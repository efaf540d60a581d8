"""CAP4D FLAME Gaussian avatar: UV remeshing, deformation net, mesh binding
(counterpart of ``cap4d_tpu/avatar/flame_avatar.py``).

Reference: gaussianavatars/scene/cap4d_gaussian_model.py:40-456. FLAME
(150/65) with the mouth (and the lower jaw) is rasterized once into its UV
layout (kernel K3 through ``ops/rasterize.py``), remeshed as a regular grid
of texels and populated with area-proportional gaussians. Per timestep:
FLAME forward (posed and neutral) → UV offset maps → pix2pix deform net →
corrective deformation inside the deformable region → face frames for the
bound gaussians. The JAX package's fused gathers with custom VJPs
(``uv_resample_vjp2``, ``face_frame_pack2``) and its roll-based laplacian
run here in their unfused form, with autograd.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, NamedTuple

import numpy as np
import torch

from cap4d_torch.avatar.binding import face_frame_pack, rotmat_to_rotvec
from cap4d_torch.avatar.deform_net import UnetGenerator, get_pos_enc
from cap4d_torch.flame.camera import rodrigues
from cap4d_torch.flame.skinner import FlameModel, flame_forward
from cap4d_torch.ops.rasterize import load_obj, rasterize_meshes

STD_DEFORM = 0.0108  # deformation normalisation (cap4d_gaussian_model.py:38)
MAX_NECK_ROT = 0.15  # tanh clamp on the relative neck rotation (:220-221)
N_POS_ENC = 12


def gen_uv_mesh(uv_mask: np.ndarray) -> np.ndarray:
    """Regular-grid faces over valid texels (utils/mesh_utils.py:5-24): two
    triangles per grid cell whose four texels are valid."""
    R = uv_mask.shape[0]
    r, c = np.mgrid[0 : R - 1, 0 : R - 1]
    p00 = r * R + c
    p01 = (r + 1) * R + c
    p10 = r * R + (c + 1)
    p11 = (r + 1) * R + (c + 1)
    tri1 = np.stack([p00, p01, p11], axis=-1).reshape(-1, 3)
    tri2 = np.stack([p00, p11, p10], axis=-1).reshape(-1, 3)
    faces = np.stack([tri1, tri2], axis=1).reshape(-1, 3)
    keep = uv_mask.reshape(-1)[faces].min(axis=-1)
    return faces[keep].astype(np.int32)


@dataclass
class UVAssets:
    """One-time UV rasterization products (load_uv, cap4d_gaussian_model.py:93-165)."""

    pix_to_face: torch.Tensor    # (R, R) int64 into template faces (0 where empty)
    bary: torch.Tensor           # (R, R, 3)
    uv_mask: torch.Tensor        # (R, R) bool
    deform_mask: torch.Tensor    # (R, R) bool
    remesh_faces: torch.Tensor   # (Fr, 3) int64 into the R² texel grid
    template_faces: torch.Tensor # (Ft, 3) int64 into template verts
    pos_enc: torch.Tensor        # (R, R, 2·N_POS_ENC)

    @property
    def resolution(self) -> int:
        return self.uv_mask.shape[0]


def build_uv_assets(template_verts: np.ndarray, template_faces: np.ndarray,
                    template_uvs: np.ndarray, faces_uv: np.ndarray,
                    deformable_vert_ids: np.ndarray, uv_resolution: int,
                    device="cpu") -> UVAssets:
    """Rasterize the template's UV layout (uv → pytorch3d NDC: [0,1] →
    [-1,1], y negated; cap4d_gaussian_model.py:64-65) and derive the texel
    masks and the remesh faces."""
    uvs = template_uvs * 2.0 - 1.0
    uvs[..., 1] = -uvs[..., 1]
    uv_verts = np.concatenate([uvs, np.ones_like(uvs[:, :1])], axis=-1).astype(np.float32)
    frag = rasterize_meshes(torch.as_tensor(uv_verts, device=device)[None],
                            torch.as_tensor(faces_uv.astype(np.int32), device=device),
                            (uv_resolution, uv_resolution))
    pix_to_face = frag.pix_to_face[0].cpu().numpy()
    uv_mask = pix_to_face >= 0
    p2f = np.where(uv_mask, pix_to_face, 0)
    vert_mask = np.zeros(template_verts.shape[0], np.float32)
    vert_mask[deformable_vert_ids] = 1.0
    deform_face = vert_mask[template_faces].min(axis=-1) > 0
    deform_mask = deform_face[p2f] & uv_mask

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return UVAssets(
        pix_to_face=t(p2f, torch.int64),
        bary=frag.bary_coords[0].to(device),
        uv_mask=t(uv_mask),
        deform_mask=t(deform_mask),
        remesh_faces=t(gen_uv_mesh(uv_mask), torch.int64),
        template_faces=t(template_faces, torch.int64),
        pos_enc=t(get_pos_enc(N_POS_ENC, uv_resolution)),
    )


def uv_resample(uv: UVAssets, verts: torch.Tensor) -> torch.Tensor:
    """Per-vertex values (V, D) → the UV texel grid (R, R, D)
    (uv_remesh_flame_vertices, cap4d_gaussian_model.py:259-265)."""
    gathered = verts[uv.template_faces[uv.pix_to_face]]             # (R, R, 3, D)
    return torch.einsum("hwk,hwkd->hwd", uv.bary, gathered) * uv.uv_mask[..., None]


def allocate_gaussians(uv: UVAssets, template_verts: torch.Tensor, n_gaussians_init: int,
                       n_points_per_triangle: int):
    """Area-proportional per-face gaussian allocation over the remesh
    (cap4d_gaussian_model.py:147-165) → (binding, per-gaussian face count)."""
    remesh_verts = uv_resample(uv, template_verts).reshape(-1, 3).cpu().numpy()
    tri = remesh_verts[uv.remesh_faces.cpu().numpy()]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    per_face = np.round(n_gaussians_init / area.sum() * area).astype(np.int64)
    per_face = np.clip(per_face, n_points_per_triangle, None)
    binding = np.repeat(np.arange(len(per_face)), per_face)
    counts = np.repeat(per_face, per_face).astype(np.float32)
    return binding.astype(np.int32), counts


class MeshProperties(NamedTuple):
    """Per-timestep face frames as packed (Fr, 16) rows (binding.face_frame_pack)."""

    face_pack: torch.Tensor       # deformed face frames
    neutral_pack: torch.Tensor    # neutral face frames
    deform_output: torch.Tensor   # (R, R, 3) net deformation (unnormalised)
    verts: torch.Tensor           # (R·R, 3) deformed remesh verts (world)

    @property
    def face_scaling(self) -> torch.Tensor:   # (Fr, 1), densification sizes
        return self.face_pack[:, 3:4]


@dataclass(frozen=True)
class FlameAvatarConfig:
    uv_resolution: int = 256
    n_unet_layers: int = 6
    use_expr_mask: bool = True
    static_neck: bool = False
    use_lower_jaw: bool = True
    n_gaussians_init: int = 100_000
    n_points_per_triangle: int = 2
    sh_degree: int = 1
    gaussian_init_type: str = "scaled"


def bank_row(x: torch.Tensor, t) -> torch.Tensor:
    """Row ``t`` of a per-timestep tensor. ``t`` is an int, or a
    one-element index tensor on ``x``'s device, gathered there without
    reading it on the host (as a captured train step needs)."""
    return x.index_select(0, t.view(1))[0] if torch.is_tensor(t) else x[int(t)]


def make_deform_net(config: FlameAvatarConfig) -> UnetGenerator:
    return UnetGenerator(in_channels=3 + 2 * N_POS_ENC, out_channels=3, ngf=64,
                         num_downs=config.n_unet_layers, zero_init_last=True)


def relative_neck_rotation(base_rot: torch.Tensor, curr_rot: torch.Tensor,
                           neck_offset: torch.Tensor) -> torch.Tensor:
    """tanh-clamped relative neck rotation (cap4d_gaussian_model.py:214-228)."""
    rel = rodrigues(curr_rot[None])[0].T @ rodrigues(base_rot[None])[0]
    rel_vec = torch.tanh(rotmat_to_rotvec(rel) / MAX_NECK_ROT) * MAX_NECK_ROT
    return rel_vec + neck_offset


def mesh_properties(flame_model: FlameModel, uv: UVAssets, deform_net: UnetGenerator,
                    shape, expr, rot, tra, eye_rot, neck_rot,
                    use_expr_mask: bool = True) -> MeshProperties:
    """select_mesh_by_timestep + update_mesh_properties
    (cap4d_gaussian_model.py:211-332): posed and neutral FLAME in one batch
    of two, UV offsets into the deform net, deformed and neutral face frames."""
    out = flame_forward(flame_model, shape, torch.stack([expr, expr * 0.0]),
                        torch.stack([rot, rot]), torch.stack([tra, tra]),
                        eye_rot=torch.stack([eye_rot, eye_rot * 0.0]),
                        neck_rot=torch.stack([neck_rot, neck_rot]))
    # pytorch3d → opencv convention (y, z negated; :239-241)
    v = torch.cat([out["verts"][..., :1], -out["verts"][..., 1:]], dim=-1)
    verts, offsets = v[0], v[0] - v[1]
    remeshed_verts = uv_resample(uv, verts)
    remeshed_offsets = uv_resample(uv, offsets.detach()) / STD_DEFORM
    if use_expr_mask:
        remeshed_offsets = remeshed_offsets * uv.uv_mask[..., None]
    pos = uv.pos_enc[None].expand(2, *uv.pos_enc.shape)
    inp = torch.cat([torch.stack([remeshed_offsets, torch.zeros_like(remeshed_offsets)]), pos],
                    dim=-1)
    out2 = deform_net(inp) * STD_DEFORM
    deform_out, nodeform_out = out2[0], out2[1]
    deform_out = torch.where(uv.deform_mask[..., None], deform_out, nodeform_out)
    R = uv.resolution
    v_def = (remeshed_verts + deform_out).reshape(R * R, 3)
    v_neu = (remeshed_verts + nodeform_out).reshape(R * R, 3)
    return MeshProperties(face_pack=face_frame_pack(v_def, uv.remesh_faces),
                          neutral_pack=face_frame_pack(v_neu, uv.remesh_faces),
                          deform_output=deform_out, verts=v_def)


# ---------------- regularizers (cap4d_gaussian_model.py:334-379) ----------------


def laplacian_loss(deform_output: torch.Tensor) -> torch.Tensor:
    """Squared 4-neighbour laplacian of the deformation map over interior
    texels, channel-summed, averaged over the (R-2)² interior."""
    d = deform_output.permute(2, 0, 1) / STD_DEFORM
    lap = (4.0 * d[:, 1:-1, 1:-1] - d[:, :-2, 1:-1] - d[:, 2:, 1:-1]
           - d[:, 1:-1, :-2] - d[:, 1:-1, 2:])
    R = d.shape[-1]
    return (lap ** 2).sum() / ((R - 2) * (R - 2))


def relative_deformation_loss(xyz_world: torch.Tensor, xyz_neutral: torch.Tensor) -> torch.Tensor:
    return (((xyz_neutral - xyz_world) / STD_DEFORM) ** 2).sum(dim=1).mean()


def load_avatar_template(asset_dir: str | Path):
    """Avatar template obj + deformable vertex list."""
    asset_dir = Path(asset_dir)
    verts, faces, uvs, faces_uv = load_obj(asset_dir / "cap4d_avatar_template.obj")
    deformable = np.genfromtxt(asset_dir / "deformable_verts.txt").astype(np.int64)
    return verts, faces, uvs, faces_uv, deformable


class FlameVariant:
    """Per-timestep mesh state for the avatar trainer."""

    name = "flame"
    uses_deform_net = True

    def __init__(self, flame_model: FlameModel, uv: UVAssets, config: FlameAvatarConfig):
        self.flame_model = flame_model
        self.uv = uv
        self.config = config

    def build_bank(self, meshes, base_rot, device="cpu") -> Dict[str, torch.Tensor]:
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

        return {
            "shape": t(meshes[0]["shape"]),
            "base_rot": t(base_rot),
            "expr": t(np.stack([m["expr"] for m in meshes])),
            "eye_rot": t(np.stack([m["eye_rot"] for m in meshes])),
            "rot": t(np.stack([m["rot"] for m in meshes])),
            "tra": t(np.stack([m["tra"] for m in meshes])),
        }

    def mesh_props(self, deform_net, bank, t, neck_offset) -> MeshProperties:
        """``t``: the timestep, an int or a one-element index tensor."""
        rot = bank_row(bank["rot"], t)
        rel = relative_neck_rotation(bank["base_rot"], rot, neck_offset)
        return mesh_properties(self.flame_model, self.uv, deform_net, bank["shape"],
                               bank_row(bank["expr"], t), rot, bank_row(bank["tra"], t),
                               bank_row(bank["eye_rot"], t), rel,
                               use_expr_mask=self.config.use_expr_mask)
