"""The full-body SMPL Gaussian avatar variant (counterpart of
``cap4d_tpu/smpl/avatar.py``).

Reference: gaussianavatars/scene/cap4d_gaussian_model.py:458-1045
(SMPLGaussianModel): SMPL neutral forward per timestep, the SMPL template's
UV remesh (kernel K3 draws its layout on the card), the deform net present
but gated off, a static "neck". The JAX package's fused ``uv_resample_vjp``
and corner-table ``face_frame_pack`` run here in their unfused form, with
autograd. SMPL vertices are used as they come: unlike FLAME's, they get no
pytorch3d → OpenCV flip.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from cap4d_torch.avatar.binding import face_frame_pack
from cap4d_torch.avatar.flame_avatar import (
    MeshProperties,
    UVAssets,
    bank_row,
    build_uv_assets,
    uv_resample,
)
from cap4d_torch.ops.rasterize import load_obj
from cap4d_torch.smpl.model import SMPLModel, smpl_forward


def load_smpl_template(asset_dir: str | Path):
    """``smpl_template.obj`` (verts, faces, uvs, faces_uv) and the deformable
    vertex ids (all vertices when ``deformable_verts.txt`` is absent)."""
    asset_dir = Path(asset_dir)
    verts, faces, uvs, faces_uv = load_obj(asset_dir / "smpl_template.obj")
    deform_path = asset_dir / "deformable_verts.txt"
    deformable = (np.genfromtxt(deform_path).astype(np.int64)
                  if deform_path.exists() else np.arange(len(verts)))
    return verts, faces, uvs, faces_uv, deformable


class SMPLVariant:
    """Per-timestep mesh state of the SMPL body for the avatar trainer."""

    name = "smpl"
    uses_deform_net = False   # enable_deform_net=False in the reference

    def __init__(self, smpl_model: SMPLModel, uv: UVAssets):
        self.smpl_model = smpl_model
        self.uv = uv

    def build_bank(self, meshes: List[Dict], base_rot, device="cpu") -> Dict[str, torch.Tensor]:
        """SMPL parameter bank (load_meshes, cap4d_gaussian_model.py:631-677)."""
        def get(m, key, default):
            v = m.get(key)
            return np.asarray(v, np.float32) if v is not None else default

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return {
            "betas": t(get(meshes[0], "betas", np.zeros(10, np.float32))),
            "base_rot": t(base_rot),
            "body_pose": t(np.stack([get(m, "body_pose", np.zeros(69, np.float32))
                                     for m in meshes])),
            "global_orient": t(np.stack([get(m, "global_orient", np.zeros(3, np.float32))
                                         for m in meshes])),
            "tra": t(np.stack([get(m, "tra", np.zeros(3, np.float32)) for m in meshes])),
            # "rot" keeps the trainer's neck plumbing whole (unused: the neck is static)
            "rot": t(np.stack([get(m, "rot", np.zeros(3, np.float32)) for m in meshes])),
        }

    def mesh_props(self, deform_net, bank, t, neck_offset) -> MeshProperties:
        """select_mesh_by_timestep for SMPL (cap4d_gaussian_model.py:689-772,
        the enable_deform_net=False branch: neutral == deformed); ``t`` an
        int or a one-element index tensor."""
        out = smpl_forward(self.smpl_model, bank["betas"], bank_row(bank["body_pose"], t)[None],
                           bank_row(bank["global_orient"], t)[None])
        R = self.uv.resolution
        v = uv_resample(self.uv, out["verts"][0]).reshape(R * R, 3)
        pack = face_frame_pack(v, self.uv.remesh_faces)
        return MeshProperties(face_pack=pack, neutral_pack=pack,
                              deform_output=torch.zeros((R, R, 3), device=v.device), verts=v)


def build_smpl_variant(smpl_model: SMPLModel, asset_dir: str | Path, uv_resolution: int = 256,
                       device="cpu") -> SMPLVariant:
    tv, tf, tuv, tfuv, deformable = load_smpl_template(asset_dir)
    uv = build_uv_assets(tv, tf, tuv, tfuv, deformable, uv_resolution, device=device)
    return SMPLVariant(smpl_model, uv)
