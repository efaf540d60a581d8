"""FLAME linear-blend skinning on tensors (counterpart of
``cap4d_tpu/flame/skinner.py``): blendshapes, pose correctives, LBS, the
blink override, the procedural mouth sphere and the optional lower jaw.

All frames go through one batched call. ``shape`` may be one coefficient
vector shared by the batch, or one per frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cap4d_torch.flame.camera import rodrigues

MOUTH_N_VERTS = 200  # 20x20 half-sphere → (lat/2)*long vertices


def generate_uv_half_sphere(
    r: float = 1.0, latitude_steps: int = 20, longitude_steps: int = 20
) -> Tuple[np.ndarray, np.ndarray]:
    """Half uv-sphere used as the procedural mouth interior (y and z negated)."""
    lats = np.linspace(-np.pi / 2, np.pi / 2, latitude_steps)[: latitude_steps // 2]
    lons = np.linspace(0.0, 2.0 * np.pi, longitude_steps)
    lat_g, lon_g = np.meshgrid(lats, lons, indexing="ij")
    verts = np.stack(
        [r * np.cos(lat_g) * np.cos(lon_g),
         -(r * np.cos(lat_g) * np.sin(lon_g)),
         -(r * np.sin(lat_g))],
        axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for i in range(latitude_steps // 2 - 1):
        for j in range(longitude_steps):
            l1l1 = i * longitude_steps + j
            l1l2 = i * longitude_steps + (j + 1) % longitude_steps
            l2l1 = (i + 1) * longitude_steps + j
            l2l2 = (i + 1) * longitude_steps + (j + 1) % longitude_steps
            faces.append([l1l1, l2l2, l2l1])
            if i > 0:
                faces.append([l1l1, l1l2, l2l2])
    return verts, np.asarray(faces, dtype=np.int32)


@dataclass
class FlameModel:
    """Frozen FLAME weights as tensors on one device."""

    template: torch.Tensor        # (V, 3)
    shape_dirs: torch.Tensor      # (V, 3, n_shape)
    expr_dirs: torch.Tensor       # (V, 3, n_expr) — last component may be blink
    pose_dirs: torch.Tensor       # (J-1, 3, 3, V, 3)
    joint_regressor: torch.Tensor # (J, V)
    skin_weights: torch.Tensor    # (V, J)
    faces: torch.Tensor           # (F, 3) int64
    mouth_verts: torch.Tensor     # (200, 3) unit half sphere
    jaw_regressor: torch.Tensor   # (n_expr, 3) expr → jaw axis-angle
    n_shape: int = 300
    n_expr: int = 100
    add_mouth: bool = False
    add_lower_jaw: bool = False
    lip_v_index: int = 3533
    lip_offset: float = 0.005


def build_flame_model(
    flame_dict: Dict[str, np.ndarray],
    n_shape: int = 300,
    n_expr: int = 100,
    blink_blendshape: Optional[np.ndarray] = None,
    add_mouth: bool = False,
    add_lower_jaw: bool = False,
    jaw_regressor: Optional[np.ndarray] = None,
    lip_v_index: int = 3533,
    device="cpu",
) -> FlameModel:
    """Assemble a FlameModel from a loaded asset dict (numpy in)."""
    sd = np.asarray(flame_dict["shapedirs"], np.float32)
    n_total_shape = 300 if sd.shape[-1] >= 400 else sd.shape[-1] // 2
    shape_dirs = sd[..., :n_shape]
    expr_dirs = sd[..., n_total_shape : n_total_shape + n_expr].copy()
    if blink_blendshape is not None:
        # the blink blendshape overrides the LAST expression component
        expr_dirs[:, :, -1] = np.asarray(blink_blendshape, np.float32)
    posedirs = np.asarray(flame_dict["posedirs"], np.float32)  # (V, 3, (J-1)*9)
    n_j = flame_dict["J_regressor"].shape[0]
    # the flat axis is ordered (J, i, j)
    pose_dirs = np.transpose(posedirs, (2, 0, 1)).reshape(n_j - 1, 3, 3, *posedirs.shape[:2])
    mouth_v, _ = generate_uv_half_sphere()
    jr = (np.asarray(jaw_regressor, np.float32) if jaw_regressor is not None
          else np.zeros((n_expr, 3), np.float32))

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return FlameModel(
        template=t(flame_dict["v_template"]),
        shape_dirs=t(shape_dirs),
        expr_dirs=t(expr_dirs),
        pose_dirs=t(pose_dirs),
        joint_regressor=t(flame_dict["J_regressor"]),
        skin_weights=t(flame_dict["weights"]),
        faces=t(flame_dict["f"], torch.int64),
        mouth_verts=t(mouth_v),
        jaw_regressor=t(jr),
        n_shape=n_shape,
        n_expr=n_expr,
        add_mouth=add_mouth,
        add_lower_jaw=add_lower_jaw,
        lip_v_index=lip_v_index,
    )


def _joint_rotation(model: FlameModel, verts: torch.Tensor, rotations: torch.Tensor):
    """Pose-corrective blendshapes + linear blend skinning.

    Returns (posed verts (B,V,3), joints (B,J,3), per-vertex transforms (B,V,4,4))."""
    B, J = rotations.shape[:2]
    ident = torch.eye(3, dtype=verts.dtype, device=verts.device)
    pose_feat = (rotations[:, 1:] - ident).reshape(B, -1)
    pose_dirs = model.pose_dirs.reshape(-1, *model.pose_dirs.shape[3:])
    pose_offsets = torch.einsum("bk,kvx->bvx", pose_feat, pose_dirs)
    joints = torch.einsum("bvx,jv->bjx", verts, model.joint_regressor)
    v_posed = verts + pose_offsets

    transforms = torch.zeros((B, J, 4, 4), dtype=verts.dtype, device=verts.device)
    transforms[..., :3, :3] = rotations
    transforms[..., 3, 3] = 1.0
    transforms[..., :3, 3] = joints - torch.einsum("bjik,bjk->bji", rotations, joints)

    weighted = torch.einsum("vj,bjik->bvik", model.skin_weights, transforms)
    v_homo = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    v_out = torch.einsum("bvik,bvk->bvi", weighted, v_homo)[..., :3]
    return v_out, joints, weighted


def mouth_sphere(model: FlameModel, neutral_verts: torch.Tensor,
                 jaw_rotation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mouth-interior half sphere anchored between the jaw joint and a lip
    vertex. Returns (B, 200, 3)."""
    jaw_joint = torch.einsum("bvx,v->bx", neutral_verts, model.joint_regressor[2])
    lip_vert = neutral_verts[:, model.lip_v_index]
    offset = lip_vert - jaw_joint
    distance = torch.linalg.norm(offset, dim=-1, keepdim=True)
    direction = offset / distance
    y = torch.zeros_like(direction)
    y[:, 1] = 1.0
    new_x = torch.linalg.cross(y, direction)
    new_x = new_x / torch.linalg.norm(new_x, dim=-1, keepdim=True)
    new_y = torch.linalg.cross(direction, new_x)
    new_y = new_y / torch.linalg.norm(new_y, dim=-1, keepdim=True)
    rot = torch.stack([new_x, new_y, direction], dim=-1)  # (B, 3, 3) columns

    v = model.mouth_verts[None] * distance[..., None] * 0.25
    v = torch.einsum("bij,bnj->bni", rot, v)
    center = jaw_joint + offset * 0.75 - model.lip_offset * direction
    v = v + center[:, None]
    if jaw_rotation is not None:
        v = jaw_joint[:, None] + torch.einsum("bij,bnj->bni", jaw_rotation, v - jaw_joint[:, None])
    return v


def flame_forward(
    model: FlameModel,
    shape: torch.Tensor,                      # (n_shape,) or (B, n_shape)
    expr: torch.Tensor,                       # (B, n_expr)
    rot: torch.Tensor,                        # (B, 3) base axis-angle
    tra: torch.Tensor,                        # (B, 3) base translation
    eye_rot: Optional[torch.Tensor] = None,   # (B, 3)
    jaw_rot: Optional[torch.Tensor] = None,   # (B, 3)
    neck_rot: Optional[torch.Tensor] = None,  # (B, 3)
) -> Dict[str, torch.Tensor]:
    """CAP4D FLAME forward: verts, per-vertex offsets (posed − shape-neutral,
    before the base rigid transform) and per-vertex 4×4 transforms."""
    B = expr.shape[0]
    shape = shape[None] if shape.ndim == 1 else shape
    shape_verts = model.template[None] + torch.einsum("bs,vxs->bvx", shape, model.shape_dirs)
    verts = shape_verts + torch.einsum("be,vxe->bvx", expr, model.expr_dirs)

    n_j = model.joint_regressor.shape[0]
    rotations = torch.eye(3, dtype=verts.dtype, device=verts.device).repeat(B, n_j, 1, 1)
    if neck_rot is not None:
        rotations[:, 0] = rodrigues(neck_rot)
    if jaw_rot is not None:
        rotations[:, 2] = rodrigues(jaw_rot)
    if eye_rot is not None:
        eye_mat = rodrigues(eye_rot)
        rotations[:, 3] = eye_mat
        rotations[:, 4] = eye_mat

    verts, _, v_transforms = _joint_rotation(model, verts, rotations)
    offsets = verts - shape_verts

    if model.add_mouth:
        m_verts = mouth_sphere(model, shape_verts).expand(B, MOUTH_N_VERTS, 3)
        verts = torch.cat([verts, m_verts], dim=1)
        offsets = torch.cat([offsets, torch.zeros_like(m_verts)], dim=1)
        v_transforms = torch.cat(
            [v_transforms, v_transforms.new_zeros((B, m_verts.shape[1], 4, 4))], dim=1)
    if model.add_lower_jaw:
        jr = torch.einsum("be,er->br", expr, model.jaw_regressor)
        shape_b = shape_verts.expand(B, *shape_verts.shape[1:])
        neutral_jaw = mouth_sphere(model, shape_b, rodrigues(jr * 0.0))
        jaw_verts = mouth_sphere(model, shape_b, rodrigues(jr))
        verts = torch.cat([verts, jaw_verts], dim=1)
        offsets = torch.cat([offsets, jaw_verts - neutral_jaw], dim=1)
        jt = verts.new_zeros((B, 4, 4))
        jt[:, :3, :3] = rodrigues(jr)
        jt[:, 3, 3] = 1.0
        v_transforms = torch.cat(
            [v_transforms, jt[:, None].expand(B, jaw_verts.shape[1], 4, 4)], dim=1)

    # base rigid transform applied after skinning
    base_rot = rodrigues(rot)
    verts = torch.einsum("bij,bnj->bni", base_rot, verts) + tra[:, None]
    base_tf = verts.new_zeros((B, 4, 4))
    base_tf[:, :3, :3] = base_rot
    base_tf[:, :3, 3] = tra
    base_tf[:, 3, 3] = 1.0
    v_transforms = torch.einsum("bij,bnjk->bnik", base_tf, v_transforms)
    return {"verts": verts, "offsets": offsets, "transforms": v_transforms}
