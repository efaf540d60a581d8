"""The SMPL body model (neutral): shape and pose blend shapes, forward
kinematics over the 24-joint kintree, linear blend skinning (counterpart of
``cap4d_tpu/smpl/model.py``).

Standard SMPL: v_shaped = T + S·β; J = 𝒥·v_shaped; pose correctives
P·(R(θ) − I); world joint transforms along the kintree; skinning; global
translation. Everything is float32; on the card the products run with TF32
off (the JAX package asks for full precision the same way).

The SMPL_NEUTRAL.pkl asset is a user download; ``make_synthetic_smpl`` is a
stand-in with SMPL's shapes.
"""

from __future__ import annotations

import contextlib
import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from cap4d_torch.flame.camera import rodrigues
from cap4d_torch.flame.io import _np_shims_installed, _to_dense_numpy

SMPL_N_JOINTS = 24
SMPL_N_BETAS = 10
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)


@dataclass
class SMPLModel:
    template: torch.Tensor         # (V, 3)
    shape_dirs: torch.Tensor       # (V, 3, 10)
    pose_dirs: torch.Tensor        # (207, V, 3): the (J-1)·9 pose features first
    joint_regressor: torch.Tensor  # (24, V)
    skin_weights: torch.Tensor     # (V, 24)
    parents: np.ndarray            # (24,) int, parents[0] == -1
    faces: torch.Tensor            # (F, 3) int64


def load_smpl_pkl(path: str | Path) -> Dict[str, np.ndarray]:
    """An SMPL pkl → dict of plain numpy arrays (v_template, shapedirs,
    posedirs, J_regressor, weights, f, kintree_table with root parent -1)."""
    with _np_shims_installed(), open(path, "rb") as fh:
        raw = pickle.load(fh, encoding="latin1")
    out = {}
    for key in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights", "f"):
        out[key] = _to_dense_numpy(raw[key], np.int32 if key == "f" else np.float32)
    kt = np.asarray(raw["kintree_table"], np.int64)
    kt[0, 0] = -1
    out["kintree_table"] = kt
    return out


def build_smpl_model(smpl_dict: Dict[str, np.ndarray], n_betas: int = SMPL_N_BETAS,
                     device="cpu") -> SMPLModel:
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    posedirs = np.asarray(smpl_dict["posedirs"], np.float32)   # (V, 3, 207)
    return SMPLModel(
        template=t(smpl_dict["v_template"]),
        shape_dirs=t(np.asarray(smpl_dict["shapedirs"])[..., :n_betas]),
        pose_dirs=t(np.transpose(posedirs, (2, 0, 1))),
        joint_regressor=t(smpl_dict["J_regressor"]),
        skin_weights=t(smpl_dict["weights"]),
        parents=np.asarray(smpl_dict["kintree_table"][0], np.int64),
        faces=t(smpl_dict["f"], torch.int64),
    )


@contextlib.contextmanager
def _full_fp32():
    """Matrix products in full float32 on the card (TF32 off) for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def smpl_forward(model: SMPLModel, betas: torch.Tensor, body_pose: torch.Tensor,
                 global_orient: torch.Tensor,
                 transl: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """betas (10,), body_pose (B, 69) axis-angle of joints 1..23,
    global_orient (B, 3), transl (B, 3) → verts (B, V, 3) and joints
    (B, 24, 3) in world space."""
    with _full_fp32():
        B = body_pose.shape[0]
        v_shaped = model.template + torch.einsum("b,vxb->vx", betas, model.shape_dirs)
        joints = model.joint_regressor @ v_shaped                        # (24, 3)
        full_pose = torch.cat([global_orient[:, None], body_pose.reshape(B, 23, 3)], dim=1)
        rots = rodrigues(full_pose)                                      # (B, 24, 3, 3)
        ident = torch.eye(3, dtype=rots.dtype, device=rots.device)
        pose_feat = (rots[:, 1:] - ident).reshape(B, -1)                 # (B, 207)
        v_posed = v_shaped[None] + torch.einsum("bk,kvx->bvx", pose_feat, model.pose_dirs)

        # forward kinematics along the kintree (24 joints, parents first)
        parents = model.parents
        rel_j = joints.clone()
        # parents by row, not by a host index array (no copy to the card)
        rel_j[1:] = joints[1:] - torch.stack([joints[int(p)] for p in parents[1:]])
        A = []
        for j in range(SMPL_N_JOINTS):
            T = torch.zeros((B, 4, 4), dtype=rots.dtype, device=rots.device)
            T[:, :3, :3] = rots[:, j]
            T[:, :3, 3] = rel_j[j]
            T[:, 3, 3] = 1.0
            A.append(T if parents[j] < 0 else A[parents[j]] @ T)
        A = torch.stack(A, dim=1)                                        # (B, 24, 4, 4)

        # remove the rest-pose joint locations: G_j = A_j · [I | -joints_j]
        t_correct = torch.einsum("bjik,jk->bji", A[:, :, :3, :3], joints)
        G = A.clone()
        G[:, :, :3, 3] = G[:, :, :3, 3] - t_correct
        W = torch.einsum("vj,bjik->bvik", model.skin_weights, G)         # (B, V, 4, 4)
        verts = (torch.einsum("bvik,bvk->bvi", W[..., :3, :3], v_posed) + W[..., :3, 3])
        joints_world = A[:, :, :3, 3]   # A holds the world joint positions
        if transl is not None:
            verts = verts + transl[:, None]
            joints_world = joints_world + transl[:, None]
    return {"verts": verts, "joints": joints_world}


def make_synthetic_smpl(n_verts: int = 800, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random SMPL-shaped asset for tests (the 24-joint kintree); the same
    arrays ``cap4d_tpu.smpl.model.make_synthetic_smpl`` draws from the same
    seed."""
    rng = np.random.default_rng(seed)
    parents = np.array(SMPL_PARENTS, np.int64)
    kt = np.stack([parents, np.arange(24)], axis=0)
    jr = rng.uniform(size=(24, n_verts)).astype(np.float32)
    jr /= jr.sum(axis=1, keepdims=True)
    w = rng.uniform(size=(n_verts, 24)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    faces = np.stack([np.zeros(n_verts - 2), np.arange(1, n_verts - 1),
                      np.arange(2, n_verts)], axis=-1).astype(np.int32)
    return {
        "v_template": rng.normal(scale=0.3, size=(n_verts, 3)).astype(np.float32),
        "shapedirs": rng.normal(scale=0.01, size=(n_verts, 3, 10)).astype(np.float32),
        "posedirs": rng.normal(scale=0.005, size=(n_verts, 3, 207)).astype(np.float32),
        "J_regressor": jr,
        "weights": w,
        "kintree_table": kt,
        "f": faces,
    }
