"""Camera math shared by the pipeline stages (counterpart of
``cap4d_tpu/flame/camera.py``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# OpenCV (x right, y down, z fwd) <-> pytorch3d (x left, y up, z fwd) convention flip.
OPENCV2PYTORCH3D = np.diag(np.array([1.0, -1.0, -1.0, 1.0], dtype=np.float32))


def safe_length(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
                eps: float = 1e-20) -> torch.Tensor:
    """sqrt(max(|x|^2, eps))."""
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim, keepdim=keepdim), min=eps))


def rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle (..., 3) → rotation matrices (..., 3, 3)."""
    angle = safe_length(rot_vecs, keepdim=True, eps=eps)
    rot_dir = rot_vecs / angle
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(*rot_vecs.shape[:-1], 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    return ident + sin * K + (1.0 - cos) * (K @ K)


def transform_vertices(transform: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) rigid transforms to (..., N, 3) vertices."""
    rot = transform[..., :3, :3].transpose(-1, -2)
    return vertices @ rot + transform[..., None, :3, 3]


def project_vertices(verts_3d: torch.Tensor, cam: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Pinhole-project (N_t, V, 3) OpenCV-world vertices for N_c cameras.

    cam: fx, fy, cx, cy each (N_c, 1); extr (N_c, 4, 4) world→cam. Returns
    (N_c, N_t, V, 3): x_px, y_px and the depth normalised by the mean depth
    times (fx+fy)/2."""
    extr = cam["extr"]
    R = extr[:, None, :3, :3]
    t = extr[:, None, None, :3, 3]
    v_cam = verts_3d[None] @ R.transpose(-1, -2) + t
    fx, fy = cam["fx"][:, None], cam["fy"][:, None]
    cx, cy = cam["cx"][:, None], cam["cy"][:, None]
    z = v_cam[..., 2]
    x_px = v_cam[..., 0] / z * fx + cx
    y_px = v_cam[..., 1] / z * fy + cy
    z_n = z / z.mean(dim=-1, keepdim=True) * (fx + fy) / 2.0
    return torch.stack([x_px, y_px, z_n], dim=-1)
