"""Screen-space triangle rasterization (z-buffer, one face per pixel) and the
helpers around it (counterpart of ``cap4d_tpu/ops/rasterize.py``).

Conventions (pytorch3d parity): vertices arrive in NDC with +x LEFT and +y
UP, pixel (0, 0) is the top-left, pixel centres sit at ndc = 1 - (2i+1)/S;
z is carried untransformed and the nearest face wins, the lowest face index
on equal z; no back-face culling; ``pix_to_face == -1`` marks empty pixels,
whose barycentrics are 0 and whose z is +inf.

``rasterize_meshes`` launches kernel K3 (``csrc/rasterize.cu``) on CUDA
tensors and runs the plain version ``rasterize_meshes_plain`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cap4d_torch.ops.cuda_build import CudaKernel, I, P

KERNEL = CudaKernel(
    "rasterize.cu",
    {"c4d_rasterize": [P, P, P, P, I, I, I, I, I, P, P, P, P]},
    extra_flags=["-fmad=false"],
)


class Fragments(NamedTuple):
    pix_to_face: torch.Tensor  # (B, H, W) int32, -1 = empty
    bary_coords: torch.Tensor  # (B, H, W, 3) float32
    zbuf: torch.Tensor         # (B, H, W) float32, +inf = empty


def pixel_centers_ndc(height: int, width: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-centre NDC coordinates 1 - (2i+1)/S, computed on the host in
    float32 so that the kernel and the plain version read identical values."""
    xs = 1.0 - (2.0 * torch.arange(width, dtype=torch.float32) + 1.0) / width
    ys = 1.0 - (2.0 * torch.arange(height, dtype=torch.float32) + 1.0) / height
    return xs.to(device), ys.to(device)


def rasterize_meshes_plain(verts: torch.Tensor, faces: torch.Tensor,
                           image_size: Tuple[int, int], chunk: int = 64) -> Fragments:
    """Plain PyTorch rasterizer: the arithmetic of ``_rasterize_single``
    (``cap4d_tpu/ops/rasterize.py:47``) over chunks of faces, batched over
    meshes. Within a chunk the first minimum wins; across chunks a strict
    ``<`` keeps the earlier chunk, so on equal z the lowest face index wins."""
    height, width = image_size
    B = verts.shape[0]
    dev = verts.device
    xs, ys = pixel_centers_ndc(height, width, dev)
    px = xs[None, :].expand(height, width).reshape(1, -1, 1)   # (1, P, 1)
    py = ys[:, None].expand(height, width).reshape(1, -1, 1)
    n_pix = height * width
    best_z = torch.full((B, n_pix), float("inf"), device=dev)
    best_f = torch.full((B, n_pix), -1, dtype=torch.int32, device=dev)
    best_b = torch.zeros((B, n_pix, 3), device=dev)
    faces = faces.long()
    for f0 in range(0, faces.shape[0], chunk):
        fv = verts[:, faces[f0 : f0 + chunk]]            # (B, C, 3, 3)
        x0, y0, z0 = (fv[:, None, :, 0, i] for i in range(3))   # (B, 1, C)
        x1, y1, z1 = (fv[:, None, :, 1, i] for i in range(3))
        x2, y2, z2 = (fv[:, None, :, 2, i] for i in range(3))
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        ok = area != 0.0
        inv_area = torch.where(ok, torch.reciprocal(area), torch.zeros_like(area))
        b0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv_area   # (B, P, C)
        b1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv_area
        b2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv_area
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & ok
        z = b0 * z0 + b1 * z1 + b2 * z2
        z = torch.where(inside, z, torch.full_like(z, float("inf")))
        c_z, c_arg = torch.min(z, dim=2)
        take = c_z < best_z
        best_z = torch.where(take, c_z, best_z)
        best_f = torch.where(take, (c_arg + f0).to(torch.int32), best_f)
        c_b = torch.stack([t.gather(2, c_arg[..., None])[..., 0] for t in (b0, b1, b2)], dim=-1)
        best_b = torch.where(take[..., None], c_b, best_b)
    return Fragments(
        pix_to_face=best_f.reshape(B, height, width),
        bary_coords=best_b.reshape(B, height, width, 3),
        zbuf=best_z.reshape(B, height, width),
    )


def _rasterize_cuda(verts: torch.Tensor, faces: torch.Tensor,
                    image_size: Tuple[int, int]) -> Fragments:
    height, width = image_size
    if verts.dtype != torch.float32 or verts.ndim != 3 or verts.shape[-1] != 3:
        raise ValueError(f"rasterize kernel takes (B, V, 3) float32 verts, got "
                         f"{tuple(verts.shape)} {verts.dtype}")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces must be (F, 3), got {tuple(faces.shape)}")
    B, V, _ = verts.shape
    if faces.numel() and (int(faces.min()) < 0 or int(faces.max()) >= V):
        raise ValueError("face indices out of range")
    verts = verts.contiguous()
    faces32 = faces.to(device=verts.device, dtype=torch.int32).contiguous()
    xs, ys = pixel_centers_ndc(height, width, verts.device)
    zbuf = torch.empty((B, height, width), dtype=torch.float32, device=verts.device)
    p2f = torch.empty((B, height, width), dtype=torch.int32, device=verts.device)
    bary = torch.empty((B, height, width, 3), dtype=torch.float32, device=verts.device)
    stream = torch.cuda.current_stream(verts.device).cuda_stream
    KERNEL.call("c4d_rasterize", verts.data_ptr(), faces32.data_ptr(), xs.data_ptr(),
                ys.data_ptr(), B, V, faces32.shape[0], height, width, zbuf.data_ptr(),
                p2f.data_ptr(), bary.data_ptr(), ctypes.c_void_p(stream))
    return Fragments(pix_to_face=p2f, bary_coords=bary, zbuf=zbuf)


def rasterize_meshes(verts: torch.Tensor, faces: torch.Tensor,
                     image_size: Tuple[int, int], plain: bool = False) -> Fragments:
    """Rasterize a batch of same-topology meshes (B, V, 3) with faces (F, 3).

    On a CUDA tensor this launches kernel K3; ``plain=True`` runs the plain
    PyTorch version there instead (for comparisons only). CPU tensors take
    the plain version."""
    if verts.is_cuda and not plain:
        return _rasterize_cuda(verts, faces, image_size)
    return rasterize_meshes_plain(verts, faces.to(verts.device), image_size)


def interpolate_face_attributes(pix_to_face: torch.Tensor, bary_coords: torch.Tensor,
                                face_attrs: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of (B, F, 3, D) per-face-corner attributes;
    empty pixels → 0."""
    B = pix_to_face.shape[0]
    safe = pix_to_face.clamp(min=0).long()
    gathered = face_attrs[torch.arange(B, device=safe.device)[:, None, None], safe]  # (B,H,W,3,D)
    out = torch.einsum("bhwk,bhwkd->bhwd", bary_coords, gathered)
    return torch.where((pix_to_face >= 0)[..., None], out, torch.zeros_like(out))


def clip_barycentric(bary: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """pytorch3d's clip_barycentric_coords: clamp to ≥0 and renormalize."""
    clipped = bary.clamp(min=0.0)
    return clipped / clipped.sum(dim=-1, keepdim=True).clamp(min=eps)


def ndc_transform_verts(verts_world: torch.Tensor, intrinsics: torch.Tensor,
                        extrinsics: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
    """OpenCV camera → pytorch3d NDC, keeping view-space z (the smallest image
    side spans [-1, 1])."""
    H, W = image_size
    R = extrinsics[:, :3, :3]
    t = extrinsics[:, :3, 3]
    v_cam = torch.einsum("bij,bvj->bvi", R, verts_world) + t[:, None]
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    z = v_cam[..., 2]
    x_px = v_cam[..., 0] / z * fx + cx
    y_px = v_cam[..., 1] / z * fy + cy
    s = min(H, W) / 2.0
    return torch.stack([-(x_px - W / 2.0) / s, -(y_px - H / 2.0) / s, z], dim=-1)


def load_obj(path) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Minimal OBJ parser: (verts, faces, uvs, faces_uv) for v / vt / f lines
    with v, v/vt or v/vt/vn references, triangles only."""
    verts, uvs, faces, faces_uv = [], [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                idx = [p.split("/") for p in parts[1:4]]
                faces.append([int(i[0]) - 1 for i in idx])
                if len(idx[0]) > 1 and idx[0][1]:
                    faces_uv.append([int(i[1]) - 1 for i in idx])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32) if uvs else None,
        np.asarray(faces_uv, np.int32) if faces_uv else None,
    )
