"""Screen-space triangle rasterization (z-buffer, one face per pixel) and the
helpers around it (counterpart of ``cap4d_tpu/ops/rasterize.py``).

Conventions (pytorch3d parity): vertices arrive in NDC with +x LEFT and +y
UP, pixel (0, 0) is the top-left, pixel centres sit at ndc = 1 - (2i+1)/S;
z is carried untransformed and the nearest face wins, the lowest face index
on equal z; no back-face culling; ``pix_to_face == -1`` marks empty pixels,
whose barycentrics are 0 and whose z is +inf.

``rasterize_meshes`` launches kernel K3 (``csrc/rasterize.cu``) on CUDA
tensors and runs the plain version ``rasterize_meshes_plain`` on CPU tensors.
K3 first writes each face's record and conservative pixel box
(``face_setup_plain`` is that step's plain version), then tests each pixel
only against the faces whose box can hold it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cap4d_torch.ops.cuda_build import CudaKernel, I, P

KERNEL = CudaKernel(
    "rasterize.cu",
    {"c4d_rasterize": [P, P, I, I, I, I, I, P, P, P, P, P, P, P],
     "c4d_rasterize_setup": [P, P, I, I, I, I, I, P, P, P, P]},
    extra_flags=["-fmad=false"],
)

# The constants of the box argument (rasterize.cu's note, kept equal to the
# kernel's): a face's box is trusted only where every x and y lies within
# COORD_MAX, AREA_MIN <= |area| <= AREA_MAX and |area| >= max(W wx, H wy) *
# (ERR_SCALE (wx + wy)(1 + max |coordinate|) + ERR_FLOOR), on images of at
# most MAX_SIDE a side.
MAX_SIDE = 16384
MAX_FRAMES = 65535            # the kernel's grid.y
MAX_FACES = 1 << 28
COORD_MAX = 2.0 ** 60
AREA_MIN = 2.0 ** -100
AREA_MAX = 2.0 ** 100
ERR_SCALE = 2.0 ** -19
ERR_FLOOR = 2.0 ** -120
BOX, EMPTY, WHOLE = 0, 1, 2   # face classes of ``face_setup_plain``
EMPTY_BOX = (0, -1, 0, -1)
GROUP = 32                    # consecutive faces under one group box


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


class FaceSetup(NamedTuple):
    records: torch.Tensor  # (B, F, 16) float32: x0 y0 z0 x1 y1 z1 x2 y2 z2, 1/area,
    #                        then edge i's (xa - xb, ya - yb), i = 0, 1, 2
    boxes: torch.Tensor    # (B, F, 4) int16: first, last column; first, last row
    groups: torch.Tensor   # (B, ceil(F / GROUP), 4) int16: the union of GROUP faces' boxes
    cls: torch.Tensor      # (B, F) int8: BOX, EMPTY or WHOLE


def face_setup_plain(verts: torch.Tensor, faces: torch.Tensor,
                     image_size: Tuple[int, int]) -> FaceSetup:
    """Plain version of K3's first step: each face's record and its pixel box.

    The box is the pixel-index range of the face's NDC bounding box, widened
    by one pixel on each side and clamped to the image; (0, -1, 0, -1) where
    it is empty. A face that no pixel can pass (area 0 or NaN, which a NaN x
    or y makes) is EMPTY; one whose box the argument in ``rasterize.cu`` does
    not cover (a coordinate past COORD_MAX or not finite, an |area| outside
    its trusted range) is WHOLE and gets the whole image. Every operation is
    the kernel's, in its order, so the two agree bit for bit. ``groups``
    holds the union of the boxes of each GROUP consecutive faces, which the
    kernel's sweep tests before it reads theirs."""
    height, width = image_size
    fv = verts[:, faces.long()]                                 # (B, F, 3, 3)
    x0, y0, z0 = fv[..., 0, 0], fv[..., 0, 1], fv[..., 0, 2]
    x1, y1, z1 = fv[..., 1, 0], fv[..., 1, 1], fv[..., 1, 2]
    x2, y2, z2 = fv[..., 2, 0], fv[..., 2, 1], fv[..., 2, 2]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    inv = torch.where(area != 0.0, torch.reciprocal(area), torch.zeros_like(area))
    records = torch.stack([x0, y0, z0, x1, y1, z1, x2, y2, z2, inv, x2 - x1, y2 - y1,
                           x0 - x2, y0 - y2, x1 - x0, y1 - y0], dim=-1)

    xmin, xmax = torch.minimum(torch.minimum(x0, x1), x2), torch.maximum(torch.maximum(x0, x1), x2)
    ymin, ymax = torch.minimum(torch.minimum(y0, y1), y2), torch.maximum(torch.maximum(y0, y1), y2)
    coords = [c.abs() for c in (x0, y0, x1, y1, x2, y2)]
    cmax = coords[0]
    for c in coords[1:]:
        cmax = torch.maximum(cmax, c)
    finite = coords[0] <= COORD_MAX
    for c in coords[1:]:
        finite = finite & (c <= COORD_MAX)
    wx, wy = xmax - xmin, ymax - ymin
    spread = (wx + wy) * (1.0 + cmax)
    thr = torch.maximum(wx * width, wy * height) * (spread * ERR_SCALE + ERR_FLOOR)
    a = area.abs()
    empty = (area == 0.0) | torch.isnan(area)
    trusted = finite & (a >= AREA_MIN) & (a <= AREA_MAX) & (a >= thr)

    def axis(lo, hi, n):
        first = ((1.0 - hi) * n - 1.0) * 0.5
        last = ((1.0 - lo) * n - 1.0) * 0.5
        return ((torch.ceil(first) - 1.0).clamp(min=0.0, max=float(n)),
                (torch.floor(last) + 1.0).clamp(min=-1.0, max=float(n - 1)))

    cx0, cx1 = axis(xmin, xmax, width)
    cy0, cy1 = axis(ymin, ymax, height)
    box = torch.stack([cx0, cx1, cy0, cy1], dim=-1)
    box_empty = (cx0 > cx1) | (cy0 > cy1)
    empty_box = torch.tensor(EMPTY_BOX, dtype=box.dtype, device=box.device)
    whole_box = torch.tensor((0, width - 1, 0, height - 1), dtype=box.dtype, device=box.device)
    box = torch.where((box_empty | empty)[..., None], empty_box, box)
    box = torch.where((~empty & ~trusted)[..., None], whole_box, box)
    cls = torch.where(empty, EMPTY, torch.where(trusted, BOX, WHOLE)).to(torch.int8)

    B, F = area.shape
    G = -(-F // GROUP)
    live = torch.zeros((B, G * GROUP), dtype=torch.bool, device=box.device)
    live[:, :F] = (box[..., 1] >= box[..., 0]) & (box[..., 3] >= box[..., 2])
    padded = torch.zeros((B, G * GROUP, 4), dtype=box.dtype, device=box.device)
    padded[:, :F] = box
    live, padded = live.reshape(B, G, GROUP), padded.reshape(B, G, GROUP, 4)
    lo = torch.where(live[..., None], padded, 32767.0).amin(dim=2)
    hi = torch.where(live[..., None], padded, -1.0).amax(dim=2)
    groups = torch.stack([lo[..., 0], hi[..., 1], lo[..., 2], hi[..., 3]], dim=-1)
    groups = torch.where(live.any(dim=2)[..., None], groups, empty_box)
    return FaceSetup(records=records, boxes=box.to(torch.int16), groups=groups.to(torch.int16),
                     cls=cls)


def _check_kernel_inputs(verts: torch.Tensor, faces: torch.Tensor,
                         image_size: Tuple[int, int]) -> None:
    """Raise on what K3 does not take. Face indices are checked on the card
    (a device-side assert in the setup kernel), so no call waits for it."""
    height, width = image_size
    if verts.dtype != torch.float32 or verts.ndim != 3 or verts.shape[-1] != 3:
        raise ValueError(f"rasterize kernel takes (B, V, 3) float32 verts, got "
                         f"{tuple(verts.shape)} {verts.dtype}")
    if faces.ndim != 2 or faces.shape[1] != 3 or faces.is_floating_point() or faces.is_complex():
        raise ValueError(f"faces must be (F, 3) integers, got {tuple(faces.shape)} {faces.dtype}")
    if not (1 <= height <= MAX_SIDE and 1 <= width <= MAX_SIDE):
        raise ValueError(f"image sides must lie in [1, {MAX_SIDE}], got {image_size}")
    if not 1 <= verts.shape[0] <= MAX_FRAMES:
        raise ValueError(f"the kernel takes 1 to {MAX_FRAMES} frames, got {verts.shape[0]}")
    if faces.shape[0] > MAX_FACES:
        raise ValueError(f"the kernel takes at most {MAX_FACES} faces, got {faces.shape[0]}")


def _launch(kernel_fn: str, verts, faces, image_size, *outputs):
    """Launch ``kernel_fn`` on a workspace of one allocation, addressed by
    offsets (records, then boxes, then group boxes); returns the workspace.
    The host work per call is a few tensor operations: on small shapes it,
    not the card, sets the time of a call."""
    height, width = image_size
    B, V, _ = verts.shape
    if not verts.is_contiguous():
        verts = verts.contiguous()
    if faces.dtype != torch.int32 or faces.device != verts.device or not faces.is_contiguous():
        faces = faces.to(device=verts.device, dtype=torch.int32).contiguous()
    F = faces.shape[0]
    ws = torch.empty(B * (F * 72 + -(-F // GROUP) * 8), dtype=torch.uint8, device=verts.device)
    base = ws.data_ptr()
    KERNEL.call(kernel_fn, verts.data_ptr(), faces.data_ptr(), B, V, F, height, width, base,
                base + B * F * 64, base + B * F * 72, *(t.data_ptr() for t in outputs),
                ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(verts.device.index)),
                inputs=(verts, faces, *outputs))
    return ws


def face_setup_cuda(verts: torch.Tensor, faces: torch.Tensor, image_size: Tuple[int, int]):
    """K3's first step alone on CUDA tensors: (records, boxes, groups) as
    ``face_setup_plain`` computes them (for comparisons)."""
    _check_kernel_inputs(verts, faces, image_size)
    ws = _launch("c4d_rasterize_setup", verts, faces, image_size)
    B, F = verts.shape[0], faces.shape[0]
    return (ws[: B * F * 64].view(torch.float32).view(B, F, 16),
            ws[B * F * 64 : B * F * 72].view(torch.int16).view(B, F, 4),
            ws[B * F * 72 :].view(torch.int16).view(B, -(-F // GROUP), 4))


def _rasterize_cuda(verts: torch.Tensor, faces: torch.Tensor,
                    image_size: Tuple[int, int]) -> Fragments:
    _check_kernel_inputs(verts, faces, image_size)
    height, width = image_size
    B, dev = verts.shape[0], verts.device
    zbuf = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    p2f = torch.empty((B, height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((B, height, width, 3), dtype=torch.float32, device=dev)
    _launch("c4d_rasterize", verts, faces, image_size, zbuf, p2f, bary)
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
