"""Host-side image, crop and camera-ray helpers (numpy only).

Counterpart of ``cap4d_tpu/data/utils.py``. The card machine has no ``cv2``,
so ``rescale_image`` carries numpy copies of OpenCV's ``INTER_AREA``
(fractional-overlap box weights rounded to float32, ``computeResizeAreaTab``)
and ``INTER_LINEAR`` (half-pixel centres, clamped borders), and
frames (PNG or JPEG) are decoded by the port's native runtime
(``cap4d_torch/runtime``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from cap4d_torch.runtime.loader import decode_image

CROP_MARGIN = 0.2


def crop_image(img: np.ndarray, crop_box: np.ndarray, bg_value=0) -> np.ndarray:
    """Crop with out-of-bounds padding at bg_value."""
    img_h, img_w = img.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in crop_box[:4])
    out = np.ones((y1 - y0, x1 - x0, *img.shape[2:]), dtype=img.dtype) * bg_value
    ix0, ix1 = min(max(x0, 0), img_w), min(max(x1, 0), img_w)
    iy0, iy1 = min(max(y0, 0), img_h), min(max(y1, 0), img_h)
    if ix1 > ix0 and iy1 > iy0:
        out[iy0 - y0 : iy1 - y0, ix0 - x0 : ix1 - x0, ...] = img[iy0:iy1, ix0:ix1, ...]
    return out


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of OpenCV's INTER_AREA for a downscale."""
    scale = 1.0 / (dsize / ssize)
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            w[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def _linear_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of OpenCV's INTER_LINEAR."""
    scale = 1.0 / (dsize / ssize)
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fx = (dx + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        fx = fx - sx
        if sx < 0:
            fx, sx = 0.0, 0
        if sx >= ssize - 1:
            fx, sx = 0.0, ssize - 1
        w[dx, sx] += 1.0 - fx
        if fx != 0:
            w[dx, sx + 1] += fx
    return w


def rescale_image(img: np.ndarray, target_resolution: int) -> np.ndarray:
    """Square resize: area weights to shrink, bilinear to enlarge.

    Like ``cv2.resize`` it drops a trailing singleton channel axis. Float
    inputs are resized in float64 and returned in their dtype; integer inputs
    are rounded (OpenCV's fixed-point rounding may differ by one there).
    """
    h, w = img.shape[:2]
    weights = _area_weights if target_resolution < h else _linear_weights
    wy = weights(h, target_resolution)
    wx = weights(w, target_resolution)
    x = img.astype(np.float64)
    if x.ndim == 3 and x.shape[2] == 1:
        x = x[..., 0]
    out = np.einsum("yh,hw...->yw...", wy, x)
    out = np.einsum("xw,yw...->yx...", wx, out)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


def apply_bg(img: np.ndarray, bg_weights: np.ndarray,
             bg_color: np.ndarray = np.array([255, 255, 255])) -> np.ndarray:
    w = bg_weights / 255.0
    return bg_color[None, None] * (1.0 - w) + img * w


def verts_to_pytorch3d(verts_2d: np.ndarray, crop_box: np.ndarray) -> np.ndarray:
    """Pixel coords → crop-relative pytorch3d NDC [-1,1], x/y negated."""
    out = verts_2d.copy()
    out[..., 0] = -((verts_2d[..., 0] - crop_box[..., 0]) / (crop_box[..., 2] - crop_box[..., 0]) * 2.0 - 1.0)
    out[..., 1] = -((verts_2d[..., 1] - crop_box[..., 1]) / (crop_box[..., 3] - crop_box[..., 1]) * 2.0 - 1.0)
    return out


def get_square_bbox(bbox: np.ndarray, border_margin: float = 0.1, mode: str = "max"):
    bbox = bbox.astype(int)
    bbox_h = bbox[3] - bbox[1]
    bbox_w = bbox[2] - bbox[0]
    center = ((bbox[2] + bbox[0]) // 2, (bbox[3] + bbox[1]) // 2)
    side = max(bbox_h, bbox_w) if mode == "max" else min(bbox_h, bbox_w)
    dim = int(side // 2.0 * (1.0 + border_margin))
    return (center[0] - dim, center[1] - dim, center[0] + dim, center[1] + dim)


def get_bbox_from_verts(verts_2d: np.ndarray, vert_mask: np.ndarray) -> np.ndarray:
    head = verts_2d[vert_mask]
    bbox = [head[..., 0].min(), head[..., 1].min(), head[..., 0].max(), head[..., 1].max()]
    return np.array(get_square_bbox(np.array(bbox), border_margin=CROP_MARGIN))


def load_camera_rays(crop_box, intr, extr, target_resolution: int) -> np.ndarray:
    """World-space unit ray directions of the crop-adjusted camera (3,H,W)."""
    scale = target_resolution / (crop_box[2] - crop_box[0])
    new_fx = intr[0, 0] * scale
    new_fy = intr[1, 1] * scale
    new_cx = (intr[0, 2] - crop_box[0]) * scale
    new_cy = (intr[1, 2] - crop_box[1]) * scale
    u, v = np.meshgrid(np.arange(target_resolution), np.arange(target_resolution))
    d = np.stack(((u - new_cx) / new_fx, (v - new_cy) / new_fy, np.ones_like(u)), axis=0)
    d = d / (np.linalg.norm(d, axis=0, keepdims=True) + 1e-8)
    h = d.shape[1]
    d = np.linalg.inv(extr[:3, :3]) @ d.reshape(3, -1)
    return d.reshape(3, h, -1)


def load_frame(frame_dir: Path, frame_id: int) -> np.ndarray:
    """Frame ``frame_id`` (sorted order) of a directory of PNG or JPEG frames,
    RGB uint8. A video file raises ``ValueError``: the JAX package reads it
    with cv2's ``VideoCapture``, and the card's machine has no video decoder
    (no cv2, no ffmpeg)."""
    frame_dir = Path(frame_dir)
    if not frame_dir.is_dir():
        raise ValueError(f"{frame_dir}: frames must be a directory of PNG or JPEG images; "
                         "video input needs a video decoder (cv2 or ffmpeg), which the port "
                         "does not have")
    frames = sorted(frame_dir.glob("*.*"))
    if frame_id >= len(frames):
        print(f"WARNING: Frame {frame_id} out of bounds for video with length {len(frames)}")
        frame_id = len(frames) - 1
    return decode_image(frames[frame_id])


def adjust_intrinsics_crop(fx, fy, cx, cy, bbox, target_resolution):
    """Intrinsics of a square crop ``bbox`` resized to ``target_resolution``."""
    scale = target_resolution / (bbox[2] - bbox[0])
    return fx * scale, fy * scale, (cx - bbox[0]) * scale, (cy - bbox[1]) * scale


def get_crop_mask(orig_resolution, target_resolution, crop_box) -> np.ndarray:
    """1 inside the original image, 0 outside, in crop coordinates."""
    m = np.ones(orig_resolution)
    m = crop_image(m, crop_box, bg_value=0)
    return rescale_image(m, target_resolution)
