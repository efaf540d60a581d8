"""Inference data pipeline: reference frames and generation targets
(counterpart of ``cap4d_tpu/data/datasets.py``).

All frames' FLAME forwards and projections run as one batched call on the
FLAME model's device; image I/O, crop boxes and ray maps stay on the host.
Reference frames go through the native runtime's fused decode → crop →
resize on a thread pool (``runtime.loader.NativePrefetcher``) when no frame
has a background directory, as in the JAX package; frames with one take the
Python path (``data/utils.py``), which composites the background first.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from cap4d_torch.data.utils import (
    apply_bg,
    crop_image,
    get_bbox_from_verts,
    load_camera_rays,
    load_frame,
    rescale_image,
    verts_to_pytorch3d,
)
from cap4d_torch.flame.camera import OPENCV2PYTORCH3D
from cap4d_torch.runtime.loader import NativePrefetcher
from cap4d_torch.flame.skinner import FlameModel, flame_forward


def compute_frame_geometry(model: FlameModel, frames: Dict[str, torch.Tensor]):
    """Batched FLAME forward + per-frame camera projection.

    frames: shape (N, 150), expr (N, 65), rot/tra/eye_rot (N, 3),
    fx/fy/cx/cy (N,), extr (N, 4, 4). Returns verts_2d (N, V, 3) in pixels
    (depth normalised as in ``project_vertices``) and offsets_3d (N, V, 3)."""
    with torch.no_grad():
        out = flame_forward(model, frames["shape"], frames["expr"], frames["rot"],
                            frames["tra"], frames["eye_rot"])
        cv = torch.as_tensor(OPENCV2PYTORCH3D[:3, :3], device=out["verts"].device)
        v = out["verts"] @ cv.T
        extr = frames["extr"]
        v_cam = v @ extr[:, :3, :3].transpose(-1, -2) + extr[:, None, :3, 3]
        z = v_cam[..., 2]
        fx, fy = frames["fx"][:, None], frames["fy"][:, None]
        x_px = v_cam[..., 0] / z * fx + frames["cx"][:, None]
        y_px = v_cam[..., 1] / z * fy + frames["cy"][:, None]
        z_n = z / z.mean(dim=-1, keepdim=True) * (fx + fy) / 2.0
        return torch.stack([x_px, y_px, z_n], dim=-1), out["offsets"]


@dataclass
class FrameSet:
    """A set of frames with everything the conditioning encoder needs."""

    flame_items: List[Dict[str, np.ndarray]]  # per-frame params (saved as flame/*.npz)
    images: Optional[np.ndarray]              # (N, R, R, 3) in [-1,1] or None
    verts_2d: np.ndarray                      # (N, 1, V, 3) NDC
    offsets_3d: np.ndarray                    # (N, 1, V, 3)
    ray_map: np.ndarray                       # (N, 1, 3, h, w)
    reference_mask: np.ndarray                # (N, 1, h, w)
    out_crop_mask: np.ndarray                 # (N, 1, h, w)

    def cond_batch(self) -> Dict[str, np.ndarray]:
        return {
            "verts_2d": self.verts_2d,
            "offsets_3d": self.offsets_3d,
            "ray_map": self.ray_map,
            "reference_mask": self.reference_mask,
            "out_crop_mask": self.out_crop_mask,
        }


def _stack(flame_items, key) -> np.ndarray:
    vals = []
    for it in flame_items:
        a = np.asarray(it[key], np.float32)
        if key == "shape":
            vals.append(a)
        elif key == "extr":
            vals.append(a.reshape(-1, 4, 4)[0])
        elif key in ("fx", "fy", "cx", "cy"):
            vals.append(a.flatten()[0])
        else:  # expr / rot / tra / eye_rot arrive as (1, d)
            vals.append(a[0])
    return np.stack(vals)


def build_frame_set(
    flame_model: FlameModel,
    flame_items: List[Dict[str, np.ndarray]],
    head_vertex_ids: np.ndarray,
    ref_extr: np.ndarray,
    resolution: int = 512,
    downsample_ratio: int = 8,
    is_reference: bool = False,
) -> FrameSet:
    """Assemble conditioning inputs for a list of frames
    (``cap4d_tpu/data/datasets.py:93``)."""
    latent_res = resolution // downsample_ratio
    n = len(flame_items)
    dev = flame_model.template.device
    stacked = {k: torch.as_tensor(_stack(flame_items, k), device=dev)
               for k in ("shape", "expr", "rot", "tra", "eye_rot", "fx", "fy", "cx", "cy", "extr")}
    verts_2d_px, offsets = compute_frame_geometry(flame_model, stacked)
    verts_2d_px = verts_2d_px.cpu().numpy()
    offsets = offsets.cpu().numpy()

    verts_out = np.empty((n, 1, *verts_2d_px.shape[1:]), np.float32)
    rays = np.empty((n, 1, 3, latent_res, latent_res), np.float32)
    out_crop = np.ones((n, 1, latent_res, latent_res), np.float32)
    images = np.zeros((n, resolution, resolution, 3), np.float32) if is_reference else None

    # fast path: fused native decode + crop + resize on a worker pool (no
    # bg-weight compositing, so frames with a bg dir take the Python path)
    prefetch = None
    if is_reference and not any("bg_dir_path" in it for it in flame_items):
        prefetch = NativePrefetcher(n_threads=8)
    tickets: Dict[int, int] = {}
    try:
        for i, item in enumerate(flame_items):
            v2d = verts_2d_px[i].copy()
            crop_box = get_bbox_from_verts(v2d, head_vertex_ids)
            item["crop_box"] = crop_box

            intr = np.eye(3)
            intr[0, 0] = item["fx"].flatten()[0]
            intr[1, 1] = item["fy"].flatten()[0]
            intr[0, 2] = item["cx"].flatten()[0]
            intr[1, 2] = item["cy"].flatten()[0]
            extr = np.asarray(item["extr"], np.float32).reshape(4, 4)

            if is_reference:
                img_dir = item.pop("img_dir_path")
                timestep_id = int(item["timestep_id"])
                frame_path = None
                if prefetch is not None and Path(img_dir).is_dir():
                    frames = sorted(Path(img_dir).glob("*.*"))
                    if timestep_id < len(frames):
                        frame_path = frames[timestep_id]
                if frame_path is not None:
                    tickets[i] = prefetch.submit(frame_path, crop_box, resolution)
                    res = item["resolutions"].flatten()
                    ocm = np.ones((int(res[0]), int(res[1]), 1), np.float32)
                else:
                    img = load_frame(img_dir, timestep_id)
                    if "bg_dir_path" in item:
                        bg = load_frame(item.pop("bg_dir_path"), timestep_id)
                    else:
                        bg = np.ones_like(img) * 255
                    ocm = np.ones_like(img[..., [0]], np.float32)
                    img = apply_bg(img, bg)
                    img = crop_image(img, crop_box, bg_value=255)
                    img = rescale_image(img, resolution)
                    images[i] = ((img / 127.5) - 1.0).astype(np.float32)
                ocm = crop_image(ocm, crop_box, bg_value=0)
                out_crop[i, 0] = rescale_image(ocm, latent_res)

            ray = load_camera_rays(crop_box, intr, extr, latent_res)
            h = ray.shape[1]
            rays[i, 0] = (ref_extr[:3, :3] @ ray.reshape(3, -1)).reshape(3, h, -1)
            verts_out[i, 0] = verts_to_pytorch3d(v2d, crop_box)

        for i, ticket in tickets.items():
            images[i] = prefetch.wait(ticket, resolution)
    finally:
        if prefetch is not None:
            prefetch.close()

    ref_mask = np.full((n, 1, latent_res, latent_res), float(is_reference), np.float32)
    return FrameSet(
        flame_items=flame_items,
        images=images,
        verts_2d=verts_out,
        offsets_3d=offsets[:, None],
        ray_map=rays,
        reference_mask=ref_mask,
        out_crop_mask=out_crop,
    )


def load_reference_items(data_path: Path) -> tuple[List[Dict], np.ndarray]:
    """fit.npz + reference_images.json → per-frame flame items + the first
    reference's extrinsics."""
    data_path = Path(data_path)
    flame_dict = dict(np.load(data_path / "fit.npz"))
    with open(data_path / "reference_images.json") as f:
        ref_json = json.load(f)

    flame_list, ref_extr = [], None
    for cam_name, timestep_id in ref_json:
        cam_id = int(np.where(flame_dict["camera_order"] == cam_name)[0].item())
        item: Dict = {}
        for key in flame_dict:
            if key in ("expr", "rot", "tra", "eye_rot"):
                item[key] = flame_dict[key][[timestep_id]]
            elif key in ("fx", "fy", "cx", "cy", "extr", "resolutions"):
                item[key] = flame_dict[key][[cam_id]]
            elif key == "shape":
                item[key] = flame_dict[key]
        item["timestep_id"] = timestep_id
        cam_dir = str(flame_dict["camera_order"][cam_id])
        item["img_dir_path"] = data_path / "images" / cam_dir
        bg_dir = data_path / "bg" / cam_dir
        if bg_dir.exists():
            item["bg_dir_path"] = bg_dir
        flame_list.append(item)
        if ref_extr is None:
            ref_extr = item["extr"]
    return flame_list, ref_extr[0]


def pivot_camera_intrinsic(extrinsics, target, angles, distance_factor=1.0):
    """Rotate a camera around a target point."""
    from scipy.spatial.transform import Rotation as R

    c2w = np.linalg.inv(extrinsics)
    R_c2w = c2w[:3, :3]
    t_c2w = c2w[:3, 3]
    v = (t_c2w - target) * distance_factor
    R_delta = R.from_euler("YX", angles, degrees=True).as_matrix()
    new_R = R_c2w @ R_delta
    new_t = target + R_c2w @ R_delta @ np.linalg.inv(R_c2w) @ v
    out = np.eye(4)
    out[:3, :3] = new_R
    out[:3, 3] = new_t
    return out


def elipsis_sample(yaw_limit, pitch_limit, rng=np.random):
    """Uniform inside the (yaw, pitch) ellipse."""
    if yaw_limit == 0.0 or pitch_limit == 0.0:
        return 0.0, 0.0
    while True:
        yaw = rng.uniform(-yaw_limit, yaw_limit)
        pitch = rng.uniform(-pitch_limit, pitch_limit)
        if np.sqrt((yaw / yaw_limit) ** 2 + (pitch / pitch_limit) ** 2) < 1.0:
            return yaw, pitch


def make_generation_items(
    gen_data: Dict[str, np.ndarray],
    reference_flame_item: Dict[str, np.ndarray],
    n_samples: int = 840,
    yaw_range: float = 55.0,
    pitch_range: float = 20.0,
    expr_factor: float = 1.0,
    rng=np.random,
) -> List[Dict]:
    """Generation targets: expression bank + cameras pivoted around the head."""
    ref = reference_flame_item
    ref_tra_cv = np.asarray(ref["tra"]).copy()
    ref_tra_cv[:, 1:] = -ref_tra_cv[:, 1:]  # pytorch3d → opencv
    if n_samples > len(gen_data["expr"]):
        raise ValueError(f"n_samples={n_samples} exceeds the {len(gen_data['expr'])} "
                         "expressions in the generation bank")
    items = []
    for expr, eye_rot in zip(gen_data["expr"][:n_samples], gen_data["eye_rot"][:n_samples]):
        yaw, pitch = elipsis_sample(yaw_range, pitch_range, rng)
        rotated = pivot_camera_intrinsic(np.asarray(ref["extr"])[0], ref_tra_cv[0], [yaw, pitch])
        items.append({
            "shape": ref["shape"],
            "expr": expr[None] * expr_factor,
            "eye_rot": eye_rot[None] * expr_factor,
            "rot": ref["rot"],
            "tra": ref["tra"],
            "extr": rotated[None].astype(np.float32),
            "resolutions": ref["resolutions"],
            "fx": ref["fx"], "fy": ref["fy"], "cx": ref["cx"], "cy": ref["cy"],
        })
    return items
