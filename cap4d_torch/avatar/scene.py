"""Avatar scene: cameras and dataset readers, host-side numpy (counterpart of
``cap4d_tpu/avatar/scene.py``).

Reference: gaussianavatars/scene/{cameras.py,dataset_readers.py,scene.py}:
per-frame {flame/*.npz, images/*.png} pairs from N source dirs, the head held
at the origin by moving the camera, crop-adjusted intrinsics and out-of-crop
masks, the last 10 % (at most 10) as the validation split, the driving
sequence reader (animation fit.npz and an optional orbit trajectory) and the
cameras.json dump. Images are read with the port's PNG reader.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from cap4d_torch.data.utils import adjust_intrinsics_crop, get_crop_mask
from cap4d_torch.flame.camera import OPENCV2PYTORCH3D, rodrigues
from cap4d_torch.utils.png import png_size, read_png


@dataclass
class AvatarCamera:
    """One training / evaluation / driving view (HWC images)."""

    uid: int
    rt: np.ndarray            # (4, 4) world→cam, OpenCV
    intrinsics: np.ndarray    # (3, 3)
    width: int
    height: int
    timestep: int
    image_path: Optional[Path] = None
    mask: Optional[np.ndarray] = None   # (H, W) in-crop mask
    _image: Optional[np.ndarray] = None

    @property
    def image(self) -> Optional[np.ndarray]:
        """(H, W, 3) float32 in [0, 1], read on first use."""
        if self._image is None and self.image_path is not None:
            self._image = read_png(self.image_path).astype(np.float32) / 255.0
        return self._image


def reverse_transform(extr: np.ndarray, rot: np.ndarray, tra: np.ndarray):
    """Fix the head at the origin and move the camera instead
    (dataset_readers.py:55-71)."""
    T_head = np.eye(4, dtype=np.float32)
    T_head[:3, :3] = rodrigues(torch.as_tensor(rot, dtype=torch.float32)[None])[0].numpy()
    T_head[:3, 3] = tra
    cv = OPENCV2PYTORCH3D
    new_extr = extr.astype(np.float32) @ cv @ T_head @ np.linalg.inv(cv)
    return new_extr, rot * 0.0, tra * 0.0


def load_cap4d_item(idx: int, flame_path: Path, image_path: Path):
    """One (flame npz, image) pair → (camera, mesh dict) (dataset_readers.py:74-129)."""
    item = dict(np.load(flame_path))
    crop_width, crop_height = png_size(image_path)
    orig_resolution = item["resolutions"][0]
    crop_box = item["crop_box"]
    fx, fy, cx, cy = [item[k].flatten()[0] for k in ("fx", "fy", "cx", "cy")]
    fx, fy, cx, cy = adjust_intrinsics_crop(fx, fy, cx, cy, crop_box, crop_width)
    crop_mask = get_crop_mask(orig_resolution, crop_width, crop_box)
    extr, rot, tra = reverse_transform(item["extr"].reshape(4, 4), item["rot"][0], item["tra"][0])
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    mesh = {"shape": item["shape"], "expr": item["expr"][0], "eye_rot": item["eye_rot"][0],
            "rot": rot, "tra": tra}
    cam = AvatarCamera(uid=idx, rt=extr, intrinsics=K, width=int(crop_width),
                       height=int(crop_height), timestep=idx, image_path=image_path,
                       mask=crop_mask)
    return cam, mesh


def read_cap4d_image_set(path: Path, cam_id_offset: int = 0):
    flame_paths = sorted((Path(path) / "flame").glob("*.npz"))
    img_paths = sorted((Path(path) / "images").glob("*.*"))
    assert len(flame_paths) > 0 and len(img_paths) == len(flame_paths), (
        f"{path}: {len(flame_paths)} flame vs {len(img_paths)} images")
    cams, meshes = [], []
    for i, (fp, ip) in enumerate(zip(flame_paths, img_paths)):
        c, m = load_cap4d_item(i + cam_id_offset, fp, ip)
        cams.append(c)
        meshes.append(m)
    return cams, meshes


def read_driving_sequence(animation_path: Path, cam_trajectory_path: Optional[Path] = None,
                          cam_id_offset: int = 0):
    """Driving fit.npz (+ optional orbit npz) → target cameras and FLAME
    parameters (dataset_readers.py:475-550)."""
    fit = dict(np.load(animation_path))
    n_frames = fit["expr"].shape[0]
    if cam_trajectory_path is not None:
        traj = dict(np.load(cam_trajectory_path))
        assert traj["extr"].shape[0] >= n_frames, "camera trajectory shorter than the driving sequence"
        extr_l, fx_l, fy_l, cx_l, cy_l = (traj["extr"], traj["fx"], traj["fy"], traj["cx"],
                                          traj["cy"])
        resolution = traj["resolution"]
    else:
        rep = lambda a: a[[0]].repeat(n_frames, axis=0)
        extr_l, fx_l, fy_l, cx_l, cy_l = map(rep, (fit["extr"], fit["fx"], fit["fy"], fit["cx"],
                                                   fit["cy"]))
        resolution = fit["resolutions"][0]
    cams, meshes = [], []
    for i in range(n_frames):
        extr, rot, tra = reverse_transform(extr_l[i], fit["rot"][i], fit["tra"][i])
        K = np.array([[fx_l[i, 0], 0, cx_l[i, 0]], [0, fy_l[i, 0], cy_l[i, 0]], [0, 0, 1]],
                     np.float32)
        meshes.append({"shape": np.zeros(150, np.float32), "expr": fit["expr"][i],
                       "eye_rot": fit["eye_rot"][i], "rot": rot, "tra": tra})
        cams.append(AvatarCamera(uid=cam_id_offset + i, rt=extr, intrinsics=K,
                                 width=int(resolution[1]), height=int(resolution[0]),
                                 timestep=cam_id_offset + i))
    return cams, meshes


@dataclass
class SceneInfo:
    train_cameras: List[AvatarCamera]
    test_cameras: List[AvatarCamera]
    val_cameras: List[AvatarCamera]
    train_meshes: List[Dict]
    test_meshes: List[Dict]
    tgt_cameras: List[AvatarCamera]
    tgt_meshes: List[Dict]
    cameras_extent: float = 1.0


def load_cap4d_dataset(source_paths: Optional[List[str]],
                       target_paths: Optional[Dict[str, Optional[str]]] = None,
                       val_ratio: float = 0.1, n_max_val_images: int = 10) -> SceneInfo:
    """Union of source dirs, last-N validation split, optional driving
    targets (dataset_readers.py:617-672)."""
    cams: List[AvatarCamera] = []
    meshes: List[Dict] = []
    for sp in source_paths or []:
        sp = Path(sp)
        assert sp.exists(), f"Source path does not exist: {sp}"
        c, m = read_cap4d_image_set(sp, cam_id_offset=len(cams))
        cams += c
        meshes += m
    n_frames = len(cams)
    n_val = max(1, min(n_max_val_images, int(n_frames * val_ratio))) if n_frames else 0
    n_val = min(n_val, n_frames - 1) if n_frames else 0   # never empty the train split
    tgt_cams: List[AvatarCamera] = []
    tgt_meshes: List[Dict] = []
    if target_paths is not None:
        traj = target_paths.get("cam_trajectory_path")
        tgt_cams, tgt_meshes = read_driving_sequence(
            Path(target_paths["animation_path"]), Path(traj) if traj else None,
            cam_id_offset=len(meshes))
    return SceneInfo(
        train_cameras=cams[:-n_val] if n_val else cams,
        test_cameras=cams[-n_val:] if n_val else [],
        val_cameras=cams[:n_val] if n_val else [],
        train_meshes=meshes, test_meshes=[],
        tgt_cameras=tgt_cams, tgt_meshes=tgt_meshes,
    )


def dump_cameras_json(cams: List[AvatarCamera], path: Path) -> None:
    """cameras.json provenance dump (scene.py:205-217)."""
    entries = []
    for i, cam in enumerate(cams):
        w2c = np.linalg.inv(cam.rt)
        entries.append({
            "id": i,
            "img_name": cam.image_path.stem if cam.image_path else str(i),
            "width": cam.width, "height": cam.height,
            "position": w2c[:3, 3].tolist(),
            "rotation": [r.tolist() for r in w2c[:3, :3]],
            "intrinsics": cam.intrinsics.tolist(),
        })
    with open(path, "w") as fh:
        json.dump(entries, fh)
