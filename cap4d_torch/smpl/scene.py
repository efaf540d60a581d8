"""SMPL dataset readers, host-side numpy: per-frame ``smpl/*.npz`` + images,
and the driving animation npz (counterpart of ``cap4d_tpu/smpl/scene.py``).

Reference: gaussianavatars/scene/dataset_readers.py:157-250 (loadSMPLItem),
:350-380 (readSMPLImageSet), :384-472 (readSMPLDrivingSequence), :553-600
(loadSMPLDataset). A frame's npz holds fx/fy/cx/cy, the R (3×3) and T (3,)
extrinsics and betas / body_pose / global_orient. Frames are PNG (the port's
reader); image sizes come from the PNG header.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from cap4d_torch.avatar.scene import AvatarCamera, SceneInfo
from cap4d_torch.utils.png import png_size


def load_smpl_item(idx: int, smpl_path: Path, image_path: Path):
    """One (smpl npz, image) pair → (camera, mesh dict)."""
    if Path(image_path).suffix.lower() != ".png":
        raise ValueError(f"{image_path}: frames must be PNG (the port reads PNG only)")
    item = dict(np.load(smpl_path))
    crop_width, crop_height = png_size(image_path)
    fx, fy, cx, cy = (float(np.asarray(item[k]).flatten()[0]) for k in ("fx", "fy", "cx", "cy"))
    extr = np.eye(4, dtype=np.float32)
    extr[:3, :3] = np.asarray(item["R"], np.float32).reshape(3, 3)
    extr[:3, 3] = np.asarray(item["T"], np.float32).flatten()[:3]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    mesh = {
        "betas": np.asarray(item.get("betas", np.zeros(10)), np.float32),
        "body_pose": np.asarray(item.get("body_pose", np.zeros(69)), np.float32).flatten(),
        "global_orient": np.asarray(item.get("global_orient", np.zeros(3)), np.float32).flatten(),
        "tra": np.zeros(3, np.float32),
        "rot": np.zeros(3, np.float32),
    }
    cam = AvatarCamera(uid=idx, rt=extr, intrinsics=K, width=int(crop_width),
                       height=int(crop_height), timestep=idx, image_path=image_path,
                       mask=np.ones((crop_height, crop_width), np.float32))
    return cam, mesh


def read_smpl_image_set(path: Path, cam_id_offset: int = 0):
    smpl_paths = sorted((Path(path) / "smpl").glob("*.npz"))
    img_paths = sorted((Path(path) / "images").glob("*.*"))
    assert len(smpl_paths) > 0 and len(img_paths) == len(smpl_paths), (
        f"{path}: {len(smpl_paths)} smpl vs {len(img_paths)} images")
    cams, meshes = [], []
    for i, (sp, ip) in enumerate(zip(smpl_paths, img_paths)):
        c, m = load_smpl_item(i + cam_id_offset, sp, ip)
        cams.append(c)
        meshes.append(m)
    return cams, meshes


def read_smpl_driving_sequence(animation_path: Path, cam_id_offset: int = 0):
    """Animation npz (the ``tools.generate_animation`` format) → target
    cameras and SMPL parameters."""
    fit = dict(np.load(animation_path))
    n_frames = fit["body_pose"].shape[0]
    resolution = fit.get("resolution", np.array([512, 512]))
    cams, meshes = [], []
    for i in range(n_frames):
        extr = np.eye(4, dtype=np.float32)
        if "R" in fit:
            extr[:3, :3] = np.asarray(fit["R"][i], np.float32)
        if "T" in fit:
            extr[:3, 3] = np.asarray(fit["T"][i], np.float32).flatten()[:3]
        K = np.array([[float(fit["fx"][i, 0]), 0, float(fit["cx"][i, 0])],
                      [0, float(fit["fy"][i, 0]), float(fit["cy"][i, 0])],
                      [0, 0, 1]], np.float32)
        meshes.append({
            "betas": np.asarray(fit.get("betas", np.zeros(10)), np.float32),
            "body_pose": np.asarray(fit["body_pose"][i], np.float32),
            "global_orient": np.asarray(fit["global_orient"][i], np.float32),
            "tra": np.zeros(3, np.float32),
            "rot": np.zeros(3, np.float32),
        })
        cams.append(AvatarCamera(uid=cam_id_offset + i, rt=extr, intrinsics=K,
                                 width=int(resolution[1]), height=int(resolution[0]),
                                 timestep=cam_id_offset + i))
    return cams, meshes


def load_smpl_dataset(source_paths: Optional[List[str]], target_animation_path: Optional[str] = None,
                      val_ratio: float = 0.1, n_max_val_images: int = 10) -> SceneInfo:
    """Union of source dirs, the last 10 % (at most 10) as the held-out split,
    an optional driving animation."""
    cams, meshes = [], []
    for sp in source_paths or []:
        sp = Path(sp)
        assert sp.exists(), f"Source path does not exist: {sp}"
        c, m = read_smpl_image_set(sp, cam_id_offset=len(cams))
        cams += c
        meshes += m
    n_frames = len(cams)
    n_val = max(1, min(n_max_val_images, int(n_frames * val_ratio))) if n_frames else 0
    tgt_cams, tgt_meshes = [], []
    if target_animation_path is not None:
        tgt_cams, tgt_meshes = read_smpl_driving_sequence(Path(target_animation_path),
                                                          cam_id_offset=len(meshes))
    return SceneInfo(
        train_cameras=cams[:-n_val] if n_val else cams,
        test_cameras=cams[-n_val:] if n_val else [],
        val_cameras=cams[:n_val] if n_val else [],
        train_meshes=meshes, test_meshes=[],
        tgt_cameras=tgt_cams, tgt_meshes=tgt_meshes,
        # the reference fixes the SMPL dataset's nerf_normalization radius at
        # 2.0 (dataset_readers.py:608; 1.0 for CAP4D): it scales the xyz
        # learning rate and the densification size threshold
        cameras_extent=2.0,
    )
