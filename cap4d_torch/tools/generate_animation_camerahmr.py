"""Merge per-frame CameraHMR SMPL fits into one animation npz (counterpart of
``cap4d_tpu/tools/generate_animation_camerahmr.py``).

Reference: generate_animation_camerahmr.py: the sorted ``*.npz`` fits (each
with betas / global_orient / body_pose / T / R) stacked, the first fit's
betas shared, pinhole intrinsics attached; the input of
``cap4d_torch.avatar.animate_smpl``.

    python -m cap4d_torch.tools.generate_animation_camerahmr --folder_path npzs \
        --output combined_animation.npz
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def combine_camerahmr_fits(folder_path: str | Path, resolution=(1080, 1920)):
    resolution = np.asarray(resolution)
    npz_files = sorted(Path(folder_path).glob("*.npz"))
    n_frames = len(npz_files)
    if n_frames == 0:
        raise ValueError(f"no npz files found in {folder_path}")
    betas = None
    global_orient = np.zeros((n_frames, 3), np.float32)
    body_pose = np.zeros((n_frames, 69), np.float32)
    transl = np.zeros((n_frames, 3), np.float32)
    R = np.zeros((n_frames, 3, 3), np.float32)
    for i, f in enumerate(npz_files):
        data = np.load(f)
        if betas is None:
            betas = np.asarray(data["betas"], np.float32)   # shared across frames
        global_orient[i] = np.asarray(data["global_orient"]).flatten()
        body_pose[i] = np.asarray(data["body_pose"]).flatten()
        transl[i] = np.asarray(data["T"]).flatten()[:3]
        R[i] = np.asarray(data["R"]).reshape(3, 3)
    fx = np.full((n_frames, 1), resolution[1] * 0.5, np.float32)
    fy = np.full((n_frames, 1), resolution[0] * 0.5, np.float32)
    cx = np.full((n_frames, 1), resolution[1] / 2, np.float32)
    cy = np.full((n_frames, 1), resolution[0] / 2, np.float32)
    return dict(betas=betas, global_orient=global_orient, body_pose=body_pose,
                T=transl, R=R, fx=fx, fy=fy, cx=cx, cy=cy, resolution=resolution)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--folder_path", type=str, default="./npzs")
    parser.add_argument("--output", type=str, default="combined_animation.npz")
    parser.add_argument("--resolution", type=int, nargs=2, default=[1080, 1920])
    args = parser.parse_args()
    np.savez(args.output, **combine_camerahmr_fits(args.folder_path, args.resolution))
    print(f"Combined animation NPZ saved to: {args.output}")


if __name__ == "__main__":
    main()
