"""Write a procedural SMPL waving animation npz (counterpart of
``cap4d_tpu/tools/generate_animation.py``).

Reference: generate_animation.py: the right shoulder (joint 17) raised, the
elbow (joint 19) bent, the wrist (joint 21) waving twice over the sequence.
Keys: betas, global_orient, body_pose, T, R, fx/fy/cx/cy, resolution, the
input of ``cap4d_torch.avatar.animate_smpl``.

    python -m cap4d_torch.tools.generate_animation --n_frames 100 --output wave.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cap4d_torch.flame.camera import rodrigues


def make_wave_animation(n_frames: int = 100, resolution=(1080, 1080)):
    resolution = np.asarray(resolution)
    betas = np.zeros(10, np.float32)
    global_orient = np.zeros((n_frames, 3), np.float32)
    body_pose = np.zeros((n_frames, 69), np.float32)
    # raise the right shoulder (joint 17 → 48:51), bend the elbow (19 → 54:57)
    body_pose[:, 48:51] = [0.0, 0.0, np.pi / 3]
    body_pose[:, 54:57] = [0.0, 0.0, np.pi / 4]
    # wave the right wrist (joint 21 → 60:63): two full periods
    t = np.arange(n_frames) / n_frames * 4 * np.pi
    body_pose[:, 60] = np.sin(t) * np.pi / 6
    transl = np.zeros((n_frames, 3), np.float32)
    transl[:, 2] = 2.0
    R = rodrigues(torch.as_tensor(global_orient)).numpy()
    fx = np.full((n_frames, 1), resolution[1] * 0.5, np.float32)
    fy = np.full((n_frames, 1), resolution[0] * 0.5, np.float32)
    cx = np.full((n_frames, 1), resolution[1] / 2, np.float32)
    cy = np.full((n_frames, 1), resolution[0] / 2, np.float32)
    return dict(betas=betas, global_orient=global_orient, body_pose=body_pose,
                T=transl, R=R, fx=fx, fy=fy, cx=cx, cy=cy, resolution=resolution)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_frames", type=int, default=100)
    parser.add_argument("--output", type=str, default="right_hand_wave_animation.npz")
    args = parser.parse_args()
    np.savez(args.output, **make_wave_animation(args.n_frames))
    print(f"Right hand waving animation NPZ saved to: {args.output}")


if __name__ == "__main__":
    main()
