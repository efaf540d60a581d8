"""Write an orbit camera trajectory npz for animation (counterpart of
``cap4d_tpu/tools/make_orbit.py``).

The reference reads orbit trajectories (orbit.npz: extr (N, 4, 4),
fx/fy/cx/cy (N, 1), resolution (2); gaussianavatars/scene/
dataset_readers.py:484-497) but ships no generator; this one pivots the
subject's camera around the head with the pivot of the generation stage's
camera sampling.

    python -m cap4d_torch.tools.make_orbit --fit_npz fit.npz --output orbit.npz
"""

from __future__ import annotations

import argparse

import numpy as np

from cap4d_torch.data.datasets import pivot_camera_intrinsic


def make_orbit(fit_npz: str, n_frames: int = 384, yaw_amplitude: float = 40.0,
               pitch_amplitude: float = 10.0, cam_id: int = 0):
    fit = dict(np.load(fit_npz))
    base_extr = np.asarray(fit["extr"][cam_id], np.float32).reshape(4, 4)
    tra = np.asarray(fit["tra"][0], np.float32).copy()
    tra[1:] = -tra[1:]   # pytorch3d → OpenCV
    t = np.arange(n_frames) / n_frames * 2 * np.pi
    yaws = np.sin(t) * yaw_amplitude
    pitches = np.sin(2 * t) * pitch_amplitude
    extr = np.stack([pivot_camera_intrinsic(base_extr, tra, [float(y), float(p)])
                     for y, p in zip(yaws, pitches)]).astype(np.float32)
    rep = lambda key: np.repeat(fit[key][[cam_id]], n_frames, axis=0).astype(np.float32)
    return {"extr": extr, "fx": rep("fx"), "fy": rep("fy"), "cx": rep("cx"), "cy": rep("cy"),
            "resolution": np.asarray(fit["resolutions"][cam_id])}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--fit_npz", type=str, required=True,
                        help="subject or animation fit.npz providing the base camera")
    parser.add_argument("--n_frames", type=int, default=384)
    parser.add_argument("--yaw", type=float, default=40.0)
    parser.add_argument("--pitch", type=float, default=10.0)
    parser.add_argument("--output", type=str, default="orbit.npz")
    args = parser.parse_args()
    np.savez(args.output, **make_orbit(args.fit_npz, args.n_frames, args.yaw, args.pitch))
    print(f"Wrote {args.output}: {args.n_frames}-frame orbit")


if __name__ == "__main__":
    main()
