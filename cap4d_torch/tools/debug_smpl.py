"""Debug tool: an SMPL forward written as an OBJ (counterpart of
``cap4d_tpu/tools/debug_smpl.py``; the reference's show_smpl.py opens a
viewer, a headless host gets an OBJ to inspect instead).

    python -m cap4d_torch.tools.debug_smpl --smpl_pkl SMPL_NEUTRAL.pkl \
        [--animation_npz wave.npz --timestep 0] --output debug_smpl.obj
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from cap4d_torch.smpl.model import build_smpl_model, load_smpl_pkl, smpl_forward


def write_obj_mesh(path, verts: np.ndarray, faces: np.ndarray) -> None:
    """``v x y z`` (6 decimals) and 1-based ``f a b c`` lines."""
    lines = [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in verts]
    lines += [f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}" for f in faces]
    Path(path).write_text("\n".join(lines) + "\n")
    print(f"Wrote {path}: {len(verts)} verts, {len(faces)} faces")


def debug_smpl(smpl_pkl, output, animation_npz=None, timestep: int = 0) -> Path:
    model = build_smpl_model(load_smpl_pkl(smpl_pkl))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    if animation_npz:
        anim = dict(np.load(animation_npz))
        out = smpl_forward(model, t(anim.get("betas", np.zeros(10))),
                           t(anim["body_pose"][[timestep]]), t(anim["global_orient"][[timestep]]))
    else:
        out = smpl_forward(model, torch.zeros(10), torch.zeros(1, 69), torch.zeros(1, 3))
    write_obj_mesh(output, out["verts"][0].numpy(), model.faces.numpy())
    return Path(output)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--smpl_pkl", type=str, default="data/assets/smpl/SMPL_NEUTRAL.pkl")
    parser.add_argument("--animation_npz", type=str, default=None)
    parser.add_argument("--timestep", type=int, default=0)
    parser.add_argument("--output", type=str, default="debug_smpl.obj")
    args = parser.parse_args()
    debug_smpl(args.smpl_pkl, args.output, args.animation_npz, args.timestep)


if __name__ == "__main__":
    main()
