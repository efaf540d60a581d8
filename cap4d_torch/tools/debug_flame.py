"""Debug tool: a FLAME forward written as an OBJ (counterpart of
``cap4d_tpu/tools/debug_flame.py``; the reference's debug/debug.py and
scripts/show_flame.py open a viewer, a headless host gets an OBJ instead).

    python -m cap4d_torch.tools.debug_flame --flame_asset_dir data/assets/flame \
        [--fit_npz fit.npz --timestep 0] [--add_mouth] --output debug_flame.obj
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from cap4d_torch.flame.compute import load_cap4d_flame_model
from cap4d_torch.flame.skinner import flame_forward
from cap4d_torch.tools.debug_smpl import write_obj_mesh


def debug_flame(flame_asset_dir, output, fit_npz=None, timestep: int = 0,
                add_mouth: bool = False) -> Path:
    model = load_cap4d_flame_model(flame_asset_dir, n_shape_params=150, n_expr_params=65,
                                   add_mouth=add_mouth)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    with torch.no_grad():
        if fit_npz:
            fit = dict(np.load(fit_npz))
            out = flame_forward(model, t(fit["shape"]), t(fit["expr"][[timestep]]),
                                t(fit["rot"][[timestep]]), t(fit["tra"][[timestep]]),
                                eye_rot=t(fit["eye_rot"][[timestep]]))
        else:
            out = flame_forward(model, torch.zeros(150), torch.zeros(1, 65), torch.zeros(1, 3),
                                torch.zeros(1, 3))
    write_obj_mesh(output, out["verts"][0].numpy(), model.faces.numpy())
    return Path(output)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--flame_asset_dir", type=str, default="data/assets/flame")
    parser.add_argument("--fit_npz", type=str, default=None,
                        help="optional fit.npz; neutral pose otherwise")
    parser.add_argument("--timestep", type=int, default=0)
    parser.add_argument("--output", type=str, default="debug_flame.obj")
    parser.add_argument("--add_mouth", action="store_true")
    args = parser.parse_args()
    debug_flame(args.flame_asset_dir, args.output, args.fit_npz, args.timestep, args.add_mouth)


if __name__ == "__main__":
    main()
