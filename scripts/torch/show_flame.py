"""FLAME mesh viewer on the PyTorch port (counterpart of scripts/show_flame.py).

Usage:
    python scripts/torch/show_flame.py <fit.npz> [--flame_asset_dir data/assets/flame]
                                       [--frame 0] [--out mesh.obj] [--device cpu]

Loads a CAP4D fit.npz (shape/expr/rot/tra arrays), runs the port's FLAME
skinner (``cap4d_torch.flame``) and opens an open3d window where open3d is
installed, else writes an OBJ to ``--out`` for any external viewer.
``cap4d_torch/tools/debug_flame.py`` is the batch variant for whole
sequences. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("fit", type=str, help="fit.npz with shape/expr/rot/tra")
    ap.add_argument("--flame_asset_dir", type=str, default="data/assets/flame")
    ap.add_argument("--frame", type=int, default=0)
    ap.add_argument("--out", type=str, default=None,
                    help="OBJ output path (used when open3d is unavailable)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default is the card (cuda)")
    args = ap.parse_args()

    from cap4d_torch.flame.compute import compute_flame, load_cap4d_flame_model
    from cap4d_torch.utils.device import resolve_device

    model = load_cap4d_flame_model(args.flame_asset_dir, n_shape_params=150, n_expr_params=65,
                                   add_mouth=True, device=resolve_device(args.device))
    fit = dict(np.load(args.fit))
    f = args.frame
    item = {
        "shape": fit["shape"].reshape(-1)[:150],
        "expr": fit["expr"][f : f + 1],
        "rot": fit["rot"][f : f + 1],
        "tra": fit["tra"][f : f + 1],
        "eye_rot": fit.get("eye_rot", np.zeros((len(fit["expr"]), 3)))[f : f + 1],
        # a viewer: identity camera, only verts_3d is read
        "fx": np.ones((1, 1)), "fy": np.ones((1, 1)),
        "cx": np.zeros((1, 1)), "cy": np.zeros((1, 1)),
        "extr": np.eye(4, dtype=np.float32)[None],
    }
    verts = np.asarray(compute_flame(model, item)["verts_3d"][0])
    faces = model.faces.cpu().numpy()
    print(f"frame {f}: {verts.shape[0]} vertices, {faces.shape[0]} faces, "
          f"bbox {verts.min(0)} .. {verts.max(0)}")

    try:
        import open3d as o3d
    except ImportError:
        out = Path(args.out or (Path(args.fit).stem + f"_frame{f}.obj"))
        with open(out, "w") as fh:
            for v in verts:
                fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for tri in faces + 1:
                fh.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
        print(f"open3d not installed: wrote {out} (open with any OBJ viewer)")
        return
    mesh = o3d.geometry.TriangleMesh()
    mesh.vertices = o3d.utility.Vector3dVector(verts.astype(np.float64))
    mesh.triangles = o3d.utility.Vector3iVector(faces.astype(np.int32))
    mesh.compute_vertex_normals()
    o3d.visualization.draw_geometries([mesh])


if __name__ == "__main__":
    main()
