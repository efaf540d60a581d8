"""Export a subject's reference frames in stage-1 output format, skipping
the diffusion stage (counterpart of
``cap4d_tpu/tools/export_reference_frames.py``).

Writes ``<out>/reference_images/{images/*.png, flame/*.npz}``, the input
stage 2 (``cap4d_torch.avatar.train``) reads, from the tracked ``fit.npz`` +
``reference_images.json`` + photos: the frames the reference's
generate_images.py stages before sampling (cap4d/inference/utils.py:103-124).
For fitting an avatar to the real photos alone, or checking the stage-1 →
stage-2 contract. Host-side: FLAME runs on the CPU.

    python -m cap4d_torch.tools.export_reference_frames --reference_data_path subject \
        --output_path out
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from cap4d_torch.data.datasets import build_frame_set, load_reference_items
from cap4d_torch.flame.compute import load_cap4d_flame_model
from cap4d_torch.inference.generate_images import save_flame_params, save_images


def export_reference_frames(reference_data_path, output_path, resolution: int = 512,
                            flame_asset_dir="data/assets/flame") -> Path:
    out_ref = Path(output_path) / "reference_images"
    out_ref.mkdir(exist_ok=True, parents=True)
    flame_model = load_cap4d_flame_model(flame_asset_dir, n_shape_params=150, n_expr_params=65,
                                         add_mouth=True)
    head_ids = np.genfromtxt(Path(flame_asset_dir) / "head_vertices.txt").astype(int)
    ref_items, ref_extr = load_reference_items(Path(reference_data_path))
    ref_set = build_frame_set(flame_model, ref_items, head_ids, ref_extr, resolution,
                              is_reference=True)
    save_flame_params(ref_set.flame_items, out_ref)
    # [-1, 1] floats → uint8 as the JAX package's writer rounds them
    save_images((np.clip((ref_set.images + 1.0) / 2.0, 0, 1) * 255).astype(np.uint8), out_ref)
    print(f"Exported {len(ref_set.flame_items)} reference frames to {out_ref}")
    return out_ref


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--reference_data_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--flame_asset_dir", default="data/assets/flame")
    args = p.parse_args()
    export_reference_frames(args.reference_data_path, args.output_path, args.resolution,
                            args.flame_asset_dir)


if __name__ == "__main__":
    main()
