"""Quality fit of the avatar on the real tesla reference photo (counterpart
of ``cap4d_tpu/tools/fit_tesla_quality.py``).

Runs stage 2 on ``examples_work/tesla/stage1/reference_images`` (in the
repository: one real photo at 512 px with a FLAME fit to a sphere-template
synthetic FLAME, whose assets are rebuilt here from seed 0) with
``configs/avatar/default.yaml`` cut to ``--iterations``, and reports
train-view PSNR/SSIM/L1: reconstruction capacity of the whole fit (FLAME →
deform net → binding → K4/K5 → losses → Adam), not novel-view quality.

Usage:
    python -m cap4d_torch.tools.fit_tesla_quality [--iterations 4000] \\
        [--root examples_work/tesla] [--out examples_work/torch/tesla] [--device cpu]

Reads ``--root`` and writes only under ``--out`` (``quality.json``,
``avatar/``, ``assets/``).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from cap4d_torch.tools.fit_holdout_quality import device_name


def run(root: str | Path = "examples_work/tesla", out: str | Path = "examples_work/torch/tesla",
        iterations: int = 4000, device=None) -> dict:
    from cap4d_torch.avatar.losses import l1_loss, psnr, ssim
    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_torch.avatar.train import training
    from cap4d_torch.utils.config import load_yaml
    from cap4d_torch.utils.device import resolve_device
    from cap4d_torch.utils.png import write_png
    from cap4d_torch.utils.synthetic_assets import make_asset_dir

    device = resolve_device(device)
    repo = Path(__file__).resolve().parents[2]
    source = repo / root / "stage1" / "reference_images"
    out_root = repo / out
    out_root.mkdir(parents=True, exist_ok=True)
    flame_dir = make_asset_dir(out_root, sphere_radius=0.09)
    cfg = load_yaml(repo / "configs" / "avatar" / "default.yaml")
    opt = dict(cfg["opt_params"])
    n = iterations
    opt.update(
        iterations=n,
        sh_warmup_iterations=max(n // 4, 1),
        densify_from_iter=n // 8,
        densify_until_iter=int(n * 0.8),
        densification_interval=max(n // 8, 1),
        opacity_reset_interval=n + 1,      # a single view: never reset opacity
        lpips_linear_start=n // 4, lpips_linear_end=int(n * 0.7),
        position_lr_max_steps=n * 10,
        deform_net_lr_max_steps=n * 10,
        neck_lr_max_steps=n * 10,
    )
    model_path = out_root / "avatar"
    t0 = time.perf_counter()
    trainer = training(source_paths=[str(source)], model_path=model_path,
                       model_params=dict(cfg["model_params"], use_lower_jaw=False),
                       opt_params=opt, testing_iterations=[], checkpoint_iterations=[n],
                       flame_asset_dir=flame_dir, device=device)
    fit_s = time.perf_counter() - t0

    scene = load_cap4d_dataset([str(source)])
    stats = {"psnr": [], "ssim": [], "l1": []}
    for cam in scene.train_cameras + scene.val_cameras + scene.test_cameras:
        img = torch.clamp(trainer.render_camera(cam, int(cam.timestep))["render"], 0, 1)
        gt = torch.as_tensor(cam.image, device=img.device)
        stats["psnr"].append(float(psnr(img, gt)))
        stats["ssim"].append(float(ssim(img, gt)))
        stats["l1"].append(float(l1_loss(img, gt)))
        write_png(model_path / f"final_render_{cam.timestep:03d}.png",
                  (img.cpu().numpy() * 255).astype(np.uint8))

    result = {
        "subject": "tesla (1 real reference photo, 512px, synthetic sphere FLAME)",
        "iterations": n,
        "n_gaussians": int(trainer.n_active),
        "fit_seconds": round(fit_s, 1),
        "fit_iters_per_sec": round(n / fit_s, 2),
        **{k: round(float(np.mean(v)), 4) for k, v in stats.items()},
        "device": device_name(device),
        "tool": "cap4d_torch/tools/fit_tesla_quality.py",
    }
    with open(out_root / "quality.json", "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(result))
    return result


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="examples_work/tesla",
                   help="holds stage1/reference_images (read only)")
    p.add_argument("--out", default="examples_work/torch/tesla")
    p.add_argument("--iterations", type=int, default=4000)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default is the card (cuda)")
    args = p.parse_args()
    run(args.root, args.out, args.iterations, args.device)


if __name__ == "__main__":
    main()
