"""Held-out-view quality of the head fit: fit on the training views of a
known 3DGS scene, report PSNR/SSIM/L1 on views the fit never saw, plus a
driving-sequence render statistic (counterpart of
``cap4d_tpu/tools/fit_holdout_quality.py``: same flags, scene, split and
result schema).

Ground truth comes from an oracle avatar rendered from a 30-view yaw orbit
around the head at 256², so every view sees the head. The last 10 % of the
views (3) are held out, as the reference's validation split does.

- Independent ground truth: the oracle renders through the plain PyTorch
  compositor (``render_camera(..., plain=True)``) while the fit trains and
  evaluates through the hand-written kernels K4/K5, so a fault of the
  kernels cannot hide in both sides.
- The oracle's deform net is perturbed with noise (its zero-initialised last
  layer included), so expressions drive a real UV-space deformation the
  fit's own deform net has to learn.

Usage:
    python -m cap4d_torch.tools.fit_holdout_quality [--iterations 1500] \\
        [--out examples_work/torch/holdout] [--lpips off|synthetic] [--device cpu]

Writes ``<out>/quality.json`` and ``<out>/holdout_NNN.png``; runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

RES = 256
N_VIEWS = 30      # the 10 % validation split then holds out exactly 3 views
N_HELD_OUT = 3

MODEL_PARAMS = dict(
    n_unet_layers=6, n_points_per_triangle=1, use_lower_jaw=False,
    static_neck=False, gaussian_init_type="scaled", use_expr_mask=True,
    uv_resolution=128, n_gaussians_init=24_000, sh_degree=1,
)
# the JAX package's avatar test opt_params, which its quality tools start from
OPT_PARAMS = dict(
    iterations=10, sh_warmup_iterations=5, lambda_scale=1.0, threshold_scale=1.0,
    lambda_xyz=1e-3, threshold_xyz=2.0, metric_xyz=False, metric_scale=False,
    feature_lr=0.0025, opacity_lr=0.025, scaling_lr=0.005, rotation_lr=0.001,
    percent_dense=0.01, lambda_dssim=0.5, densification_interval=3,
    densify_grad_threshold=1e-6, opacity_reset_interval=6, densify_until_iter=7,
    densify_from_iter=2, position_lr_init=5e-3, position_lr_final=5e-5,
    position_lr_delay_mult=0.01, position_lr_max_steps=1000, w_lpips=0.1,
    lambda_lpips_end=0.9, lpips_linear_start=100, lpips_linear_end=600,
    deform_net_w_decay=2e-3, deform_net_lr_init=1e-5, deform_net_lr_final=1e-7,
    deform_net_lr_delay_mult=0.01, deform_net_lr_max_steps=1000,
    lambda_laplacian=1.0, lambda_relative_deform=0.4, lambda_relative_rot=0.005,
    neck_lr_init=1e-5, neck_lr_final=1e-7, neck_lr_delay_mult=0.01,
    neck_lr_max_steps=1000, lambda_neck=1.0,
)


def orbit_extr(i, n, dist=1.2):
    """Camera i of an n-view yaw orbit around the head at the origin."""
    yaw = (i / n - 0.5) * 1.2
    c, s = np.cos(yaw), np.sin(yaw)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, :3] = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
    extr[2, 3] = dist
    return extr


def frame_item(i, shape, rng):
    return {
        "shape": shape,
        "expr": rng.normal(scale=0.25, size=(1, 65)).astype(np.float32),
        "rot": rng.normal(scale=0.03, size=(1, 3)).astype(np.float32),
        "tra": np.zeros((1, 3), np.float32),
        "eye_rot": np.zeros((1, 3), np.float32),
        "fx": np.full((1, 1), 500.0, np.float32),
        "fy": np.full((1, 1), 500.0, np.float32),
        "cx": np.full((1, 1), RES / 2, np.float32),
        "cy": np.full((1, 1), RES / 2, np.float32),
        "extr": orbit_extr(i, N_VIEWS)[None],
        "resolutions": np.array([[RES, RES]], np.int64),
        "crop_box": np.array([0, 0, RES, RES], np.int64),
        "timestep_id": i,
    }


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def seconds_per_iteration(metrics_path: Path) -> Optional[float]:
    """Host-clock seconds per fit iteration between the first and last
    logged iterations (None with fewer than two)."""
    steps = [json.loads(line) for line in open(metrics_path)]
    steps = [s for s in steps if "loss" in s and "elapsed_s" in s]
    if len(steps) < 2:
        return None
    return (steps[-1]["elapsed_s"] - steps[0]["elapsed_s"]) / (steps[-1]["iter"] - steps[0]["iter"])


def run(iterations: int = 1500, out: str | Path = "examples_work/torch/holdout",
        lpips: str = "off", lpips_weights: Optional[str] = None, device=None) -> dict:
    from cap4d_torch.avatar.losses import l1_loss, psnr, ssim
    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_torch.avatar.train import training
    from cap4d_torch.avatar.trainer import AvatarTrainer
    from cap4d_torch.tools.convert_lpips import (convert_torch_lpips, save_lpips_npz,
                                                 synthetic_lpips_states)
    from cap4d_torch.utils.device import resolve_device
    from cap4d_torch.utils.png import write_png
    from cap4d_torch.utils.synthetic_assets import make_asset_dir

    device = resolve_device(device)
    repo = Path(__file__).resolve().parents[2]
    out_root = repo / out
    out_root.mkdir(parents=True, exist_ok=True)
    work = out_root / "work"
    data_dir = work / "generated_images"
    (data_dir / "flame").mkdir(parents=True, exist_ok=True)
    (data_dir / "images").mkdir(parents=True, exist_ok=True)
    # a head-sized sphere template: local faces keep bound splats small
    flame_dir = make_asset_dir(work, sphere_radius=0.09)

    rng = np.random.default_rng(12)
    shape = rng.normal(scale=0.3, size=(150,)).astype(np.float32)
    items = [frame_item(i, shape, rng) for i in range(N_VIEWS)]
    for i, item in enumerate(items):
        np.savez(data_dir / "flame" / f"{i:05d}.npz", **item)
        write_png(data_dir / "images" / f"{i:05d}.png", np.zeros((RES, RES, 3), np.uint8))

    # ---- oracle avatar: a deterministic random init of the same scene with a
    # noise-perturbed deform net, rendered by the plain compositor
    scene0 = load_cap4d_dataset([str(data_dir)], n_max_val_images=N_HELD_OUT)
    oracle = AvatarTrainer.create(scene0, MODEL_PARAMS, dict(OPT_PARAMS), flame_asset_dir=flame_dir,
                                  seed=7, device=device)
    gen = torch.Generator(device="cpu").manual_seed(99)
    with torch.no_grad():
        for p in oracle.deform_net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device, p.dtype))
    for cam in sorted(scene0.train_cameras + scene0.test_cameras, key=lambda c: c.timestep):
        img = torch.clamp(oracle.render_camera(cam, int(cam.timestep), plain=True)["render"], 0, 1)
        write_png(data_dir / "images" / f"{cam.timestep:05d}.png",
                  (img.cpu().numpy() * 255).astype(np.uint8))
    del oracle

    # ---- fit a fresh avatar on the training split only
    opt = dict(OPT_PARAMS)
    opt.update(iterations=iterations, sh_warmup_iterations=max(iterations // 3, 1),
               densify_from_iter=100, densify_until_iter=iterations // 2,
               densification_interval=100, opacity_reset_interval=10 ** 9,
               lpips_linear_start=10 ** 9, lpips_linear_end=10 ** 9 + 1,
               position_lr_max_steps=iterations, deform_net_lr_max_steps=iterations,
               neck_lr_max_steps=iterations)
    synthetic = lpips_weights is None and lpips == "synthetic"
    if synthetic:
        # random VGG16 and non-negative heads through the same converter as
        # the real downloads: exercises the ramp and the loss end to end
        lpips_weights = work / "lpips_synthetic.npz"
        save_lpips_npz(convert_torch_lpips(*synthetic_lpips_states(seed=0)), lpips_weights)
    if lpips_weights is not None:
        opt.update(lpips_linear_start=iterations // 10, lpips_linear_end=(iterations * 7) // 10,
                   lambda_lpips_end=0.75, w_lpips=0.1)

    t0 = time.perf_counter()
    trainer = training(source_paths=[str(data_dir)], model_path=work / "avatar",
                       model_params=MODEL_PARAMS, opt_params=opt,
                       testing_iterations=[iterations], checkpoint_iterations=[],
                       flame_asset_dir=flame_dir, seed=3, n_max_val_images=N_HELD_OUT,
                       lpips_weights=str(lpips_weights) if lpips_weights else None,
                       device=device)
    fit_s = time.perf_counter() - t0

    # ---- held-out evaluation: the last N_HELD_OUT cameras never trained
    scene = load_cap4d_dataset([str(data_dir)], n_max_val_images=N_HELD_OUT)
    stats = {"psnr": [], "ssim": [], "l1": []}
    for cam in scene.test_cameras:
        img = torch.clamp(trainer.render_camera(cam, int(cam.timestep))["render"], 0, 1)
        gt = torch.as_tensor(cam.image, device=img.device)
        stats["psnr"].append(float(psnr(img, gt)))
        stats["ssim"].append(float(ssim(img, gt)))
        stats["l1"].append(float(l1_loss(img, gt)))
        write_png(out_root / f"holdout_{cam.timestep:03d}.png",
                  (img.cpu().numpy() * 255).astype(np.uint8))

    # ---- driving tripwire: trained timesteps' meshes from a held-out camera
    drive_stats = []
    cam = scene.test_cameras[-1]
    for t in range(4):
        img = torch.clamp(trainer.render_camera(cam, t % N_VIEWS)["render"], 0, 1).cpu().numpy()
        drive_stats.append([float(img.mean()), float(img.std())])

    result = {
        "scene": f"synthetic oracle avatar, {N_VIEWS} orbit views @{RES}px, "
                 f"{len(scene.test_cameras)} held out (10% val split, "
                 "dataset_readers.py:637-648 semantics)",
        "iterations": iterations,
        "n_gaussians": int(trainer.n_active),
        "fit_seconds": round(fit_s, 1),
        "holdout": {k: round(float(np.mean(v)), 4) for k, v in stats.items()},
        "holdout_per_view": {k: [round(x, 4) for x in v] for k, v in stats.items()},
        "driving_mean_std": [[round(a, 5), round(b, 5)] for a, b in drive_stats],
        "s_per_iteration": seconds_per_iteration(work / "avatar" / "metrics.jsonl"),
        "device": device_name(device),
        "tool": "cap4d_torch/tools/fit_holdout_quality.py",
    }
    if lpips_weights is not None:
        curve = [(r["iter"], r["lpips"]) for r in
                 (json.loads(line) for line in open(work / "avatar" / "metrics.jsonl"))
                 if "lpips" in r and "iter" in r]
        if not curve or not any(v != 0.0 for _, v in curve):
            raise RuntimeError("the lpips term never became active")
        result["lpips"] = {
            "weights": ("synthetic (random VGG through the converter; see "
                        "cap4d_torch/tools/convert_lpips.py for the real downloads)"
                        if synthetic else str(lpips_weights)),
            "ramp": [opt["lpips_linear_start"], opt["lpips_linear_end"]],
            "w_lpips": opt["w_lpips"],
            "lambda_lpips_end": opt["lambda_lpips_end"],
            "first_nonzero": next(([it, round(v, 8)] for it, v in curve if v != 0.0), None),
            "final": [curve[-1][0], round(curve[-1][1], 8)],
            "n_logged": len(curve),
        }
    with open(out_root / "quality.json", "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(result["holdout"]))
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=1500)
    ap.add_argument("--out", type=str, default="examples_work/torch/holdout")
    ap.add_argument("--lpips", choices=["off", "synthetic"], default="off",
                    help="'synthetic': turn on the perceptual term with randomly initialised "
                    "VGG/linear weights through tools/convert_lpips.py's converter")
    ap.add_argument("--lpips_weights", type=str, default=None,
                    help="converted lpips npz (overrides --lpips synthetic)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default is the card (cuda)")
    args = ap.parse_args()
    run(args.iterations, args.out, args.lpips, args.lpips_weights, args.device)


if __name__ == "__main__":
    main()
