"""The full default avatar fit as a user runs it: ``configs/avatar/default.yaml``
verbatim (10,000 iterations, 512 px, 100k initial gaussians) through the real
``training()`` loop (counterpart of ``cap4d_tpu/tools/fit_default_full.py``:
the same orbit scene, ``--views``, ``--config`` and ``--interval``).

Scene: a synthetic head-sized oracle avatar rendered through K4 from an orbit
of cameras at 512 px (the real stage-1 outputs need the MMDM weights; wall
time depends on the shapes, not on the scene's content). The result is the
fit's wall time, its steady rate from ``metrics.jsonl``'s host clock, and
train-view PSNR/SSIM as a check that the fit learned the scene.

Usage:
    python -m cap4d_torch.tools.fit_default_full [--views 200] \\
        [--out examples_work/torch/fit_default] [--interval 0] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from cap4d_torch.tools.fit_holdout_quality import OPT_PARAMS, device_name

RES = 512
N_VIEWS_DEFAULT = 200


def orbit_extr(i, n, dist=1.2):
    yaw = (i / n - 0.5) * 1.4
    pitch = 0.25 * np.sin(2 * np.pi * i / max(n, 1) * 3)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, :3] = rx @ ry
    extr[2, 3] = dist
    return extr


def frame_item(i, n_views, shape, rng):
    return {
        "shape": shape,
        "expr": rng.normal(scale=0.25, size=(1, 65)).astype(np.float32),
        "rot": rng.normal(scale=0.03, size=(1, 3)).astype(np.float32),
        "tra": np.zeros((1, 3), np.float32),
        "eye_rot": np.zeros((1, 3), np.float32),
        "fx": np.full((1, 1), 2200.0, np.float32),
        "fy": np.full((1, 1), 2200.0, np.float32),
        "cx": np.full((1, 1), RES / 2, np.float32),
        "cy": np.full((1, 1), RES / 2, np.float32),
        "extr": orbit_extr(i, n_views)[None],
        "resolutions": np.array([[RES, RES]], np.int64),
        "crop_box": np.array([0, 0, RES, RES], np.int64),
        "timestep_id": i,
    }


def run(views: int = N_VIEWS_DEFAULT, out: str | Path = "examples_work/torch/fit_default",
        config: str = "configs/avatar/default.yaml", interval: int = 0, device=None) -> dict:
    from cap4d_torch.avatar.losses import psnr, ssim
    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_torch.avatar.train import training
    from cap4d_torch.avatar.trainer import AvatarTrainer
    from cap4d_torch.utils.config import load_yaml
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
    flame_dir = make_asset_dir(work, sphere_radius=0.09)

    rng = np.random.default_rng(21)
    shape = rng.normal(scale=0.3, size=(150,)).astype(np.float32)
    for i in range(views):
        np.savez(data_dir / "flame" / f"{i:05d}.npz", **frame_item(i, views, shape, rng))
        write_png(data_dir / "images" / f"{i:05d}.png", np.zeros((RES, RES, 3), np.uint8))

    # ---- the oracle avatar renders the ground-truth views
    cfg = load_yaml(repo / config)
    model_params = dict(cfg["model_params"], use_lower_jaw=False)
    scene0 = load_cap4d_dataset([str(data_dir)])
    oracle = AvatarTrainer.create(scene0, model_params, dict(OPT_PARAMS), flame_asset_dir=flame_dir,
                                  seed=7, device=device)
    oracle.active_sh_degree = oracle.config.sh_degree
    t_gt = time.perf_counter()
    for cam in sorted(scene0.train_cameras + scene0.test_cameras, key=lambda c: c.timestep):
        img = torch.clamp(oracle.render_camera(cam, int(cam.timestep))["render"], 0, 1)
        write_png(data_dir / "images" / f"{cam.timestep:05d}.png",
                  (img.cpu().numpy() * 255).astype(np.uint8))
    gt_s = time.perf_counter() - t_gt
    print(f"oracle GT: {views} views @{RES}px in {gt_s:.1f}s")
    del oracle

    # ---- the fit: the config's opt_params verbatim (mid-fit evaluations per --interval)
    n_iter = int(cfg["opt_params"]["iterations"])
    model_path = work / "avatar"
    testing = list(range(interval, n_iter + 1, interval)) if interval else []
    t0 = time.perf_counter()
    trainer = training(source_paths=[str(data_dir)], model_path=model_path,
                       model_params=model_params, opt_params=dict(cfg["opt_params"]),
                       testing_iterations=testing, checkpoint_iterations=[n_iter],
                       flame_asset_dir=flame_dir, seed=0, device=device)
    fit_s = time.perf_counter() - t0

    # ---- steady rate from the metrics' host clock (after warm-up)
    recs = [json.loads(line) for line in open(model_path / "metrics.jsonl") if '"iter"' in line]
    steps = [(r["iter"], r["elapsed_s"]) for r in recs if "elapsed_s" in r and "loss" in r]
    lo = next((s for s in steps if s[0] >= 2000), steps[len(steps) // 4])
    hi = steps[-1]
    steady = (hi[0] - lo[0]) / max(hi[1] - lo[1], 1e-9)

    # final train-view reconstruction (the fit learned the scene)
    scene = load_cap4d_dataset([str(data_dir)])
    stats = {"psnr": [], "ssim": []}
    for cam in scene.train_cameras[:5]:
        img = torch.clamp(trainer.render_camera(cam, int(cam.timestep))["render"], 0, 1)
        gt = torch.as_tensor(cam.image, device=img.device)
        stats["psnr"].append(float(psnr(img, gt)))
        stats["ssim"].append(float(ssim(img, gt)))

    result = {
        "workload": f"{config} verbatim: {n_iter} iters, {views} views @{RES}px, "
                    f"uv {cfg['model_params']['uv_resolution']}, "
                    f"{cfg['model_params']['n_gaussians_init']} init gaussians",
        "backend": device_name(device),
        "wall_s": round(fit_s, 1),
        "wall_min": round(fit_s / 60, 2),
        "it_per_sec_wall": round(n_iter / fit_s, 2),
        "it_per_sec_steady": round(steady, 2),
        "steady_window": [lo[0], hi[0]],
        "n_gaussians_final": int(trainer.n_active),
        "train_view": {k: round(float(np.mean(v)), 3) for k, v in stats.items()},
        "reference_baseline": "~11 it/s sustained wall on the recommended CUDA GPU "
                              "(~15 min for the 10k default fit; gaussianavatars/train.py:112-248)",
        "oracle_gt_s": round(gt_s, 1),
        "lpips_note": "LPIPS term inactive (its VGG weights are a download, not in the "
                      "repository); l1/SSIM keep full weight",
        "tool": "cap4d_torch/tools/fit_default_full.py",
    }
    with open(out_root / "quality.json", "w") as fh:
        json.dump(result, fh, indent=2)
    print(json.dumps(result, indent=2))
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=N_VIEWS_DEFAULT)
    ap.add_argument("--out", type=str, default="examples_work/torch/fit_default")
    ap.add_argument("--config", type=str, default="configs/avatar/default.yaml")
    ap.add_argument("--interval", type=int, default=0,
                    help="mid-fit evaluation interval (the reference's --interval 2000); "
                    "0 = none, the tool computes the final quality itself")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; default is the card (cuda)")
    args = ap.parse_args()
    run(args.views, args.out, args.config, args.interval, args.device)


if __name__ == "__main__":
    main()
