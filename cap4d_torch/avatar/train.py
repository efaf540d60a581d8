"""Stage-2 CLI: fit a rigged 3D Gaussian avatar to reference and generated
images (counterpart of ``cap4d_tpu/avatar/train.py``).

Reference: gaussianavatars/train.py (flags --source_paths --model_path
--interval --config_path; the loss schedule; SH warmup; the densification
cadence; the evaluation report with L1/PSNR/SSIM/LPIPS on the held-out
split; config_dump.yaml; chkpnt{iter}.pth checkpoints).

The dispatch is the JAX package's (``chunked``, ``dispatch_len``): a fit
of at least 100 iterations runs in dispatches of up to ``CHUNK_LEN``
iterations over a device-resident :class:`CameraBank`, each dispatch one
host round trip (its losses and pair-overflow counts in one copy). On the
card a dispatch replays a captured CUDA graph of the whole train step
(``avatar/step_compiler.py``); on the CPU the same step runs eagerly.
Dispatches are cut at every loop event (the log every 10 iterations, the SH
warmup, the densification and opacity-reset cadence, evaluations and
checkpoints), so the trajectory does not depend on ``dispatch_len``. The
pair budget is probed before the loop (every training view's candidates)
and grows, with the dispatch rolled back and run again, whenever a render
outgrows it; each regrowth is logged to ``metrics.jsonl``. A fit runs one
eager ``AvatarTrainer.train_step`` per iteration (and says why) with
``chunked=False``, under ``--detect_anomaly`` (anomaly mode syncs) and on a
train split of mixed resolutions (no bank). The camera order is the JAX
package's either way: a seeded ``numpy`` permutation, drawn anew when used
up. Run it with ``python -m cap4d_torch.avatar.train``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from cap4d_torch.avatar.convert_ref import (
    load_reference_avatar_checkpoint,
    restore_reference_checkpoint,
)
from cap4d_torch.avatar.losses import error_map, l1_loss, psnr, ssim
from cap4d_torch.avatar.lpips import load_lpips
from cap4d_torch.avatar.scene import dump_cameras_json, load_cap4d_dataset
from cap4d_torch.avatar.step_compiler import StepGraphs, probe_budget
from cap4d_torch.avatar.trainer import AvatarTrainer, CameraBank, search_max_iteration
from cap4d_torch.smpl.scene import load_smpl_dataset
from cap4d_torch.utils.config import dump_yaml, load_yaml
from cap4d_torch.utils.device import resolve_device
from cap4d_torch.utils.png import write_png


# iterations per dispatch (cap4d_tpu/avatar/train.py:57), and the log cadence
# that also cuts dispatches
CHUNK_LEN = 10
LOG_EVERY = 10


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """(H, W) uint8 → (H, W, 3) RGB uint8 with the piecewise-linear JET map
    (blue → cyan → yellow → red), as OpenCV's COLORMAP_JET draws it."""
    v = x.astype(np.float32) / 255.0

    def ramp(c):
        return np.clip(1.5 - np.abs(4.0 * v - c), 0.0, 1.0)

    rgb = np.stack([ramp(3.0), ramp(2.0), ramp(1.0)], axis=-1)
    return (rgb * 255.0 + 0.5).astype(np.uint8)


def training(
    source_paths: List[str],
    model_path: str | Path,
    model_params: Dict,
    opt_params: Dict,
    testing_iterations: List[int],
    checkpoint_iterations: List[int],
    load_existing_checkpoint: bool = False,
    flame_asset_dir: str | Path = "data/assets/flame",
    lpips_weights: Optional[str] = None,
    seed: int = 0,
    n_max_val_images: int = 10,
    variant: str = "flame",
    smpl_asset_dir: str | Path = "data/assets/smpl",
    device=None,
    chunked: Optional[bool] = None,
    dispatch_len: Optional[int] = None,
) -> AvatarTrainer:
    """Fit an avatar: the FLAME head (``variant="flame"``, stage-1
    flame/*.npz inputs) or the full SMPL body (``variant="smpl"``,
    smpl/*.npz inputs, SMPL assets under ``smpl_asset_dir``). Runs on the
    card unless ``device="cpu"``.

    ``chunked`` (default: on when the fit has at least 100 iterations left)
    runs dispatches of up to ``dispatch_len`` (default ``CHUNK_LEN``)
    iterations, graphed on the card; neither changes the trajectory. The
    returned trainer's ``step_graphs`` holds the dispatcher's counters
    (None for a per-step fit)."""
    device = resolve_device(device)
    if variant not in ("flame", "smpl"):
        raise ValueError(f"variant must be 'flame' or 'smpl', got {variant!r}")
    model_path = Path(model_path)
    model_path.mkdir(parents=True, exist_ok=True)
    # config provenance, re-read by animate (train.py:386, animate.py:84)
    dump_yaml({"model_params": dict(model_params), "opt_params": dict(opt_params),
               "variant": variant}, model_path / "config_dump.yaml")
    lpips = load_lpips(lpips_weights)
    if variant == "smpl":
        scene = load_smpl_dataset(source_paths)
        dump_cameras_json(scene.train_cameras, model_path / "cameras.json")
        trainer = AvatarTrainer.create_smpl(scene, model_params, opt_params,
                                            smpl_asset_dir=smpl_asset_dir, lpips=lpips,
                                            seed=seed, device=device)
    else:
        scene = load_cap4d_dataset(source_paths, n_max_val_images=n_max_val_images)
        dump_cameras_json(scene.train_cameras, model_path / "cameras.json")
        trainer = AvatarTrainer.create(scene, model_params, opt_params,
                                       flame_asset_dir=flame_asset_dir, lpips=lpips, seed=seed,
                                       device=device)

    first_iter = 0
    if load_existing_checkpoint:
        loaded_iter, path = search_max_iteration(model_path)
        if loaded_iter is None:
            print("WARNING: No valid checkpoint found in", model_path)
        else:
            print(f"Loading trained model at iteration {loaded_iter}")
            chkpt, first_iter = load_reference_avatar_checkpoint(path)
            restore_reference_checkpoint(trainer, chkpt)

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    cams = scene.train_cameras
    order = rng.permutation(len(cams))
    order_pos = 0

    def take_indices(k: int) -> List[int]:
        nonlocal order, order_pos
        out = []
        while len(out) < k:
            if order_pos >= len(order):
                order = rng.permutation(len(cams))
                order_pos = 0
            out.append(int(order[order_pos]))
            order_pos += 1
        return out

    opt = opt_params
    n_iter = opt["iterations"]
    sh_max = trainer.config.sh_degree
    metrics_fh = open(model_path / "metrics.jsonl", "a")
    graphs = _dispatcher(trainer, cams, n_iter, first_iter, chunked, dispatch_len)
    trainer.step_graphs = graphs
    k_max = graphs.max_len if graphs is not None else 1

    def after_event(it: int) -> bool:
        """Loop events that read the state after iteration ``it`` on the host:
        a dispatch ends there."""
        if it in testing_iterations or it in checkpoint_iterations or it % LOG_EVERY == 0:
            return True
        if it < opt["densify_until_iter"]:
            if it > opt["densify_from_iter"] and it % opt["densification_interval"] == 0:
                return True
            if it % opt["opacity_reset_interval"] == 0 or it == opt["densify_from_iter"]:
                return True
        return False

    ema_loss = 0.0
    t_start = time.perf_counter()
    adam_step = 0
    iteration = first_iter
    while iteration < n_iter:
        i0 = iteration + 1
        # SH warmup (train.py:120-121), before the warmup multiple's step
        if i0 % opt["sh_warmup_iterations"] == 0:
            trainer.active_sh_degree = min(trainer.active_sh_degree + 1, sh_max)
        # up to k_max iterations, cut before the next SH bump and at the first event
        k = min(k_max, n_iter - i0 + 1)
        for j in range(1, k):
            if ((i0 + j) % opt["sh_warmup_iterations"] == 0
                    and trainer.active_sh_degree < sh_max):
                k = j
                break
        for j in range(k):
            if after_event(i0 + j):
                k = j + 1
                break
        idxs = take_indices(k)
        if graphs is not None:
            n_grown = len(graphs.regrowths)
            losses = graphs.run(idxs, i0, adam_step + 1)
            for old, new in graphs.regrowths[n_grown:]:
                print(f"[ITER {i0}] a render outgrew the pair budget {old}: grown to {new}, "
                      f"dispatch rolled back and run again")
                metrics_fh.write(json.dumps({"iter": i0, "capacity_grown": new,
                                             "prev_capacity": old}) + "\n")
        else:
            losses = trainer.train_step(cams[idxs[0]], i0, adam_step + 1)
        adam_step += k
        iteration = i0 + k - 1
        trainer.iteration = iteration
        cam = cams[idxs[-1]]

        if iteration % LOG_EVERY == 0 or iteration == n_iter:
            # a dispatch's losses are host arrays over its iterations, ending here
            vals = {name: float(v[-1] if graphs is not None else v) for name, v in losses.items()}
            vals.update(n_truncated=0.0, n_truncated_depth=0.0)
            ema_loss = 0.4 * vals["total"] + 0.6 * ema_loss
            elapsed = time.perf_counter() - t_start
            metrics_fh.write(json.dumps({"iter": iteration, "loss": vals["total"],
                                         "elapsed_s": round(elapsed, 3),
                                         "n_active": trainer.n_active, **vals}) + "\n")
            metrics_fh.flush()
            print(f"[{iteration}/{n_iter}] loss={ema_loss:.5f} gaussians={trainer.n_active} "
                  f"it/s={(iteration - first_iter) / max(elapsed, 1e-9):.2f}")

        # densification (train.py:229-240)
        if iteration < opt["densify_until_iter"]:
            if (iteration > opt["densify_from_iter"]
                    and iteration % opt["densification_interval"] == 0):
                size_threshold = 20.0 if iteration > opt["opacity_reset_interval"] else None
                trainer.densify(int(cam.timestep), gen, size_threshold)
            if (iteration % opt["opacity_reset_interval"] == 0
                    or iteration == opt["densify_from_iter"]):
                trainer.reset_opacity()

        if iteration in testing_iterations:
            evaluate(trainer, scene, iteration, metrics_fh, image_dir=model_path / "eval_images")
        if iteration in checkpoint_iterations or iteration == n_iter:
            print(f"[ITER {iteration}] Saving Checkpoint")
            trainer.save_checkpoint(model_path, iteration)
    if graphs is not None:
        graphs.close()
        print(f"[fit] dispatches: {graphs.counters()}")
    metrics_fh.close()
    return trainer


def _dispatcher(trainer: AvatarTrainer, cams, n_iter: int, first_iter: int,
                chunked: Optional[bool], dispatch_len: Optional[int]) -> Optional[StepGraphs]:
    """The fit's :class:`StepGraphs` (graphed on the card), or None for one
    eager ``train_step`` per iteration, with the reason printed."""
    use = chunked if chunked is not None else n_iter - first_iter >= 100
    why = None
    if not use:
        why = ("chunked=False" if chunked is False
               else f"{n_iter - first_iter} iterations, fewer than 100")
    elif torch.is_anomaly_enabled():
        why = "--detect_anomaly (anomaly mode syncs at every check)"
    bank = CameraBank.build(cams, trainer.device) if why is None else None
    if why is None and bank is None:
        why = "the train split mixes resolutions (no camera bank)"
    if why is not None:
        print(f"[fit] one eager train_step per iteration: {why}")
        return None
    trainer.schedule_tables(n_iter + 1)
    graphed = trainer.device.type == "cuda"
    graphs = StepGraphs(trainer, bank, probe_budget(trainer, cams), dispatch_len or CHUNK_LEN,
                        graphs=graphed)
    print(f"[fit] {'graphed' if graphed else 'eager'} dispatches of up to {graphs.max_len} "
          f"iterations, pair budget {graphs.budget}")
    return graphs


@torch.no_grad()
def evaluate(trainer: AvatarTrainer, scene, iteration: int, metrics_fh, image_dir=None) -> None:
    """Validation report: L1/PSNR/SSIM(/LPIPS) on the held-out split, with
    render and error-map PNGs (train.py:284-349)."""
    for split, cameras in (("val", scene.val_cameras), ("test", scene.test_cameras)):
        if not cameras:
            continue
        stats = {"l1": [], "psnr": [], "ssim": [], "lpips": []}
        for cam_i, cam in enumerate(cameras[:10]):
            img = torch.clamp(trainer.render_camera(cam, int(cam.timestep))["render"], 0, 1)
            ct = trainer.camera_tensors(cam)
            m = ct["mask"][..., None]
            img, gt = img * m, ct["gt"] * m
            vals = [l1_loss(img, gt), psnr(img, gt), ssim(img, gt)]
            if trainer.lpips.available:
                vals.append(trainer.lpips(img, gt))
            fetched = torch.stack(vals).cpu().numpy()
            for k, v in zip(("l1", "psnr", "ssim", "lpips"), fetched):
                stats[k].append(float(v))
            if image_dir is not None and cam_i < 3:
                d = Path(image_dir) / f"iter_{iteration:06d}"
                d.mkdir(parents=True, exist_ok=True)
                write_png(d / f"{split}_{cam_i}_render.png",
                          (img.cpu().numpy() * 255).astype(np.uint8))
                err = error_map(img, gt).cpu().numpy()
                err = (np.clip(err * 4, 0, 1) * 255).astype(np.uint8)
                write_png(d / f"{split}_{cam_i}_error.png", jet_colormap(err))
        msg = {f"{split}/{k}": float(np.mean(v)) for k, v in stats.items() if v}
        print(f"[ITER {iteration}] {split}: " + " ".join(
            f"{k.split('/')[1]}={v:.4f}" for k, v in msg.items()))
        metrics_fh.write(json.dumps({"iter": iteration, **msg}) + "\n")
        metrics_fh.flush()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--source_paths", type=str, nargs="+", required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--interval", type=int, default=2000, help="test/checkpoint interval")
    parser.add_argument("--load_existing_checkpoint", action="store_true")
    parser.add_argument("--flame_asset_dir", type=str, default="data/assets/flame")
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args()
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    config = load_yaml(args.config_path)
    n_iter = config["opt_params"]["iterations"]
    interval = list(range(args.interval, n_iter + 1, args.interval))
    training(
        source_paths=args.source_paths, model_path=args.model_path,
        model_params=config["model_params"], opt_params=config["opt_params"],
        testing_iterations=interval, checkpoint_iterations=interval + [n_iter],
        load_existing_checkpoint=args.load_existing_checkpoint,
        flame_asset_dir=args.flame_asset_dir, lpips_weights=args.lpips_weights,
        device=args.device,
    )


if __name__ == "__main__":
    main()
