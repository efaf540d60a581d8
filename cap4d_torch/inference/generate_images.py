"""Stage-1 CLI: generate novel-view/expression face images with the MMDM
(counterpart of ``cap4d_tpu/inference/generate_images.py``).

Same flags, config schema and output layout: ``mmdm_config_dump.yaml`` and
``{reference_images,generated_images}/{images/*.png, flame/*.npz,
condition_vis/*/*.jpg}``. PNGs are written with the port's zlib PNG writer,
the condition-vis maps as JPEG (quality 95, 4:2:0) by the port's native
runtime (``cap4d_torch/runtime``). Runs on the card; pass ``device="cpu"``
(``--device cpu``) to run the plain versions on the CPU.

``--groups_per_device`` sets how many view-groups share one UNet call.
``--detect_anomaly`` checks the latents, the conditioning banks, every
round's eps, every DDIM update and the decoded images for non-finite values
and raises ``FloatingPointError`` naming the stage (``torch.autograd``'s
anomaly mode does nothing under ``no_grad``); each check is a device sync.

  python -m cap4d_torch.inference.generate_images --config_path ... \
      --reference_data_path ... --output_path ... [--allow_random_weights 1]
"""

from __future__ import annotations

import argparse
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from cap4d_torch.data.datasets import build_frame_set, load_reference_items, make_generation_items
from cap4d_torch.flame.compute import load_cap4d_flame_model
from cap4d_torch.mmdm.model import MMDM, check_finite
from cap4d_torch.mmdm.sampler import StochasticIOSampler
from cap4d_torch.runtime.loader import encode_jpeg
from cap4d_torch.utils.config import load_yaml
from cap4d_torch.utils.device import resolve_device
from cap4d_torch.utils.logging import profile_trace
from cap4d_torch.utils.png import write_png


def save_images(images: np.ndarray, out_dir: Path) -> None:
    """(N, H, W, 3) uint8 → images/%05d.png"""
    img_dir = out_dir / "images"
    img_dir.mkdir(exist_ok=True, parents=True)
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = [pool.submit(write_png, img_dir / f"{i:05d}.png", img)
                   for i, img in enumerate(images)]
        for f in futures:
            f.result()


def save_flame_params(flame_items, out_dir: Path) -> None:
    flame_dir = out_dir / "flame"
    flame_dir.mkdir(exist_ok=True, parents=True)
    for i, item in enumerate(flame_items):
        np.savez(flame_dir / f"{i:05d}.npz", **{k: np.asarray(v) for k, v in item.items()})


def save_condition_vis(model: MMDM, cond_bank: Dict[str, torch.Tensor], out_dir: Path) -> None:
    """Human-inspectable conditioning maps, ×8 nearest-upsampled JPEGs."""
    base = out_dir / "condition_vis"
    base.mkdir(exist_ok=True, parents=True)
    vis = model.cond_model.get_vis(cond_bank["pos_enc"])
    for key, v in vis.items():
        key_dir = base / key
        key_dir.mkdir(exist_ok=True)
        v = np.clip(v.cpu().numpy(), -1.0, 1.0)
        v = np.repeat(np.repeat(v, 8, axis=1), 8, axis=2)
        for i, img in enumerate(v):
            encode_jpeg(key_dir / f"{i:05d}.jpg", (((img + 1.0) / 2.0) * 255).astype(np.uint8))


def run_generation(
    config_path: str | Path,
    reference_data_path: str | Path,
    output_path: str | Path,
    visualize_conditioning: bool = True,
    allow_random_weights: bool = False,
    flame_asset_dir: str | Path = "data/assets/flame",
    dtype: torch.dtype = torch.bfloat16,
    profile_dir: Optional[str] = None,
    resume: bool = True,
    device=None,
    init_noise: Optional[Dict[str, np.ndarray]] = None,
    groups_per_device: int = 1,
    detect_anomaly: bool = False,
) -> Dict[str, object]:
    """Run stage 1 end to end; returns the latents, images and timings.

    ``device`` None means the card (raises without CUDA). ``init_noise`` may
    hold "encode" (n_ref, h, w, 4) posterior noise and "x_bank"
    (n_gen, h, w, 4) initial latents; otherwise both are drawn from a
    ``torch.Generator`` seeded with the config's seed. ``groups_per_device``
    view-groups share one UNet call; ``detect_anomaly`` raises
    ``FloatingPointError`` at the first non-finite value (module docstring)."""
    dev = resolve_device(device)
    init_noise = init_noise or {}
    gen_config = load_yaml(config_path)
    out = Path(output_path)
    out_ref = out / "reference_images"
    out_gen = out / "generated_images"
    for p in (out, out_ref, out_gen):
        p.mkdir(exist_ok=True, parents=True)
    shutil.copy(config_path, out / "mmdm_config_dump.yaml")

    seed = int(gen_config["seed"])
    gen = torch.Generator(device=dev).manual_seed(seed)

    # --- model ---
    ckpt_dir = Path(gen_config["ckpt_path"])
    config_dump = ckpt_dir / "config_dump.yaml"
    has_weights = bool(list((ckpt_dir / "checkpoints").glob("*.ckpt")))
    if not has_weights and not allow_random_weights:
        raise FileNotFoundError(
            f"No MMDM checkpoint under {ckpt_dir}/checkpoints — download the "
            "released weights, or pass allow_random_weights for smoke tests.")
    if not config_dump.exists():
        raise FileNotFoundError(f"missing model config {config_dump}")
    t_model = time.perf_counter()
    model = MMDM.from_config(config_dump, ckpt_path=ckpt_dir if has_weights else None,
                             flame_asset_dir=flame_asset_dir, dtype=dtype, device=dev)
    if not has_weights:
        print("WARNING: running with RANDOM weights (smoke-test mode)")
    print(f"Timing: model load/init {time.perf_counter() - t_model:.1f}s")

    # --- data ---
    t_data = time.perf_counter()
    print(f"Loading reference dataset from {reference_data_path}")
    flame_model = load_cap4d_flame_model(flame_asset_dir, n_shape_params=150, n_expr_params=65,
                                         add_mouth=True, device=dev)
    head_ids = np.genfromtxt(Path(flame_asset_dir) / "head_vertices.txt").astype(int)
    ref_items, ref_extr = load_reference_items(Path(reference_data_path))
    resolution = int(gen_config["resolution"])
    ref_set = build_frame_set(flame_model, ref_items, head_ids, ref_extr, resolution,
                              is_reference=True)
    gd = gen_config["generation_data"]
    gen_bank = dict(np.load(gd["data_path"]))
    gen_items = make_generation_items(
        gen_bank, ref_items[0], n_samples=gd["n_samples"], yaw_range=gd["yaw_range"],
        pitch_range=gd["pitch_range"], expr_factor=gd["expr_factor"],
        rng=np.random.RandomState(seed))
    gen_set = build_frame_set(flame_model, gen_items, head_ids, ref_extr, resolution,
                              is_reference=False)
    print(f"Timing: datasets + frame sets {time.perf_counter() - t_data:.1f}s")

    # --- conditioning banks ---
    t_banks = time.perf_counter()
    print("Encoding reference images + building conditioning banks")
    z_ref = model.encode_images(ref_set.images, noise=init_noise.get("encode"), generator=gen)
    ref_cond = model.prepare_conditioning(ref_set.cond_batch(), z=z_ref)
    gen_cond = model.prepare_conditioning(gen_set.cond_batch())
    if detect_anomaly:
        check_finite(z_ref, "after VAE encode of the reference images")
        for name, bank in (("reference", ref_cond), ("generation", gen_cond)):
            for key, t in bank.items():
                check_finite(t, f"in the {name} conditioning bank's {key}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"Timing: encode + conditioning banks {time.perf_counter() - t_banks:.1f}s")

    save_flame_params(ref_set.flame_items, out_ref)
    save_flame_params(gen_set.flame_items, out_gen)
    if visualize_conditioning:
        save_condition_vis(model, ref_cond, out_ref)
        save_condition_vis(model, gen_cond, out_gen)

    # --- sampling ---
    sampler = StochasticIOSampler(model, groups_per_device=groups_per_device,
                                  detect_anomaly=detect_anomaly)
    S = int(gen_config["n_ddim_steps"])
    t_sample = time.perf_counter()
    with profile_trace(profile_dir):
        z_gen = sampler.sample(
            S=S, ref_cond=ref_cond, gen_cond=gen_cond, V=int(gen_config["V"]),
            R_max=int(gen_config["R_max"]), cfg_scale=float(gen_config["cfg_scale"]),
            seed=seed, x_bank=init_noise.get("x_bank"), generator=gen,
            checkpoint_dir=str(out) if resume else None)
        z_gen_host = z_gen.cpu().numpy()  # device → host copy synchronises
    sampler_s = time.perf_counter() - t_sample

    t_decode = time.perf_counter()
    print(f"Saving reference images to {out_ref}/images")
    save_images(model.decode_latents(ref_cond["z_input"], as_uint8=True,
                                     detect_anomaly=detect_anomaly), out_ref)
    print(f"Saving generated images to {out_gen}/images")
    imgs = model.decode_latents(z_gen, as_uint8=True, detect_anomaly=detect_anomaly)
    save_images(imgs, out_gen)
    decode_s = time.perf_counter() - t_decode
    n_ref = ref_cond["pos_enc"].shape[0]
    G = int(gen_config["V"]) - min(n_ref, int(gen_config["R_max"]))
    group_steps = S * (z_gen_host.shape[0] // G)
    print(f"Timing: sampler {sampler_s:.1f}s ({group_steps} group-steps), "
          f"decode+save {decode_s:.1f}s")
    return {"z_gen": z_gen_host, "images": imgs,
            "sampler_s": sampler_s, "decode_s": decode_s, "group_steps": group_steps}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--reference_data_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=1, help="kept for CLI parity")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default is the card (cuda)")
    parser.add_argument("--visualize_conditioning", type=int, default=1)
    parser.add_argument("--allow_random_weights", type=int, default=0)
    parser.add_argument("--flame_asset_dir", type=str, default="data/assets/flame")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the sampling loop")
    parser.add_argument("--no_resume", action="store_true",
                        help="disable mid-run sampler checkpointing")
    parser.add_argument("--groups_per_device", type=int, default=1,
                        help="view-groups sampled together in one UNet call")
    parser.add_argument("--max_dispatch_group_steps", type=int, default=200,
                        help="kept for CLI parity; no effect (each step is launched eagerly)")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="raise FloatingPointError at the first non-finite value")
    args = parser.parse_args()
    run_generation(
        args.config_path,
        args.reference_data_path,
        args.output_path,
        visualize_conditioning=bool(args.visualize_conditioning),
        allow_random_weights=bool(args.allow_random_weights),
        flame_asset_dir=args.flame_asset_dir,
        profile_dir=args.profile_dir,
        resume=not args.no_resume,
        device=args.device,
        groups_per_device=args.groups_per_device,
        detect_anomaly=args.detect_anomaly,
    )


if __name__ == "__main__":
    main()
