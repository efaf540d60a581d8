#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``cap4d_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each must pass; any failure raises and the exit code is non-zero):
  1. device: the card's name and power limit; build every kernel from
     ``cap4d_torch/csrc`` (one nvcc per source, all started together);
  2. K1 and K6 (flash attention forward and backward): the SASS of their
     main kernels holds wgmma (HGMMA) and TMA loads (UTMALDG) and no mma.sync
     (HMMA), and ptxas reports no spills; K1 against its plain version at the
     main path's shapes (bf16, d=64), a ragged S and the edge shapes S = 1,
     64, 127, 129; then, at the four attention shapes of MMDM training, a
     ragged S and the edge shapes, K1's output with and without its
     log-sum-exp (bit-identical), that log-sum-exp against the fp32 one, and
     K6 against its plain version, run twice (dK, dV bit-identical). Each
     kernel's yardstick is the fastest SDPA backend (flash, cuDNN,
     memory-efficient) that takes the inputs; K6's is SDPA's backward alone,
     timed on a retained forward graph;
  3. K2 GroupNorm(+SiLU) against its plain version at main-path shapes;
  4. K3 rasterizer against its plain version on 32 synthetic FLAME frames at
     128²;
  5. one full-width UNet forward (shipped config, V=8, 64² latents, CFG
     batch 2, bf16) with nonzero norm scales, kernels against plain versions;
     then one training loss and its gradients at full width (fp32 parameters,
     bf16 compute, remat), kernels against plain versions, every parameter;
  6. the stage-1 main path: ``run_generation`` at the shipped width on
     synthetic assets with random weights (the debug generation config: 10
     DDIM steps, 28 samples), with every kernel's launch count read around
     that run;
  7. K4/K5 (3DGS tile compositing forward/backward) against the plain
     compositor at the fit's shapes: a freshly initialised full-width avatar
     (``configs/avatar/default.yaml`` model_params, head-sized sphere
     template) rendered at 512² from a stage-1 camera, outputs and the
     gradients of a fixed loss;
  8. the stage-2 main path: ``training()`` on phase 6's 28 + 1 images with
     default model_params and debug opt_params cut to 300 iterations
     (densification, opacity reset, SH warmup, evaluation, checkpoint);
  9. the stage-3 main path: ``render_sequence`` of that checkpoint driven by
     a synthetic 48-frame fit.npz at 512², with the animated PLY;
 10. the MMDM training main path: ``train_mmdm`` on the shipped training
     config at full width with the synthetic dataset, bf16, cut to a virtual
     batch of 4 micro-batches and 3 optimizer steps (checkpoint and image log
     at step 3); the checkpoint reloads into a fresh UNet; then, outside the
     counted run, one more step through the loop's step function, timed
     alone and profiled, and the AdamW update alone;
 11. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Launch counts are read around each main path (6, 8, 9, 10) with every count
set to 0 just before it; the kernels line sums them.

``--phases`` runs a subset (for bring-up); the result lines are printed only
when every phase ran.

Without CUDA, or outside a checkout, it exits non-zero and prints no result.
Times are CUDA-event times on the card, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOPS = 989e12           # dense bf16 tensor cores
FP32_FLOPS = 67e12            # fp32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, keys, iters: int = 20) -> float:
    """Device time per call of the kernels whose names contain one of
    ``keys``, from torch.profiler over ``iters`` calls: what a call costs
    the card, without the host time that bounds ``time_ms`` at small
    shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and any(k in e.key for k in keys))
    return us / iters / 1e3


def check_close(name: str, out, ref, rtol: float, atol: float) -> float:
    """Elementwise |out - ref| <= rtol·|ref| + atol; logs and returns the max
    abs error."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    bad = err > rtol * ref.abs() + atol
    max_err = float(err.max())
    max_rel = float((err / ref.abs().clamp(min=atol)).max())
    log(f"[{name}] max abs err {max_err:.3g}, max rel err {max_rel:.3g} "
        f"(tolerance |out - plain| <= {rtol:g}·|plain| + {atol:.3g})")
    assert bool(out.isfinite().all()), f"{name}: non-finite output"
    assert not bool(bad.any()), (f"{name}: {int(bad.sum())} elements outside "
                                 f"rtol {rtol} atol {atol:.3g}; max abs err {max_err:.3g}")
    return max_err


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_fastest(make_fn):
    """The yardstick: the fastest SDPA backend that accepts the inputs, as
    (ms, backend name). ``make_fn()`` returns the call to time and runs under
    ``sdpa_kernel`` of one backend at a time; a backend that refuses the
    inputs raises and is skipped. The port never calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    best = None
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                fn = make_fn()
                ms = time_ms(fn)
        except RuntimeError:
            continue
        if best is None or ms < best[0]:
            best = (ms, name.split("_")[0].lower())
    assert best is not None, "no SDPA backend accepts the attention inputs"
    return best


def attention_inputs(gen, B, S, H, spread: float = 1.5):
    """bf16 (B, S, H, 64) q, k, v, dO; q and k scaled by ``spread`` so the
    logits q·k/8 have a std of ~2 (softmax rows neither flat nor one-hot)."""
    import torch

    q, k = ((spread * torch.randn((B, S, H, 64), generator=gen, device="cuda"))
            .to(torch.bfloat16) for _ in range(2))
    v, do = (torch.randn((B, S, H, 64), generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    return q, k, v, do


class Entry:
    """Accumulates one kernel's numbers over the shapes of its phase."""

    def __init__(self, name, route, source, replaces, kernel, library: bool):
        self.d = {"name": name, "route": route, "source": source, "replaces": replaces,
                  "launches": None, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bound_by": None, "library_ms": 0.0 if library else None}
        self.kernel = kernel
        self._flop_ms = self._byte_ms = 0.0

    def add(self, err, ms, plain_ms, flop_ms, byte_ms, library_ms=None):
        d = self.d
        d["max_abs_err"] = max(d["max_abs_err"], err)
        d["ms"] += ms
        d["plain_ms"] += plain_ms
        self._flop_ms += flop_ms
        self._byte_ms += byte_ms
        d["bound_ms"] = max(self._flop_ms, self._byte_ms)
        d["bound_by"] = "operations" if self._flop_ms >= self._byte_ms else "bytes"
        if d["library_ms"] is not None:
            d["library_ms"] += library_ms


# ---------------------------------------------------------------- phases ----

def phase_build(kernels):
    from cap4d_torch.ops.cuda_build import build_all

    t0 = time.perf_counter()
    build_all(kernels)
    log(f"[build] {len(kernels)} kernels built in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {k.source.name}: {line.strip()}")


EDGE_S = (1, 64, 127, 129)   # S below one tile, at a tile and one either side (B=2, H=4)


def ptxas_report(kernel) -> dict:
    """{function: (registers, spill store bytes, spill load bytes)} from
    ptxas's report of ``kernel``'s build; a library built before this run is
    compiled once more for the report alone."""
    import tempfile

    text = kernel.build_log
    if not text:
        with tempfile.TemporaryDirectory() as tmp:
            text = subprocess.run(kernel.build_command(Path(tmp) / "report.so"),
                                  capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = [0, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return out


def sass_functions(so_path: Path) -> dict:
    """{function: SASS text} of a built library, from ``cuobjdump -sass``."""
    from cap4d_torch.ops.cuda_build import nvcc_path

    cuobjdump = str(Path(nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(so_path)], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    return dict(zip(parts[1::2], parts[2::2]))


def phase_attention_sass():
    """K1's and K6's main kernels issue wgmma (HGMMA) and TMA loads
    (UTMALDG), no mma.sync (HMMA), and spill nothing."""
    from cap4d_torch.ops import flash_attention as fa

    for kernel, main in ((fa.KERNEL, "flash_fwd_kernel"), (fa.KERNEL_BWD, "bwd_main_kernel")):
        sass = sass_functions(kernel.so_path())
        report = ptxas_report(kernel)
        for fn, text in sass.items():
            counts = {op: len(re.findall(rf"\b{op}\b", text))
                      for op in ("HGMMA", "UTMALDG", "UTMASTG", "UBLKRED", "HMMA", "MUFU")}
            regs, st, ld = report.get(fn, (None,) * 3)
            log(f"[sass] {kernel.source.name}: {fn}: " + ", ".join(
                f"{op} {n}" for op, n in counts.items()) + f" | ptxas: {regs} registers, "
                f"spill stores {st} B, spill loads {ld} B")
            assert counts["HMMA"] == 0, f"{fn} issues mma.sync (HMMA)"
            if main in fn:
                assert counts["HGMMA"] > 0 and counts["UTMALDG"] > 0, \
                    f"{fn}: no wgmma or no TMA load in the SASS: {counts}"
                assert st == 0 and ld == 0, f"{fn} spills: {st} B stored, {ld} B loaded"
        assert any(main in fn for fn in sass), f"{main} not found in {kernel.so_path()}"


def phase_attention(entry: Entry):
    import torch
    import torch.nn.functional as F

    from cap4d_torch.ops.flash_attention import flash_attention

    # (B, S, H) as the main path calls it: ds1 spatial, ds2/ds4/mid 3d; + ragged S
    shapes = [(16, 4096, 5), (2, 8192, 10), (2, 2048, 20), (2, 512, 20), (2, 1000, 4)]
    d = 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H in shapes + [(2, s, 4) for s in EDGE_S]:
        q, k, v = (torch.randn((B, S, H, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        out = flash_attention(q, k, v)
        ref = flash_attention(q, k, v, plain=True)
        torch.cuda.synchronize()
        # bf16 output: 2e-2 relative (~5 bf16 ulps) plus 2e-2 of the output's
        # largest magnitude for entries near zero
        err = check_close(f"K1 B={B} S={S} H={H}", out, ref, 2e-2,
                          2e-2 * float(ref.float().abs().max()))
        if (B, S, H) not in shapes:
            entry.d["max_abs_err"] = max(entry.d["max_abs_err"], err)
            continue   # edge shapes: checked, not timed
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: flash_attention(q, k, v, plain=True), iters=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms, backend = sdpa_fastest(lambda: lambda: F.scaled_dot_product_attention(qt, kt, vt))
        flops = 4.0 * S * S * d * B * H
        nbytes = 4.0 * B * S * H * d * 2
        flop_ms, byte_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        entry.add(err, ms, plain_ms, flop_ms, byte_ms, lib_ms)
        dev_ms = device_ms(lambda: flash_attention(q, k, v), ("flash_fwd",))
        log(f"[K1] B={B} S={S} H={H}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s; on the device {dev_ms:.4f} ms, "
            f"{flops / dev_ms / 1e9:.1f} TFLOP/s) | plain {plain_ms:.3f} ms | sdpa ({backend}) "
            f"{lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s) | bound "
            f"{max(flop_ms, byte_ms):.4f} ms")
    log(f"[K1] 5 shapes summed: kernel {entry.d['ms']:.4f} ms | fastest sdpa "
        f"{entry.d['library_ms']:.4f} ms | bound {entry.d['bound_ms']:.4f} ms")


def phase_group_norm(entry: Entry):
    import torch
    import torch.nn.functional as F

    from cap4d_torch.ops.norms import group_norm_silu

    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in [(16, 64, 64, 320), (16, 32, 32, 960), (16, 8, 8, 2560)]:
        C = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(C, generator=gen, device="cuda")
        for silu, eps in ((True, 1e-5), (False, 1e-6)):
            out = group_norm_silu(x, scale, bias, 32, eps, silu)
            ref = group_norm_silu(x, scale, bias, 32, eps, silu, plain=True)
            torch.cuda.synchronize()
            # bf16 output: a 1-2 ulp difference from the folded affine
            err = check_close(f"K2 {shape} silu={silu}", out, ref, 1e-2, 1e-3)
            ms = time_ms(lambda: group_norm_silu(x, scale, bias, 32, eps, silu))
            plain_ms = time_ms(lambda: group_norm_silu(x, scale, bias, 32, eps, silu, plain=True))
            xn, sb, bb = x.permute(0, 3, 1, 2), scale.to(x.dtype), bias.to(x.dtype)
            lib_ms = time_ms(lambda: F.group_norm(xn, 32, sb, bb, eps))
            nbytes = 2.0 * x.numel() * x.element_size()     # read x once, write y once
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            flop_ms = 8.0 * x.numel() / FP32_FLOPS * 1e3
            entry.add(err, ms, plain_ms, flop_ms, byte_ms, lib_ms)
            log(f"[K2] {shape} silu={silu} eps={eps}: kernel {ms:.3f} ms "
                f"({nbytes / ms / 1e6:.0f} GB/s moved once) | plain {plain_ms:.3f} ms | "
                f"F.group_norm {lib_ms:.3f} ms | bound {byte_ms:.4f} ms "
                f"(two-pass floor {1.5 * byte_ms:.4f} ms)")


def synthetic_frames(work: Path, n: int):
    """NDC verts (n, V, 3) of synthetic FLAME generation frames, as the main
    path's conditioning sees them, and the template's faces."""
    import numpy as np
    import torch

    from cap4d_torch.data.datasets import build_frame_set, load_reference_items, make_generation_items
    from cap4d_torch.flame.compute import load_cap4d_flame_model
    from cap4d_torch.mmdm.conditioning import load_prop_renderer_assets
    from cap4d_torch.utils import synthetic_assets as sa

    flame_dir = sa.make_asset_dir(work)
    ref_dir = sa.make_reference_dir(work, resolution=512)
    bank = dict(np.load(sa.make_gen_bank(work, n=n)))
    flame = load_cap4d_flame_model(flame_dir, 150, 65, add_mouth=True, device="cuda")
    ref_items, ref_extr = load_reference_items(ref_dir)
    items = make_generation_items(bank, ref_items[0], n_samples=n, rng=np.random.RandomState(0))
    head = np.genfromtxt(flame_dir / "head_vertices.txt").astype(int)
    fs = build_frame_set(flame, items, head, ref_extr, 512)
    assets = load_prop_renderer_assets(flame_dir / "cap4d_flame_template.obj",
                                       flame_dir / "head_vertices.txt", device="cuda")
    return torch.as_tensor(fs.verts_2d[:, 0], device="cuda"), assets.faces


def box_pixel_tests(verts, faces, size) -> int:
    """Pixel-face tests the rasterization needs: for every frame and face,
    the pixel centres (ndc 1 - (2i+1)/S) inside the face's screen box."""
    import torch

    fv = verts[:, faces.long(), :2]                       # (B, F, 3, 2)
    lo, hi = fv.amin(dim=2), fv.amax(dim=2)                # (B, F, 2) as (x, y)
    counts = []
    for axis, n in ((0, size[1]), (1, size[0])):
        # centre k lies in [lo, hi] iff n(1 - hi) <= 2k + 1 <= n(1 - lo)
        k0 = torch.ceil((n * (1.0 - hi[..., axis]) - 1.0) / 2.0).clamp(min=0)
        k1 = torch.floor((n * (1.0 - lo[..., axis]) - 1.0) / 2.0).clamp(max=n - 1)
        counts.append((k1 - k0 + 1).clamp(min=0).double())
    return int((counts[0] * counts[1]).sum())


def phase_rasterize(entry: Entry, work: Path):
    import torch

    from cap4d_torch.ops.rasterize import rasterize_meshes

    verts, faces = synthetic_frames(work, 32)
    size = (128, 128)
    out = rasterize_meshes(verts, faces, size)
    ref = rasterize_meshes(verts, faces, size, plain=True)
    torch.cuda.synchronize()
    agree = float((out.pix_to_face == ref.pix_to_face).float().mean())
    same = (out.pix_to_face == ref.pix_to_face) & (ref.pix_to_face >= 0)
    z_err = float((out.zbuf - ref.zbuf)[same].abs().max()) if bool(same.any()) else 0.0
    b_err = float((out.bary_coords - ref.bary_coords)[same].abs().max()) if bool(same.any()) else 0.0
    covered = float((ref.pix_to_face >= 0).float().mean())
    log(f"[K3] {verts.shape[0]} frames x {size[0]}x{size[1]}, {faces.shape[0]} faces, "
        f"{verts.shape[1]} verts: pix_to_face agreement {agree:.6f} (covered {covered:.3f}) | "
        f"z max err {z_err:.3g} | bary max err {b_err:.3g}")
    # rounding is made identical (no FMA contraction), so the tolerance is
    # 1e-4 of the pixels and 1e-5 on z / barycentrics where the faces agree
    assert agree >= 1.0 - 1e-4, f"K3 pix_to_face agreement {agree}"
    assert z_err <= 1e-5 and b_err <= 1e-5, f"K3 z/bary error {z_err} / {b_err}"
    ms = time_ms(lambda: rasterize_meshes(verts, faces, size))
    plain_ms = time_ms(lambda: rasterize_meshes(verts, faces, size, plain=True), iters=3, warmup=1)
    B, V = verts.shape[:2]
    Fn, P = faces.shape[0], size[0] * size[1]
    # the work the function needs: each face tested only against the pixels
    # of its screen box (the kernel itself still tests every face)
    tests = box_pixel_tests(verts, faces, size)
    flops = 18.0 * tests               # 3 edge functions + 3 scalings per pixel-face test
    nbytes = B * V * 12 + Fn * 12 + B * P * 20
    flop_ms, byte_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    entry.add(max(z_err, b_err), ms, plain_ms, flop_ms, byte_ms)
    log(f"[K3] kernel {ms:.3f} ms | plain {plain_ms:.3f} ms | bound {max(flop_ms, byte_ms):.4f} ms "
        f"({tests} box tests = {tests / (B * P * Fn):.2e} of the {B * P * Fn} brute-force tests "
        f"the kernel makes; {flop_ms:.4f} ms ops, {byte_ms:.4f} ms bytes)")


def shipped_model_section():
    from cap4d_torch.utils.config import load_yaml

    return load_yaml(REPO / "configs" / "mmdm" / "cap4d_mmdm_final.yaml")["model"]


def profile_breakdown(fn, label: str = "profile") -> None:
    """Device time of one call by kernel family (torch.profiler), and the
    device's busy share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"K1 flash_fwd": ("flash_fwd",), "K6 flash bwd": ("bwd_prep", "bwd_main", "bwd_dq"),
                "K2 group norm": ("gn_stats", "gn_apply"),
                "K3 raster": ("raster",), "K4 gsplat_fwd": ("gsplat_fwd",),
                "K5 gsplat_bwd": ("gsplat_bwd",), "conv": ("conv", "cudnn", "implicit"),
                "gemm": ("gemm", "cutlass", "sm90_xmma", "nvjet"),
                "sort/scan": ("sort", "radix", "scan"),
                "AdamW (foreach)": ("multi_tensor_apply",),
                "index/scatter": ("index", "scatter", "gather")}
    totals = dict.fromkeys(list(families) + ["other"], 0.0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue   # CPU-side ops: their kernels are counted as CUDA events
        us = evt.self_device_time_total
        name = evt.key.lower()
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)), "other")
        totals[fam] += us / 1e3
    busy = sum(totals.values())
    if busy == 0:
        log(f"[{label}] the profiler saw no device time")
        return
    cpu = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    log(f"[{label}] host ms by op (self, profiled): " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ({e.count})" for e in cpu))
    log(f"[{label}] device ms by family: " + ", ".join(
        f"{f} {ms:.2f} ({100 * ms / busy:.0f}%)" for f, ms in totals.items() if ms)
        + f"; busy {busy:.2f} ms of {wall_ms:.2f} ms wall ({100 * busy / wall_ms:.0f}% busy)")


def build_shipped_unet():
    """The shipped-width UNet on the card, empty."""
    import torch

    from cap4d_torch.mmdm.unet import MMDMUNet

    up = shipped_model_section()["params"]["unet_config"]["params"]
    with torch.device("meta"):
        unet = MMDMUNet(
            in_channels=up["in_channels"], out_channels=up["out_channels"],
            model_channels=up["model_channels"], channel_mult=tuple(up["channel_mult"]),
            num_res_blocks=up["num_res_blocks"],
            attention_resolutions=tuple(up["attention_resolutions"]),
            num_head_channels=up["num_head_channels"],
            condition_channels=up["condition_channels"], time_steps=up["time_steps"],
            temporal_mode=up["temporal_mode"])
    return unet.to_empty(device="cuda")


def phase_unet():
    import torch

    from cap4d_torch.mmdm.unet import GroupNorm32

    up = shipped_model_section()["params"]["unet_config"]["params"]
    unet = build_shipped_unet()
    gen = torch.Generator(device="cuda").manual_seed(2)
    norms = {id(m.weight) for m in unet.modules()
             if isinstance(m, (GroupNorm32, torch.nn.LayerNorm))}
    with torch.no_grad():
        # fan-in-scaled weights, norm scales 1 ± 0.1, small biases: every
        # layer (the zero-initialised ones included) carries signal
        for p in unet.parameters():
            if id(p) in norms:
                p.normal_(1.0, 0.1, generator=gen)
            elif p.ndim == 1:
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
    unet.set_dtype(torch.bfloat16).eval().requires_grad_(False)
    unet.to(memory_format=torch.channels_last)
    B, T, L = 2, up["time_steps"], 64
    x = torch.randn((B, T, L, L, 4), generator=gen, device="cuda")
    t = torch.full((B, T), 500, device="cuda")
    ref = torch.zeros((B, T, L, L, 1), device="cuda")
    ref[:, 0] = 1.0
    cond = {"pos_enc": 0.5 * torch.randn((B, T, L, L, up["condition_channels"]), generator=gen,
                                         device="cuda"),
            "z_input": torch.randn((B, T, L, L, 4), generator=gen, device="cuda"),
            "ref_mask": ref}
    with torch.no_grad():
        eps_k = unet.use_plain_ops(False)(x, t, cond)
        ms_k = time_ms(lambda: unet(x, t, cond), iters=3, warmup=1)
        profile_breakdown(lambda: unet(x, t, cond))
        eps_p = unet.use_plain_ops(True)(x, t, cond)
        ms_p = time_ms(lambda: unet(x, t, cond), iters=3, warmup=1)
    torch.cuda.synchronize()
    scale = float(eps_p[:, 1:].abs().max())
    err = float((eps_k - eps_p).abs().max())
    mean_rel = float((eps_k - eps_p).abs().mean() / eps_p[:, 1:].abs().mean())
    log(f"[unet] full width bf16 (B={B}, T={T}, {L}x{L}): eps max |kernels - plain| {err:.4g} "
        f"(max |eps| {scale:.4g}, mean rel {mean_rel:.3g}) | forward kernels {ms_k:.1f} ms, "
        f"plain {ms_p:.1f} ms")
    assert bool(eps_k.isfinite().all()) and bool(eps_p.isfinite().all()), "UNet eps not finite"
    # bf16 through ~60 norms and 16 attentions: 5e-2 of the largest |eps|
    assert err <= 5e-2 * scale, f"UNet kernels vs plain: {err} > 5e-2 x {scale}"
    del unet
    torch.cuda.empty_cache()


def phase_main_path(work: Path, kernels, card: str):
    import numpy as np
    import torch

    from cap4d_torch.inference.generate_images import run_generation
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.config import dump_yaml, load_yaml

    gen_cfg = load_yaml(REPO / "configs" / "generation" / "debug.yaml")
    n_samples = gen_cfg["generation_data"]["n_samples"]
    root = work / "main"
    flame_dir = sa.make_asset_dir(root)
    ref_dir = sa.make_reference_dir(root, resolution=gen_cfg["resolution"])
    bank = sa.make_gen_bank(root, n=n_samples)
    ckpt_dir = sa.write_model_config(root, shipped_model_section())
    cfg = root / "gen_config.yaml"
    dump_yaml(dict(gen_cfg, ckpt_path=str(ckpt_dir),
                   generation_data=dict(gen_cfg["generation_data"], data_path=str(bank))), cfg)
    out = root / "output"
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = run_generation(cfg, ref_dir, out, allow_random_weights=True, flame_asset_dir=flame_dir,
                         dtype=torch.bfloat16)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    n_unet = res["group_steps"]
    log(f"[main] run_generation wall {wall:.1f} s | sampler {res['sampler_s']:.2f} s, "
        f"{res['sampler_s'] / n_unet:.4f} s per group-step ({n_unet} group-steps) | decode+save "
        f"{res['decode_s']:.2f} s | on {card}")
    log(f"[main] launches {launches} over {n_unet} UNet calls")
    for sub, n in (("reference_images", 1), ("generated_images", n_samples)):
        assert len(list((out / sub / "images").glob("*.png"))) == n, sub
        assert len(list((out / sub / "flame").glob("*.npz"))) == n, sub
    assert res["z_gen"].shape == (n_samples, 64, 64, 4), res["z_gen"].shape
    assert np.isfinite(res["z_gen"]).all(), "non-finite latents"
    assert res["images"].shape == (n_samples, 512, 512, 3)
    assert launches["flash_attention"] == 16 * n_unet, launches
    assert launches["group_norm"] == 61 * n_unet, launches
    assert launches["rasterize"] > 0, launches
    return launches, out


# ------------------------------------------------ slice 2: avatar phases ----

def avatar_params():
    from cap4d_torch.utils.config import load_yaml

    model = load_yaml(REPO / "configs" / "avatar" / "default.yaml")["model_params"]
    opt = load_yaml(REPO / "configs" / "avatar" / "debug.yaml")["opt_params"]
    return model, dict(opt, iterations=300)


def pair_pixel_counts(packed, pair_gauss, bounds, n_done, tiles_x):
    """(pair-pixel evaluations, kept pair-pixels) that this render needs:
    every pair of the batches its tile ran against the tile's 256 pixels;
    kept where σ ≥ 0 and opac·e^-σ ≥ 1/255."""
    import torch

    from cap4d_torch.ops.gsplat import ALPHA_MIN, BATCH, tile_pixel_centres

    lens = (bounds[1:] - bounds[:-1]).long()
    ran = torch.minimum(lens, n_done.long() * BATCH)
    evals = int(ran.sum()) * 256
    kept = 0
    starts = bounds[:-1].tolist()
    for t, n in enumerate(ran.tolist()):
        if n == 0:
            continue
        d = packed[pair_gauss[starts[t]: starts[t] + n].long()]
        px, py = tile_pixel_centres(torch.tensor([t], device=packed.device), tiles_x)
        dx, dy = px - d[:, 0:1], py - d[:, 1:2]
        sig = 0.5 * (d[:, 2:3] * dx * dx + d[:, 4:5] * dy * dy) + d[:, 3:4] * dx * dy
        kept += int(((sig >= 0) & (d[:, 5:6] * torch.exp(-sig.clamp(min=0)) >= ALPHA_MIN)).sum())
    return evals, kept


def gsplat_kernels_vs_plain(trainer, cam, sh_degree: int, label: str):
    """K4/K5 against the plain compositor on ``trainer``'s avatar seen from
    ``cam``: outputs and the gradients of a fixed loss, for the avatar's own
    opacities and for opacities U[0.05, 1). Returns (max forward error, max
    gradient error, the world splats, the second case's opacities, the
    generator)."""
    import torch

    from cap4d_torch.avatar import gaussians as G
    from cap4d_torch.ops import gsplat_tiles as gt

    ct = trainer.camera_tensors(cam)
    mesh = trainer.mesh_at_timestep(cam.timestep)
    world = {k: v.detach() for k, v in G.world_gaussians(trainer.gauss, trainer.aux,
                                                           mesh.face_pack).items()}
    gen = torch.Generator(device="cuda").manual_seed(7)
    target = torch.rand((cam.height, cam.width, 3), generator=gen, device="cuda")
    cases = [(f"{label}, fresh avatar", world["opacities"]),
             (f"{label}, opacities U[0.05, 1)",
              0.05 + 0.95 * torch.rand(world["opacities"].shape, generator=gen, device="cuda"))]
    err = gerr = 0.0
    for case, opac in cases:
        leaves = [world["means3d"], world["quats"], world["scales"], opac, world["sh"],
                  torch.zeros((trainer.n_active, 2), device="cuda")]
        names = ["means3d", "quats", "scales", "opacities", "sh", "means2d_offset"]
        res = {}
        for plain in (False, True):
            xs = [x.clone().requires_grad_(True) for x in leaves]
            out = gt.rasterize_gaussians(xs[0], xs[1], xs[2], xs[3], xs[4], ct["rt"], ct["K"],
                                         cam.width, cam.height, sh_degree=sh_degree,
                                         render_depth=True, means2d_offset=xs[5], plain=plain)
            loss = (((out["render"] - target) ** 2).mean() + 0.1 * out["alpha"].mean()
                    + 0.01 * (out["depth"] * out["alpha"]).mean())
            grads = torch.autograd.grad(loss, xs)
            torch.cuda.synchronize()
            res[plain] = (out, grads, float(loss.detach()))
        (ok_, gk, lk), (op_, gp, lp) = res[False], res[True]
        # forward: fp32 sums in another order, __expf, and a tile's stop
        # decision at a batch boundary (the plain version sums ln T by cumsum)
        # -> 2e-4 absolute on render/alpha (the stop rule's own bound is
        # 1e-4 of a colour); depth = Σw·d / alpha where alpha > 1e-2, 2e-4 of
        # the largest depth
        err = max(err, check_close(f"K4 {case} render", ok_["render"], op_["render"], 0.0, 2e-4),
                  check_close(f"K4 {case} alpha", ok_["alpha"], op_["alpha"], 0.0, 2e-4))
        cov = op_["alpha"] > 1e-2
        dmax = float(op_["depth"][cov].abs().max()) if bool(cov.any()) else 1.0
        check_close(f"K4 {case} depth", ok_["depth"][cov], op_["depth"][cov], 0.0, 2e-4 * dmax)
        # backward: atomics in run-dependent order plus the forward's
        # rounding -> 1e-3 of the largest gradient of each input, floored at
        # 1e-6 of the largest gradient of all inputs (an input whose gradient
        # vanishes, as the quats of isotropic splats do, carries rounding
        # noise only)
        top = max(float(b.abs().max()) for b in gp)
        for name, a, b in zip(names, gk, gp):
            scale = max(float(b.abs().max()), 1e-3 * top)
            check_close(f"K5 {case} d{name}", a, b, 0.0, 1e-3 * scale)
            gerr = max(gerr, float((a - b).abs().max()))
        log(f"[K4/K5] {case}: {ok_['n_pairs']} pairs, loss kernel {lk:.7f} plain {lp:.7f}")
    return err, gerr, world, opac, gen


def phase_gsplat(e_fwd: Entry, e_bwd: Entry, work: Path, stage1_out: Path):
    """K4/K5 against the plain compositor on a freshly initialised avatar."""
    import torch

    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_torch.avatar.trainer import AvatarTrainer
    from cap4d_torch.ops import gsplat_tiles as gt
    from cap4d_torch.utils import synthetic_assets as sa

    model, opt = avatar_params()
    flame_dir = sa.make_asset_dir(work / "avatar_assets", sphere_radius=0.09)
    scene = load_cap4d_dataset([str(stage1_out / "reference_images"),
                                str(stage1_out / "generated_images")])
    trainer = AvatarTrainer.create(scene, model, opt, flame_asset_dir=flame_dir)
    cam = scene.train_cameras[0]
    ct = trainer.camera_tensors(cam)
    err, gerr, world, opac, gen = gsplat_kernels_vs_plain(trainer, cam, model["sh_degree"],
                                                          "head")

    # timings of the compositor alone at these shapes (the second case)
    with torch.no_grad():
        ch = gt.project_gaussians_ch(world["means3d"], world["quats"], world["scales"],
                                     ct["rt"], ct["K"], cam.width, cam.height)
        cols = torch.rand((trainer.n_active, 3), generator=gen, device="cuda")
        packed = torch.stack([ch["mean_x"], ch["mean_y"], ch["conic_a"], ch["conic_b"],
                              ch["conic_c"], opac, cols[:, 0], cols[:, 1], cols[:, 2],
                              ch["depth"]], dim=-1).contiguous()
        pg, bd = gt.tile_pairs(ch["mean_x"], ch["mean_y"], ch["conic_a"], ch["conic_b"],
                               ch["conic_c"], opac, ch["radius"], ch["valid"], ch["depth"],
                               cam.width, cam.height)
        tiles_x = (cam.width + 15) // 16
        fwd, n_done = gt.composite_fwd_cuda(packed, pg, bd, tiles_x)
        go = torch.randn(fwd.shape, generator=gen, device="cuda")
        ms_f = time_ms(lambda: gt.composite_fwd_cuda(packed, pg, bd, tiles_x), iters=20)
        ms_b = time_ms(lambda: gt.composite_bwd_cuda(packed, pg, bd, fwd, n_done, go, tiles_x),
                       iters=20)
        plain_f = time_ms(lambda: gt.rasterize_gaussians_plain(packed, pg, bd, tiles_x),
                          iters=3, warmup=1)
        evals, kept = pair_pixel_counts(packed, pg, bd, n_done, tiles_x)
    pk = packed.clone().requires_grad_(True)
    plain_out = gt.rasterize_gaussians_plain(pk, pg, bd, tiles_x)
    plain_b = time_ms(lambda: torch.autograd.grad(plain_out, pk, go, retain_graph=True),
                      iters=3, warmup=1)
    N, M, n_tiles = packed.shape[0], pg.shape[0], n_done.shape[0]
    # operations per pair-pixel: forward 11 for every evaluation (dx, dy,
    # σ, e^-σ, compares) + 13 for a kept one (α, w, 5 accumulations, log1p,
    # T); backward the same 11 + 45 for a kept one (q, the suffix, dL/dα,
    # ten gradients and their warp-level sums)
    f_flops, b_flops = 11.0 * evals + 13.0 * kept, 11.0 * evals + 45.0 * kept
    f_bytes = N * 40 + M * 4 + (n_tiles + 1) * 4 + n_tiles * 256 * 24 + n_tiles * 4
    b_bytes = N * 40 + M * 4 + (n_tiles + 1) * 4 + 2 * n_tiles * 256 * 24 + n_tiles * 4 + N * 40
    for e, ms, pms, fl, by in ((e_fwd, ms_f, plain_f, f_flops, f_bytes),
                               (e_bwd, ms_b, plain_b, b_flops, b_bytes)):
        flop_ms, byte_ms = fl / FP32_FLOPS * 1e3, by / HBM_BYTES_PER_S * 1e3
        e.add(err if e is e_fwd else gerr, ms, pms, flop_ms, byte_ms)
        log(f"[{e.d['name']}] {N} gaussians, {M} pairs, {n_tiles} tiles, {evals} pair-pixel "
            f"evaluations ({kept} kept): kernel {ms:.3f} ms | plain {pms:.3f} ms | bound "
            f"{max(flop_ms, byte_ms):.4f} ms ({flop_ms:.4f} ms ops, {byte_ms:.4f} ms bytes)")
    log(f"[K4/K5] tiles that stopped early: {int((n_done.long() * 256 < (bd[1:] - bd[:-1])).sum())}"
        f" | max segment {int((bd[1:] - bd[:-1]).max())} pairs")
    del trainer, plain_out
    torch.cuda.empty_cache()
    return flame_dir


def check_eval_renders(trainer, scene, evals):
    """The evaluation's renders show the fitted avatar.

    Two kinds of held-out camera cannot. One whose stage-1 crop lies wholly
    outside its source image has an empty crop mask: its masked render and
    target are both zero, so ``evaluate`` counts an L1 of 0 and a PSNR of
    inf for it. One with no splat in front of it renders the white
    background alone. Both are named. Every other camera must show the
    avatar in its crop (alpha summing to at least 50 pixels there) and
    render the crop closer to the target than the white background would,
    at least one camera must, and a split without an empty camera must
    report a finite PSNR. Also counts the training views that see the head."""
    import torch

    def render(cam):
        with torch.no_grad():
            return trainer.render_camera(cam, int(cam.timestep))

    seen = sum(bool(render(c)["visibility"].any()) for c in scene.train_cameras)
    log(f"[fit] training views with splats in front of the camera: {seen} of "
        f"{len(scene.train_cameras)}")
    shown = 0
    for split in ("val", "test"):
        cams = getattr(scene, f"{split}_cameras")[:10]
        empty, unseen = [], []
        for cam in cams:
            ct = trainer.camera_tensors(cam)
            inside = ct["mask"] > 0.5
            if not bool(inside.any()):
                empty.append(cam.uid)
                continue
            out = render(cam)
            if not bool(out["visibility"].any()):
                assert float(out["alpha"].max()) == 0.0, (split, cam.uid)
                unseen.append(cam.uid)
                continue
            alpha = out["alpha"][inside]
            cover = float(alpha.sum())
            err = float((out["render"].clamp(0, 1) - ct["gt"]).abs().mean(-1)[inside].mean())
            err_bg = float((1.0 - ct["gt"]).mean(-1)[inside].mean())
            log(f"[fit] {split} camera {cam.uid}: {int(inside.sum())} in-crop pixels, alpha sum "
                f"{cover:.1f} (> 0.05 on {int((alpha > 0.05).sum())}, > 0.5 on "
                f"{int((alpha > 0.5).sum())}), L1 there {err:.4f} (white background {err_bg:.4f})")
            assert cover >= 50 and err < err_bg, (split, cam.uid, cover, err, err_bg)
            shown += 1
        psnrs = [l[f"{split}/psnr"] for l in evals if f"{split}/psnr" in l]
        log(f"[fit] {split}: cameras with an empty crop mask {empty}, with no splat in front "
            f"{unseen} | psnr {psnrs}")
        if cams and not empty:
            assert psnrs and all(math.isfinite(p) for p in psnrs), (split, psnrs)
    assert shown > 0, "no held-out camera shows the avatar"


def phase_fit(work: Path, stage1_out: Path, flame_dir: Path, kernels, card: str):
    """Stage 2 through ``training()``; returns the model path and launches."""
    import json as _json

    from cap4d_torch.avatar.train import training

    model, opt = avatar_params()
    model_path = work / "avatar"
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    trainer = training([str(stage1_out / "reference_images"),
                        str(stage1_out / "generated_images")],
                       model_path, model, opt, testing_iterations=[300],
                       checkpoint_iterations=[300], flame_asset_dir=flame_dir)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    lines = [_json.loads(l) for l in open(model_path / "metrics.jsonl")]
    steps = {l["iter"]: l for l in lines if "loss" in l}
    evals = [l for l in lines if "val/psnr" in l]
    assert all(math.isfinite(l["loss"]) for l in steps.values()), "non-finite fit loss"
    assert (model_path / "chkpnt300.pth").exists() and evals, "no checkpoint / eval"
    assert steps[190]["n_active"] != steps[210]["n_active"], "densification changed nothing"
    s_per_it = (steps[300]["elapsed_s"] - steps[20]["elapsed_s"]) / 280
    from cap4d_torch.avatar.scene import load_cap4d_dataset

    scene = load_cap4d_dataset([str(stage1_out / "reference_images"),
                                str(stage1_out / "generated_images")])
    n_eval = min(len(scene.val_cameras), 10) + min(len(scene.test_cameras), 10)
    log(f"[fit] 300 iterations, wall {wall:.1f} s | {s_per_it:.4f} s per iteration over "
        f"iterations 20-300 ({1 / s_per_it:.2f} it/s) | gaussians {steps[20]['n_active']} -> "
        f"{steps[300]['n_active']} | loss {steps[10]['loss']:.4f} -> {steps[300]['loss']:.4f} | "
        f"{evals[0]} | on {card}")
    log(f"[fit] launches {launches} (300 iterations + {n_eval} evaluation renders)")
    assert launches["gsplat_bwd"] == 300 and launches["gsplat_fwd"] == 300 + n_eval, launches
    assert launches["rasterize"] > 0, launches
    check_eval_renders(trainer, scene, [l for l in lines if "val/psnr" in l or "test/psnr" in l])
    # one more iteration and one evaluation render, outside the counted run
    cam = scene.train_cameras[0]
    profile_breakdown(lambda: trainer.train_step(cam, 301, 301), "fit iteration profile")
    profile_breakdown(lambda: trainer.render_camera(cam, cam.timestep, clip=True),
                      "render profile")
    del trainer
    return model_path, launches


def phase_animate(work: Path, model_path: Path, flame_dir: Path, kernels, card: str):
    from cap4d_torch.avatar.animate import render_sequence
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.plyio import read_ply

    drv = sa.make_driving_sequence(work, n_frames=48, resolution=512)
    out = work / "animation"
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = render_sequence(model_path, drv, out, flame_asset_dir=str(flame_dir), compress_ply=True)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    frames = sorted((out / "frames").glob("*.png"))
    assert res["frames"] == 48 and len(frames) == 48, (res, len(frames))
    ply = read_ply(out / "exported_animation.ply")
    assert "delta_vertex_00047" in ply, sorted(ply)[:5]
    log(f"[animate] 48 frames at 512x512: render loop {res['render_s']:.2f} s = "
        f"{48 / res['render_s']:.2f} FPS (PNG writes and PLY vertex capture included) | wall "
        f"{wall:.1f} s | on {card}")
    log(f"[animate] launches {launches}")
    assert launches["gsplat_fwd"] == 48, launches
    return launches


# --------------------------------------------- slice 3: MMDM training ----

TRAIN_ATTENTION = [  # (B, S, H) of the UNet's attentions at V=8, 64², calls per micro-batch
    ((8, 4096, 5), 5),      # level 0, 64², spatial
    ((1, 8192, 10), 5),     # level 1, 32², 3d
    ((1, 2048, 20), 5),     # level 2, 16², 3d
    ((1, 512, 20), 1),      # middle, 8², 3d
]


def phase_attention_backward(entry: Entry):
    """K1's lse2 output and K6 against their plain versions at the training
    shapes, a ragged S and the edge shapes; K6 run twice on the same inputs
    (dK and dV bit-identical, dQ's spread printed); K6's numbers summed over
    one micro-batch's 16 calls, beside SDPA's backward alone."""
    import torch
    import torch.nn.functional as F

    from cap4d_torch.ops import flash_attention as fa

    d = 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = TRAIN_ATTENTION + [((1, 1000, 4), 0)] + [((2, s, 4), 0) for s in EDGE_S]
    for (B, S, H), calls in cases:
        q, k, v, do = attention_inputs(gen, B, S, H)
        o_no_lse, _ = fa.flash_attention_fwd_cuda(q, k, v)
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, with_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(o, o_no_lse), "K1 output changes when it writes lse2"
        lse_ref = fa.attention_lse_plain(q, k)
        # fp32 row sums of S ex2.approx terms: 1e-3 in log2 is 0.07 % of a probability
        check_close(f"K1 lse2 B={B} S={S} H={H}", lse, lse_ref, 0.0, 1e-3)
        grads = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
        again = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse)
        refs = fa.attention_backward_plain(q.float(), k.float(), v.float(), o.float(),
                                           do.float(), lse)
        torch.cuda.synchronize()
        # dK and dV are deterministic; dQ sums the key blocks' partials with
        # atomic reductions in run-dependent order
        assert torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2]), \
            "K6 dK/dV differ between two runs on the same inputs"
        dq_spread = float((grads[0].float() - again[0].float()).abs().max())
        log(f"[K6] B={B} S={S} H={H}: two runs: dK, dV bit-identical, max |dQ1 - dQ2| "
            f"{dq_spread:.3g}")
        err = 0.0
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            # P and dS are rounded to bf16 before their products (as the
            # forward rounds P), and the outputs are bf16: 2e-2 of each
            # output's largest |grad|. At S = 1 a softmax over one key is
            # constant: dQ and dK are 0 up to rounding on both sides, and are
            # held at 2e-2 of dV's largest, the gradient's own units.
            scale = float((r if S > 1 else refs[2]).abs().max())
            e = check_close(f"K6 {name} B={B} S={S} H={H}", a, r, 0.0, 2e-2 * scale)
            log(f"[K6] {name} B={B} S={S} H={H}: max |kernel - plain| / max |plain| = "
                f"{e / max(scale, 1e-30):.3g}")
            err = max(err, e)
        del refs, again
        entry.d["max_abs_err"] = max(entry.d["max_abs_err"], err)
        if not calls:
            continue
        ms = time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse))
        plain_ms = time_ms(lambda: fa.attention_backward_plain(q, k, v, o, do, lse),
                           iters=3, warmup=1)
        fwd_lse_ms = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, with_lse=True))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_backward():
            # the forward runs once under the chosen backend; the timed call
            # is its backward alone, on the retained graph
            out = F.scaled_dot_product_attention(qt, kt, vt)
            return lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

        lib_ms, backend = sdpa_fastest(sdpa_backward)
        flops = 10.0 * S * S * d * B * H
        nbytes = 8.0 * B * S * H * d * 2 + B * H * S * 4   # q k v o dO in, dq dk dv out, lse2
        flop_ms, byte_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        entry.add(0.0, calls * ms, calls * plain_ms, calls * flop_ms, calls * byte_ms,
                  calls * lib_ms)
        dev_ms = device_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse),
                           ("bwd_prep", "bwd_main", "bwd_dq"))
        log(f"[K6] B={B} S={S} H={H} (x{calls} per micro-batch): kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s; on the device {dev_ms:.4f} ms, "
            f"{flops / dev_ms / 1e9:.1f} TFLOP/s) | plain {plain_ms:.3f} ms | sdpa ({backend}) "
            f"backward {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s) | bound "
            f"{max(flop_ms, byte_ms):.4f} ms | K1 with lse2 {fwd_lse_ms:.4f} ms")
    log(f"[K6] per micro-batch (16 calls): kernel {entry.d['ms']:.4f} ms | plain "
        f"{entry.d['plain_ms']:.3f} ms | fastest sdpa backward {entry.d['library_ms']:.4f} ms | "
        f"bound {entry.d['bound_ms']:.4f} ms ({entry.d['bound_by']})")


def shipped_schedule():
    from cap4d_torch.mmdm.schedule import make_mmdm_schedule

    mp = shipped_model_section()["params"]
    return make_mmdm_schedule(
        timesteps=mp["timesteps"], linear_start=mp["linear_start"], linear_end=mp["linear_end"],
        zero_snr_shift=mp["zero_snr_shift"], shift=mp["shift_schedule"],
        sqrt_shift=mp["sqrt_shift"], minus_one_shift=mp["minus_one_shift"],
        n_frames=mp["n_frames"], image_size=mp["image_size"])


def phase_unet_grad():
    """One training loss and its gradients at full width, kernels against
    plain versions; no gradient that the plain versions give may be dropped."""
    import torch

    from cap4d_torch.mmdm.model import init_random_
    from cap4d_torch.mmdm.training import mmdm_loss, schedule_consts
    from cap4d_torch.mmdm.unet import GroupNorm32

    mp = shipped_model_section()["params"]
    unet = build_shipped_unet()
    init_random_(unet, 0)   # the random-weights mode: N(0, 0.02), ≤1-D parameters zero
    gen = torch.Generator(device="cuda").manual_seed(4)
    norms = {id(m.weight) for m in unet.modules()
             if isinstance(m, (GroupNorm32, torch.nn.LayerNorm))}
    with torch.no_grad():
        # a live init: with every norm scale 0 (the random-weights mode) q = k
        # = v = 0 and the attention gradients vanish
        for p in unet.parameters():
            if id(p) in norms:
                p.fill_(1.0)
            elif p.ndim == 1:
                p.normal_(0.0, 0.02, generator=gen)
    unet.train().requires_grad_(True)
    unet.remat, unet.compute_dtype = True, torch.bfloat16
    unet.to(memory_format=torch.channels_last)
    n_params = sum(p.numel() for p in unet.parameters())
    consts = schedule_consts(shipped_schedule(), "cuda")
    B, T, L = 1, mp["n_frames"], mp["image_size"]
    z = torch.randn((B, T, L, L, 4), generator=gen, device="cuda")
    ref = torch.zeros((B, T, L, L, 1), device="cuda")
    ref[:, :4] = 1.0
    cond = {"pos_enc": torch.randn((B, T, L, L, 50), generator=gen, device="cuda"),
            "z_input": z * ref, "ref_mask": ref}
    t = torch.randint(0, mp["timesteps"], (B, T), generator=gen, device="cuda")
    noise = torch.randn(z.shape, generator=gen, device="cuda")

    def micro_batch():
        unet.zero_grad(set_to_none=True)
        loss, _ = mmdm_loss(unet, consts, z, cond, t=t, noise=noise)
        loss.backward()
        return loss

    res = {}
    for plain in (False, True):
        unet.use_plain_ops(plain)
        micro_batch()   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = micro_batch()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        grads = {n: p.grad.detach().clone() for n, p in unet.named_parameters()}
        res[plain] = (float(loss.detach()), grads)
        log(f"[unet grad] {'plain versions' if plain else 'kernels'}: loss {res[plain][0]:.6f} | "
            f"micro-batch (forward, remat recompute, backward) {sec:.4f} s | peak "
            f"{peak:.2f} GiB | {n_params} parameters")
    unet.use_plain_ops(False)
    profile_breakdown(micro_batch, "train micro-batch profile")
    (lk, gk), (lp, gp) = res[False], res[True]
    assert math.isfinite(lk) and math.isfinite(lp)
    rel_loss = abs(lk - lp) / abs(lp)
    rels, dropped = {}, []
    for n, g in gp.items():
        norm = float(g.float().norm())
        if norm == 0.0:
            continue
        if not bool(gk[n].any()):
            dropped.append(n)
        rels[n] = float((gk[n] - g).float().norm()) / norm
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:8]
    n_zero = len(gp) - len(rels)
    log(f"[unet grad] loss relative difference {rel_loss:.3g} (tolerance 1e-2) | "
        f"{len(rels)} parameter tensors with a nonzero plain gradient, {n_zero} with a zero one "
        f"| worst ||g_k - g_p|| / ||g_p|| (tolerance 5e-2): "
        + ", ".join(f"{n} {r:.3g}" for n, r in worst))
    assert not dropped, f"kernel gradients all zero where the plain ones are not: {dropped}"
    assert rel_loss <= 1e-2, rel_loss
    bad = {n: r for n, r in rels.items() if r > 5e-2}
    assert not bad, f"gradients off by more than 5e-2: {bad}"
    del unet, res, gk, gp
    torch.cuda.empty_cache()


def phase_train(work: Path, kernels, card: str):
    """The training main path, as a user runs it, with the cuts listed."""
    import torch

    from cap4d_torch.mmdm.schedule import make_ddim_timesteps
    from cap4d_torch.mmdm.train import load_train_checkpoint, train_mmdm
    from cap4d_torch.mmdm.unet import AttentionModule, GroupNorm32
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.config import dump_yaml, load_yaml
    from cap4d_torch.utils.png import read_png

    cfg = load_yaml(REPO / "configs" / "mmdm" / "cap4d_mmdm_final.yaml")
    # the only cuts: the virtual batch and the step count (checkpoint and image log at the end)
    cuts = {"virtual_batch_size": 4, "n_steps": 3, "save_every_n_steps": 3}
    log(f"[train] cuts of configs/mmdm/cap4d_mmdm_final.yaml: " + ", ".join(
        f"{k} {cfg[k]} -> {v}" for k, v in cuts.items()) + "; image_log_every 3")
    root = work / "train"
    cfg_path = root / "train_config.yaml"
    root.mkdir(parents=True)
    dump_yaml(dict(cfg, **cuts), cfg_path)
    flame_dir = sa.make_asset_dir(root)
    out = root / "output"
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_mmdm(cfg_path, out, flame_asset_dir=flame_dir, log_every=1, image_log_every=3)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    unet = state.unet
    n_params = sum(p.numel() for p in unet.parameters())
    lines = [json.loads(l) for l in open(out / "train_metrics.jsonl")]
    assert [l["step"] for l in lines] == [1, 2, 3], lines
    losses = [l["loss"] for l in lines]
    assert all(math.isfinite(l) for l in losses), losses
    elapsed = {l["step"]: l["step"] / l["steps_per_sec"] for l in lines}
    accum = cuts["virtual_batch_size"]
    s_step = (elapsed[3] - elapsed[1]) / 2
    log(f"[train] {n_params} UNet parameters | losses {losses} | step 1 (warm-up) "
        f"{elapsed[1]:.3f} s | steps 2-3: {s_step:.4f} s per optimizer step, "
        f"{s_step / accum:.4f} s per micro-batch ({accum} micro-batches a step) | peak "
        f"{peak:.2f} GiB allocated | wall {wall:.1f} s with set-up, image log and checkpoint "
        f"| on {card}")

    n_attn = sum(isinstance(m, AttentionModule) for m in unet.modules())
    n_gn = sum(isinstance(m, GroupNorm32) for m in unet.modules())
    micro = accum * cuts["n_steps"]
    n_ddim = len(make_ddim_timesteps(10, 1000))
    # remat runs every attention and every GroupNorm but the last one twice;
    # the image log's DDIM runs 10 forwards without gradients
    expect = {"flash_attention_bwd": micro * n_attn,
              "flash_attention": micro * 2 * n_attn + n_ddim * n_attn,
              "group_norm": micro * (2 * n_gn - 1) + n_ddim * n_gn}
    log(f"[train] launches {launches} over {micro} micro-batches and {n_ddim} DDIM forwards "
        f"(expected {expect})")
    for name, n in expect.items():
        assert launches[name] == n, (name, launches[name], n)

    grid = read_png(out / "image_log" / "samples_000003.png")
    assert grid.shape == (512, 8 * 514 - 2, 3), grid.shape
    ckpt = out / "mmdm_step3.pkl"
    fresh = build_shipped_unet()
    assert load_train_checkpoint(ckpt, fresh) == 3
    fresh.compute_dtype = torch.bfloat16
    fresh.to(memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(5)
    L = 64
    x = torch.randn((1, 8, L, L, 4), generator=gen, device="cuda")
    ref = torch.zeros((1, 8, L, L, 1), device="cuda")
    ref[:, :4] = 1.0
    cond = {"pos_enc": torch.randn((1, 8, L, L, 50), generator=gen, device="cuda"),
            "z_input": x * ref, "ref_mask": ref}
    ts = torch.randint(0, 1000, (1, 8), generator=gen, device="cuda")
    with torch.no_grad():
        eps_a, eps_b = unet(x, ts, cond), fresh(x, ts, cond)
    err = float((eps_a - eps_b).abs().max())
    log(f"[train] mmdm_step3.pkl ({ckpt.stat().st_size / 2**30:.2f} GiB) reloaded into a fresh "
        f"UNet: eps max |trained - reloaded| {err:.3g} (max |eps| {float(eps_a.abs().max()):.3g})")
    assert bool(eps_a.isfinite().all()) and err <= 1e-3 * float(eps_a.abs().max()), err
    del fresh

    # one more optimizer step through the loop's own step function, timed
    # alone and profiled (outside the counted run)
    import numpy as np

    from cap4d_torch.mmdm.train import SyntheticMMDMDataset, make_accum_train_step

    model = SimpleNamespace(unet=unet, schedule=shipped_schedule(), device=torch.device("cuda"),
                            latent_size=L)
    data = SyntheticMMDMDataset(model, n_views=8, n_ref=4, seed=1).batches(1)
    t0 = time.perf_counter()
    micro_batches = [next(data) for _ in range(accum)]
    z_stack = torch.as_tensor(np.stack([m["z"] for m in micro_batches]), device="cuda")
    cond_stack = {k: torch.as_tensor(np.stack([m["cond"][k] for m in micro_batches]),
                                     device="cuda") for k in micro_batches[0]["cond"]}
    torch.cuda.synchronize()
    log(f"[train] host: drawing and uploading one step's synthetic batches (as the loop does) "
        f"{time.perf_counter() - t0:.4f} s")
    step_fn = make_accum_train_step(model, state.optimizer, accum)
    gen = torch.Generator(device="cuda").manual_seed(6)

    def one_step():
        return step_fn(state, z_stack, cond_stack, gen)

    one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    log(f"[train] one more optimizer step ({accum} micro-batches + AdamW), timed alone: "
        f"{time.perf_counter() - t0:.4f} s")
    profile_breakdown(one_step, "train step profile")
    adamw_ms = time_ms(lambda: state.optimizer.step(), iters=3, warmup=1)
    log(f"[train] AdamW update over {n_params} fp32 parameters: {adamw_ms:.3f} ms")
    del state, unet
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------- slice 4: K7 and the SMPL body ----

MATMUL_CASES = ("acc_matmul3", "acc_matmul2", "tri_matmul2", "tri_blocked", "tri_blocked4")


def bf16_rn_numpy(a):
    """float32 → bfloat16 (round to nearest even) → float32, on the bits."""
    import numpy as np

    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def op_mix_term_numpy(x, acc, case):
    """The extra term of one body application, in float64 numpy: scan8's
    exclusive lane prefix product, the acc_matmul cases' split-bf16 (PX, CH)
    @ (CH, 5) product with cmat = [x0, x1, x2, 1, x3]."""
    import numpy as np

    if case == "scan8":
        return np.concatenate([np.ones((acc.shape[0], 1)),
                               np.cumprod(acc.astype(np.float64), axis=1)[:, :-1]], axis=1)
    cmat = np.concatenate([x[0:3], np.ones((1, x.shape[1]), np.float32), x[3:4]], axis=0)
    a_hi = bf16_rn_numpy(acc)
    a_lo = bf16_rn_numpy(acc - a_hi)
    b_hi = bf16_rn_numpy(cmat)
    b_lo = bf16_rn_numpy(cmat - b_hi)
    f = lambda a, b: a.astype(np.float64) @ b.astype(np.float64).T
    out = f(a_hi, b_hi) + f(a_lo, b_hi)
    return out + f(a_hi, b_lo) if case == "acc_matmul3" else out


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def phase_op_mix(entry: Entry, kernels, card: str):
    """K7 against its plain version for all 15 cases at NITER 1 and 64, the
    extra terms against numpy, the SASS of each case's loop; then the tool's
    run at NITER 262,144 (the main path of this kernel)."""
    import numpy as np
    import torch

    from cap4d_torch.ops import op_mix as om
    from cap4d_torch.tools import bench_ops

    x = bench_ops.make_input("cuda")
    for case in om.CASES:
        for niter in (1, 64):
            out = om.op_mix(x, case, niter)
            ref = om.op_mix(x, case, niter, plain=True)
            torch.cuda.synchronize()
            # the test's tolerances: one or two ulps of the transcendentals,
            # fp32 sums of bf16 products in another order for the matmul cases
            atol = 1e-5 if case in MATMUL_CASES else 1e-6
            err = check_close(f"K7 {case} NITER={niter}", out, ref, 1e-5, atol)
            entry.d["max_abs_err"] = max(entry.d["max_abs_err"], err)
    gen = torch.Generator(device="cuda").manual_seed(8)
    xn = x.cpu().numpy()
    for case in om.TERM_CASES:
        # acc near 1 keeps scan8's 255-long products normal floats
        lo, hi = (0.97, 1.03) if case == "scan8" else (0.1, 0.5)
        acc = lo + (hi - lo) * torch.rand(x.shape, generator=gen, device="cuda")
        term = om.op_mix_term(x, acc, case)
        ref = torch.as_tensor(op_mix_term_numpy(xn, acc.cpu().numpy(), case), dtype=torch.float32)
        check_close(f"K7 {case} term vs numpy", term.cpu(), ref, 1e-5, 0.0)
    sass = bench_ops.sass_loop_histograms(om.KERNEL.so_path())
    for case in om.CASES:
        h = sass.get(case)
        assert h, f"no loop found in the SASS of {case}"
        log(f"[K7 sass] {case}: {sum(h.values())} instructions per iteration: " + ", ".join(
            f"{op} {n}" for op, n in h.most_common(10)))

    niter = bench_ops.NITER
    for k in kernels:
        k.launches = 0
    res = bench_ops.run_bench(niter)
    launches = {k.name: k.launches for k in kernels}
    for case, r in res.items():
        assert bool(torch.isfinite(r["out"]).all()), f"K7 {case}: non-finite output at NITER {niter}"
    log(f"[K7] bench_ops at NITER {niter}, K {om.K} on {card}:\n" + bench_ops.format_table(res, niter))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    for case, r in res.items():
        plain_ms = time_ms(lambda: om.op_mix(x, case, 64, plain=True), iters=3, warmup=1)
        b_ms, pipe = bench_ops.bound_ms(case, niter, n_sm, clock)
        byte_ms = 2.0 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
        entry.add(0.0, r["ms"], plain_ms, b_ms, byte_ms)
        log(f"[K7] {case}: kernel {r['ms']:.3f} ms at NITER {niter} | plain {plain_ms:.3f} ms at "
            f"NITER 64 | bound {b_ms:.3f} ms ({pipe}; {n_sm} SMs at {clock / 1e6:.0f} MHz) | "
            f"{r['ms'] / b_ms:.1f}x the bound")
    log(f"[K7] launches {launches}")
    assert launches["op_mix"] == 4 * len(om.CASES), launches
    return launches


SMPL_VIEW = (540, 960)   # (W, H): half of generate_animation_camerahmr's 1080 x 1920 portrait


def phase_smpl(work: Path, kernels, card: str):
    """The full-body main path at full width on synthetic SMPL-sized assets:
    K4/K5 against the plain compositor at one full-body view of a fresh
    avatar, ``train_fullbody`` (300 iterations), ``render_sequence_smpl``
    of its checkpoint on the 48-frame wave; returns both runs' launches."""
    import json as _json

    import numpy as np
    import torch

    from cap4d_torch.avatar.animate_smpl import load_trained_smpl_avatar, render_sequence_smpl
    from cap4d_torch.avatar.train_fullbody import SMPL_DISABLED_REGULARIZERS, train_fullbody
    from cap4d_torch.avatar.trainer import AvatarTrainer
    from cap4d_torch.smpl.scene import load_smpl_dataset
    from cap4d_torch.tools.generate_animation import make_wave_animation
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.config import dump_yaml
    from cap4d_torch.utils.plyio import read_ply

    root = work / "smpl"
    smpl_dir = sa.make_smpl_asset_dir(root)
    data = sa.make_smpl_dataset(root, n_views=16, width=SMPL_VIEW[0], height=SMPL_VIEW[1])
    model, opt = avatar_params()
    log(f"[smpl] cuts: views {SMPL_VIEW[0]}x{SMPL_VIEW[1]} (half of 1080x1920), 16 synthetic "
        f"views around the body, configs/avatar/debug.yaml opt_params to 300 iterations; "
        f"model_params of configs/avatar/default.yaml as shipped")

    # K4/K5 at one full-body view of a fresh avatar; every training view sees it
    scene = load_smpl_dataset([str(data)])
    trainer = AvatarTrainer.create_smpl(scene, model, dict(opt, **SMPL_DISABLED_REGULARIZERS),
                                        smpl_asset_dir=smpl_dir)
    with torch.no_grad():
        pairs = [int(trainer.render_camera(c, c.timestep)["n_pairs"]) for c in scene.train_cameras]
    log(f"[smpl] {trainer.n_active} splats over {trainer.uv.remesh_faces.shape[0]} remesh faces "
        f"(uv {trainer.uv.resolution}) | pairs per training view: {pairs}")
    assert all(p > 0 for p in pairs), f"training views that render no pair: {pairs}"
    cam = scene.train_cameras[0]
    gsplat_kernels_vs_plain(trainer, cam, model["sh_degree"], f"smpl {cam.width}x{cam.height}")
    del trainer
    torch.cuda.empty_cache()

    cfg = root / "fullbody.yaml"
    dump_yaml({"model_params": model, "opt_params": opt}, cfg)
    model_path = root / "avatar"
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    trainer = train_fullbody([str(data)], model_path, cfg, interval=300, smpl_asset_dir=smpl_dir)
    wall = time.perf_counter() - t0
    fit_launches = {k.name: k.launches for k in kernels}
    lines = [_json.loads(l) for l in open(model_path / "metrics.jsonl")]
    steps = {l["iter"]: l for l in lines if "loss" in l}
    evals = [l for l in lines if "val/psnr" in l or "test/psnr" in l]
    assert all(math.isfinite(l["loss"]) for l in steps.values()), "non-finite fit loss"
    assert (model_path / "chkpnt300.pth").exists() and evals, "no checkpoint / evaluation"
    assert steps[190]["n_active"] != steps[210]["n_active"], "densification changed nothing"
    s_per_it = (steps[300]["elapsed_s"] - steps[20]["elapsed_s"]) / 280
    n_eval = len(scene.val_cameras[:10]) + len(scene.test_cameras[:10])
    log(f"[smpl fit] 300 iterations, wall {wall:.1f} s | {s_per_it:.4f} s per iteration over "
        f"iterations 20-300 ({1 / s_per_it:.2f} it/s) | splats {steps[20]['n_active']} -> "
        f"{steps[300]['n_active']} | loss {steps[10]['loss']:.4f} -> {steps[300]['loss']:.4f} | "
        f"{evals} | on {card}")
    log(f"[smpl fit] launches {fit_launches} (300 iterations + {n_eval} evaluation renders)")
    assert fit_launches["gsplat_bwd"] == 300, fit_launches
    assert fit_launches["gsplat_fwd"] == 300 + n_eval, fit_launches
    assert fit_launches["rasterize"] == 1, fit_launches      # the template's UV layout
    assert all(math.isfinite(l.get("val/psnr", 0.0)) for l in evals), evals
    cam = scene.train_cameras[0]
    profile_breakdown(lambda: trainer.train_step(cam, 301, 301), "smpl fit iteration profile")
    del trainer
    torch.cuda.empty_cache()

    anim = root / "wave.npz"
    np.savez(anim, **make_wave_animation(48, (1080, 1080)))
    out = root / "animation"
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = render_sequence_smpl(model_path, anim, out, smpl_asset_dir=smpl_dir, compress_ply=True)
    wall = time.perf_counter() - t0
    anim_launches = {k.name: k.launches for k in kernels}
    frames = sorted((out / "frames").glob("*.png"))
    assert res["frames"] == 48 and len(frames) == 48, (res, len(frames))
    ply = read_ply(out / "exported_animation.ply")
    assert "delta_vertex_00047" in ply, sorted(ply)[:5]
    mp4 = out / "renders.mp4"
    log(f"[smpl animate] 48 frames at 1080x1080: render loop {res['render_s']:.2f} s = "
        f"{48 / res['render_s']:.2f} FPS (PNG writes and PLY vertex capture included) | wall "
        f"{wall:.1f} s | mp4 {mp4.stat().st_size if mp4.exists() else 'not written'} bytes "
        f"(ffmpeg {'found' if shutil.which('ffmpeg') else 'absent'}) | on {card}")
    log(f"[smpl animate] launches {anim_launches}")
    assert anim_launches["gsplat_fwd"] == 48 and anim_launches["rasterize"] == 1, anim_launches
    scene_a = load_smpl_dataset(None, target_animation_path=str(anim))
    tr = load_trained_smpl_avatar(model_path, smpl_dir, scene_a)
    cam = scene_a.tgt_cameras[24]
    with torch.no_grad():
        img = tr.render_camera(cam, cam.timestep, clip=True)
        log(f"[smpl animate] frame 24: alpha > 0.5 on {int((img['alpha'] > 0.5).sum())} pixels, "
            f"{int(img['n_pairs'])} pairs")
        assert bool(img["render"].isfinite().all()) and float(img["alpha"].max()) > 0.5
        profile_breakdown(lambda: tr.render_camera(cam, cam.timestep, clip=True)["render"].cpu(),
                          "smpl frame profile")
    del tr
    torch.cuda.empty_cache()
    return fit_launches, anim_launches


PHASES = ("attention", "attention_bwd", "group_norm", "rasterize", "unet", "unet_grad",
          "generate", "gsplat", "fit", "animate", "train", "op_mix", "smpl")


def main() -> int:
    if not (REPO / "cap4d_torch").is_dir() or not (REPO / "configs").is_dir():
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    phases = parser.parse_args().phases.split(",")
    assert set(phases) <= set(PHASES), phases
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from cap4d_torch.ops import flash_attention, gsplat_tiles, norms, op_mix, rasterize

    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    kernels = [flash_attention.KERNEL, norms.KERNEL, rasterize.KERNEL,
               gsplat_tiles.KERNEL_FWD, gsplat_tiles.KERNEL_BWD, flash_attention.KERNEL_BWD,
               op_mix.KERNEL]
    phase_build(kernels)
    if "attention" in phases or "attention_bwd" in phases:
        phase_attention_sass()

    work = REPO / ".chip_smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    entries = [
        Entry("flash_attention", "cuda", "cap4d_torch/csrc/flash_attention.cu",
              "cap4d_tpu/ops/flash_attention.py:45", flash_attention.KERNEL, library=True),
        Entry("group_norm_silu", "cuda", "cap4d_torch/csrc/group_norm.cu",
              "cap4d_tpu/ops/norms.py:26", norms.KERNEL, library=True),
        Entry("rasterize", "cuda", "cap4d_torch/csrc/rasterize.cu",
              "cap4d_tpu/ops/rasterize.py:233", rasterize.KERNEL, library=False),
        Entry("gsplat_fwd", "cuda", "cap4d_torch/csrc/gsplat_fwd.cu",
              "cap4d_tpu/ops/gsplat_pallas.py:197", gsplat_tiles.KERNEL_FWD, library=False),
        Entry("gsplat_bwd", "cuda", "cap4d_torch/csrc/gsplat_bwd.cu",
              "cap4d_tpu/ops/gsplat_pallas.py:266", gsplat_tiles.KERNEL_BWD, library=False),
        Entry("flash_attention_bwd", "cuda", "cap4d_torch/csrc/flash_attention_bwd.cu",
              "cap4d_tpu/ops/attention.py:42", flash_attention.KERNEL_BWD, library=True),
        Entry("op_mix", "cuda", "cap4d_torch/csrc/op_mix.cu", "tools/bench_vpu_ops.py:37",
              op_mix.KERNEL, library=False),
    ]
    main_paths = []   # launch counts of each main path run
    if "attention" in phases:
        phase_attention(entries[0])
    if "attention_bwd" in phases:
        phase_attention_backward(entries[5])
    if "group_norm" in phases:
        phase_group_norm(entries[1])
    if "rasterize" in phases:
        phase_rasterize(entries[2], work / "raster")
    if "unet" in phases:
        phase_unet()
    if "unet_grad" in phases:
        phase_unet_grad()
    if "generate" in phases:
        gen_launches, stage1_out = phase_main_path(work, kernels, card)
        main_paths.append(gen_launches)
        if "gsplat" in phases:
            flame_dir = phase_gsplat(entries[3], entries[4], work, stage1_out)
            if "fit" in phases:
                model_path, fit_launches = phase_fit(work, stage1_out, flame_dir, kernels, card)
                main_paths.append(fit_launches)
                if "animate" in phases:
                    main_paths.append(phase_animate(work, model_path, flame_dir, kernels, card))
    if "train" in phases:
        main_paths.append(phase_train(work, kernels, card))
    if "op_mix" in phases:
        main_paths.append(phase_op_mix(entries[6], kernels, card))
    if "smpl" in phases:
        main_paths.extend(phase_smpl(work, kernels, card))
    shutil.rmtree(work, ignore_errors=True)
    if phases != list(PHASES):
        log(f"[done] phases {phases} passed; no result lines for a partial run")
        return 1
    for e in entries:
        n = e.kernel.name
        e.d["launches"] = sum(launches[n] for launches in main_paths)
        assert e.d["launches"] > 0, f"{n} never launched on the main paths"

    log(f"[device] {card}")
    print(json.dumps({"kernels": [e.d for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
