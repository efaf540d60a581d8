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
  3. K2 GroupNorm(+SiLU): ptxas's registers and spills (none), then against
     its plain version at main-path shapes (stage 1's, training's largest,
     and one whose slab fits no cluster), with times by CUDA events and
     torch.profiler;
  4. K3 rasterizer: ptxas's registers and spills (none); against its plain
     version (and its first step, the face records and pixel boxes, against
     ``face_setup_plain`` bit for bit) on five sets: 32 synthetic FLAME
     frames at 128² (the fan-triangulated conditioning template, unchanged
     so its times compare with the brute-force kernel's), 32 frames at 128²
     of a 10k-face head hull (local faces), the head avatar's and the SMPL
     body's UV layouts at 256², and edge cases at 120×200 (z = 0 straddled,
     ±1e30, ±inf, NaN x or y, zero area, slivers on tile borders and pixel
     centres, a whole-image face, equal-z duplicates); times by CUDA events
     and torch.profiler per step, box tests and what the tile kernel sweeps
     and keeps;
  5. one full-width UNet forward (shipped config, V=8, 64² latents, CFG
     batch 2, bf16) with nonzero norm scales, kernels against plain versions;
     then one training loss and its gradients at full width (fp32 parameters,
     bf16 compute, remat), kernels against plain versions, every parameter;
  6. the stage-1 main path: ``run_generation`` at the shipped width on
     synthetic assets with random weights (the debug generation config: 10
     DDIM steps, 28 samples), with every kernel's launch count read around
     that run; then stage 1's batched view-groups: the same config on
     random weights that carry signal (norm scales near 1) and one set of
     initial latents at ``groups_per_device`` 1, 2 and 4, and 8 at 56
     samples, each run counted, timed and its peak memory while sampling
     read; z_gen at 4 held against 1 (relative norm gap within
     ``BATCHED_REL_TOL``), and K1/K2 against their plain versions at the
     shapes the batched run launched them at;
  6b. the native runtime (``loader``): the machine's codec headers and
     libraries (none are needed), a timed g++ build, PNG and JPEG round
     trips (PNG decode bit for bit against ``read_png``), 64 frames through
     the prefetch pool against the serial Python path, and a
     ``--detect_anomaly`` stage 1 whose UNet returns NaN at DDIM step 2,
     which must raise ``FloatingPointError``;
  7. K4/K5 (3DGS tile compositing forward/backward) against the plain
     compositor at the fit's shapes: a freshly initialised full-width avatar
     (``configs/avatar/default.yaml`` model_params, head-sized sphere
     template) rendered at 512² from stage 1's reference camera, outputs and
     the gradients of a fixed loss; K4's outputs, batches run and state and
     K5's gradient against the plain versions at the kernels' interfaces;
     then the same on single deep tiles of ~1,200 and ~12,000 pairs. Run
     alone (``--phases gsplat``) it writes stage 1's reference camera
     without the MMDM;
  8. the stage-2 main path: ``training()`` on phase 6's 28 + 1 images with
     default model_params and debug opt_params cut to 300 iterations
     (densification, opacity reset, SH warmup, evaluation, checkpoint);
  9. the stage-3 main path: ``render_sequence`` of that checkpoint driven by
     a synthetic 48-frame fit.npz at 512², with the animated PLY;
  9b. the head fit's held-out quality (``quality``): ``fit_holdout_quality``
     cut to 300 iterations (27 orbit views that see the head, 3 held out;
     the oracle rendered by the plain compositor, the fit through K4/K5);
 10. the MMDM training main path: ``train_mmdm`` on the shipped training
     config at full width with the synthetic dataset, bf16, cut to a virtual
     batch of 4 micro-batches and 3 optimizer steps (checkpoint and image log
     at step 3); the checkpoint reloads into a fresh UNet; then, outside the
     counted run, one more step through the loop's step function, timed
     alone and profiled, and the AdamW update alone;
 11. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Launch counts are read around each main path (6 and its batched runs, 8,
9, 9b, 10, and the op-mix and SMPL runs) with every count set to 0 just
before it; the kernels line sums them.

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


def device_ms(fn, keys, iters: int = 20):
    """Device time per call of the kernels whose names contain one of
    ``keys``, from torch.profiler over ``iters`` calls: what a call costs
    the card, without the host time that bounds ``time_ms`` at small
    shapes. The profiler does not record the card's kernels in every run;
    where two tries saw none of them this returns None, and the caller
    prints "not measured" beside the CUDA events' time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(k in e.key for k in keys))
        if us > 0:
            return us / iters / 1e3
    return None


def shown(ms, unit: str = " ms") -> str:
    """``ms`` to four places, or "not measured" where it is None."""
    return "not measured" if ms is None else f"{ms:.4f}{unit}"


def tflops(flops: float, ms) -> str:
    return "not measured" if ms is None else f"{flops / ms / 1e9:.1f} TFLOP/s"


def ratio(a, b) -> str:
    """a / b to two places, or "not measured" where either is None."""
    return "not measured" if a is None or b is None else f"{a / b:.2f}x"


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
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  check=True).stdout
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
            f"({flops / ms / 1e9:.1f} TFLOP/s; on the device {shown(dev_ms)}, "
            f"{tflops(flops, dev_ms)}) | plain {plain_ms:.3f} ms | sdpa ({backend}) "
            f"{lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s) | bound "
            f"{max(flop_ms, byte_ms):.4f} ms")
    log(f"[K1] 5 shapes summed: kernel {entry.d['ms']:.4f} ms | fastest sdpa "
        f"{entry.d['library_ms']:.4f} ms | bound {entry.d['bound_ms']:.4f} ms")


def kernel_ptxas(kernel, tag: str) -> None:
    """ptxas's registers and spills of every function of ``kernel``; asserts
    that none spills."""
    report = ptxas_report(kernel)
    assert report, f"no ptxas report for {kernel.source.name}"
    for fn, (regs, st, ld) in report.items():
        log(f"[{tag} ptxas] {kernel.source.name} {fn}: {regs} registers, {st} bytes spill "
            f"stores, {ld} bytes spill loads")
        assert st == 0 and ld == 0, f"{fn} spills: {st} B stored, {ld} B loaded"


GN_SHAPES = [(16, 64, 64, 320), (16, 32, 32, 960), (16, 8, 8, 2560)]   # the table's six
# checked and timed on their own lines: the decoder's widest slab at stage 1,
# the largest shape of training's micro-batch, and a slab too large for any
# cluster's shared memory (the kernel's second path: rows read twice)
GN_EXTRA_SHAPES = [(16, 64, 64, 960), (8, 64, 64, 320), (2, 256, 256, 640)]


def phase_group_norm(entry: Entry):
    import torch
    import torch.nn.functional as F

    from cap4d_torch.ops.norms import group_norm_silu, plan_group_norm

    kernel_ptxas(entry.kernel, "K2")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev_sum = 0.0   # the table's six shapes on the device; None once one is not measured
    for shape in GN_SHAPES + GN_EXTRA_SHAPES:
        C = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(C, generator=gen, device="cuda")
        plan = plan_group_norm(shape, x.dtype, 32)
        for silu, eps in ((True, 1e-5), (False, 1e-6)):
            out = group_norm_silu(x, scale, bias, 32, eps, silu)
            ref = group_norm_silu(x, scale, bias, 32, eps, silu, plain=True)
            torch.cuda.synchronize()
            # bf16 output: a 1-2 ulp difference from the folded affine
            err = check_close(f"K2 {shape} silu={silu}", out, ref, 1e-2, 1e-3)
            ms = time_ms(lambda: group_norm_silu(x, scale, bias, 32, eps, silu))
            dev_ms = device_ms(lambda: group_norm_silu(x, scale, bias, 32, eps, silu),
                               ("gn_silu_kernel",))
            plain_ms = time_ms(lambda: group_norm_silu(x, scale, bias, 32, eps, silu, plain=True))
            xn, sb, bb = x.permute(0, 3, 1, 2), scale.to(x.dtype), bias.to(x.dtype)
            lib_ms = time_ms(lambda: F.group_norm(xn, 32, sb, bb, eps))
            nbytes = 2.0 * x.numel() * x.element_size()     # read x once, write y once
            byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
            flop_ms = 8.0 * x.numel() / FP32_FLOPS * 1e3
            if shape in GN_SHAPES:
                entry.add(err, ms, plain_ms, flop_ms, byte_ms, lib_ms)
                dev_sum = None if dev_sum is None or dev_ms is None else dev_sum + dev_ms
            log(f"[K2{'' if shape in GN_SHAPES else ' extra'}] {shape} silu={silu} eps={eps}: "
                f"kernel {ms:.4f} ms, device {shown(dev_ms)} "
                f"({nbytes / ms / 1e6:.0f} GB/s moved once) | plain {plain_ms:.3f} ms | "
                f"F.group_norm {lib_ms:.3f} ms | bound {byte_ms:.4f} ms | plan: "
                f"{plan.slab_groups} groups a slab, clusters of {plan.cluster}, "
                f"{'resident' if plan.resident else 'rows read twice'}, {plan.blocks} blocks, "
                f"{plan.smem_bytes} B shared")
    log(f"[K2] {len(GN_SHAPES) * 2} shapes summed: kernel {entry.d['ms']:.4f} ms, device "
        f"{shown(dev_sum)} | bound {entry.d['bound_ms']:.4f} ms | F.group_norm "
        f"{entry.d['library_ms']:.4f} ms")


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


def hull_frames(n: int, size: int):
    """NDC verts (n, V, 3) and faces of a head with local faces, as a FLAME
    mesh has them: the convex hull of the head-sized sphere template of
    ``make_synthetic_flame`` (its jitter leaves 394 of the 5,023 vertices on
    the hull, so they are pushed back onto the sphere first: 10,042 faces of
    about a pixel at 128²), seen by an orbit of ±60° in front of the head,
    which fills 60% of the frame."""
    import numpy as np
    import torch
    from scipy.spatial import ConvexHull

    from cap4d_torch.flame.io import make_synthetic_flame
    from cap4d_torch.ops.rasterize import ndc_transform_verts
    from cap4d_torch.utils.synthetic_assets import look_at_extrinsics

    radius = 0.09
    v = make_synthetic_flame(n_verts=5023, sphere_radius=radius)["v_template"]
    v = (v / np.linalg.norm(v, axis=1, keepdims=True) * radius).astype(np.float32)
    faces = ConvexHull(v).simplices.astype(np.int32)
    extr = np.stack([look_at_extrinsics(yaw, 1.0) for yaw in np.linspace(-np.pi / 3, np.pi / 3, n)])
    f = 0.6 * size / (2 * radius)
    K = np.tile(np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], np.float32), (n, 1, 1))
    t = lambda a: torch.as_tensor(a, device="cuda")
    verts = ndc_transform_verts(t(np.tile(v[None], (n, 1, 1))), t(K), t(extr), (size, size))
    return verts.contiguous(), t(faces)


def uv_chart(obj_path: Path):
    """The template's UV layout as ``build_uv_assets`` rasterizes it: uv in
    [0, 1] → NDC [-1, 1] with y negated, z = 1; one frame."""
    import numpy as np
    import torch

    from cap4d_torch.ops.rasterize import load_obj

    _, _, uvs, faces_uv = load_obj(obj_path)
    uvs = uvs * 2.0 - 1.0
    uvs[:, 1] = -uvs[:, 1]
    verts = np.concatenate([uvs, np.ones_like(uvs[:, :1])], axis=-1).astype(np.float32)
    return (torch.as_tensor(verts, device="cuda")[None],
            torch.as_tensor(faces_uv.astype(np.int32), device="cuda"))


def raster_sets(work: Path) -> dict:
    """{label: (verts, faces, (H, W))}: the fan set (the conditioning template,
    unchanged since the brute-force kernel), the hull set, both avatars' UV
    layouts at 256² and the edge cases at 120×200, a size no tile divides."""
    import numpy as np
    import torch

    from cap4d_torch.utils import synthetic_assets as sa

    sets = {"fan": (*synthetic_frames(work, 32), (128, 128)),
            "hull": (*hull_frames(32, 128), (128, 128))}
    head_dir = sa.make_asset_dir(work / "head_uv", sphere_radius=0.09)
    sets["head_uv"] = (*uv_chart(head_dir / "cap4d_avatar_template.obj"), (256, 256))
    smpl_dir = sa.make_smpl_asset_dir(work / "smpl_uv")
    sets["smpl_uv"] = (*uv_chart(smpl_dir / "smpl_template.obj"), (256, 256))
    with np.errstate(all="ignore"):
        v, f = sa.raster_edge_set(120, 200)
    sets["edge"] = (torch.as_tensor(v, device="cuda"), torch.as_tensor(f, device="cuda"),
                    (120, 200))
    return sets


def raster_work(setup, size) -> dict:
    """What K3's tile kernel reads and tests, counted from its plain first
    step: group boxes swept (every tile reads its frame's), face boxes read
    (those of the groups whose box overlaps the tile), (tile, face) pairs
    kept, and lane-tests (32 for each 8×4 warp sub-tile a kept box touches,
    before the sub-tile rule rules some out)."""
    import torch

    def cells(b, w, h):
        b = b.long()
        live = (b[..., 1] >= b[..., 0]) & (b[..., 3] >= b[..., 2])
        n = (b[..., 1] // w - b[..., 0] // w + 1) * (b[..., 3] // h - b[..., 2] // h + 1)
        return torch.where(live, n, torch.zeros_like(n))

    B, F = setup.cls.shape
    G = setup.groups.shape[1]
    tiles = B * ((size[0] + 15) // 16) * ((size[1] + 15) // 16)
    in_group = torch.full((G,), 32, device=setup.groups.device)
    in_group[-1] = F - 32 * (G - 1)
    return {"group boxes": tiles * G,
            "face boxes": int((cells(setup.groups, 16, 16) * in_group).sum()),
            "kept": int(cells(setup.boxes, 16, 16).sum()),
            "lane-tests": 32 * int(cells(setup.boxes, 8, 4).sum())}


def bits_equal(a, b):
    """Bitwise equality of two float32 tensors, NaN equal to NaN."""
    import torch

    nan = torch.isnan(a) & torch.isnan(b)
    return (a.view(torch.int32) == b.view(torch.int32)) | nan


def phase_rasterize(entry: Entry, work: Path):
    import torch

    from cap4d_torch.ops.rasterize import (BOX, EMPTY, WHOLE, face_setup_cuda, face_setup_plain,
                                           rasterize_meshes)

    kernel_ptxas(entry.kernel, "K3")
    for label, (verts, faces, size) in raster_sets(work).items():
        out = rasterize_meshes(verts, faces, size)
        ref = rasterize_meshes(verts, faces, size, plain=True)
        torch.cuda.synchronize()
        agree = float((out.pix_to_face == ref.pix_to_face).float().mean())
        same = (out.pix_to_face == ref.pix_to_face) & (ref.pix_to_face >= 0)
        z_err = float((out.zbuf - ref.zbuf)[same].abs().max()) if bool(same.any()) else 0.0
        b_err = (float((out.bary_coords - ref.bary_coords)[same].abs().max())
                 if bool(same.any()) else 0.0)
        covered = float((ref.pix_to_face >= 0).float().mean())
        differ = int((~((out.pix_to_face == ref.pix_to_face) & bits_equal(out.zbuf, ref.zbuf)
                        & bits_equal(out.bary_coords, ref.bary_coords).all(-1))).sum())
        B, V = verts.shape[:2]
        Fn, P = faces.shape[0], size[0] * size[1]
        log(f"[K3 {label}] {B} frames x {size[0]}x{size[1]}, {Fn} faces, {V} verts: pix_to_face "
            f"agreement {agree:.6f} (covered {covered:.3f}) | z max err {z_err:.3g} | bary max "
            f"err {b_err:.3g} | {differ} pixels differ in any bit")
        # rounding is made identical (no FMA contraction), so the tolerance is
        # 1e-4 of the pixels and 1e-5 on z / barycentrics where the faces agree
        assert agree >= 1.0 - 1e-4, f"K3 {label} pix_to_face agreement {agree}"
        assert z_err <= 1e-5 and b_err <= 1e-5, f"K3 {label} z/bary error {z_err} / {b_err}"
        # step 1 alone against its plain version: records, boxes and group boxes
        # bit for bit
        recs, boxes, groups = face_setup_cuda(verts, faces, size)
        plain = face_setup_plain(verts, faces, size)
        torch.cuda.synchronize()
        assert bool(bits_equal(recs, plain.records).all()), f"K3 {label}: records differ"
        assert torch.equal(boxes, plain.boxes), f"K3 {label}: boxes differ"
        assert torch.equal(groups, plain.groups), f"K3 {label}: group boxes differ"
        classes = {name: int((plain.cls == c).sum()) for name, c in
                   (("box", BOX), ("empty", EMPTY), ("whole", WHOLE))}
        log(f"[K3 {label}] step 1 (records, boxes, group boxes) equals face_setup_plain bit "
            f"for bit; faces by class {classes}")
        if label == "edge":
            entry.add(max(z_err, b_err), 0.0, 0.0, 0.0, 0.0)
            continue
        call = lambda: rasterize_meshes(verts, faces, size)
        ms = time_ms(call, iters=100, warmup=5)   # at 256² the host's ~30 µs a call sets it
        setup_ms = device_ms(call, ("raster_setup",))
        tile_ms = device_ms(call, ("raster_tile",))
        plain_ms = time_ms(lambda: rasterize_meshes(verts, faces, size, plain=True),
                           iters=3, warmup=1)
        tests = box_pixel_tests(verts, faces, size)
        sweep = raster_work(plain, size)
        flops = 18.0 * tests               # 3 edge functions + 3 scalings per pixel-face test
        nbytes = B * V * 12 + Fn * 12 + B * P * 20
        flop_ms, byte_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        entry.add(max(z_err, b_err), ms, plain_ms, flop_ms, byte_ms)
        log(f"[K3 {label}] kernel {ms:.4f} ms (device: setup {shown(setup_ms)}, tiles "
            f"{shown(tile_ms)}) | plain {plain_ms:.3f} ms | bound {max(flop_ms, byte_ms):.4f} ms "
            f"({flop_ms:.4f} ms ops, {byte_ms:.4f} ms bytes) | {tests} box tests | swept: "
            + ", ".join(f"{v} {k}" for k, v in sweep.items())
            + f" (brute force: {B * P * Fn} tests)")
    log(f"[K3] four sets summed: kernel {entry.d['ms']:.4f} ms | plain {entry.d['plain_ms']:.3f} "
        f"ms | bound {entry.d['bound_ms']:.4f} ms")


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
                "K2 group norm": ("gn_silu",),
                "K3 rasterize": ("raster_setup", "raster_tile"), "K4 gsplat_fwd": ("gsplat_fwd",),
                "K5 gsplat_bwd": ("gsplat_bwd",), "conv": ("conv", "cudnn", "implicit"),
                "gemm": ("gemm", "cutlass", "sm90_xmma", "nvjet"),
                "sort/scan": ("sort", "radix", "scan"),
                "AdamW (foreach)": ("multi_tensor_apply",),
                "index/scatter": ("index", "scatter", "gather")}
    totals = dict.fromkeys(list(families) + ["other"], 0.0)
    n_kernels = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue   # CPU-side ops: their kernels are counted as CUDA events
        n_kernels += evt.count
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
        + f"; busy {busy:.2f} ms of {wall_ms:.2f} ms wall ({100 * busy / wall_ms:.0f}% busy); "
        f"{n_kernels} device kernels")


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


def stage1_assets(work: Path) -> SimpleNamespace:
    """The debug generation config at the shipped width on synthetic assets
    (written once under ``work/main``)."""
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.config import dump_yaml, load_yaml

    gen_cfg = load_yaml(REPO / "configs" / "generation" / "debug.yaml")
    n_samples = gen_cfg["generation_data"]["n_samples"]
    root = work / "main"
    cfg = root / "gen_config.yaml"
    a = SimpleNamespace(root=root, cfg=cfg, n_samples=n_samples, ref_dir=root / "subject",
                        flame_dir=root / "assets" / "flame")
    if cfg.exists():
        return a
    a.flame_dir = sa.make_asset_dir(root)
    a.ref_dir = sa.make_reference_dir(root, resolution=gen_cfg["resolution"])
    bank = sa.make_gen_bank(root, n=n_samples)
    ckpt_dir = sa.write_model_config(root, shipped_model_section())
    dump_yaml(dict(gen_cfg, ckpt_path=str(ckpt_dir),
                   generation_data=dict(gen_cfg["generation_data"], data_path=str(bank))), cfg)
    return a


def signal_init_(module, seed: int) -> None:
    """Fan-in-scaled weights, norm scales 1 ± 0.1 and small biases, from
    ``seed``: every layer carries signal (the random-weights mode zeroes
    every norm scale, which leaves the UNet's output almost constant)."""
    import torch

    gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
    norms = {id(m.weight) for m in module.modules()
             if "Norm" in type(m).__name__ and getattr(m, "weight", None) is not None}
    with torch.no_grad():
        for p in module.parameters():
            if id(p) in norms:
                p.normal_(1.0, 0.1, generator=gen)
            elif p.ndim == 1:
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)


def generation_run(a: SimpleNamespace, out: Path, kernels, card: str, label: str,
                   groups_per_device: int = 1, init_noise=None, cfg=None) -> dict:
    """One counted ``run_generation``: every launch count set to 0 just
    before it and read just after; its wall, s per group-step, peak memory."""
    import numpy as np
    import torch

    from cap4d_torch.inference.generate_images import run_generation
    from cap4d_torch.mmdm.sampler import parallel_groups

    from cap4d_torch.mmdm.sampler import StochasticIOSampler

    sample, sampler_peak = StochasticIOSampler.sample, []

    def measured(self, *args, **kw):   # the sampler's own peak, apart from encode/decode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        z = sample(self, *args, **kw)
        torch.cuda.synchronize()
        sampler_peak.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        return z

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    StochasticIOSampler.sample = measured
    t0 = time.perf_counter()
    try:
        res = run_generation(cfg or a.cfg, a.ref_dir, out, allow_random_weights=True,
                             flame_asset_dir=a.flame_dir, dtype=torch.bfloat16,
                             init_noise=init_noise, groups_per_device=groups_per_device)
    finally:
        StochasticIOSampler.sample = sample
    wall = time.perf_counter() - t0
    peak = max(torch.cuda.max_memory_allocated() / 2 ** 30, sampler_peak[0])
    launches = {k.name: k.launches for k in kernels}
    n = res["z_gen"].shape[0]
    n_groups = n // 7                                   # one reference: G = 7
    n_calls = res["group_steps"] // parallel_groups(n_groups, groups_per_device)
    res.update(launches=launches, peak_gib=peak, sampler_peak_gib=sampler_peak[0],
               s_per_group_step=res["sampler_s"] / res["group_steps"])
    log(f"[{label}] groups_per_device {groups_per_device}: run_generation wall {wall:.1f} s | "
        f"sampler {res['sampler_s']:.2f} s, {res['s_per_group_step']:.4f} s per group-step "
        f"({res['group_steps']} group-steps in {n_calls} UNet calls of batch "
        f"{2 * res['group_steps'] // n_calls}) | decode+save {res['decode_s']:.2f} s | peak "
        f"allocated {peak:.2f} GiB, while sampling {sampler_peak[0]:.2f} GiB | on {card}")
    log(f"[{label}] launches {launches}")
    for sub, n_img in (("reference_images", 1), ("generated_images", n)):
        assert len(list((out / sub / "images").glob("*.png"))) == n_img, sub
        assert len(list((out / sub / "flame").glob("*.npz"))) == n_img, sub
        assert list((out / sub / "condition_vis").rglob("*.jpg")), sub
    assert res["z_gen"].shape == (n, 64, 64, 4), res["z_gen"].shape
    assert np.isfinite(res["z_gen"]).all(), "non-finite latents"
    assert res["images"].shape == (n, 512, 512, 3)
    assert launches["flash_attention"] == 16 * n_calls, launches
    assert launches["group_norm"] == 61 * n_calls, launches
    assert launches["rasterize"] > 0, launches
    return res


class recorded_shapes:
    """Records the shapes K1 and K2 are launched at inside the block."""

    def __enter__(self):
        from cap4d_torch.ops import flash_attention as fa
        from cap4d_torch.ops import norms

        self.k1, self.k2 = set(), set()
        self.saved = fa.flash_attention_fwd_cuda, norms._group_norm_silu_cuda
        f0, g0 = self.saved

        def k1(q, k, v, with_lse=False):
            self.k1.add(tuple(q.shape))
            return f0(q, k, v, with_lse)

        def k2(x, scale, bias, num_groups, eps, apply_silu):
            self.k2.add((tuple(x.shape), x.dtype, num_groups, float(eps), bool(apply_silu)))
            return g0(x, scale, bias, num_groups, eps, apply_silu)

        fa.flash_attention_fwd_cuda, norms._group_norm_silu_cuda = k1, k2
        return self

    def __exit__(self, *exc):
        from cap4d_torch.ops import flash_attention as fa
        from cap4d_torch.ops import norms

        fa.flash_attention_fwd_cuda, norms._group_norm_silu_cuda = self.saved


def batched_kernels_vs_plain(shapes: recorded_shapes) -> None:
    """K1 and K2 against their plain versions at the shapes the batched
    stage 1 launched them at (tolerances as in the K1 and K2 phases)."""
    import torch

    from cap4d_torch.ops.flash_attention import flash_attention
    from cap4d_torch.ops.norms import group_norm_silu, plan_group_norm

    gen = torch.Generator(device="cuda").manual_seed(5)
    k1_ms = k1_plain = 0.0
    for B, S, H, d in sorted(shapes.k1):
        q, k, v = (torch.randn((B, S, H, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        out, ref = flash_attention(q, k, v), flash_attention(q, k, v, plain=True)
        check_close(f"batched K1 B={B} S={S} H={H}", out, ref, 2e-2,
                    2e-2 * float(ref.float().abs().max()))
        ms = time_ms(lambda: flash_attention(q, k, v))
        plain_ms = time_ms(lambda: flash_attention(q, k, v, plain=True), iters=3, warmup=1)
        k1_ms, k1_plain = k1_ms + ms, k1_plain + plain_ms
        log(f"[batched K1] B={B} S={S} H={H}: kernel {ms:.4f} ms "
            f"({4.0 * S * S * d * B * H / ms / 1e9:.1f} TFLOP/s) | plain {plain_ms:.3f} ms")
    k2_ms = k2_plain = 0.0
    for shape, dtype, groups, eps, silu in sorted(shapes.k2, key=str):
        C = shape[-1]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
        scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
        bias = 0.1 * torch.randn(C, generator=gen, device="cuda")
        plan = plan_group_norm(shape, dtype, groups)
        out = group_norm_silu(x, scale, bias, groups, eps, silu)
        ref = group_norm_silu(x, scale, bias, groups, eps, silu, plain=True)
        check_close(f"batched K2 {shape} silu={silu}", out, ref, 1e-2, 1e-3)
        ms = time_ms(lambda: group_norm_silu(x, scale, bias, groups, eps, silu))
        plain_ms = time_ms(lambda: group_norm_silu(x, scale, bias, groups, eps, silu, plain=True))
        k2_ms, k2_plain = k2_ms + ms, k2_plain + plain_ms
        log(f"[batched K2] {shape} {dtype} silu={silu} eps={eps}: kernel {ms:.4f} ms | plain "
            f"{plain_ms:.3f} ms | plan: {plan.slab_groups} groups a slab, clusters of "
            f"{plan.cluster}, {'resident' if plan.resident else 'rows read twice'}, "
            f"{plan.blocks} blocks")
        # stage 1's slabs all fit a cluster's shared memory at batch 8 too
        assert plan.resident, (shape, plan)
    log(f"[batched] K1 {len(shapes.k1)} shapes {k1_ms:.4f} ms (plain {k1_plain:.2f}) | K2 "
        f"{len(shapes.k2)} shapes {k2_ms:.4f} ms (plain {k2_plain:.2f})")


# z_gen of groups_per_device 4 against 1 (bf16, random signal weights, the same
# initial latents): batched cuBLAS/cuDNN calls round differently
BATCHED_REL_TOL = 0.015   # measured 0.0091 on the H100 (PERF.md §6)


def phase_main_path(work: Path, kernels, card: str):
    """Stage 1 through ``run_generation``: the debug config with random
    weights as before, then the batched view-groups (groups_per_device 1, 2
    and 4 on signal weights and the same initial latents, and 8 at 56
    samples for memory). Returns every run's launches and stage 1's output."""
    import numpy as np
    import torch

    import cap4d_torch.mmdm.model as mmdm_model
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.config import dump_yaml, load_yaml

    a = stage1_assets(work)
    out = a.root / "output"
    first = generation_run(a, out, kernels, card, "main")
    runs = [first["launches"]]

    gen = torch.Generator(device="cuda").manual_seed(124)
    noise = {"encode": torch.randn((1, 64, 64, 4), generator=gen, device="cuda").cpu().numpy(),
             "x_bank": torch.randn((a.n_samples, 64, 64, 4), generator=gen,
                                   device="cuda").cpu().numpy()}
    saved_init = mmdm_model.init_random_
    mmdm_model.init_random_ = signal_init_
    try:
        batched = {}
        for gpd in (1, 2, 4):
            if gpd == 4:
                with recorded_shapes() as shapes:
                    batched[gpd] = generation_run(a, a.root / f"batched_{gpd}", kernels, card,
                                                  "batched", gpd, noise)
            else:
                batched[gpd] = generation_run(a, a.root / f"batched_{gpd}", kernels, card,
                                              "batched", gpd, noise)
            runs.append(batched[gpd]["launches"])
        # eight groups in one call: 56 samples, 2 DDIM steps
        cfg8 = a.root / "gen_config_56.yaml"
        c = load_yaml(a.cfg)
        (a.root / "bank_56").mkdir(exist_ok=True)
        bank = sa.make_gen_bank(a.root / "bank_56", n=56)
        dump_yaml(dict(c, n_ddim_steps=2, generation_data=dict(
            c["generation_data"], n_samples=56, data_path=str(bank))), cfg8)
        big = generation_run(a, a.root / "batched_8", kernels, card, "batched", 8, cfg=cfg8)
        runs.append(big["launches"])
    finally:
        mmdm_model.init_random_ = saved_init
    z1, z4 = batched[1]["z_gen"], batched[4]["z_gen"]
    gap = float(np.abs(z4 - z1).max())
    rel = float(np.linalg.norm(z4 - z1) / np.linalg.norm(z1))
    log(f"[batched] z_gen groups_per_device 4 vs 1: max |diff| {gap:.4g} (max |z| "
        f"{float(np.abs(z1).max()):.4g}), relative norm gap {rel:.4g} (tolerance "
        f"{BATCHED_REL_TOL}) | s per group-step: " + ", ".join(
            f"{g} -> {r['s_per_group_step']:.4f}" for g, r in sorted(batched.items()))
        + f", 8 -> {big['s_per_group_step']:.4f} | peak GiB while sampling: " + ", ".join(
            f"{g} -> {r['sampler_peak_gib']:.2f}" for g, r in sorted(batched.items()))
        + f", 8 -> {big['sampler_peak_gib']:.2f} | on {card}")
    assert rel <= BATCHED_REL_TOL, f"batched z_gen relative gap {rel} > {BATCHED_REL_TOL}"
    batched_kernels_vs_plain(shapes)
    torch.cuda.empty_cache()
    return runs, out


# ------------------------------------------- the native runtime (loader) ----

def runtime_probe() -> None:
    """What the machine offers the image codecs and video input."""
    headers = {h: Path("/usr/include", h).exists() for h in ("png.h", "jpeglib.h", "zlib.h")}
    out = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=60).stdout
    libs = sorted({line.split()[0] for line in out.splitlines()
                   if re.search(r"libpng|libjpeg|libturbojpeg", line)})
    log(f"[loader] probe: headers {headers} | libpng/libjpeg in ldconfig: {libs or 'none'} | "
        f"g++ {shutil.which('g++')} | ffmpeg {shutil.which('ffmpeg')}")


def test_image(h: int, w: int, seed: int):
    """A smooth RGB uint8 image with mild noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([128 + 100 * np.sin(6 * x + seed), 128 + 100 * np.cos(5 * y),
                    128 + 90 * np.sin(4 * (x + y))], -1)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


def phase_loader(work: Path, card: str):
    """The native runtime on the card's machine: probe, build, PNG and JPEG
    round trips, the prefetch pool against the serial Python path, and a
    --detect_anomaly generation whose UNet returns NaN at DDIM step 2."""
    import numpy as np
    import torch

    from cap4d_torch.data.utils import crop_image, load_frame, rescale_image
    from cap4d_torch.inference.generate_images import run_generation
    from cap4d_torch.mmdm.unet import MMDMUNet
    from cap4d_torch.runtime import loader
    from cap4d_torch.utils.png import read_png, write_png

    runtime_probe()
    # a fresh build, timed (stage 1 built the library at its first use)
    build_dir = loader.BUILD_DIR
    loader.BUILD_DIR = work / "runtime_build"
    try:
        t0 = time.perf_counter()
        so = loader.build()
        build_s = time.perf_counter() - t0
    finally:
        loader.BUILD_DIR = build_dir
    loader.lib()
    log(f"[loader] g++ built {so.name} in {build_s:.1f} s")

    d = work / "loader"
    d.mkdir(parents=True, exist_ok=True)
    img = test_image(1024, 768, 0)
    write_png(d / "a.png", img)
    loader.encode_jpeg(d / "a.jpg", img)
    png = loader.decode_image(d / "a.png")
    assert np.array_equal(png, read_png(d / "a.png")), "PNG decode differs from read_png"
    jpg = loader.decode_image(d / "a.jpg")
    jerr = float(np.abs(jpg.astype(int) - img.astype(int)).mean())
    log(f"[loader] PNG decode equals read_png bit for bit; JPEG (quality 95, 4:2:0) round trip "
        f"mean |diff| {jerr:.3f} of 255 ({(d / 'a.jpg').stat().st_size} bytes)")
    # the image's noise (std 4) sets most of the round trip's error
    assert jpg.shape == img.shape and jerr < 4.0, jerr

    # 64 reference-sized frames (1024 x 768, half PNG, half JPEG) to 512²
    frames = d / "frames"
    frames.mkdir(exist_ok=True)
    paths = []
    for i in range(64):
        path = frames / f"{i:05d}.{'png' if i % 2 else 'jpg'}"
        im = test_image(1024, 768, i)
        if i % 2:
            write_png(path, im)
        else:
            loader.encode_jpeg(path, im)
        paths.append(path)
    box = [-64, 128, 704, 896]    # a square crop 64 px outside the left edge
    t0 = time.perf_counter()
    native = loader.load_frames(paths, [box] * 64, 512, n_threads=8)
    native_s = time.perf_counter() - t0
    # the Python path (numpy INTER_AREA) takes seconds a frame: time 8 of them
    n_serial = 8
    t0 = time.perf_counter()
    serial = np.stack([(rescale_image(crop_image(load_frame(frames, i), np.array(box), 255), 512)
                        / 127.5 - 1.0).astype(np.float32) for i in range(n_serial)])
    serial_s = (time.perf_counter() - t0) / n_serial
    diff = float(np.abs(native[:n_serial] - serial).mean())
    log(f"[loader] 64 frames 1024x768 -> 512²: pool of 8 threads {native_s:.3f} s "
        f"({1e3 * native_s / 64:.1f} ms a frame); serial Python path {1e3 * serial_s:.1f} ms a "
        f"frame over {n_serial} ({64 * serial_s / native_s:.1f}x the pool) | mean |pool - "
        f"python| {diff:.4f} (the pool's box filter against INTER_AREA)")
    assert np.isfinite(native).all() and diff < 0.05, diff

    # --detect_anomaly: the UNet returns NaN from its ninth call (step 2, round 0)
    a = stage1_assets(work)
    forward = MMDMUNet.forward
    calls = []

    def poisoned(self, x, t, cond):
        out = forward(self, x, t, cond)
        calls.append(1)
        return out * float("nan") if len(calls) == 9 else out

    MMDMUNet.forward = poisoned
    try:
        run_generation(a.cfg, a.ref_dir, a.root / "anomaly", allow_random_weights=True,
                       flame_asset_dir=a.flame_dir, dtype=torch.bfloat16, detect_anomaly=True)
    except FloatingPointError as e:
        log(f"[loader] detect_anomaly: FloatingPointError after {len(calls)} UNet calls: {e}")
        assert "step 2, round 0" in str(e) and len(calls) == 9, (str(e), len(calls))
    else:
        raise AssertionError("detect_anomaly did not raise on a NaN eps")
    finally:
        MMDMUNet.forward = forward


# ------------------------------------ the held-out quality of the head fit ----

def phase_quality(work: Path, kernels, card: str):
    """``fit_holdout_quality`` on the card, cut to 300 iterations: a fit on
    27 orbit views that all see the head, held-out PSNR/SSIM/L1 on 3."""
    from cap4d_torch.tools import fit_holdout_quality

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    res = fit_holdout_quality.run(iterations=300, out=work / "holdout")
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    log(f"[quality] fit_holdout_quality 300 iterations: held-out {res['holdout']} (per view "
        f"{res['holdout_per_view']}) | {res['s_per_iteration']:.4f} s per fit iteration | fit "
        f"{res['fit_seconds']} s, wall {wall:.1f} s | gaussians {res['n_gaussians']} | on {card}")
    log(f"[quality] launches {launches}")
    assert all(math.isfinite(v) for v in res["holdout"].values()), res["holdout"]
    # the plain-compositor oracle launches no K4; 300 iterations, then the
    # evaluation, held-out and driving renders
    assert launches["gsplat_bwd"] == 300 and launches["gsplat_fwd"] >= 300 + 3 + 4, launches
    assert launches["rasterize"] > 0, launches
    return launches


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


def render_vs_plain(case: str, leaves, rt, K, width: int, height: int, sh_degree: int,
                    target):
    """``rasterize_gaussians`` through K4/K5 against ``plain=True`` on the
    leaves (means3d, quats, scales, opacities, sh, means2d_offset): the
    render, alpha and depth, and the gradients of a fixed loss. Returns (max
    forward error, max gradient error)."""
    import torch

    from cap4d_torch.ops import gsplat_tiles as gt

    names = ["means3d", "quats", "scales", "opacities", "sh", "means2d_offset"]
    res = {}
    for plain in (False, True):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        out = gt.rasterize_gaussians(xs[0], xs[1], xs[2], xs[3], xs[4], rt, K, width, height,
                                     sh_degree=sh_degree, render_depth=True,
                                     means2d_offset=xs[5], plain=plain)
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
    err = max(check_close(f"K4 {case} render", ok_["render"], op_["render"], 0.0, 2e-4),
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
    gerr = 0.0
    for name, a, b in zip(names, gk, gp):
        scale = max(float(b.abs().max()), 1e-3 * top)
        check_close(f"K5 {case} d{name}", a, b, 0.0, 1e-3 * scale)
        gerr = max(gerr, float((a - b).abs().max()))
    log(f"[K4/K5] {case}: {ok_['n_pairs']} pairs, loss kernel {lk:.7f} plain {lp:.7f}")
    return err, gerr


def gsplat_kernels_vs_plain(trainer, cam, sh_degree: int, label: str):
    """K4/K5 against the plain compositor on ``trainer``'s avatar seen from
    ``cam`` (:func:`render_vs_plain`), for the avatar's own opacities and
    for opacities U[0.05, 1). Returns (max forward error, max gradient error,
    the world splats, the second case's opacities, the generator)."""
    import torch

    from cap4d_torch.avatar import gaussians as G

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
        e, g = render_vs_plain(case, leaves, ct["rt"], ct["K"], cam.width, cam.height,
                               sh_degree, target)
        err, gerr = max(err, e), max(gerr, g)
    return err, gerr, world, opac, gen


def split_vs_plain(label: str, packed, pg, bd, tiles_x: int, gen):
    """K4's out, n_done and state and K5's dpacked against the plain versions
    at the kernels' interfaces (``composite_fwd_plain``,
    ``composite_bwd_plain``, K5 on K4's own outputs), within the render's
    tolerances. Returns (forward error, gradient error, out, n_done, state,
    the cotangent)."""
    import torch

    from cap4d_torch.ops import gsplat_tiles as gt
    from cap4d_torch.ops.gsplat import LN_T_STOP

    out, n_done, state = gt.composite_fwd_cuda(packed, pg, bd, tiles_x)
    out_p, n_done_p, state_p = gt.composite_fwd_plain(packed, pg, bd, tiles_x)
    torch.cuda.synchronize()
    rows, tile, batch = gt.work_items(bd)
    # a tile may run one batch more or less than the plain version only where
    # its deciding pixel's ln T lies at ln 1e-4, within fp32 sums in another order
    differ = torch.nonzero(n_done != n_done_p)[:, 0].tolist()
    for t in differ:
        j = min(int(n_done[t]), int(n_done_p[t]))
        ran = state if int(n_done[t]) > j else state_p
        edge = float(ran[int(rows[t]) + j, 0].max())
        assert abs(edge - LN_T_STOP) < 1e-4, (label, t, int(n_done[t]), int(n_done_p[t]), edge)
    same = n_done == n_done_p
    log(f"[K4 {label}] n_done: {len(differ)} of {same.shape[0]} tiles differ from the plain "
        f"version (each at the stop threshold)")
    # the render's tolerances (render_vs_plain): 2e-4 absolute on Σw·rgb, Σw
    # and T = exp(ln T), 2e-4 of the largest depth on Σw·depth
    dmax = float(packed[pg.long(), 9].abs().max()) if pg.numel() else 1.0
    tol = [2e-4] * 4 + [2e-4 * dmax]
    o, op_ = out[same], out_p[same]
    err = max(check_close(f"K4 {label} out[{c}]", o[..., c], op_[..., c], 0.0, tol[c])
              for c in range(5))
    err = max(err, check_close(f"K4 {label} exp(out ln T)", o[..., 5].exp(), op_[..., 5].exp(),
                               0.0, 2e-4))
    ran_item = (batch < n_done.long()[tile]) & same[tile]
    r = (rows[:-1][tile] + batch)[ran_item]
    s, sp = state[r], state_p[r]
    err = max(err, check_close(f"K4 {label} state exp(ln T before)", s[:, 0].exp(),
                               sp[:, 0].exp(), 0.0, 2e-4))
    for c in range(5):
        err = max(err, check_close(f"K4 {label} state prefix[{c}]", s[:, 1 + c], sp[:, 1 + c],
                                   0.0, tol[c]))
    go = torch.randn(out.shape, generator=gen, device="cuda")
    dk = gt.composite_bwd_cuda(packed, pg, bd, out, n_done, state, go, tiles_x)
    dp = gt.composite_bwd_plain(packed, pg, bd, out, n_done, state, go, tiles_x)
    torch.cuda.synchronize()
    # atomics in run-dependent order: 1e-3 of each column's largest gradient,
    # floored at 1e-3 of the largest of all
    top = float(dp.abs().max())
    gerr = 0.0
    for c in range(dp.shape[1]):
        scale = max(float(dp[:, c].abs().max()), 1e-3 * top)
        gerr = max(gerr, check_close(f"K5 {label} dpacked[:, {c}]", dk[:, c], dp[:, c], 0.0,
                                     1e-3 * scale))
    return err, gerr, out, n_done, state, go


def time_split(label: str, packed, pg, bd, tiles_x: int, out, n_done, state, go):
    """K4 and K5 alone: ms by CUDA events and on the device (torch.profiler),
    and the work items. Returns (K4 ms, K5 ms, K4 device ms, K5 device ms,
    items that ran)."""
    from cap4d_torch.ops import gsplat_tiles as gt
    from cap4d_torch.ops.gsplat import BATCH

    def fwd():
        gt.composite_fwd_cuda(packed, pg, bd, tiles_x)

    def bwd():
        gt.composite_bwd_cuda(packed, pg, bd, out, n_done, state, go, tiles_x)

    ms_f, ms_b = time_ms(fwd, iters=20), time_ms(bwd, iters=20)
    dev_f, dev_b = device_ms(fwd, ("gsplat_fwd",)), device_ms(bwd, ("gsplat_bwd",))
    items = (bd[1:] - bd[:-1] + BATCH - 1) // BATCH
    n_items, ran = int(items.sum()), int(n_done.sum())
    log(f"[K4/K5 {label}] {pg.shape[0]} pairs, {bd.shape[0] - 1} tiles | {n_items} items, "
        f"{ran} run, {n_items - ran} discarded after their tile's stop, at most "
        f"{int(items.max())} in a tile | K4 {ms_f:.4f} ms (device {shown(dev_f, '')}) | K5 "
        f"{ms_b:.4f} ms (device {shown(dev_b, '')})")
    return ms_f, ms_b, dev_f, dev_b, ran


def view_inputs(world, opac, cols, ct, width: int, height: int):
    """The compositor's inputs for one view of the splats ``world`` with
    opacities ``opac`` and colours ``cols`` (N, 3): packed rows, pairs,
    bounds and tiles_x."""
    import torch

    from cap4d_torch.ops import gsplat_tiles as gt

    ch = gt.project_gaussians_ch(world["means3d"], world["quats"], world["scales"],
                                 ct["rt"], ct["K"], width, height)
    packed = torch.stack([ch["mean_x"], ch["mean_y"], ch["conic_a"], ch["conic_b"],
                          ch["conic_c"], opac, cols[:, 0], cols[:, 1], cols[:, 2],
                          ch["depth"]], dim=-1).contiguous()
    pg, bd = gt.tile_pairs(ch["mean_x"], ch["mean_y"], ch["conic_a"], ch["conic_b"],
                           ch["conic_c"], opac, ch["radius"], ch["valid"], ch["depth"],
                           width, height)
    return packed, pg, bd, (width + 15) // 16


def gsplat_bounds(packed, pg, bd, n_done, tiles_x):
    """K4's and K5's bounds on this view, as (ms by operations, ms by bytes)
    each: operations per pair-pixel of the batches that ran, forward 11 for
    every evaluation (dx, dy, σ, e^-σ, compares) + 13 for a kept one (α, w,
    5 accumulations, T), backward the same 11 + 45 for a kept one (q, the
    suffix, dL/dα, ten gradients and their sums); bytes each input read once
    and each output (K4's state rows included) written once."""
    from cap4d_torch.ops.gsplat import BATCH

    evals, kept = pair_pixel_counts(packed, pg, bd, n_done, tiles_x)
    N, M, n_tiles = packed.shape[0], pg.shape[0], n_done.shape[0]
    n_items = int(((bd[1:] - bd[:-1] + BATCH - 1) // BATCH).sum())
    ran = int(n_done.sum())
    f_bytes = (N * 40 + M * 4 + (n_tiles + 1) * 4 + n_tiles * 256 * 24 + n_tiles * 4
               + n_items * 256 * 24)
    b_bytes = (N * 40 + M * 4 + (n_tiles + 1) * 4 + 2 * n_tiles * 256 * 24 + n_tiles * 4
               + ran * 256 * 24 + N * 40)
    f = ((11.0 * evals + 13.0 * kept) / FP32_FLOPS * 1e3, f_bytes / HBM_BYTES_PER_S * 1e3)
    b = ((11.0 * evals + 45.0 * kept) / FP32_FLOPS * 1e3, b_bytes / HBM_BYTES_PER_S * 1e3)
    return f, b, evals, kept


def check_and_time_view(label: str, packed, pg, bd, tiles_x: int, gen):
    """:func:`split_vs_plain` and :func:`time_split` on one view, with the
    bounds; returns a dict of the numbers."""
    err, gerr, out, n_done, state, go = split_vs_plain(label, packed, pg, bd, tiles_x, gen)
    ms_f, ms_b, dev_f, dev_b, ran = time_split(label, packed, pg, bd, tiles_x, out, n_done,
                                               state, go)
    f, b, evals, kept = gsplat_bounds(packed, pg, bd, n_done, tiles_x)
    log(f"[K4/K5 {label}] {evals} pair-pixel evaluations ({kept} kept) | bound K4 "
        f"{max(f):.4f} ms ({f[0]:.4f} ops, {f[1]:.4f} bytes), K5 {max(b):.4f} ms ({b[0]:.4f} "
        f"ops, {b[1]:.4f} bytes)")
    return dict(err=err, gerr=gerr, ms_f=ms_f, ms_b=ms_b, dev_f=dev_f, dev_b=dev_b, f=f, b=b,
                out=out, n_done=n_done, state=state, go=go)


def gsplat_ptxas():
    """ptxas's registers and spills of every K4/K5 function."""
    from cap4d_torch.ops import gsplat_tiles as gt

    for kernel in (gt.KERNEL_FWD, gt.KERNEL_BWD):
        for fn, (regs, st, ld) in ptxas_report(kernel).items():
            log(f"[ptxas] {kernel.source.name} {fn}: {regs} registers, {st} bytes spill "
                f"stores, {ld} bytes spill loads")


def reference_stage1(work: Path) -> Path:
    """Stage 1's reference_images (FLAME npz and images) for phase 6's
    synthetic subject and reference camera, without the MMDM: what the
    gsplat phase needs when it runs without the generate phase."""
    import numpy as np
    import torch

    from cap4d_torch.data.datasets import build_frame_set, load_reference_items
    from cap4d_torch.flame.compute import load_cap4d_flame_model
    from cap4d_torch.inference.generate_images import save_flame_params, save_images
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.config import load_yaml

    res = load_yaml(REPO / "configs" / "generation" / "debug.yaml")["resolution"]
    root = work / "main"
    flame_dir = sa.make_asset_dir(root)
    flame = load_cap4d_flame_model(flame_dir, n_shape_params=150, n_expr_params=65,
                                   add_mouth=True, device=torch.device("cuda"))
    items, extr = load_reference_items(sa.make_reference_dir(root, resolution=res))
    head_ids = np.genfromtxt(flame_dir / "head_vertices.txt").astype(int)
    ref = build_frame_set(flame, items, head_ids, extr, res, is_reference=True)
    out = root / "output"
    save_flame_params(ref.flame_items, out / "reference_images")
    save_images(((ref.images + 1.0) * 127.5).clip(0, 255).astype(np.uint8),
                out / "reference_images")
    return out


def deep_tile_leaves(n: int, gen):
    """One 16×16 tile holding ``n`` near-transparent splats (opacity
    U[0.0045, 0.008), 2-D σ of 1.5-4 px, depths 2-4) in front of a camera of
    focal 40 px: every pair is kept at few pixels, so no pixel's T falls
    below 1e-4 and no batch is skipped. Returns (leaves, viewmat, K)."""
    import torch

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device="cuda")

    f = 40.0
    z = u(2.0, 4.0, n)
    means = torch.stack([(u(0.0, 16.0, n) - 8.0) * z / f, (u(0.0, 16.0, n) - 8.0) * z / f, z], -1)
    quats = torch.nn.functional.normalize(torch.randn((n, 4), generator=gen, device="cuda"), dim=-1)
    scales = (u(1.5, 4.0, n) * z / f)[:, None].expand(n, 3).contiguous()
    sh = u(-0.5, 0.5, n, 1, 3)
    leaves = [means, quats, scales, u(0.0045, 0.008, n), sh, torch.zeros((n, 2), device="cuda")]
    viewmat = torch.eye(4, device="cuda")
    K = torch.tensor([[f, 0.0, 8.0], [0.0, f, 8.0], [0.0, 0.0, 1.0]], device="cuda")
    return leaves, viewmat, K


def phase_deep_tile(gen):
    """K4/K5 on a single deep tile of ~1,200 and ~12,000 pairs: the render
    and gradients against ``plain=True``, the kernels against their plain
    versions, and the time of the deep tile against the shallow one."""
    import torch

    from cap4d_torch.ops import gsplat_tiles as gt
    from cap4d_torch.ops.gsplat import BATCH

    numbers = {}
    for n in (1200, 12000):
        leaves, viewmat, K = deep_tile_leaves(n, gen)
        target = torch.rand((16, 16, 3), generator=gen, device="cuda")
        render_vs_plain(f"deep tile {n}", leaves, viewmat, K, 16, 16, 0, target)
        with torch.no_grad():
            ct = {"rt": viewmat, "K": K}
            cols = torch.rand((n, 3), generator=gen, device="cuda")
            packed, pg, bd, tiles_x = view_inputs(
                {"means3d": leaves[0], "quats": leaves[1], "scales": leaves[2]}, leaves[3],
                cols, ct, 16, 16)
            num = check_and_time_view(f"deep tile {n}", packed, pg, bd, tiles_x, gen)
        n_items = int((bd[-1] + BATCH - 1) // BATCH)
        assert int(num["n_done"][0]) == n_items, ("the deep tile stopped early", n_items,
                                                  int(num["n_done"][0]))
        numbers[n] = num
    a, b = numbers[1200], numbers[12000]
    log(f"[K4/K5 deep tile] 12,000 pairs against 1,200: K4 {b['ms_f'] / a['ms_f']:.2f}x "
        f"(device {ratio(b['dev_f'], a['dev_f'])}), K5 {b['ms_b'] / a['ms_b']:.2f}x (device "
        f"{ratio(b['dev_b'], a['dev_b'])}); the target is within 3x")


def phase_gsplat(e_fwd: Entry, e_bwd: Entry, work: Path, stage1_out):
    """K4/K5 against the plain compositor on a freshly initialised avatar at
    the head's reference view (stage 1's, or phase 6's reference camera
    alone where the generate phase did not run), then on single deep tiles.
    Returns the FLAME asset dir and the stage-1 output dir."""
    import torch

    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_torch.avatar.trainer import AvatarTrainer
    from cap4d_torch.ops import gsplat_tiles as gt
    from cap4d_torch.utils import synthetic_assets as sa

    gsplat_ptxas()
    if stage1_out is None:
        stage1_out = reference_stage1(work)
    model, opt = avatar_params()
    flame_dir = sa.make_asset_dir(work / "avatar_assets", sphere_radius=0.09)
    sources = [stage1_out / d for d in ("reference_images", "generated_images")]
    scene = load_cap4d_dataset([str(d) for d in sources if d.exists()])
    trainer = AvatarTrainer.create(scene, model, opt, flame_asset_dir=flame_dir)
    cam = scene.train_cameras[0]
    ct = trainer.camera_tensors(cam)
    err, gerr, world, opac, gen = gsplat_kernels_vs_plain(trainer, cam, model["sh_degree"],
                                                          "head")

    # the kernels alone at these shapes (the second case's opacities)
    with torch.no_grad():
        cols = torch.rand((trainer.n_active, 3), generator=gen, device="cuda")
        packed, pg, bd, tiles_x = view_inputs(world, opac, cols, ct, cam.width, cam.height)
        num = check_and_time_view("head", packed, pg, bd, tiles_x, gen)
        plain_f = time_ms(lambda: gt.rasterize_gaussians_plain(packed, pg, bd, tiles_x),
                          iters=3, warmup=1)
    pk = packed.clone().requires_grad_(True)
    plain_out = gt.rasterize_gaussians_plain(pk, pg, bd, tiles_x)
    plain_b = time_ms(lambda: torch.autograd.grad(plain_out, pk, num["go"], retain_graph=True),
                      iters=3, warmup=1)
    for e, ms, pms, (flop_ms, byte_ms), ke, ce in (
            (e_fwd, num["ms_f"], plain_f, num["f"], err, num["err"]),
            (e_bwd, num["ms_b"], plain_b, num["b"], gerr, num["gerr"])):
        e.add(max(ke, ce), ms, pms, flop_ms, byte_ms)
        log(f"[{e.d['name']}] head: kernel {ms:.4f} ms | plain {pms:.3f} ms | bound "
            f"{max(flop_ms, byte_ms):.4f} ms")
    log(f"[K4/K5] tiles that stopped early: "
        f"{int((num['n_done'].long() * 256 < (bd[1:] - bd[:-1])).sum())}"
        f" | max segment {int((bd[1:] - bd[:-1]).max())} pairs")
    del trainer, plain_out, num
    torch.cuda.empty_cache()
    phase_deep_tile(gen)
    return flame_dir, stage1_out


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
            f"({flops / ms / 1e9:.1f} TFLOP/s; on the device {shown(dev_ms)}, "
            f"{tflops(flops, dev_ms)}) | plain {plain_ms:.3f} ms | sdpa ({backend}) "
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
    """K7 against its plain version for all 15 cases at NITER 1, 7 and 64, the
    extra terms against numpy, ptxas's spills (none) and the SASS of each
    case's loop (no BAR in the one-row-a-warp cases); then the tool's run at
    NITER 262,144 (the main path of this kernel)."""
    import numpy as np
    import torch

    from cap4d_torch.ops import op_mix as om
    from cap4d_torch.tools import bench_ops

    x = bench_ops.make_input("cuda")
    for case in om.CASES:
        for niter in (1, 7, 64):   # the remainder loop, both loops, the unrolled loop
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
    kernel_ptxas(om.KERNEL, "K7")
    sass = bench_ops.sass_loop_histograms(om.KERNEL.so_path())
    for case in om.CASES:
        h = sass.get(case)
        assert h, f"no loop found in the SASS of {case}"
        log(f"[K7 sass] {case}: {sum(h.values()):g} instructions per iteration (loop unrolled "
            f"x{om.UNROLL}, divided out): " + ", ".join(f"{op} {n:g}" for op, n in h.most_common(10)))
        if case in om.ROW_PER_WARP:
            # one row a warp: shuffles only, no block barrier inside the loop
            assert h.get("BAR", 0) == 0, f"K7 {case}: BAR inside the loop: {dict(h)}"

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
    label = f"smpl {cam.width}x{cam.height}"
    _, _, world, opac, gen = gsplat_kernels_vs_plain(trainer, cam, model["sh_degree"], label)
    with torch.no_grad():
        cols = torch.rand((trainer.n_active, 3), generator=gen, device="cuda")
        view = view_inputs(world, opac, cols, trainer.camera_tensors(cam), cam.width, cam.height)
        check_and_time_view(label, *view, gen)
    del trainer, world, view
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
          "generate", "loader", "gsplat", "fit", "animate", "quality", "train", "op_mix", "smpl")


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
    # the fit trains on stage 1's images from the gsplat phase's assets; the
    # animation drives the fit's checkpoint
    assert "fit" not in phases or {"generate", "gsplat"} <= set(phases), phases
    assert "animate" not in phases or "fit" in phases, phases
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
              "cap4d_tpu/ops/attention.py:43", flash_attention.KERNEL_BWD, library=True),
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
    stage1_out = None
    if "generate" in phases:
        gen_launches, stage1_out = phase_main_path(work, kernels, card)
        main_paths.extend(gen_launches)
    if "loader" in phases:
        phase_loader(work, card)
    if "gsplat" in phases:
        flame_dir, stage1_out = phase_gsplat(entries[3], entries[4], work, stage1_out)
    if "fit" in phases:
        model_path, fit_launches = phase_fit(work, stage1_out, flame_dir, kernels, card)
        main_paths.append(fit_launches)
    if "animate" in phases:
        main_paths.append(phase_animate(work, model_path, flame_dir, kernels, card))
    if "quality" in phases:
        main_paths.append(phase_quality(work, kernels, card))
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
