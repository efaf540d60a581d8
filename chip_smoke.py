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
     read; every round and DDIM update of these runs is a replay of a
     captured CUDA graph (the sampler's default on the card; its captures
     and replays asserted, launches counted through the replays), and the
     runs at 1, 4 and 8 are repeated with ``graphs=False``: z_gen graphed
     against eager bit for bit, s per group-step both ways (the whole
     sampler, and from the second round on by CUDA events), the rounds'
     busy share, peak memory while sampling within 10 % of eager; z_gen at
     4 held against 1 (relative norm gap within ``BATCHED_REL_TOL``), and
     K1/K2 against their plain versions at the shapes the batched run
     launched them at;
  6b. the native runtime (``loader``): the machine's codec headers and
     libraries (none are needed), a timed g++ build, PNG and JPEG round
     trips (PNG decode bit for bit against ``read_png``), 64 frames through
     the prefetch pool against the serial Python path, and a
     ``--detect_anomaly`` stage 1 whose UNet returns NaN at DDIM step 2,
     which must raise ``FloatingPointError``;
  6c. video input (``video``): the probe of NVDEC (``libnvcuvid``,
     ``NVIDIA_DRIVER_CAPABILITIES``, ``cuvidGetDecoderCaps`` for H.264 and
     VP9, ``cuvidCreateDecoder`` for H.264); the port's I_PCM + P_Skip H.264
     streams at 1920x1080 and 1080x1920 decoded on the host by the runtime
     (``runtime/h264.cpp``), every plane equal to the frames written, and
     ``nv12_to_rgb`` on the card against the CPU; the I_PCM + B_Skip streams
     (PR 16) at both sizes, each B frame the rounded average of its
     anchors, in order (one decode a frame) and shuffled; the random-syntax
     CAVLC and CABAC streams of tier-1, without and with B pictures,
     decoded to ffmpeg's pinned luma SHA-256; 1080x1920 CABAC random-syntax
     streams of 60 frames (20 written, repeated three times), I/P and with B
     pictures in a pyramid, timed
     (frames/s, random access, decodes a sequential read makes);
     VP9 (``runtime/vp9.cpp``): every committed stream under
     ``tests/data/vp9/`` (libvpx's and ``utils/vp9_writer.py``'s) decoded
     to the SHA-256 of ffmpeg's planes that tier-1 pins, the RGB on the card
     equal to the CPU's, and a 16-frame 1080x1920 libvpx load timed (ms a
     frame decoding alone and with the RGB on the card, random access);
     swscale's bicubic scaler (``runtime/nvdec.py``) on the card equal to
     the CPU on VP9's odd-height and rescaled frames; VP8
     (``runtime/vp8.cpp``): every committed file under ``tests/data/vp8/``
     (libvpx's, cv2's ``VP80`` writes, the MediaRecorder layout and
     ``utils/vp8_writer.py``'s) decoded to the SHA-256 of ffmpeg's planes
     that tier-1 pins, the RGB on the card equal to the CPU's, and a
     16-frame 1080x1920 libvpx load timed the same way; Motion-JPEG at
     1080p (.mp4 and .mov) through the runtime, its planes to the SHA-256
     of ffmpeg's mjpeg decoder's, sequential and random access, timed;
     MPEG-4 Part 2 (``runtime/mpeg4.cpp``):
     the cv2-written ``mp4v`` files under ``tests/data/mpeg4/`` and the
     random-syntax streams of ``utils/mpeg4_writer.py`` decoded to the
     SHA-256 of ffmpeg's planes that tier-1 pins, and a 60-frame 1080x1920
     Advanced Simple load (B-VOPs, quarter-sample, 4MV) timed (ms a frame
     decoding, with the RGB on the card, the decodes of a sequential read,
     a random read); HEVC (``runtime/hevc.cpp``): the writer's intra and
     P/B streams decoded to the SHA-256 of ffmpeg's planes that tier-1
     pins, a portrait recording to cv2's upright RGB, and 1080x1920 intra
     and P/B loads timed; AVI, Matroska and fragmented mp4; stage 1's
     reference loader on a Motion-JPEG video and on an MPEG-4 video
     against the same frames as a PNG directory. Every stream it writes is
     written by four niced worker processes (``Writers``, ``video_writes``)
     while the card phases run, from the end of phase 4 (the phases before
     time host-bound kernels: K3's UV sets are ~30 µs a call of host work);
     its untimed checks (``video_checks``) then run in a process of their
     own beside the SMPL path of 11, and its timed loads (``video_loads``)
     in another beside phase 12 (``VideoPhase``, ``VideoProcess``): no timed
     load shares the host with a writer or a check, but the figures of
     phases 5-12 are taken beside the writers or a video process.
     ``--serial-video`` runs the whole video phase after phase 12 with
     nothing beside it instead, to measure what the overlap costs them;
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
     (densification, opacity reset, SH warmup, evaluation, checkpoint),
     twice, each counted: chunked as by default (the whole train step
     captured as a CUDA graph and replayed, launches counted through the
     replays) and per step (``chunked=False``), with s per iteration,
     captures, the pair budget and its regrowths; then one step from
     identical state on the camera with the most candidates, eager against
     eager (K5's atomic spread) and replayed against eager (within
     ``GRAPH_*_REL_TOL``), and dispatches of ten replays timed by CUDA
     events against their wall time (the card's busy share);
  9. the stage-3 main path: ``render_sequence`` of that checkpoint (of a
     fresh avatar when the fit did not run) driven by a synthetic 48-frame
     fit.npz at 512², with the animated PLY, each frame a replay of the
     captured frame render with eight frames in flight (captures, replays,
     pair budget and regrowths asserted, K4 counted through the replays);
     then the same with ``graphs=False`` (every PNG and the PLY
     byte-identical) and graphed without PNG writes: FPS each way, a
     replayed frame's device ms and the loop's busy share by CUDA events;
  9b. the head fit's held-out quality (``quality``): ``fit_holdout_quality``
     cut to 300 iterations (27 orbit views that see the head, 3 held out;
     the oracle rendered by the plain compositor, the fit through K4/K5);
 10. the MMDM training main path: ``train_mmdm`` on the shipped training
     config at full width with the synthetic dataset, bf16, cut to a virtual
     batch of 4 micro-batches and 3 optimizer steps (checkpoint and image log
     at step 3), each micro-batch a replay of one captured CUDA graph (its
     captures and replays asserted, launches counted through the replays);
     the checkpoint reloads into a fresh UNet; then, outside the counted run,
     on signal weights, a graphed step against an eager one from identical
     state (eager against eager for the spread; within
     ``TRAIN_GRAPH_*_REL_TOL``), a replayed step after an AdamW update
     against an eager one (stale bf16 weight casts would show), s per
     optimizer step graphed | eager in turns, the card's busy share over
     replayed steps by CUDA events, profiles of both, the AdamW update alone;
 11. the op-mix micro-benchmark (K7) and the full-body SMPL path (``op_mix``,
     ``smpl``; its 300-iteration fit graphed and per step, and the replay
     against the eager step, as in 8; its 48-frame wave at 1080² graphed
     and eager as in 9);
 12. several cards through ``cap4d_torch.parallel`` (``parallel``), on the one
     card: NCCL at world 1 (a bucketed all-reduce and a barrier), and NCCL
     for two ranks on the card refused; then two ranks sharing the card over
     gloo (started by ``cap4d_torch.parallel.spawn``), against this process
     alone: stage 1 at the shipped width on signal weights, the debug config
     cut to 2 DDIM steps, at ``groups_per_device`` 2 (z_gen within
     ``DP_REL_TOL``), phase 9's 48 frames with ``dp_frames`` 0 (every PNG and
     the PLY byte-identical to phase 9's), and ``make_accum_train_step`` at
     full width (the shipped training config, 4 micro-batches over the two
     ranks, graphed, 2 AdamW steps with injected draws after one from seeded random
     gradients: the first step's loss to 1e-5 relative and gradient norm
     within ``DP_GRAD_REL_TOL``, the second step's within
     ``DP_STEP2_REL_TOL``, beside one process run twice; both ranks'
     parameters bitwise equal); each rank's seconds,
     peak memory and launches, the gradient all-reduce's bytes and seconds;
     then stage 1's CLI under ``torch.distributed.run --nproc_per_node 2``
     (1 DDIM step): rank 0 writes every PNG, rank 1 none;
 13. a ``[timing] total`` line (the script's seconds and the share spent
     waiting on the stream writers) and, unless ``--serial-video``, a line
     naming the phases whose figures were taken beside the video phase's
     processes; the card's name and power limit, a
     ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Launch counts are read around each main path (6 and its batched runs, both
fits of 8, 9, 9b, 10, the op-mix and SMPL runs, and each rank's runs in 12) with every
count set to 0 just before it; the kernels line sums them (the ranks return
theirs to this process).

``--phases`` runs a subset (for bring-up); the result lines are printed only
when every phase ran. ``--serial-video`` runs the video phase last, alone.

Without CUDA, or outside a checkout, it exits non-zero and prints no result.
Times are CUDA-event times on the card, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import cProfile
import ctypes
import json
import math
import os
import pstats
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


# SHA-256 of ffmpeg's mjpeg planes (Y; U and V) of video_loads' 24 Motion-JPEG
# frames (test_image(1080, 1920, k) through utils/synthetic_assets.py's
# write_mjpeg_video), computed with cv2's libavcodec and held by
# tests/test_torch_swscale.py
MJPEG_1080_PLANES_SHA256 = (24, ("06c25030735ccc76767161ff954453b92a263f472b53ff51b8724e7632577fa0",
                                 "c0ce0ab441d90314972dfea76f975136e99d5495db654cce3bad8fb6dcff3fbe"))


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


class timed_calls:
    """CUDA events around every call of ``cls.<name>`` inside the block (a
    graph owner's launch of one unit: a replay, an eager run, or the warm-up
    and capture): the device span from the second call of ``kind`` (the
    first after a capture) to the last call's end, the device time inside
    those calls, and so the card's busy share of the span. With
    ``window=(i, n)``, torch.profiler records calls i..i+n-1: the kernels'
    device time inside them against their span by CUDA events (the busy
    share inside the units themselves)."""

    def __init__(self, cls, name: str, window=None):
        self.cls, self.name, self.calls, self.window = cls, name, [], window
        self.prof, self.inside = None, None

    def __enter__(self):
        import torch

        self.orig = orig = getattr(self.cls, self.name)

        def wrapped(obj, *args, **kw):
            i = len(self.calls)
            if self.window and i == self.window[0]:
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                self.prof.__enter__()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = orig(obj, *args, **kw)
            b.record()
            self.calls.append((args[0] if args else None, a, b))
            if self.prof is not None and i == sum(self.window) - 1:
                torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)
                kernel_ms = sum(e.self_device_time_total for e in self.prof.key_averages()
                                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
                first, last = self.calls[self.window[0]], self.calls[-1]
                self.inside = (kernel_ms, first[1].elapsed_time(last[2]))
                self.prof = None
            return out

        setattr(self.cls, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.orig)

    def profiled(self) -> str:
        """The profiled window's kernel time against its span."""
        if self.inside is None:
            return "profiled window: not measured"
        k, span = self.inside
        if k == 0:
            return "profiled window: the profiler saw no device time"
        return (f"profiled window of {self.window[1]} calls: kernels {k:.2f} ms of a "
                f"{span:.2f} ms span ({100 * k / span:.1f} % busy)")

    def summary(self, kind=None) -> dict:
        """{"n": calls of ``kind`` in the span, "unit_ms": their mean device
        ms, "span_ms", "busy"} (None where there are fewer than two)."""
        import torch

        torch.cuda.synchronize()
        first = [i for i, c in enumerate(self.calls) if kind is None or c[0] == kind]
        if len(first) < 2:
            return {"n": 0, "unit_ms": None, "span_ms": None, "busy": None}
        calls = self.calls[first[1]:]
        span = calls[0][1].elapsed_time(calls[-1][2])
        inside = sum(a.elapsed_time(b) for _, a, b in calls)
        units = [a.elapsed_time(b) for k, a, b in calls if kind is None or k == kind]
        return {"n": len(units), "unit_ms": sum(units) / len(units), "span_ms": span,
                "busy": inside / span}


def generation_run(a: SimpleNamespace, out: Path, kernels, card: str, label: str,
                   groups_per_device: int = 1, init_noise=None, cfg=None,
                   graphs=None, window=None) -> dict:
    """One counted ``run_generation``: every launch count set to 0 just
    before it and read just after; its wall, s per group-step (the whole
    sampler, and from the second round on by CUDA events), the sampler's
    graph counters, the busy share of its rounds, peak memory. ``window``:
    torch.profiler over those calls of the sampler (``timed_calls``), which
    slows the run: its times are not compared."""
    import numpy as np
    import torch

    from cap4d_torch.inference.generate_images import run_generation
    from cap4d_torch.mmdm.sampler import StochasticIOSampler, parallel_groups
    from cap4d_torch.mmdm.sampler_graph import BlockGraphs

    sample, sampler_peak = StochasticIOSampler.sample, []

    def measured(self, *args, **kw):   # the sampler's own peak, apart from encode/decode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        z = sample(self, *args, **kw)
        torch.cuda.synchronize()
        sampler_peak.append((torch.cuda.max_memory_allocated() / 2 ** 30,
                             torch.cuda.max_memory_reserved() / 2 ** 30))
        return z

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    StochasticIOSampler.sample = measured
    t0 = time.perf_counter()
    try:
        with timed_calls(BlockGraphs, "run", window=window) as timer:
            res = run_generation(cfg or a.cfg, a.ref_dir, out, allow_random_weights=True,
                                 flame_asset_dir=a.flame_dir, dtype=torch.bfloat16,
                                 init_noise=init_noise, groups_per_device=groups_per_device,
                                 graphs=graphs)
    finally:
        StochasticIOSampler.sample = sample
    wall = time.perf_counter() - t0
    peak = max(torch.cuda.max_memory_allocated() / 2 ** 30, sampler_peak[0][0])
    launches = {k.name: k.launches for k in kernels}
    n = res["z_gen"].shape[0]
    n_groups = n // 7                                   # one reference: G = 7
    n_par = parallel_groups(n_groups, groups_per_device)
    n_calls = res["group_steps"] // n_par
    rounds = timer.summary("round")
    steady = rounds["span_ms"] / 1e3 / (rounds["n"] * n_par) if rounds["n"] else None
    g = res["sampler_graphs"]
    res.update(launches=launches, peak_gib=peak, sampler_peak_gib=sampler_peak[0][0],
               sampler_reserved_gib=sampler_peak[0][1], s_per_group_step=res["sampler_s"]
               / res["group_steps"], steady_s_per_group_step=steady, rounds=rounds)
    mode = "graphed" if g["graphed"] else "eager"
    log(f"[{label}] groups_per_device {groups_per_device}, {mode}: run_generation wall "
        f"{wall:.1f} s | sampler {res['sampler_s']:.2f} s, {res['s_per_group_step']:.4f} s per "
        f"group-step ({res['group_steps']} group-steps in {n_calls} UNet calls of batch "
        f"{2 * n_par}), from the second round on {shown(steady, ' s')} per group-step by "
        f"CUDA events | sampler graphs {g} | rounds after the first: {rounds['n']}, "
        f"{shown(rounds['unit_ms'])} each, "
        + (f"busy {100 * rounds['busy']:.1f} % of their span" if g["graphed"] and rounds["n"]
           else "busy not measured (eager)")
        + (f" | {timer.profiled()}" if window else "")
        + f" | decode+save {res['decode_s']:.2f} s | peak allocated {peak:.2f} GiB, while "
        f"sampling {sampler_peak[0][0]:.2f} GiB (reserved {sampler_peak[0][1]:.2f}) | on {card}")
    log(f"[{label}] launches {launches}")
    for sub, n_img in (("reference_images", 1), ("generated_images", n)):
        assert len(list((out / sub / "images").glob("*.png"))) == n_img, sub
        assert len(list((out / sub / "flame").glob("*.npz"))) == n_img, sub
        assert list((out / sub / "condition_vis").rglob("*.jpg")), sub
    assert res["z_gen"].shape == (n, 64, 64, 4), res["z_gen"].shape
    assert np.isfinite(res["z_gen"]).all(), "non-finite latents"
    assert res["images"].shape == (n, 512, 512, 3)
    # launches inside replays are counted through them: the same counts as eager
    assert launches["flash_attention"] == 16 * n_calls, launches
    assert launches["group_norm"] == 61 * n_calls, launches
    assert launches["rasterize"] > 0, launches
    S = res["group_steps"] // n_groups
    if g["graphed"]:
        # the first round and the first update are the warm-ups of the two captures
        assert g["captures"] == 2 and g["replays"] == (n_calls - 1) + (S - 1), g
    else:
        assert g["captures"] == 0 and g["replays"] == 0, g
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
        # the same runs with every round and update eager (not counted)
        eager = {g: generation_run(a, a.root / f"eager_{g}", kernels, card, "eager", g,
                                   noise if g < 8 else None, cfg8 if g == 8 else None,
                                   graphs=False) for g in (1, 4, 8)}
        # the kernels' share of three rounds (torch.profiler), graphed and eager
        for graphs in (None, False):
            generation_run(a, a.root / f"profiled_{graphs}", kernels, card, "profiled", 1,
                           noise, graphs=graphs, window=(6, 3))
    finally:
        mmdm_model.init_random_ = saved_init
    graphed = {**batched, 8: big}
    for g, e in eager.items():
        zg, ze = graphed[g]["z_gen"], e["z_gen"]
        same = bool(np.array_equal(zg, ze))
        peak_ratio = graphed[g]["sampler_peak_gib"] / e["sampler_peak_gib"]
        log(f"[graph vs eager] groups_per_device {g}: z_gen "
            f"{'bit-identical' if same else 'differs'} (max |diff| "
            f"{float(np.abs(zg - ze).max()):.4g}) | s per group-step graphed | eager "
            f"{graphed[g]['s_per_group_step']:.4f} | {e['s_per_group_step']:.4f} (whole sampler), "
            f"{shown(graphed[g]['steady_s_per_group_step'], '')} | "
            f"{shown(e['steady_s_per_group_step'], '')} (second round on) | busy "
            f"{100 * graphed[g]['rounds']['busy']:.1f} % | peak GiB while sampling "
            f"{graphed[g]['sampler_peak_gib']:.2f} | {e['sampler_peak_gib']:.2f} (ratio "
            f"{peak_ratio:.3f}), reserved {graphed[g]['sampler_reserved_gib']:.2f} | "
            f"{e['sampler_reserved_gib']:.2f} | on {card}")
        # eps sums per frame from one group of one round (the atomics add to
        # zero), and a replay runs the eager kernels: the bits must agree
        assert same, f"graphed z_gen differs from eager at groups_per_device {g}"
        assert peak_ratio <= 1.10, (g, graphed[g]["sampler_peak_gib"], e["sampler_peak_gib"])
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


def video_probe() -> dict:
    """What the machine offers video input: ``libcuda.so.1`` and
    ``libnvcuvid.so.1`` (NVDEC), ``NVIDIA_DRIVER_CAPABILITIES``, the Video
    Codec SDK headers, the Python video modules, ``cuvidGetDecoderCaps`` for
    H.264 and VP9 at 8-bit 4:2:0 and ``cuvidCreateDecoder`` for H.264.
    Returns the caps by codec."""
    import importlib

    from cap4d_torch.runtime import nvdec

    libs = {}
    for name in ("libcuda.so.1", "libnvcuvid.so.1"):
        try:
            ctypes.CDLL(name)
            libs[name] = "loads"
        except OSError as e:
            libs[name] = f"absent ({e})"
    roots = ["/usr/local/cuda/include", "/usr/local/cuda/targets/x86_64-linux/include",
             "/usr/include"]
    headers = {h: [r for r in roots if Path(r, h).exists()] for h in ("nvcuvid.h", "cuviddec.h")}
    modules = {}
    for mod in ("av", "torchvision.io", "decord"):
        try:
            importlib.import_module(mod)
            modules[mod] = "imports"
        except ImportError as e:
            modules[mod] = f"{type(e).__name__}: {e}"[:80]
    log(f"[video] probe: {libs} | NVIDIA_DRIVER_CAPABILITIES="
        f"{os.environ.get('NVIDIA_DRIVER_CAPABILITIES')!r} | SDK headers {headers} | "
        f"modules {modules}")
    caps = {codec: nvdec.decoder_caps(codec) for codec in ("h264", "vp9")}
    log(f"[video] probe: cuvidGetDecoderCaps (8-bit 4:2:0) {caps}")
    if "error" not in caps["h264"]:
        log(f"[video] probe: cuvidCreateDecoder (H.264 1920x1088 NV12) returned "
            f"{create_decoder_status()}")
    return caps


class DecoderCreateInfo(ctypes.Structure):
    """``CUVIDDECODECREATEINFO`` of ``cuviddec.h`` (176 bytes on x86-64)."""
    _fields_ = [("ulWidth", ctypes.c_ulong), ("ulHeight", ctypes.c_ulong),
                ("ulNumDecodeSurfaces", ctypes.c_ulong), ("CodecType", ctypes.c_int),
                ("ChromaFormat", ctypes.c_int), ("ulCreationFlags", ctypes.c_ulong),
                ("bitDepthMinus8", ctypes.c_ulong), ("ulIntraDecodeOnly", ctypes.c_ulong),
                ("ulMaxWidth", ctypes.c_ulong), ("ulMaxHeight", ctypes.c_ulong),
                ("Reserved1", ctypes.c_ulong), ("display_area", ctypes.c_short * 4),
                ("OutputFormat", ctypes.c_int), ("DeinterlaceMode", ctypes.c_int),
                ("ulTargetWidth", ctypes.c_ulong), ("ulTargetHeight", ctypes.c_ulong),
                ("ulNumOutputSurfaces", ctypes.c_ulong), ("vidLock", ctypes.c_void_p),
                ("target_rect", ctypes.c_short * 4), ("enableHistogram", ctypes.c_ulong),
                ("Reserved2", ctypes.c_ulong * 4)]


def create_decoder_status() -> int:
    """``cuvidCreateDecoder``'s status for an H.264 1920x1088 NV12 decoder
    (8 surfaces, PreferCUVID with a context lock) on card 0's primary
    context; a decoder it makes is destroyed again."""
    cuda, cuvid = ctypes.CDLL("libcuda.so.1"), ctypes.CDLL("libnvcuvid.so.1")
    assert ctypes.sizeof(DecoderCreateInfo) == 176
    dev, ctx, lock, dec = ctypes.c_int(0), ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
    assert cuda.cuDeviceGet(ctypes.byref(dev), 0) == 0
    assert cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev) == 0
    try:
        assert cuda.cuCtxPushCurrent_v2(ctx) == 0
        assert cuvid.cuvidCtxLockCreate(ctypes.byref(lock), ctx) == 0
        info = DecoderCreateInfo(ulWidth=1920, ulHeight=1088, ulNumDecodeSurfaces=8,
                                 CodecType=4, ChromaFormat=1, ulCreationFlags=4,
                                 ulMaxWidth=1920, ulMaxHeight=1088, ulTargetWidth=1920,
                                 ulTargetHeight=1088, ulNumOutputSurfaces=2, vidLock=lock)
        info.display_area[:] = [0, 0, 1920, 1080]
        status = cuvid.cuvidCreateDecoder(ctypes.byref(dec), ctypes.byref(info))
        if status == 0:
            cuvid.cuvidDestroyDecoder(dec)
        cuvid.cuvidCtxLockDestroy(lock)
        cuda.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))
    finally:
        cuda.cuDevicePrimaryCtxRelease_v2(dev)
    return status


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


# ------------------------------------------------------------ video input ----

VIDEO_SIZES = ((1920, 1080), (1080, 1920))   # 1080p, and portrait phone video


def repeat_mp4(path: Path, times: int) -> None:
    """Rewrite the flat mp4 ``path`` as its samples ``times`` over, for a
    long load at the writer's cost of one: the stream must start at a key
    frame that resets the decoder (an IDR picture) and show every picture
    before its end, so that each copy decodes as the first does."""
    from cap4d_torch.utils import container_writer as cw
    from cap4d_torch.utils import synthetic_assets as sa

    s = cw.stream_of_mp4(path)
    n = len(s.samples)
    assert s.sync[0] and sorted(s.rank) == list(range(n)), path
    rank = [r + k * n for k in range(times) for r in s.rank]
    delay = max(j - r for j, r in enumerate(rank))
    ctts = [r - j + delay for j, r in enumerate(rank)] if delay else None
    sa.write_mp4(path, s.samples * times, cw.mp4_sample_entry(s), s.width, s.height,
                 sync=s.sync * times, ctts=ctts, edit_start=delay)


# ------------------------------------------------ the video phase's writers ----
# The seeded stream writers run in Python and take seconds a 1080x1920
# picture. They start after the rasterize phase (the phases before time
# host-bound kernels, which the writers' processes slowed by up to 2x), in
# worker processes at a lowered priority, while the card phases run; every
# write is done before the video checks and timed loads start, so no timed
# load shares the host with a writer. A write's bytes do not depend on when
# or where it runs.
WRITER_PROCESSES = 4


def _writer_init() -> None:
    os.nice(10)     # the card phases' host threads go first


def _write_job(fn, args, kwargs):
    """One write in a worker: (``fn(*args, **kwargs)``, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def planes_digest(planes) -> str:
    """The SHA-256 of a frame's (Y, U, V) planes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p).tobytes())
    return h.hexdigest()


def write_pcm_mp4(path: Path, w: int, h: int, **kw) -> list:
    """``synthetic_assets.write_h264_mp4``'s exact stream, 24 frames with an
    IDR every 8; returns each frame's ``planes_digest`` (not the planes: the
    checks' process need not receive 75 MB a file)."""
    from cap4d_torch.utils import synthetic_assets as sa

    return [planes_digest(f) for f in sa.write_h264_mp4(path, 24, w, h, gop=8, **kw)]


def write_h264_load(path: Path, w: int, h: int, n: int, seed: int, times: int, **kw) -> dict:
    """A 1080x1920 H.264 load: ``n`` pictures of random CABAC syntax, their
    samples repeated ``times`` over; returns the writer's stats."""
    from cap4d_torch.utils import h264_writer as hw

    stats = hw.write_h264_syntax_mp4(path, w, h, n, seed, "cabac", **kw)
    repeat_mp4(path, times)
    return stats


def write_hevc_load(path: Path, w: int, h: int, seed: int, times: int, gop=None, **kw) -> dict:
    """A 1080x1920 HEVC load: one GOP of random syntax (the intra writer's
    pictures, or ``gop``'s inter pictures) as hvc1, its samples repeated
    ``times`` over (each copy starts at its IDR picture)."""
    from cap4d_torch.utils import hevc_writer as hw

    if gop is None:
        st = hw.write_hevc_stream(w, h, kw.pop("n_frames"), seed=seed, **kw)
    else:
        st = hw.write_hevc_inter_stream(w, h, seed, gop, **kw)
    hw.write_hevc_mp4(path, st, w, h)
    repeat_mp4(path, times)
    return dict(n_written=len(st["samples"]), sizes=[len(x) for x in st["samples"]])


def video_writes(d: Path) -> dict:
    """key -> (function, args, kwargs): the video phase's seeded writes into
    ``d``, the largest (the timed loads) first, since the workers take them
    in this order; each on one thread (the writers' files do not depend on
    their ``workers``; nested pools of 8 oversubscribed the card phases'
    host)."""
    from cap4d_torch.utils import h264_writer as hw
    from cap4d_torch.utils import hevc_writer as hew
    from cap4d_torch.utils import mpeg4_writer as mw

    jobs = {
        "mpeg4_load": (mw.write_mpeg4_syntax_mp4, (d / "mpeg4_asp_1080x1920.mp4", 1080, 1920, 60, 11),
                       dict(b_frames=True, quarter=True)),
        "syntax_cabac_1080x1920": (write_h264_load, (d / "syntax_cabac_1080x1920.mp4", 1080, 1920,
                                                     20, 5, 3), dict(b_frames=False)),
        "syntax_cabac_b_1080x1920": (write_h264_load, (d / "syntax_cabac_b_1080x1920.mp4", 1080,
                                                       1920, 20, 4, 3), dict(b_frames=True)),
        "hevc_inter_load": (write_hevc_load, (d / "hevc_pb_1080x1920.mp4", 1080, 1920, 22, 3),
                            dict(gop=hew.GOP_PYRAMID, log2_ctb=6, log2_min_cb=4, vui=hew.BT709,
                                 max_slices=1, tools=dict(hew.PHONE_TOOLS, amp=True),
                                 mix=HEVC_PB_LOAD_MIX)),
        "hevc_intra_load": (write_hevc_load, (d / "hevc_load_1080x1920.mp4", 1080, 1920, 21, 12),
                            dict(n_frames=2, log2_ctb=6, log2_min_cb=4, vui=hew.BT709,
                                 max_slices=1, tools=hew.PHONE_TOOLS)),
    }
    for w, h in VIDEO_SIZES:
        jobs[f"pcm_{w}x{h}"] = (write_pcm_mp4, (d / f"h264_{w}x{h}.mp4", w, h), {})
        jobs[f"pcm_b_{w}x{h}"] = (write_pcm_mp4, (d / f"h264_b_{w}x{h}.mp4", w, h),
                                  dict(b_frames=2))
    for pins, b in ((hw.PINNED_LUMA_SHA256, False), (hw.PINNED_B_LUMA_SHA256, True)):
        for entropy, seed, w, h, n in pins:
            path = d / f"syntax_{entropy}_{seed}{'_b' if b else ''}.mp4"
            jobs[path.stem] = (hw.write_h264_syntax_mp4, (path, w, h, n, seed, entropy),
                               dict(b_frames=b))
    for name in hew.STREAMS:
        jobs[f"hevc_{name}"] = (hew.write_stream_mp4, (d / f"hevc_{name}.mp4", name), {})
    jobs["hevc_portrait"] = (hew.write_rotated_mp4, (d / "hevc_portrait.mp4",), {})
    for name, (w, h, n, seed, kw) in mw.STREAMS.items():
        jobs[f"mpeg4_{name}"] = (mw.write_mpeg4_syntax_mp4, (d / f"mpeg4_{name}.mp4", w, h, n, seed),
                                 kw)
    for entropy, seed in (("cavlc", 1), ("cabac", 5)):
        jobs[f"mux_h264_{entropy}_{seed}"] = (
            hw.write_h264_syntax_mp4, (d / f"mux_h264_{entropy}_{seed}.mp4", 128, 96, 16, seed, entropy),
            dict(b_frames=True))
    jobs["mux_mpeg4_advanced"] = (mw.write_mpeg4_syntax_mp4,
                                  (d / "mux_mpeg4_advanced.mp4", *mw.STREAMS["advanced"][:4]),
                                  mw.STREAMS["advanced"][4])
    (d / "fragmented").mkdir(parents=True, exist_ok=True)
    for (w, h) in mw.PINNED_ODD_RGB_SHA256:
        jobs[f"mpeg4_odd_{w}x{h}"] = (mw.write_mpeg4_syntax_mp4,
                                      (d / "fragmented" / f"mpeg4_{w}x{h}.mp4", w, h), mw.ODD_STREAM)
    return jobs


class Writers:
    """The video phase's writes (``video_writes``), started at once in
    ``WRITER_PROCESSES`` spawned workers, in ``video_writes``' order."""

    def __init__(self, d: Path):
        import concurrent.futures as cf
        import multiprocessing

        d.mkdir(parents=True, exist_ok=True)
        self.t0 = time.perf_counter()
        self.pool = cf.ProcessPoolExecutor(WRITER_PROCESSES, multiprocessing.get_context("spawn"),
                                           initializer=_writer_init)
        self.futures = {k: self.pool.submit(_write_job, *job) for k, job in video_writes(d).items()}
        self.finished = []      # seconds from the start to each write's end
        for f in self.futures.values():
            f.add_done_callback(lambda _: self.finished.append(time.perf_counter() - self.t0))
        self.waited = 0.0
        self.done_after = None

    def finish(self) -> dict:
        """Wait for every write (a write that failed raises here), then stop
        the workers; returns key -> (the write's result, its seconds)."""
        import concurrent.futures as cf

        t0 = time.perf_counter()
        cf.wait(list(self.futures.values()))
        self.waited = time.perf_counter() - t0
        self.pool.shutdown()
        self.done_after = max(self.finished)
        done = {k: f.result() for k, f in self.futures.items()}
        busy = sum(seconds for _, seconds in done.values())
        log(f"[timing] video writers: {len(self.futures)} writes in {WRITER_PROCESSES} worker "
            f"processes, {busy:.1f} s of writing, all done {self.done_after:.1f} s after they "
            f"started; waited {self.waited:.1f} s for them")
        return done

    def stop(self) -> None:
        for f in self.futures.values():
            f.cancel()
        self.pool.shutdown(cancel_futures=True)


# the 1080x1920 HEVC P/B load: phone parameter sets, AMP and a B pyramid of
# 9 pictures (sps_max_num_reorder_pics 2), more skipped and merged blocks
# than the tests' streams (a camera's P and B pictures carry few bits)
HEVC_PB_LOAD_MIX = dict(skip=0.5, intra=0.05, merge=0.6, residual=0.4)


def count_decodes(reader):
    """The reader's decode calls, counted: a list whose first item is the count."""
    calls, decode = [0], reader._decoder.decode

    def counted(*args):
        calls[0] += 1
        return decode(*args)

    reader._decoder.decode = counted
    return calls


class SubTimer:
    """``[timing] <label>: <step> <seconds>`` lines, each step timed from the
    last."""

    def __init__(self, label: str):
        self.label, self.t = label, time.perf_counter()

    def __call__(self, step: str) -> None:
        log(f"[timing] {self.label}: {step} {time.perf_counter() - self.t:.1f} s")
        self.t = time.perf_counter()


def video_checks(work: Path, card: str, writes: dict):
    """The video phase's checks that time nothing, in a process of their own
    (``VideoProcess``) beside the SMPL path: the probe; the port's
    I_PCM + P_Skip H.264 streams at 1920x1080 and 1080x1920 (24 frames, an
    IDR every 8) through the demuxer and the runtime's H.264 decoder, every
    plane equal to the frames written, in order and shuffled, and
    ``nv12_to_rgb`` on the card against the CPU; the I_PCM + B_Skip streams
    at both sizes (each B frame the rounded average of its anchors), in
    order with one decode a frame, and shuffled; the random-syntax CAVLC
    and CABAC streams of tests/test_torch_h264.py and
    tests/test_torch_h264_b.py decoded to the luma SHA-256 that the tests
    pin to ffmpeg's decode; VP9 and VP8 (``vp9_checks``, ``vp8_checks``:
    the committed streams to ffmpeg's pinned plane hashes, RGB on the card
    against the CPU, swscale's scaler on the card against the CPU); HEVC
    (``hevc_checks``); MPEG-4 Part 2 (``mpeg4_checks``: the committed cv2
    files and the writer's streams to ffmpeg's pinned plane hashes); AVI,
    Matroska and fragmented mp4 (``containers_checks``,
    ``fragmented_checks``); stage 1's reference loader on a Motion-JPEG
    and on an MPEG-4 video against the same frames as a PNG directory."""
    import hashlib

    import numpy as np
    import torch

    from cap4d_torch.data import mp4
    from cap4d_torch.data.datasets import build_frame_set, load_reference_items
    from cap4d_torch.data.utils import VideoFrameReader, load_frame
    from cap4d_torch.flame.compute import load_cap4d_flame_model
    from cap4d_torch.runtime.nvdec import nv12_to_rgb
    from cap4d_torch.utils import h264_writer as hw
    from cap4d_torch.utils import mpeg4_writer as mw
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.png import read_png, write_png

    step = SubTimer("video checks")
    caps = video_probe()
    d = work / "video"
    rng = np.random.default_rng(0)

    for w, h in VIDEO_SIZES:
        path = d / f"h264_{w}x{h}.mp4"
        digests, write_s = writes[f"pcm_{w}x{h}"]
        t0 = time.perf_counter()
        t = mp4.read_track(path)
        demux_ms = 1e3 * (time.perf_counter() - t0)
        assert (t.codec, t.width, t.height, len(t)) == ("h264", w, h, 24), t
        assert list(np.flatnonzero(t.sync)) == [0, 8, 16], t.sync
        assert [mp4.annexb(t.sample(i), t.avc.length_size)[4] & 0x1F for i in range(24)] == [
            5 if i % 8 == 0 else 1 for i in range(24)]
        reader = VideoFrameReader(path, device="cuda")
        t0 = time.perf_counter()
        seq = [reader.h264_planes(k) for k in range(24)]
        seq_ms = 1e3 * (time.perf_counter() - t0) / 24
        shuffled = VideoFrameReader(path, device="cuda")
        for k in rng.permutation(24):
            assert planes_digest(shuffled.h264_planes(int(k))) == digests[k], \
                f"{path.name} frame {k} (shuffled)"
        for k in range(24):
            assert planes_digest(seq[k]) == digests[k], f"{path.name} frame {k}"
        planes = seq     # equal to the frames written
        rgb = load_frame(path, 3, device="cuda")
        worst, differing = 0, 0
        for k in (0, 8, 16):
            y, u, v = (torch.from_numpy(p) for p in planes[k])
            uv = torch.stack([u, v], -1)
            diff = np.abs(nv12_to_rgb(y.cuda(), uv.cuda()).astype(int) - nv12_to_rgb(y, uv))
            worst, differing = max(worst, int(diff.max())), differing + int((diff > 0).sum())
        y, u, v = (torch.from_numpy(p) for p in planes[3])
        assert np.array_equal(rgb, nv12_to_rgb(y, torch.stack([u, v], -1))), "load_frame's RGB"
        # integer arithmetic: the card's RGB equals the CPU's
        assert worst == 0, worst
        log(f"[video] H.264 I_PCM + P_Skip {w}x{h}, 24 frames, IDR every 8: written in "
            f"{write_s:.2f} s ({path.stat().st_size} bytes), demuxed in {demux_ms:.2f} ms, "
            f"decoded on the host {seq_ms:.2f} ms a frame; Y, U, V equal to the frames written "
            f"in order and shuffled; nv12_to_rgb card vs CPU max |diff| {worst} ({differing} "
            f"values differ of {3 * 3 * w * h}) | on {card}")


    # B pictures (PR 16): I_PCM anchors and B_Skip pictures, each B frame the
    # rounded average of its two anchors in Y, U and V
    for w, h in VIDEO_SIZES:
        path = d / f"h264_b_{w}x{h}.mp4"
        digests = writes[f"pcm_b_{w}x{h}"][0]
        reader = VideoFrameReader(path, device="cuda")
        calls = count_decodes(reader)
        t0 = time.perf_counter()
        seq = [reader.h264_planes(k) for k in range(24)]
        seq_ms = 1e3 * (time.perf_counter() - t0) / 24
        assert calls[0] == 24, f"{path.name}: {calls[0]} decodes for 24 frames in order"
        for k in range(24):
            assert planes_digest(seq[k]) == digests[k], f"{path.name} frame {k}"
        shuffled = VideoFrameReader(path, device="cuda")
        for k in rng.permutation(24):
            assert planes_digest(shuffled.h264_planes(int(k))) == digests[k], \
                f"{path.name} frame {k} (shuffled)"
        y, u, v = (torch.from_numpy(p) for p in seq[1])
        assert np.array_equal(load_frame(path, 1, device="cuda"),
                              nv12_to_rgb(y, torch.stack([u, v], -1))), "load_frame's RGB (B frame)"
        log(f"[video] H.264 I_PCM + B_Skip {w}x{h}, 24 frames, 2 B pictures between anchors: "
            f"Y, U, V equal to the anchors' rounded averages in order ({calls[0]} decodes for "
            f"24 frames, {seq_ms:.2f} ms a frame) and shuffled | on {card}")

    step("H.264 I_PCM streams")
    # random syntax: the luma SHA-256 that tier-1 pins to ffmpeg's decode
    pinned = [(key, want, False) for key, want in sorted(hw.PINNED_LUMA_SHA256.items())] + [
        (key, want, True) for key, want in sorted(hw.PINNED_B_LUMA_SHA256.items())]
    for (entropy, seed, w, h, n), want, b_frames in pinned:
        path = d / f"syntax_{entropy}_{seed}{'_b' if b_frames else ''}.mp4"
        stats = writes[path.stem][0]
        reader = VideoFrameReader(path, device="cuda")
        got = hashlib.sha256(b"".join(reader.h264_planes(k)[0].tobytes()
                                      for k in range(n))).hexdigest()
        assert got == want, f"{entropy} seed {seed}: luma SHA-256 {got}, ffmpeg's {want}"
        log(f"[video] H.264 random syntax {entropy} seed {seed} {w}x{h}x{n}"
            f"{' with B pictures' if b_frames else ''} ({path.stat().st_size} bytes, "
            f"{stats['mb']}): luma SHA-256 equals ffmpeg's ({want[:16]}...)")


    step("H.264 random syntax pins")
    # every codec decodes on the host; NVDEC stays a probe
    usable = all(c.get("status") == 0 and c.get("supported") for c in caps.values())
    log(f"[video] NVDEC {'answers its caps' if usable else 'is not usable here'} (a probe: no "
        f"codec goes to it)")
    vp9_checks(card, rng)
    step("VP9")
    vp8_checks(card, rng)
    step("VP8")
    hevc_checks(d, card, rng, writes)
    step("HEVC")
    mpeg4_checks(d, card, rng, writes)
    step("MPEG-4")
    containers_checks(d, card, rng, writes)
    step("containers")
    fragmented_checks(d, card, rng, writes)
    step("fragmented")

    # stage 1's reference loader: images/cam0.mp4 (Motion-JPEG, then MPEG-4
    # Part 2 of random syntax at the frames' size) against a PNG directory
    def write_mpeg4(video, frames):
        h, w = frames[0].shape[:2]
        mw.write_mpeg4_syntax_mp4(video, w, h, len(frames), 3, b_frames=True, quarter=True)

    for codec, write in (("Motion-JPEG", sa.write_mjpeg_video), ("MPEG-4 Part 2", write_mpeg4)):
        root = d / f"stage1_{codec.split()[0].replace('-', '').lower()}"
        flame_dir = sa.make_asset_dir(root)
        ref = sa.make_reference_dir(root, resolution=512, n_timesteps=3)
        video = ref / "images" / "cam0.mp4"
        write(video, [read_png(p) for p in sorted((ref / "images" / "cam0").glob("*"))])
        fit = dict(np.load(ref / "fit.npz"))
        fit["camera_order"] = np.array(["cam0.mp4"])
        np.savez(ref / "fit.npz", **fit)
        (ref / "reference_images.json").write_text('[["cam0.mp4", 1]]')
        flame = load_cap4d_flame_model(flame_dir, n_shape_params=150, n_expr_params=65,
                                       add_mouth=True, device=torch.device("cuda"))
        head_ids = np.genfromtxt(flame_dir / "head_vertices.txt").astype(int)
        items, extr = load_reference_items(ref)
        from_video = build_frame_set(flame, items, head_ids, extr, 512, is_reference=True)
        reader = VideoFrameReader(video)
        assert reader.track.codec == ("mjpeg" if codec == "Motion-JPEG" else "mpeg4")
        decoded = [reader[k] for k in range(3)]
        video.rename(root / "cam0.mp4")
        for kind, imgs in (("images", decoded), ("bg", [np.full_like(decoded[0], 255)] * 3)):
            (ref / kind / "cam0.mp4").mkdir(parents=True)
            for k, img in enumerate(imgs):
                write_png(ref / kind / "cam0.mp4" / f"{k:05d}.png", img)
        items, extr = load_reference_items(ref)
        from_pngs = build_frame_set(flame, items, head_ids, extr, 512, is_reference=True)
        assert np.array_equal(from_video.images, from_pngs.images), f"{codec}-fed frame set differs"
        assert np.isfinite(from_video.images).all() and np.abs(from_video.images).max() > 0.1
        log(f"[video] stage 1's reference loader on images/cam0.mp4 ({codec}, frame 1 at "
            f"512²) equals the same frames as a PNG directory (white bg directory)")
    step("reference loader")


def video_loads(work: Path, card: str, writes: dict):
    """The video phase's timed loads, in a process of their own beside the
    ``parallel`` phase (after every writer and check is done): 1080x1920
    CABAC random-syntax H.264 streams
    of 60 frames (20 written, repeated three times), I/P and with B
    pictures (a pyramid), timed (sequential frames/s, a random-access read
    and the samples it decodes, the decodes of a sequential read); the
    16-frame 1080x1920 libvpx VP9 and VP8 loads; the HEVC intra and P/B
    loads; Motion-JPEG at 1080p (.mp4 and .mov) through the runtime, its
    planes to ffmpeg's pinned hashes, the RGB on the card against the CPU,
    sequential and random access; the 1080x1920 MPEG-4 Advanced Simple
    load; the containers' and fragmented mp4's timed reads."""
    import numpy as np
    import torch

    from cap4d_torch.data.utils import VideoFrameReader, load_frame, open_video
    from cap4d_torch.utils import mpeg4_writer as mw
    from cap4d_torch.utils import synthetic_assets as sa

    step = SubTimer("video loads")
    d = work / "video"
    rng = np.random.default_rng(1)
    # a synthetic load, timed on the host: random syntax with the tier-1
    # streams' statistics (h264_writer.MIX), CABAC, at 1080x1920; 20 pictures
    # written (the writer's ~1.3 s a picture) and their samples repeated
    # three times (each copy starts at its IDR picture)
    w, h, n_written, n = 1080, 1920, 20, 60
    path = d / "syntax_cabac_1080x1920.mp4"
    stats, write_s = writes[path.stem]
    mbps = path.stat().st_size * 8 / (n / 30) / 1e6
    reader = VideoFrameReader(path, device="cuda")
    t0 = time.perf_counter()
    for k in range(n):
        reader.h264_planes(k)
    decode_s = time.perf_counter() - t0
    reader = VideoFrameReader(path, device="cuda")
    t0 = time.perf_counter()
    frames = [reader[k] for k in range(n)]
    rgb_s = time.perf_counter() - t0
    assert all(f.shape == (h, w, 3) and f.dtype == np.uint8 for f in frames)
    assert all(np.array_equal(f, frames[k % n_written]) for k, f in enumerate(frames))
    order = rng.permutation(n)[:12]
    decoded = count_decodes(open_video(path, "cuda"))   # the reader load_frame reads through
    t0 = time.perf_counter()
    for k in order:
        assert np.array_equal(load_frame(path, int(k), device="cuda"), frames[k]), k
    rand_ms = 1e3 * (time.perf_counter() - t0) / len(order)
    gops = int(np.count_nonzero(reader.track.sync))
    log(f"[video] H.264 CABAC 1080x1920 of random syntax (tier-1's statistics, a synthetic "
        f"load), {n} frames ({n_written} written, repeated; {path.stat().st_size} bytes, "
        f"{mbps:.1f} Mbit/s at 30 fps, {gops} IDRs, up to {stats['slices_max']} slices a "
        f"picture; written in {write_s:.1f} s): "
        f"decode {n / decode_s:.1f} frames/s ({1e3 * decode_s / n:.1f} ms a frame), with the RGB "
        f"conversion {n / rgb_s:.1f} frames/s, a random-access load_frame {rand_ms:.1f} ms "
        f"({decoded[0] / len(order):.2f} samples decoded a read); host seconds "
        f"{decode_s:.2f} | on {card}")

    # the same load with B pictures (PR 16): seed 4 draws POC type 0, groups
    # of up to 3 B pictures with a reference B picture in the middle (a
    # pyramid, reorder depth 2), direct_8x8_inference_flag 1, default and
    # implicit bi-prediction weights, spatial and temporal direct
    path = d / "syntax_cabac_b_1080x1920.mp4"
    stats, write_s = writes[path.stem]
    assert stats["reorder"] == 2 and "b" in stats["frames"], stats["frames"]
    mbps = path.stat().st_size * 8 / (n / 30) / 1e6
    reader = VideoFrameReader(path, device="cuda")
    calls = count_decodes(reader)
    t0 = time.perf_counter()
    for k in range(n):
        reader.h264_planes(k)
    decode_s = time.perf_counter() - t0
    assert calls[0] == n, f"a sequential read decoded {calls[0]} samples for {n} frames"
    seq_decodes = calls[0]
    reader = VideoFrameReader(path, device="cuda")
    t0 = time.perf_counter()
    frames = [reader[k] for k in range(n)]
    rgb_s = time.perf_counter() - t0
    assert all(f.shape == (h, w, 3) and f.dtype == np.uint8 for f in frames)
    assert all(np.array_equal(f, frames[k % n_written]) for k, f in enumerate(frames))
    order = rng.permutation(n)[:12]
    decoded = count_decodes(open_video(path, "cuda"))
    t0 = time.perf_counter()
    for k in order:
        assert np.array_equal(load_frame(path, int(k), device="cuda"), frames[k]), k
    rand_ms = 1e3 * (time.perf_counter() - t0) / len(order)
    gops = int(np.count_nonzero(reader.track.sync))
    kinds = {k: stats["frames"].count(k) for k in sorted(set(stats["frames"]))}
    log(f"[video] H.264 CABAC 1080x1920 with B pictures, random syntax (tier-1's statistics, a "
        f"synthetic load), {n} frames ({n_written} written, repeated; {path.stat().st_size} "
        f"bytes, {mbps:.1f} Mbit/s at 30 fps, {gops} IDRs, pictures {kinds} in each copy, "
        f"{stats['b_slices']} B slices ({stats['temporal']} "
        f"temporal direct), up to {stats['slices_max']} slices a picture; written in "
        f"{write_s:.1f} s): decode {n / decode_s:.1f} frames/s ({1e3 * decode_s / n:.1f} ms a "
        f"frame on one host thread), a sequential read decoded {seq_decodes} samples for {n} "
        f"frames; with the RGB conversion {n / rgb_s:.1f} frames/s; a random-access load_frame "
        f"{rand_ms:.1f} ms ({decoded[0] / len(order):.2f} samples decoded a read); host seconds "
        f"{decode_s:.2f} | on {card}")
    step("H.264 CABAC loads")
    vp9_load(card, rng)
    step("VP9")
    vp8_load(card, rng)
    step("VP8")
    hevc_loads(d, card, writes)
    step("HEVC")

    # Motion-JPEG at 1080p through the runtime, in both sample entries: the
    # planes of ffmpeg's mjpeg decoder (pinned), the RGB on the card
    frames = [test_image(1080, 1920, k) for k in range(24)]
    reads = {}
    for name in ("mjpeg.mp4", "mjpeg.mov"):
        path = d / name
        sa.write_mjpeg_video(path, frames)
        reader = VideoFrameReader(path, device="cuda")
        assert len(reader) == 24 and reader.track.codec == "mjpeg"
        t0 = time.perf_counter()
        planes = [reader.planes(k) for k in range(24)]
        planes_ms = 1e3 * (time.perf_counter() - t0) / 24
        got = (len(planes), mw.planes_sha256(planes))
        assert got == MJPEG_1080_PLANES_SHA256, f"{name}: planes {got}, ffmpeg's {MJPEG_1080_PLANES_SHA256}"
        reader = VideoFrameReader(path, device="cuda")
        t0 = time.perf_counter()
        seq = [reader[k] for k in range(24)]
        seq_ms = 1e3 * (time.perf_counter() - t0) / 24
        cpu = VideoFrameReader(path, device="cpu")
        assert all(np.array_equal(seq[k], cpu[k]) for k in (0, 11, 23)), "card vs CPU RGB"
        order = np.random.default_rng(0).permutation(24)
        t0 = time.perf_counter()
        rand = {int(k): load_frame(path, int(k)) for k in order}
        rand_ms = 1e3 * (time.perf_counter() - t0) / 24
        assert all(np.array_equal(seq[k], rand[k]) for k in range(24)), "random access differs"
        err = max(float(np.abs(f.astype(int) - g).mean()) for f, g in zip(seq, frames))
        assert err < 4.0, err    # quality 90 and the frames' noise (std 4)
        reads[name] = seq
        log(f"[video] Motion-JPEG {name} 1920x1080, 24 frames ({path.stat().st_size} bytes): "
            f"planes equal ffmpeg's mjpeg decoder's (pinned SHA-256), {planes_ms:.2f} ms a frame "
            f"decoding alone on one host thread; with the RGB on the card {seq_ms:.2f} ms a "
            f"frame sequential (equal to the CPU's), {rand_ms:.2f} ms a load_frame(k) in random "
            f"order, equal; mean |frame - source| {err:.3f} | on {card}")
    assert all(np.array_equal(a, b) for a, b in zip(*reads.values())), ".mp4 and .mov differ"

    step("Motion-JPEG")
    mpeg4_load(d, card, rng, writes)
    step("MPEG-4")
    containers_timed(d, card, rng, d / "syntax_cabac_b_1080x1920.mp4")
    step("containers")
    fragmented_timed(d, card, rng)
    step("fragmented")


def vp9_checks(card: str, rng):
    """VP9 input (``runtime/vp9.cpp``): every committed stream under
    ``tests/data/vp9/`` (libvpx's settings of each tool, and the writer's
    header-level tools) decoded on the card's machine to the SHA-256 of
    ffmpeg's planes (``vp9_writer.PINNED_SHA256``), in order and, but for
    the timed load, shuffled; the RGB on the card equal to the CPU's on
    every frame; swscale's scaler on the card against the CPU."""
    import numpy as np
    import torch

    from cap4d_torch.data.utils import VideoFrameReader
    from cap4d_torch.utils import mpeg4_writer as mw
    from cap4d_torch.utils import vp9_writer as vw


    data = Path(__file__).resolve().parent / "tests" / "data" / "vp9"
    files = sorted(data.glob("*.*"))
    streams = {f.name.rsplit(".", 1)[0] for f in files}
    assert streams == set(vw.PINNED_SHA256), sorted(streams ^ set(vw.PINNED_SHA256))
    for path in files:
        name = path.name.rsplit(".", 1)[0]
        n, want = vw.PINNED_SHA256[name]
        reader = VideoFrameReader(path, device="cuda")
        pictures = [reader.planes(k) for k in range(len(reader._order))]
        got = mw.planes_sha256(pictures)
        assert (len(pictures), got) == (n, want), \
            f"{path.name}: {len(pictures)} pictures, SHA-256 {got}; ffmpeg's {n}, {want}"
        if name != "load_1080":
            shuffled = VideoFrameReader(path, device="cuda")
            for k in rng.permutation(n):
                for a, b in zip(shuffled.planes(int(k)), pictures[k]):
                    assert np.array_equal(a, b), f"{path.name} picture {k} (shuffled)"
        cpu = VideoFrameReader(path, device="cpu")
        for k in range(n):
            assert np.array_equal(reader[k], cpu[k]), f"{path.name} frame {k}: card vs CPU RGB"
        t = reader.track
        log(f"[video] VP9 {path.name} {t.width}x{t.height}, {len(t)} samples, {n} pictures "
            f"({path.stat().st_size} bytes, {len(reader._vp9.tools)} decoder tools): Y and U/V "
            f"SHA-256 equal ffmpeg's ({want[0][:16]}..., {want[1][:16]}...), RGB on the card "
            f"equals the CPU's")

    # swscale's scaler (odd heights, frames coded at another size) on the card
    from cap4d_torch.runtime.nvdec import swscale_bicubic

    scaled = 0
    for name in ("odd.webm", "resize.webm"):
        reader = VideoFrameReader(data / name, device="cpu")
        h, w = reader.track.height, reader.track.width
        for k in range(len(reader._order)):
            planes = reader.planes(k)
            if planes[0].shape == (h, w) and h % 2 == 0:
                continue       # the unscaled converter
            outs = [swscale_bicubic(*(torch.from_numpy(p).to(dev) for p in planes), h, w,
                                    reader._vp9.matrix, reader._vp9.full_range)
                    for dev in ("cuda", "cpu")]
            assert np.array_equal(*outs), f"{name} frame {k}: the scaler on the card vs the CPU"
            scaled += 1
    assert scaled >= 10, scaled
    log(f"[video] swscale's bicubic scaler (runtime/nvdec.py) on the card equals the CPU on "
        f"{scaled} VP9 frames of odd.webm and resize.webm (odd height, coded at other sizes)")


def vp9_load(card: str, rng):
    """The 16-frame 1080x1920 libvpx VP9 load (realtime, 1.2 Mbit/s
    target, a key frame every 4) timed on one host thread: ms a frame
    decoding alone, with the RGB conversion on the card, the decodes of a
    sequential read, and a random read's ms and samples decoded."""
    import numpy as np

    from cap4d_torch.data.utils import VideoFrameReader, load_frame, open_video

    data = Path(__file__).resolve().parent / "tests" / "data" / "vp9"
    path = data / "load_1080.mp4"
    reader = VideoFrameReader(path, device="cuda")
    n, (h, w) = len(reader), (reader.track.height, reader.track.width)
    mbps = path.stat().st_size * 8 / (n / 30) / 1e6
    calls = count_decodes(reader)
    t0 = time.perf_counter()
    for k in range(n):
        reader.planes(k)
    decode_s = time.perf_counter() - t0
    assert calls[0] == n, f"a sequential read decoded {calls[0]} samples for {n} frames"
    reader = VideoFrameReader(path, device="cuda")
    t0 = time.perf_counter()
    frames = [reader[k] for k in range(n)]
    rgb_s = time.perf_counter() - t0
    assert all(f.shape == (h, w, 3) and f.dtype == np.uint8 for f in frames)
    order = rng.permutation(n)[:8]
    decoded = count_decodes(open_video(path, "cuda"))
    t0 = time.perf_counter()
    for k in order:
        assert np.array_equal(load_frame(path, int(k), device="cuda"), frames[k]), k
    rand_ms = 1e3 * (time.perf_counter() - t0) / len(order)
    keys = int(np.count_nonzero(reader.track.sync))
    log(f"[video] VP9 1080x1920 libvpx load (realtime, cpu-used 8; a real encoder's stream), "
        f"{n} frames ({path.stat().st_size} bytes, {mbps:.2f} Mbit/s at 30 fps, {keys} key "
        f"frames): decode {1e3 * decode_s / n:.1f} ms a frame on one host thread, a sequential "
        f"read decoded {calls[0]} samples for {n} frames; with the RGB conversion on the card "
        f"{1e3 * rgb_s / n:.1f} ms a frame; a random-access load_frame {rand_ms:.1f} ms "
        f"({decoded[0] / len(order):.2f} samples decoded a read); host seconds {decode_s:.2f} "
        f"| on {card}")



def vp8_checks(card: str, rng):
    """VP8 input (``runtime/vp8.cpp``): every committed file under
    ``tests/data/vp8/`` (libvpx's settings of each tool, cv2's VP80 writes in
    WebM, Matroska and AVI, the MediaRecorder layout, and the writer's
    header-level tools) decoded on the card's machine to the SHA-256 of
    ffmpeg's planes (``vp8_writer.PINNED_SHA256``), in order and, but for
    the timed load, shuffled; the RGB on the card equal to the CPU's on
    every frame."""
    import numpy as np

    from cap4d_torch.data.utils import VideoFrameReader
    from cap4d_torch.utils import mpeg4_writer as mw
    from cap4d_torch.utils import vp8_writer as vw

    data = Path(__file__).resolve().parent / "tests" / "data" / "vp8"
    files = sorted(data.glob("*.*"))
    stems = {f.name.rsplit(".", 1)[0] for f in files}
    assert stems == set(vw.PINNED_SHA256), sorted(stems ^ set(vw.PINNED_SHA256))
    for path in files:
        name = path.name.rsplit(".", 1)[0]
        n, want = vw.PINNED_SHA256[name]
        reader = VideoFrameReader(path, device="cuda")
        pictures = [reader.planes(k) for k in range(len(reader._order))]
        got = mw.planes_sha256(pictures)
        assert (len(pictures), got) == (n, want), \
            f"{path.name}: {len(pictures)} pictures, SHA-256 {got}; ffmpeg's {n}, {want}"
        if name != "load_1080":
            shuffled = VideoFrameReader(path, device="cuda")
            for k in rng.permutation(n):
                for a, b in zip(shuffled.planes(int(k)), pictures[k]):
                    assert np.array_equal(a, b), f"{path.name} picture {k} (shuffled)"
        cpu = VideoFrameReader(path, device="cpu")
        for k in range(n):
            assert np.array_equal(reader[k], cpu[k]), f"{path.name} frame {k}: card vs CPU RGB"
        t = reader.track
        log(f"[video] VP8 {path.name} {t.width}x{t.height}, {len(t)} samples, {n} pictures "
            f"({path.stat().st_size} bytes, {len(reader._vp8.tools)} decoder tools): Y and U/V "
            f"SHA-256 equal ffmpeg's ({want[0][:16]}..., {want[1][:16]}...), RGB on the card "
            f"equals the CPU's")


def vp8_load(card: str, rng):
    """The 16-frame 1080x1920 libvpx VP8 load (vp08 in mp4, realtime,
    1.2 Mbit/s target, a key frame every 8) timed on one host thread: ms a
    frame decoding alone, with the RGB conversion on the card, the decodes
    of a sequential read, and a random read's ms and samples decoded."""
    import numpy as np

    from cap4d_torch.data.utils import VideoFrameReader, load_frame, open_video

    data = Path(__file__).resolve().parent / "tests" / "data" / "vp8"
    path = data / "load_1080.mp4"
    reader = VideoFrameReader(path, device="cuda")
    n, (h, w) = len(reader), (reader.track.height, reader.track.width)
    mbps = path.stat().st_size * 8 / (n / 30) / 1e6
    calls = count_decodes(reader)
    t0 = time.perf_counter()
    for k in range(n):
        reader.planes(k)
    decode_s = time.perf_counter() - t0
    assert calls[0] == n, f"a sequential read decoded {calls[0]} samples for {n} frames"
    reader = VideoFrameReader(path, device="cuda")
    t0 = time.perf_counter()
    frames = [reader[k] for k in range(n)]
    rgb_s = time.perf_counter() - t0
    assert all(f.shape == (h, w, 3) and f.dtype == np.uint8 for f in frames)
    order = rng.permutation(n)[:8]
    decoded = count_decodes(open_video(path, "cuda"))
    t0 = time.perf_counter()
    for k in order:
        assert np.array_equal(load_frame(path, int(k), device="cuda"), frames[k]), k
    rand_ms = 1e3 * (time.perf_counter() - t0) / len(order)
    keys = int(np.count_nonzero(reader.track.sync))
    log(f"[video] VP8 1080x1920 libvpx load (vp08 in mp4, realtime, cpu-used -8; a real "
        f"encoder's stream), {n} frames ({path.stat().st_size} bytes, {mbps:.2f} Mbit/s at 30 "
        f"fps, {keys} key frames): decode {1e3 * decode_s / n:.1f} ms a frame on one host "
        f"thread, a sequential read decoded {calls[0]} samples for {n} frames; with the RGB "
        f"conversion on the card {1e3 * rgb_s / n:.1f} ms a frame; a random-access load_frame "
        f"{rand_ms:.1f} ms ({decoded[0] / len(order):.2f} samples decoded a read); host seconds "
        f"{decode_s:.2f} | on {card}")


def hevc_checks(d: Path, card: str, rng, writes: dict):
    """HEVC input (``runtime/hevc.cpp``): the writer's seeded streams
    (``hevc_writer.STREAMS``: intra pictures at CTB 16, 32 and 64, tiles,
    wavefronts, slices, PCM, bypass, scaling lists, SAO, open GOPs with
    RASL/RADL pictures; P and B pictures: a phone-like IPPP stream,
    a B pyramid with weighted P prediction and AMP, long-term pictures with
    list modifications, temporal sub-layers, an open GOP whose RASL
    pictures refer across its CRA, pic_output_flag 0 and
    no_output_of_prior_pics_flag) written as ``hvc1`` mp4 by the early
    writers and decoded to the SHA-256 of ffmpeg's planes
    (``PINNED_SHA256``), in order and shuffled, the RGB on the card equal to
    the CPU's; a portrait phone recording (the "phone" stream turned 90
    degrees by its ``tkhd``) to the pinned hash of cv2's upright RGB
    frames."""
    import numpy as np

    from cap4d_torch.data.utils import VideoFrameReader
    from cap4d_torch.utils import container_writer as cw
    from cap4d_torch.utils import hevc_writer as hw


    for name, kw in hw.STREAMS.items():
        path = d / f"hevc_{name}.mp4"
        reader = VideoFrameReader(path, device="cuda")
        pictures = [reader.planes(k) for k in range(len(reader._order))]
        got = hw.planes_sha256(pictures)
        assert got == hw.PINNED_SHA256[name], f"{name}: SHA-256 {got}, ffmpeg's {hw.PINNED_SHA256[name]}"
        shuffled = VideoFrameReader(path, device="cuda")
        for k in rng.permutation(len(pictures)):
            for a, b in zip(shuffled.planes(int(k)), pictures[k]):
                assert np.array_equal(a, b), f"HEVC {name} picture {k} (shuffled)"
        cpu = VideoFrameReader(path, device="cpu")
        for k in range(len(pictures)):
            assert np.array_equal(reader[k], cpu[k]), f"HEVC {name} frame {k}: card vs CPU RGB"
        log(f"[video] HEVC {name} {kw['width']}x{kw['height']}, {len(reader.track)} samples, "
            f"{len(pictures)} pictures ({len(reader._hevc.tools)} decoder tools): planes' SHA-256 "
            f"equals ffmpeg's ({got[:16]}...) in order and shuffled, RGB on the card equals the "
            f"CPU's")
    path = d / "hevc_portrait.mp4"
    reader = VideoFrameReader(path, device="cuda")
    frames = [reader[k] for k in range(len(reader))]
    got = cw.rgb_sha256(frames)
    assert frames[0].shape == (256, 136, 3) and got == hw.PINNED_ROTATED_RGB_SHA256, \
        (frames[0].shape, got)
    log(f"[video] HEVC portrait recording (tkhd turned 90 degrees): {len(frames)} frames "
        f"{frames[0].shape[1]}x{frames[0].shape[0]} upright, RGB SHA-256 equals cv2's "
        f"({got[:16]}...)")


def hevc_loads(d: Path, card: str, writes: dict):
    """Two 1080x1920 HEVC loads on phone parameter sets (CTB 64, minimum
    CB 16, coded 1088 wide with a conformance window, SAO and deblocking,
    BT.709 limited range; random syntax): an intra one (an IDR and an I
    picture written, their samples repeated to 24 frames) and a P/B one (a
    9-picture B pyramid with a P picture, AMP and TMVP, written once and
    repeated to 27 frames), each timed on one host thread: ms a frame
    decoding alone and with the RGB conversion on the card, and the decodes
    of a sequential read."""
    import numpy as np

    from cap4d_torch.data.utils import VideoFrameReader

    # the timed loads: written once by the early writers and their samples
    # repeated (each copy starts at its IDR picture)
    w, h = 1080, 1920
    for key, label, path in (("hevc_intra_load", "intra", d / "hevc_load_1080x1920.mp4"),
                             ("hevc_inter_load", "P/B (a B pyramid, AMP, TMVP)",
                              d / "hevc_pb_1080x1920.mp4")):
        info, write_s = writes[key]
        n_written = info["n_written"]
        reader = VideoFrameReader(path, device="cuda")
        n = len(reader)
        calls = count_decodes(reader)
        t0 = time.perf_counter()
        for k in range(n):
            reader.planes(k)
        decode_s = time.perf_counter() - t0
        assert calls[0] == n, f"a sequential read decoded {calls[0]} samples for {n} frames"
        reader = VideoFrameReader(path, device="cuda")
        t0 = time.perf_counter()
        frames = [reader[k] for k in range(n)]
        rgb_s = time.perf_counter() - t0
        assert n >= 24 and all(f.shape == (h, w, 3) and f.dtype == np.uint8 for f in frames)
        assert all(np.array_equal(f, frames[k % n_written]) for k, f in enumerate(frames))
        if key == "hevc_inter_load":
            tools = reader._hevc.tools
            assert {"p_slice", "b_slice", "merge", "amvp", "tmvp", "skip"} <= tools, sorted(tools)
        size = path.stat().st_size
        log(f"[video] HEVC 1080x1920 {label} load (random syntax, phone parameter sets, {n} "
            f"pictures, {n_written} written, repeated; {size} bytes, "
            f"{size * 8 / (n / 30) / 1e6:.1f} Mbit/s at 30 fps; written in {write_s:.1f} s by an "
            f"early writer): decode {1e3 * decode_s / n:.1f} ms a frame on one host thread, a "
            f"sequential read decoded {calls[0]} samples for {n} frames; with the RGB conversion "
            f"on the card {1e3 * rgb_s / n:.1f} ms a frame; host seconds {decode_s:.2f} | on {card}")


def mpeg4_checks(d: Path, card: str, rng, writes: dict):
    """MPEG-4 Part 2 input (``runtime/mpeg4.cpp``): the cv2-written files
    under ``tests/data/mpeg4/`` and the writer's random-syntax streams to
    the SHA-256 of ffmpeg's planes (``mpeg4_writer.PINNED_CV2_SHA256`` and
    ``PINNED_SHA256``)."""
    from cap4d_torch.data.utils import VideoFrameReader
    from cap4d_torch.utils import mpeg4_writer as mw

    def decode_all(reader):
        return [reader.planes(k) for k in range(len(reader._order))]

    data = Path(__file__).resolve().parent / "tests" / "data" / "mpeg4"
    for name, want in sorted(mw.PINNED_CV2_SHA256.items()):
        reader = VideoFrameReader(data / f"{name}.mp4", device="cuda")
        got = mw.planes_sha256(decode_all(reader))
        assert got == want, f"cv2's {name}.mp4: planes SHA-256 {got}, ffmpeg's {want}"
        t = reader.track
        log(f"[video] MPEG-4 cv2-written {name}.mp4 {t.width}x{t.height}x{len(t)} "
            f"({(data / f'{name}.mp4').stat().st_size} bytes, VOPs "
            f"{''.join(reader._vop_type)}): Y and U/V SHA-256 equal ffmpeg's ({want[0][:16]}..., "
            f"{want[1][:16]}...)")
    for name, (w, h, n, seed, kw) in sorted(mw.STREAMS.items()):
        path = d / f"mpeg4_{name}.mp4"
        stats = writes[f"mpeg4_{name}"][0]
        reader = VideoFrameReader(path, device="cuda")
        want = mw.PINNED_SHA256[name]
        got = mw.planes_sha256(decode_all(reader))
        assert got == want, f"writer's {name}: planes SHA-256 {got}, ffmpeg's {want}"
        log(f"[video] MPEG-4 random syntax {name} {w}x{h}x{n} {kw} ({path.stat().st_size} bytes, "
            f"VOPs {''.join(stats['vops'])}): Y and U/V SHA-256 equal ffmpeg's "
            f"({want[0][:16]}..., {want[1][:16]}...)")


def mpeg4_load(d: Path, card: str, rng, writes: dict):
    """A 60-frame 1080x1920 Advanced Simple load of the writer's (B-VOPs,
    quarter-sample, 4MV, video packets), a synthetic load, timed on the
    host: ms a frame decoding, with the RGB conversion on the card, the
    decodes of a sequential read, and a random read's ms and samples
    decoded."""
    import numpy as np

    from cap4d_torch.data.utils import VideoFrameReader, load_frame, open_video

    # the timed load: random syntax (the writer's MIX), a synthetic load
    w, h, n = 1080, 1920, 60
    path = d / "mpeg4_asp_1080x1920.mp4"
    stats, write_s = writes["mpeg4_load"]
    tools = stats["tools"]
    assert tools["inter4v"] and tools["b_direct"] and tools["quarter"], tools
    mbps = path.stat().st_size * 8 / (n / 30) / 1e6
    reader = VideoFrameReader(path, device="cuda")
    calls = count_decodes(reader)
    t0 = time.perf_counter()
    for k in range(n):
        reader.planes(k)
    decode_s = time.perf_counter() - t0
    assert calls[0] == n, f"a sequential read decoded {calls[0]} samples for {n} frames"
    seq_decodes = calls[0]
    reader = VideoFrameReader(path, device="cuda")
    t0 = time.perf_counter()
    frames = [reader[k] for k in range(n)]
    rgb_s = time.perf_counter() - t0
    assert all(f.shape == (h, w, 3) and f.dtype == np.uint8 for f in frames)
    order = rng.permutation(n)[:12]
    decoded = count_decodes(open_video(path, "cuda"))
    t0 = time.perf_counter()
    for k in order:
        assert np.array_equal(load_frame(path, int(k), device="cuda"), frames[k]), k
    rand_ms = 1e3 * (time.perf_counter() - t0) / len(order)
    kinds = {k: stats["vops"].count(k) for k in sorted(set(stats["vops"]))}
    log(f"[video] MPEG-4 Advanced Simple 1080x1920 of random syntax (B-VOPs, quarter-sample, "
        f"4MV, video packets; a synthetic load), {n} frames ({path.stat().st_size} bytes, "
        f"{mbps:.1f} Mbit/s at 30 fps, VOPs {kinds}, {tools['inter4v']} 4MV, "
        f"{tools.get('b_direct', 0)} direct; written in {write_s:.1f} s): decode "
        f"{1e3 * decode_s / n:.1f} ms a frame on one host thread, a sequential read decoded "
        f"{seq_decodes} samples for {n} frames; with the RGB conversion on the card "
        f"{1e3 * rgb_s / n:.1f} ms a frame; a random-access load_frame {rand_ms:.1f} ms "
        f"({decoded[0] / len(order):.2f} samples decoded a read); host seconds {decode_s:.2f} "
        f"| on {card}")



def containers_checks(d: Path, card: str, rng, writes: dict):
    """AVI and Matroska/WebM input (``data/avi.py``, ``data/mkv.py``): the
    cv2-written files under ``tests/data/containers/`` read on the card to
    the SHA-256 the tests pin to frames held against cv2
    (``container_writer.PINNED_CV2_RGB_SHA256``, the VP9 WebM's
    included); the writers' H.264 B and MPEG-4 B-VOP streams muxed into AVI
    (idx1, no index, in-band parameter sets) and Matroska (SimpleBlocks,
    BlockGroups, unknown sizes without Cues or a duration) to ffmpeg's
    pinned plane hashes, one decode a sample."""
    import hashlib

    from cap4d_torch.data.utils import VideoFrameReader
    from cap4d_torch.utils import container_writer as cw
    from cap4d_torch.utils import h264_writer as hw
    from cap4d_torch.utils import mpeg4_writer as mw

    data = Path(__file__).resolve().parent / "tests" / "data" / "containers"
    for name, (n, want) in sorted(cw.PINNED_CV2_RGB_SHA256.items()):
        path = data / f"{name}{cw.CV2_FILE_SUFFIX[name]}"
        reader = VideoFrameReader(path, device="cuda")
        assert len(reader) == n, f"{path.name}: len {len(reader)}, cv2 counts {n}"
        got = cw.rgb_sha256([reader[k] for k in range(n)])
        assert got == want, f"cv2's {path.name}: RGB SHA-256 {got}, pinned {want}"
        t = reader.track
        log(f"[video] cv2-written {path.name} ({t.codec} as {t.fourcc!r}) {t.width}x{t.height}, "
            f"{n} frames ({path.stat().st_size} bytes): RGB SHA-256 equals the pin held against "
            f"cv2 ({want[:16]}...)")

    variants = {"avi_idx1": (".avi", cw.write_avi, {}),
                "avi_no_index": (".avi", cw.write_avi, dict(index="none")),
                "avi_in_band": (".avi", cw.write_avi, dict(in_band=True)),
                "mkv": (".mkv", cw.write_mkv, {}),
                "mkv_group": (".mkv", cw.write_mkv, dict(blocks="group", negative=True)),
                "mkv_live": (".mkv", cw.write_mkv, dict(unknown_sizes=True, cues=False,
                                                        duration=False))}
    w, h, n = 128, 96, 16
    sources = {}
    for entropy, seed in (("cavlc", 1), ("cabac", 5)):
        src = d / f"mux_h264_{entropy}_{seed}.mp4"
        sources[f"H.264 {entropy} B"] = (src, hw.PINNED_B_LUMA_SHA256[entropy, seed, w, h, n])
    src = d / "mux_mpeg4_advanced.mp4"
    sources["MPEG-4 B-VOPs"] = (src, mw.PINNED_SHA256["advanced"])
    for label, (src, want) in sources.items():
        s = cw.stream_of_mp4(src)
        for variant, (suffix, mux, kw) in variants.items():
            path = d / f"{src.stem}_{variant}{suffix}"
            mux(path, s, **kw)
            reader = VideoFrameReader(path, device="cuda")
            calls = count_decodes(reader)
            planes = [reader.planes(k) for k in range(len(reader._order))]
            if label.startswith("H.264"):
                got = hashlib.sha256(b"".join(p[0].tobytes() for p in planes)).hexdigest()
            else:
                got = mw.planes_sha256(planes)
            assert got == want, f"{path.name}: planes SHA-256 {got}, ffmpeg's {want}"
            assert calls[0] == len(s.samples), f"{path.name}: {calls[0]} decodes"
            assert reader[len(planes) - 1].shape == (s.height, s.width, 3)
        log(f"[video] {label} {s.width}x{s.height}x{len(s.samples)} in {', '.join(variants)}: "
            f"planes SHA-256 equal ffmpeg's pin, one decode a sample")



def containers_timed(d: Path, card: str, rng, h264_b: Path):
    """Timed on the host with the RGB on the card: a 240-sample 1080x1920
    Motion-JPEG and the 60-sample 1080x1920 H.264 CABAC B stream in
    mp4/mov, AVI and Matroska in turns: demux ms, reader open ms (the AVI's
    order-count scan), ms a frame for sequential reads and for random
    load_frame calls on the same frames."""
    import numpy as np

    from cap4d_torch.data import container
    from cap4d_torch.data.utils import VideoFrameReader, load_frame, open_video
    from cap4d_torch.runtime.loader import encode_jpeg
    from cap4d_torch.utils import container_writer as cw
    from cap4d_torch.utils import synthetic_assets as sa

    # timed: 240 Motion-JPEG samples (24 frames, each ten times) and the
    # 60-sample H.264 B stream, 1080x1920, in mp4/mov (the baseline), AVI and
    # Matroska in turns, each read the same way: the first 48 frames (all
    # 60 for H.264) in order, then the same 12 frames at random
    tmp = d / "frame.jpg"
    jpegs = []
    for k in range(24):
        encode_jpeg(tmp, test_image(1920, 1080, k), 90)
        jpegs.append(tmp.read_bytes())
    mov = d / "timed_mjpeg.mov"
    sa.write_mp4(mov, jpegs * 10, sa.visual_sample_entry(b"jpeg", 1080, 1920), 1080, 1920,
                 brand=b"qt  ")
    for label, src, n_seq in (("Motion-JPEG", mov, 48), ("H.264 CABAC B", h264_b, 60)):
        s = cw.stream_of_mp4(src)
        n = len(s.samples)
        n_seq = min(n_seq, n)
        order = [int(k) for k in rng.permutation(n)[:12]]
        paths = [src]
        for suffix, mux in ((".avi", cw.write_avi), (".mkv", cw.write_mkv)):
            paths.append(d / f"{src.stem}_timed{suffix}")
            mux(paths[-1], s)
        for path in paths:
            demux = []
            for _ in range(3):
                t0 = time.perf_counter()
                t = container.read_track(path)
                demux.append(1e3 * (time.perf_counter() - t0))
            assert len(t) == n
            t0 = time.perf_counter()
            reader = VideoFrameReader(path, device="cuda")
            open_ms = 1e3 * (time.perf_counter() - t0)
            calls = count_decodes(reader) if reader._decoder is not None else [n_seq]
            t0 = time.perf_counter()
            frames = [reader[k] for k in range(n_seq)]
            seq_ms = 1e3 * (time.perf_counter() - t0) / n_seq
            assert calls[0] == n_seq, f"{path.name}: {calls[0]} decodes for {n_seq} frames"
            assert all(f.shape == (1920, 1080, 3) for f in frames)
            cached = open_video(path, "cuda")
            decoded = count_decodes(cached) if cached._decoder is not None else [len(order)]
            t0 = time.perf_counter()
            for k in order:
                got = load_frame(path, k, device="cuda")
                assert k >= n_seq or np.array_equal(got, frames[k]), k
            rand_ms = 1e3 * (time.perf_counter() - t0) / len(order)
            log(f"[video] {label} 1080x1920 in {path.suffix[1:].upper()}, {n} samples "
                f"({path.stat().st_size} bytes): demux {min(demux):.2f} ms (best of 3), reader "
                f"open {open_ms:.2f} ms, sequential {seq_ms:.2f} ms a frame ({n_seq} frames), "
                f"random load_frame {rand_ms:.2f} ms a frame (the same 12 frames, "
                f"{decoded[0] / len(order):.2f} samples decoded a read), RGB on the card "
                f"| on {card}")
        del frames


def fragmented_checks(d: Path, card: str, rng, writes: dict):
    """Fragmented mp4 and edit lists (``data/mp4.py``) and MPEG-4 Part 2 at
    an odd height: every layout of ``container_writer.FRAGMENTED_LAYOUTS``
    around the H.264 B, MPEG-4 B-VOP, committed VP9 and Motion-JPEG
    streams, ``EDIT_LISTS``' four edit lists and a fragmented file with two
    edits, written with the port's writer and read on the card (RGB) to the
    SHA-256 tests/test_torch_fragmented.py pins to frames held against cv2,
    sequential (one decode a sample) and shuffled; the 99x57 and 97x57
    MPEG-4 streams (left chroma siting) to tests/test_torch_swscale.py's
    pins."""
    import numpy as np

    from cap4d_torch.data.utils import VideoFrameReader
    from cap4d_torch.utils import container_writer as cw
    from cap4d_torch.utils import mpeg4_writer as mw
    from cap4d_torch.utils import synthetic_assets as sa


    def check_shuffled(path, frames, label):
        reader = VideoFrameReader(path, device="cuda")
        for k in rng.permutation(len(frames)):
            assert np.array_equal(reader[int(k)], frames[k]), f"{label}: frame {k} shuffled"

    fd = d / "fragmented"
    fd.mkdir(exist_ok=True)
    streams = cw.fragment_streams(fd, [test_image(48, 64, k) for k in range(12)])
    for name, (_, s) in streams.items():
        readers, shown = [], 0
        for layout, kw in cw.FRAGMENTED_LAYOUTS.items():
            path = fd / f"{name}_{layout}.mp4"
            cw.write_fragmented_mp4(path, s, **kw)
            reader = VideoFrameReader(path, device="cuda")
            calls = count_decodes(reader)
            frames = [reader[k] for k in range(len(reader._order))]
            assert calls[0] == len(reader.track), f"{path.name}: {calls[0]} decodes"
            check_shuffled(path, frames, path.name)
            readers.append(reader)
            shown += len(frames)
        got = cw.layouts_sha256(readers)
        assert got == cw.PINNED_FRAGMENTED_RGB_SHA256[name], f"{name}: layouts' RGB SHA-256 {got}"
        log(f"[video] fragmented mp4, {name} {s.width}x{s.height}x{len(s.samples)} in "
            f"{len(readers)} layouts ({', '.join(cw.FRAGMENTED_LAYOUTS)}): cv2's counts "
            f"{[len(r) for r in readers]}, {shown} frames, RGB on the card equal to the pin held "
            f"against cv2 ({got[:16]}...), one decode a sample, shuffled reads equal | on {card}")

    flat = fd / "sync.mov"
    sa.write_mjpeg_video(flat, [test_image(32, 48, k) for k in range(30)])
    edited = {name: (cw.stream_of_mp4(flat), edits) for name, edits in cw.EDIT_LISTS.items()}
    for name, (s, edits) in list(edited.items()) + [
            ("fragmented", (streams["mpeg4_b"][1], cw.FRAGMENTED_EDITS))]:
        path = fd / f"edit_{name}.mp4"
        if name == "fragmented":
            cw.write_fragmented_mp4(path, s, edits=edits)
        else:
            cw.write_edited_mp4(path, s, edits)
        reader = VideoFrameReader(path, device="cuda")
        frames = [reader[k] for k in range(len(reader._order))]
        got = (len(frames), cw.rgb_sha256(frames))
        assert got == cw.PINNED_EDIT_RGB_SHA256[name], f"edit list {name}: {got}"
        try:
            reader[len(frames)]
            raise AssertionError(f"edit list {name}: a frame past the edited ones read")
        except IndexError:
            pass
        check_shuffled(path, frames, f"edit list {name}")
        log(f"[video] edit list {name} {edits}: cv2's count {len(reader)}, {len(frames)} frames "
            f"equal to the pin held against cv2 ({got[1][:16]}...), IndexError past them, "
            f"shuffled reads equal | on {card}")

    for (w, h), (n, want) in sorted(mw.PINNED_ODD_RGB_SHA256.items()):
        path = fd / f"mpeg4_{w}x{h}.mp4"
        reader = VideoFrameReader(path, device="cuda")
        frames = [reader[k] for k in range(len(reader))]
        got = (len(frames), cw.rgb_sha256(frames))
        assert got == (n, want), f"MPEG-4 {w}x{h}: RGB {got}, pinned {want}"
        check_shuffled(path, frames, f"MPEG-4 {w}x{h}")
        log(f"[video] MPEG-4 Part 2 {w}x{h} (odd height, left chroma siting {reader._chroma_pos} "
            f"through swscale's scaler on the card): {n} frames equal to the pin held against cv2 "
            f"({want[:16]}...), shuffled reads equal | on {card}")


def fragmented_timed(d: Path, card: str, rng):
    """Timed on the host with the RGB on the card: containers_timed's
    240-sample 1080x1920 Motion-JPEG file flat and fragmented (a fragment a
    sample, as ffmpeg's frag_keyframe cuts an all-key stream, and 24
    samples a fragment), the flat file read first and again last: demux ms,
    reader open ms, ms a frame sequential and for random load_frame calls on
    the same frames."""
    import numpy as np

    from cap4d_torch.data import container
    from cap4d_torch.data.utils import VideoFrameReader, load_frame, open_video
    from cap4d_torch.utils import container_writer as cw

    fd = d / "fragmented"

    # timed: containers_timed's 240 Motion-JPEG samples, flat and fragmented
    mov = d / "timed_mjpeg.mov"
    s = cw.stream_of_mp4(mov)
    n = len(s.samples)
    order = [int(k) for k in rng.permutation(n)[:12]]
    paths = [("flat", mov)]
    for label, kw in (("a fragment a sample", {}), ("24 samples a fragment", dict(fragment=24))):
        paths.append((label, fd / f"timed_{len(paths)}.mp4"))
        cw.write_fragmented_mp4(paths[-1][1], s, **kw)
    paths.append(("flat again", mov))       # flat on both sides of the fragmented reads
    reads = []
    for label, path in paths:
        demux = []
        for _ in range(3):
            t0 = time.perf_counter()
            t = container.read_track(path)
            demux.append(1e3 * (time.perf_counter() - t0))
        assert len(t) == n
        t0 = time.perf_counter()
        reader = VideoFrameReader(path, device="cuda")
        open_ms = 1e3 * (time.perf_counter() - t0)
        assert len(reader) == n, (label, len(reader))
        calls = count_decodes(reader)
        t0 = time.perf_counter()
        frames = [reader[k] for k in range(48)]
        seq_ms = 1e3 * (time.perf_counter() - t0) / 48
        assert calls[0] == 48 and all(f.shape == (1920, 1080, 3) for f in frames)
        cached = open_video(path, "cuda")
        decoded = count_decodes(cached)
        t0 = time.perf_counter()
        for k in order:
            got = load_frame(path, k, device="cuda")
            assert k >= 48 or np.array_equal(got, frames[k]), k
        rand_ms = 1e3 * (time.perf_counter() - t0) / len(order)
        reads.append(frames)
        log(f"[video] Motion-JPEG 1080x1920 {path.suffix[1:]}, {label}, {n} samples ({path.stat().st_size} "
            f"bytes): demux {min(demux):.2f} ms (best of 3), reader open {open_ms:.2f} ms, "
            f"sequential {seq_ms:.2f} ms a frame (48 frames), random load_frame {rand_ms:.2f} ms a "
            f"frame (the same 12 frames, {decoded[0] / len(order):.2f} samples decoded a read), "
            f"RGB on the card | on {card}")
    assert all(np.array_equal(a, b) for f in reads[1:] for a, b in zip(reads[0], f)), \
        "the fragmented files' frames differ from the flat file's"

def _video_main(fn, work: Path, card: str, writes: dict, conn) -> None:
    t0 = time.perf_counter()
    try:
        fn(work, card, writes)
    except BaseException:
        import traceback

        conn.send((traceback.format_exc(), time.perf_counter() - t0))
        raise
    conn.send((None, time.perf_counter() - t0))


class VideoProcess:
    """``fn`` (``video_checks`` or ``video_loads``) in a spawned process of
    its own, beside a card phase (``VideoPhase``): neither shares the host
    with a writer or with the other."""

    def __init__(self, fn, work: Path, card: str, writes: dict):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.name = fn.__name__
        self.conn, send = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(target=_video_main, args=(fn, work, card, writes, send))
        self.proc.start()
        send.close()
        self.seconds = self.waited = None

    def join(self) -> None:
        """Wait for the process (its own seconds in ``seconds``, the wait in
        ``waited``); raise with its traceback if it failed."""
        t0 = time.perf_counter()
        try:
            error, self.seconds = self.conn.recv()
        except EOFError:
            error = f"the process ended (code {self.proc.exitcode}) before reporting"
        self.proc.join()
        self.waited = time.perf_counter() - t0
        if error is not None:
            raise AssertionError(f"{self.name} failed:\n{error}")
        log(f"[timing] {self.name}: {self.seconds:.1f} s in a process of its own, waited "
            f"{self.waited:.1f} s for it")

    def stop(self) -> None:
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()


class VideoPhase:
    """The video phase in steps: the writes (``Writers``), then the checks
    and then the timed loads (``VideoProcess``), each step waiting for the
    one before. ``run_phases`` starts the writes after ``rasterize``, the
    checks after ``op_mix`` (beside ``smpl``) and the loads after ``smpl``
    (beside ``parallel``), so that their host work overlaps the card
    phases; with ``--serial-video`` every step runs after the last card
    phase with nothing beside it, which measures what the overlap costs the
    figures taken beside it (K4/K5/K7, the fit, the animation's FPS, the
    training steps, ``parallel``'s seconds, the video loads)."""

    def __init__(self, work: Path, card: str, background: list):
        self.work, self.card, self.background = work, card, background
        self.writers = self.writes = self.checks = self.loads = None

    def start_writes(self) -> None:
        self.writers = Writers(self.work / "video")
        self.background.append(self.writers)

    def start_checks(self) -> None:
        self.writes = self.writers.finish()
        self.checks = VideoProcess(video_checks, self.work, self.card, self.writes)
        self.background.append(self.checks)

    def start_loads(self) -> None:
        self.checks.join()
        self.loads = VideoProcess(video_loads, self.work, self.card, self.writes)
        self.background.append(self.loads)

    def finish(self) -> None:
        self.loads.join()

    def summary(self) -> str:
        w = self.writers
        return (f"{w.waited:.1f} s waiting on the stream writers, whose {len(w.futures)} writes "
                f"were all done {w.done_after:.1f} s after they started; the video checks took "
                f"{self.checks.seconds:.1f} s (waited {self.checks.waited:.1f} s), the timed loads "
                f"{self.loads.seconds:.1f} s (waited {self.loads.waited:.1f} s)")


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
    log(f"[quality] launches {launches} | dispatch {res['dispatch']}")
    assert all(math.isfinite(v) for v in res["holdout"].values()), res["holdout"]
    # the plain-compositor oracle launches no K4; 300 iterations (replayed
    # from the step's CUDA graph, and any a budget regrowth ran again), then
    # the evaluation, held-out and driving renders
    n_step = 300 + res["dispatch"]["rolled_back"]
    assert res["dispatch"]["graphed"] and res["dispatch"]["replays"] > 0, res["dispatch"]
    assert launches["gsplat_bwd"] == n_step and launches["gsplat_fwd"] >= n_step + 3 + 4, launches
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


# One train step from identical state, replayed from its CUDA graph against
# the same step run eagerly: the losses (relative) and every written tensor
# (relative norm). K5 adds with atomicAdd, so the eager step differs from
# itself in the last bits; the replay is held to that spread. On the H100
# (PERF.md §6) eager against eager measured up to 6.3e-6 (losses) and
# 3.5e-6 (state), the replay against eager up to 7.0e-6 and 1.1e-6
GRAPH_LOSS_REL_TOL = 1e-4
GRAPH_STATE_REL_TOL = 3e-5
# The budgeted pair build against the exact one at one view: K4's outputs
# bit for bit, the gradients through K5 within this (relative norm). On the
# H100 the exact build against itself measured up to 3.3e-7, the budgeted
# against the exact 3.3e-7 (PERF.md §6)
BUDGET_GRAD_REL_TOL = 1e-5


def budget_vs_exact(trainer, cam, budget: int, tag: str) -> None:
    """One view rendered with the exact pair build twice and with the pair
    budget once: the renders (K4) bit for bit, and the gradients of a fixed
    loss (K5) held to the exact build's own spread."""
    import torch

    from cap4d_torch.avatar import gaussians as G
    from cap4d_torch.ops.gsplat_tiles import rasterize_gaussians

    ct = trainer.camera_tensors(cam)
    with torch.no_grad():
        world = G.world_gaussians(trainer.gauss, trainer.aux,
                                  trainer.mesh_at_timestep(cam.timestep).face_pack)
    runs = []
    for b in (None, None, budget):
        leaves = [world[k].detach().clone().requires_grad_(True)
                  for k in ("means3d", "quats", "scales", "opacities", "sh")]
        out = rasterize_gaussians(*leaves, ct["rt"], ct["K"], cam.width, cam.height,
                                  sh_degree=trainer.active_sh_degree, budget=b)
        grads = torch.autograd.grad((out["render"] * ct["gt"]).sum(), leaves)
        runs.append((out["render"].detach(), out.get("n_overflow"), grads))
    assert int(runs[2][1]) == 0, int(runs[2][1])
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][0], runs[2][0]), tag
    spread, gap = rel_gap(runs[0][2], runs[1][2]), rel_gap(runs[0][2], runs[2][2])
    log(f"[{tag}] budget {budget} against the exact pair build: render bit-identical; "
        f"gradients exact vs exact {spread:.3e}, budgeted vs exact {gap:.3e} (bound "
        f"{BUDGET_GRAD_REL_TOL:g})")
    assert gap <= BUDGET_GRAD_REL_TOL, (gap, spread)


def rel_gap(a, b) -> float:
    """The largest relative gap over pairs of tensors: |a − b| / |a| by
    norm (0 where both are 0)."""
    import torch

    worst = 0.0
    for x, y in zip(a, b):
        x, y = x.double(), y.double()
        scale = float(torch.linalg.vector_norm(x))
        diff = float(torch.linalg.vector_norm(x - y))
        worst = max(worst, diff / scale if scale else diff)
    return worst


def graph_vs_eager(trainer, cams, tag: str, iteration: int = 301) -> dict:
    """From one state, one step on the camera with the most candidates: run
    eagerly twice (their spread), then captured and replayed, through
    ``StepGraphs``' lane step at the fit's probed budget; then a dispatch of
    ten replays, its device time by CUDA events against its wall time, and
    its profile. The trainer's state is put back afterwards."""
    import torch

    from cap4d_torch.avatar.step_compiler import StepGraphs, probe_budget
    from cap4d_torch.avatar.trainer import CameraBank

    bank = CameraBank.build(cams, trainer.device)
    for i, cam in enumerate(cams):     # the bank's uint8 images come back bit for bit
        got, ref = bank.camera(torch.tensor([i], device=trainer.device)), trainer.camera_tensors(cam)
        assert all(torch.equal(got[k], ref[k]) for k in ("rt", "K", "gt", "mask")), i
    budget = probe_budget(trainer, cams)
    counts = [int(trainer.candidate_count(c)) for c in cams]
    idx = max(range(len(cams)), key=counts.__getitem__)
    budget_vs_exact(trainer, cams[idx], budget, tag)
    start = [t.clone() for t in trainer.written_state()]

    def put_back():
        for s_, t in zip(start, trainer.written_state()):
            t.copy_(s_)

    def one(sg, lanes=1):
        put_back()
        losses = sg.run([idx] * lanes, iteration, iteration)
        return ([torch.as_tensor(v) for v in losses.values()],
                [t.clone() for t in trainer.written_state()])

    eager = StepGraphs(trainer, bank, budget, 1, graphs=False)
    graph = StepGraphs(trainer, bank, budget, 10, graphs=True)
    e1, e2 = one(eager), one(eager)
    one(graph)                                     # the eager first lane, then the capture
    g1 = one(graph)                                # replayed
    assert graph.captures == 1 and graph.replays == 1, (graph.captures, graph.replays)
    spread = (rel_gap(e1[0], e2[0]), rel_gap(e1[1], e2[1]))
    gap = (rel_gap(e1[0], g1[0]), rel_gap(e1[1], g1[1]))
    log(f"[{tag}] bank {tuple(bank.gt.shape)} {bank.gt.dtype} | one step from identical state "
        f"on camera {idx} ({counts[idx]} candidates, budget {budget}): eager vs eager losses {spread[0]:.3e}, state {spread[1]:.3e} | "
        f"replayed vs eager losses {gap[0]:.3e}, state {gap[1]:.3e} (bounds "
        f"{GRAPH_LOSS_REL_TOL:g}, {GRAPH_STATE_REL_TOL:g}) | capture {graph.capture_s:.2f} s, "
        f"launches a replay {graph.replay_launches}")
    assert gap[0] <= GRAPH_LOSS_REL_TOL and gap[1] <= GRAPH_STATE_REL_TOL, (gap, spread)

    # dispatches of 10 replays (snapshot, upload, replays, one fetch), timed
    # on the card by CUDA events around the replays and on the host around
    # the whole dispatch
    times = []
    for _ in range(3):
        put_back()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        graph.run([idx] * 10, iteration, iteration)
        ev[1].record()
        torch.cuda.synchronize()
        times.append((ev[0].elapsed_time(ev[1]) / 10, (time.perf_counter() - t0) * 1e3 / 10))
    log(f"[{tag}] dispatches of 10 replays, ms a step on the card (CUDA events) | wall: "
        + ", ".join(f"{d:.3f} | {w:.3f} (busy {100 * d / w:.0f}%)" for d, w in times))
    put_back()
    profile_breakdown(lambda: graph.run([idx] * 10, iteration, iteration),
                      f"{tag} dispatch of 10 replays profile")
    put_back()
    graph.close()
    return {"spread": spread, "gap": gap, "times": times}


def fit_summary(tag: str, model_path: Path, trainer, wall: float, launches, card: str) -> dict:
    """The fit's metrics.jsonl read back: s per iteration over iterations
    20-300, the evaluations, and the dispatcher's counters, logged."""
    import json as _json

    lines = [_json.loads(l) for l in open(model_path / "metrics.jsonl")]
    steps = {l["iter"]: l for l in lines if "loss" in l}
    evals = [l for l in lines if "val/psnr" in l or "test/psnr" in l]
    assert all(math.isfinite(l["loss"]) for l in steps.values()), "non-finite fit loss"
    assert (model_path / "chkpnt300.pth").exists() and evals, "no checkpoint / evaluation"
    assert steps[190]["n_active"] != steps[210]["n_active"], "densification changed nothing"
    s_per_it = (steps[300]["elapsed_s"] - steps[20]["elapsed_s"]) / 280
    g = trainer.step_graphs
    disp = ("per-step eager" if g is None else
            f"{g.captures} captures ({g.capture_s:.2f} s), {g.replays} replays, pair budget "
            f"{g.budget}, regrowths {g.regrowths}, {g.rolled_back} iterations rolled back")
    log(f"[{tag}] 300 iterations, wall {wall:.1f} s | {s_per_it:.4f} s per iteration over "
        f"iterations 20-300 ({1 / s_per_it:.2f} it/s) | splats {steps[20]['n_active']} -> "
        f"{steps[300]['n_active']} | loss {steps[10]['loss']:.4f} -> {steps[300]['loss']:.4f} | "
        f"{disp} | {evals} | on {card}")
    log(f"[{tag}] launches {launches}")
    return {"s_per_it": s_per_it, "wall": wall, "evals": evals,
            "rolled_back": 0 if g is None else g.rolled_back}


def phase_fit(work: Path, stage1_out: Path, flame_dir: Path, kernels, card: str):
    """Stage 2 through ``training()``: the counted fit, chunked as by default
    (CUDA graphs), then the same fit per step (``chunked=False``), each
    counted; returns the graphed fit's model path and both runs' launches."""
    import torch

    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_torch.avatar.train import training

    model, opt = avatar_params()
    sources = [str(stage1_out / "reference_images"), str(stage1_out / "generated_images")]
    scene = load_cap4d_dataset(sources)
    n_eval = min(len(scene.val_cameras), 10) + min(len(scene.test_cameras), 10)
    runs = {}
    for tag, chunked in (("fit", None), ("fit eager", False)):
        model_path = work / ("avatar" if chunked is None else "avatar_eager")
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        trainer = training(sources, model_path, model, opt, testing_iterations=[300],
                           checkpoint_iterations=[300], flame_asset_dir=flame_dir,
                           chunked=chunked)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        res = fit_summary(tag, model_path, trainer, wall, launches, card)
        # 300 iterations (and the iterations a budget regrowth ran again), then
        # the evaluation renders
        n_step = 300 + res["rolled_back"]
        assert launches["gsplat_bwd"] == n_step, launches
        assert launches["gsplat_fwd"] == n_step + n_eval, launches
        assert launches["rasterize"] > 0, launches
        g = trainer.step_graphs
        assert (g is not None and g.graphs and g.replays > 0) == (chunked is None), tag
        runs[tag] = (trainer, launches, res)
        if chunked is not None:
            del trainer
            torch.cuda.empty_cache()
    trainer, _, res = runs["fit"]
    log(f"[fit] graphed | eager: {res['s_per_it']:.4f} | {runs['fit eager'][2]['s_per_it']:.4f} "
        f"s per iteration, wall {res['wall']:.1f} | {runs['fit eager'][2]['wall']:.1f} s, "
        f"psnr {[l.get('val/psnr') for l in res['evals']]} | "
        f"{[l.get('val/psnr') for l in runs['fit eager'][2]['evals']]} | on {card}")
    check_eval_renders(trainer, scene, res["evals"])
    graph_vs_eager(trainer, scene.train_cameras, "fit")
    # one more iteration and one evaluation render, outside the counted run
    cam = scene.train_cameras[0]
    profile_breakdown(lambda: trainer.train_step(cam, 301, 301), "fit iteration profile")
    profile_breakdown(lambda: trainer.render_camera(cam, cam.timestep, clip=True),
                      "render profile")
    launches = [runs["fit"][1], runs["fit eager"][1]]
    del trainer, runs
    return work / "avatar", launches


def animation_runs(tag: str, run, out: Path, kernels, card: str, frames: int, size: str) -> dict:
    """``run(out, graphs=...)`` (a ``render_sequence``) counted and graphed
    as by default, then eagerly (not counted) and graphed without PNG
    writes: FPS each way, the replayed frame's device ms and the busy share
    of the graphed loop's frames by CUDA events, the pair budget and its
    regrowths; every PNG and the PLY of the graphed run byte-identical to
    the eager run's. Then, not timed against anything, graphed runs under
    torch.profiler (four frames' kernels against their span) and under
    cProfile (the loop's host time by function). Returns the counted run's
    launches."""
    from cap4d_torch.avatar import animate as animate_mod
    from cap4d_torch.avatar.render_graph import FrameGraph
    from cap4d_torch.utils.plyio import read_ply

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with timed_calls(FrameGraph, "launch") as timer:
        res = run(out, None)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    fg, frames_t = res["frame_graphs"], timer.summary()
    pngs = sorted((out / "frames").glob("*.png"))
    assert res["frames"] == frames and len(pngs) == frames, (res, len(pngs))
    ply = read_ply(out / "exported_animation.ply")
    assert f"delta_vertex_{frames - 1:05d}" in ply, sorted(ply)[:5]
    assert fg["graphed"] and fg["captures"] == 1 + len(fg["regrowths"]), fg
    assert fg["replays"] == frames + fg["rerendered"] - fg["captures"], fg
    # K4 once a frame, through the replays; the template's UV layout once (K3)
    assert launches["gsplat_fwd"] == frames + fg["rerendered"], launches
    eager_out = out.parent / (out.name + "_eager")
    t0 = time.perf_counter()
    eager = run(eager_out, False)
    eager_wall = time.perf_counter() - t0
    assert not eager["frame_graphs"]["graphed"]
    for png in pngs:
        assert png.read_bytes() == (eager_out / "frames" / png.name).read_bytes(), \
            f"{tag}: graphed {png.name} differs from the eager loop's"
    ply_name = "exported_animation.ply"
    if (out / ply_name).read_bytes() != (eager_out / ply_name).read_bytes():
        raise AssertionError(f"{tag}: the graphed PLY differs from the eager loop's: "
                             + ply_diff(out / ply_name, eager_out / ply_name))
    write_png = animate_mod.write_png
    animate_mod.write_png = lambda path, img: None
    try:
        with timed_calls(FrameGraph, "launch") as bare_timer:
            bare = run(out.parent / (out.name + "_nopng"), None)
    finally:
        animate_mod.write_png = write_png
    bare_t = bare_timer.summary()
    with timed_calls(FrameGraph, "launch", window=(10, 4)) as prof_timer:
        run(out.parent / (out.name + "_profiled"), None)
    host = cProfile.Profile()
    host.enable()
    hosted = run(out.parent / (out.name + "_cprofile"), None)
    host.disable()
    stats = pstats.Stats(host)
    top = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:10]
    log(f"[{tag}] host seconds by function (cProfile, self time; the loop "
        f"{hosted['render_s']:.2f} s): " + ", ".join(
            f"{fn[2]} ({Path(fn[0]).name}:{fn[1]}) {st[2]:.3f}" for fn, st in top))
    log(f"[{tag}] {frames} frames at {size}, graphed | eager: render loop "
        f"{res['render_s']:.2f} | {eager['render_s']:.2f} s = {frames / res['render_s']:.2f} | "
        f"{frames / eager['render_s']:.2f} FPS (PNG writes and PLY vertex capture included), "
        f"graphed without PNG writes {frames / bare['render_s']:.2f} FPS | replayed frames: "
        f"{frames_t['n']} after the first, {shown(frames_t['unit_ms'])} each on the card, busy "
        f"{100 * frames_t['busy']:.1f} % of their span ({shown(frames_t['span_ms'])}); "
        f"without PNG writes {shown(bare_t['unit_ms'])} each, busy "
        f"{100 * bare_t['busy']:.1f} % of {shown(bare_t['span_ms'])}; "
        f"{prof_timer.profiled()} | frame "
        f"graph {fg} | every PNG and the PLY byte-identical to the eager loop's | wall "
        f"{wall:.1f} | {eager_wall:.1f} s | on {card}")
    log(f"[{tag}] launches {launches}")
    return launches


def fresh_avatar(work: Path):
    """A freshly initialised full-width head avatar (``configs/avatar/
    default.yaml`` model_params on phase 6's reference camera) written as an
    iteration-0 checkpoint with its config: what the animate phase drives
    when the fit did not run. Returns (model path, FLAME asset dir)."""
    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_torch.avatar.trainer import AvatarTrainer
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.config import dump_yaml

    stage1_out = reference_stage1(work)
    model, opt = avatar_params()
    flame_dir = sa.make_asset_dir(work / "avatar_assets", sphere_radius=0.09)
    scene = load_cap4d_dataset([str(stage1_out / "reference_images")])
    trainer = AvatarTrainer.create(scene, model, opt, flame_asset_dir=flame_dir)
    trainer.active_sh_degree = model["sh_degree"]
    path = work / "fresh_avatar"
    path.mkdir()
    dump_yaml({"model_params": model, "opt_params": opt}, path / "config_dump.yaml")
    trainer.save_checkpoint(path, 0)
    log(f"[animate] no fit in this run: a fresh avatar of {trainer.n_active} splats")
    return path, flame_dir


def phase_animate(work: Path, model_path: Path, flame_dir: Path, kernels, card: str):
    from cap4d_torch.avatar.animate import render_sequence
    from cap4d_torch.utils import synthetic_assets as sa

    drv = sa.make_driving_sequence(work, n_frames=48, resolution=512)
    return animation_runs(
        "animate", lambda out, graphs: render_sequence(
            model_path, drv, out, flame_asset_dir=str(flame_dir), compress_ply=True,
            graphs=graphs),
        work / "animation", kernels, card, 48, "512x512")


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
    graph = state.step_graph.counters()
    log(f"[train] {n_params} UNet parameters | losses {losses} | step 1 (warm-up and capture) "
        f"{elapsed[1]:.3f} s | steps 2-3: {s_step:.4f} s per optimizer step, "
        f"{s_step / accum:.4f} s per micro-batch ({accum} micro-batches a step) | micro-batch "
        f"graph {graph} | peak {peak:.2f} GiB allocated | wall {wall:.1f} s with set-up, image "
        f"log and checkpoint | on {card}")
    micro = accum * cuts["n_steps"]
    # the first micro-batch warms up, then one capture; the rest are replays
    assert graph["graphed"] and graph["captures"] == 1 and graph["replays"] == micro - 1, graph

    n_attn = sum(isinstance(m, AttentionModule) for m in unet.modules())
    n_gn = sum(isinstance(m, GroupNorm32) for m in unet.modules())
    n_ddim = len(make_ddim_timesteps(10, 1000))
    # remat runs every attention and every GroupNorm but the last one twice;
    # the image log's DDIM runs 10 forwards without gradients; a replay adds
    # what its capture launched
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

    del state, unet
    torch.cuda.empty_cache()
    train_graph_vs_eager(cfg_path, flame_dir, accum, card)
    return launches


# a graphed training step against an eager one from identical state (bf16
# compute, signal weights): the mean loss, and the parameters' update
# ||ΔP_graph − ΔP_eager|| / ||ΔP_eager||. The forward that sets the loss
# does not depend on K6's atomic dQ, and the loss came out bit-identical;
# the update does: eager against eager differed by 3.0e-5–3.6e-5 and
# graphed against eager by 3.1e-5–4.5e-5 (H100, PERF.md §6). The eager
# spread is measured again beside each check
TRAIN_GRAPH_LOSS_REL_TOL = 1e-5
TRAIN_GRAPH_UPDATE_REL_TOL = 2e-4
# the stale-weight check's update is made with this learning rate, so that
# the weights' bf16 casts before and after it differ
STALE_CHECK_LR = 1e-2


def signal_mmdm(cfg_path: Path, flame_dir: Path, device="cuda"):
    """The MMDM of a training config for training on ``device``: fp32
    parameters on signal weights (norm scales near 1), bf16 compute, remat."""
    import torch

    import cap4d_torch.mmdm.model as mmdm_model
    from cap4d_torch.mmdm.model import MMDM
    from cap4d_torch.utils.config import load_yaml

    saved, mmdm_model.init_random_ = mmdm_model.init_random_, signal_init_
    try:
        return MMDM.from_config(load_yaml(cfg_path), flame_asset_dir=flame_dir,
                                dtype=torch.bfloat16, device=device, remat=True, trainable=True)
    finally:
        mmdm_model.init_random_ = saved


def first_update_(state, seed: int = 7) -> None:
    """One AdamW update from seeded random gradients: an update from fresh
    moments is about lr·sign(g), which turns the last bits of a near-zero
    gradient into a whole step; after it the updates are smooth in the
    gradient."""
    import torch

    params = list(state.unet.parameters())
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device=p.device)
    state.optimizer.step()


def train_graph_vs_eager(cfg_path: Path, flame_dir: Path, accum: int, card: str) -> None:
    """``make_accum_train_step`` graphed against eager at full width, from
    identical state (parameters and AdamW moments put back, the same
    generator seed): eager against eager (the spread), the first graphed
    step (warm-up, capture, replays) and an all-replayed one against eager;
    then a replayed step after an AdamW update against an eager step from
    the same state (stale bf16 weight casts would show), beside the gap such
    casts would make. Then s per optimizer step graphed | eager, the card's
    busy share over replayed steps by CUDA events, a loop of graphed steps
    with the dataset's draws staged by ``BatchStager`` (a fetch every step
    against one at the end), profiles of both steps, and the AdamW
    update alone."""
    import numpy as np
    import torch

    from cap4d_torch.mmdm.train import BatchStager, SyntheticMMDMDataset, make_accum_train_step
    from cap4d_torch.mmdm.training import init_train_state

    model = signal_mmdm(cfg_path, flame_dir)
    state = init_train_state(model.unet, 1e-4)
    params = list(model.unet.parameters())
    first_update_(state)
    steps = {g: make_accum_train_step(model, state.optimizer, accum,
                                      cfg_probability=model.cfg_probability, graphs=g)
             for g in (False, True)}
    data = SyntheticMMDMDataset(model, n_views=model.n_frames, n_ref=4, seed=1).batches(1)
    stacks = []
    for _ in range(2):
        micro = [next(data) for _ in range(accum)]
        stacks.append((torch.as_tensor(np.stack([m["z"] for m in micro]), device="cuda"),
                       {k: torch.as_tensor(np.stack([m["cond"][k] for m in micro]),
                                           device="cuda") for k in micro[0]["cond"]}))

    def snapshot():
        return ([p.detach().clone() for p in params],
                [{k: v.clone() for k, v in state.optimizer.state[p].items()} for p in params])

    def restore(snap):
        with torch.no_grad():
            for p, s_, st in zip(params, *snap):
                p.copy_(s_)
                for k, v in st.items():
                    state.optimizer.state[p][k].copy_(v)

    def run(graphed: bool, which: int, seed: int) -> float:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        loss = float(steps[graphed](state, *stacks[which], gen))
        assert math.isfinite(loss), loss
        return loss

    def update_gap(ref, start) -> float:
        """||P − ref|| / ||ref − start|| over every parameter."""
        num = den = 0.0
        for p, r, s_ in zip(params, ref, start):
            num += float((p.detach() - r).float().norm()) ** 2
            den += float((r - s_).float().norm()) ** 2
        return math.sqrt(num / den)

    rel = lambda a, b: abs(a - b) / abs(b)
    s0 = snapshot()
    l_e = run(False, 0, 11)
    p_e = [p.detach().clone() for p in params]
    restore(s0)
    spread = (rel(run(False, 0, 11), l_e), update_gap(p_e, s0[0]))
    gaps = {}
    for label in ("first graphed step (warm-up, capture, 3 replays)", "replayed step"):
        restore(s0)
        gaps[label] = (rel(run(True, 0, 11), l_e), update_gap(p_e, s0[0]))
    counters = steps[True].graph.counters()
    log(f"[train graph] one step of {accum} micro-batches from identical state (signal "
        f"weights, cfg_probability {model.cfg_probability}): eager vs eager loss "
        f"{spread[0]:.3e}, update {spread[1]:.3e} | " + " | ".join(
            f"{k} vs eager loss {g[0]:.3e}, update {g[1]:.3e}" for k, g in gaps.items())
        + f" (bounds {TRAIN_GRAPH_LOSS_REL_TOL:g}, {TRAIN_GRAPH_UPDATE_REL_TOL:g}) | {counters}, "
        f"launches a replay {steps[True].graph.replay_launches}")
    assert counters["captures"] == 1 and counters["replays"] == 2 * accum - 1, counters
    for g in gaps.values():
        assert g[0] <= TRAIN_GRAPH_LOSS_REL_TOL and g[1] <= TRAIN_GRAPH_UPDATE_REL_TOL, (gaps,
                                                                                         spread)

    # stale weights: a replayed step after an AdamW update (made by a replayed
    # step at STALE_CHECK_LR) against an eager step from the same state
    restore(s0)
    del p_e
    state.optimizer.param_groups[0]["lr"] = STALE_CHECK_LR
    run(True, 0, 11)
    state.optimizer.param_groups[0]["lr"] = 1e-4
    s1 = snapshot()
    l_g = run(True, 1, 12)
    p_g = [p.detach().clone() for p in params]
    restore(s1)
    l_e1 = run(False, 1, 12)
    stale_gap = (rel(l_g, l_e1), update_gap(p_g, s1[0]))
    del p_g
    restore(s0)
    l_stale = run(False, 1, 12)    # the loss that the update's old weights give
    log(f"[train graph] after an AdamW update at lr {STALE_CHECK_LR:g}: replayed vs eager loss "
        f"{stale_gap[0]:.3e}, update {stale_gap[1]:.3e}; stale weight casts would show a "
        f"loss gap of {rel(l_stale, l_e1):.3e} | on {card}")
    assert stale_gap[0] <= TRAIN_GRAPH_LOSS_REL_TOL, stale_gap
    assert stale_gap[1] <= TRAIN_GRAPH_UPDATE_REL_TOL, stale_gap
    assert rel(l_stale, l_e1) >= 100 * TRAIN_GRAPH_LOSS_REL_TOL, (l_stale, l_e1)
    del s0, s1
    torch.cuda.empty_cache()

    # s per optimizer step graphed | eager in turns, each step alone
    times = {False: [], True: []}
    for graphed in (False, True, True, False, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(graphed, 0, 13)
        times[graphed].append(time.perf_counter() - t0)
    # the card's busy share: a replayed step's device time by CUDA events,
    # enqueued while a sleep kernel holds the stream, against the step's
    # wall time above. The events see idle time only where the host falls
    # behind the card inside the step
    hold_ms = 300.0
    cycles = int(hold_ms * 1e-3 * sm_clock_hz())
    device_ms, enqueue_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        ev[0].record()
        steps[True](state, *stacks[0], torch.Generator(device="cuda").manual_seed(13))
        ev[1].record()
        enqueue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        device_ms.append(ev[0].elapsed_time(ev[1]))
    # how far the host gets ahead: three replays of the graph, back to back,
    # launched while the stream is held (their gradients are thrown away)
    graph = steps[True].graph.graph
    torch.cuda.synchronize()
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    for _ in range(3):
        graph.replay()
    launch_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wall_ms = 1e3 * min(times[True])
    log(f"[train graph] s per optimizer step of {accum} micro-batches (graphed | eager, in "
        f"turns): {', '.join(f'{t:.4f}' for t in times[True])} | "
        f"{', '.join(f'{t:.4f}' for t in times[False])} | a replayed step on the card "
        f"(CUDA events, the stream held {hold_ms:.0f} ms while it is enqueued): "
        f"{', '.join(f'{d:.2f}' for d in device_ms)} ms, enqueued in "
        f"{', '.join(f'{e:.2f}' for e in enqueue_ms)} ms; busy "
        f"{100 * min(device_ms) / wall_ms:.0f}% of the fastest graphed step's wall "
        f"({wall_ms:.2f} ms) | three back-to-back replays launched in {launch_ms:.2f} ms "
        f"with the stream held | on {card}")
    # the training loop's own overlap: BatchStager draws the next step on its
    # worker while the card replays this one; a fetch every step, as
    # train_mmdm logs here, against one at the end
    gen = torch.Generator(device="cuda").manual_seed(14)
    loop_s = {}
    for fetch_each in (True, False, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with BatchStager(data, accum, "cuda", 3) as stage:
            for _ in range(3):
                loss = steps[True](state, *stage.next(), gen)
                if fetch_each:
                    float(loss)
        float(loss)
        loop_s.setdefault(fetch_each, []).append((time.perf_counter() - t0) / 3)
    log(f"[train graph] loop of 3 graphed steps with the synthetic dataset's draws, staged "
        f"by BatchStager, s a step: the loss fetched every step "
        f"{', '.join(f'{t:.4f}' for t in loop_s[True])} | once at the end "
        f"{', '.join(f'{t:.4f}' for t in loop_s[False])} | on {card}")
    profile_breakdown(lambda: run(True, 0, 13), "train step profile, graphed")
    profile_breakdown(lambda: run(False, 0, 13), "train step profile, eager")
    n_params = sum(p.numel() for p in params)
    adamw_ms = time_ms(lambda: state.optimizer.step(), iters=3, warmup=1)
    log(f"[train] AdamW update over {n_params} fp32 parameters: {adamw_ms:.3f} ms")
    del state, model, steps, stacks
    torch.cuda.empty_cache()


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
    avatar, ``train_fullbody`` (300 iterations) graphed and per step, the
    replayed step against the eager one, ``render_sequence_smpl`` of the
    graphed fit's checkpoint on the 48-frame wave; returns the three runs'
    launches."""
    import numpy as np
    import torch

    from cap4d_torch.avatar.animate_smpl import load_trained_smpl_avatar, render_sequence_smpl
    from cap4d_torch.avatar.train_fullbody import SMPL_DISABLED_REGULARIZERS, train_fullbody
    from cap4d_torch.avatar.trainer import AvatarTrainer
    from cap4d_torch.smpl.scene import load_smpl_dataset
    from cap4d_torch.tools.generate_animation import make_wave_animation
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.config import dump_yaml

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
    n_eval = len(scene.val_cameras[:10]) + len(scene.test_cameras[:10])
    runs = {}
    for tag, chunked in (("smpl fit", None), ("smpl fit eager", False)):
        model_path = root / ("avatar" if chunked is None else "avatar_eager")
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        trainer = train_fullbody([str(data)], model_path, cfg, interval=300,
                                 smpl_asset_dir=smpl_dir, chunked=chunked)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        res = fit_summary(tag, model_path, trainer, wall, launches, card)
        n_step = 300 + res["rolled_back"]
        assert launches["gsplat_bwd"] == n_step, launches
        assert launches["gsplat_fwd"] == n_step + n_eval, launches
        assert launches["rasterize"] == 1, launches      # the template's UV layout
        assert all(math.isfinite(l.get("val/psnr", 0.0)) for l in res["evals"]), res["evals"]
        g = trainer.step_graphs
        assert (g is not None and g.graphs and g.replays > 0) == (chunked is None), tag
        runs[tag] = (trainer, launches, res)
        if chunked is not None:
            del trainer
            torch.cuda.empty_cache()
    trainer, fit_launches, res = runs["smpl fit"]
    eager_launches, eager_res = runs["smpl fit eager"][1:]
    log(f"[smpl fit] graphed | eager: {res['s_per_it']:.4f} | {eager_res['s_per_it']:.4f} s per "
        f"iteration, wall {res['wall']:.1f} | {eager_res['wall']:.1f} s | on {card}")
    model_path = root / "avatar"
    graph_vs_eager(trainer, scene.train_cameras, "smpl fit")
    cam = scene.train_cameras[0]
    profile_breakdown(lambda: trainer.train_step(cam, 301, 301), "smpl fit iteration profile")
    del trainer, runs
    torch.cuda.empty_cache()

    anim = root / "wave.npz"
    np.savez(anim, **make_wave_animation(48, (1080, 1080)))
    out = root / "animation"
    anim_launches = animation_runs(
        "smpl animate", lambda o, graphs: render_sequence_smpl(
            model_path, anim, o, smpl_asset_dir=smpl_dir, compress_ply=True, graphs=graphs),
        out, kernels, card, 48, "1080x1080")
    mp4 = out / "renders.mp4"
    log(f"[smpl animate] mp4 {mp4.stat().st_size if mp4.exists() else 'not written'} bytes "
        f"(ffmpeg {'found' if shutil.which('ffmpeg') else 'absent'})")
    assert anim_launches["rasterize"] == 1, anim_launches
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
    return fit_launches, eager_launches, anim_launches


# ---------------------------------------- several cards: cap4d_torch.parallel ----

# z_gen of stage 1 on two ranks against one process, both at groups_per_device
# 2 (bf16, signal weights, the same initial latents): each rank's UNet call
# holds the groups one process's round holds, so the two agree bit for bit
# unless the processes' convolution or GEMM algorithms differ
DP_REL_TOL = 0.0
# training on two ranks against one process (bf16 compute; see
# phase_parallel (d)): the first step's all-reduced gradient norm, and the
# second step's loss and gradient norm. One process run twice differed from
# itself by up to 2.43e-5 and 3.49e-4 there, two ranks by up to 5.91e-6 and
# 1.56e-4 (H100, PERF.md §6)
DP_GRAD_REL_TOL = 1e-4
DP_STEP2_REL_TOL = 1e-3


def torch_flags() -> None:
    """TF32 off for fp32 matmuls and convolutions, in this process and in
    every rank it starts (the ranks are compared with this process)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def port_kernels():
    from cap4d_torch.ops import flash_attention, gsplat_tiles, norms, op_mix, rasterize

    return [flash_attention.KERNEL, norms.KERNEL, rasterize.KERNEL, gsplat_tiles.KERNEL_FWD,
            gsplat_tiles.KERNEL_BWD, flash_attention.KERNEL_BWD, op_mix.KERNEL]


def counted(kernels, fn):
    """(fn's result, the launches it made, its seconds, its peak GiB)."""
    import torch

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k.name: k.launches for k in kernels}, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def nccl_rank(dp):
    """NCCL on the card: three tensors (16 MB) averaged in two buckets, then
    a barrier; over one rank the mean leaves them as they were."""
    import torch

    from cap4d_torch.parallel import all_reduce_mean_, barrier

    gen = torch.Generator(device=dp.device).manual_seed(3)
    ts = [torch.randn(n, generator=gen, device=dp.device) for n in (3_000_000, 1_000_000, 5)]
    ref = [t.clone() for t in ts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moved = all_reduce_mean_(ts, dp, bucket_bytes=8 * 2**20)
    barrier(dp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    assert all(torch.equal(a, b) for a, b in zip(ts, ref)), "the mean over one rank changed"
    return {"backend": dp.backend, "nccl": str(torch.cuda.nccl.version()), "bytes": moved,
            "s": seconds}


def dp_stage1(dp, a, cfg, noise, out):
    """``run_generation`` on signal weights at groups_per_device 2 over the
    ranks of ``dp`` (None: this process alone); returns z_gen."""
    import torch

    import cap4d_torch.mmdm.model as mmdm_model
    from cap4d_torch.inference.generate_images import run_generation

    saved, mmdm_model.init_random_ = mmdm_model.init_random_, signal_init_
    try:
        return run_generation(cfg, a.ref_dir, out, allow_random_weights=True,
                              flame_asset_dir=a.flame_dir, dtype=torch.bfloat16,
                              init_noise=noise, groups_per_device=2, dp=dp)["z_gen"]
    finally:
        mmdm_model.init_random_ = saved


def dp_train(dp, cfg_path: Path, flame_dir: Path, steps: int = 2, accum: int = 4) -> dict:
    """``make_accum_train_step`` at full width (signal weights, bf16 compute,
    remat) over the ranks of ``dp`` (None: this process alone): ``steps``
    AdamW steps of ``accum`` micro-batches from the synthetic dataset with
    injected timesteps and noise (cfg_probability 0, so no mask draw), after
    one update from seeded random gradients (as the CPU tests carry a JAX
    TrainState one update past init).
    Returns the losses, the gradient norms after the all-reduce, a checksum
    of the parameters' bytes, and the gradient all-reduce alone, timed."""
    import hashlib

    import numpy as np
    import torch

    from cap4d_torch.mmdm.train import SyntheticMMDMDataset, make_accum_train_step
    from cap4d_torch.mmdm.training import all_reduce_grads_, init_train_state
    from cap4d_torch.mmdm.unet import AttentionModule, GroupNorm32
    from cap4d_torch.parallel import local_dp
    from cap4d_torch.utils.config import load_yaml

    dp = local_dp(dp, "cuda")
    dev = dp.device
    config = load_yaml(cfg_path)
    model = signal_mmdm(cfg_path, flame_dir, dev)
    state = init_train_state(model.unet, float(config["learning_rate"]))
    params = list(model.unet.parameters())
    first_update_(state)
    step_fn = make_accum_train_step(model, state.optimizer, accum, cfg_probability=0.0, dp=dp)
    data = SyntheticMMDMDataset(model, n_views=model.n_frames, n_ref=int(config["n_ref"]),
                                seed=0).batches(1)
    losses, norms = [], []
    for s in range(steps):
        micro = [next(data) for _ in range(accum)]
        z = torch.as_tensor(np.stack([m["z"] for m in micro]), device=dev)
        cond = {k: torch.as_tensor(np.stack([m["cond"][k] for m in micro]), device=dev)
                for k in micro[0]["cond"]}
        gen = torch.Generator(device=dev).manual_seed(1000 + s)
        t = torch.randint(0, model.schedule.num_timesteps, z.shape[:3], generator=gen, device=dev)
        noise = torch.randn(z.shape, generator=gen, device=dev)
        losses.append(float(step_fn(state, z, cond, None, t_stack=t, noise_stack=noise)))
        norms.append(float(torch.linalg.vector_norm(
            torch.stack([p.grad.norm() for p in params if p.grad is not None]))))
    digest = hashlib.sha256()
    for p in params:
        digest.update(p.detach().cpu().numpy().tobytes())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moved = all_reduce_grads_(params, dp)
    torch.cuda.synchronize()
    return {"losses": losses, "grad_norms": norms, "checksum": digest.hexdigest(),
            "allreduce_bytes": moved, "allreduce_s": time.perf_counter() - t0,
            "n_params": sum(p.numel() for p in params), "graph": step_fn.graph.counters(),
            "n_attn": sum(isinstance(m, AttentionModule) for m in model.unet.modules()),
            "n_gn": sum(isinstance(m, GroupNorm32) for m in model.unet.modules())}


def ply_diff(a: Path, b: Path) -> str:
    """The elements and fields of two PLY files that differ, with the most
    they differ by."""
    import numpy as np

    from cap4d_torch.utils.plyio import read_ply

    pa, pb = read_ply(a), read_ply(b)
    out = []
    for el in pa:
        for f in pa[el].dtype.names:
            x, y = pa[el][f].astype(np.float64), pb[el][f].astype(np.float64)
            if x.shape != y.shape or not np.array_equal(x, y):
                d = np.abs(x - y) if x.shape == y.shape else None
                out.append(f"{el}.{f}: " + ("shapes differ" if d is None else
                                            f"{int((d > 0).sum())} values, max {d.max():.3g}"))
    return "; ".join(out) if out else "equal values"


def parallel_rank(dp, a, cfg, noise, anim, train_cfg):
    """One rank of the two sharing the card: stage 1's group split, the
    animation's frame split, training's data-parallel step, each counted."""
    import torch

    from cap4d_torch.avatar.animate import render_sequence

    torch_flags()
    kernels = port_kernels()
    out = {"stage1": counted(kernels, lambda: dp_stage1(dp, a, cfg, noise, a.root / "dp_world2"))}
    torch.cuda.empty_cache()
    out["animate"] = counted(kernels, lambda: render_sequence(
        anim.model_path, anim.drv, anim.out, flame_asset_dir=str(anim.flame_dir),
        compress_ply=True, dp=dp))
    torch.cuda.empty_cache()
    out["train"] = counted(kernels, lambda: dp_train(dp, train_cfg, a.flame_dir))
    return out


def phase_parallel(work: Path, model_path: Path, flame_dir: Path, kernels, card: str):
    """Several cards through ``cap4d_torch.parallel`` on the one card there
    is: NCCL at world 1; two ranks sharing the card over gloo for stage 1's
    group split, the animation's frame split and training's data-parallel
    step, each against this process alone; stage 1's CLI under
    ``torch.distributed.run``. Returns the ranks' launch counts."""
    import numpy as np
    import torch

    from cap4d_torch.parallel import spawn
    from cap4d_torch.utils.config import dump_yaml, load_yaml

    t_phase = time.perf_counter()
    log("[parallel] compute mode " + subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"], capture_output=True,
        text=True, check=True, timeout=60).stdout.strip())
    # (a) NCCL at world 1; NCCL asked for two ranks on the one card raises
    (nccl,) = spawn(nccl_rank, 1, "cuda", backend="nccl", timeout_s=300)
    assert nccl["backend"] == "nccl", nccl
    log(f"[parallel] NCCL {nccl['nccl']} at world 1: {nccl['bytes']} bytes all-reduced in 2 "
        f"buckets + a barrier in {nccl['s']:.4f} s")
    try:
        spawn(nccl_rank, 2, "cuda", backend="nccl", timeout_s=300)
    except Exception as e:      # the rank's ValueError, raised here with its traceback
        assert "NCCL refuses two ranks on one device" in str(e), e
    else:
        raise AssertionError("NCCL accepted two ranks on one card")
    log("[parallel] NCCL for two ranks on one card: refused (the rank raised, spawn raised)")

    # one process: stage 1 (the debug config cut to 2 DDIM steps) and training
    a = stage1_assets(work)
    cfg2 = a.root / "gen_config_2steps.yaml"
    dump_yaml(dict(load_yaml(a.cfg), n_ddim_steps=2), cfg2)
    gen = torch.Generator(device="cuda").manual_seed(124)
    noise = {"encode": torch.randn((1, 64, 64, 4), generator=gen, device="cuda").cpu().numpy(),
             "x_bank": torch.randn((a.n_samples, 64, 64, 4), generator=gen,
                                   device="cuda").cpu().numpy()}
    z1, _, s1_s, s1_peak = counted(kernels, lambda: dp_stage1(None, a, cfg2, noise,
                                                               a.root / "dp_world1"))
    torch.cuda.empty_cache()
    train_cfg = work / "parallel" / "train_config.yaml"
    train_cfg.parent.mkdir()
    dump_yaml(load_yaml(REPO / "configs" / "mmdm" / "cap4d_mmdm_final.yaml"), train_cfg)
    t1, _, t1_s, t1_peak = counted(kernels, lambda: dp_train(None, train_cfg, a.flame_dir))
    # one process's own spread: one more run against the first (one, not
    # two, to keep the script's time; nothing asserts on it)
    t1_again = [dp_train(None, train_cfg, a.flame_dir)]
    torch.cuda.empty_cache()
    log(f"[parallel] one process: stage 1 {s1_s:.1f} s (peak {s1_peak:.2f} GiB), training "
        f"2 steps of 4 micro-batches {t1_s:.1f} s (peak {t1_peak:.2f} GiB)")

    # (b)-(d): two ranks on the card over gloo
    anim = SimpleNamespace(model_path=model_path, drv=work / "driving" / "fit.npz",
                           out=work / "animation_dp", flame_dir=flame_dir)
    t0 = time.perf_counter()
    ranks = spawn(parallel_rank, 2, "cuda", a, cfg2, noise, anim, train_cfg, timeout_s=900)
    spawn_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        log(f"[parallel] rank {r}: " + " | ".join(
            f"{path} {res[path][2]:.1f} s, peak {res[path][3]:.2f} GiB, launches {res[path][1]}"
            for path in ("stage1", "animate", "train")))

    # (b) stage 1: rank 0 wrote the files, both ranks hold the same latents
    z2 = [res["stage1"][0] for res in ranks]
    assert np.array_equal(z2[0], z2[1]), "the ranks' z_gen differ"
    same = bool(np.array_equal(z2[0], z1))
    rel = float(np.linalg.norm(z2[0] - z1) / np.linalg.norm(z1))
    log(f"[parallel] stage 1, 2 ranks x 2 groups a call vs one process at 2: z_gen "
        f"{'bit-identical' if same else 'differs'}, max |diff| "
        f"{float(np.abs(z2[0] - z1).max()):.4g}, relative norm gap {rel:.4g} (tolerance "
        f"{DP_REL_TOL}) | on {card}")
    assert rel <= DP_REL_TOL, f"stage 1 world 2 vs 1 relative gap {rel} > {DP_REL_TOL}"
    out2 = a.root / "dp_world2"
    assert len(list((out2 / "generated_images" / "images").glob("*.png"))) == a.n_samples
    calls = 2           # 2 DDIM steps, one round of 4 groups: one UNet call a rank a step
    for res in ranks:
        launches = res["stage1"][1]
        assert launches["flash_attention"] == 16 * calls, launches
        assert launches["group_norm"] == 61 * calls, launches
        assert launches["rasterize"] > 0, launches

    # (c) the animation: every frame and the PLY byte-identical to phase 9's
    seq, par = work / "animation", anim.out
    for i in range(48):
        name = f"frames/{i:05d}.png"
        assert (seq / name).read_bytes() == (par / name).read_bytes(), f"frame {i} differs"
    ply = "exported_animation.ply"
    if (seq / ply).read_bytes() != (par / ply).read_bytes():
        raise AssertionError("the PLY differs: " + ply_diff(seq / ply, par / ply))
    rank_s = ranks[0]["animate"][0]["rank_render_s"]
    assert [res["animate"][1]["gsplat_fwd"] for res in ranks] == [24, 24]
    log(f"[parallel] animation, 48 frames at 512x512 over 2 ranks: every PNG and the PLY "
        f"byte-identical to phase 9's | render loops {rank_s[0]:.2f} / {rank_s[1]:.2f} s, "
        f"{48 / max(rank_s):.2f} FPS over the slowest rank (two ranks share one card)")

    # (d) training: the ranks bitwise equal, each step against one process
    tr = [res["train"][0] for res in ranks]
    gaps = {f"{key} step {s + 1}": (abs(tr[0][key][s] - t1[key][s]) / abs(t1[key][s]),
                                    *(abs(r[key][s] - t1[key][s]) / abs(t1[key][s])
                                      for r in t1_again))
            for key in ("losses", "grad_norms") for s in range(2)}
    log("[parallel] training, relative gaps to one process (two ranks | one process again): "
        + ", ".join(f"{k} {g[0]:.3g} | {g[1]:.3g}" for k, g in gaps.items()))
    assert tr[0]["checksum"] == tr[1]["checksum"], "the ranks' parameters differ"
    for key in ("losses", "grad_norms"):
        assert tr[0][key] == tr[1][key], key
    # step 1 starts from the same parameters as one process: the same loss;
    # its gradients differ in last bits (K6 adds dQ atomically, and the sums
    # over micro-batches associate differently over two ranks), which bf16
    # backward layers round to whole ulps
    assert gaps["losses step 1"][0] <= 1e-5, (tr[0]["losses"], t1["losses"])
    assert gaps["grad_norms step 1"][0] <= DP_GRAD_REL_TOL, (tr[0]["grad_norms"],
                                                              t1["grad_norms"])
    # step 2 starts from parameters that differ in their last bits, and the
    # bf16 forward turns any difference into whole-ulp roundings
    for key in ("losses", "grad_norms"):
        assert gaps[f"{key} step 2"][0] <= DP_STEP2_REL_TOL, (key, tr[0][key], t1[key])
    # every rank's micro-batches are replays of one captured graph but the first
    assert [r["graph"]["replays"] for r in (*tr, t1)] == [3, 3, 7], [r["graph"] for r in tr]
    assert all(r["graph"]["graphed"] and r["graph"]["captures"] == 1 for r in (*tr, t1))
    for res in ranks:
        launches, n_attn, n_gn = res["train"][1], tr[0]["n_attn"], tr[0]["n_gn"]
        micro = 2 * 2      # 2 steps x 2 micro-batches a rank
        assert launches["flash_attention_bwd"] == micro * n_attn, launches
        assert launches["flash_attention"] == micro * 2 * n_attn, launches
        assert launches["group_norm"] == micro * (2 * n_gn - 1), launches
    log(f"[parallel] training, 4 micro-batches over 2 ranks, 2 AdamW steps, {tr[0]['n_params']} "
        f"parameters: losses {tr[0]['losses']} (one process {t1['losses']}), gradient norms "
        f"{tr[0]['grad_norms']} (one process {t1['grad_norms']}), parameter checksums equal | "
        f"micro-batch graphs: rank 0 {tr[0]['graph']}, one process {t1['graph']} | "
        f"gradient all-reduce (gloo through host memory, two ranks on one card): "
        f"{tr[0]['allreduce_bytes']} bytes in {tr[0]['allreduce_s']:.3f} / "
        f"{tr[1]['allreduce_s']:.3f} s | on {card}")

    # stage 1's CLI under torch.distributed.run, one DDIM step on random weights
    cfg1 = a.root / "gen_config_1step.yaml"
    dump_yaml(dict(load_yaml(a.cfg), n_ddim_steps=1), cfg1)
    logs, out_cli = work / "torchrun_logs", a.root / "dp_cli"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "--log_dir", str(logs), "--redirects", "3", "-m",
         "cap4d_torch.inference.generate_images", "--config_path", str(cfg1),
         "--reference_data_path", str(a.ref_dir), "--output_path", str(out_cli),
         "--allow_random_weights", "1", "--flame_asset_dir", str(a.flame_dir)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    cli_s = time.perf_counter() - t0
    stdout = {p.parent.name: p.read_text() for p in logs.rglob("stdout.log")}
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:], stdout)
    assert set(stdout) == {"0", "1"}, sorted(stdout)
    assert "[dp] backend gloo, world 2" in stdout["0"], stdout["0"][-2000:]
    assert "Saving generated images" in stdout["0"] and "Saving" not in stdout["1"], stdout
    assert len(list((out_cli / "generated_images" / "images").glob("*.png"))) == a.n_samples
    assert len(list((out_cli / "reference_images" / "images").glob("*.png"))) == 1
    log(f"[parallel] torch.distributed.run --nproc_per_node 2 -m "
        f"cap4d_torch.inference.generate_images (1 DDIM step): {cli_s:.1f} s, rank 0 wrote "
        f"{a.n_samples} + 1 PNGs, rank 1 none")
    log(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s (the two-rank spawn "
        f"{spawn_s:.1f} s) | on {card}")
    return [res[path][1] for res in ranks for path in ("stage1", "animate", "train")]


PHASES = ("attention", "attention_bwd", "group_norm", "rasterize", "unet", "unet_grad",
          "generate", "loader", "video", "gsplat", "fit", "animate", "quality", "train",
          "op_mix", "smpl", "parallel")


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
    parser.add_argument("--serial-video", action="store_true",
                        help="run the video phase after every card phase, with nothing beside it")
    args = parser.parse_args()
    phases = args.phases.split(",")
    assert set(phases) <= set(PHASES), phases
    # the fit trains on stage 1's images from the gsplat phase's assets; the
    # animation drives the fit's checkpoint (a fresh avatar's without the fit)
    assert "fit" not in phases or {"generate", "gsplat"} <= set(phases), phases
    # the parallel phase compares with the animation's frames and drives its checkpoint
    assert "parallel" not in phases or "animate" in phases, phases
    sys.path.insert(0, str(REPO))
    torch_flags()
    t_start = time.perf_counter()

    def mark(name: str) -> None:
        log(f"[timing] {name} done {time.perf_counter() - t_start:.1f} s after the start")

    card = card_line()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
        f"nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    kernels = port_kernels()
    phase_build(kernels)
    mark("build")
    if "attention" in phases or "attention_bwd" in phases:
        phase_attention_sass()

    work = REPO / ".chip_smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    background = []      # the video phase's processes, stopped on the way out
    try:
        return run_phases(phases, work, kernels, card, background, t_start, mark,
                          args.serial_video)
    finally:
        for b in background:
            b.stop()


def run_phases(phases, work: Path, kernels, card: str, background: list, t_start: float,
               mark, serial_video: bool = False) -> int:
    """The phases in order, then the result lines. The video phase's writes
    run beside the card phases from the end of ``rasterize`` (the phases
    before time host-bound kernels), its checks beside ``smpl`` and its
    timed loads beside ``parallel`` (``VideoPhase``), or all after
    ``parallel`` with ``serial_video``."""
    import torch

    from cap4d_torch.ops import flash_attention, gsplat_tiles, norms, op_mix, rasterize

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
        mark("attention")
    if "attention_bwd" in phases:
        phase_attention_backward(entries[5])
        mark("attention_bwd")
    if "group_norm" in phases:
        phase_group_norm(entries[1])
        mark("group_norm")
    if "rasterize" in phases:
        phase_rasterize(entries[2], work / "raster")
        mark("rasterize")
    video = VideoPhase(work, card, background) if "video" in phases else None
    overlap = video is not None and not serial_video
    if overlap:
        video.start_writes()
    if "unet" in phases:
        phase_unet()
        mark("unet")
    if "unet_grad" in phases:
        phase_unet_grad()
        mark("unet_grad")
    stage1_out = None
    if "generate" in phases:
        gen_launches, stage1_out = phase_main_path(work, kernels, card)
        main_paths.extend(gen_launches)
        mark("generate")
    if "loader" in phases:
        phase_loader(work, card)
        mark("loader")
    if "gsplat" in phases:
        flame_dir, stage1_out = phase_gsplat(entries[3], entries[4], work, stage1_out)
        mark("gsplat")
    if "fit" in phases:
        model_path, fit_launches = phase_fit(work, stage1_out, flame_dir, kernels, card)
        main_paths.extend(fit_launches)
        mark("fit")
    if "animate" in phases:
        if "fit" not in phases:
            model_path, flame_dir = fresh_avatar(work)
        main_paths.append(phase_animate(work, model_path, flame_dir, kernels, card))
        mark("animate")
    if "quality" in phases:
        main_paths.append(phase_quality(work, kernels, card))
        mark("quality")
    if "train" in phases:
        main_paths.append(phase_train(work, kernels, card))
        mark("train")
    if "op_mix" in phases:
        main_paths.append(phase_op_mix(entries[6], kernels, card))
        mark("op_mix")
    if overlap:
        video.start_checks()
        mark("video writes (the checks start)")
    if "smpl" in phases:
        main_paths.extend(phase_smpl(work, kernels, card))
        mark("smpl")
    if overlap:
        video.start_loads()
        mark("video checks (the timed loads start)")
    if "parallel" in phases:
        main_paths.extend(phase_parallel(work, model_path, flame_dir, kernels, card))
        mark("parallel")
    if video is not None:
        if serial_video:
            video.start_writes()
            video.start_checks()
            video.start_loads()
        video.finish()
        mark("video")
    shutil.rmtree(work, ignore_errors=True)
    if phases != list(PHASES):
        log(f"[done] phases {phases} passed; no result lines for a partial run")
        return 1
    for e in entries:
        n = e.kernel.name
        e.d["launches"] = sum(launches[n] for launches in main_paths)
        assert e.d["launches"] > 0, f"{n} never launched on the main paths"

    total = time.perf_counter() - t_start
    log(f"[timing] total {total:.1f} s ({'video after the card phases' if serial_video else 'video beside them'}); "
        f"{100 * video.writers.waited / total:.1f} % of it {video.summary()}")
    if not serial_video:
        log("[timing] measured under load: the figures of unet to op_mix beside the writers, "
            "smpl's beside the video checks, parallel's beside the timed loads (the timed loads "
            "beside parallel); --serial-video runs the video phase alone after them")
    log(f"[device] {card}")
    print(json.dumps({"kernels": [e.d for e in entries]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
