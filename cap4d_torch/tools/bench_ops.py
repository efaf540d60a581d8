"""Time the op-mix micro-benchmark (kernel K7) case by case on the card
(counterpart of ``python tools/bench_vpu_ops.py``).

Each case runs ``acc <- body(acc, x)`` NITER times over a resident (256, 256)
float32 block; ``base`` is the loop, the carry and one multiply-add, and each
other case adds its ops, so cost(op) = (t_case - t_base) / NITER / ops. The
table has the JAX tool's columns: total ms, ns/iter over ``base`` and ns/op.

    python -m cap4d_torch.tools.bench_ops [--niter 262144]

Runs on the card unless ``--device cpu`` (the plain version: use a small
``--niter``). ``bound_ms`` and ``sass_loop_histograms`` give, per case, the
least time the card could take and the instructions the compiler put in one
iteration of the kernel's loop.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from cap4d_torch.ops import op_mix as om
from cap4d_torch.utils.device import resolve_device

NITER = 262144
ROWS = 256
# ops per extra-op count, as the JAX tool divides ns/iter (cases not listed: 1)
PER_CASE_OPS = {"mul": om.K, "exp": om.K, "log1p": om.K, "log": om.K, "exp2": om.K,
                "div": om.K, "where": om.K, "roll_sel_mul": 4, "scan8": 9, "tri_matmul2": 1}

# Rates per SM per clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0); "tensor" is device-wide bf16 flop/s.
PIPE_RATE = {"fp32": 128, "select": 64, "mufu": 16, "shuffle": 32, "convert": 16}
TENSOR_FLOPS = 989e12
# Ops per element per iteration that each case's body needs, by pipe:
# fp32 = add/mul/FMA (the x0.999999 + 1e-9 tail is 2); select = compare,
# select, min; mufu = one exp2/log2 per transcendental; shuffle = one lane
# rotation; convert = a rounding to bf16 (the split's hi and lo); tensor =
# the bf16 flops of the row contraction. Division by the loop-invariant
# divisor is a product by its reciprocal and two FMA corrections. The tri
# cases count their prefix sums as scans (two adds a value for hi and lo,
# the kernel's form), not as the JAX form's dense (256, 256) products.
CASE_OPS = {
    "base": {"fp32": 2},
    "mul": {"fp32": 6},
    "exp": {"mufu": 4, "fp32": 6},
    "log1p": {"mufu": 4, "fp32": 6, "select": 4},
    "roll_sel_mul": {"shuffle": 4, "select": 4, "fp32": 6},
    "scan8": {"shuffle": 9, "select": 9, "fp32": 11},
    "log": {"mufu": 4, "fp32": 10},
    "exp2": {"mufu": 4, "fp32": 2},
    "div": {"fp32": 14},
    "where": {"select": 4, "fp32": 6},
    "acc_matmul3": {"tensor": 30, "convert": 2, "fp32": 4},
    "acc_matmul2": {"tensor": 20, "convert": 2, "fp32": 4},
    "tri_matmul2": {"convert": 2, "fp32": 8},
    "tri_blocked": {"convert": 2, "fp32": 8},
    "tri_blocked4": {"convert": 2, "fp32": 8},
}


def make_input(device) -> torch.Tensor:
    """The JAX tool's block: uniform(0.1, 0.9) from numpy's seed 0."""
    x = np.random.default_rng(0).uniform(0.1, 0.9, (ROWS, om.LANES)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def bound_ms(case: str, niter: int, n_sm: int, clock_hz: float, rows: int = ROWS) -> tuple:
    """(least ms for the case's loop, the pipe that sets it)."""
    elems = rows * om.LANES * float(niter)
    times = {pipe: (n * elems / TENSOR_FLOPS if pipe == "tensor"
                    else n * elems / (PIPE_RATE[pipe] * n_sm * clock_hz))
             for pipe, n in CASE_OPS[case].items()}
    pipe = max(times, key=times.get)
    return times[pipe] * 1e3, pipe


def time_case(x: torch.Tensor, case: str, niter: int, repeats: int = 3) -> tuple:
    """(best wall ms of ``repeats`` runs after one warm-up, the output); the
    clock stops after the output is on the host, as the JAX tool's fetch."""
    out = om.op_mix(x, case, niter).cpu()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = om.op_mix(x, case, niter).cpu()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3, out


def run_bench(niter: int = NITER, device=None, repeats: int = 3) -> Dict[str, dict]:
    """Every case's best time and output (the card unless device="cpu")."""
    device = resolve_device(device)
    x = make_input(device)
    res = {}
    for case in om.CASES:
        ms, out = time_case(x, case, niter, repeats)
        res[case] = {"ms": ms, "out": out}
    return res


def format_table(res: Dict[str, dict], niter: int) -> str:
    base = res["base"]["ms"]
    lines = [f"{'case':14s} {'total_ms':>9s} {'ns/iter':>9s} {'ns/op':>8s}"]
    for name, r in res.items():
        extra = (r["ms"] - base) / niter * 1e6
        lines.append(f"{name:14s} {r['ms']:9.2f} {extra:9.1f} "
                     f"{extra / PER_CASE_OPS.get(name, 1):8.1f}")
    lines.append(f"(base loop: {base:.2f} ms total, {base / niter * 1e6:.0f} ns/iter; "
                 f"NITER {niter}, K {om.K})")
    return "\n".join(lines)


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_FUNC = re.compile(r"Function : (\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def sass_loop_histograms(so_path: Path, cuobjdump: Optional[str] = None) -> Dict[str, Counter]:
    """Opcodes of one iteration of each case's timed loop: the instructions
    between the target of the kernel's widest backward branch and that
    branch, from ``cuobjdump -sass`` of the built library, divided by the
    loop's unroll (``op_mix.UNROLL`` iterations a pass)."""
    if cuobjdump is None:
        from cap4d_torch.ops.cuda_build import nvcc_path

        cuobjdump = str(Path(nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(so_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs: Dict[str, list] = {}
    name, pending = None, []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            name, pending = m.group(1), []
            funcs[name] = []
            continue
        lab = _LABEL.match(line)
        if lab and name:
            pending.append(lab.group(1))
            continue
        ins = _INSTR.search(line)
        if ins and name:
            funcs[name].append((int(ins.group(1), 16), ins.group(2), pending))
            pending = []
    names = list(om.CASES)
    out: Dict[str, Counter] = {}
    for fname, instrs in funcs.items():
        m = re.search(r"op_mix_loopILi(\d+)E", fname)
        if not m:
            continue
        labels = {lab: addr for addr, _, labs in instrs for lab in labs}
        best = None
        for addr, text_, _ in instrs:
            b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+|\.L_x_\d+)", text_)
            if not b:
                continue
            tgt = b.group(1)
            tgt = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
            if tgt is not None and tgt < addr and (best is None or addr - tgt > best[1] - best[0]):
                best = (tgt, addr)
        hist = Counter()
        if best is not None:
            for addr, text_, _ in instrs:
                if best[0] <= addr <= best[1]:
                    op = re.sub(r"^@!?U?P[T\d]+\s+", "", text_).split()[0].split(".")[0]
                    if op != "NOP":
                        hist[op] += 1
        out[names[int(m.group(1))]] = Counter({op: n / om.UNROLL for op, n in hist.items()})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--niter", type=int, default=NITER)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain version)")
    args = parser.parse_args(argv)
    res = run_bench(args.niter, args.device, args.repeats)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU (plain version)"
    print(f"op-mix micro-benchmark on {where}")
    print(format_table(res, args.niter))
    return res


if __name__ == "__main__":
    main()
