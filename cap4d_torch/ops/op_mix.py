"""The op-mix micro-benchmark: per case, ``acc <- body(acc, x)`` ``niter``
times from ``acc = 0.5·x`` over a (256, 256) float32 block (counterpart of
``tools/bench_vpu_ops.py``'s ``make_loop`` and ``CASES``).

``op_mix`` launches kernel K7 (``csrc/op_mix.cu``) on CUDA tensors and runs
the plain version ``op_mix_plain`` (the same loop in PyTorch) on CPU tensors.
Three cases add their body's extra term at x1e-12, below float32 resolution
at |acc| ≈ 0.25, so their output cannot show whether the term is right:
``op_mix_term`` returns one body application's term (scan8's exclusive lane
prefix product, the acc_matmul cases' (rows, 5) split-bf16 products).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from cap4d_torch.ops.cuda_build import CudaKernel, I, P

KERNEL = CudaKernel(
    "op_mix.cu",
    {"c4d_op_mix": [I, P, P, I, I, P], "c4d_op_mix_term": [I, P, P, P, I, P]},
)

LANES = 256    # CH: the lane axis every roll, scan and contraction runs along
K = 4          # extra-op repetitions of the elementwise cases
UNROLL = 4     # iterations of the kernel's timed loop per pass (csrc/op_mix.cu kUnroll)
TERM_CASES = ("scan8", "acc_matmul3", "acc_matmul2")
# the cases whose kernel runs one row a warp (csrc/op_mix.cu row_per_warp);
# the others run one element a thread
ROW_PER_WARP = ("roll_sel_mul", "scan8", "acc_matmul3", "acc_matmul2", "tri_matmul2",
                "tri_blocked", "tri_blocked4")


def _tail(acc):
    return acc * 0.999999 + 1e-9


def _lane(acc):
    return torch.arange(acc.shape[1], device=acc.device)


def _bf16(a):
    return a.to(torch.bfloat16).to(torch.float32)


def _roll_sel_mul(acc, x, term):
    lane = _lane(acc)
    for s in (1, 2, 4, 8):
        r = torch.roll(acc, s, dims=1)   # jnp.roll / pltpu.roll: toward higher lanes
        acc = acc * torch.where(lane < s, 1.0, r)
    return _tail(acc)


def _scan8(acc, x, term):
    lane = _lane(acc)
    p = torch.where(lane < 1, 1.0, torch.roll(acc, 1, dims=1))
    for s in (1, 2, 4, 8, 16, 32, 64, 128):
        p = p * torch.where(lane < s, 1.0, torch.roll(p, s, dims=1))
    term.append(p)
    return acc * 0.999999 + p * 1e-12


def _acc_matmul(n_pass):
    def body(acc, x, term):
        cmat = torch.cat([x[0:3], torch.ones_like(x[0:1]), x[3:4]], dim=0)   # (5, CH)
        a_hi = _bf16(acc)
        a_lo = _bf16(acc - a_hi)
        b_hi = _bf16(cmat)
        b_lo = _bf16(cmat - b_hi)

        def dd(a, b):   # (PX, CH) x (5, CH) -> (PX, 5): bf16 products, fp32 sums
            return (a[:, None, :] * b[None, :, :]).sum(-1)

        out = dd(a_hi, b_hi) + dd(a_hi, b_lo) + dd(a_lo, b_hi) if n_pass == 3 else \
            dd(a_hi, b_hi) + dd(a_lo, b_hi)
        term.append(out)
        return acc * 0.999999 + out.sum(dim=1, keepdim=True) * 1e-12
    return body


def _excl_split(a):
    """dot(hi, u) + dot(lo, u) with u strictly upper triangular: the
    exclusive lane prefix sums of the split-bf16 parts of ``a``."""
    hi = _bf16(a)
    lo = _bf16(a - hi)
    excl = lambda v: torch.cumsum(F.pad(v[:, :-1], (1, 0)), dim=1)
    return excl(hi) + excl(lo)


def _tri(seg):
    def body(acc, x, term):
        outs, carry = [], None
        for p in acc.split(seg, dim=1):
            e = _excl_split(p)
            if carry is not None:
                e = e + carry
            carry = e[:, -1:] + p[:, -1:]
            outs.append(e)
        return torch.cat(outs, dim=1) * 1e-6 + 0.5
    return body


def _repeat(op):
    def body(acc, x, term):
        for _ in range(K):
            acc = op(acc, x)
        return _tail(acc)
    return body


# tools/bench_vpu_ops.py's CASES, in its order (the kernel's case ids)
CASES: Dict[str, Callable] = {
    "base": lambda acc, x, term: _tail(acc),
    "mul": _repeat(lambda a, x: a * x),
    "exp": _repeat(lambda a, x: torch.exp(-a.abs())),
    "log1p": _repeat(lambda a, x: torch.log1p(torch.clamp(a.abs(), max=0.9))),
    "roll_sel_mul": _roll_sel_mul,
    "scan8": _scan8,
    "log": _repeat(lambda a, x: torch.log(a.abs() + 0.5)),
    "exp2": _repeat(lambda a, x: torch.exp2(-a.abs())),
    "div": _repeat(lambda a, x: a / (x.abs() + 1.001)),
    "where": _repeat(lambda a, x: torch.where(x > 0.5, a, a * 0.5)),
    "acc_matmul3": _acc_matmul(3),
    "acc_matmul2": _acc_matmul(2),
    "tri_matmul2": _tri(256),
    "tri_blocked": _tri(128),
    "tri_blocked4": _tri(64),
}
_CASE_ID = {name: i for i, name in enumerate(CASES)}


def _check(x: torch.Tensor, case: str) -> None:
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; cases: {list(CASES)}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != LANES or x.shape[0] < 4:
        raise ValueError(f"op_mix takes a (rows >= 4, {LANES}) float32 block, got "
                         f"{tuple(x.shape)} {x.dtype}")


def op_mix_plain(x: torch.Tensor, case: str, niter: int) -> torch.Tensor:
    """The loop in PyTorch: ``niter`` applications of the case's body."""
    _check(x, case)
    body = CASES[case]
    acc = x * 0.5
    for _ in range(niter):
        acc = body(acc, x, [])
    return acc


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def op_mix(x: torch.Tensor, case: str, niter: int, plain: bool = False) -> torch.Tensor:
    """The case's loop over ``x``. On a CUDA tensor this launches kernel K7
    (``plain=True`` runs the plain version there, for comparisons only); CPU
    tensors take the plain version."""
    _check(x, case)
    if not x.is_cuda or plain:
        return op_mix_plain(x, case, niter)
    x = x.contiguous()
    out = torch.empty_like(x)
    KERNEL.call("c4d_op_mix", _CASE_ID[case], x.data_ptr(), out.data_ptr(), x.shape[0],
                int(niter), _stream(x), inputs=(x,))
    return out


def op_mix_term(x: torch.Tensor, acc: torch.Tensor, case: str, plain: bool = False) -> torch.Tensor:
    """The extra term of one body application from ``acc``: (rows, 256) for
    scan8, (rows, 5) for acc_matmul3 / acc_matmul2. Kernel on CUDA tensors,
    plain version on CPU tensors or with ``plain=True``."""
    _check(x, case)
    if case not in TERM_CASES:
        raise ValueError(f"case {case!r} has no extra term; cases with one: {TERM_CASES}")
    if acc.shape != x.shape or acc.dtype != torch.float32:
        raise ValueError(f"acc must be {tuple(x.shape)} float32")
    if not x.is_cuda or plain:
        term = []
        CASES[case](acc, x, term)
        return term[0]
    x, acc = x.contiguous(), acc.contiguous()
    term = torch.empty((x.shape[0], LANES if case == "scan8" else 5), dtype=torch.float32,
                       device=x.device)
    KERNEL.call("c4d_op_mix_term", _CASE_ID[case], x.data_ptr(), acc.data_ptr(), term.data_ptr(),
                x.shape[0], _stream(x), inputs=(x, acc))
    return term
