"""GroupNorm (+SiLU) over NHWC activations with fp32 statistics
(counterpart of ``cap4d_tpu/ops/norms.py``).

``group_norm_silu`` runs the ``GroupNormSiLU`` autograd Function. Its
forward launches kernel K2 (``csrc/group_norm.cu``) on CUDA tensors and runs
the plain version ``group_norm_silu_plain`` (the math of ``_gn_silu_jnp``)
on CPU tensors; it raises on a shape or type the kernel does not take rather
than falling back. ``plan_group_norm`` holds those checks and picks the
kernel's slabs and clusters; it runs anywhere, so the CPU tests reach it. The
backward recomputes the plain version under autograd in fp32, as
``cap4d_tpu/ops/norms.py:186-206`` leaves the gradient to XLA.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from cap4d_torch.ops.cuda_build import CudaKernel, F, I, P

KERNEL = CudaKernel(
    "group_norm.cu",
    {"c4d_group_norm_silu": [P, P, P, P, I, I, I, I, F, I, I, I, I, I, P]},
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The card and the kernel, as the plan counts them (csrc/group_norm.cu).
SMS = 132                    # H100 SXM
THREADS = 256                # threads a block (kThreads)
MAX_CLUSTER = 16             # clusters above 8 are non-portable (kMaxCluster)
SMEM_BLOCK = 232448          # shared memory a block may use (kMaxSmem)
# The plan's rule, from a grid of plans timed on an H100 (PERF.md §6):
# a block's rows near TILE_BYTES of shared memory, at most MAX_ROWS rows,
# and at least MIN_BLOCKS blocks (two a SM).
TILE_BYTES = 65536
MAX_ROWS = 512
MIN_BLOCKS = 256


class GroupNormPlan(NamedTuple):
    """How K2 covers a call: slabs of ``slab_groups`` whole groups, one
    cluster of ``cluster`` blocks per (sample, slab), each block holding
    ``ceil(H·W / cluster)`` rows of the slab in shared memory when
    ``resident`` (else it reads them twice, the second time from L2)."""
    slab_groups: int
    cluster: int
    resident: bool
    smem_bytes: int
    blocks: int


def _small_bytes(width: int, ve: int, gps: int) -> int:
    """Shared memory besides the rows (csrc/group_norm.cu small_floats)."""
    return 4 * (THREADS // 32 * min(width // ve, 32) * 2 * ve + 4 * width + 2 * gps)


def _plan(n: int, hw: int, c: int, groups: int, esize: int) -> GroupNormPlan:
    """Among slabs of whole groups in whole 16-byte vectors and clusters of
    1 to 16 blocks: the block rows nearest TILE_BYTES with at most MAX_ROWS
    rows and MIN_BLOCKS blocks (the smaller cluster, then the narrower slab,
    on a tie); else the most blocks that fit; where no cluster holds a slab,
    the narrowest slab with its rows read twice."""
    ve = 16 // esize                         # elements of a 16-byte vector
    gs = c // groups
    slabs = [g for g in range(1, groups + 1) if groups % g == 0
             and (g * gs) % ve == 0 and g * gs // ve <= THREADS]
    if not slabs:
        raise ValueError(f"group norm kernel: no slab of whole groups of {gs} channels is a "
                         f"multiple of 16 bytes and at most {THREADS * ve} channels wide "
                         f"(C={c}, groups={groups})")
    best = None
    for gps in slabs:
        width = gps * gs
        small = _small_bytes(width, ve, gps)
        for cs in (1, 2, 4, 8, 16):
            rows = -(-hw // cs)
            tile = rows * width * esize
            if rows * (cs - 1) >= hw or tile + small > SMEM_BLOCK:
                continue
            plan = GroupNormPlan(gps, cs, True, tile + small, n * (groups // gps) * cs)
            wanted = rows <= MAX_ROWS and plan.blocks >= MIN_BLOCKS
            key = (not wanted, abs(math.log2(tile / TILE_BYTES)) if wanted else -plan.blocks,
                   cs, gps)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is not None:
        return best[1]
    gps = slabs[0]
    return GroupNormPlan(gps, MAX_CLUSTER, False, _small_bytes(gps * gs, ve, gps),
                         n * (groups // gps) * MAX_CLUSTER)


@functools.lru_cache(maxsize=None)
def plan_group_norm(shape: Tuple[int, ...], dtype: torch.dtype, num_groups: int) -> GroupNormPlan:
    """K2's checks of shape and type, and its plan for them; raises
    ValueError on what the kernel does not take. ``shape`` is a tuple (or a
    torch.Size); the answer is kept per shape, type and group count."""
    if len(shape) != 4:
        raise ValueError(f"group norm kernel takes NHWC (N, H, W, C), got {tuple(shape)}")
    if dtype not in _DTYPES:
        raise ValueError(f"group norm kernel takes float32 or bfloat16, got {dtype}")
    n, h, w, c = (int(d) for d in shape)
    if min(n, h, w, c) < 1 or num_groups < 1:
        raise ValueError(f"group norm kernel needs a nonempty tensor, got {tuple(shape)}")
    esize = 4 if dtype == torch.float32 else 2
    if c % num_groups or (c * esize) % 16:
        raise ValueError(f"group norm kernel needs C % groups == 0 and rows of a multiple of "
                         f"16 bytes (C={c}, groups={num_groups}, {dtype})")
    return _plan(n, h * w, c, num_groups, esize)


def group_norm_silu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          num_groups: int, eps: float, apply_silu: bool) -> torch.Tensor:
    """(N, H, W, C) GroupNorm with fp32 two-pass statistics, affine, SiLU."""
    n, h, w, c = x.shape
    xg = x.reshape(n, h * w, num_groups, c // num_groups).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    out = xn * scale.float() + bias.float()
    if apply_silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def _fp32_on(t: torch.Tensor, x: torch.Tensor, c: int) -> torch.Tensor:
    """``t`` (C,) as the kernel reads it: float32, contiguous, 16-byte
    aligned, on x's card; copied only where it is not already."""
    if t.shape != (c,):
        raise ValueError(f"scale/bias must be ({c},), got {tuple(t.shape)}")
    if (t.dtype == torch.float32 and t.device == x.device and t.is_contiguous()
            and t.data_ptr() % 16 == 0):
        return t
    return t.to(device=x.device, dtype=torch.float32).contiguous().clone()


def _group_norm_silu_cuda(x, scale, bias, num_groups, eps, apply_silu):
    plan = plan_group_norm(x.shape, x.dtype, num_groups)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group norm kernel takes a contiguous, 16-byte aligned NHWC tensor")
    n, h, w, c = x.shape
    scale, bias = _fp32_on(scale, x, c), _fp32_on(bias, x, c)
    y = torch.empty_like(x)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    KERNEL.call("c4d_group_norm_silu", x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), n, h * w, c, num_groups, float(eps), int(apply_silu),
                _DTYPES[x.dtype], plan.slab_groups, plan.cluster, int(plan.resident),
                ctypes.c_void_p(stream), inputs=(x, scale, bias))
    return y


class GroupNormSiLU(torch.autograd.Function):
    """Forward K2 (the plain version for CPU tensors); backward by autograd
    through the plain version recomputed in fp32. Saves x, scale, bias."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, apply_silu)
        if x.is_cuda:
            return _group_norm_silu_cuda(x, scale, bias, num_groups, eps, apply_silu)
        return group_norm_silu_plain(x, scale, bias, num_groups, eps, apply_silu)

    @staticmethod
    def backward(ctx, grad):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            xf, sf, bf = (t.detach().float().requires_grad_() for t in (x, scale, bias))
            out = group_norm_silu_plain(xf, sf, bf, *ctx.args)
            gx, gs, gb = torch.autograd.grad(out, (xf, sf, bf), grad.float())
        return gx.to(x.dtype), gs.to(scale.dtype), gb.to(bias.dtype), None, None, None


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int = 32, eps: float = 1e-5, apply_silu: bool = True,
                    plain: bool = False) -> torch.Tensor:
    """GroupNorm over (H, W, group channels) + affine (+ SiLU) of NHWC ``x``,
    differentiable.

    CUDA tensors launch kernel K2 forward, through the Function when a
    gradient is to be recorded and directly otherwise; CPU tensors take the
    plain version through the Function. ``plain=True`` selects autograd
    through ``group_norm_silu_plain`` for comparisons."""
    if plain:
        return group_norm_silu_plain(x, scale, bias, num_groups, eps, apply_silu)
    if x.is_cuda and not (torch.is_grad_enabled()
                          and (x.requires_grad or scale.requires_grad or bias.requires_grad)):
        # no graph to record: K2 without the autograd Function's host cost
        return _group_norm_silu_cuda(x, scale, bias, num_groups, eps, apply_silu)
    return GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
