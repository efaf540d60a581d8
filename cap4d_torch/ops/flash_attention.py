"""Non-causal multi-head attention over (B, S, H, D) with its backward
(counterpart of ``cap4d_tpu/ops/flash_attention.py``).

``flash_attention`` runs the ``FlashAttention`` autograd Function. On CUDA
tensors its forward launches kernel K1 (``csrc/flash_attention.cu``: bf16,
head dim 64, any S; wgmma, TMA and warp specialisation), which also writes
the rows' base-2 log-sum-exp when a gradient is needed, and its backward
launches kernel K6 (``csrc/flash_attention_bwd.cu``: dQ, dK, dV from Q, K,
V, O, dO and that log-sum-exp in one pass over the key blocks). The kernels
read Q, K, V, O and dO through TMA tensor maps over the caller's strides,
so ``_check_layout`` holds what a tensor map needs. On CPU tensors the same
Function runs the plain versions ``attention_plain`` (fp32 softmax, as
``cap4d_tpu/ops/attention.py:32``) and ``attention_backward_plain`` (the
backward's explicit formula in fp32). Both kernels raise on inputs they do
not take; nothing falls back.

``plain=True`` skips the Function and differentiates ``attention_plain``
with autograd: the independent reference that comparisons hold the kernels
against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cap4d_torch.ops.cuda_build import CudaKernel, F, I, L, P

KERNEL = CudaKernel(
    "flash_attention.cu",
    {"c4d_flash_attention_fwd": [P, P, P, P, P, I, I, I] + [L] * 12 + [F, P]},
)
KERNEL_BWD = CudaKernel(
    "flash_attention_bwd.cu",
    {"c4d_flash_attention_bwd": [P] * 12 + [I, I, I] + [L] * 18 + [F, P]},
)
HEAD_DIM = 64
LOG2E = 1.0 / math.log(2.0)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) exact attention, logits and softmax in fp32 (also under
    autocast, which would run the logits' product in bf16)."""
    scale = q.shape[-1] ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
        attn = torch.softmax(sim, dim=-1)
        return torch.einsum("bhij,bjhd->bihd", attn.to(v.dtype), v)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, S) fp32 base-2 log-sum-exp of the scaled logits: K1's lse2."""
    scale = q.shape[-1] ** -0.5
    sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    return torch.logsumexp(sim, dim=-1) * LOG2E


def attention_backward_plain(q, k, v, o, do, lse):
    """dQ, dK, dV of (B, S, H, D) attention by the explicit formula in fp32:
    P = exp2(Q Kᵀ·scale·log2 e − lse2), D = rowsum(dO ∘ O), dV = Pᵀ dO,
    dS = P ∘ (dO Vᵀ − D), dQ = scale·dS K, dK = scale·dSᵀ Q. Returned in
    q's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    sim = torch.einsum("bihd,bjhd->bhij", qf, kf) * (scale * LOG2E)
    p = torch.exp2(sim - lse.float()[..., None])
    del sim
    dv = torch.einsum("bhij,bihd->bjhd", p, gf)
    dsum = (gf * of).sum(-1).transpose(1, 2)                     # (B, H, S)
    ds = p * (torch.einsum("bihd,bjhd->bhij", gf, vf) - dsum[..., None])
    del p
    dq = torch.einsum("bhij,bjhd->bihd", ds, kf) * scale
    dk = torch.einsum("bhij,bihd->bjhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _layout_ok(t: torch.Tensor) -> bool:
    return t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _check_layout(**tensors) -> None:
    for name, t in tensors.items():
        if not _layout_ok(t):
            raise ValueError(f"{name}: head dim must be contiguous, other strides multiples "
                             "of 8 and the base 16-byte aligned")


def _check_inputs(q, k, v) -> None:
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash attention kernel takes bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if S < 1:
        raise ValueError("flash attention kernel takes a sequence of at least one row")
    if D != HEAD_DIM:
        raise ValueError(f"flash attention kernel takes head dim {HEAD_DIM}, got {D}")
    if B * H > 65535:  # one grid row per (batch, head) in K1 and K6
        raise ValueError(f"flash attention kernel takes at most 65535 batch x heads, got {B * H}")
    _check_layout(q=q, k=k, v=v)


def _strides(*tensors):
    out = []
    for t in tensors:
        out += [t.stride(0), t.stride(1), t.stride(2)]
    return out


def flash_attention_fwd_cuda(q, k, v, with_lse: bool = False):
    """Kernel K1: (O, lse2) with lse2 (B, H, S) fp32, or None unless asked."""
    _check_inputs(q, k, v)
    B, S, H, D = q.shape
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.call("c4d_flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), None if lse is None else lse.data_ptr(), B, S, H,
                *_strides(q, k, v, o), float(D ** -0.5), ctypes.c_void_p(stream),
                inputs=(q, k, v))
    return o, lse


def flash_attention_bwd_cuda(q, k, v, o, do, lse):
    """Kernel K6: (dQ, dK, dV) as contiguous bf16 (B, S, H, 64)."""
    _check_inputs(q, k, v)
    B, S, H, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o and do must be bf16 {tuple(q.shape)}, got {tuple(o.shape)} "
                         f"{o.dtype}, {tuple(do.shape)}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be fp32 {(B, H, S)}, got {tuple(lse.shape)} {lse.dtype}")
    do = do.to(q.dtype)
    if not _layout_ok(do):
        do = do.contiguous()   # an upstream gradient may come in any layout
    _check_layout(o=o)
    lse = lse.contiguous()
    # workspace: lse2 and D in rows padded to a multiple of 64, and the fp32
    # dQ accumulator that the key blocks' partials are reduce-added into
    s_pad = -(-S // 64) * 64
    lse_pad, dsum_pad = (torch.empty((B * H, s_pad), dtype=torch.float32, device=q.device)
                         for _ in range(2))
    dq_acc = torch.empty((B * H, s_pad, D), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty((B, S, H, D), dtype=q.dtype, device=q.device) for _ in range(3))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL_BWD.call("c4d_flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), do.data_ptr(), lse.data_ptr(), lse_pad.data_ptr(),
                    dsum_pad.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), B, S, H, *_strides(q, k, v, o, do, dq), float(D ** -0.5),
                    ctypes.c_void_p(stream), inputs=(q, k, v, o, do, lse))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Forward K1 (with lse2 when a gradient is needed), backward K6; the
    plain versions for CPU tensors. Saves q, k, v, o and lse2."""

    @staticmethod
    def forward(ctx, q, k, v, need_grad: bool):
        if q.is_cuda:
            o, lse = flash_attention_fwd_cuda(q, k, v, with_lse=need_grad)
        else:
            o = attention_plain(q, k, v)
            lse = attention_lse_plain(q, k) if need_grad else None
        if need_grad:
            ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.is_cuda:
            return (*flash_attention_bwd_cuda(q, k, v, o, do, lse), None)
        return (*attention_backward_plain(q, k, v, o, do, lse), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
    """softmax(Q Kᵀ/√d) V over (B, S, H, D), differentiable. CUDA tensors
    launch K1 forward and K6 backward; CPU tensors take the plain versions
    through the same Function. ``plain=True`` selects autograd through
    ``attention_plain`` for comparisons."""
    if plain:
        return attention_plain(q, k, v)
    # the forward runs with grad mode off, so whether lse2 is needed is
    # decided here
    need_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, need_grad)
