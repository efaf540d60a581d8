"""Non-causal multi-head attention forward over (B, S, H, D) (counterpart of
``cap4d_tpu/ops/flash_attention.py``).

``flash_attention`` launches kernel K1 (``csrc/flash_attention.cu``: bf16,
head dim 64, any S) on CUDA tensors and runs the plain version
``attention_plain`` (fp32 softmax, as ``cap4d_tpu/ops/attention.py:32``) on
CPU tensors. It raises on inputs the kernel does not take. The port has no
attention backward yet (MMDM training is a later slice).
"""

from __future__ import annotations

import ctypes

import torch

from cap4d_torch.ops.cuda_build import CudaKernel, F, I, L, P

KERNEL = CudaKernel(
    "flash_attention.cu",
    {"c4d_flash_attention_fwd": [P, P, P, P, I, I, I] + [L] * 12 + [F, P]},
)
HEAD_DIM = 64


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) exact attention, logits and softmax in fp32."""
    scale = q.shape[-1] ** -0.5
    sim = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    attn = torch.softmax(sim, dim=-1)
    return torch.einsum("bhij,bjhd->bihd", attn.to(v.dtype), v)


def _flash_attention_cuda(q, k, v):
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"flash attention kernel takes bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"flash attention kernel takes head dim {HEAD_DIM}, got {D}")
    if B * H > 65535:  # one grid row per (batch, head)
        raise ValueError(f"flash attention kernel takes at most 65535 batch x heads, got {B * H}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous, other strides multiples "
                             "of 8 and the base 16-byte aligned")
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    KERNEL.call("c4d_flash_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), B, S, H, *strides, float(D ** -0.5), ctypes.c_void_p(stream))
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
    """softmax(Q Kᵀ/√d) V over (B, S, H, D). CUDA tensors launch kernel K1
    (``plain=True`` selects the plain version for comparisons); CPU tensors
    take the plain version."""
    if q.is_cuda and not plain:
        return _flash_attention_cuda(q, k, v)
    return attention_plain(q, k, v)
