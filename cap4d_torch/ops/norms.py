"""GroupNorm (+SiLU) over NHWC activations with fp32 statistics
(counterpart of ``cap4d_tpu/ops/norms.py``).

``group_norm_silu`` runs the ``GroupNormSiLU`` autograd Function. Its
forward launches kernel K2 (``csrc/group_norm.cu``) on CUDA tensors and runs
the plain version ``group_norm_silu_plain`` (the math of ``_gn_silu_jnp``)
on CPU tensors; it raises on a shape or type the kernel does not take rather
than falling back. Its backward recomputes the plain version under autograd
in fp32, as ``cap4d_tpu/ops/norms.py:186-206`` leaves the gradient to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from cap4d_torch.ops.cuda_build import CudaKernel, F, I, P

KERNEL = CudaKernel(
    "group_norm.cu",
    {"c4d_group_norm_silu": [P, P, P, P, P, I, I, I, I, F, I, I, P]},
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _group_norm_silu_cuda(x, scale, bias, num_groups, eps, apply_silu):
    if x.ndim != 4:
        raise ValueError(f"group norm kernel takes NHWC (N, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"group norm kernel takes float32 or bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    if c % num_groups or c % 8 or c // num_groups > 256:
        raise ValueError(f"group norm kernel needs C % groups == 0, C % 8 == 0 and at most "
                         f"256 channels a group (C={c}, groups={num_groups})")
    if not x.is_contiguous():
        raise ValueError("group norm kernel takes a contiguous NHWC tensor")
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be ({c},)")
    y = torch.empty_like(x)
    stats = torch.empty(2 * n * num_groups, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.call("c4d_group_norm_silu", x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), stats.data_ptr(), n, h * w, c, num_groups, float(eps),
                int(apply_silu), _DTYPES[x.dtype], ctypes.c_void_p(stream))
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

    CUDA tensors launch kernel K2 forward; CPU tensors take the plain version
    through the same Function. ``plain=True`` selects autograd through
    ``group_norm_silu_plain`` for comparisons."""
    if plain:
        return group_norm_silu_plain(x, scale, bias, num_groups, eps, apply_silu)
    return GroupNormSiLU.apply(x, scale, bias, num_groups, eps, apply_silu)
