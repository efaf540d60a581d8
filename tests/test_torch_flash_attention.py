"""The flash-attention wrapper (``cap4d_torch/ops/flash_attention.py``) on
the CPU: the checks that refuse what the TMA kernels K1/K6 cannot take, and
the ``FlashAttention`` autograd Function (its plain versions on CPU tensors)
against ``jax.vjp`` of ``cap4d_tpu.ops.attention._einsum_attention`` at the
tile edges S = 1, 64, 127, 128, 129."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_torch.ops import flash_attention as fa
from cap4d_tpu.ops.attention import _einsum_attention


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _misaligned():
    # a (1, 4, 2, 64) view one element past a 16-byte boundary
    return torch.zeros(4 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 4, 2, 64)


def _odd_stride():
    # rows 8 elements apart would do; 132 is not a multiple of 8
    return torch.zeros(1, 4, 2 * 64 + 4, dtype=torch.bfloat16)[..., :128].view(1, 4, 2, 64)


REFUSED = {
    "head dim 32": lambda: (_bf16(1, 4, 2, 32),) * 3,
    "float32": lambda: (torch.zeros(1, 4, 2, 64),) * 3,
    "stride not a multiple of 8": lambda: (_odd_stride(), _bf16(1, 4, 2, 64), _bf16(1, 4, 2, 64)),
    "head dim not contiguous": lambda: (_bf16(1, 4, 64, 2).transpose(2, 3),) * 3,
    "misaligned base": lambda: (_bf16(1, 4, 2, 64), _misaligned(), _bf16(1, 4, 2, 64)),
    "mismatched shapes": lambda: (_bf16(1, 4, 2, 64), _bf16(1, 5, 2, 64), _bf16(1, 4, 2, 64)),
    "three dims": lambda: (_bf16(4, 2, 64),) * 3,
    "empty sequence": lambda: (_bf16(1, 0, 2, 64),) * 3,
    "batch x heads above the grid": lambda: (_bf16(1, 1, 1, 64).expand(65536, 1, 1, 64),) * 3,
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_checks_refuse_what_the_kernels_cannot_take(case):
    with pytest.raises(ValueError):
        fa._check_inputs(*REFUSED[case]())


@pytest.mark.parametrize("mode", ["spatial", "3d"])
def test_checks_take_the_unet_views(mode):
    """The UNet's q/k/v are strided views of one projection output; the
    kernels read them in place, so the checks accept them."""
    from cap4d_torch.ops.attention import attention_mode_reshape

    heads, d, t = 5, 64, 2
    qkv = torch.zeros(2 * t, 40, 3 * heads * d, dtype=torch.bfloat16)
    views = [attention_mode_reshape(x, mode, t, heads)[0] for x in qkv.chunk(3, dim=-1)]
    assert not views[1].is_contiguous()
    fa._check_inputs(*views)


@pytest.mark.parametrize("S", [1, 64, 127, 128, 129])
def test_function_matches_jax_vjp(S):
    """O, dQ, dK, dV of the FlashAttention Function against jax.vjp of the
    JAX package's einsum attention; fp32, the two differ in summation order
    only: 1e-5 of each output's largest. At S = 1 a softmax over one key is
    constant, so dQ and dK are exactly 0 in JAX and rounding noise of the
    explicit formula here (~1e-7): their floor is 1e-5 of the incoming
    gradient's largest."""
    rng = np.random.default_rng(S)
    q, k, v, g = (rng.normal(size=(2, S, 3, 64)).astype(np.float32) for _ in range(4))
    j_out, vjp = jax.vjp(_einsum_attention, *(jnp.asarray(a) for a in (q, k, v)))
    j_grads = vjp(jnp.asarray(g))

    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*xs)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(g))
    for name, a, ref in [("out", out, j_out)] + list(zip(("dq", "dk", "dv"), grads, j_grads)):
        ref = np.asarray(ref)
        scale = max(np.abs(ref).max(), np.abs(g).max() if S == 1 else 0.0)
        np.testing.assert_allclose(a.detach().numpy(), ref, atol=1e-5 * scale, err_msg=name)
