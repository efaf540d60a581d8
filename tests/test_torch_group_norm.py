"""Kernel K2 (GroupNorm + SiLU) on the CPU: its plain version against the
TPU kernel itself, and the shapes its plan accepts.

``cap4d_tpu.ops.norms._gn_silu_pallas`` runs in interpret mode (its module's
``pl.pallas_call`` wrapped with ``interpret=True``); ``fused_group_norm_silu``
would fall back to ``_gn_silu_jnp`` off the TPU. fp32 at atol 1e-5: both sides
take fp32 statistics of the same values, in another order.

``plan_group_norm`` holds every check the kernel's wrapper makes of shape and
type, and the slab and cluster it launches with; a plan that refuses a shape
of the shipped UNet, or leaves SMs idle, fails here before a chip run.
"""

import re
import types
from collections import Counter
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import cap4d_tpu.ops.norms as jax_norms
from cap4d_torch.mmdm import unet as unet_mod
from cap4d_torch.ops import norms
from cap4d_torch.utils.config import load_yaml
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent


class _Interpret(types.SimpleNamespace):
    """``pl`` with ``pallas_call`` in interpret mode; everything else as is."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.mark.parametrize("shape", [(2, 16, 16, 320), (2, 8, 8, 960)])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
def test_plain_matches_pallas_kernel_interpret(shape, silu, eps, monkeypatch):
    monkeypatch.setattr(jax_norms, "pl", _Interpret())
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    bias = (0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    ref = np.asarray(jax_norms._gn_silu_pallas(jnp.asarray(x), jnp.asarray(scale),
                                               jnp.asarray(bias), 32, eps, silu))
    out = norms.group_norm_silu_plain(torch.from_numpy(x), torch.from_numpy(scale),
                                      torch.from_numpy(bias), 32, eps, silu).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def _unet_group_norm_calls():
    """(shape, eps, silu) of every GroupNorm call of one forward of the
    shipped UNet (configs/mmdm/cap4d_mmdm_final.yaml) at stage 1's batch
    (B=2 CFG halves × T=8 views, 64² latents), built and run on the meta
    device: shapes only, no memory, attention replaced by its output shape."""
    up = load_yaml(REPO / "configs" / "mmdm" / "cap4d_mmdm_final.yaml")[
        "model"]["params"]["unet_config"]["params"]
    with torch.device("meta"):
        net = unet_mod.MMDMUNet(
            in_channels=up["in_channels"], out_channels=up["out_channels"],
            model_channels=up["model_channels"], channel_mult=tuple(up["channel_mult"]),
            num_res_blocks=up["num_res_blocks"],
            attention_resolutions=tuple(up["attention_resolutions"]),
            num_head_channels=up["num_head_channels"],
            condition_channels=up["condition_channels"], time_steps=up["time_steps"],
            temporal_mode=up["temporal_mode"])
    seen = []

    def record(x, scale, bias, num_groups, eps, silu, plain=False):
        seen.append((tuple(x.shape), num_groups, eps, silu))
        return torch.empty_like(x)

    mp = pytest.MonkeyPatch()
    mp.setattr(unet_mod, "group_norm_silu", record)
    mp.setattr(unet_mod, "flash_attention", lambda q, k, v, plain=False: q)
    try:
        B, T, L = 2, up["time_steps"], 64
        with torch.device("meta"), torch.no_grad():
            cond = {"pos_enc": torch.empty(B, T, L, L, up["condition_channels"]),
                    "z_input": torch.empty(B, T, L, L, 4), "ref_mask": torch.empty(B, T, L, L, 1)}
            net(torch.empty(B, T, L, L, 4), torch.zeros(B, T, dtype=torch.long), cond)
    finally:
        mp.undo()
    return seen


@pytest.fixture(scope="module")
def unet_calls():
    return _unet_group_norm_calls()


def test_unet_group_norm_shapes(unet_calls):
    """61 calls a forward (chip_smoke.py counts 61 launches a group-step), C
    from 320 to 2560 at 64² down to 8², 32 groups."""
    assert len(unet_calls) == 61
    shapes = Counter(s for s, *_ in unet_calls)
    assert {s[-1] for s in shapes} == {320, 640, 960, 1280, 1920, 2560}
    assert {s[1] for s in shapes} == {64, 32, 16, 8}
    assert all(g == 32 for _, g, _, _ in unet_calls)
    assert shapes[(16, 64, 64, 320)] == 13 and shapes[(16, 64, 64, 960)] == 1


@pytest.mark.parametrize("batch", [16, 8])   # stage 1's UNet batch, training's micro-batch
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_accepts_every_unet_shape(unet_calls, batch, dtype):
    for shape in sorted({s for s, *_ in unet_calls}):
        shape = (batch,) + shape[1:]
        plan = norms.plan_group_norm(shape, dtype, 32)
        esize = torch.finfo(dtype).bits // 8
        width = plan.slab_groups * shape[-1] // 32
        assert 32 % plan.slab_groups == 0 and (width * esize) % 16 == 0, (shape, plan)
        assert width * esize // 16 <= norms.THREADS, (shape, plan)
        assert plan.cluster in (1, 2, 4, 8, 16), (shape, plan)
        assert plan.smem_bytes <= norms.SMEM_BLOCK, (shape, plan)
        # every SM gets a block
        assert plan.blocks >= norms.SMS, (shape, plan)
        rows = -(-shape[1] * shape[2] // plan.cluster)
        # the block's rows stay in shared memory
        assert plan.resident and rows * width * esize < plan.smem_bytes, (shape, plan)


def test_plan_reads_twice_only_what_no_cluster_holds():
    """A slab too large for any cluster's shared memory (not a UNet shape:
    (2, 256, 256, 640), 5.2 MB a slab of 4 groups) takes the kernel's second
    path, its rows read twice."""
    plan = norms.plan_group_norm((2, 256, 256, 640), torch.bfloat16, 32)
    assert not plan.resident and plan.cluster == norms.MAX_CLUSTER
    rows = -(-256 * 256 // norms.MAX_CLUSTER)
    assert rows * plan.slab_groups * 20 * 2 > norms.SMEM_BLOCK


@pytest.mark.parametrize("shape,dtype,groups,why", [
    ((16, 4096, 320), torch.bfloat16, 32, "NHWC"),
    ((2, 8, 8, 320), torch.float16, 32, "float32 or bfloat16"),
    ((2, 8, 8, 320), torch.float64, 32, "float32 or bfloat16"),
    ((2, 8, 8, 330), torch.bfloat16, 32, "C % groups"),
    ((2, 8, 8, 36), torch.bfloat16, 4, "multiple of"),
    ((2, 8, 8, 8192), torch.bfloat16, 2, "channels wide"),
    ((0, 8, 8, 320), torch.bfloat16, 32, "nonempty"),
])
def test_plan_refuses_what_the_kernel_cannot_take(shape, dtype, groups, why):
    with pytest.raises(ValueError, match=why):
        norms.plan_group_norm(shape, dtype, groups)


def test_plan_constants_match_the_kernel_source():
    src = (REPO / "cap4d_torch" / "csrc" / "group_norm.cu").read_text()
    consts = dict(re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == norms.THREADS
    assert int(consts["kMaxCluster"]) == norms.MAX_CLUSTER
    assert int(consts["kMaxSmem"]) == norms.SMEM_BLOCK


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 64)).astype(np.float32))
    s, b = torch.ones(64), torch.zeros(64)
    np.testing.assert_array_equal(norms.group_norm_silu(x, s, b).numpy(),
                                  norms.group_norm_silu_plain(x, s, b, 32, 1e-5, True).numpy())
