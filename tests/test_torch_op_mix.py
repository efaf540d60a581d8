"""The op-mix micro-benchmark's plain version (``cap4d_torch.ops.op_mix``)
against ``tools/bench_vpu_ops.py``'s Pallas kernel run in interpret mode on
the CPU, case by case, at NITER 2; the roll direction; and the extra terms
that three cases add below float32 resolution, against numpy.

Tolerances: rtol 1e-5 with atol 1e-6 for the elementwise cases (one or two
ulps of PyTorch's and XLA's transcendentals, grown over 8 dependent
applications) and 1e-5 for the matmul cases (fp32 sums of bf16 products in
another order).
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cap4d_torch.ops import op_mix as om
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
MATMUL_CASES = {"acc_matmul3", "acc_matmul2", "tri_matmul2", "tri_blocked", "tri_blocked4"}


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench_vpu_ops",
                                                  REPO / "tools" / "bench_vpu_ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(seed=0):
    return np.random.default_rng(seed).uniform(0.1, 0.9, (256, 256)).astype(np.float32)


def test_case_table_matches_the_tool(bench):
    assert list(om.CASES) == list(bench.CASES)
    assert (om.LANES, om.K) == (bench.CH, bench.K) and bench.PX == 256


@pytest.mark.parametrize("case", list(om.CASES))
def test_plain_matches_pallas_interpret(bench, case, monkeypatch):
    interpret = types.SimpleNamespace(
        pallas_call=lambda *a, **k: pl.pallas_call(*a, interpret=True, **k),
        BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(bench, "NITER", 2)
    monkeypatch.setattr(bench, "pl", interpret)
    x = _x()
    ref = np.asarray(bench.make_loop(bench.CASES[case])(jnp.asarray(x)))
    ours = om.op_mix(torch.as_tensor(x), case, 2).numpy()
    atol = 1e-5 if case in MATMUL_CASES else 1e-6
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=atol)


def test_roll_moves_toward_higher_lanes():
    """pltpu.roll follows jnp.roll: rolling arange by 1 along the lanes gives
    [127, 0, 1, ...] in an (8, 128) block; torch.roll, which the plain
    version uses, does the same. A mirrored roll would pass every
    elementwise case and fail roll_sel_mul."""
    def kernel(x_ref, o_ref):
        o_ref[...] = pltpu.roll(x_ref[...], 1, axis=1)

    a = np.tile(np.arange(128, dtype=np.float32), (8, 1))
    got = np.asarray(pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                                    interpret=True)(jnp.asarray(a)))
    np.testing.assert_array_equal(got[0, :3], [127, 0, 1])
    np.testing.assert_array_equal(torch.roll(torch.as_tensor(a), 1, dims=1).numpy(), got)


def test_roll_sel_mul_matches_numpy():
    x = _x(1)
    acc = 0.5 * x.astype(np.float64)
    lane = np.arange(256)
    for s in (1, 2, 4, 8):
        acc = acc * np.where(lane < s, 1.0, np.roll(acc, s, axis=1))
    ref = acc * 0.999999 + 1e-9
    np.testing.assert_allclose(om.op_mix(torch.as_tensor(x), "roll_sel_mul", 1).numpy(), ref,
                               rtol=1e-5, atol=1e-12)


def test_scan8_term_is_the_exclusive_lane_prefix_product():
    rng = np.random.default_rng(2)
    x = _x(2)
    acc = rng.uniform(0.97, 1.03, (256, 256)).astype(np.float32)   # products stay normal
    p = om.op_mix_term(torch.as_tensor(x), torch.as_tensor(acc), "scan8").numpy()
    ref = np.concatenate([np.ones((256, 1)), np.cumprod(acc.astype(np.float64), axis=1)[:, :-1]],
                         axis=1)
    np.testing.assert_allclose(p, ref, rtol=1e-5)


def _bf16_rn(a: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 (round to nearest even) → float32, on the bits."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("case", ["acc_matmul3", "acc_matmul2"])
def test_acc_matmul_term_is_the_split_bf16_product(case):
    rng = np.random.default_rng(3)
    x = _x(3)
    acc = rng.uniform(0.1, 0.5, (256, 256)).astype(np.float32)
    out = om.op_mix_term(torch.as_tensor(x), torch.as_tensor(acc), case).numpy()
    cmat = np.concatenate([x[0:3], np.ones((1, 256), np.float32), x[3:4]], axis=0)
    a_hi = _bf16_rn(acc)
    a_lo = _bf16_rn(acc - a_hi)
    b_hi = _bf16_rn(cmat)
    b_lo = _bf16_rn(cmat - b_hi)
    f = lambda a, b: a.astype(np.float64) @ b.astype(np.float64).T
    ref = f(a_hi, b_hi) + f(a_lo, b_hi) + (f(a_hi, b_lo) if case == "acc_matmul3" else 0.0)
    assert out.shape == (256, 5)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    # the split reaches past bf16: the 3-pass form is closer to the fp32 product
    err = np.abs(ref - acc.astype(np.float64) @ cmat.astype(np.float64).T).max()
    assert err < (1e-3 if case == "acc_matmul3" else 5e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="unknown case"):
        om.op_mix(torch.zeros(256, 256), "nope", 1)
    with pytest.raises(ValueError, match="float32 block"):
        om.op_mix(torch.zeros(256, 128), "base", 1)
    with pytest.raises(ValueError, match="no extra term"):
        om.op_mix_term(torch.zeros(256, 256), torch.zeros(256, 256), "exp")


def test_loop_unroll_and_layouts_match_the_kernel_source():
    """bench_ops divides the SASS of a loop by ``UNROLL``, and chip_smoke.py
    holds the one-row-a-warp cases to a loop without block barriers: both
    must name what ``csrc/op_mix.cu`` compiles."""
    src = (REPO / "cap4d_torch" / "csrc" / "op_mix.cu").read_text()
    assert f"constexpr int kUnroll = {om.UNROLL};" in src
    # enum Case follows CASES; row_per_warp(c) is roll_sel_mul, scan8 and
    # every case from acc_matmul3 on
    assert "return c == ROLL_SEL_MUL || c == SCAN8 || c >= ACC_MATMUL3;" in src
    names = list(om.CASES)
    expected = tuple(n for i, n in enumerate(names)
                     if n in ("roll_sel_mul", "scan8") or i >= names.index("acc_matmul3"))
    assert om.ROW_PER_WARP == expected
