"""The compositor split into (tile, 256-pair batch) items, at the kernels'
interfaces: ``composite_fwd_plain`` (K4's outputs, batches run and state)
and ``composite_bwd_plain`` (K5's per-gaussian gradient) against the plain
compositor ``rasterize_gaussians_plain`` and its autograd gradient, against
the Pallas compositor of ``cap4d_tpu/ops/gsplat_pallas.py`` run in interpret
mode, and (batches run, state) against a float64 numpy brute force.

Tolerances: against the plain compositor 2e-5 absolute on the outputs and
1e-4 of each gradient column's largest (fp32 sums in another order: a batch
composited from T = 1 and scaled by exp(ln T before it)); against Pallas
5e-4, as ``tests/test_torch_gsplat.py`` holds the Pallas forward and VJP
(its split-bf16 MXU prefix sums, and a stop rule checked at global
multiples of 256 where a segment does not start at one: the two rules run
different pairs past T < 1e-4, so that comparison takes the cotangent of ln T
as a loss of T = exp(ln T) gives it, T·dL/dT); the state against
float64 1e-4 absolute (2e-5 relative on ln T).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_tpu.ops.gsplat_pallas import CHUNK, NCH, _make_composite
from cap4d_torch.ops import gsplat_tiles as gt
from cap4d_torch.ops.gsplat import BATCH, LN_T_STOP, rasterize_gaussians_plain
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)


def _splats(rng, n, x0, y0, sigma_px, opac):
    """(n, 10) packed rows around the tile at pixel (x0, y0): means in the
    tile, isotropic-ish conics of ``sigma_px`` pixels, opacities U[opac]."""
    s = rng.uniform(*sigma_px, size=n)
    a = 1.0 / (s * s)
    return np.stack([
        x0 + rng.uniform(0, 16, n), y0 + rng.uniform(0, 16, n),
        a * rng.uniform(0.8, 1.2, n), a * rng.uniform(-0.2, 0.2, n), a * rng.uniform(0.8, 1.2, n),
        rng.uniform(*opac, size=n), *rng.uniform(0, 1, (3, n)), rng.uniform(1.0, 3.0, n),
    ], axis=1)


def _assemble(tiles_x, segments, extra=None):
    """Packed rows, pair_gauss and bounds from per-tile lists of row blocks;
    ``extra`` rows are shared gaussians that segments name by index."""
    rows = [] if extra is None else [extra]
    n = 0 if extra is None else len(extra)
    pair_gauss, bounds = [], [0]
    for seg in segments:
        ids = []
        for part in seg:
            if isinstance(part, np.ndarray):
                rows.append(part)
                ids.extend(range(n, n + len(part)))
                n += len(part)
            else:
                ids.append(part)           # a shared gaussian
        pair_gauss.extend(ids)
        bounds.append(len(pair_gauss))
    packed = np.concatenate(rows).astype(np.float32)
    return packed, np.asarray(pair_gauss, np.int32), np.asarray(bounds, np.int32), tiles_x


def _case(name):
    rng = np.random.default_rng(CASES.index(name) + 11)
    if name == "stops_mid_segment":       # one tile, 3,000 pairs: runs 7 of its 12 batches
        return _assemble(1, [[_splats(rng, 3000, 0, 0, (8, 20), (0.006, 0.012))]])
    if name == "never_stops":             # one tile, 3,000 near-transparent pairs
        return _assemble(1, [[_splats(rng, 3000, 0, 0, (1.0, 2.5), (0.01, 0.05))]])
    if name == "ragged_last_batch":       # 600, 300, 257 and 100 pairs over 2×2 tiles
        lens = (600, 300, 257, 100)
        return _assemble(2, [[_splats(rng, L, 16 * (t % 2), 16 * (t // 2), (1.5, 4), (0.02, 0.2))]
                             for t, L in enumerate(lens)])
    if name == "empty_tiles":             # 3×3 tiles, six of them empty
        lens = (0, 400, 0, 0, 700, 0, 50, 0, 0)
        return _assemble(3, [[_splats(rng, L, 16 * (t % 3), 16 * (t // 3), (1.5, 4), (0.02, 0.3))]
                             if L else [] for t, L in enumerate(lens)])
    if name == "giant_splat":             # one splat over all 3×3 tiles, mid-depth
        giant = np.array([[24.0, 24.0, 1 / 900, 1e-4, 1 / 700, 0.6, 0.9, 0.1, 0.5, 2.0]])
        segs = []
        for t in range(9):
            before = _splats(rng, 90, 16 * (t % 3), 16 * (t // 3), (1.5, 4), (0.02, 0.3))
            after = _splats(rng, 200, 16 * (t % 3), 16 * (t // 3), (1.5, 4), (0.02, 0.3))
            segs.append([before, 0, after])
        return _assemble(3, segs, extra=giant)
    if name == "alpha_clamp":             # opacity-1 pairs on pixel centres: α clamped at 0.999
        segs = []
        for t in range(2):
            body = _splats(rng, 300 + 300 * t, 16 * t, 0, (1.5, 4), (0.05, 0.5))
            body[::7, 0] = np.floor(body[::7, 0]) + 0.5
            body[::7, 1] = np.floor(body[::7, 1]) + 0.5
            body[::7, 5] = rng.uniform(0.9995, 1.0, size=len(body[::7]))
            segs.append([body])
        return _assemble(2, segs)
    if name == "whole_batches":           # 512, 256 and 768 pairs: no ragged batch
        lens = (512, 256, 768)
        return _assemble(3, [[_splats(rng, L, 16 * t, 0, (1.5, 4), (0.01, 0.05))]
                             for t, L in enumerate(lens)])
    raise KeyError(name)


CASES = ["stops_mid_segment", "never_stops", "ragged_last_batch", "empty_tiles",
         "giant_splat", "alpha_clamp", "whole_batches"]


def _cotangent(n_tiles, seed=3):
    return np.random.default_rng(seed).normal(size=(n_tiles, 256, 6)).astype(np.float32)


def _split(packed, pg, bounds, tiles_x, go):
    t = [torch.as_tensor(x) for x in (packed, pg, bounds, go)]
    out, n_done, state = gt.composite_fwd_plain(t[0], t[1], t[2], tiles_x)
    dpacked = gt.composite_bwd_plain(t[0], t[1], t[2], out, n_done, state, t[3], tiles_x)
    return out.numpy(), n_done.numpy(), state.numpy(), dpacked.numpy()


def _assert_grads_close(ours, ref, rel):
    top = np.abs(ref).max()
    for c in range(ref.shape[1]):
        scale = max(np.abs(ref[:, c]).max(), 1e-3 * top)
        np.testing.assert_allclose(ours[:, c], ref[:, c], atol=rel * scale, rtol=0,
                                   err_msg=f"column {c}")


@pytest.mark.parametrize("name", CASES)
def test_split_matches_plain_compositor(name):
    packed, pg, bounds, tiles_x = _case(name)
    go = _cotangent(len(bounds) - 1)
    out, n_done, state, dpacked = _split(packed, pg, bounds, tiles_x, go)
    pk = torch.as_tensor(packed).requires_grad_(True)
    ref = rasterize_gaussians_plain(pk, torch.as_tensor(pg), torch.as_tensor(bounds), tiles_x)
    g_ref, = torch.autograd.grad(ref, pk, torch.as_tensor(go))
    np.testing.assert_allclose(out, ref.detach().numpy(), atol=2e-5, rtol=1e-5)
    assert np.isfinite(dpacked).all()
    _assert_grads_close(dpacked, g_ref.numpy(), 1e-4)
    lens = np.diff(bounds)
    if name == "stops_mid_segment":
        assert 1 < n_done[0] < -(-lens[0] // BATCH), n_done
    if name in ("never_stops", "ragged_last_batch", "whole_batches"):
        np.testing.assert_array_equal(n_done, -(-lens // BATCH))
    if name == "empty_tiles":
        assert (n_done[lens == 0] == 0).all() and (out[lens == 0] == 0).all()


@pytest.mark.parametrize("name", CASES)
def test_split_matches_pallas_interpret(name):
    packed, pg, bounds, tiles_x = _case(name)
    n_tiles, m = len(bounds) - 1, len(pg)
    go = _cotangent(n_tiles)
    t = [torch.as_tensor(x) for x in (packed, pg, bounds)]
    go[..., 5] *= np.exp(rasterize_gaussians_plain(*t, tiles_x)[..., 5].numpy())
    out, _, _, dpacked = _split(packed, pg, bounds, tiles_x, go)
    pairs_t = np.zeros((NCH, m + CHUNK), np.float32)
    pairs_t[:10, :m] = packed[pg].T
    composite = _make_composite(n_tiles, tiles_x, m + CHUNK, True)
    bj = jnp.asarray(bounds)
    out_j, vjp = jax.vjp(lambda p: composite(p, bj), jnp.asarray(pairs_t))
    go_j = np.zeros((n_tiles, 256, 8), np.float32)
    go_j[..., :6] = go
    dpairs = np.asarray(vjp(jnp.asarray(go_j))[0])
    d_ref = np.zeros_like(packed)
    np.add.at(d_ref, pg, dpairs[:10, :m].T)
    out_j = np.asarray(out_j)
    np.testing.assert_allclose(out[..., :5], out_j[..., :5], atol=5e-4)
    np.testing.assert_allclose(np.exp(out[..., 5]), np.exp(out_j[..., 5]), atol=5e-4)
    _assert_grads_close(dpacked, d_ref, 5e-4)


def _numpy_state(packed, pg, bounds, tiles_x):
    """Batches run and state rows by a float64 brute force over each tile's
    whole segment."""
    n_tiles = len(bounds) - 1
    p = np.arange(256)
    n_done = np.zeros(n_tiles, np.int64)
    rows = {}
    row = 0
    for t in range(n_tiles):
        seg = packed[pg[bounds[t]:bounds[t + 1]]].astype(np.float64)
        nb = -(-len(seg) // BATCH)
        px = (t % tiles_x) * 16 + p % 16 + 0.5
        py = (t // tiles_x) * 16 + p // 16 + 0.5
        dx, dy = px[None] - seg[:, 0:1], py[None] - seg[:, 1:2]
        sig = 0.5 * (seg[:, 2:3] * dx * dx + seg[:, 4:5] * dy * dy) + seg[:, 3:4] * dx * dy
        raw = seg[:, 5:6] * np.exp(-np.maximum(sig, 0))
        alpha = np.where((sig >= 0) & (raw >= 1 / 255), np.minimum(raw, 0.999), 0.0)
        l = np.log1p(-alpha)
        excl = np.cumsum(l, 0) - l
        w = alpha * np.exp(excl)
        terms = np.stack([w * seg[:, 6:7], w * seg[:, 7:8], w * seg[:, 8:9], w, w * seg[:, 9:10]])
        for j in range(nb):
            k = j * BATCH
            if j > 0 and excl[k].max() < LN_T_STOP:
                break
            before = excl[k]
            rows[row + j] = np.concatenate([before[None], terms[:, :k].sum(1)])
            n_done[t] = j + 1
        row += nb
    return n_done, rows


@pytest.mark.parametrize("name", CASES)
def test_split_state_matches_float64(name):
    packed, pg, bounds, tiles_x = _case(name)
    _, n_done, state, _ = _split(packed, pg, bounds, tiles_x, _cotangent(len(bounds) - 1))
    ref_done, ref_rows = _numpy_state(packed, pg, bounds, tiles_x)
    np.testing.assert_array_equal(n_done, ref_done)
    for r, ref in ref_rows.items():
        np.testing.assert_allclose(state[r, 0], ref[0], atol=1e-4, rtol=2e-5, err_msg=f"row {r}")
        np.testing.assert_allclose(state[r, 1:], ref[1:], atol=1e-4, err_msg=f"row {r}")
    assert len(ref_rows) == int(n_done.sum()) and len(state) == gt.state_rows(len(n_done), len(pg))


@pytest.mark.parametrize("seed", range(3))
def test_state_rows_bound_the_items(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 3 * BATCH, size=50) * rng.integers(0, 2, size=50)
    bounds = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32))
    row_start, tile, batch = gt.work_items(bounds)
    assert int(row_start[-1]) == int((-(-lens // BATCH)).sum()) == tile.shape[0]
    assert int(row_start[-1]) <= gt.state_rows(50, int(lens.sum()))
    assert (batch < torch.as_tensor(-(-lens // BATCH))[tile]).all()


def test_kernel_wrappers_refuse_cpu_tensors():
    packed, pg, bounds, tiles_x = _case("ragged_last_batch")
    t = [torch.as_tensor(x) for x in (packed, pg, bounds)]
    with pytest.raises(ValueError, match="CUDA"):
        gt.composite_fwd_cuda(*t, tiles_x)
    out, n_done, state = gt.composite_fwd_plain(*t, tiles_x)
    with pytest.raises(ValueError, match="CUDA"):
        gt.composite_bwd_cuda(*t, out, n_done, state, torch.zeros_like(out), tiles_x)
    assert gt.KERNEL_FWD._lib is None and gt.KERNEL_BWD._lib is None
