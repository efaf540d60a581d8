"""Parity of the port's 3DGS renderer (``cap4d_torch.ops.gsplat`` and
``ops.gsplat_tiles``, plain compositor on the CPU) with ``cap4d_tpu.ops.
gsplat`` and with the Pallas tile kernel run in interpret mode, plus the
numpy brute force of ``tests/test_gsplat.py``.

Tolerances: SH and projection are the same fp32 formulas (1e-5, radii
exact); forward images 5e-4 absolute (fp32 sums in another order, and a
tile that stops early differs from the TPU's stop rule by < 1e-4 of a
colour); gradients 5e-4 of the largest gradient of each input, as
``tests/test_gsplat_pallas.py`` holds the Pallas VJP.
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from cap4d_tpu.ops import gsplat as jgs
from cap4d_tpu.ops.gsplat_pallas import rasterize_gaussians_pallas
from cap4d_torch.ops import gsplat as tgs
from cap4d_torch.ops import gsplat_tiles
from cap4d_torch.ops.gsplat_tiles import rasterize_gaussians, tile_pairs
from tests.test_gsplat import _scene, numpy_render
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_sh_and_quats_match_jax():
    rng = np.random.default_rng(5)
    sh = rng.normal(scale=0.3, size=(64, 25, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    for deg in range(5):
        ref = np.asarray(jgs.eval_sh(jnp.asarray(sh), jnp.asarray(dirs), deg))
        np.testing.assert_allclose(tgs.eval_sh(*_t(sh, dirs), deg).numpy(), ref, atol=1e-5)
        ch = tgs.eval_sh_ch(torch.as_tensor(sh), *torch.as_tensor(dirs).unbind(-1), deg)
        np.testing.assert_allclose(ch.numpy().T, ref, atol=1e-5)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(tgs.quat_to_rotmat(torch.as_tensor(q)).numpy(),
                               np.asarray(jgs.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tgs.sh2rgb(tgs.rgb2sh(torch.as_tensor(rgb))).numpy(), rgb,
                               atol=1e-6)


def test_projection_matches_jax():
    means, quats, scales, opac, sh, viewmat, K = _scene(n=60, seed=2)
    ours = tgs.project_gaussians(*_t(means, quats, scales, viewmat, K), 64, 48)
    ref = jgs.project_gaussians(*_j(means, quats, scales, viewmat, K), 64, 48)
    for name, a, b in zip(["means2d", "conic", "depth", "radius", "valid"], ours, ref):
        b = np.asarray(b)
        if name in ("radius", "valid"):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("sh_degree", [0, 3])
def test_forward_matches_pallas_and_bruteforce(sh_degree):
    means, quats, scales, opac, sh, viewmat, K = _scene(n=60)
    W = H = 64
    bg = np.ones(3, np.float32)
    out = rasterize_gaussians(*_t(means, quats, scales, opac, sh, viewmat, K), W, H,
                              sh_degree=sh_degree, background=torch.as_tensor(bg),
                              render_depth=True)
    pal = rasterize_gaussians_pallas(*_j(means, quats, scales, opac, sh, viewmat, K), W, H,
                                     sh_degree=sh_degree, background=jnp.asarray(bg),
                                     render_depth=True, max_tiles_per_gaussian=36,
                                     interpret=True)
    ref_img, ref_alpha = numpy_render(means, quats, scales, opac, sh, viewmat, K, W, H,
                                      sh_degree, bg)
    assert int(out["n_truncated"]) == 0 and int(out["n_truncated_depth"]) == 0
    for key in ("render", "alpha"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(pal[key]), atol=5e-4)
    np.testing.assert_allclose(out["render"].numpy(), ref_img, atol=5e-4)
    np.testing.assert_allclose(out["alpha"].numpy(), ref_alpha, atol=5e-4)
    cov = np.asarray(pal["alpha"]) > 1e-2
    np.testing.assert_allclose(out["depth"].numpy()[cov], np.asarray(pal["depth"])[cov],
                               rtol=5e-4)
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(pal["radii"]))
    np.testing.assert_array_equal(out["visibility"].numpy(), np.asarray(pal["visibility"]))


def _grads_both(means, quats, scales, opac, sh, viewmat, K, W, H):
    """Gradients of one loss (rgb, alpha and depth terms) through the
    Pallas VJP (interpret mode) and through the port's plain compositor."""
    target = np.random.default_rng(0).uniform(size=(H, W, 3)).astype(np.float32)

    def jloss(m, s, o, shh, off):
        r = rasterize_gaussians_pallas(m, jnp.asarray(quats), s, o, shh, jnp.asarray(viewmat),
                                       jnp.asarray(K), W, H, sh_degree=1,
                                       max_tiles_per_gaussian=36, means2d_offset=off,
                                       render_depth=True, interpret=True)
        return (jnp.mean((r["render"] - target) ** 2) + 0.1 * jnp.mean(r["alpha"])
                + 0.01 * jnp.mean(r["depth"] * r["alpha"]))

    n = len(means)
    g_jax = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*_j(means, scales, opac, sh),
                                                      jnp.zeros((n, 2)))
    xs = [x.requires_grad_(True) for x in _t(means, scales, opac, sh, np.zeros((n, 2), np.float32))]
    r = rasterize_gaussians(xs[0], torch.as_tensor(quats), xs[1], xs[2], xs[3],
                            *_t(viewmat, K), W, H, sh_degree=1, means2d_offset=xs[4],
                            render_depth=True)
    tgt = torch.as_tensor(target)
    loss = (((r["render"] - tgt) ** 2).mean() + 0.1 * r["alpha"].mean()
            + 0.01 * (r["depth"] * r["alpha"]).mean())
    return g_jax, torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("high_opacity", [False, True])
def test_gradients_match_pallas_vjp(high_opacity):
    means, quats, scales, opac, sh, viewmat, K = _scene(n=40, seed=3)
    if high_opacity:
        # alphas reach the 0.999 clamp (zero gradient there) and 1/(1-α) is large
        opac = np.random.default_rng(4).uniform(0.95, 1.0, size=opac.shape).astype(np.float32)
    g_jax, g_ours = _grads_both(means, quats, scales, opac, sh, viewmat, K, 32, 32)
    for name, gj, go in zip(["means", "scales", "opac", "sh", "means2d_offset"], g_jax, g_ours):
        gj, go = np.asarray(gj), go.numpy()
        assert np.isfinite(go).all(), name
        scale = np.abs(gj).max() + 1e-12
        np.testing.assert_allclose(go / scale, gj / scale, atol=5e-4, err_msg=name)


def test_deep_stack_no_truncation():
    """300 gaussians on one tile (> 192 pairs, two compositing batches)."""
    n = 300
    rng = np.random.default_rng(7)
    means = np.concatenate([rng.normal(scale=0.002, size=(n, 2)),
                            np.linspace(2.0, 4.0, n)[:, None]], axis=1).astype(np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 0.02, np.float32)
    opac = np.full((n,), 0.05, np.float32)
    sh = np.zeros((n, 1, 3), np.float32)
    sh[:, 0] = rng.uniform(-0.3, 0.3, size=(n, 3))
    viewmat = np.eye(4, dtype=np.float32)
    K = np.array([[100.0, 0, 16], [0, 100.0, 16], [0, 0, 1]], np.float32)
    out = rasterize_gaussians(*_t(means, quats, scales, opac, sh, viewmat, K), 32, 32,
                              sh_degree=0)
    assert int(out["n_truncated"]) == 0 and out["n_pairs"] > 192
    ref_img, ref_alpha = numpy_render(means, quats, scales, opac, sh, viewmat, K, 32, 32, 0,
                                      np.ones(3, np.float32))
    np.testing.assert_allclose(out["render"].numpy(), ref_img, atol=5e-4)
    np.testing.assert_allclose(out["alpha"].numpy(), ref_alpha, atol=5e-4)


def test_giant_splat_partly_offscreen():
    """A splat spanning most of the tile grid (and past its edge) is covered
    on every tile its box touches: no truncation, brute-force agreement."""
    n = 40
    rng = np.random.default_rng(9)
    means = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    means[:, 2] += 3.0
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 0.03, np.float32)
    scales[0] = 0.55
    means[0] = [0.3, -0.2, 4.0]
    opac = rng.uniform(0.3, 0.9, size=(n,)).astype(np.float32)
    sh = np.zeros((n, 1, 3), np.float32)
    sh[:, 0] = rng.uniform(-0.5, 0.5, size=(n, 3))
    viewmat = np.eye(4, dtype=np.float32)
    K = np.array([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    out = rasterize_gaussians(*_t(means, quats, scales, opac, sh, viewmat, K), 64, 64,
                              sh_degree=0)
    assert int(out["n_truncated"]) == 0
    assert float(out["radii"][0]) > 40          # box past both image edges
    ref_img, ref_alpha = numpy_render(means, quats, scales, opac, sh, viewmat, K, 64, 64, 0,
                                      np.ones(3, np.float32))
    np.testing.assert_allclose(out["render"].numpy(), ref_img, atol=5e-4)
    np.testing.assert_allclose(out["alpha"].numpy(), ref_alpha, atol=5e-4)


def test_early_termination_of_opaque_tiles():
    """A wall of 600 near-opaque splats drives every pixel's T below 1e-4
    within the first batch; the plain compositor stops at the batch
    boundary and stays within 1e-4 of the full brute-force composite."""
    rng = np.random.default_rng(12)
    n = 600
    means = np.concatenate([rng.uniform(-0.12, 0.12, size=(n, 2)),
                            np.linspace(2.0, 3.0, n)[:, None]], axis=1).astype(np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 0.3, np.float32)
    opac = np.full((n,), 0.99, np.float32)
    sh = np.zeros((n, 1, 3), np.float32)
    sh[:, 0] = rng.uniform(-0.5, 0.5, size=(n, 3))
    viewmat = np.eye(4, dtype=np.float32)
    K = np.array([[60.0, 0, 8], [0, 60.0, 8], [0, 0, 1]], np.float32)
    args = _t(means, quats, scales, opac, sh, viewmat, K)
    out = rasterize_gaussians(*args, 16, 16, sh_degree=0)
    ch = tgs.project_gaussians_ch(*args[:3], args[5], args[6], 16, 16)
    pg, bounds = tile_pairs(ch["mean_x"], ch["mean_y"], ch["conic_a"], ch["conic_b"],
                            ch["conic_c"], args[3], ch["radius"], ch["valid"], ch["depth"],
                            16, 16)
    assert int(bounds[1] - bounds[0]) > tgs.BATCH
    assert float(out["alpha"].min()) > 1 - 1e-4
    # the tile ran exactly its first batch: same result as its first 256 pairs
    rgb = tgs.eval_sh(args[4], torch.nn.functional.normalize(args[0], dim=-1), 0) + 0.5
    packed = torch.stack([ch["mean_x"], ch["mean_y"], ch["conic_a"], ch["conic_b"],
                          ch["conic_c"], args[3], *rgb.clamp(min=0).unbind(-1), ch["depth"]], -1)
    full = tgs.rasterize_gaussians_plain(packed, pg, bounds, 1)
    first = tgs.rasterize_gaussians_plain(packed, pg, torch.tensor([0, tgs.BATCH]), 1)
    np.testing.assert_array_equal(full.numpy(), first.numpy())
    ref_img, ref_alpha = numpy_render(means, quats, scales, opac, sh, viewmat, K, 16, 16, 0,
                                      np.ones(3, np.float32))
    np.testing.assert_allclose(out["render"].numpy(), ref_img, atol=2e-4)
    np.testing.assert_allclose(out["alpha"].numpy(), ref_alpha, atol=2e-4)


def test_tile_pairs_order_and_cover():
    """Pairs are tile-major, front to back, depth ties broken by index; the
    alpha-bound cull drops no tile that a kept pixel needs."""
    means, quats, scales, opac, sh, viewmat, K = _scene(n=50, seed=6)
    means[10:20, 2] = 3.0                                  # exact depth ties
    args = _t(means, quats, scales, opac, sh, viewmat, K)
    ch = tgs.project_gaussians_ch(*args[:3], args[5], args[6], 64, 64)
    pg, bounds = tile_pairs(ch["mean_x"], ch["mean_y"], ch["conic_a"], ch["conic_b"],
                            ch["conic_c"], args[3], ch["radius"], ch["valid"], ch["depth"],
                            64, 64)
    depth = ch["depth"].numpy()
    b = bounds.numpy()
    assert b[0] == 0 and (np.diff(b) >= 0).all() and b[-1] == pg.shape[0]
    for t in range(len(b) - 1):
        seg = pg[b[t]:b[t + 1]].long().numpy()
        key = np.stack([depth[seg], seg], axis=1)
        assert all(tuple(key[i]) < tuple(key[i + 1]) for i in range(len(seg) - 1)), t
    # brute-force keep mask: every tile of a splat's 3σ box holding a kept
    # pixel has the pair (kept pixels past the box are outside the contract)
    ys, xs = np.mgrid[0:64, 0:64] + 0.5
    valid = ch["valid"].numpy()
    for g in np.nonzero(valid)[0]:
        dx, dy = xs - ch["mean_x"][g].item(), ys - ch["mean_y"][g].item()
        a, bb, c = (ch[k][g].item() for k in ("conic_a", "conic_b", "conic_c"))
        sig = 0.5 * (a * dx * dx + c * dy * dy) + bb * dx * dy
        r = ch["radius"][g].item()
        inbox = (np.floor(xs / 16) >= np.floor((ch["mean_x"][g].item() - r) / 16)) & (
            np.floor(xs / 16) <= np.floor((ch["mean_x"][g].item() + r) / 16)) & (
            np.floor(ys / 16) >= np.floor((ch["mean_y"][g].item() - r) / 16)) & (
            np.floor(ys / 16) <= np.floor((ch["mean_y"][g].item() + r) / 16))
        kept = (sig >= 0) & (opac[g] * np.exp(-np.maximum(sig, 0)) >= 1 / 255) & inbox
        for t in np.unique((ys[kept] // 16).astype(int) * 4 + (xs[kept] // 16).astype(int)):
            assert g in pg[b[t]:b[t + 1]].long().numpy(), (g, t)


def test_cpu_tensors_never_launch_kernels():
    means, quats, scales, opac, sh, viewmat, K = _scene(n=10, seed=1)
    before = (gsplat_tiles.KERNEL_FWD.launches, gsplat_tiles.KERNEL_BWD.launches)
    xs = [x.requires_grad_(True) for x in _t(means, scales)]
    out = rasterize_gaussians(xs[0], torch.as_tensor(quats), xs[1], *_t(opac, sh, viewmat, K),
                              32, 32, sh_degree=0)
    out["render"].sum().backward()
    assert (gsplat_tiles.KERNEL_FWD.launches, gsplat_tiles.KERNEL_BWD.launches) == before
    assert gsplat_tiles.KERNEL_FWD._lib is None and gsplat_tiles.KERNEL_BWD._lib is None
