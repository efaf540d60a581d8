"""cap4d_torch FLAME, data pipeline, conditioning banks and schedules against
cap4d_tpu on the same synthetic assets (CPU, fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_torch.data import datasets as tdata
from cap4d_torch.flame import compute as tcompute
from cap4d_torch.flame import io as tio
from cap4d_torch.flame import skinner as tskin
from cap4d_torch.mmdm import conditioning as tcond
from cap4d_torch.mmdm import schedule as tsched
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_tpu.data import datasets as jdata
from cap4d_tpu.flame import compute as jcompute
from cap4d_tpu.flame import io as jio
from cap4d_tpu.flame import skinner as jskin
from cap4d_tpu.mmdm import conditioning as jcond
from cap4d_tpu.mmdm import schedule as jsched


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    flame_dir = sa.make_asset_dir(root)
    ref_dir = sa.make_reference_dir(root, resolution=256)
    bank = dict(np.load(sa.make_gen_bank(root, n=16)))
    return flame_dir, ref_dir, bank


def test_synthetic_flame_matches():
    a, b = jio.make_synthetic_flame(n_verts=300, seed=3), tio.make_synthetic_flame(n_verts=300, seed=3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for r in (1.0, 0.5):
        va, fa = jskin.generate_uv_half_sphere(r)
        vb, fb = tskin.generate_uv_half_sphere(r)
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("extras", [(), ("jaw_rot", "neck_rot"), ("lower_jaw",)])
def test_compute_flame_matches(assets, extras):
    flame_dir = assets[0]
    lower = "lower_jaw" in extras
    jm = jcompute.load_cap4d_flame_model(flame_dir, 150, 65, add_mouth=True, add_lower_jaw=lower)
    tm = tcompute.load_cap4d_flame_model(flame_dir, 150, 65, add_mouth=True, add_lower_jaw=lower)
    rng = np.random.default_rng(4)
    f32 = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    fit = dict(shape=f32(150, scale=0.3), expr=f32(3, 65, scale=0.3), rot=f32(3, 3, scale=0.1),
               tra=f32(3, 3, scale=0.01), eye_rot=f32(3, 3, scale=0.1),
               fx=np.full((2, 1), 800.0, np.float32), fy=np.full((2, 1), 810.0, np.float32),
               cx=np.full((2, 1), 256.0, np.float32), cy=np.full((2, 1), 250.0, np.float32),
               extr=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)))
    fit["extr"][:, 2, 3] = 1.5
    for k in extras:
        if k != "lower_jaw":
            fit[k] = f32(3, 3, scale=0.1)
    a, b = jcompute.compute_flame(jm, fit), tcompute.compute_flame(tm, fit)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        # 3e-5 relative: fp32 sums in another order (pixel coords are ~1e2-1e3)
        np.testing.assert_allclose(b[k], a[k], rtol=3e-5, atol=3e-6, err_msg=k)


@pytest.fixture(scope="module")
def frame_sets(assets):
    """Reference + generation frame sets from both packages (both read the
    reference frames through their native loaders)."""
    flame_dir, ref_dir, bank = assets
    out = {}
    for pkg, data, comp in (("jax", jdata, jcompute), ("torch", tdata, tcompute)):
        fm = comp.load_cap4d_flame_model(flame_dir, 150, 65, add_mouth=True)
        head = np.genfromtxt(flame_dir / "head_vertices.txt").astype(int)
        items, extr = data.load_reference_items(ref_dir)
        ref = data.build_frame_set(fm, items, head, extr, 64, is_reference=True)
        gen_items = data.make_generation_items(bank, items[0], n_samples=7,
                                               rng=np.random.RandomState(124))
        gen = data.build_frame_set(fm, gen_items, head, extr, 64)
        out[pkg] = (ref, gen)
    return out


def test_build_frame_set_matches(frame_sets):
    for jfs, tfs in zip(frame_sets["jax"], frame_sets["torch"]):
        for a, b in zip(jfs.flame_items, tfs.flame_items):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_allclose(np.asarray(b[k], float), np.asarray(a[k], float),
                                           rtol=1e-6, err_msg=k)
        for k in ("verts_2d", "offsets_3d", "ray_map", "reference_mask", "out_crop_mask"):
            # fp32, the depth channel is ~1e3
            np.testing.assert_allclose(getattr(tfs, k), getattr(jfs, k), rtol=1e-5, atol=3e-5,
                                       err_msg=k)
        if jfs.images is not None:
            np.testing.assert_allclose(tfs.images, jfs.images, atol=1e-5)


def test_conditioning_banks_match(assets, frame_sets):
    """50-channel banks: rasterize at 2x, interpolate, positional encoding,
    area pool, ray/ref/crop channels; the unconditional bank is zeros."""
    flame_dir = assets[0]
    tpl, head = flame_dir / "cap4d_flame_template.obj", flame_dir / "head_vertices.txt"
    kw = dict(image_size=8, positional_channels=42, super_resolution=2, use_crop_mask=True)
    jc = jcond.CAP4DConditioning(assets=jcond.load_prop_renderer_assets(tpl, head), **kw)
    tc = tcond.CAP4DConditioning(assets=tcond.load_prop_renderer_assets(tpl, head), **kw)
    for jfs, tfs in zip(frame_sets["jax"], frame_sets["torch"]):
        batch = jfs.cond_batch()
        ja = jcond.conditioning_forward(jc, {k: jnp.asarray(v) for k, v in batch.items()},
                                        unconditional=False)
        ta = tcond.conditioning_forward(tc, {k: torch.as_tensor(v) for k, v in batch.items()},
                                        unconditional=False)
        pe_j, pe_t = np.asarray(ja["pos_enc"]), ta["pos_enc"].numpy()
        assert pe_t.shape == pe_j.shape and pe_t.shape[-1] == 50
        # a pixel on a shared edge may pick the other face where XLA contracts
        # to FMA: allow 1e-3 of the latent pixels to differ, the rest to 1e-4
        close = np.isclose(pe_t, pe_j, atol=1e-4).all(axis=-1)
        assert close.mean() >= 0.999, close.mean()
        np.testing.assert_allclose(ta["ref_mask"].numpy(), np.asarray(ja["ref_mask"]))
        un = tcond.conditioning_forward(tc, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert not un["pos_enc"].any()
        vis_t = tc.get_vis(ta["pos_enc"])
        assert vis_t.keys() == jc.get_vis(ja["pos_enc"]).keys()


SCHED_VARIANTS = [
    dict(),
    dict(shift=False),
    dict(sqrt_shift=False, minus_one_shift=False),
    dict(zero_snr_shift=False, beta_schedule="cosine"),
    dict(negative_shift=True, image_size=32, n_frames=4),
]


@pytest.mark.parametrize("kw", SCHED_VARIANTS)
def test_schedule_bit_for_bit(kw):
    a, b = jsched.make_mmdm_schedule(**kw), tsched.make_mmdm_schedule(**kw)
    for field in a.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field), err_msg=field)
    for S in (10, 50, 250):
        ts_a = jsched.make_ddim_timesteps(S, a.num_timesteps)
        np.testing.assert_array_equal(tsched.make_ddim_timesteps(S, b.num_timesteps), ts_a)
        for eta in (0.0, 0.5):
            for x, y in zip(jsched.make_ddim_sampling_parameters(a.alphas_cumprod, ts_a, eta),
                            tsched.make_ddim_sampling_parameters(b.alphas_cumprod, ts_a, eta)):
                np.testing.assert_array_equal(y, x)
