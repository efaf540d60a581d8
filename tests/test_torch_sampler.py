"""cap4d_torch's stochastic I/O sampler against cap4d_tpu's with a
deterministic stand-in denoiser and the same initial latent bank."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_torch.mmdm.sampler import StochasticIOSampler as TSampler
from cap4d_tpu.mmdm.sampler import StochasticIOSampler as JSampler
from cap4d_tpu.mmdm.schedule import make_mmdm_schedule

LAT, C_COND = 8, 6


def _eps(x, pos_enc, z_input, ref, lib):
    """eps := 0.1·x + mean(pos_enc), with the reference-slot passthrough."""
    bias = lib.mean(pos_enc, -1, keepdims=True) if lib is jnp else pos_enc.mean(-1, keepdim=True)
    return (x - z_input) * ref + (0.1 * x + bias) * (1.0 - ref)


class JFake:
    in_channels = 4

    def apply(self, variables, x, t, cond):
        return _eps(x, cond["pos_enc"], cond["z_input"], cond["ref_mask"], jnp)


class TFake(torch.nn.Module):
    in_channels = 4

    def forward(self, x, t, cond):
        return _eps(x, cond["pos_enc"], cond["z_input"], cond["ref_mask"], torch)


def _models():
    sched = make_mmdm_schedule(n_frames=8, image_size=LAT)
    jm = types.SimpleNamespace(unet=JFake(), unet_params={}, schedule=sched, latent_size=LAT)
    tm = types.SimpleNamespace(unet=TFake(), schedule=sched, latent_size=LAT,
                               device=torch.device("cpu"))
    return jm, tm


def _banks(n, seed):
    rng = np.random.default_rng(seed)
    return {"pos_enc": rng.normal(size=(n, LAT, LAT, C_COND)).astype(np.float32),
            "z_input": rng.normal(size=(n, LAT, LAT, 4)).astype(np.float32),
            "ref_mask": np.ones((n, LAT, LAT, 1), np.float32)}


@pytest.mark.parametrize("n_ref,n_gen,R", [(4, 12, 4), (1, 14, 4)])
def test_sampler_matches_jax(n_ref, n_gen, R):
    jm, tm = _models()
    ref_cond, gen_cond = _banks(n_ref, 1), _banks(n_gen, 2)
    kw = dict(S=4, ref_cond=ref_cond, gen_cond=gen_cond, V=8, R_max=R, cfg_scale=2.0, seed=7,
              verbose=False)
    rng = jax.random.PRNGKey(7)
    x0 = np.array(jax.random.normal(rng, (n_gen, LAT, LAT, 4), jnp.float32))
    ref = np.asarray(JSampler(jm).sample(rng=rng, **kw))
    tcond = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in
             (("ref_cond", ref_cond), ("gen_cond", gen_cond))}
    out = TSampler(tm).sample(**dict(kw, **tcond), x_bank=x0).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_sampler_checkpoint_resume_and_checks(tmp_path):
    _, tm = _models()
    kw = dict(S=4, ref_cond=_banks(4, 1), gen_cond=_banks(12, 2), V=8, R_max=4, cfg_scale=2.0,
              seed=7, verbose=False, x_bank=np.random.default_rng(0).normal(
                  size=(12, LAT, LAT, 4)).astype(np.float32))
    full = TSampler(tm).sample(**kw).numpy()

    class Stop(Exception):
        pass

    def stop_at(step, total):
        if step == 2:
            raise Stop

    with pytest.raises(Stop):
        TSampler(tm).sample(checkpoint_dir=str(tmp_path), checkpoint_every=1,
                            progress_cb=stop_at, **kw)
    resumed = TSampler(tm).sample(checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    np.testing.assert_array_equal(resumed.numpy(), full)

    with pytest.raises(ValueError, match="divisible"):
        TSampler(tm).sample(**dict(kw, gen_cond=_banks(9, 2), x_bank=None))
    with pytest.raises(ValueError, match="x_bank"):
        TSampler(tm).sample(**dict(kw, x_bank=np.zeros((3, LAT, LAT, 4), np.float32)))


@pytest.mark.parametrize("cfg_scale", [1.0, 2.5])
def test_plain_ddim_matches_jax(cfg_scale):
    from cap4d_torch.mmdm.ddim import ddim_sample as t_ddim
    from cap4d_tpu.mmdm.ddim import ddim_sample as j_ddim

    jm, tm = _models()
    shape = (2, 8, LAT, LAT, 4)
    cond = {k: v.reshape(2, 8, *v.shape[1:]) for k, v in _banks(16, 3).items()}
    cond["ref_mask"][:, 0] = 1.0
    cond["ref_mask"][:, 1:] = 0.0
    uncond = dict(cond, pos_enc=np.zeros_like(cond["pos_enc"]),
                  z_input=np.zeros_like(cond["z_input"]))
    rng = jax.random.PRNGKey(5)
    x0 = np.array(jax.random.normal(rng, shape, jnp.float32))
    ref = j_ddim(jm, {k: jnp.asarray(v) for k, v in cond.items()}, shape, steps=5,
                 cfg_scale=cfg_scale, uncond={k: jnp.asarray(v) for k, v in uncond.items()},
                 rng=rng)
    out = t_ddim(tm, {k: torch.from_numpy(v) for k, v in cond.items()}, shape, steps=5,
                 cfg_scale=cfg_scale, uncond={k: torch.from_numpy(v) for k, v in uncond.items()},
                 x=x0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_ref,n_gen,R,groups_per_device", [
    (4, 12, 4, 2), (4, 12, 4, 3), (4, 12, 4, 4),   # 3 groups: 2 and 4 fall back to 1 and 3
    (1, 14, 4, 2),                                  # 2 groups in one call
    (1, 28, 4, 1), (1, 28, 4, 3), (1, 28, 4, 4),    # 4 groups: 3 falls back to 2
])
def test_batched_sampler_matches_jax(n_ref, n_gen, R, groups_per_device):
    """n_par groups in one UNet call of batch 2·n_par, at the JAX package's
    groups_per_device (one device)."""
    from cap4d_torch.mmdm.sampler import parallel_groups

    jm, tm = _models()
    ref_cond, gen_cond = _banks(n_ref, 1), _banks(n_gen, 2)
    kw = dict(S=2, ref_cond=ref_cond, gen_cond=gen_cond, V=8, R_max=R, cfg_scale=2.0, seed=7,
              verbose=False)
    rng = jax.random.PRNGKey(3)
    x0 = np.array(jax.random.normal(rng, (n_gen, LAT, LAT, 4), jnp.float32))
    ref = np.asarray(JSampler(jm, mesh=None, groups_per_device=groups_per_device)
                     .sample(rng=rng, **kw))
    tcond = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in
             (("ref_cond", ref_cond), ("gen_cond", gen_cond))}

    calls = []

    class Counted(TFake):
        def forward(self, x, t, cond):
            calls.append(x.shape[0])
            return super().forward(x, t, cond)

    tm.unet = Counted()
    out = TSampler(tm, groups_per_device=groups_per_device).sample(
        **dict(kw, **tcond), x_bank=x0).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    n_groups = n_gen // (8 - min(n_ref, R))
    n_par = parallel_groups(n_groups, groups_per_device)
    assert n_par == {(3, 2): 1, (3, 4): 3, (4, 3): 2}.get((n_groups, groups_per_device),
                                                             min(groups_per_device, n_groups))
    assert calls == [2 * n_par] * (2 * n_groups // n_par)


def _nan_at_step(lib, t_nan):
    """The fake denoiser, returning NaN wherever the timestep is ``t_nan``."""
    def eps(x, t, cond):
        out = _eps(x, cond["pos_enc"], cond["z_input"], cond["ref_mask"], lib)
        hit = (t == t_nan)[..., None, None, None]
        return lib.where(hit, lib.full_like(out, float("nan")), out)
    return eps


def test_detect_anomaly_raises_floating_point_error():
    """A denoiser that returns NaN at DDIM step 2: the port's detect_anomaly
    raises FloatingPointError naming the step and round, as the JAX sampler
    does under jax_debug_nans."""
    from cap4d_torch.mmdm.schedule import make_ddim_timesteps

    jm, tm = _models()
    S = 4
    t_nan = int(np.flip(make_ddim_timesteps(S, tm.schedule.num_timesteps))[2])
    ref_cond, gen_cond = _banks(1, 1), _banks(14, 2)
    kw = dict(S=S, V=8, R_max=4, cfg_scale=2.0, seed=7, verbose=False)
    x0 = np.random.default_rng(0).normal(size=(14, LAT, LAT, 4)).astype(np.float32)
    tcond = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in
             (("ref_cond", ref_cond), ("gen_cond", gen_cond))}
    class TNaN(TFake):
        def forward(self, x, t, cond):
            return _nan_at_step(torch, t_nan)(x, t, cond)

    tm.unet = TNaN()
    # without the flag the NaN runs through to the output
    out = TSampler(tm).sample(**kw, **tcond, x_bank=x0)
    assert torch.isnan(out).any()
    for gpd, rnd in ((1, 0), (2, 0)):
        with pytest.raises(FloatingPointError, match=f"step 2, round {rnd}"):
            TSampler(tm, groups_per_device=gpd, detect_anomaly=True).sample(
                **kw, **tcond, x_bank=x0)

    class JNaN(JFake):
        def apply(self, variables, x, t, cond):
            return _nan_at_step(jnp, t_nan)(x, t, cond)

    jm.unet = JNaN()
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            JSampler(jm).sample(ref_cond=ref_cond, gen_cond=gen_cond, rng=jax.random.PRNGKey(0),
                                **kw)
    finally:
        jax.config.update("jax_debug_nans", False)


def test_batched_real_unet_matches_per_group():
    """A tiny real MMDM UNet (fp32, CPU): three groups in one call of batch 6
    against one group a call."""
    from cap4d_torch.mmdm.schedule import make_mmdm_schedule
    from cap4d_torch.mmdm.unet import MMDMUNet

    torch.manual_seed(0)
    unet = MMDMUNet(in_channels=4, out_channels=4, model_channels=32, channel_mult=(1, 2, 4, 4),
                    num_res_blocks=1, attention_resolutions=(4, 2, 1), num_head_channels=16,
                    condition_channels=50, time_steps=8)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in unet.named_parameters():   # nonzero norm scales, fan-in scaled weights
            if p.ndim == 1:
                p.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.05 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
    unet.eval().requires_grad_(False)
    tm = types.SimpleNamespace(unet=unet, schedule=make_mmdm_schedule(), latent_size=LAT,
                               device=torch.device("cpu"))
    rng = np.random.default_rng(4)
    bank = lambda n: {"pos_enc": torch.from_numpy(rng.normal(size=(n, LAT, LAT, 50)).astype(np.float32)),
                      "z_input": torch.from_numpy(rng.normal(size=(n, LAT, LAT, 4)).astype(np.float32)),
                      "ref_mask": torch.ones(n, LAT, LAT, 1)}
    kw = dict(S=2, ref_cond=bank(4), gen_cond=bank(12), V=8, R_max=4, cfg_scale=2.0, seed=5,
              verbose=False, x_bank=rng.normal(size=(12, LAT, LAT, 4)).astype(np.float32))
    one = TSampler(tm, groups_per_device=1).sample(**kw)
    three = TSampler(tm, groups_per_device=3).sample(**kw)
    assert torch.isfinite(one).all()
    torch.testing.assert_close(three, one, atol=1e-5, rtol=1e-5)
