"""Stage 1's DDIM blocks (``cap4d_torch/mmdm/sampler_graph.py``) on the
CPU: the static block path against the step-by-step loop the sampler ran
before its blocks (kept here as the oracle) bit for bit, against
``cap4d_tpu``'s ``StochasticIOSampler`` at small and large
``max_group_steps_per_dispatch``, the checkpoints at the JAX package's block
boundaries, the bodies a capture records read nothing on the host, and the
graphed control flow with a stand-in graph.
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_torch.mmdm import sampler as sampler_mod
from cap4d_torch.mmdm import sampler_graph
from cap4d_torch.mmdm.sampler import StochasticIOSampler as TSampler
from cap4d_torch.mmdm.sampler import parallel_groups
from cap4d_torch.mmdm.schedule import make_ddim_sampling_parameters, make_ddim_timesteps
from cap4d_torch.ops import flash_attention, norms
from cap4d_torch.ops.cuda_build import CudaKernel
from cap4d_tpu.mmdm.sampler import StochasticIOSampler as JSampler
from tests.test_torch_capture import HostReads
from tests.test_torch_sampler import LAT, TFake, _banks, _models
from tests.test_torch_fit_dispatch import one_thread  # noqa: F401 (fixture)
from tests.test_torch_mmdm_training import _ReplayEagerly
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)


def tiny_unet():
    """A tiny real MMDM UNet (fp32, CPU) with nonzero norm scales and
    fan-in scaled weights, so the timestep and every input matter."""
    from cap4d_torch.mmdm.unet import MMDMUNet

    torch.manual_seed(0)
    unet = MMDMUNet(in_channels=4, out_channels=4, model_channels=32, channel_mult=(1, 2, 4, 4),
                    num_res_blocks=1, attention_resolutions=(4, 2, 1), num_head_channels=16,
                    condition_channels=50, time_steps=8)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if p.ndim == 1:
                p.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.05 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
    return unet.eval().requires_grad_(False)


def real_model():
    from cap4d_torch.mmdm.schedule import make_mmdm_schedule

    return types.SimpleNamespace(unet=tiny_unet(), schedule=make_mmdm_schedule(),
                                 latent_size=LAT, device=torch.device("cpu"))


def real_inputs(n_ref=4, n_gen=16, seed=4):
    rng = np.random.default_rng(seed)

    def bank(n):
        return {"pos_enc": torch.from_numpy(rng.normal(size=(n, LAT, LAT, 50)).astype(np.float32)),
                "z_input": torch.from_numpy(rng.normal(size=(n, LAT, LAT, 4)).astype(np.float32)),
                "ref_mask": torch.ones(n, LAT, LAT, 1)}

    return dict(ref_cond=bank(n_ref), gen_cond=bank(n_gen), V=8, R_max=4, cfg_scale=2.0,
                seed=5, verbose=False,
                x_bank=rng.normal(size=(n_gen, LAT, LAT, 4)).astype(np.float32))


def _step_round_eps(model, banks, x_bank, t, ref_idx, gen_idx, cfg_scale):
    """One round as the step-by-step sampler ran it: the timestep a host
    int filled into the CFG batch."""
    n_par, R = ref_idx.shape
    G = gen_idx.shape[1]
    pe = torch.cat([banks["ref_pos_enc"][ref_idx], banks["gen_pos_enc"][gen_idx]], dim=1)
    ref_z = banks["ref_z"][ref_idx]
    x_T = x_bank[gen_idx]
    z_in = torch.cat([ref_z, torch.zeros_like(x_T)], dim=1)
    x = torch.cat([ref_z, x_T], dim=1)
    h, w = x.shape[2:4]
    rmask = torch.cat([x.new_ones((n_par, R, h, w, 1)), x.new_zeros((n_par, G, h, w, 1))], dim=1)
    cond2 = {"pos_enc": torch.cat([torch.zeros_like(pe), pe]),
             "z_input": torch.cat([torch.zeros_like(z_in), z_in]),
             "ref_mask": torch.cat([rmask, rmask])}
    t2 = torch.full((2 * n_par, R + G), int(t), dtype=torch.int64, device=x.device)
    out = model.unet(torch.cat([x, x]), t2, cond2)
    e_uncond, e_cond = out[:n_par], out[n_par:]
    return (e_uncond + cfg_scale * (e_cond - e_uncond))[:, R:]


@torch.no_grad()
def step_by_step(model, S, ref_cond, gen_cond, V, R_max, cfg_scale, seed, x_bank,
                 groups_per_device=1, verbose=False):
    """The oracle: the sampler's loop before its blocks, one DDIM step at a
    time (index tables uploaded each step, a fresh eps and latent bank
    each step), on one process."""
    sched = model.schedule
    n_gen, n_all_ref = gen_cond["pos_enc"].shape[0], ref_cond["pos_enc"].shape[0]
    R = min(n_all_ref, R_max)
    G = V - R
    n_groups = n_gen // G
    n_par = parallel_groups(n_groups, groups_per_device)
    n_rounds = n_groups // n_par
    ddim_ts = make_ddim_timesteps(S, sched.num_timesteps)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(sched.alphas_cumprod, ddim_ts, 0.0)
    banks = {"ref_pos_enc": ref_cond["pos_enc"].float(), "ref_z": ref_cond["z_input"].float(),
             "gen_pos_enc": gen_cond["pos_enc"].float()}
    x_bank = torch.as_tensor(x_bank, dtype=torch.float32).clone()
    host_rng = np.random.RandomState(seed)
    time_range = np.flip(ddim_ts)
    for i in range(S):
        index = S - i - 1
        if R == 1:
            ref_rounds = np.zeros((n_groups, R), np.int64)
        else:
            ref_rounds = np.stack([host_rng.permutation(n_all_ref)[:R] for _ in range(n_groups)])
        gen_rounds = host_rng.permutation(n_gen).reshape(n_groups, G)
        ref_t = torch.as_tensor(ref_rounds.reshape(n_rounds, n_par, R))
        gen_t = torch.as_tensor(gen_rounds.reshape(n_rounds, n_par, G))
        eps = torch.zeros_like(x_bank)
        for r in range(n_rounds):
            e_t = _step_round_eps(model, banks, x_bank, time_range[i], ref_t[r], gen_t[r],
                                  cfg_scale)
            eps.index_add_(0, gen_t[r].reshape(-1), e_t.reshape(-1, *e_t.shape[2:]).float())
        a_t, a_prev = np.float64(alphas[index]), np.float64(alphas_prev[index])
        sig = np.float64(sigmas[index])
        e_factor = np.float32(-np.sqrt(a_prev) * np.sqrt(1.0 - a_t) / np.sqrt(a_t)
                              + np.sqrt(1.0 - a_prev - sig ** 2))
        x_factor = np.float32(np.sqrt(a_prev) / np.sqrt(a_t))
        x_bank = x_bank * float(x_factor) + eps * float(e_factor)
    return x_bank


@pytest.mark.parametrize("max_group_steps,groups_per_device", [
    (1, 1), (1000, 1),      # K = 1 and K = S, four rounds of one group
    (1, 2), (5, 2),         # K = 1 and K = 2, two rounds of two groups
])
def test_static_blocks_equal_the_step_by_step_loop(one_thread, max_group_steps,
                                                   groups_per_device):
    """The static block path (graphs=False: the bodies a capture records,
    run eagerly on their slots) gives the step-by-step loop's latents bit
    for bit with a tiny real UNet."""
    model = real_model()
    kw = real_inputs()
    ref = step_by_step(model, 4, groups_per_device=groups_per_device, **kw)
    sampler = TSampler(model, groups_per_device=groups_per_device,
                       max_group_steps_per_dispatch=max_group_steps)
    out = sampler.sample(S=4, **kw)
    assert torch.equal(out, ref)
    n_rounds = 4 // groups_per_device
    assert sampler.counters["steps_per_block"] == min(4, max(1, max_group_steps // n_rounds))
    assert sampler.counters["graphed"] is False and sampler.counters["captures"] == 0


@pytest.mark.parametrize("max_group_steps,groups_per_device,every", [
    (1, 1, 3), (6, 2, 3), (500, 2, 10)])
def test_blocks_match_jax_sampler(max_group_steps, groups_per_device, every):
    """Against cap4d_tpu's sampler at the same max_group_steps_per_dispatch:
    the latents within 1e-5, progress_cb at the same block ends."""
    jm, tm = _models()
    ref_cond, gen_cond = _banks(1, 1), _banks(28, 2)
    rng = jax.random.PRNGKey(3)
    x0 = np.array(jax.random.normal(rng, (28, LAT, LAT, 4), jnp.float32))
    seen = {"jax": [], "torch": []}
    kw = dict(S=7, V=8, R_max=4, cfg_scale=2.0, seed=7, verbose=False, checkpoint_every=every)
    ref = np.asarray(JSampler(jm, mesh=None, groups_per_device=groups_per_device,
                              max_group_steps_per_dispatch=max_group_steps).sample(
        ref_cond=ref_cond, gen_cond=gen_cond, rng=rng,
        progress_cb=lambda d, s: seen["jax"].append(d), **kw))
    tcond = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in
             (("ref_cond", ref_cond), ("gen_cond", gen_cond))}
    out = TSampler(tm, groups_per_device=groups_per_device,
                   max_group_steps_per_dispatch=max_group_steps).sample(
        **tcond, x_bank=x0, progress_cb=lambda d, s: seen["torch"].append(d), **kw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert seen["torch"] == seen["jax"] and seen["torch"][-1] == 7


class Stop(Exception):
    pass


def test_checkpoints_land_on_jax_block_boundaries(tmp_path):
    """Blocks of 2 steps with checkpoint_every=3: both packages write their
    pickle at step 4 (the first block end past 3) before a stop at step 6,
    with the same host RNG state and latents; resuming from it gives the
    uninterrupted run bit for bit."""
    import pickle

    jm, tm = _models()
    ref_cond, gen_cond = _banks(4, 1), _banks(12, 2)        # 3 groups, 3 rounds
    rng = jax.random.PRNGKey(9)
    x0 = np.array(jax.random.normal(rng, (12, LAT, LAT, 4), jnp.float32))
    kw = dict(S=7, V=8, R_max=4, cfg_scale=2.0, seed=11, verbose=False, checkpoint_every=3)
    tcond = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in
             (("ref_cond", ref_cond), ("gen_cond", gen_cond))}

    def stop_at_6(done, total):
        if done == 6:
            raise Stop

    snaps = {}
    for name, run in (
            ("jax", lambda d, cb: JSampler(jm, max_group_steps_per_dispatch=6).sample(
                ref_cond=ref_cond, gen_cond=gen_cond, rng=rng, checkpoint_dir=str(d),
                progress_cb=cb, **kw)),
            ("torch", lambda d, cb: TSampler(tm, max_group_steps_per_dispatch=6).sample(
                **tcond, x_bank=x0, checkpoint_dir=str(d), progress_cb=cb, **kw))):
        d = tmp_path / name
        d.mkdir()
        with pytest.raises(Stop):
            run(d, stop_at_6)
        with open(d / "sampler_checkpoint.pkl", "rb") as fh:
            snaps[name] = pickle.load(fh)
    sj, st = snaps["jax"], snaps["torch"]
    assert sj["step"] == st["step"] == 4
    for a, b in zip(sj["rng_state"], st["rng_state"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(st["x_bank"], sj["x_bank"], atol=1e-5, rtol=1e-5)

    full = TSampler(tm, max_group_steps_per_dispatch=6).sample(**tcond, x_bank=x0, **kw)
    resumed = TSampler(tm, max_group_steps_per_dispatch=6).sample(
        **tcond, x_bank=x0, checkpoint_dir=str(tmp_path / "torch"), **kw)
    assert torch.equal(resumed, full)


def _recording_blocks(monkeypatch):
    """Patches the sampler's BlockGraphs to keep each run's instance."""
    made = []

    class Recorded(sampler_graph.BlockGraphs):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(sampler_mod, "BlockGraphs", Recorded)
    return made


def test_round_and_update_read_nothing_on_the_host(monkeypatch):
    """The round (the real UNet's forward with CFG, the eps scatter-add) and
    the update that the card captures call no operator that reads the
    device on the host or uploads a host array."""
    made = _recording_blocks(monkeypatch)
    model = real_model()
    TSampler(model, max_group_steps_per_dispatch=8).sample(S=2, **real_inputs())
    blocks = made[0]
    blocks.counter.zero_()
    with HostReads() as scan:
        blocks.round_body()
        blocks.update_body()
    assert scan.found == []


def test_graphed_control_flow_with_a_stand_in_graph(monkeypatch):
    """The graphed path on the CPU with a stand-in graph whose replay runs
    the body: each body's first use is the warm-up and one capture, every
    later round and update a replay that adds the capture's launches, and
    the latents are the eager path's bit for bit."""
    made = _recording_blocks(monkeypatch)
    per_replay = {"round": {k.name: 16 * (k is flash_attention.KERNEL) + 61 * (k is norms.KERNEL)
                            for k in CudaKernel.registry},
                  "update": {k.name: 0 for k in CudaKernel.registry}}
    captured = []

    def stand_in_capture(fn):
        name = "round" if getattr(fn, "__name__", "") == "round_body" else "update"
        captured.append(name)
        return _ReplayEagerly(fn), per_replay[name]

    monkeypatch.setattr(sampler_graph, "warm_up", lambda fn: fn())
    monkeypatch.setattr(sampler_graph, "capture_graph", stand_in_capture)
    _, tm = _models()
    kw = dict(S=5, ref_cond=_banks(4, 1), gen_cond=_banks(16, 2), V=8, R_max=4, cfg_scale=2.0,
              seed=7, verbose=False, x_bank=np.random.default_rng(0).normal(
                  size=(16, LAT, LAT, 4)).astype(np.float32))
    kw.update({k: {kk: torch.from_numpy(vv) for kk, vv in kw[k].items()}
               for k in ("ref_cond", "gen_cond")})
    eager = TSampler(tm, max_group_steps_per_dispatch=8).sample(**kw)
    graphed_sampler = TSampler(tm, max_group_steps_per_dispatch=8)
    orig = sampler_graph.BlockGraphs.__init__

    def as_graphed(self, *a):
        orig(self, *a[:-1], False)
        self.graphs = a[-1]     # on the CPU, only with the stand-in

    monkeypatch.setattr(sampler_graph.BlockGraphs, "__init__", as_graphed)
    graphed_sampler.graphs = True
    k1, k2 = flash_attention.KERNEL, norms.KERNEL
    before = k1.launches, k2.launches
    graphed = graphed_sampler.sample(**kw)
    assert torch.equal(graphed, eager)
    n_rounds, S = 4, 5                       # 4 groups of 4, blocks of 2 steps
    c = made[-1].counters()
    assert c["steps_per_block"] == 2 and c["captures"] == 2 and captured == ["round", "update"]
    assert c["replays"] == (S * n_rounds - 1) + (S - 1)
    assert (k1.launches - before[0], k2.launches - before[1]) == \
        (16 * (S * n_rounds - 1), 61 * (S * n_rounds - 1))
    k1.launches, k2.launches = before
    assert made[-1].graph == {"round": None, "update": None}    # freed at the end


def test_graph_flags_and_the_cli(monkeypatch):
    """graphs=True raises on the CPU and with detect_anomaly, which runs
    eagerly by default; --max_dispatch_group_steps reaches run_generation."""
    from cap4d_torch.inference import generate_images as tgen

    _, tm = _models()
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        TSampler(tm, graphs=True)
    with pytest.raises(ValueError, match="detect_anomaly"):
        TSampler(tm, graphs=True, detect_anomaly=True)
    with pytest.raises(ValueError, match="max_group_steps_per_dispatch"):
        TSampler(tm, max_group_steps_per_dispatch=0)
    assert TSampler(tm).graphs is False and TSampler(tm, detect_anomaly=True).graphs is False
    assert inspect.signature(TSampler).parameters["max_group_steps_per_dispatch"].default == 200
    assert inspect.signature(tgen.run_generation).parameters["graphs"].default is None
    got = []
    monkeypatch.setattr(tgen, "run_generation", lambda *a, **kw: got.append(kw))
    argv = ["generate_images", "--config_path", "c.yaml", "--reference_data_path", "ref",
            "--output_path", "out", "--device", "cpu"]
    for extra in ([], ["--max_dispatch_group_steps", "50"]):
        monkeypatch.setattr("sys.argv", argv + extra)
        tgen.main()
    assert [kw["max_group_steps_per_dispatch"] for kw in got] == [200, 50]


def test_fake_denoiser_rank_free_rounds_match(one_thread):
    """The stand-in denoiser through the blocks against the oracle loop at
    two groups a call (R = 1: no reference draws)."""
    _, tm = _models()
    kw = dict(ref_cond=_banks(1, 1), gen_cond=_banks(14, 2), V=8, R_max=4, cfg_scale=2.0,
              seed=3, verbose=False,
              x_bank=np.random.default_rng(2).normal(size=(14, LAT, LAT, 4)).astype(np.float32))
    kw.update({k: {kk: torch.from_numpy(vv) for kk, vv in kw[k].items()}
               for k in ("ref_cond", "gen_cond")})
    tm.unet = TFake()
    ref = step_by_step(tm, 4, groups_per_device=2, **kw)
    out = TSampler(tm, groups_per_device=2, max_group_steps_per_dispatch=3).sample(S=4, **kw)
    assert torch.equal(out, ref)
