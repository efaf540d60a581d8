"""cap4d_torch.parallel on the CPU: two gloo ranks started by ``spawn``
(``torch.multiprocessing`` with a ``file://`` store) for stage 1's group
split, the animation's frame split and MMDM training's data-parallel batch,
against one rank and against cap4d_tpu on ``dp_mesh(2)`` of the 8-device CPU
platform that ``tests/conftest.py`` sets up; and the layer's pure rules
(backend, blocks, ranks, the kernels' device guard).

The ranks import this module to find their bodies, so its top level imports
torch, numpy and the port only; JAX and cap4d_tpu are imported inside the
tests, in the pytest process."""

import argparse
import importlib
import inspect
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cap4d_torch.mmdm.sampler import StochasticIOSampler as TSampler
from cap4d_torch.mmdm.schedule import make_ddim_timesteps
from cap4d_torch.mmdm.schedule import make_mmdm_schedule as t_schedule
from cap4d_torch.ops.cuda_build import check_on_current_card
from cap4d_torch.parallel import (
    DP,
    all_reduce_mean_,
    dp_mesh,
    gather_object,
    init_dp,
    pick_backend,
    rank_card,
    shard_slice,
    spawn,
)
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

LAT, C_COND = 8, 6
TIMEOUT_S = 240.0


# ------------------------------------------------------------ rank bodies ----

def _eps(x, cond):
    """eps := 0.1·x + mean(pos_enc), with the reference-slot passthrough
    (the stand-in denoiser of test_torch_sampler.py)."""
    ref = cond["ref_mask"]
    bias = cond["pos_enc"].mean(-1, keepdim=True)
    return (x - cond["z_input"]) * ref + (0.1 * x + bias) * (1.0 - ref)


class TFake(torch.nn.Module):
    in_channels = 4

    def __init__(self, t_nan=None):
        super().__init__()
        self.t_nan = t_nan

    def forward(self, x, t, cond):
        out = _eps(x, cond)
        if self.t_nan is not None:
            out = torch.where((t == self.t_nan)[..., None, None, None],
                              torch.full_like(out, float("nan")), out)
        return out


def _t_model(t_nan=None):
    return SimpleNamespace(unet=TFake(t_nan), schedule=t_schedule(n_frames=8, image_size=LAT),
                           latent_size=LAT, device=torch.device("cpu"))


def _tcond(banks):
    return {k: torch.from_numpy(v.copy()) for k, v in banks.items()}


def _sample(dp, case, ckpt=None, **kw):
    c = dict(case)
    return TSampler(_t_model(), groups_per_device=c.pop("g"), dp=dp).sample(
        S=c["S"], ref_cond=_tcond(c["ref"]), gen_cond=_tcond(c["gen"]), V=8, R_max=4,
        cfg_scale=2.0, seed=7, verbose=False, x_bank=c["x0"], checkpoint_dir=ckpt, **kw).numpy()


class Stop(Exception):
    pass


def _stop_at_2(step, total):
    if step == 2:
        raise Stop


def _sampler_rank(dp, cases, ckpt_dir):
    """Every case at world ``dp.world``, a run stopped after step 2 and
    resumed from its checkpoint, and the collectives on mixed buckets."""
    out = {name: _sample(dp, case) for name, case in cases.items()}
    try:
        _sample(dp, cases["g1"], ckpt=ckpt_dir, checkpoint_every=1, progress_cb=_stop_at_2)
    except Stop:
        out["stopped"] = True
    out["resumed"] = _sample(dp, cases["g1"], ckpt=ckpt_dir, checkpoint_every=1)
    a = torch.full((5,), float(dp.rank + 1))
    b = torch.arange(3, dtype=torch.float64) * (dp.rank + 1)
    c = torch.full((4, 4), float(dp.rank))
    out["bytes"] = all_reduce_mean_([a, b, c], dp, bucket_bytes=32)
    out["mean"] = [a.numpy(), b.numpy(), c.numpy()]
    out["gathered"] = gather_object(("rank", dp.rank), dp)
    return out


def _nan_rank(dp, case, t_nan):
    """detect_anomaly on every rank with a denoiser that returns NaN at one
    timestep."""
    c = dict(case)
    TSampler(_t_model(t_nan), groups_per_device=c.pop("g"), detect_anomaly=True, dp=dp).sample(
        S=c["S"], ref_cond=_tcond(c["ref"]), gen_cond=_tcond(c["gen"]), V=8, R_max=4,
        cfg_scale=2.0, seed=7, verbose=False, x_bank=c["x0"])


def _train_rank(dp, cfg, sched_kw, start, data):
    """make_train_step over a batch of 2 and make_accum_train_step over 4
    micro-batches, each from the same carried state; returns each one's
    loss and parameters (the flax tree, numpy)."""
    from cap4d_torch.mmdm import training as T
    from cap4d_torch.mmdm.convert import (
        flax_from_state_dict,
        state_dict_from_flax,
        train_state_from_flax,
        unet_norm_kinds,
        unet_torch_key,
    )
    from cap4d_torch.mmdm.train import make_accum_train_step
    from cap4d_torch.mmdm.unet import MMDMUNet

    sched = t_schedule(**sched_kw)
    t = {k: torch.from_numpy(np.array(v)) if not isinstance(v, dict) else
         {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()} for k, v in data.items()}
    out = {}
    for kind in ("batch", "accum"):
        tm = MMDMUNet(**cfg)
        tm.load_state_dict(state_dict_from_flax(start["params"], unet_torch_key), strict=True)
        tm.train()
        optimizer = T.make_adamw(tm, 1e-4)
        train_state_from_flax(tm, optimizer, start["params"], start["mu"], start["nu"],
                              start["count"])
        state = T.TrainState(tm, optimizer, 1)
        if kind == "batch":
            step = T.make_train_step(tm, sched, optimizer, dp=dp)
            loss = step(state, t["z2"], t["cond2"], t=t["t2"], noise=t["noise2"])["loss"]
        else:
            model = SimpleNamespace(unet=tm, schedule=sched, device=torch.device("cpu"))
            step = make_accum_train_step(model, optimizer, 4, cfg_probability=0.0, dp=dp)
            ptrs = [g.data_ptr() for g in step.graph.grads()]
            loss = step(state, t["z4"], t["cond4"], torch.Generator().manual_seed(0),
                        t_stack=t["t4"], noise_stack=t["noise4"])
            out["accum_grads_kept"] = [p.grad.data_ptr() for p in tm.parameters()] == ptrs
        out[kind] = (float(loss), flax_from_state_dict(dict(tm.named_parameters()),
                                                       unet_norm_kinds(tm)))
    return out


def _animate_rank(dp, jobs):
    """render_sequence and render_sequence_smpl with the default dp_frames."""
    from cap4d_torch.avatar.animate import render_sequence
    from cap4d_torch.avatar.animate_smpl import render_sequence_smpl

    return [render_sequence(**jobs["flame"], dp=dp), render_sequence_smpl(**jobs["smpl"], dp=dp)]


# -------------------------------------------------------- stage 1's split ----

def _banks(n, seed):
    rng = np.random.default_rng(seed)
    return {"pos_enc": rng.normal(size=(n, LAT, LAT, C_COND)).astype(np.float32),
            "z_input": rng.normal(size=(n, LAT, LAT, 4)).astype(np.float32),
            "ref_mask": np.ones((n, LAT, LAT, 1), np.float32)}


def _x0(n_gen, seed):
    import jax
    import jax.numpy as jnp

    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n_gen, LAT, LAT, 4),
                                      jnp.float32))


# name: (groups_per_device, n_gen); four references, so G = 4. g1 and g2
# split 4 groups evenly over two ranks; "uneven" has 3 groups, n_par 3: two
# slots on rank 0 and one on rank 1 (world 1 runs it at groups_per_device 3)
CASES = {"g1": (1, 16), "g2": (2, 16), "uneven": (2, 12)}


@pytest.fixture(scope="module")
def sampler_cases():
    ref = _banks(4, 1)
    return {name: dict(g=g, S=4, ref=ref, gen=_banks(n_gen, 2), x0=_x0(n_gen, 7))
            for name, (g, n_gen) in CASES.items()}


@pytest.fixture(scope="module")
def sampler_world2(sampler_cases, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("dp_sampler_ckpt")
    return spawn(_sampler_rank, 2, "cpu", sampler_cases, str(ckpt), timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_sampler_world2_matches_jax_on_dp_mesh2(sampler_cases, sampler_world2, name):
    """The port's sampler on two ranks against cap4d_tpu's on dp_mesh(2) at
    the same groups_per_device, the same initial latents (atol 1e-5)."""
    import jax

    from cap4d_tpu.mmdm.sampler import StochasticIOSampler as JSampler
    from cap4d_tpu.parallel import dp_mesh as j_dp_mesh
    from tests.test_torch_sampler import _models

    jm, _ = _models()
    c = sampler_cases[name]
    ref = np.asarray(JSampler(jm, mesh=j_dp_mesh(2), groups_per_device=c["g"]).sample(
        S=c["S"], ref_cond=c["ref"], gen_cond=c["gen"], V=8, R_max=4, cfg_scale=2.0, seed=7,
        rng=jax.random.PRNGKey(7), verbose=False))
    for rank_out in sampler_world2:
        np.testing.assert_allclose(rank_out[name], ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_sampler_world2_bit_identical_to_world1(sampler_cases, sampler_world2, name):
    """World 2 at groups_per_device g against one process at g, bit for bit
    (each frame's eps comes from one group on one rank; the other adds
    zeros); the uneven split (n_par 3 over two ranks) against one process
    at n_par 3. Both ranks return the same latents."""
    c = dict(sampler_cases[name])
    if name == "uneven":
        c["g"] = 3
    one = _sample(None, c)
    for rank_out in sampler_world2:
        assert torch.equal(torch.from_numpy(rank_out[name]), torch.from_numpy(one)), name


def test_sampler_world2_checkpoint_resume(sampler_world2):
    """Stopped after DDIM step 2 on both ranks, resumed by both from rank 0's
    snapshot: the latents equal the uninterrupted run's."""
    for rank_out in sampler_world2:
        assert rank_out["stopped"]
        np.testing.assert_array_equal(rank_out["resumed"], rank_out["g1"])


def test_collectives_over_gloo(sampler_world2):
    """all_reduce_mean_ over buckets of at most 32 bytes (mixed dtypes, a
    tensor larger than a bucket) and gather_object, on both ranks."""
    for rank_out in sampler_world2:
        a, b, c = rank_out["mean"]
        np.testing.assert_array_equal(a, np.full(5, 1.5, np.float32))
        np.testing.assert_array_equal(b, np.arange(3) * 1.5)
        np.testing.assert_array_equal(c, np.full((4, 4), 0.5, np.float32))
        assert rank_out["bytes"] == 5 * 4 + 3 * 8 + 16 * 4
        assert rank_out["gathered"] == [("rank", 0), ("rank", 1)]


def test_rank_failure_raises_in_spawn_naming_the_rank(sampler_cases):
    """detect_anomaly on two ranks with a denoiser that returns NaN at DDIM
    step 2: a rank raises FloatingPointError naming the step, the round and
    itself, and spawn raises it in the parent with the rank's traceback."""
    S = sampler_cases["g1"]["S"]
    t_nan = int(np.flip(make_ddim_timesteps(S, 1000))[2])
    with pytest.raises(Exception, match=r"FloatingPointError: .*step 2, round 0 on rank [01]"):
        spawn(_nan_rank, 2, "cpu", sampler_cases["g1"], t_nan, timeout_s=TIMEOUT_S)


# ------------------------------------------------- training's data split ----

@pytest.fixture(scope="module")
def train_setup():
    """The small UNet of test_torch_mmdm_training.py with live parameters, a
    JAX TrainState one AdamW update past init, a batch of 2 and a stack of
    4 micro-batches, each with the draws the JAX steps make from their key
    (cfg_probability 0)."""
    import jax
    import jax.numpy as jnp

    from cap4d_tpu.mmdm.unet import MMDMUNet as JUNet
    from tests.test_torch_mmdm_training import CFG, L, SCHED, batch, carried_state, live_params

    jm = JUNet(attn_backend="einsum", fused_norms=True, **CFG)
    Tv = CFG["time_steps"]
    c = {"pos_enc": jnp.zeros((1, Tv, L, L, 50)), "z_input": jnp.zeros((1, Tv, L, L, 4)),
         "ref_mask": jnp.zeros((1, Tv, L, L, 1))}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, Tv, L, L, 4)),
                                            jnp.zeros((1, Tv), jnp.int32), c))["params"]
    params, opt_state = carried_state(live_params(shapes, 11), 3)
    adam = opt_state[0]
    start = {"params": jax.tree.map(np.asarray, params), "mu": jax.tree.map(np.asarray, adam.mu),
             "nu": jax.tree.map(np.asarray, adam.nu), "count": int(adam.count)}

    def draws(key, z):
        k_t, k_n = jax.random.split(key)
        return (np.asarray(jax.random.randint(k_t, z.shape[:2], 0, 1000)),
                np.asarray(jax.random.normal(k_n, z.shape, jnp.float32)))

    z2, cond2, _, _ = batch(21, n=2)
    z2, cond2 = z2[:, 0], {k: v[:, 0] for k, v in cond2.items()}
    t2, noise2 = draws(jax.random.PRNGKey(31), z2)
    z4, cond4, _, _ = batch(22, n=4)
    t4, noise4 = [], []
    k = jax.random.PRNGKey(32)
    for i in range(4):       # the accumulation scan's key chain, then micro_loss's split
        k, sub = jax.random.split(k)
        _, k_loss = jax.random.split(sub)
        t_i, n_i = draws(k_loss, z4[i])
        t4.append(t_i)
        noise4.append(n_i)
    data = dict(z2=z2, cond2=cond2, t2=t2, noise2=noise2, z4=z4, cond4=cond4,
                t4=np.stack(t4), noise4=np.stack(noise4))
    return SimpleNamespace(jm=jm, params=params, opt_state=opt_state, start=start, data=data,
                           cfg=CFG, sched=SCHED)


@pytest.fixture(scope="module")
def train_world2(train_setup):
    s = train_setup
    return spawn(_train_rank, 2, "cpu", s.cfg, s.sched, s.start, s.data, timeout_s=TIMEOUT_S)


def _jax_reference(s, kind):
    import jax
    import jax.numpy as jnp

    from cap4d_tpu.mmdm import training as J
    from cap4d_tpu.mmdm.schedule import make_mmdm_schedule as j_schedule
    from cap4d_tpu.mmdm.train import make_accum_train_step as j_accum_step
    from cap4d_tpu.parallel import dp_mesh as j_dp_mesh
    from tests.test_torch_mmdm_training import OPT

    # copies: the jitted steps donate their state
    state = J.TrainState(*jax.tree.map(jnp.array, (s.params, s.opt_state)),
                         jnp.ones((), jnp.int32))
    d = {k: jax.tree.map(jnp.asarray, v) for k, v in s.data.items()}
    if kind == "batch":
        step = J.make_train_step(s.jm, j_schedule(**s.sched), OPT, mesh=j_dp_mesh(2))
        state, logs = step(state, d["z2"], d["cond2"], jax.random.PRNGKey(31))
        loss = logs["loss"]
    else:
        model = SimpleNamespace(unet=s.jm, schedule=j_schedule(**s.sched))
        step = j_accum_step(model, OPT, 4, mesh=j_dp_mesh(2), cfg_probability=0.0)
        state, loss = step(state, d["z4"], d["cond4"], jax.random.PRNGKey(32))
    return float(loss), state.params


@pytest.mark.parametrize("kind", ["batch", "accum"])
def test_train_steps_world2_match_jax(train_setup, train_world2, kind):
    """make_train_step on two ranks (one sample each) against cap4d_tpu's
    make_train_step on dp_mesh(2), and make_accum_train_step on two ranks
    (two micro-batches each) against cap4d_tpu's make_accum_train_step, from
    the same carried state with the JAX steps' own draws: the mean loss to
    1e-5 relative, every parameter to 1e-7 absolute (test_torch_mmdm_training.py's
    tolerances)."""
    from tests.test_torch_mmdm_training import leaves_by_path

    loss, params = _jax_reference(train_setup, kind)
    ref = leaves_by_path(params)
    for rank_out in train_world2:
        got_loss, got = rank_out[kind]
        assert got_loss == pytest.approx(loss, rel=1e-5)
        got = leaves_by_path(got)
        assert set(got) == set(ref)
        for path, r in ref.items():
            np.testing.assert_allclose(got[path], r, atol=1e-7, err_msg=str(path))


@pytest.mark.parametrize("kind", ["batch", "accum"])
def test_train_steps_world2_ranks_bitwise_equal_and_match_world1(train_setup, train_world2, kind):
    """After the step both ranks hold the same parameters bit for bit, and
    they agree with one process taking the whole batch (loss 1e-5 relative,
    parameters 1e-7)."""
    from tests.test_torch_mmdm_training import leaves_by_path

    s = train_setup
    one_loss, one = _train_rank(None, s.cfg, s.sched, s.start, s.data)[kind]
    (l0, p0), (l1, p1) = train_world2[0][kind], train_world2[1][kind]
    assert l0 == l1 == pytest.approx(one_loss, rel=1e-5)
    one, p0, p1 = leaves_by_path(one), leaves_by_path(p0), leaves_by_path(p1)
    for name in p0:
        np.testing.assert_array_equal(p0[name], p1[name], err_msg=name)
        np.testing.assert_allclose(p0[name], one[name], atol=1e-7, err_msg=name)


def test_accum_step_world2_keeps_grad_tensors(train_world2):
    """The bucketed gradient all-reduce copies back in place: after the step
    on two ranks every .grad is still the static tensor that the step
    zeroed, the memory a captured micro-batch accumulates into."""
    assert [rank_out["accum_grads_kept"] for rank_out in train_world2] == [True, True]


def test_accum_steps_must_split_evenly():
    from cap4d_torch.mmdm.train import make_accum_train_step

    with pytest.raises(ValueError, match="split evenly"):
        make_accum_train_step(SimpleNamespace(device=torch.device("cpu")), None, 3,
                              dp=DP(rank=1, world=2))


# ------------------------------------------------- the animation's split ----

@pytest.fixture(scope="module")
def animation_jobs(tmp_path_factory):
    """Freshly initialised small FLAME and SMPL avatars (checkpoints at
    iteration 0, no fit), a 5-frame FLAME drive (frames 0, 2, 4 on rank 0)
    and a 4-frame SMPL wave."""
    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_torch.avatar.trainer import AvatarTrainer
    from cap4d_torch.smpl.scene import load_smpl_dataset
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.config import dump_yaml
    from tests.test_torch_avatar_e2e import MODEL_PARAMS, RES, _make_stage1_output
    from tests.test_torch_smpl import MODEL_PARAMS as SMPL_PARAMS
    from tests.test_torch_smpl import OPT_PARAMS, _driving

    root = tmp_path_factory.mktemp("dp_animate")
    flame_dir = sa.make_asset_dir(root, sphere_radius=0.09)
    smpl_dir = sa.make_smpl_asset_dir(root / "smpl_assets", n_rings=14, n_segments=16)
    data = _make_stage1_output(root, n_frames=2)
    capture = sa.make_smpl_dataset(root, n_views=2, width=RES, height=RES, focal=100.0)
    avatars = {}
    for variant, params, make in (
            ("flame", MODEL_PARAMS, lambda: AvatarTrainer.create(
                load_cap4d_dataset([str(data)]), MODEL_PARAMS, OPT_PARAMS,
                flame_asset_dir=flame_dir, device="cpu")),
            ("smpl", SMPL_PARAMS, lambda: AvatarTrainer.create_smpl(
                load_smpl_dataset([str(capture)]), SMPL_PARAMS, OPT_PARAMS,
                smpl_asset_dir=smpl_dir, device="cpu"))):
        path = root / f"avatar_{variant}"
        path.mkdir()
        dump_yaml({"model_params": params, "opt_params": OPT_PARAMS, "variant": variant},
                  path / "config_dump.yaml")
        make().save_checkpoint(path, 0)
        avatars[variant] = path
    drv = sa.make_driving_sequence(root, n_frames=5, resolution=RES, fx=500.0, distance=1.2)

    def jobs(tag):
        return {"flame": dict(model_path=avatars["flame"], animation_path=drv,
                              output_path=root / f"flame_{tag}", flame_asset_dir=flame_dir,
                              save_alpha=True, save_depth=True),
                "smpl": dict(model_path=avatars["smpl"], animation_path=_driving(root),
                             output_path=root / f"smpl_{tag}", smpl_asset_dir=smpl_dir)}
    return jobs


@pytest.fixture(scope="module")
def animations(animation_jobs):
    one = _animate_rank(None, {k: dict(v, device="cpu") for k, v in
                               animation_jobs("world1").items()})
    two = spawn(_animate_rank, 2, "cpu", animation_jobs("world2"), timeout_s=TIMEOUT_S)
    return animation_jobs, one, two


@pytest.mark.parametrize("variant", ["flame", "smpl"])
def test_animation_world2_files_byte_identical_to_world1(animations, variant):
    """dp_frames 0 on two ranks: every frame PNG (and the FLAME run's alpha
    PNGs and depth arrays) and the animated PLY byte-identical to one
    process rendering the frames in turn; each rank rendered its own
    frames, rank 0 the even ones."""
    jobs, one, two = animations
    i = ("flame", "smpl").index(variant)
    d1, d2 = (Path(jobs(tag)[variant]["output_path"]) for tag in ("world1", "world2"))
    files = sorted(p.name for p in (d1 / "frames").iterdir())
    assert files == sorted(p.name for p in (d2 / "frames").iterdir())
    n = one[i]["frames"]
    assert len([f for f in files if f[5:] == ".png"]) == n == two[0][i]["frames"]
    for name in files:
        assert (d1 / "frames" / name).read_bytes() == (d2 / "frames" / name).read_bytes(), name
    ply = "exported_animation.ply"
    assert (d1 / ply).read_bytes() == (d2 / ply).read_bytes()
    assert len(two[0][i]["rank_render_s"]) == 2 and len(one[i]["rank_render_s"]) == 1


def test_dp_frames_defaults_and_limits(animation_jobs, monkeypatch):
    """--dp_frames and the functions' dp_frames default to 0 (every rank),
    as in the JAX CLIs; more ranks than the process group raises."""
    from cap4d_torch.avatar.animate import render_sequence
    from cap4d_torch.avatar.animate_smpl import render_sequence_smpl

    for fn in (render_sequence, render_sequence_smpl):
        assert inspect.signature(fn).parameters["dp_frames"].default == 0
    seen = []

    def parse_then_stop(self, args=None, namespace=None):
        seen.append(argparse.ArgumentParser.parse_known_args(
            self, ["--model_path", "m", "--animation_path", "a", "--output_path", "o"])[0])
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_then_stop)
    for module in ("cap4d_torch.avatar.animate", "cap4d_torch.avatar.animate_smpl"):
        with pytest.raises(SystemExit):
            importlib.import_module(module).main()
    assert [ns.dp_frames for ns in seen] == [0, 0]
    jobs = animation_jobs("limits")
    with pytest.raises(ValueError, match="dp_frames"):
        render_sequence(**jobs["flame"], dp_frames=2, device="cpu")
    with pytest.raises(ValueError, match="dp_frames"):
        render_sequence_smpl(**jobs["smpl"], dp_frames=-1, device="cpu")


# ------------------------------------------------------------ pure rules ----

@pytest.mark.parametrize("device_type,local_world,n_cards,requested,expected", [
    ("cuda", 4, 4, None, "nccl"),       # a card a rank
    ("cuda", 1, 1, None, "nccl"),
    ("cuda", 2, 1, None, "gloo"),       # two ranks share the card
    ("cuda", 2, 1, "gloo", "gloo"),
    ("cuda", 4, 4, "gloo", "gloo"),
    ("cpu", 2, 0, None, "gloo"),
    ("cuda", 2, 1, "nccl", ValueError),  # NCCL refuses two ranks on one device
    ("cpu", 2, 0, "nccl", ValueError),
    ("cuda", 1, 1, "mpi", ValueError),
])
def test_backend_rule(device_type, local_world, n_cards, requested, expected):
    if expected is ValueError:
        with pytest.raises(ValueError):
            pick_backend(device_type, local_world, n_cards, requested)
    else:
        assert pick_backend(device_type, local_world, n_cards, requested) == expected


@pytest.mark.parametrize("index,local_world,n_cards,cards,backend", [
    (None, 1, 1, [0], "nccl"),                  # no index, one card
    (None, 2, 4, [0, 1], "nccl"),               # no index, enough cards
    (None, 3, 2, [0, 1, 0], "gloo"),            # no index, too few cards: shared
    (0, 1, 4, [0], "nccl"),                     # an explicit index, one local rank
    (0, 2, 4, [0, 0], "gloo"),                  # an explicit index, two local ranks
])
def test_rank_card_rule(index, local_world, n_cards, cards, backend):
    """Each local rank's card and the backend from the cards the ranks use:
    an explicit index puts every local rank on it, which NCCL refuses."""
    plans = [rank_card(index, r, local_world, n_cards) for r in range(local_world)]
    assert [card for card, _ in plans] == cards
    used = plans[0][1]
    assert used == len(set(cards)) and all(n == used for _, n in plans)
    assert pick_backend("cuda", local_world, used, None) == backend
    if backend == "gloo":
        with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
            pick_backend("cuda", local_world, used, "nccl")
    else:
        assert pick_backend("cuda", local_world, used, "nccl") == "nccl"
    with pytest.raises(ValueError, match="requested"):
        rank_card(n_cards, 0, local_world, n_cards)


@pytest.mark.parametrize("requested", [None, "nccl"])
def test_init_dp_explicit_card_two_local_ranks(monkeypatch, requested):
    """``--device cuda:0`` under ``torchrun --nproc_per_node 2`` on a host
    with two cards: both ranks land on card 0, so init_dp picks gloo, and
    raises (before any process group) when NCCL is asked for."""
    import cap4d_torch.parallel.mesh as mesh

    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = []
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    seen = {}

    class Stop(Exception):
        pass

    def fake_init(backend, **kw):
        seen.update(kw, backend=backend)
        raise Stop

    monkeypatch.setattr(mesh.dist, "init_process_group", fake_init)
    if requested == "nccl":
        with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
            init_dp("cuda:0", backend="nccl")
        assert not seen
    else:
        with pytest.raises(Stop):
            init_dp("cuda:0")
        assert seen["backend"] == "gloo" and (seen["rank"], seen["world_size"]) == (1, 2)
    assert cards == [torch.device("cuda", 0)]


@pytest.mark.parametrize("n_items", [0, 1, 3, 4, 7, 64])
@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_shard_slice_is_array_split(n_items, world):
    blocks = np.array_split(np.arange(n_items), world)
    for rank in range(world):
        np.testing.assert_array_equal(np.arange(n_items)[shard_slice(n_items, rank, world)],
                                      blocks[rank])


def test_dp_mesh_takes_the_first_ranks():
    dp = DP(rank=0, world=4)
    assert list(dp_mesh(None, dp)) == [0, 1, 2, 3] and list(dp_mesh(2, dp)) == [0, 1]
    assert list(dp_mesh()) == [0]
    for bad in (0, 5):
        with pytest.raises(ValueError, match="ranks requested"):
            dp_mesh(bad, dp)


def test_init_dp_without_launcher_is_world1_without_group(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    dp = init_dp("cpu")
    assert (dp.rank, dp.world, dp.group, dp.backend, dp.device) == (0, 1, None, None,
                                                                    torch.device("cpu"))
    assert not torch.distributed.is_initialized()
    assert all_reduce_mean_([torch.ones(3)], dp) == 0      # no collective without a group
    with pytest.raises(RuntimeError, match="CUDA"):
        init_dp()
    # a launched rank asking for the card on a machine without one raises
    # before any process group exists
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_dp()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device,current,ok", [
    (("cuda", 0), 0, True),
    (("cuda", None), 1, True),          # "cuda" means the current card
    (("cuda", 1), 0, False),            # another rank's card
    (("cpu", None), 0, False),
])
def test_kernel_device_guard(device, current, ok):
    """CudaKernel.call's guard: a ctypes launch goes to the current device,
    so an input on another card (or the CPU) is refused."""
    d = SimpleNamespace(type=device[0], index=device[1])
    if ok:
        check_on_current_card([d, d], current)
    else:
        with pytest.raises(ValueError, match="current device"):
            check_on_current_card([SimpleNamespace(type="cuda", index=current), d], current)
