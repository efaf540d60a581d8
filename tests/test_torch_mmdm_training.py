"""cap4d_torch's MMDM training path against cap4d_tpu's on the CPU (fp32):
the attention and GroupNorm autograd Functions against jax.vjp of the JAX
package's plain forms, the schedule constants and q_sample, the loss and
every parameter gradient, one AdamW step from a carried JAX TrainState, an
accumulated step, the synthetic dataset, the CPU training loop and its
checkpoint loading into the JAX UNet.

Parameters are a live init (norm scales 1 ± 0.1, small biases, fan-in-scaled
kernels) drawn with numpy and carried into the port by ``convert``; the
random-weights mode zeroes every norm scale, so attention and norm
gradients would be exactly zero and hide a dropped gradient.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cap4d_torch.mmdm import training as T
from cap4d_torch.mmdm.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
    train_state_from_flax,
    unet_flax_path,
    unet_norm_kinds,
    unet_torch_key,
)
from cap4d_torch.mmdm.schedule import make_mmdm_schedule as t_schedule
from cap4d_torch.mmdm.train import SyntheticMMDMDataset as TData
from cap4d_torch.mmdm.train import (
    BatchStager,
    load_train_checkpoint,
    make_accum_train_step,
    train_mmdm,
)
from cap4d_torch.mmdm.unet import MMDMUNet as TUNet
from cap4d_torch.ops.attention import attention_mode_reshape as t_reshape
from cap4d_torch.ops.cuda_build import CudaKernel
from cap4d_torch.ops.flash_attention import flash_attention
from cap4d_torch.ops.norms import group_norm_silu
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_torch.utils.config import dump_yaml
from cap4d_torch.utils.png import read_png
from cap4d_tpu.mmdm import training as J
from cap4d_tpu.mmdm.convert import unet_torch_key as j_unet_key
from cap4d_tpu.mmdm.schedule import make_mmdm_schedule as j_schedule
from cap4d_tpu.mmdm.train import SyntheticMMDMDataset as JData
from cap4d_tpu.mmdm.unet import MMDMUNet as JUNet
from cap4d_tpu.ops.attention import _einsum_attention
from cap4d_tpu.ops.attention import attention_mode_reshape as j_reshape
from cap4d_tpu.ops.norms import _gn_silu_jnp
from tests.test_torch_capture import HostReads
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

# the shipped topology's kinds of block at a narrow width: spatial attention
# at ds 1 (S = 64), joint "3d" attention at ds 2 (S = 3·4·4 = 48, a ragged
# tile), one reference and two generated views
CFG = dict(in_channels=4, out_channels=4, model_channels=32, channel_mult=(1, 2),
           num_res_blocks=1, attention_resolutions=(1, 2), num_head_channels=16,
           condition_channels=50, time_steps=3, temporal_mode="3d")
L = 8
SCHED = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012, zero_snr_shift=True,
             shift=True, sqrt_shift=True, minus_one_shift=True, negative_shift=False,
             n_frames=CFG["time_steps"], image_size=L)
OPT = optax.adamw(1e-4)
OPT_INIT, OPT_UPDATE = jax.jit(OPT.init), jax.jit(OPT.update)


def live_params(tree, seed):
    """Fan-in-scaled kernels, norm scales N(1, 0.1), biases N(0, 0.05) (numpy)."""
    rng = np.random.default_rng(seed)

    def mk(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = tuple(leaf.shape)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.normal(size=shape)).astype(np.float32)
        return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, tree)


def leaves_by_path(tree):
    return {tuple(getattr(k, "key", str(k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def batch(seed, n=1):
    """(n, B=1, T, L, L, ·) latents, conditioning, timesteps and noise."""
    rng = np.random.default_rng(seed)
    Tv = CFG["time_steps"]
    z = rng.normal(size=(n, 1, Tv, L, L, 4)).astype(np.float32)
    ref = np.zeros((n, 1, Tv, L, L, 1), np.float32)
    ref[:, :, 0] = 1.0
    cond = {"pos_enc": rng.normal(size=(n, 1, Tv, L, L, 50)).astype(np.float32),
            "z_input": z * ref, "ref_mask": ref}
    t = rng.integers(0, 1000, size=(n, 1, Tv))
    noise = rng.normal(size=z.shape).astype(np.float32)
    return z, cond, t, noise


@pytest.fixture(scope="module")
def nets():
    """(JAX UNet, its live params, the jitted JAX loss-and-grad, schedules)."""
    jm = JUNet(attn_backend="einsum", fused_norms=True, **CFG)
    Tv = CFG["time_steps"]
    c = {"pos_enc": jnp.zeros((1, Tv, L, L, 50)), "z_input": jnp.zeros((1, Tv, L, L, 4)),
         "ref_mask": jnp.zeros((1, Tv, L, L, 1))}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, Tv, L, L, 4)),
                                            jnp.zeros((1, Tv), jnp.int32), c))["params"]
    params = live_params(shapes, 11)
    j_sched, t_sched = j_schedule(**SCHED), t_schedule(**SCHED)
    consts = J.schedule_consts(j_sched)

    @jax.jit
    def loss_grad(p, z, cond, t, noise):
        f = lambda p_: J.mmdm_loss(jm, p_, consts, z, cond, jax.random.PRNGKey(0), t=t, noise=noise)
        (loss, _), g = jax.value_and_grad(f, has_aux=True)(p)
        return loss, g

    return SimpleNamespace(jm=jm, shapes=shapes, params=params, loss_grad=loss_grad,
                           j_sched=j_sched, t_sched=t_sched)


def port_unet(params, remat=False):
    tm = TUNet(**CFG)
    tm.load_state_dict(state_dict_from_flax(params, unet_torch_key), strict=True)
    tm.remat = remat
    return tm.train()


def tt(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------- operators ----

@pytest.mark.parametrize("mode", ["spatial", "temporal", "3d"])
def test_attention_function_grads_match_jax(mode):
    """Forward and dQ/dK/dV of the FlashAttention Function (plain versions on
    the CPU) against jax.vjp of _einsum_attention in each layout; n = 65
    gives S = 65 / 130 (ragged tiles) and t = 2 the temporal S. fp32: the
    two differ only in summation order, 1e-5 of each output's largest."""
    rng = np.random.default_rng(2)
    b, t, n, heads, d = 1, 2, 65, 2, 64
    q, k, v = (rng.normal(size=(b * t, n, heads * d)).astype(np.float32) for _ in range(3))
    g = rng.normal(size=(b * t, n, heads * d)).astype(np.float32)

    def jfn(q_, k_, v_):
        qr, un = j_reshape(q_, mode, t, heads)
        kr, _ = j_reshape(k_, mode, t, heads)
        vr, _ = j_reshape(v_, mode, t, heads)
        return un(_einsum_attention(qr, kr, vr))

    j_out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    j_grads = vjp(jnp.asarray(g))

    xs = [tt(a).requires_grad_(True) for a in (q, k, v)]
    qr, undo = t_reshape(xs[0], mode, t, heads)
    kr, _ = t_reshape(xs[1], mode, t, heads)
    vr, _ = t_reshape(xs[2], mode, t, heads)
    out = undo(flash_attention(qr, kr, vr))
    grads = torch.autograd.grad(out, xs, tt(g))
    for name, a, ref in [("out", out, j_out)] + list(zip("qkv", grads, j_grads)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(a.detach().numpy(), ref, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)


@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
def test_group_norm_function_grads_match_jax(silu, eps):
    """The GroupNormSiLU Function's gradients (plain recompute in fp32)
    against jax.vjp of _gn_silu_jnp, with a non-contiguous incoming gradient;
    fp32, 1e-5 of each gradient's largest."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 8, 8, 64)) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    bias = (0.1 * rng.normal(size=64)).astype(np.float32)
    g = rng.normal(size=(2, 64, 8, 8)).astype(np.float32)
    g_nhwc = tt(g).permute(0, 2, 3, 1)             # NHWC view, not contiguous
    assert not g_nhwc.is_contiguous()

    _, vjp = jax.vjp(lambda a, s, c: _gn_silu_jnp(a, s, c, 32, eps, silu),
                     *(jnp.asarray(a) for a in (x, scale, bias)))
    j_grads = vjp(jnp.asarray(np.ascontiguousarray(g.transpose(0, 2, 3, 1))))
    xs = [tt(a).requires_grad_(True) for a in (x, scale, bias)]
    out = group_norm_silu(*xs, 32, eps, silu)
    grads = torch.autograd.grad(out, xs, g_nhwc)
    for name, a, ref in zip(("x", "scale", "bias"), grads, j_grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(a.numpy(), ref, atol=1e-5 * np.abs(ref).max(), err_msg=name)


def test_schedule_consts_and_q_sample_bit_for_bit(nets):
    jc = J.schedule_consts(nets.j_sched)
    tc = T.schedule_consts(nets.t_sched)
    assert set(jc) == set(tc)
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    z, _, t, noise = batch(5)
    out = T.q_sample(tc, tt(z[0]), tt(t[0]), tt(noise[0])).numpy()
    ref = np.asarray(J.q_sample(jc, jnp.asarray(z[0]), jnp.asarray(t[0]), jnp.asarray(noise[0])))
    np.testing.assert_array_equal(out, ref)


# ------------------------------------------------------------ loss, steps ----

def port_loss(tm, sched, z, cond, t, noise):
    consts = T.schedule_consts(sched)
    return T.mmdm_loss(tm, consts, tt(z), {k: tt(v) for k, v in cond.items()},
                       t=tt(t), noise=tt(noise))


def test_mmdm_loss_and_every_gradient_match_jax(nets):
    """Loss and every parameter gradient with injected t/noise, the port with
    remat on and off. fp32 through the UNet: the loss to 1e-5 relative, each
    gradient to 1e-4 of its tensor's largest (summation order only), floored
    at 1e-3 of the largest gradient of all (the bias of a conv that feeds a
    one-channel-per-group GroupNorm has a gradient of rounding noise only,
    ~1e-7 of the largest);
    remat recomputes the same ops, so on and off agree to 1e-6."""
    z, cond, t, noise = batch(7)
    j_loss, j_grads = nets.loss_grad(nets.params, jnp.asarray(z[0]),
                                     {k: jnp.asarray(v[0]) for k, v in cond.items()},
                                     jnp.asarray(t[0]), jnp.asarray(noise[0]))
    j_grads = leaves_by_path(j_grads)
    port = {}
    for remat in (False, True):
        tm = port_unet(nets.params, remat)
        loss, logs = port_loss(tm, nets.t_sched, z[0], {k: v[0] for k, v in cond.items()},
                               t[0], noise[0])
        loss.backward()
        assert float(logs["loss_simple"]) == float(loss.detach())
        named = dict(tm.named_parameters())
        grads = flax_from_state_dict({k: p.grad for k, p in named.items()}, unet_norm_kinds(tm))
        port[remat] = (float(loss), leaves_by_path(grads))
    np.testing.assert_allclose(port[False][0], float(j_loss), rtol=1e-5)
    assert set(port[False][1]) == set(j_grads)
    top = max(np.abs(g).max() for g in j_grads.values())
    for path, ref in j_grads.items():
        scale = max(np.abs(ref).max(), 1e-3 * top)
        np.testing.assert_allclose(port[False][1][path], ref, atol=1e-4 * scale, err_msg=str(path))
        np.testing.assert_allclose(port[True][1][path], port[False][1][path], atol=1e-6 * scale,
                                   err_msg=f"remat {path}")
    assert port[True][0] == pytest.approx(port[False][0], rel=1e-7)


def carried_state(params, seed):
    """A JAX TrainState one optax.adamw update past init (random gradients),
    so that the next update is smooth in the gradient."""
    rng = np.random.default_rng(seed)
    grads0 = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    opt_state = OPT_INIT(params)
    updates, opt_state = OPT_UPDATE(grads0, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


def port_from_state(params, opt_state):
    adam = opt_state[0]
    tm = port_unet(params)
    optimizer = T.make_adamw(tm, 1e-4)
    train_state_from_flax(tm, optimizer, params, adam.mu, adam.nu, int(adam.count))
    return tm, optimizer


def test_adamw_step_from_carried_train_state_matches_optax(nets):
    """One AdamW step of the port from a JAX TrainState carried across
    (params, mu, nu, count) against optax.adamw(1e-4); the weight decay is
    optax's 1e-4, not torch's default 1e-2. fp32: 1e-7 absolute."""
    params, opt_state = carried_state(nets.params, 1)
    tm, optimizer = port_from_state(params, opt_state)
    assert optimizer.param_groups[0]["weight_decay"] == 1e-4
    assert optimizer.param_groups[0]["betas"] == (0.9, 0.999)
    assert optimizer.param_groups[0]["eps"] == 1e-8
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    updates, _ = OPT_UPDATE(grads, opt_state, params)
    ref = leaves_by_path(optax.apply_updates(params, updates))
    for k, g in state_dict_from_flax(grads, unet_torch_key).items():
        dict(tm.named_parameters())[k].grad = g
    optimizer.step()
    out = leaves_by_path(flax_from_state_dict(dict(tm.named_parameters()), unet_norm_kinds(tm)))
    for path, r in ref.items():
        np.testing.assert_allclose(out[path], r, atol=1e-7, err_msg=str(path))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_jax_composition(nets, n_micro):
    """make_train_step (one micro-batch) and make_accum_train_step over 2
    micro-batches (cfg_probability 0), t and noise injected, against the same
    composition in JAX: the summed value_and_grad of mmdm_loss over the
    micro-batches, divided by their number, then optax.adamw from the same
    carried state. Mean loss to 1e-5 relative; parameters to 1e-7 absolute
    (the update is lr·m̂/√v̂, smooth in the gradient once v̂ is nonzero)."""
    params, opt_state = carried_state(nets.params, 3)
    z, cond, t, noise = batch(9, n=n_micro)
    losses, grads = [], None
    for i in range(n_micro):
        loss, g = nets.loss_grad(params, jnp.asarray(z[i]),
                                 {k: jnp.asarray(v[i]) for k, v in cond.items()},
                                 jnp.asarray(t[i]), jnp.asarray(noise[i]))
        losses.append(float(loss))
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    grads = jax.tree.map(lambda g: g / n_micro, grads)
    updates, _ = OPT_UPDATE(grads, opt_state, params)
    ref = leaves_by_path(optax.apply_updates(params, updates))

    tm, optimizer = port_from_state(params, opt_state)
    state = T.TrainState(tm, optimizer, 1)
    tcond = {k: tt(v) for k, v in cond.items()}
    if n_micro == 1:
        step = T.make_train_step(tm, nets.t_sched, optimizer)
        loss = step(state, tt(z[0]), {k: v[0] for k, v in tcond.items()},
                    t=tt(t[0]), noise=tt(noise[0]))["loss"]
    else:
        model = SimpleNamespace(unet=tm, schedule=nets.t_sched, device=torch.device("cpu"))
        step = make_accum_train_step(model, optimizer, n_micro, cfg_probability=0.0)
        loss = step(state, tt(z), tcond, torch.Generator().manual_seed(0),
                    t_stack=tt(t), noise_stack=tt(noise))
    assert state.step == 2
    assert float(loss) == pytest.approx(np.mean(losses), rel=1e-5)
    out = leaves_by_path(flax_from_state_dict(dict(tm.named_parameters()), unet_norm_kinds(tm)))
    for path, r in ref.items():
        np.testing.assert_allclose(out[path], r, atol=1e-7, err_msg=str(path))


# ------------------------------------------- the static (graphed) step ----

def micro_stacks(seed, n_micro, b):
    """(n_micro, b, T, L, L, ·) latents and conditioning as torch tensors."""
    z, cond, _, _ = batch(seed, n=n_micro * b)
    z = tt(z.reshape(n_micro, b, *z.shape[2:]))
    cond = {k: tt(v.reshape(n_micro, b, *v.shape[2:])) for k, v in cond.items()}
    return z, cond


def interleaved_step(tm, optimizer, sched, z, cond, generator, cfg_probability):
    """The accumulated step as the eager loop ran it: per micro-batch the
    unconditional mask, then (inside mmdm_loss) the timesteps and the noise,
    drawn between the backward passes; .grad set by the first backward.
    Returns the mean loss and the masks drawn."""
    consts = T.schedule_consts(sched)
    optimizer.zero_grad(set_to_none=True)
    total, masks = torch.zeros(()), []
    for i in range(z.shape[0]):
        is_uncond = torch.rand((z.shape[1],), generator=generator) < cfg_probability
        masks.append(is_uncond)

        def mix(c):
            return torch.where(is_uncond.reshape(-1, *([1] * (c.ndim - 1))), torch.zeros_like(c), c)

        ci = {"pos_enc": mix(cond["pos_enc"][i]), "z_input": mix(cond["z_input"][i]),
              "ref_mask": cond["ref_mask"][i]}
        loss, _ = T.mmdm_loss(tm, consts, z[i], ci, generator,
                              num_timesteps=sched.num_timesteps)
        loss.backward()
        total += loss.detach()
    for p in tm.parameters():
        p.grad.div_(z.shape[0])
    optimizer.step()
    return total / z.shape[0], torch.cat(masks)


def static_step(nets, params, opt_state, cfg_probability, graphs=False):
    tm, optimizer = port_from_state(params, opt_state)
    model = SimpleNamespace(unet=tm, schedule=nets.t_sched, device=torch.device("cpu"))
    step = make_accum_train_step(model, optimizer, 2, cfg_probability=cfg_probability,
                                 graphs=graphs)
    return tm, optimizer, step


def assert_same_params(a, b):
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("draws", ["generator", "global"])
def test_static_step_equals_interleaved_draws_bit_for_bit(nets, draws):
    """make_accum_train_step (graphs=False: the body the card captures, run
    eagerly on its static slots) over 2 micro-batches of 2 samples at
    cfg_probability 0.5, drawing from a seeded generator, against the eager
    loop with its draws interleaved: the loss and every parameter bit for
    bit, the masks mixed. "global": cfg_probability 0 with no generator
    (chip_smoke.py's data-parallel run), drawing from torch's global RNG."""
    params, opt_state = carried_state(nets.params, 4)
    z, cond = micro_stacks(12, 2, 2)
    p_uncond = 0.5 if draws == "generator" else 0.0
    tm_ref, opt_ref = port_from_state(params, opt_state)
    tm, optimizer, step = static_step(nets, params, opt_state, p_uncond)
    with torch.random.fork_rng():
        torch.manual_seed(5)
        gen = torch.Generator().manual_seed(3) if draws == "generator" else None
        ref_loss, masks = interleaved_step(tm_ref, opt_ref, nets.t_sched, z, cond, gen, p_uncond)
        torch.manual_seed(5)
        gen = torch.Generator().manual_seed(3) if draws == "generator" else None
        loss = step(T.TrainState(tm, optimizer, 1), z, cond, gen)
    if draws == "generator":
        assert bool(masks.any()) and not bool(masks.all()), masks
    assert torch.equal(loss, ref_loss), (float(loss), float(ref_loss))
    assert_same_params(tm, tm_ref)


def test_static_step_keeps_grad_and_slot_addresses(nets):
    """Two static steps write the same .grad tensors and slots (the
    addresses a captured graph holds), and each step zeroes its gradients
    in place: garbage written into them between the steps changes nothing."""
    params, opt_state = carried_state(nets.params, 5)
    z, cond = micro_stacks(13, 2, 1)
    runs = []
    for poison in (False, True):
        tm, optimizer, step = static_step(nets, params, opt_state, 0.5)
        state, gen = T.TrainState(tm, optimizer, 1), torch.Generator().manual_seed(8)
        ptrs = []
        for _ in range(2):
            step(state, z, cond, gen)
            ptrs.append(([p.grad.data_ptr() for p in tm.parameters()],
                         {k: v.data_ptr() for k, v in step.graph.slots.items()}))
            if poison:
                for p in tm.parameters():
                    p.grad.fill_(float("nan"))
        assert ptrs[0] == ptrs[1]
        runs.append(tm)
    assert set(ptrs[0][1]) == {"z", "pos_enc", "z_input", "ref_mask", "t", "noise", "uncond"}
    assert_same_params(runs[1], runs[0])
    assert state.step == 3 and step.graph.counters() == {
        "graphed": False, "captures": 0, "capture_s": 0.0, "replays": 0}


class _ReplayEagerly:
    """A stand-in for a captured graph: a replay runs the body eagerly."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def test_graphed_control_flow_with_a_stand_in_graph(nets, monkeypatch):
    """The graphed path's control flow on the CPU, with a stand-in graph
    whose replay runs the body eagerly: the first micro-batch is the
    warm-up, then one capture and replays for the rest of the step and all
    of the next; a replaced .grad tensor leads to a new capture; every
    replay adds the capture's launches; and the result is the eager path's
    bit for bit."""
    from cap4d_torch.mmdm import step_graph
    from cap4d_torch.ops import flash_attention

    monkeypatch.setattr(step_graph, "warm_up", lambda fn: fn())
    monkeypatch.setattr(step_graph, "capture_graph", lambda fn: (
        _ReplayEagerly(fn), {k.name: int(k is flash_attention.KERNEL) for k in CudaKernel.registry}))
    params, opt_state = carried_state(nets.params, 6)
    z, cond = micro_stacks(14, 2, 1)
    tm_e, opt_e, eager = static_step(nets, params, opt_state, 0.5)
    tm_g, opt_g, graphed = static_step(nets, params, opt_state, 0.5)
    graphed.graph.graphs = True     # on the CPU, only with the stand-in
    gen_e, gen_g = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    k = flash_attention.KERNEL
    before = k.launches
    counts = []
    for s in range(3):
        if s == 2:
            p = next(tm_g.parameters())
            p.grad = p.grad.clone()
        le = eager(T.TrainState(tm_e, opt_e, 1), z, cond, gen_e)
        lg = graphed(T.TrainState(tm_g, opt_g, 1), z, cond, gen_g)
        assert torch.equal(le, lg), s
        counts.append((graphed.graph.captures, graphed.graph.replays))
    assert counts == [(1, 1), (1, 3), (2, 4)]
    assert k.launches - before == 4
    k.launches = before
    assert_same_params(tm_g, tm_e)


def test_micro_batch_body_reads_nothing_on_the_host(nets):
    """The body that the card captures (loss, remat'd forward and backward,
    the loss sum) calls no operator that reads the device on the host or
    uploads a host array."""
    tm = port_unet(nets.params, remat=True)
    optimizer = T.make_adamw(tm)
    model = SimpleNamespace(unet=tm, schedule=nets.t_sched, device=torch.device("cpu"))
    step = make_accum_train_step(model, optimizer, 2, cfg_probability=0.5)
    z, cond = micro_stacks(15, 2, 1)
    step(T.TrainState(tm, optimizer, 0), z, cond, torch.Generator().manual_seed(1))
    with HostReads() as scan:
        step.graph.body()
    assert scan.found == []


def test_graphs_need_the_card_and_detect_anomaly_runs_eagerly(nets, monkeypatch):
    """graphs=True raises on the CPU (no fallback); the CLI's
    --detect_anomaly asks train_mmdm for the eager path, and without it the
    device's default."""
    import sys

    from cap4d_torch.mmdm import train as train_mod

    tm = port_unet(nets.params)
    model = SimpleNamespace(unet=tm, schedule=nets.t_sched, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        make_accum_train_step(model, T.make_adamw(tm), 2, graphs=True)
    seen = []
    monkeypatch.setattr(train_mod, "train_mmdm", lambda *a, **kw: seen.append(
        (kw["graphs"], torch.is_anomaly_enabled())))
    argv = ["train", "--config_path", "c.yaml", "--output_path", "out", "--device", "cpu"]
    try:
        for extra in (["--detect_anomaly"], []):
            torch.autograd.set_detect_anomaly(False)
            monkeypatch.setattr(sys, "argv", argv + extra)
            train_mod.main()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert seen == [(False, True), (None, False)]


# ---------------------------------------------------- data, loop, formats ----

def test_synthetic_dataset_batches_equal_jax():
    model = SimpleNamespace(latent_size=8, unet=SimpleNamespace(condition_channels=50))
    jb, tb = JData(model, n_views=8, n_ref=4, seed=3).batches(2), TData(model, 8, 4, 3).batches(2)
    for _ in range(3):
        a, b = next(jb), next(tb)
        np.testing.assert_array_equal(a["z"], b["z"])
        for k in a["cond"]:
            np.testing.assert_array_equal(a["cond"][k], b["cond"][k], err_msg=k)


def test_batch_stager_draws_each_step_in_order_and_no_more():
    """BatchStager's worker draws the steps' micro-batches in the order a
    loop drawing each step in place would, and none past the last step; on
    the CPU the stacks are np.stack's."""
    model = SimpleNamespace(latent_size=8, unet=SimpleNamespace(condition_channels=50))
    ref, batches = TData(model, 8, 4, 3).batches(1), TData(model, 8, 4, 3).batches(1)
    with BatchStager(batches, 2, "cpu", 3) as stage:
        for _ in range(3):
            z, cond = stage.next()
            micro = [next(ref) for _ in range(2)]
            np.testing.assert_array_equal(z.numpy(), np.stack([m["z"] for m in micro]))
            assert set(cond) == set(micro[0]["cond"])
            for k, v in cond.items():
                np.testing.assert_array_equal(v.numpy(), np.stack([m["cond"][k] for m in micro]))
        with pytest.raises(RuntimeError, match="staged"):
            stage.next()
    np.testing.assert_array_equal(next(batches)["z"], next(ref)["z"])


@pytest.mark.parametrize("temporal_mode", ["3d", "temporal"])
def test_flax_conversion_round_trip(temporal_mode):
    """unet_flax_path inverts unet_torch_key on every path of the JAX tree at
    the shipped topology, and flax_from_state_dict(state_dict_from_flax(p))
    gives back p exactly."""
    cfg = dict(CFG, channel_mult=(1, 2, 4, 4), num_res_blocks=2, attention_resolutions=(4, 2, 1),
               time_steps=8, temporal_mode=temporal_mode)
    jm = JUNet(attn_backend="einsum", **cfg)
    c = {"pos_enc": jnp.zeros((1, 8, 16, 16, 50)), "z_input": jnp.zeros((1, 8, 16, 16, 4)),
         "ref_mask": jnp.zeros((1, 8, 16, 16, 1))}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16, 16, 4)),
                                            jnp.zeros((1, 8), jnp.int32), c))["params"]
    params = live_params(shapes, 5)
    with torch.device("meta"):
        tm = TUNet(**cfg)
    kinds = unet_norm_kinds(tm)
    ref = leaves_by_path(params)
    for path in ref:
        key = j_unet_key(path)
        assert unet_flax_path(key, kinds.get(key, "")) == path, (path, key)
    tm = TUNet(**cfg)
    tm.load_state_dict(state_dict_from_flax(params, unet_torch_key), strict=True)
    back = leaves_by_path(flax_from_state_dict(tm.state_dict(), kinds))
    assert set(back) == set(ref)
    for path, r in ref.items():
        np.testing.assert_array_equal(back[path], r, err_msg=str(path))


def test_train_mmdm_on_cpu_runs_logs_and_saves(tmp_path):
    """Three optimizer steps of 2 micro-batches on the small config, fp32 on
    the CPU, as test_train_loop_runs_and_logs runs the JAX loop; then the
    checkpoint's params load into the JAX UNet (unet.apply) and into a fresh
    port UNet, and both give the same eps (2e-4, the fp32 UNet parity of
    test_torch_networks.py)."""
    flame_dir = sa.make_asset_dir(tmp_path)
    model_section = sa.small_model_config()
    cfg_path = tmp_path / "train_config.yaml"
    dump_yaml({"model": model_section, "learning_rate": 1e-4, "gpu_batch_size": 1,
                  "virtual_batch_size": 2, "n_steps": 3, "n_ref": 4,
                  "save_every_n_steps": 3}, cfg_path)
    out = tmp_path / "train_out"
    state = train_mmdm(cfg_path, out, flame_asset_dir=flame_dir, log_every=1,
                       dtype=torch.float32, image_log_every=3, device="cpu")
    assert state.step == 3
    lines = [json.loads(l) for l in open(out / "train_metrics.jsonl")]
    assert [l["step"] for l in lines] == [1, 2, 3]
    losses = [l["loss"] for l in lines]
    assert np.isfinite(losses).all() and 0.2 < losses[-1] < 5.0
    assert all(l["steps_per_sec"] > 0 for l in lines)
    grid = read_png(out / "image_log" / "samples_000003.png")
    assert grid.shape == (64, 8 * 66 - 2, 3)
    ckpt = out / "mmdm_step3.pkl"
    assert ckpt.exists()

    import pickle

    with open(ckpt, "rb") as fh:
        saved = pickle.load(fh)
    assert saved["step"] == 3 and int(saved["opt_state"]["count"]) == 3
    up = model_section["params"]["unet_config"]["params"]
    jm = JUNet(in_channels=4, out_channels=4, model_channels=up["model_channels"],
               channel_mult=tuple(up["channel_mult"]), num_res_blocks=up["num_res_blocks"],
               attention_resolutions=tuple(up["attention_resolutions"]),
               num_head_channels=up["num_head_channels"], condition_channels=50,
               time_steps=up["time_steps"], attn_backend="einsum", fused_norms=True)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 8, 8, 8, 4)).astype(np.float32)
    ts = rng.integers(0, 1000, size=(1, 8))
    ref = np.zeros((1, 8, 8, 8, 1), np.float32)
    ref[:, :4] = 1.0
    cond = {"pos_enc": rng.normal(size=(1, 8, 8, 8, 50)).astype(np.float32),
            "z_input": x * ref, "ref_mask": ref}
    j_tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ts),
                                            {k: jnp.asarray(v) for k, v in cond.items()}))["params"]
    assert (jax.tree.structure(saved["params"]) == jax.tree.structure(j_tree)
            and all(a.shape == b.shape for a, b in zip(jax.tree.leaves(saved["params"]),
                                                       jax.tree.leaves(j_tree))))
    j_eps = np.asarray(jax.jit(jm.apply)({"params": saved["params"]}, jnp.asarray(x),
                                         jnp.asarray(ts), {k: jnp.asarray(v) for k, v in cond.items()}))

    fresh = TUNet(in_channels=4, out_channels=4, model_channels=up["model_channels"],
                  channel_mult=tuple(up["channel_mult"]), num_res_blocks=up["num_res_blocks"],
                  attention_resolutions=tuple(up["attention_resolutions"]),
                  num_head_channels=up["num_head_channels"], condition_channels=50,
                  time_steps=up["time_steps"])
    assert load_train_checkpoint(ckpt, fresh) == 3
    with torch.no_grad():
        t_eps = fresh(tt(x), tt(ts), {k: tt(v) for k, v in cond.items()}).numpy()
        trained = state.unet(tt(x), tt(ts), {k: tt(v) for k, v in cond.items()}).numpy()
    np.testing.assert_array_equal(t_eps, trained)
    np.testing.assert_allclose(t_eps, j_eps, atol=2e-4)


def test_save_image_grid_matches_jax(tmp_path):
    """The port's PNG grid (its own writer) is the JAX package's cv2 grid."""
    import cv2

    from cap4d_torch.utils.logging import save_image_grid as t_grid
    from cap4d_tpu.utils.logging import save_image_grid as j_grid

    imgs = np.random.default_rng(0).uniform(-1.1, 1.1, size=(2, 3, 16, 16, 3)).astype(np.float32)
    j_grid(imgs, tmp_path / "j.png")
    t_grid(imgs, tmp_path / "t.png")
    np.testing.assert_array_equal(read_png(tmp_path / "t.png"),
                                  cv2.imread(str(tmp_path / "j.png"))[..., ::-1])
