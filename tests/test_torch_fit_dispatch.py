"""The fit's dispatch on the CPU: the static pair budget
(``gsplat_tiles.tile_pairs(budget=)``), the camera bank, the static train
step (``AvatarTrainer.step``), the dispatcher
(``cap4d_torch/avatar/step_compiler.py``) and ``training(chunked=,
dispatch_len=)``.

On the CPU the dispatcher runs its lane step eagerly (a CUDA graph needs
the card), with the same snapshots, rollbacks and budget regrowths as on
the card. The bit-for-bit comparisons run torch on one thread: with several,
the CPU's accumulating index kernels add in a varying order, and the step
differs from itself in the last bits. The last test holds one dispatched
step against ``cap4d_tpu``'s chunk program (``_build_train_chunk``, one
live lane) at ``test_torch_avatar_step.py``'s tolerances.
"""

import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cap4d_torch.avatar import gaussians as G
from cap4d_torch.avatar import step_compiler
from cap4d_torch.avatar.convert_ref import deform_state_dict_from_flax, load_jax_capture
from cap4d_torch.avatar.scene import load_cap4d_dataset
from cap4d_torch.avatar.step_compiler import BUDGET_QUANTUM, StepGraphs, next_budget
from cap4d_torch.avatar.train import training
from cap4d_torch.avatar.trainer import AvatarTrainer, CameraBank
from cap4d_torch.ops import gsplat_tiles
from cap4d_torch.ops.cuda_build import CudaKernel
from cap4d_torch.ops.gsplat import N_OUT, TILE
from cap4d_torch.ops.gsplat_tiles import rasterize_gaussians, tile_pairs
from cap4d_torch.utils import synthetic_assets as sa
from tests.test_avatar_e2e import OPT_PARAMS
from tests.test_torch_capture import HostReads
from tests.test_torch_avatar_e2e import MODEL_PARAMS, _jax_trainer, _make_stage1_output
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fit_dispatch")
    flame_dir = sa.make_asset_dir(root, sphere_radius=0.09)
    return root, flame_dir, _make_stage1_output(root)


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _state(tr):
    """Every tensor of a trainer's fit state, by name, as numpy."""
    out = {f"gauss.{f}": tr.gauss[f] for f in G.FIELDS}
    out.update({f"aux.{k}": v for k, v in tr.aux.items()})
    for k, v in tr.moments.items():
        out.update({f"{k}.{n}": t for n, t in v.items()} if isinstance(v, dict) else {k: v})
    out.update({f"deform.{n}": p for n, p in tr.deform_net.named_parameters()})
    out["neck"] = tr.neck_weight
    return {k: v.detach().numpy().copy() for k, v in out.items()}


def _assert_same_state(a, b):
    sa_, sb = _state(a), _state(b)
    assert sa_.keys() == sb.keys()
    for k in sa_:
        np.testing.assert_array_equal(sa_[k], sb[k], err_msg=k)


# ---------------------------------------------------------- the pair budget

def _splats(seed, n, width, height):
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g)

    return dict(mean_x=u(-0.2 * width, 1.2 * width), mean_y=u(-0.2 * height, 1.2 * height),
                conic_a=u(0.005, 0.5), conic_b=u(-0.004, 0.004), conic_c=u(0.005, 0.5),
                opacity=u(0.0, 1.0), radius=torch.ceil(u(0.0, 40.0)),
                valid=torch.rand(n, generator=g) > 0.15,
                depth=torch.round(u(0.0, 8.0)))          # ties: broken by gaussian index


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(0, 400), width=st.integers(1, 130),
       height=st.integers(1, 130), slack=st.integers(-3000, 3000))
def test_budgeted_pairs_equal_unbudgeted(seed, n, width, height, slack):
    """Under budget, the budgeted build's first M pairs and its bounds are
    the unbudgeted ones bit for bit and its counter reads 0; over budget
    the counter holds exactly the candidates that did not fit."""
    sp = _splats(seed, n, width, height)
    pg, bounds = tile_pairs(**sp, width=width, height=height)
    boxes = gsplat_tiles._tile_boxes(sp["mean_x"], sp["mean_y"], sp["radius"], sp["valid"],
                                     width, height)
    total = int(boxes[3].sum())
    budget = max(total + slack, 0)
    pg_b, bounds_b, over = tile_pairs(**sp, width=width, height=height, budget=budget)
    assert pg_b.shape == (budget,) and pg_b.dtype == torch.int32 and over.shape == (1,)
    assert int(over) == max(total - budget, 0)
    if total <= budget:
        assert torch.equal(bounds_b, bounds)
        assert torch.equal(pg_b[:pg.shape[0]], pg)


def test_budgeted_render_equals_exact_render():
    """The plain compositor reads each tile's segment only, so a budgeted
    render is the exact one bit for bit, gradients included."""
    g = torch.Generator().manual_seed(3)
    n, width, height = 300, 70, 45
    means = torch.stack([torch.rand(n, generator=g) * 0.6 - 0.3,
                         torch.rand(n, generator=g) * 0.4 - 0.2,
                         torch.rand(n, generator=g) * 0.5 + 1.0], -1)
    quats = torch.randn(n, 4, generator=g)
    scales = torch.rand(n, 3, generator=g) * 0.03 + 0.005
    opac = torch.rand(n, generator=g)
    sh = torch.randn(n, 4, 3, generator=g) * 0.3
    rt = torch.eye(4)
    K = torch.tensor([[80.0, 0, 35.0], [0, 80.0, 22.5], [0, 0, 1]])
    outs = []
    for budget in (None, 2 * BUDGET_QUANTUM):
        leaves = [t.clone().requires_grad_(True) for t in (means, scales, opac, sh)]
        m2d = torch.zeros(n, 2, requires_grad=True)
        out = rasterize_gaussians(leaves[0], quats, leaves[1], leaves[2], leaves[3], rt, K,
                                  width, height, sh_degree=1, means2d_offset=m2d, budget=budget)
        if budget is not None:
            assert int(out["n_overflow"]) == 0
        grads = torch.autograd.grad(out["render"].square().sum(), leaves + [m2d])
        outs.append((out["render"].detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_next_budget():
    assert next_budget(0) == BUDGET_QUANTUM and next_budget(1) == BUDGET_QUANTUM
    assert next_budget(43690) == BUDGET_QUANTUM              # 1.5× is 65,535
    assert next_budget(43692) == 2 * BUDGET_QUANTUM          # 65,538
    assert next_budget(1_000_000) == 23 * BUDGET_QUANTUM     # 1.5e6 slots


# ---------------------------------------------------------- the camera bank

def test_camera_bank_gives_the_cameras_images(inputs):
    """PNG images go to the card as uint8 and come back as the float32
    image bit for bit; a set that is not 8-bit stays float32."""
    root, flame_dir, data_dir = inputs
    scene = load_cap4d_dataset([str(data_dir)])
    tr = AvatarTrainer.create(scene, MODEL_PARAMS, OPT_PARAMS, flame_asset_dir=flame_dir,
                              device="cpu")
    cams = scene.train_cameras
    bank = CameraBank.build(cams, tr.device)
    assert bank.gt.dtype == torch.uint8 and (bank.width, bank.height) == (cams[0].width,
                                                                           cams[0].height)
    for i, cam in enumerate(cams):
        got, ref = bank.camera(torch.tensor([i])), tr.camera_tensors(cam)
        for k in ("rt", "K", "gt", "mask"):
            assert torch.equal(got[k], ref[k]), k
        assert got["t"].tolist() == [int(cam.timestep)]
    cams[0]._image = cams[0].image + 1e-4
    assert CameraBank.build(cams, tr.device).gt.dtype == torch.float32
    cams[0].width += 1
    assert CameraBank.build(cams, tr.device) is None


# ---------------------------------------------------------- the static step

def _frozen_adam(p, g, m, v, step, lr, eps=1e-15, b1=0.9, b2=0.999, wd=0.0):
    g = g + wd * p
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / (1 - b1 ** step)
    vhat = v / (1 - b2 ** step)
    return p - lr * mhat / (torch.sqrt(vhat) + eps), m, v


def _frozen_step(tr, cam, iteration, adam_step):
    """``AvatarTrainer.train_step`` as it was before the static step: the
    schedules as host floats, the timestep read on the host, the exact pair
    build, and every update rebinding its tensor."""
    from cap4d_torch.avatar.binding import relative_rotation_loss_pack, safe_norm
    from cap4d_torch.avatar.flame_avatar import laplacian_loss, relative_deformation_loss
    from cap4d_torch.avatar.losses import l1_loss, ssim
    F = torch.nn.functional

    opt, mo = tr.opt, tr.moments
    ct = tr.camera_tensors(cam)
    t = int(cam.timestep)
    ramp = max(opt["lpips_linear_end"] - opt["lpips_linear_start"], 1)
    lambda_lpips = float(np.clip((iteration - opt["lpips_linear_start"]) / ramp, 0.0, 1.0)
                         * opt["lambda_lpips_end"])
    names = [k for k, _ in tr.deform_net.named_parameters()]
    dparams = [p for _, p in tr.deform_net.named_parameters()]
    for f in G.FIELDS:
        tr.gauss[f].requires_grad_(True)
    tr.neck_weight.requires_grad_(True)
    m2d = torch.zeros((tr.n_active, 2), requires_grad=True)
    gp = tr.gauss
    neck = torch.zeros(3) if tr.config.static_neck else tr.neck_weight[t]
    mesh = tr.variant.mesh_props(tr.deform_net, tr.flame_bank, t, neck)
    world = G.world_gaussians(gp, tr.aux, mesh.face_pack)
    out = rasterize_gaussians(world["means3d"], world["quats"], world["scales"],
                              world["opacities"], world["sh"], ct["rt"], ct["K"], cam.width,
                              cam.height, sh_degree=tr.active_sh_degree, means2d_offset=m2d)
    mask = ct["mask"][..., None]
    image_cf = (out["render"] * mask).permute(2, 0, 1)
    gt_cf = (ct["gt"] * mask).permute(2, 0, 1)
    losses = {}
    lam_ds = opt["lambda_dssim"]
    photo_w = (1 - lambda_lpips) if tr.lpips.available else 1.0
    losses["l1"] = l1_loss(image_cf, gt_cf) * (1 - lam_ds) * photo_w
    losses["ssim"] = (1 - ssim(image_cf, gt_cf, channel_first=True)) * lam_ds * photo_w
    if tr.lpips.available:
        losses["lpips"] = opt["w_lpips"] * lambda_lpips * tr.lpips(
            image_cf.permute(1, 2, 0), gt_cf.permute(1, 2, 0))
    vis = out["visibility"].to(torch.float32)
    nvis = torch.clamp(vis.sum(), min=1)
    xyz_pen = F.relu(safe_norm(gp["xyz"], dim=1) - opt["threshold_xyz"])
    losses["xyz"] = (xyz_pen * vis).sum() / nvis * opt["lambda_xyz"]
    sc_pen = safe_norm(F.relu(torch.exp(gp["scaling"]) - opt["threshold_scale"]), dim=1)
    losses["scale"] = (sc_pen * vis).sum() / nvis * opt["lambda_scale"]
    losses["lap"] = laplacian_loss(mesh.deform_output) * opt["lambda_laplacian"]
    neutral = G.world_gaussians(gp, tr.aux, mesh.neutral_pack)["means3d"]
    losses["deform"] = (relative_deformation_loss(world["means3d"], neutral)
                        * opt["lambda_relative_deform"])
    losses["rot"] = (relative_rotation_loss_pack(mesh.neutral_pack, mesh.face_pack)
                     * opt["lambda_relative_rot"])
    losses["neck"] = safe_norm(tr.neck_weight[t]) * opt["lambda_neck"]
    total = losses["total"] = sum(losses.values())
    leaves = [tr.gauss[f] for f in G.FIELDS] + dparams + [tr.neck_weight, m2d]
    g = torch.autograd.grad(total, leaves, allow_unused=True)
    for f in G.FIELDS:
        tr.gauss[f].requires_grad_(False)
    tr.neck_weight.requires_grad_(False)
    g = [torch.zeros_like(p) if gi is None else gi for gi, p in zip(g, leaves)]
    nf, nd = len(G.FIELDS), len(dparams)
    with torch.no_grad():
        m2d_g = torch.linalg.norm(g[-1][:, :2], dim=-1)
        vis_b, aux = out["visibility"], tr.aux
        aux["xyz_gradient_accum"] += torch.where(vis_b, m2d_g, torch.zeros_like(m2d_g))
        aux["denom"] += vis_b.to(m2d_g.dtype)
        aux["max_radii2d"] = torch.where(vis_b, torch.maximum(aux["max_radii2d"], out["radii"]),
                                         aux["max_radii2d"])
        lrs = tr.learning_rates(iteration)
        g_lr = {"xyz": lrs["xyz"], "features_dc": opt["feature_lr"],
                "features_rest": opt["feature_lr"] / 20.0, "opacity": opt["opacity_lr"],
                "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"]}
        for f, gf in zip(G.FIELDS, g[:nf]):
            tr.gauss[f], mo["gauss_m"][f], mo["gauss_v"][f] = _frozen_adam(
                tr.gauss[f], gf, mo["gauss_m"][f], mo["gauss_v"][f], adam_step, g_lr[f])
        for name, p, gd in zip(names, dparams, g[nf:nf + nd]):
            new_p, mo["deform_m"][name], mo["deform_v"][name] = _frozen_adam(
                p, gd, mo["deform_m"][name], mo["deform_v"][name], adam_step, lrs["deform"],
                wd=opt["deform_net_w_decay"])
            p.copy_(new_p)
        gn = g[-2]
        rows = (gn.abs().sum(-1, keepdim=True) > 0)
        n_p, n_m, n_v = _frozen_adam(tr.neck_weight, gn, mo["neck_m"], mo["neck_v"], adam_step,
                                     lrs["neck"], eps=1e-18)
        tr.neck_weight = torch.where(rows, n_p, tr.neck_weight)
        mo["neck_m"] = torch.where(rows, n_m, mo["neck_m"])
        mo["neck_v"] = torch.where(rows, n_v, mo["neck_v"])
    return {k: v.detach() for k, v in losses.items()}


def _frozen_reset_opacity(tr):
    with torch.no_grad():
        o = tr.gauss["opacity"]
        p = torch.clamp(torch.sigmoid(o), max=0.01)
        tr.gauss["opacity"] = torch.log(p / (1 - p))
        for k in ("gauss_m", "gauss_v"):
            tr.moments[k]["opacity"] = torch.zeros_like(tr.moments[k]["opacity"])


def _drive(tr, cams, step, reset):
    """OPT_PARAMS' ten iterations as ``training`` runs them (the camera
    order, the SH warmup, densification at 3 and 6, the opacity reset at 2
    and 6), through ``step(camera index, iteration)``."""
    opt = tr.opt
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    order, pos, losses = rng.permutation(len(cams)), 0, []
    for it in range(1, opt["iterations"] + 1):
        if pos >= len(order):
            order, pos = rng.permutation(len(cams)), 0
        idx, pos = int(order[pos]), pos + 1
        if it % opt["sh_warmup_iterations"] == 0:
            tr.active_sh_degree = min(tr.active_sh_degree + 1, tr.config.sh_degree)
        losses.append({k: float(v) for k, v in step(idx, it).items()})
        if it < opt["densify_until_iter"]:
            if it > opt["densify_from_iter"] and it % opt["densification_interval"] == 0:
                tr.densify(int(cams[idx].timestep), gen, None)
            if it % opt["opacity_reset_interval"] == 0 or it == opt["densify_from_iter"]:
                reset()
    return losses


def test_static_step_matches_the_frozen_step(inputs, one_thread):
    """The static step with the budgeted pair build, run eagerly through the
    dispatcher's lane step (device-read camera, iteration and Adam step,
    schedule tables, in-place Adam), against the step it replaced, bit for
    bit over ten iterations that cross an SH change, two densifications and
    two opacity resets."""
    root, flame_dir, data_dir = inputs
    scene = load_cap4d_dataset([str(data_dir)])
    cams = scene.train_cameras
    ref, new = (AvatarTrainer.create(scene, MODEL_PARAMS, OPT_PARAMS, flame_asset_dir=flame_dir,
                                     device="cpu") for _ in range(2))
    graphs = StepGraphs(new, CameraBank.build(cams, new.device),
                        step_compiler.probe_budget(new, cams), max_len=1, graphs=False)
    a = _drive(ref, cams, lambda i, it: _frozen_step(ref, cams[i], it, it),
               lambda: _frozen_reset_opacity(ref))
    b = _drive(new, cams, lambda i, it: {k: v[0] for k, v in graphs.run([i], it, it).items()},
               new.reset_opacity)
    assert ref.n_active > 1502 and ref.active_sh_degree == 1   # densified; SH warmed up
    assert a == b
    _assert_same_state(ref, new)
    # and train_step, the per-step path, is the same step
    cam = cams[0]
    la = _frozen_step(ref, cam, 11, 11)
    lb = new.train_step(cam, 11, 11)
    assert {k: float(v) for k, v in la.items()} == {k: float(lb[k]) for k in la}
    _assert_same_state(ref, new)


# ---------------------------------------------------------- the dispatch

@pytest.fixture(scope="module")
def fits(inputs, tmp_path_factory):
    """Four fits of OPT_PARAMS' ten iterations: dispatched one iteration at
    a time, ten at a time, four at a time from a budget of 64 slots, and
    per step (one thread each)."""
    from cap4d_torch.avatar import train as train_mod

    root, flame_dir, data_dir = inputs
    out = tmp_path_factory.mktemp("fits")
    runs = {"one": dict(chunked=True, dispatch_len=1), "ten": dict(chunked=True),
            "small": dict(chunked=True, dispatch_len=4), "eager": dict(chunked=False)}
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    probe = train_mod.probe_budget
    try:
        fitted = {}
        for name, kw in runs.items():
            train_mod.probe_budget = (lambda tr, cams: 64) if name == "small" else probe
            fitted[name] = training([str(data_dir)], out / name, MODEL_PARAMS, OPT_PARAMS, [],
                                    [], flame_asset_dir=flame_dir, device="cpu", **kw)
    finally:
        train_mod.probe_budget = probe
        torch.set_num_threads(before)
    return out, fitted


def test_dispatch_len_does_not_change_the_fit(fits):
    """training(chunked=True, dispatch_len=1) and the default dispatch of
    ten give bit-identical stores, deform nets and necks, and so does the
    per-step fit (test_avatar_e2e.py:276 for the JAX package)."""
    out, f = fits
    assert f["one"].step_graphs.max_len == 1 and f["ten"].step_graphs.max_len == 10
    assert f["eager"].step_graphs is None
    assert f["ten"].n_active > 1502                          # densified
    _assert_same_state(f["one"], f["ten"])
    _assert_same_state(f["one"], f["eager"])
    lines = [json.loads(l) for l in open(out / "ten" / "metrics.jsonl")]
    assert [l["iter"] for l in lines if "loss" in l] == [10]


def test_a_budget_too_small_rolls_back_and_regrows(fits):
    """A fit that starts with a budget of 64 slots overflows at once: the
    dispatch rolls back, the budget regrows (logged under the JAX log's
    keys), and the fit ends bit for bit where the fits with the probed
    budget (65,536 slots, never outgrown) end."""
    out, f = fits
    assert f["small"].step_graphs.regrowths[0][0] == 64
    # the first dispatch, iterations 1-2 (cut at the opacity reset at 2), ran twice
    assert f["small"].step_graphs.counters()["rolled_back"] == 2
    assert not f["ten"].step_graphs.regrowths and f["ten"].step_graphs.budget == BUDGET_QUANTUM
    grown = [json.loads(l) for l in open(out / "small" / "metrics.jsonl")
             if "capacity_grown" in l]
    assert grown[0] == {"iter": 1, "capacity_grown": f["small"].step_graphs.regrowths[0][1],
                        "prev_capacity": 64}
    _assert_same_state(f["small"], f["ten"])


def test_launch_counts_add_replays():
    """Every kernel is in the registry, and replays add their launches."""
    names = {k.name for k in CudaKernel.registry}
    assert {"gsplat_fwd", "gsplat_bwd"} <= names
    k = gsplat_tiles.KERNEL_BWD
    before = k.launches
    k.add_launches(3)
    assert k.launches == before + 3
    k.launches = before


# -------------------------------------------- capture safety, read on the CPU

def _compositor_stand_in(packed, pair_gauss, bounds, tiles_x, plain=False):
    """K4/K5's place in the scan: the plain compositor reads its segment
    lengths on the host, the kernels do not."""
    n_tiles = bounds.shape[0] - 1
    touch = packed[pair_gauss[:1].long()].sum() * 0.0 + packed.sum() * 0.0
    return touch + torch.zeros((n_tiles, TILE * TILE, N_OUT))


@pytest.mark.parametrize("variant", ["flame", "smpl"])
def test_lane_step_reads_nothing_on_the_host(inputs, tmp_path, monkeypatch, variant):
    """The lane step that the card captures, minus the compositor, calls no
    operator that reads the device on the host or uploads a host array."""
    root, flame_dir, data_dir = inputs
    if variant == "smpl":
        from cap4d_torch.smpl.scene import load_smpl_dataset
        from tests.test_torch_smpl import MODEL_PARAMS as SMPL_MP
        from tests.test_torch_smpl import OPT_PARAMS as SMPL_OPT

        smpl_dir = sa.make_smpl_asset_dir(tmp_path, n_rings=14, n_segments=16)
        scene = load_smpl_dataset([str(sa.make_smpl_dataset(tmp_path, n_views=3, width=48,
                                                              height=64, focal=100.0))])
        tr = AvatarTrainer.create_smpl(scene, SMPL_MP, SMPL_OPT, smpl_asset_dir=smpl_dir,
                                       device="cpu")
    else:
        scene = load_cap4d_dataset([str(data_dir)])
        tr = AvatarTrainer.create(scene, MODEL_PARAMS, OPT_PARAMS, flame_asset_dir=flame_dir,
                                  device="cpu")
    tr.active_sh_degree = 1
    tr.schedule_tables(10)
    graphs = StepGraphs(tr, CameraBank.build(scene.train_cameras, tr.device), BUDGET_QUANTUM,
                        max_len=2, graphs=False)
    graphs.run([0], 1, 1)                                   # first use: caches, tables
    monkeypatch.setattr(gsplat_tiles, "composite", _compositor_stand_in)
    with HostReads() as scan:
        graphs.lane_step()
    assert scan.found == []


# ---------------------------------------------------------- against JAX

def test_dispatched_step_matches_jax_chunk(inputs, one_thread):
    """One dispatched step from an identical state against cap4d_tpu's
    chunk program with one live lane: every learning rate 0, so both write
    (1 − β1)·g into their first moments (and nothing else moves), which
    are held at test_torch_avatar_step.py:39's tolerances."""
    root, flame_dir, data_dir = inputs
    zero_lr = dict(OPT_PARAMS, feature_lr=0.0, opacity_lr=0.0, scaling_lr=0.0, rotation_lr=0.0,
                   position_lr_init=0.0, position_lr_final=0.0, deform_net_lr_init=0.0,
                   deform_net_lr_final=0.0, neck_lr_init=0.0, neck_lr_final=0.0)
    from cap4d_tpu.avatar.scene import load_cap4d_dataset as jax_dataset
    from cap4d_tpu.avatar.train import _build_cam_bank, _chunk_args, _chunk_meta

    tj = _jax_trainer(data_dir, flame_dir, zero_lr)
    scene = load_cap4d_dataset([str(data_dir)])
    tt = AvatarTrainer.create(scene, MODEL_PARAMS, zero_lr, flame_asset_dir=flame_dir,
                              device="cpu")
    load_jax_capture(tt, tj.capture())
    it, idx = 5, 1
    cams_j = jax_dataset([str(data_dir)]).train_cameras
    chunk = tj._build_train_chunk(cams_j[0].width, cams_j[0].height, 1)
    gp, dp, neck, aux, moments, losses_j = chunk(
        *_chunk_args(tj, _build_cam_bank(cams_j), _chunk_meta(it, 1, [idx])))
    assert int(losses_j["n_truncated"][0]) == 0 and int(losses_j["n_truncated_depth"][0]) == 0

    graphs = StepGraphs(tt, CameraBank.build(scene.train_cameras, tt.device),
                        step_compiler.probe_budget(tt, scene.train_cameras), max_len=10,
                        graphs=False)
    losses_t = graphs.run([idx], it, 1)
    for k, v in losses_t.items():
        np.testing.assert_allclose(v[0], float(losses_j[k][0]), rtol=1e-4, atol=1e-7, err_msg=k)
    act = np.asarray(aux.active)
    for f in G.FIELDS:
        mj = np.asarray(getattr(moments["gauss_m"], f))[act]
        scale = np.abs(mj).max() + 1e-12
        np.testing.assert_allclose(tt.moments["gauss_m"][f].numpy() / scale, mj / scale,
                                   atol=2e-3, err_msg=f)
    ref = deform_state_dict_from_flax(jax.tree.map(np.asarray, moments["deform_m"]),
                                      MODEL_PARAMS["n_unet_layers"])
    top = max(float(v.abs().max()) for v in ref.values())
    for k, v in ref.items():
        np.testing.assert_allclose(tt.moments["deform_m"][k].numpy() / top, v.numpy() / top,
                                   atol=2e-3, err_msg=k)
    t = scene.train_cameras[idx].timestep
    nm = np.asarray(moments["neck_m"])[t]
    np.testing.assert_allclose(tt.moments["neck_m"][t].numpy(), nm, atol=2e-3 * np.abs(nm).max())
    acc = np.asarray(aux.xyz_gradient_accum)[act]
    np.testing.assert_allclose(tt.aux["xyz_gradient_accum"].numpy(), acc, atol=2e-3 * acc.max())
    np.testing.assert_array_equal(tt.aux["denom"].numpy(), np.asarray(aux.denom)[act])
