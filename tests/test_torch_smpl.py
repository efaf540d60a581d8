"""The port's full-body SMPL path (``cap4d_torch.smpl``, ``create_smpl``,
``training(variant="smpl")``, ``render_sequence_smpl``) and its host tools
against ``cap4d_tpu`` on the CPU, from the same seeded numpy inputs.

Tolerances: SMPL vertices 2e-5 (fp32 blend shapes and kinematics in another
order); face frames 2e-4 (normalised directions of short remesh edges);
losses 1e-4 relative, gradients 2e-3 of each group's largest (two
compositors, sums in other orders); the Adam update 1e-5 relative; renders
within the 1/255 keep step (a pair whose alpha sits at the 1/255 threshold
may fall on either side of it in the two packages).
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_tpu.avatar import trainer as jtr
from cap4d_tpu.avatar.flame_avatar import allocate_gaussians
from cap4d_tpu.ops.rasterize import rasterize_meshes
from cap4d_tpu.smpl import avatar as ja
from cap4d_tpu.smpl import model as jm
from cap4d_tpu.smpl import scene as js
from cap4d_torch.avatar import flame_avatar as tfa
from cap4d_torch.avatar import gaussians as G
from cap4d_torch.avatar.convert_ref import (
    deform_state_dict_from_flax,
    load_jax_capture,
    load_reference_avatar_checkpoint,
    restore_reference_checkpoint,
)
from cap4d_torch.avatar.trainer import AvatarTrainer
from cap4d_torch.smpl import avatar as ta
from cap4d_torch.smpl import model as tm
from cap4d_torch.smpl import scene as ts
from cap4d_torch.utils import synthetic_assets as sa
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

RES = 64
# tests/test_smpl.py's fit sizes
MODEL_PARAMS = dict(n_unet_layers=5, n_points_per_triangle=1, gaussian_init_type="scaled",
                    uv_resolution=32, n_gaussians_init=300, sh_degree=1)
OPT_PARAMS = dict(
    iterations=4, sh_warmup_iterations=2, lambda_scale=1.0, threshold_scale=1.0,
    lambda_xyz=1e-3, threshold_xyz=2.0, metric_xyz=False, metric_scale=False,
    feature_lr=0.0025, opacity_lr=0.025, scaling_lr=0.005, rotation_lr=0.001,
    percent_dense=0.01, lambda_dssim=0.5, densification_interval=100,
    densify_grad_threshold=1e-6, opacity_reset_interval=100,
    densify_until_iter=0, densify_from_iter=0,
    position_lr_init=5e-3, position_lr_final=5e-5, position_lr_delay_mult=0.01,
    position_lr_max_steps=1000, w_lpips=0.1, lambda_lpips_end=0.9,
    lpips_linear_start=100, lpips_linear_end=600, deform_net_w_decay=2e-3,
    deform_net_lr_init=1e-5, deform_net_lr_final=1e-7,
    deform_net_lr_delay_mult=0.01, deform_net_lr_max_steps=1000,
    lambda_laplacian=0.0, lambda_relative_deform=0.0, lambda_relative_rot=0.0,
    neck_lr_init=1e-5, neck_lr_final=1e-7, neck_lr_delay_mult=0.01,
    neck_lr_max_steps=1000, lambda_neck=0.0,
)


def _close(a, b, atol=1e-5, rtol=1e-5, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol, err_msg=msg)


# ------------------------------------------------------------ the SMPL model


@pytest.mark.parametrize("n_verts", [500, 6890])
def test_smpl_forward_matches_jax(n_verts):
    sd = tm.make_synthetic_smpl(n_verts=n_verts, seed=4)
    for k, v in jm.make_synthetic_smpl(n_verts=n_verts, seed=4).items():
        np.testing.assert_array_equal(sd[k], v, err_msg=k)
    rng = np.random.default_rng(0)
    betas = rng.normal(scale=0.5, size=10).astype(np.float32)
    pose = rng.normal(scale=0.3, size=(2, 69)).astype(np.float32)
    go = rng.normal(scale=0.3, size=(2, 3)).astype(np.float32)
    tr = rng.normal(size=(2, 3)).astype(np.float32)
    ref = jm.smpl_forward(jm.build_smpl_model(sd), *(jnp.asarray(a) for a in (betas, pose, go, tr)))
    out = tm.smpl_forward(tm.build_smpl_model(sd), *(torch.as_tensor(a) for a in (betas, pose, go, tr)))
    _close(out["verts"], ref["verts"], atol=2e-5, rtol=0)
    _close(out["joints"], ref["joints"], atol=2e-5, rtol=0)


def test_load_smpl_pkl_matches_jax(tmp_path):
    path = tmp_path / "SMPL_NEUTRAL.pkl"
    with open(path, "wb") as fh:
        pickle.dump(tm.make_synthetic_smpl(n_verts=300, seed=1), fh)
    ours, ref = tm.load_smpl_pkl(path), jm.load_smpl_pkl(path)
    assert sorted(ours) == sorted(ref) and ours["kintree_table"][0, 0] == -1
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


# ------------------------------------------------------- avatar variant


@pytest.fixture(scope="module")
def smpl_dir(tmp_path_factory):
    """A small body template (14 rings of 16) in the SMPL asset layout."""
    return sa.make_smpl_asset_dir(tmp_path_factory.mktemp("smpl_assets"), n_rings=14,
                                  n_segments=16)


def test_smpl_asset_dir_has_smpl_sizes(tmp_path):
    d = sa.make_smpl_asset_dir(tmp_path)
    sd = tm.load_smpl_pkl(d / "SMPL_NEUTRAL.pkl")
    assert sd["v_template"].shape == (6890, 3) and sd["f"].shape == (13776, 3)
    assert sd["shapedirs"].shape == (6890, 3, 10) and sd["posedirs"].shape == (6890, 3, 207)
    assert sd["J_regressor"].shape == (24, 6890) and sd["weights"].shape == (6890, 24)
    np.testing.assert_array_equal(sd["kintree_table"][0], tm.SMPL_PARENTS)
    v = sd["v_template"]
    assert 1.6 < v[:, 1].max() - v[:, 1].min() < 1.8    # body-sized
    tv, tf, tuv, tfuv, de = ta.load_smpl_template(d)
    assert tuv.min() > 0 and tuv.max() < 1 and len(de) == 6890
    # every UV face is a small triangle of the chart (nothing wraps around the seam)
    assert np.ptp(tuv[tfuv][..., 0], axis=1).max() < 0.1


@pytest.fixture(scope="module")
def uv_pair(smpl_dir):
    """UV assets at 16² by both packages from the same rasterization (the
    JAX fragments handed to the port), and the port's own."""
    from cap4d_torch.ops.rasterize import Fragments

    tv, tf, tuv, tfuv, de = ta.load_smpl_template(smpl_dir)
    uv_j = ja.build_uv_assets(*ja.load_smpl_template(smpl_dir), 16)
    own = ta.build_uv_assets(tv, tf, tuv, tfuv, de, 16)
    uvs = tuv * 2.0 - 1.0
    uvs[:, 1] = -uvs[:, 1]
    ndc = np.concatenate([uvs, np.ones_like(uvs[:, :1])], -1).astype(np.float32)
    frag = rasterize_meshes(jnp.asarray(ndc)[None], jnp.asarray(tfuv), (16, 16))
    real = tfa.rasterize_meshes
    tfa.rasterize_meshes = lambda *a, **k: Fragments(*(torch.as_tensor(np.array(x)) for x in frag))
    try:
        uv_t = ta.build_uv_assets(tv, tf, tuv, tfuv, de, 16)
    finally:
        tfa.rasterize_meshes = real
    return tv, uv_t, uv_j, own


def test_smpl_uv_assets_match_jax(uv_pair):
    tv, uv_t, uv_j, own = uv_pair
    for name in ("pix_to_face", "uv_mask", "deform_mask", "remesh_faces", "template_faces"):
        np.testing.assert_array_equal(getattr(uv_t, name).numpy(), np.asarray(getattr(uv_j, name)),
                                      err_msg=name)
    _close(uv_t.bary, uv_j.bary)
    b_t, c_t = tfa.allocate_gaussians(uv_t, torch.as_tensor(tv), 300, 1)
    b_j, c_j = allocate_gaussians(uv_j, jnp.asarray(tv), 300, 1)
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_array_equal(c_t, c_j)
    # the lat-long chart has no texel centre on a face edge: the port's own
    # rasterization (kernel K3's plain version) covers the same texels
    np.testing.assert_array_equal(own.pix_to_face.numpy(), np.asarray(uv_j.pix_to_face))


def test_smpl_mesh_props_match_jax(smpl_dir, uv_pair):
    _, uv_t, uv_j, _ = uv_pair
    sd = tm.load_smpl_pkl(smpl_dir / "SMPL_NEUTRAL.pkl")
    rng = np.random.default_rng(3)
    meshes = [{"betas": rng.normal(scale=0.5, size=10).astype(np.float32),
               "body_pose": rng.normal(scale=0.3, size=69).astype(np.float32),
               "global_orient": rng.normal(scale=0.3, size=3).astype(np.float32)}
              for _ in range(2)]
    vj = ja.SMPLVariant(jm.build_smpl_model(sd), uv_j)
    vt = ta.SMPLVariant(tm.build_smpl_model(sd), uv_t)
    bank_j = vj.build_bank(meshes, np.zeros(3, np.float32))
    bank_t = vt.build_bank(meshes, np.zeros(3, np.float32))
    for k in bank_j:
        _close(bank_t[k], bank_j[k], atol=0, rtol=0, msg=k)
    mj = vj.mesh_props(None, None, bank_j, 1, jnp.zeros(3))
    mt = vt.mesh_props(None, bank_t, 1, torch.zeros(3))
    for name in ("face_pack", "neutral_pack", "verts"):
        _close(getattr(mt, name), getattr(mj, name), atol=2e-4, msg=name)
    assert float(mt.deform_output.abs().max()) == 0.0


# ------------------------------------------------------------ datasets


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("smpl_capture")
    return root, sa.make_smpl_dataset(root, n_views=3, width=RES, height=RES, focal=100.0)


def _same_cameras(cams_t, cams_j):
    assert len(cams_t) == len(cams_j)
    for a, b in zip(cams_t, cams_j):
        assert (a.uid, a.timestep, a.width, a.height) == (b.uid, b.timestep, b.width, b.height)
        np.testing.assert_array_equal(a.rt, b.rt)
        np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
        if b.mask is not None:
            np.testing.assert_array_equal(a.mask, b.mask)


def _same_meshes(ms_t, ms_j):
    assert len(ms_t) == len(ms_j)
    for a, b in zip(ms_t, ms_j):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_smpl_datasets_match_jax(capture, tmp_path):
    from cap4d_torch.tools.generate_animation import make_wave_animation

    root, data = capture
    s_t, s_j = ts.load_smpl_dataset([str(data)]), js.load_smpl_dataset([str(data)])
    for split in ("train_cameras", "test_cameras", "val_cameras"):
        _same_cameras(getattr(s_t, split), getattr(s_j, split))
    _same_meshes(s_t.train_meshes, s_j.train_meshes)
    assert s_t.cameras_extent == s_j.cameras_extent == 2.0
    np.testing.assert_array_equal(s_t.train_cameras[0].image, np.asarray(
        s_j.train_cameras[0].image))
    anim = tmp_path / "wave.npz"
    np.savez(anim, **make_wave_animation(5, (RES, 48)))
    d_t = ts.read_smpl_driving_sequence(anim, cam_id_offset=3)
    d_j = js.read_smpl_driving_sequence(anim, cam_id_offset=3)
    _same_cameras(d_t[0], d_j[0])
    _same_meshes(d_t[1], d_j[1])
    (tmp_path / "bad" / "smpl").mkdir(parents=True)
    (tmp_path / "bad" / "images").mkdir()
    np.savez(tmp_path / "bad" / "smpl" / "00000.npz", **dict(np.load(data / "smpl" / "00000.npz")))
    (tmp_path / "bad" / "images" / "00000.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="PNG"):
        ts.load_smpl_dataset([str(tmp_path / "bad")])


# ------------------------------------------------------------ one training step


def _perturb(t, seed=0):
    """Move a JAX trainer off its initial state so every gaussian group gets
    a gradient; caps that never truncate."""
    t.max_per_tile, t.max_tiles_per_gaussian = 2048, 400
    t.active_sh_degree = 1
    rng = np.random.default_rng(seed)
    gp = t.gauss_params
    C = gp.xyz.shape[0]
    t.gauss_params = gp.replace(
        xyz=gp.xyz + jnp.asarray(rng.normal(scale=0.02, size=(C, 3)), jnp.float32),
        scaling=gp.scaling + jnp.asarray(rng.normal(scale=0.4, size=(C, 3)), jnp.float32),
        opacity=jnp.asarray(rng.uniform(-2, 3, size=(C, 1)), jnp.float32),
        rotation=gp.rotation + jnp.asarray(rng.normal(scale=0.2, size=(C, 4)), jnp.float32),
        features_dc=jnp.asarray(rng.normal(scale=0.5, size=gp.features_dc.shape), jnp.float32),
        features_rest=jnp.asarray(rng.normal(scale=0.1, size=gp.features_rest.shape),
                                  jnp.float32))
    return t


def test_create_smpl_one_step_matches_jax(smpl_dir, capture):
    """JAX's step with the gaussian and neck learning rates 0 leaves those
    parameters and writes (1 - β1)·g into the zeroed first moments; the
    deform net (gated off, zero gradients) still takes Adam's weight decay,
    at a nonzero learning rate, and is held against the port's update."""
    from cap4d_tpu.avatar.train import _step_args

    _, data = capture
    opt = dict(OPT_PARAMS, feature_lr=0.0, opacity_lr=0.0, scaling_lr=0.0, rotation_lr=0.0,
               position_lr_init=0.0, position_lr_final=0.0, neck_lr_init=0.0,
               neck_lr_final=0.0, deform_net_lr_init=1e-3, deform_net_lr_final=1e-4)
    tj = _perturb(jtr.AvatarTrainer.create_smpl(js.load_smpl_dataset([str(data)]), MODEL_PARAMS,
                                                opt, smpl_asset_dir=smpl_dir))
    tt = AvatarTrainer.create_smpl(ts.load_smpl_dataset([str(data)]), MODEL_PARAMS, opt,
                                   smpl_asset_dir=smpl_dir, device="cpu")
    assert tt.variant.name == "smpl" and tt.config.static_neck and not tt.config.use_lower_jaw
    np.testing.assert_array_equal(tt.uv.pix_to_face.numpy(), np.asarray(tj.uv.pix_to_face))
    load_jax_capture(tt, tj.capture())
    cam_j = js.load_smpl_dataset([str(data)]).train_cameras[1]
    cam_t = ts.load_smpl_dataset([str(data)]).train_cameras[1]
    it = 5
    step = tj._build_train_step(cam_j.width, cam_j.height, 1)
    gp, dp, neck, aux, moments, losses_j, _ = step(*_step_args(tj, cam_j, it, 1))
    assert int(losses_j["n_truncated"]) == 0 and int(losses_j["n_truncated_depth"]) == 0
    before = {k: v.clone() for k, v in tt.gauss.items()}
    losses_t, out_t, grads_t = tt.gradients(cam_t, it)
    assert float(out_t["visibility"].sum()) > 0
    for k, v in losses_t.items():
        np.testing.assert_allclose(float(v), float(losses_j[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    act = np.asarray(aux.active)
    for f in G.FIELDS:
        gj = np.asarray(getattr(moments["gauss_m"], f))[act] / 0.1
        scale = np.abs(gj).max() + 1e-12
        np.testing.assert_allclose(grads_t["gauss"][f].numpy() / scale, gj / scale, atol=2e-3,
                                   err_msg=f)
    wd = opt["deform_net_w_decay"]
    ref_m = deform_state_dict_from_flax(jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                                     moments["deform_m"]), 5)
    params = {k: p.detach().clone() for k, p in tt.deform_net.named_parameters()}
    for k, v in ref_m.items():
        assert not bool(grads_t["deform"][k].any()), k        # gated off: zero gradients
        _close(grads_t["deform"][k] + wd * params[k], v, rtol=1e-5, atol=1e-12, msg=k)
    assert not bool(grads_t["neck"].any())
    tt.apply_adam(grads_t, it, 1)
    for f in G.FIELDS:
        np.testing.assert_array_equal(tt.gauss[f].numpy(), before[f].numpy(), err_msg=f)
    # the update itself (the step, lr·m̂/(√v̂ + ε) ≈ lr·sign(p), nearly cancels
    # p where p ≈ lr): JAX's float32 bias correction 1 - 0.999 is 1.3e-5 off
    new_j = deform_state_dict_from_flax(jax.tree.map(np.asarray, dp), 5)
    for k, p in tt.deform_net.named_parameters():
        step_t = p.detach() - params[k]
        assert bool(step_t.any()) or not bool(params[k].any()), k   # the decay moved it
        _close(step_t, new_j[k] - params[k].numpy(), rtol=1e-5, atol=1e-10, msg=k)


# --------------------------------------------------- fit, checkpoints, animation


@pytest.fixture(scope="module")
def fitted(smpl_dir, capture):
    from cap4d_torch.avatar.train import training

    root, data = capture
    model_path = root / "smpl_avatar"
    trainer = training([str(data)], model_path, MODEL_PARAMS, OPT_PARAMS, testing_iterations=[4],
                       checkpoint_iterations=[4], variant="smpl", smpl_asset_dir=smpl_dir,
                       device="cpu")
    return model_path, trainer


def _driving(root, n_frames=4):
    from cap4d_torch.tools.generate_animation import make_wave_animation

    path = root / "wave_drive.npz"
    anim = make_wave_animation(n_frames, (RES, RES))
    anim["fx"][:] = anim["fy"][:] = 40.0      # the 1.7 m body inside 64² at 2 m
    np.savez(path, **anim)
    return path


def _assert_renders_close(ours, ref):
    err = np.abs(np.asarray(ours) - np.asarray(ref))
    assert err.max() <= 5e-3, err.max()
    assert (err > 2e-4).mean() <= 2e-3, (err > 2e-4).sum()


def _jax_driving_trainer(smpl_dir, anim, chkpt_path):
    """A JAX SMPL trainer on the driving sequence with a checkpoint restored
    and the driving bank put back (the JAX restore replays the fit's bank)."""
    from cap4d_tpu.avatar.convert_ref import load_reference_avatar_checkpoint as jax_load
    from cap4d_tpu.avatar.convert_ref import restore_reference_checkpoint as jax_restore

    scene = js.load_smpl_dataset(None, target_animation_path=str(anim))
    tj = jtr.AvatarTrainer.create_smpl(scene, MODEL_PARAMS, OPT_PARAMS, smpl_asset_dir=smpl_dir)
    chkpt, _ = jax_load(chkpt_path)
    jax_restore(tj, chkpt)
    tj.max_per_tile, tj.max_tiles_per_gaussian = 2048, 400
    bank = tj.variant.build_bank(scene.tgt_meshes, np.zeros(3, np.float32))
    bank["betas"] = tj.flame_bank["betas"]
    bank["base_rot"] = tj.flame_bank["base_rot"]
    tj.flame_bank = bank
    return tj, scene


def _port_driving_trainer(smpl_dir, anim, chkpt_path):
    scene = ts.load_smpl_dataset(None, target_animation_path=str(anim))
    tt = AvatarTrainer.create_smpl(scene, MODEL_PARAMS, OPT_PARAMS, smpl_asset_dir=smpl_dir,
                                   device="cpu")
    chkpt, _ = load_reference_avatar_checkpoint(chkpt_path)
    restore_reference_checkpoint(tt, chkpt, with_extras=False)
    return tt, scene


def test_smpl_fit_animation_and_ply(smpl_dir, capture, fitted):
    from cap4d_torch.avatar.animate_smpl import render_sequence_smpl
    from cap4d_torch.utils.config import load_yaml
    from cap4d_torch.utils.plyio import read_ply

    root, _ = capture
    model_path, trainer = fitted
    assert (model_path / "chkpnt4.pth").exists() and trainer.variant.name == "smpl"
    assert load_yaml(model_path / "config_dump.yaml")["variant"] == "smpl"
    chkpt, it = load_reference_avatar_checkpoint(model_path / "chkpnt4.pth")
    assert it == 4 and "betas" in chkpt and "shape" not in chkpt
    np.testing.assert_array_equal(chkpt["betas"].numpy(), trainer.flame_bank["betas"].numpy())
    out = root / "smpl_anim"
    res = render_sequence_smpl(model_path, _driving(root), out, smpl_asset_dir=smpl_dir,
                               n_max_frames=2, device="cpu")
    assert res["frames"] == 2 and len(list((out / "frames").glob("*.png"))) == 2
    ply = read_ply(out / "exported_animation.ply")
    assert "delta_vertex_00001" in ply and len(ply["vertex"]) == trainer.n_active
    with pytest.raises(ValueError, match="dp_frames"):   # more ranks than the one process
        render_sequence_smpl(model_path, _driving(root), out, smpl_asset_dir=smpl_dir,
                             dp_frames=2, device="cpu")


def test_smpl_port_checkpoint_loads_into_jax(smpl_dir, capture, fitted):
    root, _ = capture
    model_path, trainer = fitted
    anim = _driving(root)
    tj, scene_j = _jax_driving_trainer(smpl_dir, anim, model_path / "chkpnt4.pth")
    tt, scene_t = _port_driving_trainer(smpl_dir, anim, model_path / "chkpnt4.pth")
    assert int(tj.gauss_aux.n_active) == tt.n_active == trainer.n_active
    np.testing.assert_array_equal(np.asarray(tj.flame_bank["betas"]), tt.flame_bank["betas"].numpy())
    for cam_j, cam_t in zip(scene_j.tgt_cameras[1:3], scene_t.tgt_cameras[1:3]):
        out_j = tj.render_camera(cam_j, cam_j.timestep)
        assert int(out_j["n_truncated"]) == 0
        out_t = tt.render_camera(cam_t, cam_t.timestep)
        assert float(out_t["alpha"].max()) > 0.5
        _assert_renders_close(out_t["render"], out_j["render"])


def test_smpl_jax_checkpoint_loads_into_port(smpl_dir, capture, tmp_path):
    root, data = capture
    tj = _perturb(jtr.AvatarTrainer.create_smpl(js.load_smpl_dataset([str(data)]), MODEL_PARAMS,
                                                OPT_PARAMS, smpl_asset_dir=smpl_dir), seed=1)
    path = tj.save_checkpoint(tmp_path, 3)
    anim = _driving(root)
    tj2, scene_j = _jax_driving_trainer(smpl_dir, anim, path)
    tt, scene_t = _port_driving_trainer(smpl_dir, anim, path)
    assert tt.n_active == int(tj.gauss_aux.n_active) and tt.active_sh_degree == 1
    np.testing.assert_array_equal(tt.flame_bank["betas"].numpy(), np.asarray(tj.flame_bank["betas"]))
    for cam_j, cam_t in zip(scene_j.tgt_cameras[:2], scene_t.tgt_cameras[:2]):
        _assert_renders_close(tt.render_camera(cam_t, cam_t.timestep)["render"],
                              tj2.render_camera(cam_j, cam_j.timestep)["render"])


# ------------------------------------------------------------ host tools


def test_animation_tools_match_jax(tmp_path):
    from cap4d_torch.tools.generate_animation import make_wave_animation
    from cap4d_torch.tools.generate_animation_camerahmr import combine_camerahmr_fits
    from cap4d_tpu.tools.generate_animation import make_wave_animation as jax_wave
    from cap4d_tpu.tools.generate_animation_camerahmr import combine_camerahmr_fits as jax_combine

    def same(a, b):
        assert sorted(a) == sorted(b)
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    same(make_wave_animation(7, (96, 64)), jax_wave(7, (96, 64)))
    rng = np.random.default_rng(0)
    for i in range(3):
        np.savez(tmp_path / f"{i:03d}.npz", betas=rng.normal(size=10).astype(np.float32),
                 global_orient=rng.normal(size=(1, 3)), body_pose=rng.normal(size=(1, 69)),
                 T=rng.normal(size=(1, 3)), R=rng.normal(size=(1, 3, 3)))
    same(combine_camerahmr_fits(tmp_path), jax_combine(tmp_path))
    with pytest.raises(ValueError, match="no npz"):
        combine_camerahmr_fits(tmp_path / "empty")


def test_make_orbit_matches_jax(tmp_path):
    from cap4d_torch.tools.make_orbit import make_orbit
    from cap4d_tpu.tools.make_orbit import make_orbit as jax_orbit

    fit = sa.make_reference_dir(tmp_path, resolution=64) / "fit.npz"
    ours, ref = make_orbit(str(fit), n_frames=12), jax_orbit(str(fit), n_frames=12)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=1e-6, err_msg=k)


def _obj_lines(path):
    lines = path.read_text().splitlines()
    return [l for l in lines if l.startswith("v ")], [l for l in lines if l.startswith("f ")]


def _same_obj(ours, ref):
    """Face lines equal; vertex lines equal up to the 6th decimal's rounding."""
    (v_o, f_o), (v_r, f_r) = _obj_lines(ours), _obj_lines(ref)
    assert f_o == f_r and len(v_o) == len(v_r)
    a = np.array([l.split()[1:] for l in v_o], float)
    b = np.array([l.split()[1:] for l in v_r], float)
    np.testing.assert_allclose(a, b, atol=2.5e-6, rtol=0)
    assert np.mean([x == y for x, y in zip(v_o, v_r)]) > 0.95


def test_debug_obj_tools_match_jax(tmp_path, monkeypatch):
    from cap4d_torch.tools.debug_flame import debug_flame
    from cap4d_torch.tools.debug_smpl import debug_smpl
    from cap4d_torch.tools.generate_animation import make_wave_animation
    from cap4d_tpu.tools import debug_flame as jdf
    from cap4d_tpu.tools import debug_smpl as jds

    pkl = tmp_path / "SMPL_NEUTRAL.pkl"
    with open(pkl, "wb") as fh:
        pickle.dump(tm.make_synthetic_smpl(n_verts=200, seed=2), fh)
    anim = tmp_path / "wave.npz"
    np.savez(anim, **make_wave_animation(3))
    for args in ([], ["--animation_npz", str(anim), "--timestep", "2"]):
        monkeypatch.setattr(sys, "argv", ["debug_smpl", "--smpl_pkl", str(pkl), "--output",
                                          str(tmp_path / "jax_smpl.obj")] + args)
        jds.main()
        debug_smpl(pkl, tmp_path / "smpl.obj", anim if args else None, 2 if args else 0)
        _same_obj(tmp_path / "smpl.obj", tmp_path / "jax_smpl.obj")

    flame_dir = sa.make_asset_dir(tmp_path)
    fit = sa.make_reference_dir(tmp_path, resolution=64) / "fit.npz"
    monkeypatch.setattr(sys, "argv", ["debug_flame", "--flame_asset_dir", str(flame_dir),
                                      "--fit_npz", str(fit), "--timestep", "1", "--add_mouth",
                                      "--output", str(tmp_path / "jax_flame.obj")])
    jdf.main()
    debug_flame(flame_dir, tmp_path / "flame.obj", fit, 1, add_mouth=True)
    _same_obj(tmp_path / "flame.obj", tmp_path / "jax_flame.obj")


def test_export_reference_frames_matches_jax(tmp_path):
    """Both packages read the reference frames through their native
    loaders, which resize to the same floats."""
    from cap4d_torch.tools.export_reference_frames import export_reference_frames
    from cap4d_torch.utils.png import read_png
    from cap4d_tpu.tools.export_reference_frames import export_reference_frames as jax_export

    flame_dir = sa.make_asset_dir(tmp_path)
    ref = sa.make_reference_dir(tmp_path, resolution=96)
    a = export_reference_frames(ref, tmp_path / "ours", 64, flame_dir)
    b = jax_export(ref, tmp_path / "jax", 64, flame_dir)
    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
    assert files(a) == files(b) and files(a)
    for f in files(a):
        if f.endswith(".npz"):
            za, zb = dict(np.load(a / f)), dict(np.load(b / f))
            assert sorted(za) == sorted(zb)
            for k in zb:
                np.testing.assert_allclose(za[k], zb[k], rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            da, db = read_png(a / f).astype(int), read_png(b / f).astype(int)
            assert np.abs(da - db).max() <= 1
