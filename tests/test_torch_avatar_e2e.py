"""Avatar fit and animation of the port end to end on the CPU: a miniature
fit with checkpoint, animation and PLY export, and checkpoints written by
either package (``cap4d_torch``, ``cap4d_tpu``) loaded by the other with
equal renders. One training iteration from an identical state is in
``test_torch_avatar_step.py``.

The JAX side renders through its CPU rasterizer (the XLA path, with caps
raised so nothing truncates); the port through its plain compositor.
Renders agree within 2e-4 on 99.9 % of the values and within 5e-3
anywhere (a pair whose alpha sits at the 1/255 keep threshold may fall on
either side of it in the two packages, a step of 1/255 of a colour).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from cap4d_tpu.avatar import trainer as jtr
from cap4d_tpu.avatar.scene import load_cap4d_dataset as jax_dataset
from cap4d_torch.avatar.convert_ref import (
    load_reference_avatar_checkpoint,
    restore_reference_checkpoint,
)
from cap4d_torch.avatar.scene import load_cap4d_dataset
from cap4d_torch.avatar.trainer import AvatarTrainer
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_torch.utils.png import write_png
from tests.test_avatar_e2e import OPT_PARAMS
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

RES = 64
MODEL_PARAMS = dict(
    n_unet_layers=5, n_points_per_triangle=1, use_lower_jaw=True, static_neck=False,
    use_glasses=True, gaussian_init_type="scaled", use_expr_mask=True, uv_resolution=32,
    n_gaussians_init=400, sh_degree=1,
)


def _make_stage1_output(root: Path, n_frames=4, seed=3) -> Path:
    """A generated_images-style dir: flame/*.npz + images/*.png."""
    rng = np.random.default_rng(seed)
    out = root / "generated_images"
    (out / "flame").mkdir(parents=True)
    (out / "images").mkdir(parents=True)
    shape = rng.normal(scale=0.3, size=(150,)).astype(np.float32)
    for i in range(n_frames):
        item = {
            "shape": shape,
            "expr": rng.normal(scale=0.3, size=(1, 65)).astype(np.float32),
            "rot": rng.normal(scale=0.05, size=(1, 3)).astype(np.float32),
            "tra": np.zeros((1, 3), np.float32),
            "eye_rot": rng.normal(scale=0.05, size=(1, 3)).astype(np.float32),
            "fx": np.full((1, 1), 500.0, np.float32), "fy": np.full((1, 1), 500.0, np.float32),
            "cx": np.full((1, 1), RES / 2, np.float32), "cy": np.full((1, 1), RES / 2, np.float32),
            "extr": np.eye(4, dtype=np.float32)[None],
            "resolutions": np.array([[RES, RES]], np.int64),
            "crop_box": np.array([0, 0, RES, RES], np.int64),
            "timestep_id": i,
        }
        item["extr"][0, 2, 3] = 1.2
        np.savez(out / "flame" / f"{i:05d}.npz", **item)
        write_png(out / "images" / f"{i:05d}.png",
                  rng.uniform(0, 255, size=(RES, RES, 3)).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_avatar_e2e")
    flame_dir = sa.make_asset_dir(root, sphere_radius=0.09)
    return root, flame_dir, _make_stage1_output(root)


def _jax_trainer(data_dir, flame_dir, opt, seed=0):
    """A JAX trainer on the CPU rasterizer with caps that never truncate,
    moved off its initial state so every parameter group gets a gradient."""
    t = jtr.AvatarTrainer.create(jax_dataset([str(data_dir)]), MODEL_PARAMS, opt,
                                 flame_asset_dir=flame_dir)
    t.max_per_tile, t.max_tiles_per_gaussian = 2048, 400
    t.active_sh_degree = 1
    rng = np.random.default_rng(seed)
    gp = t.gauss_params
    C = gp.xyz.shape[0]
    # anisotropic scales: the rotation gradient of an isotropic splat is
    # rounding noise only
    t.gauss_params = gp.replace(
        xyz=gp.xyz + jnp.asarray(rng.normal(scale=0.05, size=(C, 3)), jnp.float32),
        scaling=gp.scaling + jnp.asarray(rng.normal(scale=0.4, size=(C, 3)), jnp.float32),
        opacity=jnp.asarray(rng.uniform(-2, 3, size=(C, 1)), jnp.float32),
        rotation=gp.rotation + jnp.asarray(rng.normal(scale=0.2, size=(C, 4)), jnp.float32),
        features_dc=jnp.asarray(rng.normal(scale=0.5, size=gp.features_dc.shape), jnp.float32),
        features_rest=jnp.asarray(rng.normal(scale=0.1, size=gp.features_rest.shape),
                                  jnp.float32))
    up0 = t.deform_params["up_0"]
    t.deform_params["up_0"] = {
        "kernel": jnp.asarray(rng.normal(scale=0.02, size=up0["kernel"].shape), jnp.float32),
        "bias": jnp.asarray(rng.normal(scale=0.01, size=up0["bias"].shape), jnp.float32)}
    t.neck_weight = jnp.asarray(rng.normal(scale=0.01, size=t.neck_weight.shape), jnp.float32)
    return t


@pytest.fixture(scope="module")
def fitted(inputs):
    from cap4d_torch.avatar.train import training

    root, flame_dir, data_dir = inputs
    model_path = root / "avatar"
    trainer = training([str(data_dir)], model_path, MODEL_PARAMS, OPT_PARAMS,
                       testing_iterations=[8], checkpoint_iterations=[8],
                       flame_asset_dir=flame_dir, device="cpu")
    return model_path, trainer


def test_fit_checkpoint_animation_and_ply(inputs, fitted):
    root, flame_dir, data_dir = inputs
    model_path, trainer = fitted
    lines = [json.loads(l) for l in open(model_path / "metrics.jsonl")]
    assert np.isfinite([l["loss"] for l in lines if "loss" in l]).all()
    assert any("val/psnr" in l for l in lines)
    assert (model_path / "chkpnt8.pth").exists() and (model_path / "chkpnt10.pth").exists()
    assert (model_path / "config_dump.yaml").exists() and (model_path / "cameras.json").exists()
    assert trainer.n_active > 400          # densification at 3 and 6 cloned/split

    from cap4d_torch.avatar.animate import render_sequence
    from cap4d_torch.utils.plyio import read_ply

    drv = sa.make_driving_sequence(root, n_frames=3, resolution=RES, fx=500.0, distance=1.2)
    res = render_sequence(model_path, drv, root / "anim", flame_asset_dir=flame_dir,
                          save_alpha=True, save_depth=True, compress_ply=True, device="cpu")
    assert res["frames"] == 3
    frames = sorted((root / "anim" / "frames").glob("?????.png"))
    assert len(frames) == 3 and len(list((root / "anim" / "frames").glob("*_depth.npy"))) == 3
    ply = read_ply(root / "anim" / "exported_animation.ply")
    assert {"faces", "base_vertex", "vertex", "delta_vertex_00002", "meta_delta_min_00002"} <= set(ply)
    assert ply["delta_vertex_00000"].dtype["x"] == np.uint8
    assert len(ply["vertex"]) == trainer.n_active and "binding" in ply["vertex"].dtype.names


def test_capture_restore_and_gaussian_ply_roundtrip(inputs, fitted, tmp_path):
    from cap4d_torch.avatar.export import load_gaussian_ply, save_gaussian_ply

    root, flame_dir, data_dir = inputs
    _, trainer = fitted
    scene = load_cap4d_dataset([str(data_dir)])
    fresh = AvatarTrainer.create(scene, MODEL_PARAMS, OPT_PARAMS, flame_asset_dir=flame_dir,
                                 device="cpu")
    fresh.restore(trainer.capture())
    cam = scene.train_cameras[0]
    np.testing.assert_array_equal(fresh.render_camera(cam, cam.timestep)["render"].numpy(),
                                  trainer.render_camera(cam, cam.timestep)["render"].numpy())
    g = {k: v.numpy() for k, v in trainer.gauss.items()}
    path = tmp_path / "gaussians.ply"
    save_gaussian_ply(path, g["xyz"], g["features_dc"], g["features_rest"], g["opacity"],
                      g["scaling"], g["rotation"], binding=trainer.aux["binding"].numpy())
    loaded = load_gaussian_ply(path)
    for k in ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation"):
        np.testing.assert_array_equal(loaded[k], g[k], err_msg=k)
    np.testing.assert_array_equal(loaded["binding"], trainer.aux["binding"].numpy())


def _assert_renders_close(ours, ref):
    err = np.abs(np.asarray(ours) - np.asarray(ref))
    assert err.max() <= 5e-3, err.max()
    assert (err > 2e-4).mean() <= 1e-3, (err > 2e-4).sum()


def test_port_checkpoint_loads_into_jax(inputs, fitted):
    root, flame_dir, data_dir = inputs
    model_path, trainer = fitted
    from cap4d_tpu.avatar.convert_ref import (
        load_reference_avatar_checkpoint as jax_load,
        restore_reference_checkpoint as jax_restore,
    )

    tj = jtr.AvatarTrainer.create(jax_dataset([str(data_dir)]), MODEL_PARAMS, OPT_PARAMS,
                                  flame_asset_dir=flame_dir)
    tj.max_per_tile, tj.max_tiles_per_gaussian = 2048, 400
    chkpt, it = jax_load(model_path / "chkpnt10.pth")
    assert it == 10
    jax_restore(tj, chkpt)
    assert int(tj.gauss_aux.n_active) == trainer.n_active
    cam_j = jax_dataset([str(data_dir)]).train_cameras[0]
    cam_t = load_cap4d_dataset([str(data_dir)]).train_cameras[0]
    out_j = tj.render_camera(cam_j, cam_j.timestep)
    assert int(out_j["n_truncated"]) == 0 and int(out_j["n_truncated_depth"]) == 0
    _assert_renders_close(trainer.render_camera(cam_t, cam_t.timestep)["render"], out_j["render"])


def test_jax_checkpoint_loads_into_port(inputs, tmp_path):
    root, flame_dir, data_dir = inputs
    tj = _jax_trainer(data_dir, flame_dir, OPT_PARAMS, seed=1)
    path = tj.save_checkpoint(tmp_path, 3)
    tt = AvatarTrainer.create(load_cap4d_dataset([str(data_dir)]), MODEL_PARAMS, OPT_PARAMS,
                              flame_asset_dir=flame_dir, device="cpu")
    chkpt, it = load_reference_avatar_checkpoint(path)
    assert it == 3
    restore_reference_checkpoint(tt, chkpt)
    assert tt.n_active == int(tj.gauss_aux.n_active) and tt.active_sh_degree == 1
    np.testing.assert_allclose(tt.neck_weight.numpy(), np.asarray(tj.neck_weight))
    for cam_j, cam_t in zip(jax_dataset([str(data_dir)]).train_cameras[:2],
                            load_cap4d_dataset([str(data_dir)]).train_cameras[:2]):
        out_j = tj.render_camera(cam_j, cam_j.timestep)
        assert int(out_j["n_truncated"]) == 0
        _assert_renders_close(tt.render_camera(cam_t, cam_t.timestep)["render"], out_j["render"])
