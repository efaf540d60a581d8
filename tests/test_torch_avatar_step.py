"""One avatar training iteration of the port against ``cap4d_tpu`` from an
identical state: the JAX trainer's ``capture()`` carried over with
``cap4d_torch.avatar.convert_ref.load_jax_capture``, then the losses and
per-group gradients before Adam, and the Adam update on identical
gradients (the eps 1e-15 first step is lr·sign(g), so whole trajectories
are not compared).

The JAX side runs its CPU rasterizer (the XLA path, caps raised so nothing
truncates); the port its plain compositor. Tolerances: losses 1e-4
relative; gradients 2e-3 of each group's largest gradient (two compositors,
sums in other orders); Adam 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_tpu.avatar import trainer as jtr
from cap4d_tpu.avatar.scene import load_cap4d_dataset as jax_dataset
from cap4d_torch.avatar import gaussians as G
from cap4d_torch.avatar.convert_ref import deform_state_dict_from_flax, load_jax_capture
from cap4d_torch.avatar.scene import load_cap4d_dataset
from cap4d_torch.avatar.trainer import AvatarTrainer, adam_update
from cap4d_torch.utils import synthetic_assets as sa
from tests.test_avatar_e2e import OPT_PARAMS
from tests.test_torch_avatar_e2e import MODEL_PARAMS, _jax_trainer, _make_stage1_output
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_avatar_step")
    flame_dir = sa.make_asset_dir(root, sphere_radius=0.09)
    return root, flame_dir, _make_stage1_output(root)


def test_one_step_from_identical_state(inputs):
    """JAX's step with every learning rate 0 leaves the parameters and
    writes (1 - β1)·g into the zeroed first moments: its gradients, before
    any update, to hold the port's against."""
    root, flame_dir, data_dir = inputs
    zero_lr = dict(OPT_PARAMS, feature_lr=0.0, opacity_lr=0.0, scaling_lr=0.0, rotation_lr=0.0,
                   position_lr_init=0.0, position_lr_final=0.0, deform_net_lr_init=0.0,
                   deform_net_lr_final=0.0, neck_lr_init=0.0, neck_lr_final=0.0)
    tj = _jax_trainer(data_dir, flame_dir, zero_lr)
    tt = AvatarTrainer.create(load_cap4d_dataset([str(data_dir)]), MODEL_PARAMS, zero_lr,
                              flame_asset_dir=flame_dir, device="cpu")
    np.testing.assert_array_equal(tt.uv.pix_to_face.numpy(), np.asarray(tj.uv.pix_to_face))
    load_jax_capture(tt, tj.capture())

    from cap4d_tpu.avatar.train import _step_args

    cam_j = jax_dataset([str(data_dir)]).train_cameras[1]
    cam_t = load_cap4d_dataset([str(data_dir)]).train_cameras[1]
    it = 5
    step = tj._build_train_step(cam_j.width, cam_j.height, 1)
    gp, dp, neck, aux, moments, losses_j, _ = step(*_step_args(tj, cam_j, it, 1))
    assert int(losses_j["n_truncated"]) == 0 and int(losses_j["n_truncated_depth"]) == 0
    losses_t, out_t, grads_t = tt.gradients(cam_t, it)

    for k, v in losses_t.items():
        np.testing.assert_allclose(float(v), float(losses_j[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    act = np.asarray(aux.active)
    for f in G.FIELDS:
        gj = np.asarray(getattr(moments["gauss_m"], f))[act] / 0.1
        gt = grads_t["gauss"][f].numpy()
        scale = np.abs(gj).max() + 1e-12
        np.testing.assert_allclose(gt / scale, gj / scale, atol=2e-3, err_msg=f)
    wd = OPT_PARAMS["deform_net_w_decay"]
    ref = deform_state_dict_from_flax(jax.tree.map(lambda m: np.asarray(m) / 0.1,
                                                   moments["deform_m"]), MODEL_PARAMS["n_unet_layers"])
    params = dict(tt.deform_net.named_parameters())
    top = max(float(v.abs().max()) for v in ref.values())
    for k, v in ref.items():
        g = grads_t["deform"][k] + wd * params[k].detach()
        np.testing.assert_allclose(g.numpy() / top, v.numpy() / top, atol=2e-3, err_msg=k)
    t = cam_t.timestep
    gneck = np.asarray(moments["neck_m"])[t] / 0.1
    np.testing.assert_allclose(grads_t["neck"][t].numpy(), gneck,
                               atol=2e-3 * np.abs(gneck).max())
    # densification statistics from the means2d gradient
    G.add_densification_stats(tt.aux, grads_t["m2d"], out_t["visibility"], out_t["radii"])
    acc = np.asarray(aux.xyz_gradient_accum)[act]
    np.testing.assert_allclose(tt.aux["xyz_gradient_accum"].numpy(), acc,
                               atol=2e-3 * acc.max())
    np.testing.assert_array_equal(tt.aux["denom"].numpy(), np.asarray(aux.denom)[act])


@pytest.mark.parametrize("step,wd,eps", [(1, 0.0, 1e-15), (7, 2e-3, 1e-15), (3, 0.0, 1e-18)])
def test_adam_update_matches_jax(step, wd, eps):
    rng = np.random.default_rng(step)
    p, g = rng.normal(size=(2, 50)).astype(np.float32)
    m = rng.normal(scale=0.01, size=50).astype(np.float32)
    v = rng.uniform(0, 1e-4, size=50).astype(np.float32)
    ours = adam_update(*(torch.as_tensor(a) for a in (p, g, m, v)), step, 1e-3, eps=eps, wd=wd)
    ref = jtr.adam_update(*(jnp.asarray(a) for a in (p, g, m, v)), jnp.float32(step), 1e-3,
                          eps=eps, wd=wd)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


