"""cap4d_torch UNet and VAE against cap4d_tpu's with the same parameters
carried across by ``state_dict_from_flax`` (fp32, CPU), the state-dict key
manifest, and the MMDM weight loading / random-init contract."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_torch.mmdm.convert import (
    VAE_PREFIX,
    UNET_PREFIX,
    newest_checkpoint,
    state_dict_from_flax,
)
from cap4d_torch.mmdm.convert import unet_torch_key as t_unet_key
from cap4d_torch.mmdm.convert import vae_torch_key as t_vae_key
from cap4d_torch.mmdm.model import MMDM
from cap4d_torch.mmdm.unet import MMDMUNet as TUNet
from cap4d_torch.mmdm.unet import timestep_embedding as t_temb
from cap4d_torch.mmdm.vae import AutoencoderKL as TVAE
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_tpu.mmdm.convert import unet_torch_key, vae_torch_key
from cap4d_tpu.mmdm.unet import MMDMUNet as JUNet
from cap4d_tpu.mmdm.unet import timestep_embedding as j_temb
from cap4d_tpu.mmdm.vae import AutoencoderKL as JVAE
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

SMALL = dict(in_channels=4, out_channels=4, model_channels=32, channel_mult=(1, 2),
             num_res_blocks=1, attention_resolutions=(1, 2), num_head_channels=16,
             condition_channels=10, time_steps=2)
# the shipped topology (mult (1,2,4,4), 2 res blocks, attention at 4/2/1) at
# a narrow width: the same parameter names as the full-width model
DEEP = dict(SMALL, channel_mult=(1, 2, 4, 4), num_res_blocks=2, attention_resolutions=(4, 2, 1),
            condition_channels=50, time_steps=8)


def random_params(tree, seed):
    """Fan-in-scaled kernels, norm scales 1 ± 0.1, small biases (numpy)."""
    rng = np.random.default_rng(seed)

    def mk(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = tuple(leaf.shape)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "bias":
            return (0.05 * rng.normal(size=shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, tree)


def _paths(tree):
    return [tuple(getattr(k, "key", str(k)) for k in kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_timestep_embedding_matches():
    t = np.array([0, 1, 37, 999], np.int64)
    # fp32 sin/cos of arguments up to ~1e3 rad differ between libraries
    np.testing.assert_allclose(t_temb(torch.from_numpy(t), 320).numpy(),
                               np.asarray(j_temb(jnp.asarray(t), 320)), atol=2e-4)


@pytest.mark.parametrize("temporal_mode", ["3d", "temporal"])
def test_unet_parity(temporal_mode):
    rng = np.random.default_rng(1)
    B, T, H, W = 1, SMALL["time_steps"], 16, 16
    x = rng.normal(size=(B, T, H, W, 4)).astype(np.float32)
    ts = rng.integers(0, 1000, size=(B, T))
    cond = {"pos_enc": rng.normal(size=(B, T, H, W, SMALL["condition_channels"])).astype(np.float32),
            "z_input": rng.normal(size=(B, T, H, W, 4)).astype(np.float32),
            "ref_mask": np.zeros((B, T, H, W, 1), np.float32)}
    cond["ref_mask"][:, 0] = 1.0

    jm = JUNet(temporal_mode=temporal_mode, attn_backend="einsum", fused_norms=True, **SMALL)
    jc = {k: jnp.asarray(v) for k, v in cond.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                            jnp.asarray(ts), jc))["params"]
    params = random_params(shapes, 3)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ts), jc))

    tm = TUNet(temporal_mode=temporal_mode, **SMALL)
    tm.load_state_dict(state_dict_from_flax(params, t_unet_key), strict=True)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(ts),
                 {k: torch.from_numpy(v) for k, v in cond.items()}).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(out[:, 0], x[:, 0] - cond["z_input"][:, 0], atol=1e-6)


def test_vae_parity():
    dd = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    z = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    jm = JVAE(embed_dim=4, **dd)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(img)))["params"]
    params = random_params(shapes, 4)
    tm = TVAE(embed_dim=4, **dd)
    tm.load_state_dict(state_dict_from_flax(params, t_vae_key), strict=True)

    mean, logvar = jm.apply({"params": params}, jnp.asarray(img), method=jm.encode_moments)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, mean.shape, mean.dtype))
    sample = jm.apply({"params": params}, jnp.asarray(img), key, method=jm.encode)
    dec = jm.apply({"params": params}, jnp.asarray(z), method=jm.decode)
    with torch.no_grad():
        t_mean, t_logvar = tm.encode_moments(torch.from_numpy(img))
        t_sample = tm.encode(torch.from_numpy(img), torch.from_numpy(noise))
        t_dec = tm.decode(torch.from_numpy(z))
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(mean), atol=2e-4)
    np.testing.assert_allclose(t_logvar.numpy(), np.asarray(logvar), atol=2e-4)
    np.testing.assert_allclose(t_sample.numpy(), np.asarray(sample), atol=2e-4)
    np.testing.assert_allclose(t_dec.numpy(), np.asarray(dec), atol=2e-4)


@pytest.mark.parametrize("net", ["unet", "vae"])
def test_state_dict_key_manifest(net):
    """The port's state_dict keys are exactly the image of cap4d_tpu's
    unet_torch_key / vae_torch_key over the JAX parameter tree, at the
    shipped topology, and the port's key functions agree with cap4d_tpu's."""
    if net == "unet":
        jm = JUNet(temporal_mode="3d", attn_backend="einsum", **DEEP)
        L, V = 16, DEEP["time_steps"]
        c = {"pos_enc": jnp.zeros((1, V, L, L, 50)), "z_input": jnp.zeros((1, V, L, L, 4)),
             "ref_mask": jnp.zeros((1, V, L, L, 1))}
        tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, V, L, L, 4)),
                                              jnp.zeros((1, V), jnp.int32), c))["params"]
        with torch.device("meta"):
            tm = TUNet(temporal_mode="3d", **DEEP)
        key_fn, t_key_fn = unet_torch_key, t_unet_key
    else:
        dd = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4)
        jm = JVAE(embed_dim=4, **dd)
        tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
        with torch.device("meta"):
            tm = TVAE(embed_dim=4, **dd)
        key_fn, t_key_fn = vae_torch_key, t_vae_key
    paths = _paths(tree)
    expected = {key_fn(p) for p in paths}
    assert len(expected) == len(paths)
    assert set(tm.state_dict().keys()) == expected
    assert all(t_key_fn(p) == key_fn(p) for p in paths)
    shapes = {key_fn(p): leaf.shape for p, (_, leaf)
              in zip(paths, jax.tree_util.tree_flatten_with_path(tree)[0])}
    for k, v in tm.state_dict().items():
        s = shapes[k]
        s = (s[3], s[2], s[0], s[1]) if len(s) == 4 else (s[::-1] if len(s) == 2 else s)
        assert tuple(v.shape) == tuple(s), k


def test_mmdm_random_init_and_checkpoint(tmp_path):
    """Random weights mirror the JAX package's mode (N(0, 0.02) for ≥2-D
    parameters, zeros for ≤1-D ones); a released-format checkpoint (prefixed
    keys under ``state_dict``, newest by ctime) loads strictly."""
    flame_dir = sa.make_asset_dir(tmp_path)
    ckpt_dir = sa.write_model_config(tmp_path)
    cfg = ckpt_dir / "config_dump.yaml"
    m = MMDM.from_config(cfg, flame_asset_dir=flame_dir, device="cpu")
    for module in (m.unet, m.vae):
        big = torch.cat([p.flatten() for p in module.parameters() if p.ndim >= 2])
        assert abs(float(big.std()) - 0.02) < 1e-3
        assert all(not p.any() for p in module.parameters() if p.ndim <= 1)

    sd = {UNET_PREFIX + k: torch.randn_like(v) for k, v in m.unet.state_dict().items()}
    sd.update({VAE_PREFIX + k: torch.randn_like(v) for k, v in m.vae.state_dict().items()})
    (ckpt_dir / "checkpoints").mkdir()
    torch.save({"state_dict": {k: torch.zeros_like(v) for k, v in sd.items()}},
               ckpt_dir / "checkpoints" / "old.ckpt")
    time.sleep(0.05)
    torch.save({"state_dict": sd}, ckpt_dir / "checkpoints" / "new.ckpt")
    os.utime(ckpt_dir / "checkpoints" / "new.ckpt")
    assert newest_checkpoint(ckpt_dir).name == "new.ckpt"
    m2 = MMDM.from_config(cfg, ckpt_path=ckpt_dir, flame_asset_dir=flame_dir, device="cpu")
    for k, v in m2.unet.state_dict().items():
        torch.testing.assert_close(v, sd[UNET_PREFIX + k])
    for k, v in m2.vae.state_dict().items():
        torch.testing.assert_close(v, sd[VAE_PREFIX + k])
