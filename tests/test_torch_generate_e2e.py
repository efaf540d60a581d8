"""Miniature stage 1 end to end: cap4d_torch's run_generation against
cap4d_tpu's on the same synthetic assets, the same checkpoint (written in the
released format, loaded by both) and the same noise (JAX's posterior and
initial-bank draws handed to the port). Both read the reference frames
through their native loaders. The port runs again with two view-groups in
one UNet call (``groups_per_device=2``)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cap4d_torch.inference.generate_images import run_generation as torch_run
from cap4d_torch.mmdm.convert import UNET_PREFIX, VAE_PREFIX
from cap4d_torch.mmdm.model import MMDM
from cap4d_torch.utils import synthetic_assets as sa

SEED, N_GEN, LAT = 124, 14, 8   # two groups of G = 7


def _write_checkpoint(ckpt_dir: Path, flame_dir: Path) -> None:
    """Fan-in-scaled weights with nonzero norm scales, prefixed as in the
    released .ckpt."""
    m = MMDM.from_config(ckpt_dir / "config_dump.yaml", flame_asset_dir=flame_dir, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = {}
    for prefix, module in ((UNET_PREFIX, m.unet), (VAE_PREFIX, m.vae)):
        for k, v in module.state_dict().items():
            if v.ndim == 1:
                w = (1.0 if k.endswith("weight") else 0.0) + 0.05 * torch.randn(v.shape, generator=gen)
            else:
                w = torch.randn(v.shape, generator=gen) / v[0].numel() ** 0.5
            state[prefix + k] = w
    (ckpt_dir / "checkpoints").mkdir()
    torch.save({"state_dict": state}, ckpt_dir / "checkpoints" / "last.ckpt")


def _jax_noise():
    """The posterior and initial-bank noise cap4d_tpu's run_generation draws."""
    rng = jax.random.PRNGKey(SEED)
    rng, enc_rng = jax.random.split(rng)
    _, sub = jax.random.split(enc_rng)
    enc = np.array(jax.random.normal(sub, (8, LAT, LAT, 4)))[:1]   # chunk of 8, 1 reference
    _, s_rng = jax.random.split(rng)
    return {"encode": enc, "x_bank": np.array(jax.random.normal(s_rng, (N_GEN, LAT, LAT, 4)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e")
    flame_dir = sa.make_asset_dir(root)
    ref_dir = sa.make_reference_dir(root, resolution=256)
    bank = sa.make_gen_bank(root, n=16)
    ckpt_dir = sa.write_model_config(root)
    cfg = sa.write_gen_config(root, ckpt_dir, bank, n_samples=N_GEN, n_ddim_steps=2, resolution=64)
    _write_checkpoint(ckpt_dir, flame_dir)

    from cap4d_tpu.inference.generate_images import run_generation as jax_run

    j = jax_run(cfg, ref_dir, root / "jax_out", flame_asset_dir=flame_dir, dtype=np.float32)
    t = torch_run(cfg, ref_dir, root / "torch_out", flame_asset_dir=flame_dir,
                  dtype=torch.float32, device="cpu", init_noise=_jax_noise())
    t2 = torch_run(cfg, ref_dir, root / "torch_out_gpd2", flame_asset_dir=flame_dir,
                   dtype=torch.float32, device="cpu", init_noise=_jax_noise(), groups_per_device=2)
    return root, j, t, t2


def test_latents_match_jax(runs):
    _, j, t, _ = runs
    assert t["z_gen"].shape == j["z_gen"].shape == (N_GEN, LAT, LAT, 4)
    assert np.isfinite(t["z_gen"]).all()
    # fp32 through VAE encode, 2 DDIM steps of the UNet and the CFG combine
    np.testing.assert_allclose(t["z_gen"], np.asarray(j["z_gen"]), atol=2e-4, rtol=1e-4)
    diff = np.abs(t["images"].astype(int) - np.asarray(j["images"]).astype(int))
    assert diff.max() <= 1   # uint8 truncation on either side of a boundary


def test_output_layout_matches_jax(runs):
    root, _, _, _ = runs

    def files(out):
        return sorted(str(p.relative_to(out))
                      for p in out.rglob("*") if p.is_file() and p.name != "sampler_checkpoint.pkl")

    assert files(root / "torch_out") == files(root / "jax_out")
    gen = root / "torch_out" / "generated_images"
    assert len(list((gen / "images").glob("*.png"))) == N_GEN
    assert list((gen / "condition_vis").rglob("*.jpg"))
    for name in sorted((root / "jax_out" / "generated_images" / "flame").glob("*.npz")):
        a, b = np.load(name), np.load(gen / "flame" / name.name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)


def test_batched_groups_match_per_group(runs):
    """Two groups in one UNet call of batch 4 against one group a call."""
    _, _, t, t2 = runs
    assert t2["group_steps"] == t["group_steps"]
    # fp32 on the CPU: the batched convolutions and GEMMs round differently
    np.testing.assert_allclose(t2["z_gen"], t["z_gen"], atol=1e-5, rtol=1e-5)


def test_cli_flags_match_jax(monkeypatch):
    """The new flags parse to the same values in both CLIs."""
    from cap4d_torch.inference import generate_images as tgen
    from cap4d_tpu.inference import generate_images as jgen

    got = {}
    for name, mod in (("jax", jgen), ("torch", tgen)):
        monkeypatch.setattr(mod, "run_generation", lambda *a, _n=name, **kw: got.__setitem__(_n, kw))
    argv = ["generate_images", "--config_path", "c.yaml", "--reference_data_path", "ref",
            "--output_path", "out"]
    try:
        for extra in ([], ["--groups_per_device", "4", "--max_dispatch_group_steps", "50",
                           "--detect_anomaly"]):
            for mod in (jgen, tgen):
                monkeypatch.setattr("sys.argv", argv + extra)
                mod.main()
            anomaly = bool(jax.config.jax_debug_nans)
            assert got["torch"]["groups_per_device"] == got["jax"]["groups_per_device"]
            assert got["torch"]["detect_anomaly"] == anomaly == bool(extra)
            jax.config.update("jax_debug_nans", False)
    finally:
        jax.config.update("jax_debug_nans", False)
    assert got["jax"]["max_group_steps_per_dispatch"] == 50
