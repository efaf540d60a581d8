"""The port's quality tools and LPIPS converter on the CPU: convert_lpips
against cap4d_tpu's converter (key for key, and the LPIPS value the weights
give), and each fit tool at a tiny size, its quality.json carrying the keys
of the JAX tool's."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_torch.tools import convert_lpips as tconv
from cap4d_torch.tools import fit_default_full, fit_holdout_quality, fit_tesla_quality
from cap4d_torch.utils.config import dump_yaml
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
TINY_MODEL = dict(n_unet_layers=5, n_points_per_triangle=1, use_lower_jaw=False,
                  static_neck=False, gaussian_init_type="scaled", use_expr_mask=True,
                  uv_resolution=32, n_gaussians_init=400, sh_degree=1)


@pytest.mark.parametrize("layout", ["raw", "plain"])
def test_convert_lpips_matches_jax(tmp_path, layout):
    from cap4d_torch.avatar.lpips import load_lpips as t_load
    from cap4d_tpu.avatar.lpips import convert_torch_lpips, save_lpips_npz
    from cap4d_tpu.avatar.lpips import load_lpips as j_load

    vgg, lin = tconv.synthetic_lpips_states(seed=3)
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, tmp_path / "vgg16.pth")
    if layout == "plain":   # lin{k}.weight under a lins. prefix
        lin_keys = {f"lins.lin{k}.weight": lin[f"lin{k}.model.1.weight"] for k in range(5)}
    else:                   # richzhang's raw lin{k}.model.1.weight
        lin_keys = lin
    torch.save({k: torch.from_numpy(v) for k, v in lin_keys.items()}, tmp_path / "vgg.pth")

    out = tmp_path / "w" / "lpips_vgg.npz"
    tconv.main(["--vgg", str(tmp_path / "vgg16.pth"), "--linear", str(tmp_path / "vgg.pth"),
                "--out", str(out)])
    ref = tmp_path / "ref.npz"
    save_lpips_npz(convert_torch_lpips(vgg, lin), ref)
    a, b = np.load(out), np.load(ref)
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 31
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    rng = np.random.default_rng(2)
    img1 = rng.uniform(0, 1, size=(32, 32, 3)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(scale=0.1, size=img1.shape), 0, 1).astype(np.float32)
    ours = float(t_load(out)(torch.from_numpy(img1), torch.from_numpy(img2)))
    theirs = float(j_load(ref)(jnp.asarray(img1), jnp.asarray(img2)))
    assert ours > 0
    assert abs(ours - theirs) <= 1e-5 * max(1.0, abs(theirs)), (ours, theirs)


def test_convert_lpips_without_vgg_needs_torchvision(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_torchvision(name, *a, **kw):
        if name.startswith("torchvision"):
            raise ImportError("No module named 'torchvision'")
        return real_import(name, *a, **kw)

    _, lin = tconv.synthetic_lpips_states()
    torch.save({k: torch.from_numpy(v) for k, v in lin.items()}, tmp_path / "vgg.pth")
    monkeypatch.setattr(builtins, "__import__", no_torchvision)
    with pytest.raises(SystemExit, match="pass --vgg"):
        tconv.main(["--linear", str(tmp_path / "vgg.pth"), "--out", str(tmp_path / "o.npz")])


def _jax_keys(rel):
    return set(json.loads((REPO / rel).read_text()))


def test_fit_holdout_quality_cpu(tmp_path, monkeypatch):
    """2 iterations at 64² with a small avatar; the same scene, split and
    result schema as the JAX tool's examples_work/holdout/quality.json."""
    monkeypatch.setattr(fit_holdout_quality, "RES", 64)
    monkeypatch.setattr(fit_holdout_quality, "MODEL_PARAMS", TINY_MODEL)
    res = fit_holdout_quality.run(iterations=2, out=tmp_path / "holdout", device="cpu")
    written = json.loads((tmp_path / "holdout" / "quality.json").read_text())
    assert _jax_keys("examples_work/holdout/quality.json") <= set(written)
    assert written == json.loads(json.dumps(res))
    assert len(written["holdout_per_view"]["psnr"]) == fit_holdout_quality.N_HELD_OUT
    assert all(np.isfinite(v) for v in written["holdout"].values())
    assert len(list((tmp_path / "holdout").glob("holdout_*.png"))) == 3


def test_fit_default_full_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(fit_default_full, "RES", 64)
    from cap4d_torch.utils.config import load_yaml

    cfg = load_yaml(REPO / "configs" / "avatar" / "default.yaml")
    cfg["model_params"] = dict(cfg["model_params"], **TINY_MODEL)
    cfg["opt_params"]["iterations"] = 20
    dump_yaml(cfg, tmp_path / "tiny.yaml")
    fit_default_full.run(views=4, out=tmp_path / "fit", config=str(tmp_path / "tiny.yaml"),
                         device="cpu")
    written = json.loads((tmp_path / "fit" / "quality.json").read_text())
    assert _jax_keys("examples_work/fit_default/quality.json") <= set(written)
    assert written["steady_window"][1] == 20 and written["it_per_sec_wall"] > 0


def test_fit_tesla_quality_cpu(tmp_path, monkeypatch):
    """The in-repository tesla photo, 2 iterations with a small avatar."""
    from cap4d_torch.utils import config

    real = config.load_yaml

    def small(path):
        cfg = real(path)
        cfg["model_params"] = dict(cfg["model_params"], **TINY_MODEL)
        return cfg

    monkeypatch.setattr(config, "load_yaml", small)
    fit_tesla_quality.run(out=tmp_path / "tesla", iterations=2, device="cpu")
    written = json.loads((tmp_path / "tesla" / "quality.json").read_text())
    assert _jax_keys("examples_work/tesla/quality.json") <= set(written)
    assert (tmp_path / "tesla" / "avatar" / "final_render_000.png").exists()
    assert np.isfinite(written["psnr"])


def _script_commands():
    """(script, argv) of every ``python -m cap4d_torch...`` line in scripts/torch."""
    import re
    import shlex

    out = []
    for sh in sorted((REPO / "scripts" / "torch").glob("*.sh")):
        text = sh.read_text().replace("\\\n", " ")
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("python -m "):
                line = re.sub(r"\$\{?\w+(:[^}]*)?\}?", "1", line)
                out.append((sh.name, shlex.split(line)[2:]))
    return out


def test_scripts_parse_with_the_port_clis(monkeypatch):
    """Every command of scripts/torch/*.sh names a cap4d_torch module whose
    CLI accepts its flags (parsed, not run)."""
    import argparse
    import importlib

    class Parsed(Exception):
        pass

    real = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, args=None, namespace=None):
        real(self, args, namespace)
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_then_stop)
    commands = _script_commands()
    assert len(commands) == 18
    for script, (module, *argv) in commands:
        assert module.startswith("cap4d_torch."), (script, module)
        monkeypatch.setattr("sys.argv", [module, *argv])
        with pytest.raises(Parsed):
            importlib.import_module(module).main()
