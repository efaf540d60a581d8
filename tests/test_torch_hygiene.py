"""The port's boundaries: no module of cap4d_torch (nor scripts/torch or
chip_smoke.py) imports JAX, flax, optax, cap4d_tpu, the repository's tools/
or tests/, or the host libraries
the card machine lacks (yaml, cv2, PIL); entry points (stage-1 generation,
the avatar fit and animation, the SMPL fit and animation, MMDM training, the
op-mix benchmark) refuse to run without CUDA unless asked for the CPU; the
kernel wrappers (K1-K7) take their plain versions on CPU tensors, forward
and backward, building and launching nothing."""

import ast
from pathlib import Path

import pytest
import torch
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cap4d_tpu", "tools", "tests", "yaml", "cv2",
             "PIL"}
SOURCES = sorted(str(p.relative_to(REPO)) for p in [*(REPO / "cap4d_torch").rglob("*.py"),
                                                    *(REPO / "scripts" / "torch").glob("*.py")]
                 ) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", SOURCES)
def test_no_forbidden_imports(rel):
    tree = ast.parse((REPO / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{rel}:{node.lineno} imports {name}"


def test_entry_points_refuse_to_run_without_cuda(tmp_path):
    from cap4d_torch.inference.generate_images import run_generation
    from cap4d_torch.mmdm.model import MMDM
    from cap4d_torch.utils.device import resolve_device

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_generation(tmp_path / "missing.yaml", tmp_path, tmp_path / "out")
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        MMDM.from_config({})
    assert resolve_device("cpu") == torch.device("cpu")


def test_avatar_entry_points_refuse_to_run_without_cuda(tmp_path):
    from cap4d_torch.avatar.animate import render_sequence, render_static
    from cap4d_torch.avatar.train import training

    with pytest.raises(RuntimeError, match="CUDA"):
        training([str(tmp_path)], tmp_path / "avatar", {}, {}, [], [])
    assert not (tmp_path / "avatar").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        render_sequence(tmp_path, tmp_path / "fit.npz", tmp_path / "anim")
    with pytest.raises(RuntimeError, match="CUDA"):
        render_static(tmp_path, tmp_path / "fit.npz", tmp_path / "anim")
    assert not (tmp_path / "anim").exists()


def test_training_entry_points_refuse_to_run_without_cuda(tmp_path, monkeypatch):
    from cap4d_torch.mmdm import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.train_mmdm(tmp_path / "missing.yaml", tmp_path / "out")
    monkeypatch.setattr("sys.argv", ["train", "--config_path", str(tmp_path / "missing.yaml"),
                                     "--output_path", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main()
    assert not (tmp_path / "out").exists()


def test_smpl_and_benchmark_entry_points_refuse_to_run_without_cuda(tmp_path, monkeypatch):
    from cap4d_torch.avatar.animate_smpl import render_sequence_smpl
    from cap4d_torch.avatar.train import training
    from cap4d_torch.avatar.train_fullbody import train_fullbody
    from cap4d_torch.avatar.trainer import AvatarTrainer
    from cap4d_torch.tools import bench_ops

    with pytest.raises(RuntimeError, match="CUDA"):
        train_fullbody([str(tmp_path)], tmp_path / "avatar", tmp_path / "missing.yaml")
    with pytest.raises(RuntimeError, match="CUDA"):
        training([str(tmp_path)], tmp_path / "avatar", {}, {}, [], [], variant="smpl")
    assert not (tmp_path / "avatar").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        render_sequence_smpl(tmp_path, tmp_path / "wave.npz", tmp_path / "anim")
    assert not (tmp_path / "anim").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        AvatarTrainer.create_smpl(None, {}, {}, smpl_asset_dir=tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_ops.run_bench(2)
    monkeypatch.setattr("sys.argv", ["bench_ops", "--niter", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_ops.main()
    res = bench_ops.run_bench(1, device="cpu", repeats=1)
    assert list(res) == list(bench_ops.om.CASES)


def test_op_mix_takes_its_plain_version_only_on_cpu_tensors():
    from cap4d_torch.ops import op_mix

    before = op_mix.KERNEL.launches
    x = torch.rand(256, 256) * 0.8 + 0.1
    out = op_mix.op_mix(x, "scan8", 2)
    torch.testing.assert_close(out, op_mix.op_mix_plain(x, "scan8", 2), rtol=0, atol=0)
    op_mix.op_mix_term(x, x, "acc_matmul3")
    assert op_mix.KERNEL.launches == before and op_mix.KERNEL._lib is None


def test_kernel_wrappers_use_plain_versions_on_cpu():
    from cap4d_torch.ops import flash_attention, gsplat_tiles, norms, rasterize

    kernels = (flash_attention.KERNEL, flash_attention.KERNEL_BWD, norms.KERNEL,
               rasterize.KERNEL, gsplat_tiles.KERNEL_FWD, gsplat_tiles.KERNEL_BWD)
    before = [k.launches for k in kernels]
    q = torch.randn(1, 70, 2, 64, requires_grad=True)
    flash_attention.flash_attention(q, q, q).sum().backward()
    x = torch.randn(1, 4, 4, 64, requires_grad=True)
    norms.group_norm_silu(x, torch.ones(64), torch.zeros(64)).sum().backward()
    assert q.grad.abs().sum() > 0 and x.grad.abs().sum() > 0
    verts = torch.rand(1, 3, 3)
    rasterize.rasterize_meshes(verts, torch.tensor([[0, 1, 2]]), (8, 8))
    means = torch.tensor([[0.0, 0.0, 2.0], [0.05, 0.0, 2.5]], requires_grad=True)
    out = gsplat_tiles.rasterize_gaussians(
        means, torch.tensor([[1.0, 0, 0, 0]] * 2), torch.full((2, 3), 0.05),
        torch.tensor([0.8, 0.5]), torch.zeros(2, 1, 3), torch.eye(4),
        torch.tensor([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]]), 32, 32, sh_degree=0)
    out["render"].sum().backward()
    assert float(out["alpha"].max()) > 0.5
    assert [k.launches for k in kernels] == before
    assert all(k._lib is None for k in kernels)  # nothing built or loaded


def test_quality_tools_refuse_to_run_without_cuda(tmp_path):
    from cap4d_torch.tools import fit_default_full, fit_holdout_quality, fit_tesla_quality

    for run in (fit_holdout_quality.run, fit_default_full.run, fit_tesla_quality.run):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(out=tmp_path / "out")
    assert not (tmp_path / "out").exists()
