"""Stage 3's frame render as a graph (``cap4d_torch/avatar/render_graph.py``)
and the pipelined animation loop on the CPU: the static render against
``render_camera`` bit for bit for the FLAME head and the SMPL body, the
frame quantised on the device against the host's quantisation, a pair
budget too small regrowing with the frames unchanged, the loop's files
against the loop the port ran before its pipeline (kept here as the
oracle), the render body scanned for host reads, the graphed control flow
with a stand-in graph, and the static render against ``cap4d_tpu``'s
``render_camera``.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cap4d_torch.avatar import animate as animate_mod
from cap4d_torch.avatar import render_graph
from cap4d_torch.avatar.render_graph import FrameGraph, PoseTable, first_budget
from cap4d_torch.avatar.trainer import AvatarTrainer
from cap4d_torch.ops import gsplat_tiles
from cap4d_torch.ops.cuda_build import CudaKernel
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_torch.utils.config import dump_yaml
from cap4d_torch.utils.png import write_png
from tests.test_avatar_e2e import OPT_PARAMS
from tests.test_torch_avatar_e2e import MODEL_PARAMS, RES, _make_stage1_output
from tests.test_torch_capture import HostReads
from tests.test_torch_fit_dispatch import _compositor_stand_in, one_thread  # noqa: F401 (fixture)
from tests.test_torch_mmdm_training import _ReplayEagerly
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)


def _perturb(tr: AvatarTrainer, seed: int) -> None:
    """Splats off their initial state (positions, anisotropic scales,
    opacities, colours), a deform net and neck rows that move the mesh."""
    gen = torch.Generator().manual_seed(seed)
    g = tr.gauss
    with torch.no_grad():
        g["xyz"].add_(0.03 * torch.randn(g["xyz"].shape, generator=gen))
        g["scaling"].add_(0.4 * torch.randn(g["scaling"].shape, generator=gen))
        g["opacity"].copy_(torch.rand(g["opacity"].shape, generator=gen) * 5 - 2)
        g["features_dc"].copy_(0.5 * torch.randn(g["features_dc"].shape, generator=gen))
        g["features_rest"].copy_(0.1 * torch.randn(g["features_rest"].shape, generator=gen))
        for p in tr.deform_net.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=gen))
        tr.neck_weight.copy_(0.01 * torch.randn(tr.neck_weight.shape, generator=gen))
    tr.active_sh_degree = 1


@pytest.fixture(scope="module")
def avatars(tmp_path_factory):
    """Perturbed small FLAME and SMPL avatars written as checkpoints, a
    5-frame FLAME drive and a 4-frame SMPL wave."""
    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_torch.smpl.scene import load_smpl_dataset
    from tests.test_torch_smpl import MODEL_PARAMS as SMPL_PARAMS
    from tests.test_torch_smpl import _driving

    root = tmp_path_factory.mktemp("render_graph")
    flame_dir = sa.make_asset_dir(root, sphere_radius=0.09)
    smpl_dir = sa.make_smpl_asset_dir(root / "smpl_assets", n_rings=14, n_segments=16)
    data = _make_stage1_output(root, n_frames=2)
    capture = sa.make_smpl_dataset(root, n_views=2, width=RES, height=RES, focal=100.0)
    out = SimpleNamespace(root=root, flame_dir=flame_dir, smpl_dir=smpl_dir, data=data)
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
        tr = make()
        _perturb(tr, 3)
        tr.save_checkpoint(path, 0)
        setattr(out, variant, path)
    out.drv = sa.make_driving_sequence(root, n_frames=5, resolution=RES, fx=500.0, distance=1.2)
    out.wave = _driving(root)
    return out


def _driven(av, variant):
    """(trainer, driving cameras) of the avatar loaded as the CLIs load it."""
    if variant == "flame":
        from cap4d_torch.avatar.scene import load_cap4d_dataset

        scene = load_cap4d_dataset(source_paths=None, target_paths={
            "animation_path": str(av.drv), "cam_trajectory_path": None})
        tr = animate_mod.load_trained_avatar(av.flame, str(av.flame_dir), scene, device="cpu")
    else:
        from cap4d_torch.avatar.animate_smpl import load_trained_smpl_avatar
        from cap4d_torch.smpl.scene import load_smpl_dataset

        scene = load_smpl_dataset(None, target_animation_path=str(av.wave))
        tr = load_trained_smpl_avatar(av.smpl, av.smpl_dir, scene, device="cpu")
    return tr, scene.tgt_cameras


@pytest.mark.parametrize("variant", ["flame", "smpl"])
def test_static_render_equals_render_camera(avatars, one_thread, variant):
    """Each driving frame through the static render (device inputs from the
    pose table, the pair budget, depth on): the float render, alpha and
    depth equal ``render_camera``'s bit for bit, the uint8 frame the host's
    ``np.clip`` · 255 quantisation, the vertices ``mesh_at_timestep``'s,
    and nothing overflowed."""
    tr, cams = _driven(avatars, variant)
    table = PoseTable(cams, tr.device)
    budget = first_budget(tr, cams[0])
    for i, cam in enumerate(cams):
        got = tr.render_frame(table.camera(torch.tensor([i])), cam.width, cam.height, budget,
                              compute_depth=True)
        ref = tr.render_camera(cam, cam.timestep, compute_depth=True, clip=True)
        assert int(got["n_overflow"][0]) == 0
        assert torch.equal(got["render"], ref["render"]), i
        assert torch.equal(got["depth"], ref["depth"]), i
        img = np.clip(ref["render"].numpy(), 0, 1)
        np.testing.assert_array_equal(got["image"].numpy(), (img * 255).astype(np.uint8))
        np.testing.assert_array_equal(got["alpha"].numpy(),
                                      (ref["alpha"].numpy() * 255).astype(np.uint8))
        assert torch.equal(got["verts"], tr.mesh_at_timestep(cam.timestep).verts), i
        assert 0 < got["image"].float().mean() < 255


def todays_loop(trainer, cams, frame_dir: Path, writer=None, save_alpha=False, save_depth=False,
                frames=None, graphs=None) -> float:
    """The oracle: the render loop the port ran before its pipeline, one
    ``render_camera`` at a time, quantised on the host, the PLY's meshes
    from ``mesh_at_timestep``."""
    frames = set(range(len(cams)) if frames is None else frames)
    attrs = None
    if writer is not None:
        attrs = {k: v.cpu().numpy() for k, v in trainer.gauss.items()}
        attrs["binding"] = trainer.aux["binding"].cpu().numpy()
        remesh_faces = trainer.uv.remesh_faces.cpu().numpy()
    for i, cam in enumerate(cams):
        if i in frames:
            out = trainer.render_camera(cam, cam.timestep, compute_depth=save_depth, clip=True)
            img = np.clip(out["render"].cpu().numpy(), 0, 1)
            write_png(frame_dir / f"{i:05d}.png", (img * 255).astype(np.uint8))
            if save_alpha:
                write_png(frame_dir / f"{i:05d}_alpha.png",
                          (out["alpha"].cpu().numpy() * 255).astype(np.uint8))
            if save_depth:
                np.save(frame_dir / f"{i:05d}_depth.npy", out["depth"].cpu().numpy())
        if writer is not None:
            writer.update(trainer.mesh_at_timestep(cam.timestep).verts.cpu().numpy(),
                          remesh_faces, attrs)
    trainer.frame_graphs = None
    return 0.0


def _run(avatars, variant, out: Path, **kw):
    from cap4d_torch.avatar.animate import render_sequence
    from cap4d_torch.avatar.animate_smpl import render_sequence_smpl

    if variant == "flame":
        return render_sequence(avatars.flame, avatars.drv, out, flame_asset_dir=avatars.flame_dir,
                               save_alpha=True, save_depth=True, compress_ply=True, device="cpu",
                               **kw)
    return render_sequence_smpl(avatars.smpl, avatars.wave, out, smpl_asset_dir=avatars.smpl_dir,
                                device="cpu", **kw)


def _same_files(a: Path, b: Path) -> None:
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert any(n.suffix == ".ply" for n in names) and any(n.suffix == ".png" for n in names)
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.fixture(scope="module")
def oracle_runs(avatars):
    """Each variant's files from the oracle loop."""
    mp = pytest.MonkeyPatch()
    mp.setattr(animate_mod, "render_frame_loop", todays_loop)
    try:
        return {v: _run(avatars, v, avatars.root / f"oracle_{v}") for v in ("flame", "smpl")}
    finally:
        mp.undo()


@pytest.mark.parametrize("variant", ["flame", "smpl"])
def test_pipelined_loop_writes_todays_files(avatars, oracle_runs, variant):
    """The pipelined loop (eager on the CPU, eight frames launched ahead)
    writes the oracle loop's PNGs, alpha PNGs, depth arrays and animated
    PLY byte for byte; one budget, no regrowth."""
    out = avatars.root / f"pipelined_{variant}"
    res = _run(avatars, variant, out)
    _same_files(avatars.root / f"oracle_{variant}", out)
    fg = res["frame_graphs"]
    assert fg["graphed"] is False and fg["regrowths"] == [] and fg["rerendered"] == 0
    assert fg["captures"] == 0 and fg["replays"] == 0


@pytest.mark.parametrize("variant,start", [("flame", "tiny"), ("flame", "least"),
                                           ("smpl", "tiny")])
def test_small_budget_regrows_and_frames_are_unchanged(avatars, oracle_runs, monkeypatch,
                                                       variant, start):
    """A first budget that cannot hold the first frame ("tiny": 16
    candidates) or one that holds only the frame that needs the fewest
    ("least", growth to exactly what was needed): frames overflow, the
    budget grows, the frames from there on render again, and every file
    equals the oracle's."""
    tr, cams = _driven(avatars, variant)
    table = PoseTable(cams, tr.device)
    needs = [int(tr.render_frame(table.camera(torch.tensor([i])), c.width, c.height, 1)[
        "n_overflow"][0]) + 1 for i, c in enumerate(cams)]
    assert start == "tiny" or len(set(needs)) > 1, needs
    first = 16 if start == "tiny" else min(needs)
    monkeypatch.setattr(render_graph, "first_budget", lambda trainer, cam: first)
    if start == "least":
        monkeypatch.setattr(render_graph, "next_budget", lambda n: n)
    out = avatars.root / f"regrow_{variant}_{start}"
    res = _run(avatars, variant, out)
    _same_files(avatars.root / f"oracle_{variant}", out)
    fg = res["frame_graphs"]
    assert fg["regrowths"] and fg["regrowths"][0][0] == first and fg["rerendered"] > 0
    assert fg["budget"] >= max(needs)
    if start == "least":
        assert [new for _, new in fg["regrowths"]] == sorted(
            {n for j, n in enumerate(needs) if n > max([first] + needs[:j])})


@pytest.mark.parametrize("variant", ["flame", "smpl"])
def test_render_body_reads_nothing_on_the_host(avatars, monkeypatch, variant):
    """The frame render that the card captures (mesh, deform net, face
    frames, world splats, the far-plane clip, the budgeted pair build,
    quantisation), minus the compositor, calls no operator that reads the
    device on the host or uploads a host array."""
    tr, cams = _driven(avatars, variant)
    fg = FrameGraph(tr, PoseTable(cams, tr.device), range(len(cams)), first_budget(tr, cams[0]),
                    compute_depth=True, clip=True, graphs=False)
    fg.launch(0)                                         # first use: caches
    monkeypatch.setattr(gsplat_tiles, "composite", _compositor_stand_in)
    with HostReads() as scan:
        fg.body()
    assert scan.found == []


def test_graphed_control_flow_with_a_stand_in_graph(avatars, monkeypatch):
    """The graphed frame render on the CPU with a stand-in graph whose replay
    runs the body: the first frame is the warm-up and one capture, the next
    ones replays that add the capture's launches (the static outputs
    rewritten each time), a grown budget captures anew at the frame it
    restarts from, and every frame equals the eager render."""
    monkeypatch.setattr(render_graph, "warm_up", lambda fn: fn())
    k4 = gsplat_tiles.KERNEL_FWD
    monkeypatch.setattr(render_graph, "capture_graph", lambda fn: (
        _ReplayEagerly(fn), {k.name: int(k is k4) for k in CudaKernel.registry}))
    tr, cams = _driven(avatars, "flame")
    table = PoseTable(cams, tr.device)
    budget = first_budget(tr, cams[0])
    eager = FrameGraph(tr, table, range(len(cams)), budget, False, True, graphs=False)
    graphed = FrameGraph(tr, table, range(len(cams)), budget, False, True, graphs=False)
    graphed.graphs = True           # on the CPU, only with the stand-in
    before = k4.launches
    for lane in (0, 1, 2, 3):
        ref, got = eager.launch(lane)["image"].clone(), graphed.launch(lane)["image"]
        assert torch.equal(got, ref), lane
    assert (graphed.captures, graphed.replays) == (1, 3)
    graphed.grow(1)
    assert graphed.regrowths == [(budget, 2 * budget)] or graphed.budget > budget
    for lane in (2, 3, 4):          # restart at lane 2 with the new budget
        ref, got = eager.launch(lane)["image"].clone(), graphed.launch(lane)["image"]
        assert torch.equal(got, ref), lane
    assert (graphed.captures, graphed.replays) == (2, 5)
    assert k4.launches - before == 5
    k4.launches = before
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        FrameGraph(tr, table, [0], budget, False, True, graphs=True)


def test_static_render_matches_jax_render_camera(avatars):
    """A JAX trainer's avatar loaded into the port: the static render of its
    training cameras against ``cap4d_tpu``'s ``render_camera`` (clip on),
    within the render tolerance of test_torch_avatar_e2e.py, and the uint8
    frames within one step on 0.02 % of the values."""
    from cap4d_torch.avatar.convert_ref import (
        load_reference_avatar_checkpoint,
        restore_reference_checkpoint,
    )
    from cap4d_torch.avatar.scene import load_cap4d_dataset
    from cap4d_tpu.avatar.scene import load_cap4d_dataset as jax_dataset
    from tests.test_torch_avatar_e2e import _assert_renders_close, _jax_trainer

    tj = _jax_trainer(avatars.data, avatars.flame_dir, OPT_PARAMS, seed=2)
    (avatars.root / "jax_ckpt").mkdir()
    path = tj.save_checkpoint(avatars.root / "jax_ckpt", 3)
    scene = load_cap4d_dataset([str(avatars.data)])
    tt = AvatarTrainer.create(scene, MODEL_PARAMS, OPT_PARAMS, flame_asset_dir=avatars.flame_dir,
                              device="cpu")
    chkpt, _ = load_reference_avatar_checkpoint(path)
    restore_reference_checkpoint(tt, chkpt)
    cams_t = scene.train_cameras
    table = PoseTable(cams_t, tt.device)
    budget = first_budget(tt, cams_t[0])
    for i, (cam_j, cam_t) in enumerate(zip(jax_dataset([str(avatars.data)]).train_cameras, cams_t)):
        out_j = tj.render_camera(cam_j, cam_j.timestep, clip=True)
        assert int(out_j["n_truncated"]) == 0 and int(out_j["n_truncated_depth"]) == 0
        got = tt.render_frame(table.camera(torch.tensor([i])), cam_t.width, cam_t.height, budget)
        assert int(got["n_overflow"][0]) == 0
        _assert_renders_close(got["render"], out_j["render"])
        ref8 = (np.clip(np.asarray(out_j["render"]), 0, 1) * 255).astype(np.uint8).astype(int)
        step = np.abs(got["image"].numpy().astype(int) - ref8)
        assert step.max() <= 1 and (step > 0).mean() <= 2e-4, (step.max(), (step > 0).sum())
