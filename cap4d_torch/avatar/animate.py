"""Stage-3 CLI: animate a fitted avatar with a driving sequence and camera
path (counterpart of ``cap4d_tpu/avatar/animate.py``).

Reference: gaussianavatars/animate.py (config_dump.yaml and the newest
chkpnt, a driving fit.npz and an optional orbit trajectory, per-frame
renders with optional alpha and depth, threaded PNG writes, ffmpeg mp4
assembly, the animated PLY export; the single-frame ``render_static``).
Run it with ``python -m cap4d_torch.avatar.animate``.

``--dp_frames n`` splits the frames over the first n ranks of the process
group (0, the default, means every rank; the JAX package's one frame a
device): frame i is rendered by rank ``i mod n``, and each rank writes its
own frames' files. Rank 0 builds the animated PLY from every frame's mesh
(no render needed), and after a barrier assembles the mp4. Without
``torchrun`` there is one rank. On the card each frame is a replay of the
captured frame render (``avatar/render_graph.py``) with eight frames
launched ahead of the one the host writes, as the JAX package's loop
pipelines them:

  python -m torch.distributed.run --standalone --nproc_per_node N \
      -m cap4d_torch.avatar.animate --model_path ... --animation_path ... --output_path ...
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cap4d_torch.avatar.convert_ref import (
    load_reference_avatar_checkpoint,
    restore_reference_checkpoint,
)
from cap4d_torch.avatar.export import PlyWriter
from cap4d_torch.avatar.scene import load_cap4d_dataset
from cap4d_torch.avatar.trainer import AvatarTrainer, search_max_iteration
from cap4d_torch.parallel.mesh import DP, barrier, dp_mesh, gather_object, init_dp, local_dp
from cap4d_torch.utils.config import load_yaml
from cap4d_torch.utils.device import resolve_device
from cap4d_torch.utils.png import write_png


def frames_to_mp4(frame_dir: Path, out_path: Path, fps: int = 24) -> None:
    """ffmpeg frames → mp4 (animate.py:55-74); skipped with a warning when
    ffmpeg is absent or fails."""
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
           "-i", str(frame_dir / "*.png"), "-c:v", "libx264", "-pix_fmt", "yuv420p",
           str(out_path)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        print(f"Wrote {out_path}")
    except (FileNotFoundError, subprocess.CalledProcessError) as e:
        print(f"WARNING: ffmpeg failed/unavailable ({e}); frames left in {frame_dir}")


def load_trained_avatar(model_path: Path, flame_asset_dir: str, scene, device=None) -> AvatarTrainer:
    """A trainer built from ``config_dump.yaml`` for ``scene`` (the driving
    sequence) with the newest checkpoint (written by the reference, the JAX
    package or the port) installed."""
    config = load_yaml(Path(model_path) / "config_dump.yaml")
    trainer = AvatarTrainer.create(scene, config["model_params"], config["opt_params"],
                                   flame_asset_dir=flame_asset_dir, device=device)
    it, ckpt_path = search_max_iteration(model_path)
    assert ckpt_path is not None, f"no chkpnt*.pth under {model_path}"
    print(f"Loading checkpoint at iteration {it}")
    chkpt, _ = load_reference_avatar_checkpoint(ckpt_path)
    # the driving sequence's bank stays: only shape and base rotation come
    # from the fit (the JAX package also loads the fit's bank and neck rows,
    # which replays the fit's expressions and clamps frames past its length)
    restore_reference_checkpoint(trainer, chkpt, with_extras=False)
    return trainer


# frames launched ahead of the one the host consumes (the JAX loop's PIPELINE)
PIPELINE = 8


class _Ring:
    """``PIPELINE`` sets of host buffers that a frame's outputs are copied
    into (pinned on the card, ``non_blocking``), each with the CUDA event
    behind its copies and the writes that still read it."""

    def __init__(self, device: torch.device, n: int = PIPELINE):
        self.cuda = device.type == "cuda"
        self.slots: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * n
        self.writes: List[list] = [[] for _ in range(n)]

    def fill(self, s: int, outs: Dict[str, torch.Tensor]) -> None:
        """Copy ``outs`` into slot ``s`` once the writes reading it are done."""
        for f in self.writes[s]:
            f.result()
        self.writes[s] = []
        slot = self.slots[s]
        for k, v in outs.items():
            if k not in slot or slot[k].shape != v.shape or slot[k].dtype != v.dtype:
                slot[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=self.cuda)
            slot[k].copy_(v, non_blocking=True)
        if self.cuda:
            self.events[s] = torch.cuda.Event()
            self.events[s].record()

    def read(self, s: int) -> Dict[str, np.ndarray]:
        """Slot ``s`` on the host, once its copies are done."""
        if self.events[s] is not None:
            self.events[s].synchronize()
        return {k: v.numpy() for k, v in self.slots[s].items()}


def render_frame_loop(trainer: AvatarTrainer, cams, frame_dir: Path, writer=None,
                      save_alpha: bool = False, save_depth: bool = False,
                      frames: Optional[Sequence[int]] = None,
                      graphs: Optional[bool] = None) -> float:
    """Render the cameras ``frames`` (all when None) in turn; PNG and npy
    writes run on two threads (animate.py:127-164). ``writer`` takes every
    camera's mesh: a rendered frame's own posed vertices, the others'
    from ``mesh_at_timestep``. Returns the loop's wall seconds; the frame
    graph's counters are left in ``trainer.frame_graphs``.

    The frames go through :class:`render_graph.FrameGraph` (``graphs``,
    default on the card: replays of a captured render; False: the same
    render eagerly) with ``PIPELINE`` frames launched ahead of the one the
    host consumes, as the JAX package's loop keeps them. Each frame's
    outputs are copied into a ring of host buffers behind a CUDA event; the
    host consumes frame i once its event completes. A frame whose candidates
    overflowed the pair budget (started at the first frame's count) grows
    it, and the frames from that one on are rendered again (the in-flight
    ones dropped): no frame drops a pair, so each equals
    :meth:`AvatarTrainer.render_camera`'s render."""
    from cap4d_torch.avatar.render_graph import FrameGraph, PoseTable, first_budget

    t0 = time.perf_counter()
    mine = sorted(range(len(cams)) if frames is None else frames)
    if graphs is None:
        graphs = trainer.device.type == "cuda"
    attrs = None
    if writer is not None:
        # gaussian attributes are constant across the sequence: fetch once
        attrs = {k: v.cpu().numpy() for k, v in trainer.gauss.items()}
        attrs["binding"] = trainer.aux["binding"].cpu().numpy()
        remesh_faces = trainer.uv.remesh_faces.cpu().numpy()
    fg = None
    if mine:
        fg = FrameGraph(trainer, PoseTable(cams, trainer.device), mine,
                        first_budget(trainer, cams[mine[0]]), save_depth, True, graphs)
    trainer.frame_graphs = fg
    fed = 0     # frames whose mesh the writer has

    def feed(upto: int) -> None:
        nonlocal fed
        while writer is not None and fed < upto:
            cam = cams[fed]
            writer.update(trainer.mesh_at_timestep(cam.timestep).verts.cpu().numpy(),
                          remesh_faces, attrs)
            fed += 1

    ring = _Ring(trainer.device)
    outputs = ["image", "n_overflow"] + ["verts"] * (writer is not None) \
        + ["alpha"] * save_alpha + ["depth"] * save_depth
    inflight: deque = deque()
    launched = 0        # frames launched, which picks the ring slot
    lane = 0
    with ThreadPoolExecutor(max_workers=2) as io_pool:
        try:
            while lane < len(mine) or inflight:
                while lane < len(mine) and len(inflight) < PIPELINE:
                    s = launched % PIPELINE
                    out = fg.launch(lane)
                    ring.fill(s, {k: out[k] for k in outputs})
                    inflight.append((lane, s))
                    launched += 1
                    lane += 1
                j, s = inflight.popleft()
                got = ring.read(s)
                overflow = int(got["n_overflow"][0])
                if overflow > 0:
                    fg.grow(overflow)
                    print(f"[frame {mine[j]}] {overflow} candidates past the pair budget: "
                          f"budget raised to {fg.budget}, re-rendering")
                    fg.rerendered += len(inflight) + 1
                    inflight.clear()
                    lane = j
                    continue
                i = mine[j]
                w = ring.writes[s]
                w.append(io_pool.submit(write_png, frame_dir / f"{i:05d}.png", got["image"]))
                if save_alpha:
                    w.append(io_pool.submit(write_png, frame_dir / f"{i:05d}_alpha.png",
                                            got["alpha"]))
                if save_depth:
                    w.append(io_pool.submit(np.save, frame_dir / f"{i:05d}_depth.npy",
                                            got["depth"]))
                if writer is not None:
                    feed(i)
                    writer.update(got["verts"].copy(), remesh_faces, attrs)
                    fed = i + 1
                if (i + 1) % 10 == 0:
                    print(f"rendered {i + 1}/{len(cams)} frames")
            feed(len(cams))
        finally:
            if fg is not None:
                fg.close()
        for f in (f for w in ring.writes for f in w):
            f.result()   # surface any write error (earlier ones surfaced in fill)
    return time.perf_counter() - t0


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic convolution engines inside the block: its
    default ones vary the deform net's output by an ulp between calls on the
    card, which the animated PLY's raw base vertices would show."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def frame_ranks(dp_frames: int, dp: DP) -> int:
    """How many ranks render frames: ``dp_frames``, or every rank for 0;
    raises past the world."""
    if not 0 <= dp_frames <= dp.world:
        raise ValueError(f"dp_frames must lie in [0, {dp.world}] (0: every rank), got {dp_frames}")
    return len(dp_mesh(dp_frames or None, dp))


def split_frame_loop(trainer: AvatarTrainer, cams, output_path: Path, dp: DP, n: int, fps: int,
                     writer=None, **render_kw) -> dict:
    """The frames of ``cams`` split over the first ``n`` ranks, frame i on
    rank ``i mod n``; rank 0 feeds ``writer`` every frame's mesh, then,
    after a barrier, writes the PLY and the mp4. Every frame's mesh, and so
    the PLY, has the same bits in any run (``deterministic_convs``). Returns
    the frame count, the slowest rank's render seconds and each rank's, and
    this rank's frame graph counters ("frame_graphs", None without frames)."""
    frame_dir = output_path / "frames"
    mine = range(dp.rank, len(cams), n) if dp.rank < n else range(0)
    with deterministic_convs():
        render_s = render_frame_loop(trainer, cams, frame_dir, frames=mine,
                                     writer=writer if dp.rank == 0 else None, **render_kw)
    rank_s = gather_object(render_s, dp)
    barrier(dp)
    if dp.rank == 0:
        if writer is not None:
            writer.save_ply(output_path / "exported_animation.ply")
            print(f"Wrote {output_path / 'exported_animation.ply'}")
        frames_to_mp4(frame_dir, output_path / "renders.mp4", fps)
    fg = trainer.frame_graphs
    return {"frames": len(cams), "render_s": max(rank_s), "rank_render_s": rank_s,
            "frame_graphs": fg.counters() if fg is not None else None}


def render_sequence(
    model_path: str | Path,
    animation_path: str | Path,
    output_path: str | Path,
    cam_trajectory_path: Optional[str | Path] = None,
    flame_asset_dir: str = "data/assets/flame",
    fps: int = 24,
    save_alpha: bool = False,
    save_depth: bool = False,
    export_animation: bool = True,
    compress_ply: bool = False,
    n_max_frames: Optional[int] = None,
    device=None,
    dp_frames: int = 0,
    dp: Optional[DP] = None,
    graphs: Optional[bool] = None,
) -> dict:
    """Drive the avatar through a target sequence (animate.py:77-171) with
    its frames split over the first ``dp_frames`` ranks of ``dp`` (module
    docstring; None: this process alone); returns the frame count, the
    render loop's seconds (the slowest rank's, and each rank's) and the
    frame graph's counters. Runs on the card unless ``device="cpu"``, its
    frames replays of a captured render unless ``graphs=False``."""
    dp = local_dp(dp, device)
    n_ranks = frame_ranks(dp_frames, dp)
    output_path = Path(output_path)
    frame_dir = output_path / "frames"
    frame_dir.mkdir(parents=True, exist_ok=True)
    scene = load_cap4d_dataset(source_paths=None, target_paths={
        "animation_path": str(animation_path),
        "cam_trajectory_path": str(cam_trajectory_path) if cam_trajectory_path else None})
    trainer = load_trained_avatar(Path(model_path), flame_asset_dir, scene, device=dp.device)
    writer = PlyWriter(compress=compress_ply) if export_animation else None
    cams = scene.tgt_cameras[:n_max_frames] if n_max_frames else scene.tgt_cameras
    return split_frame_loop(trainer, cams, output_path, dp, n_ranks, fps, writer=writer,
                            save_alpha=save_alpha, save_depth=save_depth, graphs=graphs)


def render_static(model_path: str | Path, animation_path: str | Path, output_path: str | Path,
                  timestep: int = 0, flame_asset_dir: str = "data/assets/flame",
                  device=None) -> Path:
    """Single-frame render (animate.py:174-222)."""
    device = resolve_device(device)
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    scene = load_cap4d_dataset(source_paths=None, target_paths={
        "animation_path": str(animation_path), "cam_trajectory_path": None})
    trainer = load_trained_avatar(Path(model_path), flame_asset_dir, scene, device=device)
    cam = scene.tgt_cameras[timestep]
    img = np.clip(trainer.render_camera(cam, cam.timestep, clip=True)["render"].cpu().numpy(), 0, 1)
    path = output_path / f"static_{timestep:05d}.png"
    write_png(path, (img * 255).astype(np.uint8))
    print(f"Wrote {path}")
    return path


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--animation_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--cam_trajectory_path", type=str, default=None)
    parser.add_argument("--flame_asset_dir", type=str, default="data/assets/flame")
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--save_alpha", action="store_true")
    parser.add_argument("--save_depth", action="store_true")
    parser.add_argument("--no_export_animation", action="store_true")
    parser.add_argument("--compress_ply", action="store_true")
    parser.add_argument("--static", type=int, default=None,
                        help="render a single frame at this timestep")
    parser.add_argument("--dp_frames", type=int, default=0,
                        help="render the frames over this many ranks, frame i on rank i mod n "
                             "(0 = every rank, 1 = rank 0 alone)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args()
    if args.static is not None:
        render_static(args.model_path, args.animation_path, args.output_path,
                      timestep=args.static, flame_asset_dir=args.flame_asset_dir,
                      device=args.device)
        return
    dp = init_dp(args.device)
    try:
        render_sequence(args.model_path, args.animation_path, args.output_path,
                        cam_trajectory_path=args.cam_trajectory_path,
                        flame_asset_dir=args.flame_asset_dir, fps=args.fps,
                        save_alpha=args.save_alpha, save_depth=args.save_depth,
                        export_animation=not args.no_export_animation,
                        compress_ply=args.compress_ply, device=args.device,
                        dp_frames=args.dp_frames, dp=dp)
    finally:
        dp.close()


if __name__ == "__main__":
    main()
