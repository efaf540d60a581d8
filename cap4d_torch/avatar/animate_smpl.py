"""Full-body SMPL animation CLI (counterpart of
``cap4d_tpu/avatar/animate_smpl.py``).

Reference: animate_smpl.py: drive a fitted SMPL avatar with an animation npz
from ``cap4d_torch.tools.generate_animation`` or the CameraHMR merger, on the
port's pipelined render loop (replays of the captured frame render on the
card, threaded PNG writes) and PLY export. ``--dp_frames``
splits the frames over the ranks of a ``torchrun`` process group as
``cap4d_torch.avatar.animate`` does (0, the default, means every rank). Run
it with ``python -m cap4d_torch.avatar.animate_smpl``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

from cap4d_torch.avatar.animate import frame_ranks, split_frame_loop
from cap4d_torch.avatar.convert_ref import (
    load_reference_avatar_checkpoint,
    restore_reference_checkpoint,
)
from cap4d_torch.avatar.export import PlyWriter
from cap4d_torch.avatar.trainer import AvatarTrainer, search_max_iteration
from cap4d_torch.parallel.mesh import DP, init_dp, local_dp
from cap4d_torch.smpl.scene import load_smpl_dataset
from cap4d_torch.utils.config import load_yaml


def load_trained_smpl_avatar(model_path: Path, smpl_asset_dir, scene, device=None) -> AvatarTrainer:
    """An SMPL trainer built from ``config_dump.yaml`` for ``scene`` (the
    driving animation) with the newest checkpoint installed."""
    config = load_yaml(Path(model_path) / "config_dump.yaml")
    trainer = AvatarTrainer.create_smpl(scene, config["model_params"], config["opt_params"],
                                        smpl_asset_dir=smpl_asset_dir, device=device)
    it, ckpt_path = search_max_iteration(model_path)
    assert ckpt_path is not None, f"no chkpnt*.pth under {model_path}"
    print(f"Loading checkpoint at iteration {it}")
    chkpt, _ = load_reference_avatar_checkpoint(ckpt_path)
    # the animation's bank stays: only betas and base rotation come from the
    # fit (restoring the fit's bank would replay its poses instead)
    restore_reference_checkpoint(trainer, chkpt, with_extras=False)
    return trainer


def render_sequence_smpl(
    model_path: str | Path,
    animation_path: str | Path,
    output_path: str | Path,
    smpl_asset_dir: str | Path = "data/assets/smpl",
    fps: int = 24,
    export_animation: bool = True,
    compress_ply: bool = False,
    n_max_frames: Optional[int] = None,
    dp_frames: int = 0,
    device=None,
    dp: Optional[DP] = None,
    graphs: Optional[bool] = None,
) -> dict:
    """Render the animation's frames, its mp4 and (optionally) the animated
    PLY, the frames split over the first ``dp_frames`` ranks of ``dp`` (0:
    all; None: this process alone); returns the frame count and the render
    loop's seconds (the slowest rank's, and each rank's) and the frame
    graph's counters. Runs on the card unless ``device="cpu"``, its frames
    replays of a captured render unless ``graphs=False``."""
    dp = local_dp(dp, device)
    n_ranks = frame_ranks(dp_frames, dp)
    model_path, output_path = Path(model_path), Path(output_path)
    frame_dir = output_path / "frames"
    frame_dir.mkdir(parents=True, exist_ok=True)
    scene = load_smpl_dataset(None, target_animation_path=str(animation_path))
    trainer = load_trained_smpl_avatar(model_path, smpl_asset_dir, scene, device=dp.device)
    writer = PlyWriter(compress=compress_ply) if export_animation else None
    cams = scene.tgt_cameras[:n_max_frames] if n_max_frames else scene.tgt_cameras
    return split_frame_loop(trainer, cams, output_path, dp, n_ranks, fps, writer=writer,
                            graphs=graphs)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--animation_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--smpl_asset_dir", type=str, default="data/assets/smpl")
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--no_export_animation", action="store_true")
    parser.add_argument("--compress_ply", action="store_true")
    parser.add_argument("--dp_frames", type=int, default=0,
                        help="render the frames over this many ranks, frame i on rank i mod n "
                             "(0 = every rank, 1 = rank 0 alone)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args()
    dp = init_dp(args.device)
    try:
        render_sequence_smpl(args.model_path, args.animation_path, args.output_path,
                             smpl_asset_dir=args.smpl_asset_dir, fps=args.fps,
                             export_animation=not args.no_export_animation,
                             compress_ply=args.compress_ply, dp_frames=args.dp_frames,
                             device=args.device, dp=dp)
    finally:
        dp.close()


if __name__ == "__main__":
    main()
