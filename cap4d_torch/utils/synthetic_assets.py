"""A synthetic CAP4D input tree — FLAME-sized assets, a reference subject, a
generation bank and configs — so stage 1 runs end to end without the
user-downloaded FLAME pkl and MMDM weights.

Draws the same arrays from the same seeds as the JAX package's test helper
(``tests/synthetic_assets.py``), but writes PNGs and YAML with the port's
own writers, so it needs neither cv2 nor yaml.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from cap4d_torch.flame.io import make_synthetic_flame, save_flame_pkl
from cap4d_torch.flame.skinner import generate_uv_half_sphere
from cap4d_torch.utils.config import dump_yaml
from cap4d_torch.utils.png import write_png

N_FLAME_VERTS = 5023


def write_obj(path, verts, faces, uvs=None) -> None:
    """OBJ with one ``vt`` per vertex: ``uvs`` (N, 2), or by default the
    vertices laid out on a regular grid of the UV square."""
    n = len(verts)
    side = int(np.ceil(np.sqrt(n)))
    if uvs is None:
        i = np.arange(n)
        uvs = np.stack([0.04 + 0.92 * (i % side) / side, 0.04 + 0.92 * (i // side) / side], -1)
    lines = [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in verts]
    lines += [f"vt {float(u):.6f} {float(w):.6f}" for u, w in uvs]
    lines += [f"f {f[0]+1}/{f[0]+1} {f[1]+1}/{f[1]+1} {f[2]+1}/{f[2]+1}" for f in faces]
    Path(path).write_text("\n".join(lines) + "\n")


def make_asset_dir(root: Path, seed: int = 0, sphere_radius: float = 0.0) -> Path:
    """``assets/flame`` with synthetic FLAME weights, the conditioning
    template (FLAME verts + the mouth half-sphere, fan faces over both) and
    the avatar template with its deformable-vertex list.

    ``sphere_radius`` > 0 makes the FLAME template a head-sized sphere and
    the avatar template its convex hull with a lat-long UV chart (local
    faces, so bound splats stay a few pixels wide); otherwise the avatar
    template has grid connectivity matching the grid UV layout."""
    flame_dir = Path(root) / "assets" / "flame"
    flame_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    fd = make_synthetic_flame(n_verts=N_FLAME_VERTS, seed=seed, sphere_radius=sphere_radius)
    save_flame_pkl(fd, flame_dir / "flame2023_no_jaw.pkl")
    np.save(flame_dir / "blink_blendshape.npy",
            rng.normal(scale=0.01, size=(N_FLAME_VERTS, 3)).astype(np.float32))
    np.save(flame_dir / "jaw_regressor.npy",
            rng.normal(scale=0.02, size=(65, 3)).astype(np.float32))
    mouth_v, mouth_f = generate_uv_half_sphere()
    verts = np.concatenate([fd["v_template"], mouth_v * 0.02], axis=0)
    faces = np.concatenate([fd["f"], mouth_f + N_FLAME_VERTS], axis=0)
    write_obj(flame_dir / "cap4d_flame_template.obj", verts, faces)
    if sphere_radius > 0:
        from scipy.spatial import ConvexHull

        hull_faces = ConvexHull(fd["v_template"]).simplices.astype(np.int32)
        norm = np.maximum(np.linalg.norm(verts, axis=1), 1e-9)
        u = np.arctan2(verts[:, 1], verts[:, 0]) / (2 * np.pi) + 0.5
        w = np.clip(verts[:, 2] / norm * 0.5 + 0.5, 0.0, 1.0)
        uvs = np.stack([0.04 + 0.92 * u, 0.04 + 0.92 * w], axis=-1)
        du = uvs[hull_faces][:, :, 0]
        seam_ok = (du.max(1) - du.min(1)) < 0.5   # drop faces across the u seam
        write_obj(flame_dir / "cap4d_avatar_template.obj", verts, hull_faces[seam_ok], uvs=uvs)
    else:
        n = len(verts)
        side = int(np.ceil(np.sqrt(n)))
        r, c = np.mgrid[0 : side - 1, 0 : side - 1]
        p00 = r * side + c
        p01, p10 = p00 + side, p00 + 1
        p11 = p01 + 1
        grid_faces = np.concatenate([np.stack([p00, p01, p11], -1).reshape(-1, 3),
                                     np.stack([p00, p11, p10], -1).reshape(-1, 3)])
        grid_faces = grid_faces[(grid_faces < n).all(axis=1)].astype(np.int32)
        write_obj(flame_dir / "cap4d_avatar_template.obj", verts, grid_faces)
    head_ids = np.arange(0, N_FLAME_VERTS, 2)
    np.savetxt(flame_dir / "head_vertices.txt", head_ids, fmt="%d")
    np.savetxt(flame_dir / "deformable_verts.txt", head_ids, fmt="%d")
    return flame_dir


def make_reference_dir(root: Path, resolution: int = 256, n_timesteps: int = 2,
                       seed: int = 1) -> Path:
    """A subject directory: fit.npz + reference_images.json + images/cam0/*.png."""
    rng = np.random.default_rng(seed)
    ref = Path(root) / "subject"
    img_dir = ref / "images" / "cam0"
    img_dir.mkdir(parents=True, exist_ok=True)
    for t in range(n_timesteps):
        img = rng.uniform(0, 255, size=(resolution, resolution, 3)).astype(np.uint8)
        # the JAX helper writes this array with cv2 (BGR order): same pixels
        write_png(img_dir / f"{t:05d}.png", np.ascontiguousarray(img[..., ::-1]))
    extr = np.eye(4, dtype=np.float32)[None]
    extr[0, 2, 3] = 1.5  # camera 1.5 m in front (opencv z forward)
    fit = dict(
        fx=np.full((1, 1), 800.0, np.float32),
        fy=np.full((1, 1), 800.0, np.float32),
        cx=np.full((1, 1), resolution / 2, np.float32),
        cy=np.full((1, 1), resolution / 2, np.float32),
        extr=extr,
        shape=rng.normal(scale=0.3, size=(150,)).astype(np.float32),
        expr=rng.normal(scale=0.3, size=(n_timesteps, 65)).astype(np.float32),
        rot=rng.normal(scale=0.05, size=(n_timesteps, 3)).astype(np.float32),
        tra=np.tile(np.array([[0, 0, 0.0]], np.float32), (n_timesteps, 1)),
        eye_rot=rng.normal(scale=0.05, size=(n_timesteps, 3)).astype(np.float32),
        camera_order=np.array(["cam0"]),
        fps=np.int64(24),
        n_timesteps=np.int64(n_timesteps),
        n_views=np.int64(1),
        resolutions=np.array([[resolution, resolution]], np.int64),
        valid_mask=np.ones((1, n_timesteps), bool),
    )
    np.savez(ref / "fit.npz", **fit)
    (ref / "reference_images.json").write_text(json.dumps([["cam0", 0]]))
    return ref


def make_gen_bank(root: Path, n: int = 16, seed: int = 2) -> Path:
    rng = np.random.default_rng(seed)
    path = Path(root) / "gen_data.npz"
    np.savez(path,
             expr=rng.normal(scale=0.4, size=(n, 65)).astype(np.float32),
             eye_rot=rng.normal(scale=0.1, size=(n, 3)).astype(np.float32))
    return path


def small_model_config(image_size: int = 8, model_channels: int = 32, n_frames: int = 8,
                       resolution: int = 64) -> Dict[str, Any]:
    """The ``model`` section of a small config_dump.yaml in the reference schema."""
    return {
        "target": "cap4d.mmdm.mmdm.MMLDM",
        "params": {
            "linear_start": 0.00085, "linear_end": 0.0120, "timesteps": 1000,
            "n_frames": n_frames, "image_size": image_size, "channels": 4,
            "scale_factor": 0.18215, "shift_schedule": True, "zero_snr_shift": True,
            "sqrt_shift": True, "minus_one_shift": True,
            "unet_config": {
                "target": "cap4d.mmdm.net.mmdm_unet.MMDMUnetModel",
                "params": {
                    "image_size": image_size, "time_steps": n_frames, "temporal_mode": "3d",
                    "in_channels": 4, "out_channels": 4, "model_channels": model_channels,
                    "condition_channels": 50, "attention_resolutions": [4, 2, 1],
                    "num_res_blocks": 1, "channel_mult": [1, 2, 4, 4],
                    "num_head_channels": 16, "use_spatial_transformer": True,
                    "use_linear_in_transformer": True, "transformer_depth": 1,
                    "context_dim": 64, "legacy": False,
                },
            },
            "first_stage_config": {
                "target": "controlnet.ldm.models.autoencoder.AutoencoderKL",
                "params": {
                    "embed_dim": 4,
                    "ddconfig": {
                        "double_z": True, "z_channels": 4, "resolution": resolution,
                        "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 1, 2, 2],
                        "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0,
                    },
                },
            },
            "cond_stage_config": {
                "target": "cap4d.mmdm.conditioning.cap4dcond.CAP4DConditioning",
                "params": {
                    "image_size": image_size, "positional_channels": 42,
                    "positional_multiplier": 1.0, "super_resolution": 2,
                    "use_ray_directions": True, "use_expr_deformation": True,
                    "use_crop_mask": True,
                },
            },
        },
    }


def write_model_config(root: Path, model_section: Optional[Dict[str, Any]] = None) -> Path:
    """``weights/mmdm/config_dump.yaml`` holding ``{"model": model_section}``
    (the small config by default); returns the checkpoint directory."""
    ckpt_dir = Path(root) / "weights" / "mmdm"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    dump_yaml({"model": model_section or small_model_config()}, ckpt_dir / "config_dump.yaml")
    return ckpt_dir


def write_gen_config(root: Path, ckpt_dir: Path, gen_data_path: Path, n_samples: int = 7,
                     n_ddim_steps: int = 2, resolution: int = 64) -> Path:
    """A generation config in the ``configs/generation`` schema."""
    cfg = {
        "n_ddim_steps": n_ddim_steps, "cfg_scale": 2.0, "resolution": resolution,
        "seed": 124, "R_max": 4, "V": 8, "ckpt_path": str(ckpt_dir),
        "generation_data": {
            "data_path": str(gen_data_path), "yaw_range": 55, "pitch_range": 20,
            "expr_factor": 1.0, "n_samples": n_samples,
        },
    }
    path = Path(root) / "gen_config.yaml"
    dump_yaml(cfg, path)
    return path


def make_driving_sequence(root: Path, n_frames: int = 48, resolution: int = 512,
                          seed: int = 9, fx: float = 800.0, distance: float = 1.5) -> Path:
    """A driving ``fit.npz`` (the animation input of stage 3): one camera
    ``distance`` in front of the head, per-frame expression, head and eye
    rotations drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    path = Path(root) / "driving" / "fit.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    extr = np.eye(4, dtype=np.float32)[None]
    extr[0, 2, 3] = distance
    np.savez(path,
             fx=np.full((1, 1), fx, np.float32), fy=np.full((1, 1), fx, np.float32),
             cx=np.full((1, 1), resolution / 2, np.float32),
             cy=np.full((1, 1), resolution / 2, np.float32),
             extr=extr,
             shape=rng.normal(scale=0.3, size=(150,)).astype(np.float32),
             expr=rng.normal(scale=0.3, size=(n_frames, 65)).astype(np.float32),
             rot=rng.normal(scale=0.05, size=(n_frames, 3)).astype(np.float32),
             tra=np.zeros((n_frames, 3), np.float32),
             eye_rot=rng.normal(scale=0.05, size=(n_frames, 3)).astype(np.float32),
             resolutions=np.array([[resolution, resolution]], np.int64),
             n_timesteps=np.int64(n_frames))
    return path
