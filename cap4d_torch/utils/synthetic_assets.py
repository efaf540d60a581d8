"""A synthetic CAP4D input tree — FLAME-sized assets, a reference subject, a
generation bank and configs, SMPL-sized body assets and a full-body capture —
so the pipeline runs end to end without the user-downloaded FLAME and SMPL
pkls and MMDM weights.

Draws the same arrays from the same seeds as the JAX package's test helper
(``tests/synthetic_assets.py``), but writes PNGs and YAML with the port's
own writers, so it needs neither cv2 nor yaml.
"""

from __future__ import annotations

import json
import pickle
import re
import struct
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from cap4d_torch.flame.io import make_synthetic_flame, save_flame_pkl
from cap4d_torch.flame.skinner import generate_uv_half_sphere
from cap4d_torch.smpl.model import SMPL_PARENTS
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


SMPL_JOINTS = np.array([   # rest joint targets (m), y up, facing +z, pelvis at the origin
    [0, 0, 0], [0.09, -0.08, 0], [-0.09, -0.08, 0], [0, 0.1, 0], [0.1, -0.45, 0],
    [-0.1, -0.45, 0], [0, 0.22, 0], [0.1, -0.78, 0], [-0.1, -0.78, 0], [0, 0.3, 0],
    [0.1, -0.83, 0.05], [-0.1, -0.83, 0.05], [0, 0.5, 0], [0.08, 0.42, 0], [-0.08, 0.42, 0],
    [0, 0.62, 0], [0.2, 0.4, 0], [-0.2, 0.4, 0], [0.24, 0.15, 0], [-0.24, 0.15, 0],
    [0.25, -0.05, 0], [-0.25, -0.05, 0], [0.25, -0.12, 0], [-0.25, -0.12, 0]], np.float32)


def make_smpl_asset_dir(root: Path, seed: int = 0, n_rings: int = 82, n_segments: int = 84) -> Path:
    """``assets/smpl`` at SMPL's published sizes: with the defaults 6,890
    vertices and 13,776 faces (a closed genus-0 surface: F = 2V − 4), 24
    joints on SMPL's kintree, 10 betas, 207 pose directions.

    The template is a body-sized (1.7 m, y up, facing +z) surface of
    revolution, ``n_rings`` latitude rings of ``n_segments`` vertices plus
    two poles, with a lat-long UV chart (the seam and the pole fans get their
    own ``vt`` entries, so the chart has no wrapping face). Joints are the
    centroids of the 40 template vertices nearest to targets on a human
    skeleton; skinning weights fall off as exp(−d²/(2·0.06²)) from the
    joints, so a vertex follows its nearest joint and a posed body keeps its
    shape. Blend shapes are small random directions. ``deformable_verts.txt``
    lists every vertex."""
    rng = np.random.default_rng(seed)
    d = Path(root) / "assets" / "smpl"
    d.mkdir(parents=True, exist_ok=True)
    theta = np.linspace(0, np.pi, n_rings + 2)[1:-1]              # ring polar angles
    phi = np.arange(n_segments) * 2 * np.pi / n_segments
    y = 0.85 * np.cos(theta)                                       # 1.7 m tall
    width = (0.07 + 0.2 * np.exp(-((y - 0.25) / 0.3) ** 2) + 0.12 * np.exp(-((y + 0.4) / 0.35) ** 2)
             + 0.04 * np.exp(-((y - 0.65) / 0.12) ** 2))
    s = np.sin(theta)[:, None]
    verts = np.stack([width[:, None] * s * np.cos(phi)[None],
                      np.repeat(y[:, None], n_segments, 1),
                      0.6 * width[:, None] * s * np.sin(phi)[None]], -1).reshape(-1, 3)
    top, bottom = len(verts), len(verts) + 1
    verts = np.concatenate([verts, [[0, 0.85, 0], [0, -0.85, 0]]]).astype(np.float32)
    # faces (vertex ids) and their UV corners (vt ids): the ring grid with a
    # duplicated seam column in the chart, then one pole vt per fan triangle
    ring = lambda r, c: r * n_segments + c % n_segments
    vt_grid = lambda r, c: r * (n_segments + 1) + c
    faces, faces_uv = [], []
    for r in range(n_rings - 1):
        for c in range(n_segments):
            faces += [[ring(r, c), ring(r + 1, c), ring(r + 1, c + 1)],
                      [ring(r, c), ring(r + 1, c + 1), ring(r, c + 1)]]
            faces_uv += [[vt_grid(r, c), vt_grid(r + 1, c), vt_grid(r + 1, c + 1)],
                         [vt_grid(r, c), vt_grid(r + 1, c + 1), vt_grid(r, c + 1)]]
    n_grid_vt = n_rings * (n_segments + 1)
    last = n_rings - 1
    for c in range(n_segments):
        faces += [[top, ring(0, c + 1), ring(0, c)], [bottom, ring(last, c), ring(last, c + 1)]]
        faces_uv += [[n_grid_vt + c, vt_grid(0, c + 1), vt_grid(0, c)],
                     [n_grid_vt + n_segments + c, vt_grid(last, c), vt_grid(last, c + 1)]]
    u_of = lambda c: 0.02 + 0.96 * c / n_segments
    v_of = lambda t: 0.9 - 0.8 * t / np.pi
    uvs = [[u_of(c), v_of(t)] for t in theta for c in range(n_segments + 1)]
    uvs += [[u_of(c + 0.5), v_of(0.0)] for c in range(n_segments)]
    uvs += [[u_of(c + 0.5), v_of(np.pi)] for c in range(n_segments)]
    lines = [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}" for v in verts]
    lines += [f"vt {u:.6f} {w:.6f}" for u, w in uvs]
    lines += [f"f {a+1}/{ta+1} {b+1}/{tb+1} {c+1}/{tc+1}"
              for (a, b, c), (ta, tb, tc) in zip(faces, faces_uv)]
    (d / "smpl_template.obj").write_text("\n".join(lines) + "\n")
    np.savetxt(d / "deformable_verts.txt", np.arange(len(verts)), fmt="%d")

    n = len(verts)
    dist = np.linalg.norm(verts[:, None] - SMPL_JOINTS[None], axis=-1)      # (V, 24)
    jr = np.zeros((24, n), np.float32)
    for j in range(24):
        jr[j, np.argsort(dist[:, j])[:40]] = 1.0 / 40
    w = np.exp(-(dist - dist.min(axis=1, keepdims=True)) ** 2 / (2 * 0.06 ** 2))
    w = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    parents = np.array(SMPL_PARENTS, np.int64)
    smpl = {
        "v_template": verts,
        "shapedirs": rng.normal(scale=0.003, size=(n, 3, 10)).astype(np.float32),
        "posedirs": rng.normal(scale=0.001, size=(n, 3, 207)).astype(np.float32),
        "J_regressor": jr,
        "weights": w,
        "kintree_table": np.stack([parents, np.arange(24)]),
        "f": np.asarray(faces, np.int32),
    }
    with open(d / "SMPL_NEUTRAL.pkl", "wb") as fh:
        pickle.dump(smpl, fh)
    return d


def look_at_extrinsics(yaw: float, distance: float, height: float = 0.0) -> np.ndarray:
    """World → camera (OpenCV: x right, y down, z forward) for a camera at
    ``distance`` from the y axis, ``yaw`` radians around it from +z, looking
    at (0, height, 0)."""
    c = np.array([distance * np.sin(yaw), height, distance * np.cos(yaw)])
    f = np.array([0.0, height, 0.0]) - c
    f /= np.linalg.norm(f)
    down = np.array([0.0, -1.0, 0.0])
    right = np.cross(down, f)
    right /= np.linalg.norm(right)
    down = np.cross(f, right)
    extr = np.eye(4, dtype=np.float32)
    extr[:3, :3] = np.stack([right, down, f])
    extr[:3, 3] = -extr[:3, :3] @ c
    return extr


def make_smpl_dataset(root: Path, n_views: int = 16, width: int = 540, height: int = 960,
                      distance: float = 3.0, focal: float = 1300.0, seed: int = 5) -> Path:
    """A full-body capture in the SMPL reader's layout: ``smpl/*.npz`` (fx,
    fy, cx, cy, R, T, betas, body_pose, global_orient) + ``images/*.png``,
    ``n_views`` cameras evenly around the body at ``distance``, all facing
    it; smooth synthetic images."""
    rng = np.random.default_rng(seed)
    out = Path(root) / "smpl_capture"
    (out / "smpl").mkdir(parents=True, exist_ok=True)
    (out / "images").mkdir(parents=True, exist_ok=True)
    betas = rng.normal(scale=0.3, size=10).astype(np.float32)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    for i in range(n_views):
        extr = look_at_extrinsics(2 * np.pi * i / n_views, distance)
        np.savez(out / "smpl" / f"{i:05d}.npz",
                 betas=betas, body_pose=rng.normal(scale=0.05, size=69).astype(np.float32),
                 global_orient=np.zeros(3, np.float32), R=extr[:3, :3], T=extr[:3, 3],
                 fx=np.float32(focal), fy=np.float32(focal),
                 cx=np.float32(width / 2), cy=np.float32(height / 2))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = np.stack([128 + 100 * np.sin(xx / 37.0 + ph[k]) * np.cos(yy / 53.0 + ph[k])
                        for k in range(3)], -1)
        write_png(out / "images" / f"{i:05d}.png", img.astype(np.uint8))
    return out


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


RASTER_TILE = 16   # K3's screen tile (csrc/rasterize.cu kTile): slivers run along its borders


def _tri_mesh(tris: np.ndarray):
    """(B, F, 3, 3) triangles → verts (B, 3F, 3) float32 and faces (F, 3) int32."""
    B, F = tris.shape[:2]
    return (np.ascontiguousarray(tris.reshape(B, 3 * F, 3), dtype=np.float32),
            np.arange(3 * F, dtype=np.int32).reshape(F, 3))


def raster_edge_cases(height: int, width: int, n_frames: int = 2, n_large: int = 1200,
                      seed: int = 0) -> Dict[str, Any]:
    """Meshes that probe the rasterizer's edge cases at an image size, as
    {name: (verts (n_frames, V, 3) float32 NDC, faces (F, 3) int32)}:

    - ``straddle_z0``: camera-space triangles with vertices on both sides of
      z = 0, projected as x / z (huge coordinates, flipped signs);
    - ``extreme``: ordinary triangles with one vertex, or two of opposite
      signs, moved to ±1e20, ±1e30, ±inf, or a NaN in x or y (never NaN in z
      alone), and triangles whose area overflows while their edge functions
      stay finite (every pixel passes, at z = ±0);
    - ``zero_area``: repeated and exactly collinear vertices;
    - ``slivers``: triangles 1e-7 to 1e-3 wide along screen-tile borders and
      through rows and columns of pixel centres;
    - ``whole``: one triangle covering the whole image;
    - ``ties``: one triangle at z = 0 spanning several tiles, repeated at
      face indices in different chunks of 64 and rounds of 1,024, beside a
      second z = 0 triangle (equal z, ±0), among faces off the image;
    - ``random``: ``n_large`` triangles spanning the image and as many small
      ones, so that tiles keep more faces than a round holds.

    Ordinary faces have z in [-3, -0.5], so the overflowing ones (z = +-0
    wherever they pass) lose to them.
    """
    rng = np.random.default_rng(seed)
    B = n_frames
    cx = (1.0 - (2.0 * np.arange(width, dtype=np.float32) + 1.0) / np.float32(width)).astype(np.float32)
    cy = (1.0 - (2.0 * np.arange(height, dtype=np.float32) + 1.0) / np.float32(height)).astype(np.float32)

    def ordinary(n, lo=-1.2, hi=1.2, size=None):
        t = np.empty((B, n, 3, 3))
        t[..., :2] = rng.uniform(lo, hi, (B, n, 3, 2))
        if size is not None:   # local: within ``size`` of a random centre
            t[..., :2] = rng.uniform(lo, hi, (B, n, 1, 2)) + rng.uniform(-size, size, (B, n, 3, 2))
        t[..., 2] = rng.uniform(-3.0, -0.5, (B, n, 3))   # negative, as in the generation frames
        return t

    cases = {}
    cam = rng.uniform(-0.6, 0.6, (B, 64, 3, 3))
    cam[..., 2] = rng.uniform(-0.4, 0.4, (B, 64, 3))
    cases["straddle_z0"] = _tri_mesh(np.stack(
        [-cam[..., 0] / cam[..., 2], -cam[..., 1] / cam[..., 2], cam[..., 2]], -1))

    values = [1e20, -1e20, 1e30, -1e30, np.inf, -np.inf, np.nan]
    t = ordinary(2 * 2 * len(values) * 3)
    i = 0
    for value in values:
        for axis in (0, 1):
            for k in range(3):
                t[:, i, k, axis] = value                      # one vertex
                t[:, i + 1, k, axis] = value                  # two vertices, opposite signs
                t[:, i + 1, (k + 1) % 3, axis] = -value
                i += 2
    # right triangles with legs of 2a, a ~ 1e19: the area 4a² overflows to inf
    # (1/area = 0) while every edge product, at most 2a(a + 1), stays finite
    a = rng.uniform(0.95e19, 1.15e19, (B, t.shape[1] - i, 1, 1))
    corner = np.array([[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0]])
    flip = rng.choice([-1.0, 1.0], (B, t.shape[1] - i, 1, 2))
    t[:, i:, :, :2] = a * corner * flip
    cases["extreme"] = _tri_mesh(t)

    t = ordinary(32)
    t[:, :16, 1] = t[:, :16, 0]                               # a repeated vertex
    s = rng.uniform(0.1, 0.9, (B, 16))[..., None]
    t[:, 16:, 2, :2] = t[:, 16:, 0, :2] + 2.0 * (t[:, 16:, 1, :2] - t[:, 16:, 0, :2]) * s
    t[:, 16:, 2, 0] = t[:, 16:, 0, 0]                         # collinear on a vertical line
    t[:, 16:, 1, 0] = t[:, 16:, 0, 0]
    cases["zero_area"] = _tri_mesh(t)

    slivers = []
    widths = [1e-7, -1e-6, 1e-5, 1e-3]
    for k in range(1, max(2, width // RASTER_TILE + 1)):
        xb = np.float32(1.0 - 2.0 * RASTER_TILE * k / width)  # between columns 16k - 1 and 16k
        for d in widths:
            slivers.append([[xb, -0.9, 1.0], [xb, 0.8, 1.5], [xb + d, 0.1, 2.0]])
    for k in range(1, max(2, height // RASTER_TILE + 1)):
        yb = np.float32(1.0 - 2.0 * RASTER_TILE * k / height)
        for d in widths:
            slivers.append([[-0.95, yb, 1.0], [0.9, yb, 1.5], [0.2, yb + d, 2.0]])
    for r in range(0, height, max(1, height // 5)):
        for d in widths:
            slivers.append([[-0.7, cy[r], 1.0], [0.95, cy[r], 1.2], [0.1, cy[r] + d, 1.4]])
    for c in range(0, width, max(1, width // 5)):
        for d in widths:
            slivers.append([[cx[c], 0.9, 1.0], [cx[c], -0.85, 1.2], [cx[c] + d, 0.0, 1.4]])
    cases["slivers"] = _tri_mesh(np.tile(np.asarray(slivers)[None], (B, 1, 1, 1)))

    cases["whole"] = _tri_mesh(np.tile(np.array(
        [[[[-4.0, -4.0, 5.0], [4.0, -4.0, 5.0], [0.0, 6.0, 5.0]]]]), (B, 1, 1, 1)))

    t = ordinary(2200, lo=2.5, hi=3.5, size=0.05)             # off the image: empty boxes
    tie = np.array([[-0.8, -0.7, 0.0], [0.75, -0.6, 0.0], [0.1, 0.85, 0.0]])
    for i in (5, 70, 1030, 2100):
        t[:, i] = tie
    t[:, 40] = [[-0.9, 0.9, 0.0], [0.9, 0.6, 0.0], [-0.2, -0.9, 0.0]]
    cases["ties"] = _tri_mesh(t)

    cases["random"] = _tri_mesh(np.concatenate(
        [ordinary(n_large, -1.5, 1.5), ordinary(n_large, size=0.05)], axis=1))
    return cases


def raster_edge_set(height: int, width: int, seed: int = 0):
    """All of ``raster_edge_cases`` as one mesh of two frames a case: in a
    case's own two frames its faces are as drawn, elsewhere every vertex of
    the case sits at (10, 10, 0) (zero area), so no case hides another."""
    cases = list(raster_edge_cases(height, width, seed=seed).values())
    n = len(cases)
    verts, faces, offset = [], [], 0
    for i, (v, f) in enumerate(cases):
        full = np.tile(np.array([10.0, 10.0, 0.0], np.float32), (2 * n, v.shape[1], 1))
        full[2 * i : 2 * i + 2] = v
        verts.append(full)
        faces.append(f + offset)
        offset += v.shape[1]
    return np.concatenate(verts, axis=1), np.concatenate(faces, axis=0)


# ------------------------------------------------------------------ video ----
# An mp4/mov writer and an H.264 stream whose decode is known exactly, for
# the video reader's tests and chip_smoke.py (the card's machine has no
# encoder). Boxes follow ISO/IEC 14496-12; the H.264 syntax is Rec. ITU-T
# H.264's (7.3.2.1 SPS, 7.3.2.2 PPS, 7.3.3 slice header, 7.3.4 slice data).

VIDEO_TIMESCALE, FRAME_TICKS = 12288, 512     # ticks a second and a frame: 24 fps
UNITY_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def visual_sample_entry(fourcc: bytes, width: int, height: int, *children: bytes) -> bytes:
    """A VisualSampleEntry (``avc1``, ``jpeg``, ...) with its child boxes."""
    return _box(fourcc, b"\0" * 6, struct.pack(">H", 1), b"\0" * 16,
                struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0, 1),
                b"\0" * 32, struct.pack(">Hh", 0x18, -1), *children)


def write_mp4(path, samples, entry: bytes, width: int, height: int, sync=None,
              brand: bytes = b"isom", ctts=None, per_chunk: int = 1, co64: bool = False,
              edit_start: int = 0, edits=None) -> None:
    """One video track at 24 fps: ``samples`` (bytes each, in decode order)
    described by the sample entry ``entry``, ``sync`` the sync flags (all
    when None), an edit list that skips nothing (as cv2 writes), or whose
    media time is ``edit_start`` frames (the first sample's composition
    offset, as ffmpeg's muxer writes it for B pictures). ``edits`` replaces
    that edit list: ``(media_time, frames)`` or ``(media_time, frames,
    media_rate)`` edits in frames (``media_time`` -1: an empty edit, a
    delay of ``frames``). ``brand`` b"qt  " makes a QuickTime ``.mov``.
    ``ctts`` the composition offsets in frames; for the demuxer's tests
    ``per_chunk`` samples a chunk (the last chunk takes the rest), ``co64``
    64-bit chunk offsets."""
    n, delta = len(samples), FRAME_TICKS
    duration = n * delta
    ftyp = _box(b"ftyp", brand, struct.pack(">I", 0x200 if brand == b"isom" else 0),
                brand + (b"iso2mp41" if brand == b"isom" else b""))
    sizes = [len(s) for s in samples]
    offsets = np.cumsum([len(ftyp) + (16 if co64 else 8)] + sizes[:-1])[::per_chunk]
    mdat = (_box(b"mdat", *samples) if not co64 else
            struct.pack(">I4sQ", 1, b"mdat", 16 + sum(sizes)) + b"".join(samples))
    stbl = [_full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
            _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))]
    if ctts is not None:
        stbl.append(_full_box(b"ctts", 0, 0, struct.pack(f">I{2 * n}I", n, *[
            v for c in ctts for v in (1, c * delta)])))
    if sync is not None and not all(sync):
        keys = [i + 1 for i, s in enumerate(sync) if s]
        stbl.append(_full_box(b"stss", 0, 0, struct.pack(f">I{len(keys)}I", len(keys), *keys)))
    runs = [(1, per_chunk)] + ([(len(offsets), n - per_chunk * (len(offsets) - 1))]
                               if n % per_chunk else [])
    kind, field = (b"co64", "Q") if co64 else (b"stco", "I")
    chunk_box = _full_box(kind, 0, 0, struct.pack(f">I{len(offsets)}{field}", len(offsets),
                                                  *offsets))
    stbl += [_full_box(b"stsc", 0, 0, struct.pack(f">I{3 * len(runs)}I", len(runs), *[
                 v for first, k in runs for v in (first, k, 1)])),
             _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)), chunk_box]
    minf = _box(b"minf", _full_box(b"vmhd", 0, 1, b"\0" * 8),
                _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                        _full_box(b"url ", 0, 1))),
                _box(b"stbl", *stbl))
    mdia = _box(b"mdia",
                _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, VIDEO_TIMESCALE, duration,
                                                     0x55C4, 0)),
                _full_box(b"hdlr", 0, 0, b"\0" * 4, b"vide", b"\0" * 12, b"VideoHandler\0"),
                minf)
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, duration), b"\0" * 8,
                     struct.pack(">hhhH", 0, 0, 0, 0), UNITY_MATRIX,
                     struct.pack(">II", width << 16, height << 16))
    edts = edit_box([(edit_start, n)] if edits is None else edits, delta)
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, VIDEO_TIMESCALE, duration,
                                                0x10000, 0x100), b"\0" * 10, UNITY_MATRIX,
                     b"\0" * 24, struct.pack(">I", 2))
    moov = _box(b"moov", mvhd, _box(b"trak", tkhd, edts, mdia))
    Path(path).write_bytes(ftyp + mdat + moov)


def edit_box(edits, delta: int) -> bytes:
    """``edts/elst`` of ``(media_time, frames[, media_rate])`` edits in
    frames of ``delta`` ticks (media time -1: an empty edit)."""
    rows = [(round(e[1] * delta), -1 if e[0] < 0 else round(e[0] * delta), e[2] if len(e) > 2 else 1)
            for e in edits]
    return _box(b"edts", _full_box(b"elst", 0, 0, struct.pack(">I", len(rows)), *[
        struct.pack(">IihH", d, t, r, 0) for d, t, r in rows]))


class _Bits:
    """An MSB-first bit writer with Exp-Golomb codes (H.264 9.1)."""

    def __init__(self):
        self.bits: list = []

    def u(self, n: int, v: int) -> "_Bits":
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def ue(self, v: int) -> "_Bits":
        n = (v + 1).bit_length()
        return self.u(n - 1, 0).u(n, v + 1)

    def se(self, v: int) -> "_Bits":
        return self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align(self, bit: int = 0) -> "_Bits":
        while len(self.bits) % 8:
            self.bits.append(bit)
        return self

    def trailing(self) -> "_Bits":
        return self.u(1, 1).align()

    def tobytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


def nal_unit(header: int, rbsp: bytes) -> bytes:
    """A NAL unit: its header byte, then the RBSP with emulation-prevention
    bytes inserted (0x03 after two zero bytes that precede a byte <= 3)."""
    return bytes([header]) + re.sub(b"\x00\x00(?=[\x00-\x03])", b"\x00\x00\x03", rbsp)


def h264_frames(n_frames: int, width: int, height: int, seed: int = 0):
    """``n_frames`` of smooth moving 4:2:0 content in video range (luma
    16..235, chroma 16..240): (Y (h, w), U (h/2, w/2), V) uint8 each."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi, 3)
    y, x = np.mgrid[0:height, 0:width] / max(width, height)
    out = []
    for k in range(n_frames):
        t = 0.35 * k
        luma = 126 + 100 * np.sin(7 * x + 3 * y + t + phase[0]) * np.cos(4 * y - t)
        cb = 128 + 100 * np.sin(5 * x - t + phase[1])[::2, ::2]
        cr = 128 + 100 * np.cos(6 * y + t + phase[2])[::2, ::2]
        out.append((np.clip(np.rint(luma), 16, 235).astype(np.uint8),
                    np.clip(np.rint(cb), 16, 240).astype(np.uint8),
                    np.clip(np.rint(cr), 16, 240).astype(np.uint8)))
    return out


def write_h264_mp4(path, n_frames: int, width: int, height: int, gop: int = 8,
                   seed: int = 0, frames=None, b_frames: int = 0):
    """An H.264 mp4 whose every decoded frame is known exactly.

    Baseline profile, CAVLC, ``pic_order_cnt_type`` 2, no VUI (so BT.601
    limited range, decoders' default). Frame ``k`` with ``k % gop == 0`` is
    an IDR picture made only of ``I_PCM`` macroblocks (the samples as they
    are); every other frame a reference P picture that skips all its
    macroblocks (``mb_skip_run`` = all, motion zero), so it decodes to a copy
    of the IDR before it. ``stss`` lists the IDRs; samples carry 4-byte NAL
    lengths. Width and height must be even; the coded picture is padded to
    whole macroblocks by repeating the last row and column, and cropped
    back. ``frames``, when given, are the IDRs' (Y, U, V) planes in place of
    :func:`h264_frames`'.

    ``b_frames`` > 0 writes Main profile with ``pic_order_cnt_type`` 0 and
    B pictures instead: in each GOP the anchors (the IDR, then every
    ``b_frames + 1``-th frame and the GOP's last) are each a different frame
    coded wholly as I_PCM, and the ``b_frames`` frames between two anchors
    non-reference B pictures made wholly of B_Skip. Spatial direct
    prediction finds no motion anywhere, so each B frame decodes to
    ``(past + future + 1) >> 1`` of its two anchors in Y, U and V. Decode
    order is anchor, then the B pictures before it; the container carries
    the composition offsets, an edit list starting at the first sample's,
    and the VUI the reorder depth 1. ``frames`` are then the anchors'
    planes. Returns the decoded frames in presentation order, (Y, U, V)
    uint8 each."""
    if width % 2 or height % 2 or not 2 <= gop <= 16 or not 0 <= b_frames < gop - 1:
        raise ValueError(f"even width and height, gop 2..16, b_frames below gop - 1 (got "
                         f"{width}x{height}, gop {gop}, b_frames {b_frames})")
    mbw, mbh = -(-width // 16), -(-height // 16)
    n_mbs = mbw * mbh
    profile = 77 if b_frames else 66
    sps = _Bits().u(8, profile).u(8, 0 if b_frames else 0xC0).u(8, 51).ue(0).ue(0)
    if b_frames:
        sps.ue(0).ue(4)           # pic_order_cnt_type 0, 8-bit pic_order_cnt_lsb
    else:
        sps.ue(2)
    sps.ue(2 if b_frames else 1).u(1, 0)
    sps.ue(mbw - 1).ue(mbh - 1).u(1, 1).u(1, 1)
    crop = (mbw * 16 - width) // 2, (mbh * 16 - height) // 2
    sps.u(1, int(any(crop)))
    if any(crop):
        sps.ue(0).ue(crop[0]).ue(0).ue(crop[1])
    if b_frames:
        # a VUI of only the bitstream restriction: reorder depth 1, two frames
        sps.u(1, 1).u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 1)
        sps.u(1, 1).ue(0).ue(0).ue(11).ue(11).ue(1).ue(2)
    else:
        sps.u(1, 0)
    sps = nal_unit(0x67, sps.trailing().tobytes())
    pps = _Bits().ue(0).ue(0).u(1, 0).u(1, 0).ue(0).ue(0).ue(0).u(1, 0).u(2, 0)
    pps = nal_unit(0x68, pps.se(0).se(0).se(0).u(1, 1).u(1, 0).u(1, 0).trailing().tobytes())

    def pcm_body(planes):
        ys, us, vs = (np.pad(p, ((0, mbh * s - p.shape[0]), (0, mbw * s - p.shape[1])),
                             mode="edge") for p, s in zip(planes, (16, 8, 8)))
        mbs = np.empty((n_mbs, 386), np.uint8)
        mbs[:, :2] = (0x0D, 0x00)     # mb_type ue(25) = I_PCM, then 7 alignment bits
        mbs[:, 2:258] = ys.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3).reshape(n_mbs, 256)
        mbs[:, 258:322] = us.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3).reshape(n_mbs, 64)
        mbs[:, 322:] = vs.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3).reshape(n_mbs, 64)
        return mbs

    if not b_frames:
        idrs = frames if frames is not None else h264_frames(-(-n_frames // gop), width, height,
                                                             seed)
        samples, frames = [], []
        for k in range(n_frames):
            if k % gop == 0:
                planes = idrs[k // gop]
                mbs = pcm_body(planes)
                head = _Bits().ue(0).ue(7).ue(0).u(4, 0).ue(k // gop % 65536).u(1, 0).u(1, 0)
                head.se(0).ue(1).ue(25).align()
                rbsp = head.tobytes() + mbs[0, 2:].tobytes() + mbs[1:].tobytes() + b"\x80"
                nal = nal_unit(0x65, rbsp)
            else:
                head = _Bits().ue(0).ue(5).ue(0).u(4, k % gop).u(1, 0).u(1, 0).u(1, 0)
                nal = nal_unit(0x41, head.se(0).ue(1).ue(n_mbs).trailing().tobytes())
            samples.append(struct.pack(">I", len(nal)) + nal)
            frames.append(planes)
        avcc = _box(b"avcC", bytes([1, 66, 0xC0, 51, 0xFF, 0xE1]), struct.pack(">H", len(sps)),
                    sps, bytes([1]), struct.pack(">H", len(pps)), pps)
        write_mp4(path, samples, visual_sample_entry(b"avc1", width, height, avcc), width,
                  height, sync=[k % gop == 0 for k in range(n_frames)])
        return frames

    # anchors by presentation index; each group of B pictures follows its
    # closing anchor in decode order
    anchor = [k % gop % (b_frames + 1) == 0 or k % gop == gop - 1 or k == n_frames - 1
              for k in range(n_frames)]
    n_anchors = sum(anchor)
    pics = frames if frames is not None else h264_frames(n_anchors, width, height, seed)
    decoded, order, a = [None] * n_frames, [], 0
    for k in range(n_frames):
        if anchor[k]:
            decoded[k] = pics[a]
            a += 1
    for k in range(n_frames):
        if not anchor[k]:
            past = max(j for j in range(k) if anchor[j])
            future = min(j for j in range(k, n_frames) if anchor[j])
            decoded[k] = tuple(((p.astype(np.uint16) + f + 1) >> 1).astype(np.uint8)
                               for p, f in zip(decoded[past], decoded[future]))
    prev = 0
    for k in range(n_frames):
        if anchor[k]:
            order += [k] + list(range(prev + 1, k))
            prev = k
    samples, fn, ref_fn = [], 0, 0
    for k in order:
        poc_lsb = 2 * (k % gop)
        if anchor[k]:
            fn = 0 if k % gop == 0 else (ref_fn + 1) % 16
            ref_fn = fn
            head = _Bits().ue(0).ue(7).ue(0).u(4, fn)
            if k % gop == 0:
                head.ue(k // gop % 65536).u(8, poc_lsb).u(1, 0).u(1, 0)
            else:
                head.u(8, poc_lsb).u(1, 0)
            head.se(0).ue(1).ue(25).align()
            mbs = pcm_body(decoded[k])
            rbsp = head.tobytes() + mbs[0, 2:].tobytes() + mbs[1:].tobytes() + b"\x80"
            nal = nal_unit(0x65 if k % gop == 0 else 0x61, rbsp)
        else:
            head = _Bits().ue(0).ue(6).ue(0).u(4, (ref_fn + 1) % 16).u(8, poc_lsb)
            head.u(1, 1).u(1, 0).u(1, 0).u(1, 0)    # spatial direct; no override or modification
            nal = nal_unit(0x01, head.se(0).ue(1).ue(n_mbs).trailing().tobytes())
        samples.append(struct.pack(">I", len(nal)) + nal)
    avcc = _box(b"avcC", bytes([1, 77, 0, 51, 0xFF, 0xE1]), struct.pack(">H", len(sps)), sps,
                bytes([1]), struct.pack(">H", len(pps)), pps)
    ctts = [k + 1 - i for i, k in enumerate(order)]
    write_mp4(path, samples, visual_sample_entry(b"avc1", width, height, avcc), width, height,
              sync=[k % gop == 0 for k in order], ctts=ctts, edit_start=ctts[0])
    return decoded


def write_mjpeg_video(path, frames, quality: int = 90) -> None:
    """A Motion-JPEG video of RGB uint8 frames, encoded by the port's
    runtime: a QuickTime ``jpeg`` sample entry for a ``.mov`` path, else an
    mp4 ``mp4v`` entry whose ``esds`` names JPEG (object type 0x6C), the
    two forms cv2 writes."""
    from cap4d_torch.runtime.loader import encode_jpeg

    path = Path(path)
    tmp = path.with_suffix(".frame.jpg")
    samples = []
    try:
        for rgb in frames:
            encode_jpeg(tmp, rgb, quality)
            samples.append(tmp.read_bytes())
    finally:
        tmp.unlink(missing_ok=True)
    h, w = frames[0].shape[:2]
    if path.suffix == ".mov":
        write_mp4(path, samples, visual_sample_entry(b"jpeg", w, h), w, h, brand=b"qt  ")
        return
    # ES_Descriptor(ES_ID 1, DecoderConfigDescriptor(JPEG, visual), SLConfigDescriptor)
    esds = _full_box(b"esds", 0, 0, bytes([3, 21, 0, 1, 0, 4, 13, 0x6C, 0x11]),
                     b"\0" * 11, bytes([6, 1, 2]))
    write_mp4(path, samples, visual_sample_entry(b"mp4v", w, h, esds), w, h)
