"""Avatar export: standard-3DGS PLY checkpoints + the animated multi-element
PLY consumed by the Brush web viewer (counterpart of
``cap4d_tpu/avatar/export.py``).

Reference parity:
  gaussianavatars/utils/export_utils.py (PlyWriter / save_ply: faces,
    base_vertex, local splats + SH + binding, per-frame vertex deltas with
    optional uint8 quantization + per-frame min/max meta elements)
  gaussianavatars/scene/gaussian_model.py:255-334 (save_ply/load_ply with the
    extra binding_0 attribute)
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from cap4d_torch.utils.plyio import read_ply, structured, write_ply


def save_gaussian_ply(
    path: str | Path,
    xyz: np.ndarray,            # (N, 3) raw local positions
    features_dc: np.ndarray,    # (N, 1, 3)
    features_rest: np.ndarray,  # (N, K-1, 3)
    opacity: np.ndarray,        # (N, 1) raw logits
    scaling: np.ndarray,        # (N, 3) raw log scales
    rotation: np.ndarray,       # (N, 4) raw wxyz
    binding: Optional[np.ndarray] = None,  # (N,)
) -> None:
    """Standard 3DGS PLY with optional binding_0 (gaussian_model.py:255-277).

    SH channel layout matches the ecosystem: (n, sh, rgb) → f_dc/f_rest columns
    ordered (rgb, sh)."""
    cols: Dict[str, np.ndarray] = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(len(xyz), np.float32),
        "ny": np.zeros(len(xyz), np.float32),
        "nz": np.zeros(len(xyz), np.float32),
    }
    f_dc = np.transpose(features_dc, (0, 2, 1)).reshape(len(xyz), -1)
    f_rest = np.transpose(features_rest, (0, 2, 1)).reshape(len(xyz), -1)
    for j in range(f_dc.shape[1]):
        cols[f"f_dc_{j}"] = f_dc[:, j]
    for j in range(f_rest.shape[1]):
        cols[f"f_rest_{j}"] = f_rest[:, j]
    cols["opacity"] = opacity[:, 0]
    for j in range(scaling.shape[1]):
        cols[f"scale_{j}"] = scaling[:, j]
    for j in range(rotation.shape[1]):
        cols[f"rot_{j}"] = rotation[:, j]
    if binding is not None:
        cols["binding_0"] = binding.astype(np.float32)
    write_ply(path, [("vertex", structured(cols))])


def load_gaussian_ply(path: str | Path, max_sh_degree: int = 3) -> Dict[str, np.ndarray]:
    """Inverse of save_gaussian_ply (gaussian_model.py:284-334)."""
    v = read_ply(path)["vertex"]
    names = v.dtype.names
    n = len(v)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1).reshape(n, 3, 1)
    rest_names = sorted((x for x in names if x.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    n_rest = len(rest_names) // 3
    f_rest = np.stack([v[x] for x in rest_names], axis=1).reshape(n, 3, n_rest)
    scale_names = sorted((x for x in names if x.startswith("scale_")),
                         key=lambda s: int(s.split("_")[-1]))
    rot_names = sorted((x for x in names if x.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    out = {
        "xyz": xyz,
        "features_dc": np.transpose(f_dc, (0, 2, 1)),
        "features_rest": np.transpose(f_rest, (0, 2, 1)),
        "opacity": v["opacity"][:, None],
        "scaling": np.stack([v[x] for x in scale_names], axis=1),
        "rotation": np.stack([v[x] for x in rot_names], axis=1),
    }
    if "binding_0" in names:
        out["binding"] = v["binding_0"].astype(np.int32)
    return out


def _normalize(prop: np.ndarray):
    lo = prop.min(axis=0, keepdims=True)
    hi = prop.max(axis=0, keepdims=True)
    return (prop - lo) / np.maximum(hi - lo, 1e-10), lo[0], hi[0]


class PlyWriter:
    """Accumulates per-frame remeshed vertices and writes the animated-avatar
    PLY (export_utils.py:15-58). `update` takes the deformed remesh verts of
    one frame; gaussian attributes + faces are captured on the first call."""

    def __init__(self, compress: bool = False):
        self.compress = compress
        self.faces: Optional[np.ndarray] = None
        self.attributes: Optional[Dict[str, np.ndarray]] = None
        self.vert_list: List[np.ndarray] = []

    def update(self, verts: np.ndarray, faces: np.ndarray,
               gaussian_attributes: Dict[str, np.ndarray]) -> None:
        if self.faces is None:
            print("Storing Gaussian attributes and faces for PLY export.")
            self.faces = np.asarray(faces)
            self.attributes = {k: np.asarray(v) for k, v in gaussian_attributes.items()}
        self.vert_list.append(np.asarray(verts))

    def save_ply(self, path: str | Path) -> None:
        a = self.attributes
        save_animated_ply(
            path, a["xyz"], a["scaling"], a["rotation"], a["features_dc"],
            a["features_rest"], a["opacity"], a["binding"], self.faces,
            self.vert_list, quantize_vertex_offsets=self.compress,
        )


def save_animated_ply(
    path: str | Path,
    xyz_local: np.ndarray,
    log_scale_local: np.ndarray,
    rotation_local: np.ndarray,
    f_dc: np.ndarray,           # (N, 1, 3)
    f_rest: np.ndarray,         # (N, K-1, 3)
    raw_opacities: np.ndarray,  # (N, 1)
    binding: np.ndarray,        # (N,)
    faces: np.ndarray,          # (F, 3)
    vertices_list: List[np.ndarray],
    quantize_vertex_offsets: bool = True,
) -> None:
    """Multi-element PLY: faces, base_vertex, vertex (splats), and per-frame
    delta_vertex_{i} (+ meta min/max) — export_utils.py:77-215."""
    assert len(vertices_list) > 0
    init_verts = vertices_list[0]
    elements = []

    elements.append(("faces", structured(
        {"index_0": faces[:, 0], "index_1": faces[:, 1], "index_2": faces[:, 2]},
        "u4")))
    elements.append(("base_vertex", structured(
        {"x": init_verts[:, 0], "y": init_verts[:, 1], "z": init_verts[:, 2]})))

    n = len(xyz_local)
    # (n, sh, rgb) → (rgb, sh) flattening (export_utils.py:153-154)
    dc = np.transpose(f_dc, (0, 2, 1)).reshape(n, -1)
    rest = np.transpose(f_rest, (0, 2, 1)).reshape(n, -1)
    cols = {"x": xyz_local[:, 0], "y": xyz_local[:, 1], "z": xyz_local[:, 2]}
    for j in range(dc.shape[1]):
        cols[f"f_dc_{j}"] = dc[:, j]
    for j in range(rest.shape[1]):
        cols[f"f_rest_{j}"] = rest[:, j]
    cols["opacity"] = raw_opacities[:, 0]
    for j in range(log_scale_local.shape[1]):
        cols[f"scale_{j}"] = log_scale_local[:, j]
    for j in range(rotation_local.shape[1]):
        cols[f"rot_{j}"] = rotation_local[:, j]
    cols["binding"] = binding.astype(np.float32)
    elements.append(("vertex", structured(cols)))

    for i, verts in enumerate(vertices_list):
        offset = verts - init_verts
        normed, lo, hi = _normalize(offset)
        elements.append((f"meta_delta_min_{i:05d}", structured(
            {"x": lo[0:1], "y": lo[1:2], "z": lo[2:3]})))
        elements.append((f"meta_delta_max_{i:05d}", structured(
            {"x": hi[0:1], "y": hi[1:2], "z": hi[2:3]})))
        if quantize_vertex_offsets:
            q = (normed * 255).astype(np.uint8)
            elements.append((f"delta_vertex_{i:05d}", structured(
                {"x": q[:, 0], "y": q[:, 1], "z": q[:, 2]}, "u1")))
        else:
            elements.append((f"delta_vertex_{i:05d}", structured(
                {"x": normed[:, 0], "y": normed[:, 1], "z": normed[:, 2]})))

    write_ply(path, elements)
