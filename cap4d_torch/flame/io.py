"""Host-side FLAME asset loading and synthetic FLAME-shaped assets
(counterpart of ``cap4d_tpu/flame/io.py``)."""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np

FLAME_N_SHAPE = 300
FLAME_N_EXPR = 100
FLAME_N_VERTS = 5023

# deprecated numpy aliases that chumpy-era pickles reference
_NP_SHIMS = {
    "bool": bool, "int": int, "float": float, "complex": complex,
    "object": object, "unicode": str, "str": str,
}


class _np_shims_installed:
    """Install the aliases for the duration of an unpickle only."""

    def __enter__(self):
        self._added = []
        for name, val in _NP_SHIMS.items():
            if name not in np.__dict__:
                setattr(np, name, val)
                self._added.append(name)

    def __exit__(self, *exc):
        for name in self._added:
            delattr(np, name)
        return False


def _to_dense_numpy(arr: Any, dtype: Any = None) -> np.ndarray:
    if callable(getattr(arr, "todense", None)):  # scipy.sparse
        arr = arr.todense()
    if dtype is None:
        base = np.asarray(arr)
        dtype = np.float32 if np.issubdtype(base.dtype, np.floating) else np.int64
    return np.array(arr, dtype=dtype).squeeze()


def load_flame_pkl(path: str | Path) -> Dict[str, np.ndarray]:
    """Load a FLAME 2023 pkl into a dict of plain numpy arrays: v_template,
    shapedirs, posedirs, J_regressor, weights, kintree_table, f."""
    with _np_shims_installed(), open(path, "rb") as fh:
        raw = pickle.load(fh, encoding="latin1")
    out: Dict[str, np.ndarray] = {}
    for key, value in raw.items():
        if not hasattr(value, "shape"):
            continue
        out[key] = _to_dense_numpy(value, np.int32) if key == "f" else _to_dense_numpy(value)
    # the root's parent is stored as the 2**32 - 1 sentinel
    out["kintree_table"] = out["kintree_table"].astype(np.int64)
    out["kintree_table"][0, 0] = -1
    return out


def make_synthetic_flame(
    n_verts: int = 64,
    n_joints: int = 5,
    n_shape: int = FLAME_N_SHAPE,
    n_expr: int = FLAME_N_EXPR,
    seed: int = 0,
    sphere_radius: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Random FLAME-shaped asset dict (no real pkl needed); the same arrays
    ``cap4d_tpu.flame.io.make_synthetic_flame`` draws from the same seed."""
    rng = np.random.default_rng(seed)
    if sphere_radius > 0:
        i = np.arange(n_verts, dtype=np.float64)
        phi = np.pi * (3.0 - np.sqrt(5.0)) * i
        z = 1.0 - 2.0 * (i + 0.5) / n_verts
        r_xy = np.sqrt(np.clip(1.0 - z * z, 0, None))
        v_template = (sphere_radius * np.stack(
            [r_xy * np.cos(phi), r_xy * np.sin(phi), z], axis=-1)).astype(np.float32)
        v_template += rng.normal(
            scale=0.02 * sphere_radius, size=v_template.shape).astype(np.float32)
    else:
        v_template = rng.normal(scale=0.1, size=(n_verts, 3)).astype(np.float32)
    bs_scale = 0.0005 if sphere_radius > 0 else 0.01
    shapedirs = rng.normal(scale=bs_scale, size=(n_verts, 3, n_shape + n_expr)).astype(np.float32)
    posedirs = rng.normal(scale=bs_scale, size=(n_verts, 3, (n_joints - 1) * 9)).astype(np.float32)
    j_regressor = rng.uniform(size=(n_joints, n_verts)).astype(np.float32)
    j_regressor /= j_regressor.sum(axis=1, keepdims=True)
    weights = rng.uniform(size=(n_verts, n_joints)).astype(np.float32)
    weights /= weights.sum(axis=1, keepdims=True)
    kintree = np.zeros((2, n_joints), dtype=np.int64)
    kintree[0] = np.array([-1, 0, 1, 1, 1][:n_joints])
    kintree[1] = np.arange(n_joints)
    # fan triangulation: valid face indices for the rasterizer
    faces = np.stack(
        [np.zeros(n_verts - 2), np.arange(1, n_verts - 1), np.arange(2, n_verts)],
        axis=-1).astype(np.int32)
    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": j_regressor,
        "weights": weights,
        "kintree_table": kintree,
        "f": faces,
    }


def save_flame_pkl(flame_dict: Dict[str, np.ndarray], path: str | Path) -> None:
    """Write a flame dict as a pkl that ``load_flame_pkl`` reads."""
    with open(path, "wb") as fh:
        pickle.dump(flame_dict, fh)
