"""FLAME forward + camera projection for a fit dict (counterpart of
``cap4d_tpu/flame/compute.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

from cap4d_torch.flame.camera import OPENCV2PYTORCH3D, project_vertices, transform_vertices
from cap4d_torch.flame.io import load_flame_pkl
from cap4d_torch.flame.skinner import FlameModel, build_flame_model, flame_forward

FLAME_ASSET_DIR = Path("data/assets/flame")
FLAME_PKL = "flame2023_no_jaw.pkl"
BLINK_BLENDSHAPE = "blink_blendshape.npy"
JAW_REGRESSOR = "jaw_regressor.npy"


def load_cap4d_flame_model(
    asset_dir: str | Path = FLAME_ASSET_DIR,
    n_shape_params: int = 150,
    n_expr_params: int = 65,
    add_mouth: bool = False,
    add_lower_jaw: bool = False,
    device="cpu",
) -> FlameModel:
    """Load the CAP4D-configured FLAME model from the standard asset layout."""
    asset_dir = Path(asset_dir)
    flame_dict = load_flame_pkl(asset_dir / FLAME_PKL)
    blink_path = asset_dir / BLINK_BLENDSHAPE
    blink = np.load(blink_path) if blink_path.exists() else None
    jaw_reg = np.load(asset_dir / JAW_REGRESSOR) if add_lower_jaw else None
    return build_flame_model(
        flame_dict, n_shape=n_shape_params, n_expr=n_expr_params,
        blink_blendshape=blink, add_mouth=add_mouth, add_lower_jaw=add_lower_jaw,
        jaw_regressor=jaw_reg, device=device)


def compute_flame(model: FlameModel, fit_3d: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Vertices in world / OpenCV / screen space for every (camera, timestep).

    fit_3d keys (fit.npz contract): shape (n_shape,), expr (N_t, n_expr),
    rot/tra/eye_rot (N_t, 3), fx/fy/cx/cy (N_c, 1), extr (N_c, 4, 4);
    optional jaw_rot / neck_rot (N_t, 3)."""
    dev = model.template.device

    def t(key):
        return torch.as_tensor(np.asarray(fit_3d[key], np.float32), device=dev)

    opt = {k: t(k) for k in ("jaw_rot", "neck_rot") if fit_3d.get(k) is not None}
    with torch.no_grad():
        out = flame_forward(model, shape=t("shape"), expr=t("expr"), rot=t("rot"),
                            tra=t("tra"), eye_rot=t("eye_rot") if "eye_rot" in fit_3d else None,
                            **opt)
        verts_3d = out["verts"]
        cv = torch.as_tensor(OPENCV2PYTORCH3D, device=dev)
        verts_3d_cv = transform_vertices(cv[None], verts_3d)
        cam = {k: t(k) for k in ("fx", "fy", "cx", "cy", "extr")}
        verts_2d = project_vertices(verts_3d_cv, cam)
    res = {"verts_3d": verts_3d, "verts_3d_cv": verts_3d_cv, "verts_2d": verts_2d,
           "offsets_3d": out["offsets"], "transforms": out["transforms"]}
    return {k: v.cpu().numpy() for k, v in res.items()}
