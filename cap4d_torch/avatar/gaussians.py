"""Mesh-bound 3D-Gaussian store with adaptive density control (counterpart
of ``cap4d_tpu/avatar/gaussians.py``).

The JAX package keeps the gaussians in fixed-capacity arrays with an
``active`` mask, because XLA needs static shapes. Here every tensor holds
exactly the live gaussians: clones and split children are appended, pruned
rows are removed. The rows keep the order the JAX store's active slots have
when it starts contiguous (originals, then clones, then second split
children), so a comparison against the JAX store's active rows is row by
row. There is no capacity to grow and nothing is dropped.

``params`` and ``moments["gauss_m"/"gauss_v"]`` are dicts over :data:`FIELDS`; ``aux``
holds binding (N,), binding_counter (F,), max_radii2d, xyz_gradient_accum
and denom (N,).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cap4d_torch.avatar.binding import quat_multiply, unpack_face_frame
from cap4d_torch.ops.gsplat import quat_to_rotmat, rgb2sh

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
Tensors = Dict[str, torch.Tensor]


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def init_gaussians(binding: np.ndarray, n_faces: int, sh_degree: int = 3,
                   gaussian_counts: Optional[np.ndarray] = None,
                   rng: Optional[np.random.Generator] = None,
                   device="cpu") -> Tuple[Tensors, Tensors]:
    """create_from_pcd init (gaussian_model.py:174-208), the same draws as
    the JAX package: xyz ~ U[0, 0.4), colours ~ U[0, 1/255), log-scales
    log(1/count), identity quats, opacity logit(0.1)."""
    rng = rng or np.random.default_rng(0)
    n0 = binding.shape[0]
    K = (sh_degree + 1) ** 2
    xyz = (rng.random((n0, 3)) * 0.4).astype(np.float32)
    f_dc = rgb2sh(torch.as_tensor(rng.random((n0, 3)) / 255.0).float())[:, None]
    scales = np.zeros((n0, 3), np.float32)
    if gaussian_counts is not None:
        scales[:] = np.log(1.0 / gaussian_counts[:, None])
    rots = np.zeros((n0, 4), np.float32)
    rots[:, 0] = 1.0

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    params = {
        "xyz": t(xyz), "features_dc": f_dc.to(device),
        "features_rest": torch.zeros((n0, K - 1, 3), device=device),
        "scaling": t(scales), "rotation": t(rots),
        "opacity": inverse_sigmoid(torch.full((n0, 1), 0.1, device=device)),
    }
    aux = {
        "binding": t(binding, torch.int64),
        "binding_counter": t(np.bincount(binding, minlength=n_faces), torch.int32),
        "max_radii2d": torch.zeros(n0, device=device),
        "xyz_gradient_accum": torch.zeros(n0, device=device),
        "denom": torch.zeros(n0, device=device),
    }
    return params, aux


def zero_moments(params: Tensors) -> Dict[str, Tensors]:
    """Adam first and second moments ("gauss_m", "gauss_v") of ``params``."""
    return {"gauss_m": {f: torch.zeros_like(params[f]) for f in FIELDS},
            "gauss_v": {f: torch.zeros_like(params[f]) for f in FIELDS}}


def world_gaussians(params: Tensors, aux: Tensors, face_pack: torch.Tensor) -> Tensors:
    """Local → world transforms of the bound gaussians (gaussian_model.py:
    112-152) from (F, 16) packed face frames: means3d (N, 3), unit quats
    (N, 4), scales (N, 3), opacities (N,) and sh (N, K, 3)."""
    f = unpack_face_frame(face_pack[aux["binding"]])
    a0, a1, a2, s = f["a0"], f["a1"], f["a2"], f["scale"]
    lx, ly, lz = params["xyz"].unbind(-1)
    means = torch.stack([(a0[i] * lx + a1[i] * ly + a2[i] * lz) * s + f["center"][i]
                         for i in range(3)], dim=-1)
    rot = params["rotation"]
    rot = rot / torch.sqrt(torch.clamp((rot * rot).sum(-1, keepdim=True), min=1e-24))
    quats = quat_multiply(torch.stack(f["quat"], dim=-1), rot)
    return {
        "means3d": means,
        "quats": quats,
        "scales": torch.exp(params["scaling"]) * s[:, None],
        "opacities": torch.sigmoid(params["opacity"][:, 0]),
        "sh": torch.cat([params["features_dc"], params["features_rest"]], dim=1),
    }


def densify_and_prune(params: Tensors, aux: Tensors, moments: Dict[str, Tensors],
                      face_scaling: torch.Tensor, noise: Tuple[torch.Tensor, torch.Tensor],
                      max_grad: float = 0.0002, min_opacity: float = 0.005,
                      extent: float = 1.0, percent_dense: float = 0.01,
                      max_screen_size: Optional[float] = None):
    """Clone + split + prune (gaussian_model.py:448-521), with the JAX
    package's semantics: a split's first child overwrites its source row,
    the second is appended after the clones; Adam moments of every written
    row are zeroed; a face never loses its last gaussian. ``noise`` holds
    two (N, 3) standard normals for the split samples. The oversize prune
    reads each row's pre-densify world scale (a new row: its source's) and
    pre-densify screen radius (a new row: 0), as the JAX store does for
    the slots it writes.

    Returns (params, aux, moments)."""
    n = params["xyz"].shape[0]
    dev = params["xyz"].device
    binding = aux["binding"]
    grads = aux["xyz_gradient_accum"] / torch.where(aux["denom"] == 0, torch.ones_like(aux["denom"]),
                                                    aux["denom"])
    grads = torch.nan_to_num(grads, nan=0.0)
    world_scale = torch.exp(params["scaling"]) * face_scaling[binding]
    max_scale = world_scale.max(dim=1).values
    big_grad = grads >= max_grad
    small = max_scale <= percent_dense * extent
    clone_idx = torch.nonzero(big_grad & small)[:, 0]
    split_sel = big_grad & ~small
    split_idx = torch.nonzero(split_sel)[:, 0]

    R = quat_to_rotmat(params["rotation"])
    # the reference adds the world-scaled sample to the LOCAL xyz
    # (gaussian_model.py:457-461), kept for parity
    child1_xyz = torch.einsum("nij,nj->ni", R, noise[0] * world_scale) + params["xyz"]
    child2_xyz = torch.einsum("nij,nj->ni", R, noise[1] * world_scale) + params["xyz"]
    new_scaling = torch.log(torch.exp(params["scaling"]) / 1.6)     # /(0.8·N), N = 2

    src = torch.cat([torch.arange(n, device=dev), clone_idx, split_idx])
    out = {f: params[f][src] for f in FIELDS}
    sel = split_sel[:, None]
    out["xyz"] = torch.cat([torch.where(sel, child1_xyz, params["xyz"]),
                            params["xyz"][clone_idx], child2_xyz[split_idx]])
    out["scaling"] = torch.cat([torch.where(sel, new_scaling, params["scaling"]),
                                params["scaling"][clone_idx], new_scaling[split_idx]])
    fresh = torch.cat([split_sel, torch.ones(src.shape[0] - n, dtype=torch.bool, device=dev)])
    new_moments = {k: {f: torch.where(fresh.view(-1, *([1] * (m[f].ndim - 1))),
                                      torch.zeros_like(m[f][src]), m[f][src]) for f in FIELDS}
                   for k, m in moments.items()}
    new_binding = binding[src]
    counter = aux["binding_counter"].clone()
    counter.index_add_(0, binding[torch.cat([clone_idx, split_idx])],
                       torch.ones(clone_idx.shape[0] + split_idx.shape[0], dtype=counter.dtype,
                                  device=dev))

    prune = torch.sigmoid(out["opacity"][:, 0]) < min_opacity
    if max_screen_size is not None:
        radii = torch.cat([aux["max_radii2d"], torch.zeros(src.shape[0] - n, device=dev)])
        prune = prune | (radii > max_screen_size) | (max_scale[src] > 0.1 * extent)
    # faces that would lose every gaussian keep all their prune candidates
    per_face = torch.zeros_like(counter).index_add_(0, new_binding, prune.to(counter.dtype))
    prune = prune & ((counter - per_face) > 0)[new_binding]
    counter.index_add_(0, new_binding[prune], -torch.ones(int(prune.sum()), dtype=counter.dtype,
                                                          device=dev))
    keep = ~prune
    m = int(keep.sum())
    new_aux = {
        "binding": new_binding[keep], "binding_counter": counter,
        "max_radii2d": torch.zeros(m, device=dev),
        "xyz_gradient_accum": torch.zeros(m, device=dev),
        "denom": torch.zeros(m, device=dev),
    }
    return ({f: out[f][keep].contiguous() for f in FIELDS}, new_aux,
            {k: {f: v[f][keep].contiguous() for f in FIELDS} for k, v in new_moments.items()})


def reset_opacity(params: Tensors, moments: Dict[str, Tensors]) -> None:
    """opacity ← logit(min(σ(o), 0.01)) and its Adam moments zeroed
    (gaussian_model.py:279-282), written into the existing tensors (a
    captured train step keeps reading them)."""
    with torch.no_grad():
        params["opacity"].copy_(
            inverse_sigmoid(torch.clamp(torch.sigmoid(params["opacity"]), max=0.01)))
        for m in moments.values():
            m["opacity"].zero_()


def add_densification_stats(aux: Tensors, means2d_grad: torch.Tensor,
                            visibility: torch.Tensor, radii: torch.Tensor) -> None:
    """Accumulate view-space gradient norms and track max radii
    (train.py:230-233), in place."""
    g = torch.linalg.norm(means2d_grad[:, :2], dim=-1)
    aux["xyz_gradient_accum"] += torch.where(visibility, g, torch.zeros_like(g))
    aux["denom"] += visibility.to(g.dtype)
    aux["max_radii2d"].copy_(torch.where(visibility, torch.maximum(aux["max_radii2d"], radii),
                                         aux["max_radii2d"]))
