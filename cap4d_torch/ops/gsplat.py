"""3D Gaussian splatting math in plain PyTorch (counterpart of
``cap4d_tpu/ops/gsplat.py``): SH evaluation, quaternions, the EWA projection,
and the plain tile compositor that kernels K4/K5 are held against.

Projection: gsplat's "classic" mode with a +0.3 px dilation (``eps2d``), the
near/far clip, the 3σ radius and the conic (inverse 2-D covariance).

Compositing contract (``cap4d_tpu/ops/gsplat_pallas.py:161-263``, not the
XLA path's ``max_per_tile`` cap): a pair is kept where ``σ ≥ 0`` and
``opac·e^{-σ} ≥ 1/255``; ``α = min(opac·e^{-σ}, 0.999)``; the pairs of a
16×16 tile are composited front to back in exact depth order (ties broken by
gaussian index); per pixel the outputs are Σ w·rgb, Σ w, Σ w·depth and ln T.
A tile stops at the first 256-pair batch boundary, counted from the start of
its own segment, at which every pixel has T < 1e-4 (the TPU kernel checks at
global multiples of 256, a DMA-alignment artifact; the two rules differ by
less than 1e-4·|color| per pixel).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

# SH constants (utils/sh_utils.py:23-57 layout)
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)

TILE = 16                      # pixels per tile side
BATCH = 256                    # pairs per compositing batch (termination granularity)
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.999
LN_T_STOP = math.log(1e-4)     # a tile stops once every pixel's ln T is below this
# packed per-gaussian row: mean_x, mean_y, conic a, b, c, opacity, r, g, b, depth
N_PACKED = 10
# compositor output per pixel: Σw·r, Σw·g, Σw·b, Σw, Σw·depth, ln T
N_OUT = 6
# pair-pixel entries per chunk of the plain compositor (bounds its memory)
_PLAIN_CHUNK_ELEMS = 1 << 24


def _sh_terms(x, y, z, sh, degree: int):
    """Σ_k basis_k(x, y, z) · sh[k] with sh indexable by k → per-gaussian rows."""
    result = _C0 * sh(0)
    if degree >= 1:
        result = result - _C1 * y * sh(1) + _C1 * z * sh(2) - _C1 * x * sh(3)
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        result = (result
                  + _C2[0] * xy * sh(4)
                  + _C2[1] * yz * sh(5)
                  + _C2[2] * (2.0 * zz - xx - yy) * sh(6)
                  + _C2[3] * xz * sh(7)
                  + _C2[4] * (xx - yy) * sh(8))
    if degree >= 3:
        result = (result
                  + _C3[0] * y * (3 * xx - yy) * sh(9)
                  + _C3[1] * xy * z * sh(10)
                  + _C3[2] * y * (4 * zz - xx - yy) * sh(11)
                  + _C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh(12)
                  + _C3[4] * x * (4 * zz - xx - yy) * sh(13)
                  + _C3[5] * z * (xx - yy) * sh(14)
                  + _C3[6] * x * (xx - 3 * yy) * sh(15))
    if degree >= 4:
        result = (result
                  + _C4[0] * xy * (xx - yy) * sh(16)
                  + _C4[1] * yz * (3 * xx - yy) * sh(17)
                  + _C4[2] * xy * (7 * zz - 1) * sh(18)
                  + _C4[3] * yz * (7 * zz - 3) * sh(19)
                  + _C4[4] * (zz * (35 * zz - 30) + 3) * sh(20)
                  + _C4[5] * xz * (7 * zz - 3) * sh(21)
                  + _C4[6] * (xx - yy) * (7 * zz - 1) * sh(22)
                  + _C4[7] * xz * (xx - 3 * yy) * sh(23)
                  + _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)) * sh(24))
    return result


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """SH colours: sh (N, K, 3), unit dirs (N, 3), degree 0-4 → (N, 3)."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    return _sh_terms(x, y, z, lambda k: sh[:, k], degree)


def eval_sh_ch(sh: torch.Tensor, dx, dy, dz, degree: int) -> torch.Tensor:
    """Channelwise :func:`eval_sh`: unit direction channels (N,) → (3, N)."""
    sh_t = sh.permute(1, 2, 0)                       # (K, 3, N)
    return _sh_terms(dx, dy, dz, lambda k: sh_t[k], degree)


def rgb2sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / _C0


def sh2rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * _C0 + 0.5


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternions (N, 4), normalised inside → rotation matrices (N, 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def project_gaussians_ch(means3d, quats, scales, viewmat, K, width: int, height: int,
                         near: float = 0.01, far=1e10,
                         eps2d: float = 0.3) -> Dict[str, torch.Tensor]:
    """EWA projection of (N, 3) means, (N, 4) wxyz quats (normalised here)
    and (N, 3) scales. ``far`` may be a 0-d tensor. Returns (N,) channels
    mean_x, mean_y, conic_a/b/c, depth, radius (0 where invalid) and valid."""
    mx, my, mz = means3d.unbind(-1)
    qn = torch.sqrt((quats * quats).sum(-1))
    qw, qx, qy, qz = (quats[:, i] / qn for i in range(4))
    s = scales.unbind(-1)
    R = [[viewmat[i, j] for j in range(3)] for i in range(3)]
    t0, t1, t2 = viewmat[0, 3], viewmat[1, 3], viewmat[2, 3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    px = R[0][0] * mx + R[0][1] * my + R[0][2] * mz + t0
    py = R[1][0] * mx + R[1][1] * my + R[1][2] * mz + t1
    z = R[2][0] * mx + R[2][1] * my + R[2][2] * mz + t2
    z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    mean_x = px / z_safe * fx + cx
    mean_y = py / z_safe * fy + cy

    r = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
    ]
    m = [[r[i][j] * s[j] for j in range(3)] for i in range(3)]   # R(q)·diag(s)
    c3 = {}
    for i in range(3):
        for j in range(i, 3):
            c3[(i, j)] = c3[(j, i)] = m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]
    b = [[sum(R[i][k] * c3[(k, j)] for k in range(3)) for j in range(3)] for i in range(3)]
    v = {}
    for i in range(3):
        for j in range(i, 3):
            v[(i, j)] = v[(j, i)] = sum(b[i][k] * R[j][k] for k in range(3))

    # perspective Jacobian with gsplat's frustum clamping of x/z, y/z
    lim_x = 1.3 * (width / 2.0) / fx
    lim_y = 1.3 * (height / 2.0) / fy
    inv_z = 1.0 / z_safe
    txz = torch.maximum(torch.minimum(px * inv_z, lim_x), -lim_x)
    tyz = torch.maximum(torch.minimum(py * inv_z, lim_y), -lim_y)
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z
    a2 = j00 * j00 * v[(0, 0)] + 2 * j00 * j02 * v[(0, 2)] + j02 * j02 * v[(2, 2)] + eps2d
    b2 = (j00 * j11 * v[(0, 1)] + j00 * j12 * v[(0, 2)]
          + j02 * j11 * v[(1, 2)] + j02 * j12 * v[(2, 2)])
    c2 = j11 * j11 * v[(1, 1)] + 2 * j11 * j12 * v[(1, 2)] + j12 * j12 * v[(2, 2)] + eps2d

    det = a2 * c2 - b2 * b2
    det_safe = torch.where(det <= 0, torch.full_like(det, 1e-10), det)
    conic_a = c2 / det_safe
    conic_b = -b2 / det_safe
    conic_c = a2 / det_safe

    mid = 0.5 * (a2 + c2)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    in_frustum = (z > near) & (z < far)
    on_screen = ((mean_x + radius > 0) & (mean_x - radius < width)
                 & (mean_y + radius > 0) & (mean_y - radius < height))
    valid = in_frustum & on_screen & (det > 0)
    return {
        "mean_x": mean_x, "mean_y": mean_y,
        "conic_a": conic_a, "conic_b": conic_b, "conic_c": conic_c,
        "depth": z, "radius": torch.where(valid, radius, torch.zeros_like(radius)),
        "valid": valid,
    }


def project_gaussians(means3d, quats, scales, viewmat, K, width: int, height: int,
                      near: float = 0.01, far: float = 1e10, eps2d: float = 0.3):
    """EWA projection → (means2d (N, 2), conic (N, 3), depth, radius, valid)."""
    ch = project_gaussians_ch(means3d, quats, scales, viewmat, K, width, height,
                              near, far, eps2d)
    means2d = torch.stack([ch["mean_x"], ch["mean_y"]], dim=-1)
    conic = torch.stack([ch["conic_a"], ch["conic_b"], ch["conic_c"]], dim=-1)
    return means2d, conic, ch["depth"], ch["radius"], ch["valid"]


def tile_pixel_centres(tile_ids: torch.Tensor, tiles_x: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, 256) pixel-centre x and y of tiles ``tile_ids``, pixel p = row·16 + col."""
    p = torch.arange(TILE * TILE, device=tile_ids.device)
    ox = (tile_ids % tiles_x) * TILE
    oy = (tile_ids // tiles_x) * TILE
    px = (ox[:, None] + p[None] % TILE).float() + 0.5
    py = (oy[:, None] + p[None] // TILE).float() + 0.5
    return px, py


def _composite_chunk(packed: torch.Tensor, gidx: torch.Tensor, inseg: torch.Tensor,
                     px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Tiles of one chunk: gidx/inseg (C, L) pair gaussians and segment mask,
    px/py (C, 256) → (C, 256, N_OUT)."""
    d = packed[gidx]                                             # (C, L, 10)
    dx = px[:, None, :] - d[..., 0:1]                            # (C, L, P)
    dy = py[:, None, :] - d[..., 1:2]
    sigma = 0.5 * (d[..., 2:3] * dx * dx + d[..., 4:5] * dy * dy) + d[..., 3:4] * dx * dy
    # exp of the clamped σ: a kept pair has σ ≥ 0, and a huge negative σ of a
    # degenerate conic must not overflow into an inf whose zero gradient is NaN
    raw = d[..., 5:6] * torch.exp(-sigma.clamp(min=0.0))
    keep = (sigma >= 0) & (raw >= ALPHA_MIN) & inseg[..., None]
    alpha = torch.where(raw < ALPHA_MAX, raw, torch.full_like(raw, ALPHA_MAX))
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    l = torch.log1p(-alpha)
    cum = torch.cumsum(l, dim=1)                                 # inclusive ln T
    # termination: batch j runs iff some pixel had T ≥ 1e-4 after batch j-1
    C, L, _ = l.shape
    with torch.no_grad():
        n_b = (L + BATCH - 1) // BATCH
        ends = torch.clamp(torch.arange(n_b, device=l.device) * BATCH + BATCH - 1, max=L - 1)
        done = cum[:, ends].amax(dim=2) < LN_T_STOP              # (C, n_b) after batch b
        stopped = torch.cumsum(done.to(torch.int32), dim=1) > 0
        run = torch.cat([torch.ones_like(stopped[:, :1]), ~stopped[:, :-1]], dim=1)
        run = run.repeat_interleave(BATCH, dim=1)[:, :L].to(l.dtype)   # (C, L)
    l = l * run[..., None]
    excl = torch.cumsum(l, dim=1) - l
    w = alpha * torch.exp(excl) * run[..., None]                 # (C, L, P)
    rgb = torch.einsum("clp,clr->cpr", w, d[..., 6:9])
    wsum = w.sum(dim=1)
    dsum = torch.einsum("clp,cl->cp", w, d[..., 9])
    ln_t = l.sum(dim=1)
    return torch.cat([rgb, wsum[..., None], dsum[..., None], ln_t[..., None]], dim=-1)


def rasterize_gaussians_plain(packed: torch.Tensor, pair_gauss: torch.Tensor,
                              bounds: torch.Tensor, tiles_x: int) -> torch.Tensor:
    """Plain compositor: per tile, the depth-sorted pairs
    ``pair_gauss[bounds[t]:bounds[t+1]]`` over per-gaussian rows ``packed``
    (N, 10) → (n_tiles, 256, 6) of Σw·rgb, Σw, Σw·depth, ln T.

    Differentiable by autograd. Tiles run in chunks of similar segment
    length holding at most ``_PLAIN_CHUNK_ELEMS`` pair-pixel entries; under
    autograd each chunk is checkpointed (recomputed in the backward), so memory stays
    bounded by one chunk at any scene size."""
    n_tiles = bounds.shape[0] - 1
    dev = packed.device
    out = packed.new_zeros((n_tiles, TILE * TILE, N_OUT))
    lens = (bounds[1:] - bounds[:-1]).long()
    starts = bounds[:-1].long()
    busy = torch.nonzero(lens > 0)[:, 0]
    if busy.numel() == 0:
        return out
    busy = busy[torch.argsort(lens[busy], stable=True)]
    lens_host = lens[busy].tolist()
    pieces, tiles, i = [], [], 0
    while i < len(lens_host):
        j = i + 1
        while (j < len(lens_host)
               and (j - i + 1) * lens_host[j] * TILE * TILE <= _PLAIN_CHUNK_ELEMS):
            j += 1
        ids = busy[i:j]
        L = lens_host[j - 1]
        k = torch.arange(L, device=dev)
        inseg = k[None] < lens[ids][:, None]
        pos = torch.clamp(starts[ids][:, None] + k[None], max=max(pair_gauss.shape[0] - 1, 0))
        gidx = torch.where(inseg, pair_gauss[pos].long(), torch.zeros_like(pos))
        px, py = tile_pixel_centres(ids, tiles_x)
        if torch.is_grad_enabled() and packed.requires_grad:
            res = checkpoint(_composite_chunk, packed, gidx, inseg, px, py, use_reentrant=False)
        else:
            res = _composite_chunk(packed, gidx, inseg, px, py)
        pieces.append(res)
        tiles.append(ids)
        i = j
    return out.index_copy(0, torch.cat(tiles), torch.cat(pieces))
