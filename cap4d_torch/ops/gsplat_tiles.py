"""Tile-binned 3D Gaussian splatting renderer (counterpart of
``cap4d_tpu/ops/gsplat_pallas.py``, entry point ``rasterize_gaussians_pallas``).

Pipeline, all differentiable where the JAX package's is:

* projection and SH in plain PyTorch (``ops/gsplat.py``), producing one
  packed row per gaussian: mean_x, mean_y, conic a/b/c, opacity, rgb, depth;
* the pair build in PyTorch ops (the JAX package's is XLA, outside any Pallas
  kernel): tile boxes from the radius, the exact alpha-bound tile cull, one
  (tile, depth rank) key per covered tile, one ``torch.sort`` of int64 keys
  ``tile << 32 | rank`` and the per-tile ``[start, end)`` bounds. Every tile a
  splat's box touches is covered (no window ladder), so ``n_truncated`` and
  ``n_truncated_depth`` are always 0. With a pair ``budget`` (the fit's
  captured step, whose shapes must not depend on the device's values) the
  build writes exactly that many candidate slots and counts the candidates
  that did not fit; the caller re-runs with a larger budget, so no pair is
  ever dropped from a result it keeps;
* compositing through :class:`Composite`: kernel K4 (``csrc/gsplat_fwd.cu``)
  forward and kernel K5 (``csrc/gsplat_bwd.cu``) backward on CUDA tensors,
  the plain compositor ``ops/gsplat.py::rasterize_gaussians_plain`` (with
  autograd for the backward) on CPU tensors or with ``plain=True``. Both
  kernels work on (tile, 256-pair batch) items: K4 composites each batch
  from T = 1 and merges a tile's batches in order under the stop rule,
  saving each batch's starting state (ln T before it, the prefix of its
  sums), from which K5 replays one batch per block.
  :func:`composite_fwd_plain` and :func:`composite_bwd_plain` compute that
  split at the kernels' interfaces in tensor ops, for comparisons and tests.

Gradients reach means3d, quats, scales, opacities, SH and ``means2d_offset``
through the projection's autograd; the densify statistics read the
``means2d_offset`` gradient.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from cap4d_torch.ops.cuda_build import CudaKernel, I, P
from cap4d_torch.ops.gsplat import (
    ALPHA_MAX,
    ALPHA_MIN,
    BATCH,
    LN_T_STOP,
    N_OUT,
    N_PACKED,
    TILE,
    eval_sh_ch,
    project_gaussians_ch,
    rasterize_gaussians_plain,
    tile_pixel_centres,
)

# K4's state per (item, pixel): ln T before the batch, then the prefix of
# Σw·r, Σw·g, Σw·b, Σw, Σw·depth
N_STATE = 6

KERNEL_FWD = CudaKernel("gsplat_fwd.cu",
                        {"c4d_gsplat_fwd": [P, P, P, I, I, I, P, P, P, P, P]})
KERNEL_BWD = CudaKernel("gsplat_bwd.cu",
                        {"c4d_gsplat_bwd": [P, P, P, P, P, P, P, I, I, I, P, P, P]})


def _tile_boxes(mean_x, mean_y, radius, valid, width: int, height: int):
    """Each gaussian's box of tiles: its first tile column and row, its
    width in tiles and its tile count (0 where not valid)."""
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    tx0 = torch.floor((mean_x - radius) / TILE).long().clamp(0, tiles_x - 1)
    ty0 = torch.floor((mean_y - radius) / TILE).long().clamp(0, tiles_y - 1)
    tx1 = torch.floor((mean_x + radius) / TILE).long().clamp(0, tiles_x - 1)
    ty1 = torch.floor((mean_y + radius) / TILE).long().clamp(0, tiles_y - 1)
    wx = tx1 - tx0 + 1
    return tx0, ty0, wx, torch.where(valid, wx * (ty1 - ty0 + 1), torch.zeros_like(wx))


def count_candidates(means3d, quats, scales, viewmat, K, width: int, height: int,
                     near: float = 0.01, far=1e10) -> torch.Tensor:
    """The (gaussian, tile) candidates of one view before the alpha cull,
    as a 0-d device tensor: the slots a pair budget must hold for it."""
    with torch.no_grad():
        ch = project_gaussians_ch(means3d, quats, scales, viewmat, K, width, height, near, far)
        return _tile_boxes(ch["mean_x"], ch["mean_y"], ch["radius"], ch["valid"],
                           width, height)[3].sum()


def tile_pairs(mean_x, mean_y, conic_a, conic_b, conic_c, opacity, radius, valid, depth,
               width: int, height: int, budget: Optional[int] = None):
    """Sorted (tile, depth) pairs: ``pair_gauss`` (M,) int32 gaussian per
    pair, tile-major and front to back within a tile, and ``bounds``
    (n_tiles + 1,) int32 segment starts. No gradient flows through here.

    With ``budget`` B the sizes depend on no device value (no host sync): B
    candidate slots, one per (gaussian, tile of its box) up to B, found by a
    ``searchsorted`` over the candidates' running count; culled and unused
    slots take the sentinel tile ``n_tiles``, so the one sort puts them last,
    and the bounds come from a ``scatter_add_`` into ``n_tiles + 1`` bins.
    ``pair_gauss`` then has B entries, of which ``pair_gauss[:bounds[-1]]``
    equal the unbudgeted call's bit for bit when every candidate fits, and a
    third result, a (1,) int32 device counter, holds the candidates that did
    not (Σ candidates − B, at least 0)."""
    with torch.no_grad():
        dev = mean_x.device
        tiles_x = (width + TILE - 1) // TILE
        tiles_y = (height + TILE - 1) // TILE
        n_tiles = tiles_x * tiles_y
        n = mean_x.shape[0]
        # exact global depth order as an integer rank, ties by gaussian index
        order = torch.sort(depth, stable=True).indices
        # alpha-bound cull (gsplat_pallas.py:733-750): σ ≥ ½·λ_min·r² at
        # distance r from the mean, so a tile whose nearest point lies past
        # r²_cut = 2·ln(opac·255)/λ_min never passes the keep mask
        lam_min = (0.5 * (conic_a + conic_c)
                   - torch.sqrt(0.25 * (conic_a - conic_c) ** 2 + conic_b ** 2))
        r2_cut = (2.0 * torch.log(torch.clamp(opacity, min=1e-30) / ALPHA_MIN)
                  / torch.clamp(lam_min, min=1e-12))
        tx0, ty0, wx, count = _tile_boxes(mean_x, mean_y, radius, valid, width, height)
        ends = torch.cumsum(count, 0)
        first = ends - count
        rank = torch.empty_like(order)
        rank[order] = torch.arange(n, device=dev)
        if budget is None:
            g = torch.repeat_interleave(torch.arange(n, device=dev), count)
            slot = torch.arange(g.shape[0], device=dev)
        elif n == 0:
            return (torch.zeros(budget, dtype=torch.int32, device=dev),
                    torch.zeros(n_tiles + 1, dtype=torch.int32, device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev))
        else:
            slot = torch.arange(budget, device=dev)
            # the gaussian whose candidates [first, end) hold each slot; n past the last
            g = torch.searchsorted(ends, slot, right=True)
            used = g < n
            g = g.clamp(max=n - 1)
        local = slot - first[g]
        cx = tx0[g] + local % wx[g]
        cy = ty0[g] + local // wx[g]
        tlx = (cx * TILE).float()
        tly = (cy * TILE).float()
        mx, my = mean_x[g], mean_y[g]
        ddx = torch.clamp(torch.maximum(tlx - mx, mx - (tlx + TILE)), min=0.0)
        ddy = torch.clamp(torch.maximum(tly - my, my - (tly + TILE)), min=0.0)
        ok = ddx * ddx + ddy * ddy <= r2_cut[g]
        bounds = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
        if budget is None:
            g, tile = g[ok], (cy * tiles_x + cx)[ok]
            keys = (tile << 32) | rank[g]
            sorted_keys = torch.sort(keys).values
            pair_gauss = order[sorted_keys & 0xFFFFFFFF].to(torch.int32)
            bounds[1:] = torch.cumsum(torch.bincount(tile, minlength=n_tiles), 0)
            return pair_gauss, bounds.to(torch.int32)
        tile = torch.where(ok & used, cy * tiles_x + cx, torch.full_like(cx, n_tiles))
        keys = (tile << 32) | rank[g]
        sorted_keys = torch.sort(keys).values
        pair_gauss = order[sorted_keys & 0xFFFFFFFF].to(torch.int32)
        counts = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
        counts.scatter_add_(0, tile, torch.ones_like(tile))
        bounds[1:] = torch.cumsum(counts[:n_tiles], 0)
        overflow = torch.clamp(ends[-1:] - budget, min=0).to(torch.int32)
        return pair_gauss, bounds.to(torch.int32), overflow


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous CUDA {dtype} tensor, got "
                         f"{t.device} {t.dtype} contiguous={t.is_contiguous()}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def state_rows(n_tiles: int, n_pairs: int) -> int:
    """Rows of the compositor's state: an upper bound on the work items,
    Σ_t ⌈len_t / 256⌉ ≤ n_tiles + M // 256, known without reading the
    device."""
    return n_tiles + n_pairs // BATCH


def composite_fwd_cuda(packed, pair_gauss, bounds, tiles_x: int):
    """K4: (n_tiles, 256, 6) outputs, the batches each tile ran and the state
    K5 starts from, (state_rows, 6, 256): for each (tile, batch) item that
    ran, ln T before the batch and the prefix of Σw·rgb, Σw, Σw·depth."""
    n_tiles = bounds.shape[0] - 1
    _check("packed", packed, torch.float32, (packed.shape[0], N_PACKED))
    _check("pair_gauss", pair_gauss, torch.int32, (pair_gauss.shape[0],))
    _check("bounds", bounds, torch.int32, (n_tiles + 1,))
    dev = packed.device
    n_rows = state_rows(n_tiles, pair_gauss.shape[0])
    out = torch.empty((n_tiles, TILE * TILE, N_OUT), dtype=torch.float32, device=dev)
    n_done = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    state = torch.empty((n_rows, N_STATE, TILE * TILE), dtype=torch.float32, device=dev)
    work = torch.empty((n_tiles + 1 + n_rows,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    KERNEL_FWD.call("c4d_gsplat_fwd", packed.data_ptr(), pair_gauss.data_ptr(),
                    bounds.data_ptr(), n_tiles, tiles_x, n_rows, work.data_ptr(),
                    out.data_ptr(), n_done.data_ptr(), state.data_ptr(),
                    ctypes.c_void_p(stream), inputs=(packed, pair_gauss, bounds))
    return out, n_done, state


def composite_bwd_cuda(packed, pair_gauss, bounds, out, n_done, state, grad_out, tiles_x: int):
    """K5: per-gaussian gradient (N, 10) of the packed rows."""
    n_tiles = bounds.shape[0] - 1
    n_rows = state_rows(n_tiles, pair_gauss.shape[0])
    grad_out = grad_out.contiguous()
    _check("out", out, torch.float32, (n_tiles, TILE * TILE, N_OUT))
    _check("grad_out", grad_out, torch.float32, (n_tiles, TILE * TILE, N_OUT))
    _check("n_done", n_done, torch.int32, (n_tiles,))
    _check("state", state, torch.float32, (n_rows, N_STATE, TILE * TILE))
    dpacked = torch.zeros_like(packed)
    work = torch.empty((2 * n_tiles + 2 + n_rows,), dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    KERNEL_BWD.call("c4d_gsplat_bwd", packed.data_ptr(), pair_gauss.data_ptr(),
                    bounds.data_ptr(), out.data_ptr(), n_done.data_ptr(), state.data_ptr(),
                    grad_out.data_ptr(), n_tiles, tiles_x, n_rows, work.data_ptr(),
                    dpacked.data_ptr(), ctypes.c_void_p(stream),
                    inputs=(packed, pair_gauss, bounds, out, n_done, state, grad_out))
    return dpacked


def work_items(bounds: torch.Tensor):
    """The (tile, batch) items of the pairs: per tile the first state row
    (n_tiles + 1,), and per item its tile and batch index (n_items,)."""
    n_tiles = bounds.shape[0] - 1
    lens = (bounds[1:] - bounds[:-1]).long()
    counts = (lens + BATCH - 1) // BATCH
    row_start = torch.zeros(n_tiles + 1, dtype=torch.int64, device=bounds.device)
    row_start[1:] = torch.cumsum(counts, 0)
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=bounds.device), counts)
    batch = torch.arange(tile.shape[0], device=bounds.device) - row_start[tile]
    return row_start, tile, batch


def _batch_terms(packed, pair_gauss, bounds, tiles_x, tile, batch):
    """The pair-pixel terms of items (tile, batch), C of them: the gathered
    rows d (C, 256, 10), the gaussians (C, 256) (0 past the batch's end),
    dx, dy, σ, e^-σ, the clamped α, the keep mask (C, 256 pairs, 256 px)
    and whether each pair slot holds a pair (C, 256)."""
    starts = bounds[tile].long() + batch * BATCH
    slot = starts[:, None] + torch.arange(BATCH, device=packed.device)
    inseg = slot < bounds[tile + 1].long()[:, None]
    gidx = torch.where(inseg, pair_gauss[slot.clamp(max=max(pair_gauss.shape[0] - 1, 0))].long(),
                       torch.zeros_like(slot))
    d = packed[gidx]
    px, py = tile_pixel_centres(tile, tiles_x)
    dx = px[:, None, :] - d[..., 0:1]
    dy = py[:, None, :] - d[..., 1:2]
    sigma = 0.5 * (d[..., 2:3] * dx * dx + d[..., 4:5] * dy * dy) + d[..., 3:4] * dx * dy
    expneg = torch.exp(-sigma.clamp(min=0.0))
    raw = d[..., 5:6] * expneg
    keep = (sigma >= 0) & (raw >= ALPHA_MIN) & inseg[..., None]
    alpha = torch.where(keep, raw.clamp(max=ALPHA_MAX), torch.zeros_like(raw))
    return d, gidx, dx, dy, expneg, raw, alpha, keep, inseg


# items per chunk of the interface-level plain versions: 256 items × 256
# pairs × 256 pixels bound their intermediates, as the plain compositor's
# chunks are bounded
_ITEMS_PER_CHUNK = 256


def composite_fwd_plain(packed, pair_gauss, bounds, tiles_x: int):
    """The split's algebra in plain tensor ops, at K4's interface: every
    (tile, batch) item composited from T = 1, then per tile a merge over its
    items in order with the stop rule at each batch boundary. Returns
    ``(out, n_done, state)`` as :func:`composite_fwd_cuda` does; state rows of
    items that did not run are 0. For comparisons and tests only."""
    n_tiles = bounds.shape[0] - 1
    px_n = TILE * TILE
    row_start, tile, batch = work_items(bounds)
    n_items = tile.shape[0]
    local = packed.new_zeros((n_items, N_STATE, px_n))
    for i in range(0, n_items, _ITEMS_PER_CHUNK):
        tc, bc = tile[i:i + _ITEMS_PER_CHUNK], batch[i:i + _ITEMS_PER_CHUNK]
        d, _, _, _, _, _, alpha, _, _ = _batch_terms(packed, pair_gauss, bounds, tiles_x, tc, bc)
        l = torch.log1p(-alpha)
        w = alpha * torch.exp(torch.cumsum(l, dim=1) - l)          # (C, 256 pairs, P)
        local[i:i + len(tc), 0] = l.sum(dim=1)
        local[i:i + len(tc), 1:4] = torch.einsum("cbp,cbr->crp", w, d[..., 6:9])
        local[i:i + len(tc), 4] = w.sum(dim=1)
        local[i:i + len(tc), 5] = torch.einsum("cbp,cb->cp", w, d[..., 9])

    state = packed.new_zeros((state_rows(n_tiles, pair_gauss.shape[0]), N_STATE, px_n))
    sums = packed.new_zeros((n_tiles, 5, px_n))
    ln_t = packed.new_zeros((n_tiles, px_n))
    n_done = torch.zeros(n_tiles, dtype=torch.int32, device=packed.device)
    counts = row_start[1:] - row_start[:-1]
    for j in range(int(counts.max()) if n_tiles else 0):
        run = (counts > j) & (n_done == j)
        if j > 0:
            run &= ln_t.amax(dim=1) >= LN_T_STOP
        rows = row_start[:-1][run] + j
        state[rows, 0] = ln_t[run]
        state[rows, 1:] = sums[run]
        sums[run] += torch.exp(ln_t[run])[:, None] * local[rows, 1:]
        ln_t[run] += local[rows, 0]
        n_done += run.to(torch.int32)
    out = torch.cat([sums.transpose(1, 2), ln_t[..., None]], dim=-1)
    return out, n_done, state


def composite_bwd_plain(packed, pair_gauss, bounds, out, n_done, state, grad_out,
                        tiles_x: int):
    """The per-batch backward in plain tensor ops, at K5's interface: each
    item that ran starts from its state row (T = exp(ln T before), the prefix
    of w·q from the prefix sums) and applies K5's per-pair formula; the
    per-pair sums over pixels go to their gaussians by ``index_add_``.
    Returns dpacked (N, 10). For comparisons and tests only."""
    row_start, tile, batch = work_items(bounds)
    ran = batch < n_done.long()[tile]
    rows = (row_start[:-1][tile] + batch)[ran]
    tile, batch = tile[ran], batch[ran]
    dpacked = torch.zeros_like(packed)
    for i in range(0, tile.shape[0], _ITEMS_PER_CHUNK):
        sl = slice(i, i + _ITEMS_PER_CHUNK)
        tc = tile[sl]
        d, gidx, dx, dy, expneg, raw, alpha, keep, inseg = _batch_terms(
            packed, pair_gauss, bounds, tiles_x, tc, batch[sl])
        g = grad_out[tc].transpose(1, 2)                             # (C, 6, P)
        s_total = (out[tc][..., :5].transpose(1, 2) * g[:, :5]).sum(dim=1)
        st = state[rows[sl]]
        prefix0 = (st[:, 1:] * g[:, :5]).sum(dim=1)                  # (C, P)
        l = torch.log1p(-alpha)
        T = torch.exp(st[:, None, 0] + torch.cumsum(l, dim=1) - l)   # before each pair
        w = alpha * T
        q = (torch.einsum("cbr,crp->cbp", d[..., 6:9], g[:, 0:3]) + g[:, None, 3]
             + d[..., 9:10] * g[:, None, 4])
        suffix = s_total[:, None] - (prefix0[:, None] + torch.cumsum(w * q, dim=1))
        d_alpha = T * q - (suffix + g[:, None, 5]) / (1.0 - alpha)
        d_pre = torch.where(keep & (raw < ALPHA_MAX), d_alpha, torch.zeros_like(d_alpha))
        d_sigma = -d_pre * alpha
        ca, cb, cc = d[..., 2:3], d[..., 3:4], d[..., 4:5]
        per_pair = torch.stack([
            (-d_sigma * (ca * dx + cb * dy)).sum(-1),
            (-d_sigma * (cc * dy + cb * dx)).sum(-1),
            (d_sigma * 0.5 * dx * dx).sum(-1),
            (d_sigma * dx * dy).sum(-1),
            (d_sigma * 0.5 * dy * dy).sum(-1),
            (d_pre * expneg).sum(-1),
            torch.einsum("cbp,cp->cb", w, g[:, 0]),
            torch.einsum("cbp,cp->cb", w, g[:, 1]),
            torch.einsum("cbp,cp->cb", w, g[:, 2]),
            torch.einsum("cbp,cp->cb", w, g[:, 4]),
        ], dim=-1)                                                   # (C, 256, 10)
        dpacked.index_add_(0, gidx[inseg], per_pair[inseg])
    return dpacked


class Composite(torch.autograd.Function):
    """K4 forward, K5 backward over the sorted pairs; CUDA tensors only."""

    @staticmethod
    def forward(ctx, packed, pair_gauss, bounds, tiles_x):
        packed = packed.contiguous()
        out, n_done, state = composite_fwd_cuda(packed, pair_gauss, bounds, tiles_x)
        ctx.save_for_backward(packed, pair_gauss, bounds, out, n_done, state)
        ctx.tiles_x = tiles_x
        ctx.mark_non_differentiable(n_done)
        return out, n_done

    @staticmethod
    def backward(ctx, grad_out, _grad_n_done):
        packed, pair_gauss, bounds, out, n_done, state = ctx.saved_tensors
        dpacked = composite_bwd_cuda(packed, pair_gauss, bounds, out, n_done, state, grad_out,
                                     ctx.tiles_x)
        return dpacked, None, None, None


def composite(packed: torch.Tensor, pair_gauss: torch.Tensor, bounds: torch.Tensor,
              tiles_x: int, plain: bool = False) -> torch.Tensor:
    """(n_tiles, 256, 6) compositor outputs. CUDA tensors launch K4 (and K5
    in the backward); ``plain=True`` runs the plain version there instead
    (for comparisons only). CPU tensors take the plain version."""
    if packed.is_cuda and not plain:
        return Composite.apply(packed, pair_gauss, bounds, tiles_x)[0]
    return rasterize_gaussians_plain(packed, pair_gauss, bounds, tiles_x)


def tiles_to_image(tiles: torch.Tensor, tiles_x: int, tiles_y: int,
                   width: int, height: int) -> torch.Tensor:
    """(n_tiles, 256, C) → (H, W, C)."""
    c = tiles.shape[-1]
    img = tiles.reshape(tiles_y, tiles_x, TILE, TILE, c).permute(0, 2, 1, 3, 4)
    return img.reshape(tiles_y * TILE, tiles_x * TILE, c)[:height, :width]


def rasterize_gaussians(
    means3d: torch.Tensor,        # (N, 3) world
    quats: torch.Tensor,          # (N, 4) wxyz
    scales: torch.Tensor,         # (N, 3) world-space scales (post-activation)
    opacities: torch.Tensor,      # (N,)
    sh_colors: torch.Tensor,      # (N, K, 3)
    viewmat: torch.Tensor,        # (4, 4) world→cam
    K: torch.Tensor,              # (3, 3)
    width: int,
    height: int,
    sh_degree: int = 3,
    background: Optional[torch.Tensor] = None,
    near: float = 0.01,
    far=1e10,
    render_depth: bool = False,
    means2d_offset: Optional[torch.Tensor] = None,   # (N, 2) zeros; grad = densify stats
    plain: bool = False,
    budget: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Render one camera; the result keys of ``rasterize_gaussians_pallas``
    (its ``mask`` of inactive slots has no counterpart: every row is live),
    plus ``n_pairs``. With a pair ``budget`` the pair build is
    :func:`tile_pairs`'s static one, ``n_pairs`` is a (1,) device count and
    ``n_overflow`` the (1,) int32 count of candidates past the budget: a
    render whose ``n_overflow`` is not 0 is incomplete."""
    if background is None:
        background = torch.ones(3, dtype=torch.float32, device=means3d.device)
    ch = project_gaussians_ch(means3d, quats, scales, viewmat, K, width, height, near, far)
    mean_x, mean_y = ch["mean_x"], ch["mean_y"]
    radius, valid, depth = ch["radius"], ch["valid"], ch["depth"]
    if means2d_offset is not None:
        mean_x = mean_x + means2d_offset[:, 0]
        mean_y = mean_y + means2d_offset[:, 1]

    cam_pos = -(viewmat[:3, :3].T @ viewmat[:3, 3])
    d = means3d - cam_pos
    dn = torch.clamp(torch.sqrt((d * d).sum(-1)), min=1e-8)
    colors = torch.clamp(eval_sh_ch(sh_colors, d[:, 0] / dn, d[:, 1] / dn, d[:, 2] / dn,
                                    sh_degree) + 0.5, min=0.0)          # (3, N)
    packed = torch.stack([mean_x, mean_y, ch["conic_a"], ch["conic_b"], ch["conic_c"],
                          opacities, colors[0], colors[1], colors[2], depth], dim=-1)

    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    pairs = tile_pairs(mean_x, mean_y, ch["conic_a"], ch["conic_b"], ch["conic_c"], opacities,
                       radius, valid, depth, width, height, budget=budget)
    pair_gauss, bounds = pairs[:2]
    out = composite(packed, pair_gauss, bounds, tiles_x, plain=plain)

    T = torch.exp(out[..., 5])
    rgb = out[..., 0:3] + T[..., None] * background
    alpha = 1.0 - T
    zero = torch.zeros((), dtype=torch.int64, device=means3d.device)
    result = {
        "render": tiles_to_image(rgb, tiles_x, tiles_y, width, height),
        "alpha": tiles_to_image(alpha[..., None], tiles_x, tiles_y, width, height)[..., 0],
        "radii": radius,
        "means2d": torch.stack([mean_x, mean_y], dim=-1),
        "visibility": valid & (radius > 0),
        "n_truncated": zero,
        "n_truncated_depth": zero,
        "n_pairs": pair_gauss.shape[0] if budget is None else bounds[-1:],
    }
    if budget is not None:
        result["n_overflow"] = pairs[2]
    if render_depth:
        dtile = out[..., 4] / torch.clamp(alpha, min=1e-10)
        result["depth"] = tiles_to_image(dtile[..., None], tiles_x, tiles_y, width, height)[..., 0]
    return result
