"""K3's culling on the CPU: ``face_setup_plain``'s boxes hold every pixel the
brute-force plain version covers, a rasterization restricted to the boxes
equals ``rasterize_meshes_plain`` bit for bit (ragged sizes, equal z across
tiles and chunks), the EMPTY and WHOLE classes, the plain version against
``cap4d_tpu``'s XLA and Pallas (interpret mode) rasterizers, and the
wrapper's refusals. The kernel itself runs only on the card (chip_smoke.py's
``rasterize`` phase)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_torch.ops import rasterize as R
from cap4d_torch.ops.rasterize import (BOX, EMPTY, EMPTY_BOX, WHOLE, face_setup_plain,
                                       pixel_centers_ndc, rasterize_meshes_plain)
from cap4d_torch.utils.synthetic_assets import RASTER_TILE, raster_edge_cases
from cap4d_tpu.ops.rasterize import rasterize_meshes as jax_rasterize
from cap4d_tpu.ops.rasterize import rasterize_meshes_pallas
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
SIZES = [(1, 1), (17, 23), (120, 200)]   # no side a multiple of the 16-pixel tile but 1


def _cases(size, n_large=150):
    with np.errstate(all="ignore"):
        cases = raster_edge_cases(*size, n_large=n_large)
    return {k: (torch.from_numpy(v), torch.from_numpy(f)) for k, (v, f) in cases.items()}


def _random_mesh(seed, n_frames=2, n_verts=60, n_faces=150):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-1.3, 1.3, size=(n_frames, n_verts, 3)).astype(np.float32)
    verts[..., 2] = rng.uniform(0.5, 3.0, size=(n_frames, n_verts))
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int32)
    return torch.from_numpy(verts), torch.from_numpy(faces)


def _tests(verts, faces, size, chunk=64):
    """(f0, inside (B, P, C), z, b0, b1, b2) per chunk of faces, in
    ``rasterize_meshes_plain``'s arithmetic."""
    xs, ys = pixel_centers_ndc(*size)
    px = xs[None, :].expand(*size).reshape(1, -1, 1)
    py = ys[:, None].expand(*size).reshape(1, -1, 1)
    faces = faces.long()
    for f0 in range(0, faces.shape[0], chunk):
        fv = verts[:, faces[f0 : f0 + chunk]]
        x0, y0, z0 = (fv[:, None, :, 0, i] for i in range(3))
        x1, y1, z1 = (fv[:, None, :, 1, i] for i in range(3))
        x2, y2, z2 = (fv[:, None, :, 2, i] for i in range(3))
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        ok = area != 0.0
        inv = torch.where(ok, torch.reciprocal(area), torch.zeros_like(area))
        b0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv
        b1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv
        b2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & ok
        yield f0, inside, b0 * z0 + b1 * z1 + b2 * z2, b0, b1, b2


def _in_box(boxes, size, f0, n):
    """(B, P, n) whether each pixel lies in the box of faces f0 .. f0 + n."""
    h, w = size
    bx = boxes[:, None, f0 : f0 + n].long()                      # (B, 1, n, 4)
    col = torch.arange(w).repeat(h).reshape(1, -1, 1)
    row = torch.arange(h).repeat_interleave(w).reshape(1, -1, 1)
    return (col >= bx[..., 0]) & (col <= bx[..., 1]) & (row >= bx[..., 2]) & (row <= bx[..., 3])


KCOORD, KINV_MIN, KINV_MAX = 2.0 ** 60, 2.0 ** -99, 2.0 ** 99
KCORNER_SCALE, KCORNER_FLOOR = 2.0 ** -20, 2.0 ** -140
SUB_W, SUB_H = 8, 4   # a warp's sub-tile in rasterize.cu


def _cannot_pass(records, size):
    """(B, F, rows, cols) of 8×4 sub-tiles: K3's sub-tile rule, in the
    kernel's float operations: one edge's b at its best corner centre lies
    below -beta, so no pixel of the sub-tile can pass."""
    h, w = size
    xs, ys = pixel_centers_ndc(h, w)
    c0 = torch.arange(0, w, SUB_W)
    r0 = torch.arange(0, h, SUB_H)
    px_hi, px_lo = xs[c0], xs[(c0 + SUB_W - 1).clamp(max=w - 1)]
    py_hi, py_lo = ys[r0], ys[(r0 + SUB_H - 1).clamp(max=h - 1)]
    px_hi, px_lo = px_hi[None, None, None, :], px_lo[None, None, None, :]
    py_hi, py_lo = py_hi[None, None, :, None], py_lo[None, None, :, None]
    r = records[..., None, None]                                   # (B, F, 16, 1, 1)
    x0, y0, x1, y1, x2, y2 = r[:, :, 0], r[:, :, 1], r[:, :, 3], r[:, :, 4], r[:, :, 6], r[:, :, 7]
    inv = r[:, :, 9]
    coords = [c.abs() for c in (x0, y0, x1, y1, x2, y2)]
    ok = (inv.abs() >= KINV_MIN) & (inv.abs() <= KINV_MAX)
    cmax = coords[0]
    for c in coords:
        ok = ok & (c <= KCOORD)
        cmax = torch.maximum(cmax, c)
    wx = torch.maximum(torch.maximum(x0, x1), x2) - torch.minimum(torch.minimum(x0, x1), x2)
    wy = torch.maximum(torch.maximum(y0, y1), y2) - torch.minimum(torch.minimum(y0, y1), y2)
    spread = (wx + wy) * (1.0 + cmax)
    beta = (spread * KCORNER_SCALE + KCORNER_FLOOR) * inv.abs() + KINV_MIN
    pos = inv > 0
    out = torch.zeros(ok.shape[:2] + (len(r0), len(c0)), dtype=torch.bool)
    for dx, dy, xb, yb in ((r[:, :, 10], r[:, :, 11], x1, y1), (r[:, :, 12], r[:, :, 13], x2, y2),
                           (r[:, :, 14], r[:, :, 15], x0, y0)):
        py = torch.where((dx > 0) == pos, py_hi, py_lo)
        px = torch.where((dy > 0) == pos, px_lo, px_hi)
        out = out | ((dx * (py - yb) - dy * (px - xb)) * inv < -beta)
    return out & ok


def _passable(records, size, f0, n):
    """(B, P, n): whether each pixel's sub-tile is not ruled out for faces
    f0 .. f0 + n by ``_cannot_pass``."""
    h, w = size
    cannot = _cannot_pass(records[:, f0 : f0 + n], size)             # (B, n, rows, cols)
    row = (torch.arange(h) // SUB_H).repeat_interleave(w)
    col = (torch.arange(w) // SUB_W).repeat(h)
    return ~cannot[:, :, row, col].transpose(1, 2)


def _box_restricted(verts, faces, size):
    """The plain rasterization with each face tested only inside its box and
    in the sub-tiles that ``_cannot_pass`` does not rule out, as K3 does."""
    setup = face_setup_plain(verts, faces, size)
    B, n_pix = verts.shape[0], size[0] * size[1]
    best_z = torch.full((B, n_pix), float("inf"))
    best_f = torch.full((B, n_pix), -1, dtype=torch.int32)
    best_b = torch.zeros((B, n_pix, 3))
    for f0, inside, z, b0, b1, b2 in _tests(verts, faces, size):
        n = z.shape[-1]
        inside = inside & _in_box(setup.boxes, size, f0, n) & _passable(setup.records, size, f0, n)
        z = torch.where(inside, z, torch.full_like(z, float("inf")))
        c_z, c_arg = torch.min(z, dim=2)
        take = c_z < best_z
        best_z = torch.where(take, c_z, best_z)
        best_f = torch.where(take, (c_arg + f0).to(torch.int32), best_f)
        c_b = torch.stack([t.gather(2, c_arg[..., None])[..., 0] for t in (b0, b1, b2)], -1)
        best_b = torch.where(take[..., None], c_b, best_b)
    return best_f.reshape(B, *size), best_z.reshape(B, *size), best_b.reshape(B, *size, 3)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("size", [(17, 23), (120, 200)])
@pytest.mark.parametrize("case", ["random_mesh", "straddle_z0", "extreme", "zero_area",
                                  "slivers", "whole", "ties", "random"])
def test_boxes_hold_every_covered_pixel(case, size):
    """Every (pixel, face) the brute-force plain version covers lies in the
    face's box and in a sub-tile the corner rule keeps, and every box in its
    group's box, on random meshes and on every edge case."""
    verts, faces = _random_mesh(3) if case == "random_mesh" else _cases(size)[case]
    setup = face_setup_plain(verts, faces, size)
    n_covered = 0
    n_ruled_out = 0
    for f0, inside, *_ in _tests(verts, faces, size):
        in_box = _in_box(setup.boxes, size, f0, inside.shape[-1])
        assert not bool((inside & ~in_box).any()), (case, f0, int((inside & ~in_box).sum()))
        passable = _passable(setup.records, size, f0, inside.shape[-1])
        assert not bool((inside & ~passable).any()), (case, f0, int((inside & ~passable).sum()))
        n_covered += int(inside.sum())
        n_ruled_out += int((in_box & ~passable).sum())
    assert n_covered > 0 or case == "zero_area"
    assert n_ruled_out > 0 or case in ("zero_area", "whole", "ties", "extreme")
    empty_box = torch.tensor(EMPTY_BOX, dtype=torch.int16)
    assert not bool(((setup.cls == EMPTY) & (setup.boxes != empty_box).any(-1)).any())
    # every box that holds a pixel lies in the box of its group of GROUP faces
    group = setup.groups[:, torch.arange(faces.shape[0]) // R.GROUP].long()
    box = setup.boxes.long()
    live = (box[..., 1] >= box[..., 0]) & (box[..., 3] >= box[..., 2])
    inside = ((group[..., 0] <= box[..., 0]) & (group[..., 1] >= box[..., 1])
              & (group[..., 2] <= box[..., 2]) & (group[..., 3] >= box[..., 3]))
    assert bool((inside | ~live).all())


@pytest.mark.parametrize("size", SIZES)
def test_box_restricted_raster_equals_plain(size):
    """Restricting each face to its box changes nothing, bit for bit, at
    sizes no tile divides, over every edge case and a random mesh."""
    meshes = list(_cases(size).values()) + [_random_mesh(4)]
    for verts, faces in meshes:
        ref = rasterize_meshes_plain(verts, faces, size)
        p2f, z, bary = _box_restricted(verts, faces, size)
        assert torch.equal(p2f, ref.pix_to_face)
        assert torch.equal(_bits(z), _bits(ref.zbuf))
        assert torch.equal(_bits(bary), _bits(ref.bary_coords))


def test_face_classes():
    """EMPTY for zero area and a NaN x or y (or an inf that makes the area
    NaN); WHOLE for an infinite or overflowing area, a coordinate past
    COORD_MAX and an area too small for the box argument; BOX otherwise."""
    nan, inf = float("nan"), float("inf")
    tris = [
        ([[-0.5, -0.5], [-0.5, -0.5], [0.5, 0.5]], EMPTY),      # repeated vertex
        ([[-0.5, -0.5], [0.0, 0.0], [0.5, 0.5]], EMPTY),        # collinear
        ([[nan, -0.5], [0.5, -0.5], [0.0, 0.5]], EMPTY),
        ([[-0.5, -0.5], [0.5, nan], [0.0, 0.5]], EMPTY),
        ([[inf, -0.5], [0.5, -0.5], [0.0, 0.5]], EMPTY),        # 0 * inf: area NaN
        ([[inf, 0.0], [0.5, 0.5], [-0.5, -0.5]], WHOLE),        # area +inf
        ([[-0.5, -0.5], [0.5, -inf], [0.0, 0.5]], WHOLE),
        ([[-1e19, -1e19], [1e19, -1e19], [-1e19, 1e19]], WHOLE),  # area overflows
        ([[-0.9, 0.1], [0.9, 0.1], [0.0, 0.1 + 1e-7]], WHOLE),  # below the trusted |area|
        ([[-2e18, 0.0], [2e18, 0.0], [0.0, 1e-12]], WHOLE),     # past COORD_MAX
        ([[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]], BOX),
        ([[3.0, 3.0], [3.5, 3.0], [3.2, 3.5]], BOX),            # off the image: empty box
    ]
    xy = torch.tensor([t for t, _ in tris], dtype=torch.float32)
    verts = torch.cat([xy, torch.full((len(tris), 3, 1), -1.0)], -1).reshape(1, -1, 3)
    faces = torch.arange(verts.shape[1], dtype=torch.int32).reshape(-1, 3)
    size = (8, 10)
    setup = face_setup_plain(verts, faces, size)
    assert setup.cls[0].tolist() == [c for _, c in tris]
    whole = torch.tensor([0, size[1] - 1, 0, size[0] - 1], dtype=torch.int16)
    empty = torch.tensor(EMPTY_BOX, dtype=torch.int16)
    for i, (_, c) in enumerate(tris):
        if c != BOX:
            assert torch.equal(setup.boxes[0, i], whole if c == WHOLE else empty), i
    # the unit triangle's box: columns whose centre lies in x [-0.5, 0.5] are
    # 2..7 of 10, rows in y [-0.5, 0.5] 2..5 of 8, each widened by one
    assert setup.boxes[0, 10].tolist() == [1, 8, 1, 6]
    assert torch.equal(setup.boxes[0, 11], empty)
    # an overflowing area makes 1/area 0 and every b +-0: it covers every pixel
    alone = rasterize_meshes_plain(verts, faces[7:8], size)
    assert bool((alone.pix_to_face == 0).all()) and bool((alone.zbuf == 0).all())


def test_equal_z_lowest_index_across_tiles_and_chunks():
    """The ``ties`` case: one z = 0 face repeated at indices 5, 70, 1030 and
    2100 (other 64-face chunks and 1,024-face rounds) across several tiles,
    beside another z = 0 face at 40: the lowest index wins everywhere."""
    size = (64, 96)
    verts, faces = _cases(size)["ties"]
    ref = rasterize_meshes_plain(verts, faces, size)
    assert set(torch.unique(ref.pix_to_face).tolist()) == {-1, 5, 40}
    first = ref.pix_to_face == 5
    assert int(first.sum()) > 4 * RASTER_TILE ** 2           # spans several tiles
    p2f, z, _ = _box_restricted(verts, faces, size)
    assert torch.equal(p2f, ref.pix_to_face) and torch.equal(_bits(z), _bits(ref.zbuf))
    for chunk in (7, 64, 1024):
        again = rasterize_meshes_plain(verts, faces, size, chunk)
        assert torch.equal(again.pix_to_face, ref.pix_to_face)


def _compare(frag, jfrag, min_agree):
    p = frag.pix_to_face.numpy()
    jp = np.asarray(jfrag.pix_to_face)
    assert (p == jp).mean() >= min_agree, (p == jp).mean()
    m = (p == jp) & (jp >= 0)
    np.testing.assert_allclose(frag.zbuf.numpy()[m], np.asarray(jfrag.zbuf)[m], atol=1e-5)
    np.testing.assert_allclose(frag.bary_coords.numpy()[m], np.asarray(jfrag.bary_coords)[m],
                               atol=1e-5)


@pytest.mark.parametrize("case", ["random", "whole", "random_mesh"])
def test_plain_matches_jax(case):
    """The plain version against the XLA scan and the Pallas kernel in
    interpret mode on ordinary meshes; edge pixels may flip where XLA's CPU
    code contracts to FMA."""
    size = (32, 48)
    verts, faces = _random_mesh(5) if case == "random_mesh" else _cases(size, n_large=60)[case]
    frag = rasterize_meshes_plain(verts, faces, size)
    jv, jf = jnp.asarray(verts.numpy()), jnp.asarray(faces.numpy())
    _compare(frag, jax_rasterize(jv, jf, size, chunk=16), 0.995)
    _compare(frag, rasterize_meshes_pallas(jv, jf, size, interpret=True), 0.995)


@pytest.mark.parametrize("verts_shape, verts_dtype, faces, size", [
    ((2, 5, 3), torch.float64, [[0, 1, 2]], (8, 8)),
    ((2, 5, 2), torch.float32, [[0, 1, 2]], (8, 8)),
    ((5, 3), torch.float32, [[0, 1, 2]], (8, 8)),
    ((2, 5, 3), torch.float32, [[0, 1, 2, 3]], (8, 8)),
    ((2, 5, 3), torch.float32, [[0.0, 1.0, 2.0]], (8, 8)),
    ((2, 5, 3), torch.float32, [[0, 1, 2]], (0, 8)),
    ((2, 5, 3), torch.float32, [[0, 1, 2]], (8, R.MAX_SIDE + 1)),
    ((0, 5, 3), torch.float32, [[0, 1, 2]], (8, 8)),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(verts_shape, verts_dtype, faces, size):
    verts = torch.zeros(verts_shape, dtype=verts_dtype)
    with pytest.raises(ValueError):
        R._check_kernel_inputs(verts, torch.tensor(faces), size)
    R._check_kernel_inputs(torch.zeros((2, 5, 3)), torch.tensor([[0, 1, 2]]), (8, R.MAX_SIDE))


def test_constants_match_the_kernel_source():
    """The box argument's constants and the tile, as rasterize.cu has them."""
    src = (REPO / "cap4d_torch" / "csrc" / "rasterize.cu").read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert float.fromhex(const("kCoordMax").rstrip("f")) == R.COORD_MAX
    assert float.fromhex(const("kAreaMin").rstrip("f")) == R.AREA_MIN
    assert float.fromhex(const("kAreaMax").rstrip("f")) == R.AREA_MAX
    assert float.fromhex(const("kErrScale").rstrip("f")) == R.ERR_SCALE
    assert float.fromhex(const("kErrFloor").rstrip("f")) == R.ERR_FLOOR
    assert float.fromhex(const("kInvMin").rstrip("f")) == KINV_MIN
    assert float.fromhex(const("kInvMax").rstrip("f")) == KINV_MAX
    assert float.fromhex(const("kCornerScale").rstrip("f")) == KCORNER_SCALE
    assert float.fromhex(const("kCornerFloor").rstrip("f")) == KCORNER_FLOOR
    assert int(const("kTile")) == RASTER_TILE
    assert f"at most {R.MAX_SIDE} a side" in src
