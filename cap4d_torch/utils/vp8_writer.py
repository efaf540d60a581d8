"""A VP8 syntax writer for the decoder's tests: the header-level tools that
no libvpx encoder setting emits (RFC 6386).

What it writes: key frames with ``color_space`` and ``clamping_type`` 1 and
a size other than the last; segmentation with absolute and delta data, the
quantiser and loop-filter features, and a map kept from the frame before;
``mb_no_coeff_skip`` 0; every ``copy_buffer_to_gf`` / ``copy_buffer_to_arf``
value, with the two copies in one frame (where libvpx's decoder and ffmpeg
part: ffmpeg copies the buffers as they stood before the frame);
loop-filter delta updates and sharpness; two and four token partitions; all
five quantiser deltas; intra-mode probability updates, saved and dropped
again by ``refresh_entropy_probs`` 0; new vectors that reach far past the
frame's edges; a hidden frame; a frame of a reserved version (5), which
ffmpeg decodes as versions 1 and 2 are decoded. Macroblocks stay simple: random 16x16 and
B_PRED intra modes, and ZERO, NEAREST, NEAR and NEW inter modes (the
writer runs the decoder's near-vector search to code them), each with a
DC coefficient in the Y2 block (or in each Y block of a B_PRED macroblock)
and in each chroma block.

The probability tables are read from the decoder's source
(``runtime/vp8.cpp``): the writer shares them, so only the comparison with
ffmpeg checks them. :func:`tools_stream` returns the samples; the tests mux
them into WebM (``tests/data/vp8/``) and hold the decode to ffmpeg's
planes, whose SHA-256 :data:`PINNED_SHA256` keeps for ``chip_smoke.py``.
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cap4d_torch.utils.vp9_writer import BoolEncoder as _Vp9BoolEncoder

_SOURCE = Path(__file__).resolve().parent.parent / "runtime" / "vp8.cpp"
DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED = range(5)
YMODE_TREE = (-DC_PRED, 2, 4, 6, -V_PRED, -H_PRED, -TM_PRED, -B_PRED)
KF_YMODE_TREE = (-B_PRED, 2, 4, 6, -DC_PRED, -V_PRED, -H_PRED, -TM_PRED)
UV_MODE_TREE = (-DC_PRED, 2, -V_PRED, 4, -H_PRED, -TM_PRED)
BMODE_TREE = (0, 2, -1, 4, -2, 6, 8, 12, -3, 10, -5, -6, -4, 14, -7, 16, -8, -9)
SMALL_MV_TREE = (2, 8, 4, 6, 0, -1, -2, -3, 10, 12, -4, -5, -6, -7)
SEGMENT_TREE = (2, 4, 0, -1, -2, -3)
IMPLIED_BMODE = (0, 2, 3, 1)        # B_DC, B_VE, B_HE, B_TM for DC, V, H, TM
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CATS = ((3, 11, (173, 148, 140)), (4, 19, (176, 155, 140, 135)),
        (5, 35, (180, 157, 141, 134, 130)),
        (11, 67, (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129)))
ZERO, MV, SPLIT = 1, 2, 3           # the inter modes' places in the loop filter's mode deltas

_NAMES = ("kDefaultCoefProbs", "kCoefUpdateProbs", "kKfBmodeProbs", "kKfYmodeProbs",
          "kKfUvModeProbs", "kYmodeProbs", "kUvModeProbs", "kBmodeProbs", "kMvDefaultProbs",
          "kMvUpdateProbs", "kModeContexts")


def _tables() -> Dict[str, np.ndarray]:
    """The decoder's uint8 constant tables the writer uses, by name."""
    src = _SOURCE.read_text()
    out = {}
    for m in re.finditer(r"const uint8_t (k\w+)((?:\[\d+\])+) = \{(.*?)\};", src, re.S):
        if m.group(1) in _NAMES:
            dims = [int(d) for d in re.findall(r"\[(\d+)\]", m.group(2))]
            out[m.group(1)] = np.array([int(v) for v in re.findall(r"\d+", m.group(3))],
                                       np.int64).reshape(dims)
    missing = set(_NAMES) - set(out)
    if missing:
        raise RuntimeError(f"{_SOURCE} has no table {sorted(missing)}")
    return out


_T = _tables()


class BoolEncoder(_Vp9BoolEncoder):
    """RFC 6386's boolean encoder (VP9's without its leading marker bit)."""

    def __init__(self):
        self.low, self.range, self.count = 0, 255, -24
        self.buf = bytearray()


@dataclass
class Frame:
    """One frame's header fields (RFC 6386 section 9 names) and the seed of
    its macroblocks."""

    key: bool = False
    show: bool = True
    version: int = 0
    size: Optional[Tuple[int, int]] = None        # a key frame's (width, height)
    scale: Tuple[int, int] = (0, 0)
    color_space: int = 0
    clamping_type: int = 0
    segmentation: Optional[dict] = None           # update_map, update_data, absolute, quant, lf
    simple: bool = False
    level: int = 20
    sharpness: int = 0
    lf_delta: Optional[dict] = None               # update: (ref[4], mode[4]) or None
    log2parts: int = 0
    q: int = 40
    q_deltas: Tuple[int, ...] = (0, 0, 0, 0, 0)   # y1dc, y2dc, y2ac, uvdc, uvac
    refresh_golden: bool = False
    refresh_altref: bool = False
    copy_golden: int = 0
    copy_altref: int = 0
    sign_bias: Tuple[int, int] = (0, 0)
    refresh_entropy: bool = True
    refresh_last: bool = True
    skip_prob: Optional[int] = 200                # None: mb_no_coeff_skip 0
    probs: Tuple[int, int, int] = (60, 128, 128)  # prob_intra, prob_last, prob_gf
    ymode_probs: Optional[Sequence[int]] = None
    uv_probs: Optional[Sequence[int]] = None
    refs: Tuple[int, ...] = (1,)                  # the references the inter macroblocks take
    far: bool = False                             # new vectors far past the edges
    seed: int = 0


@dataclass
class _Mb:
    ref: int = 0
    mv: Tuple[int, int] = (0, 0)                  # (x, y) in quarter samples


class Writer:
    """Codes :class:`Frame` s into VP8 samples, keeping the decoder's state
    (probabilities, segmentation, the macroblock grid of the frame)."""

    def __init__(self):
        self.width = self.height = 0
        self.seg_map: List[int] = []

    def _reset_probs(self) -> None:
        self.coef = _T["kDefaultCoefProbs"].copy()
        self.ymode = list(_T["kYmodeProbs"])
        self.uv = list(_T["kUvModeProbs"])
        self.mvp = _T["kMvDefaultProbs"].copy()
        self.seg_enabled = False

    def frame(self, f: Frame) -> bytes:
        rng = random.Random(f.seed)
        if f.key:
            self.width, self.height = f.size
            self.mbw, self.mbh = (self.width + 15) // 16, (self.height + 15) // 16
            self.seg_map = [0] * (self.mbw * self.mbh)
            self._reset_probs()
        e = BoolEncoder()
        if f.key:
            e.write(f.color_space, 128)
            e.write(f.clamping_type, 128)
        seg = f.segmentation
        self.seg_enabled = seg is not None
        e.write(int(seg is not None), 128)
        if seg is not None:
            e.write(int(seg["update_map"]), 128)
            e.write(int(seg["update_data"]), 128)
            if seg["update_data"]:
                e.write(int(seg["absolute"]), 128)
                for v, bits in [(v, 7) for v in seg["quant"]] + [(v, 6) for v in seg["lf"]]:
                    self._sint(e, bits, v)
            if seg["update_map"]:
                self.seg_probs = seg.get("probs", (120, 90, 160))
                for p in self.seg_probs:
                    e.write(1, 128)
                    e.literal(8, p)
        e.write(int(f.simple), 128)
        e.literal(6, f.level)
        e.literal(3, f.sharpness)
        e.write(int(f.lf_delta is not None), 128)
        if f.lf_delta is not None:
            update = f.lf_delta.get("update")
            e.write(int(update is not None), 128)
            if update is not None:
                for v in list(update[0]) + list(update[1]):
                    e.write(int(v != 0), 128)
                    if v:
                        e.literal(6, abs(v))
                        e.write(int(v < 0), 128)
        e.literal(2, f.log2parts)
        e.literal(7, f.q)
        for d in f.q_deltas:
            self._sint(e, 4, d)
        if not f.key:
            e.write(int(f.refresh_golden), 128)
            e.write(int(f.refresh_altref), 128)
            if not f.refresh_golden:
                e.literal(2, f.copy_golden)
            if not f.refresh_altref:
                e.literal(2, f.copy_altref)
            e.write(f.sign_bias[0], 128)
            e.write(f.sign_bias[1], 128)
            self.sign_bias = (0, 0, f.sign_bias[0], f.sign_bias[1])
        e.write(int(f.refresh_entropy), 128)
        saved = (self.coef.copy(), list(self.ymode), list(self.uv), self.mvp.copy())
        if not f.key:
            e.write(int(f.refresh_last), 128)
        for p in _T["kCoefUpdateProbs"].reshape(-1):      # no coefficient updates
            e.write(0, int(p))
        e.write(int(f.skip_prob is not None), 128)
        if f.skip_prob is not None:
            e.literal(8, f.skip_prob)
        if not f.key:
            for p in f.probs:
                e.literal(8, p)
            for probs, mine in ((f.ymode_probs, self.ymode), (f.uv_probs, self.uv)):
                e.write(int(probs is not None), 128)
                if probs is not None:
                    for i, p in enumerate(probs):
                        e.literal(8, p)
                        mine[i] = p
            for p in _T["kMvUpdateProbs"].reshape(-1):    # no vector probability updates
                e.write(0, int(p))
        parts = [BoolEncoder() for _ in range(1 << f.log2parts)]
        self._macroblocks(f, rng, e, parts)
        if not f.refresh_entropy:
            self.coef, self.ymode, self.uv, self.mvp = saved
        first = e.bytes()
        tokens = [p.bytes() for p in parts]
        tag = (0 if f.key else 1) | (f.version << 1) | (int(f.show) << 4) | (len(first) << 5)
        out = bytearray(tag.to_bytes(3, "little"))
        if f.key:
            out += b"\x9d\x01\x2a"
            out += (self.width | f.scale[0] << 14).to_bytes(2, "little")
            out += (self.height | f.scale[1] << 14).to_bytes(2, "little")
        out += first
        for t in tokens[:-1]:
            out += len(t).to_bytes(3, "little")
        for t in tokens:
            out += t
        return bytes(out)

    @staticmethod
    def _sint(e: BoolEncoder, bits: int, v: int) -> None:
        e.write(int(v != 0), 128)
        if v:
            e.literal(bits, abs(v))
            e.write(int(v < 0), 128)

    # ---------------------------------------------------------- macroblocks --

    def _macroblocks(self, f: Frame, rng: random.Random, e: BoolEncoder,
                     parts: List[BoolEncoder]) -> None:
        mbw, mbh = self.mbw, self.mbh
        grid = [[_Mb() for _ in range(mbw + 1)] for _ in range(mbh + 1)]   # border first
        above_b = [0] * (4 * mbw)
        above_nz = [[0] * 9 for _ in range(mbw)]
        seg = f.segmentation
        for y in range(mbh):
            left_b = [0] * 4
            left_nz = [0] * 9
            tok = parts[y % len(parts)]
            for x in range(mbw):
                if seg is not None and seg["update_map"]:
                    s = rng.randrange(4)
                    self.seg_map[y * mbw + x] = s
                    e.tree(SEGMENT_TREE, self.seg_probs, s)
                skip = f.skip_prob is not None and rng.random() < 0.2
                if f.skip_prob is not None:
                    e.write(int(skip), f.skip_prob)
                m = grid[y + 1][x + 1]
                bpred = False
                if f.key:
                    ymode = rng.choice([DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED])
                    e.tree(KF_YMODE_TREE, _T["kKfYmodeProbs"], ymode)
                    top = above_b[4 * x:4 * x + 4]
                    if ymode == B_PRED:
                        bpred = True
                        for by in range(4):
                            for bx in range(4):
                                b = rng.randrange(10)
                                e.tree(BMODE_TREE, _T["kKfBmodeProbs"][top[bx]][left_b[by]], b)
                                top[bx] = left_b[by] = b
                    else:
                        top = [IMPLIED_BMODE[ymode]] * 4
                        left_b = [IMPLIED_BMODE[ymode]] * 4
                    above_b[4 * x:4 * x + 4] = top
                    e.tree(UV_MODE_TREE, _T["kKfUvModeProbs"], rng.randrange(4))
                elif rng.random() < 0.25:          # intra in an inter frame
                    e.write(0, f.probs[0])
                    ymode = rng.choice([DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED])
                    e.tree(YMODE_TREE, self.ymode, ymode)
                    if ymode == B_PRED:
                        bpred = True
                        for _ in range(16):
                            e.tree(BMODE_TREE, _T["kBmodeProbs"], rng.randrange(10))
                    e.tree(UV_MODE_TREE, self.uv, rng.randrange(4))
                else:
                    e.write(1, f.probs[0])
                    m.ref = rng.choice(f.refs)
                    e.write(int(m.ref != 1), f.probs[1])
                    if m.ref != 1:
                        e.write(int(m.ref == 3), f.probs[2])
                    self._inter_mode(f, rng, e, grid, x, y, m)
                self._tokens(tok, rng, above_nz[x], left_nz, skip, bpred,
                             self.seg_map[y * mbw + x] if self.seg_enabled else 0)

    def _inter_mode(self, f: Frame, rng: random.Random, e: BoolEncoder, grid, x: int, y: int,
                    m: _Mb) -> None:
        """The decoder's near-vector search (ffmpeg's vp8_decode_mvs), then a
        random mode among ZERO, NEAREST, NEAR and NEW coded with its counts."""
        ctx = _T["kModeContexts"]
        near = [(0, 0)] * 4
        cnt = [0, 0, 0, 0]
        idx = 0
        for n, edge in enumerate((grid[y][x + 1], grid[y + 1][x], grid[y][x])):
            if not edge.ref:
                continue
            mv = edge.mv
            if mv != (0, 0):
                if self.sign_bias[m.ref] != self.sign_bias[edge.ref]:
                    mv = (-mv[0], -mv[1])
                if not n or mv != near[idx]:
                    idx += 1
                    near[idx] = mv
                cnt[idx] += 1 + (n != 2)
            else:
                cnt[0] += 1 + (n != 2)
        mode = rng.choice(["zero", "nearest", "near", "new", "new"])
        e.write(int(mode != "zero"), int(ctx[cnt[0]][0]))
        if mode == "zero":
            m.mv = (0, 0)
            return
        if cnt[3] and near[1] == near[3]:
            cnt[1] += 1
        if cnt[2] > cnt[1]:
            cnt[1], cnt[2] = cnt[2], cnt[1]
            near[1], near[2] = near[2], near[1]
        e.write(int(mode != "nearest"), int(ctx[cnt[1]][1]))
        if mode == "nearest":
            m.mv = self._clamp(near[1], x, y)
            return
        e.write(int(mode != "near"), int(ctx[cnt[2]][2]))
        if mode == "near":
            m.mv = self._clamp(near[2], x, y)
            return
        best = self._clamp(near[1 if cnt[1] >= cnt[0] else 0], x, y)
        e.write(0, int(ctx[0][3]))        # no SPLITMV: the split context is 0 here
        reach = 400 if f.far else 24
        delta = (rng.randint(-reach, reach), rng.randint(-reach, reach))
        self._mv_component(e, delta[1], 0)
        self._mv_component(e, delta[0], 1)
        m.mv = (best[0] + delta[0], best[1] + delta[1])

    def _clamp(self, mv, x, y):
        return (min(max(mv[0], -64 * (x + 1)), 64 * (self.mbw - x)),
                min(max(mv[1], -64 * (y + 1)), 64 * (self.mbh - y)))

    def _mv_component(self, e: BoolEncoder, v: int, comp: int) -> None:
        p = [int(q) for q in self.mvp[comp]]
        a = abs(v)
        if a < 8:
            e.write(0, p[0])
            e.tree(SMALL_MV_TREE, p[2:9], a)
        else:
            e.write(1, p[0])
            for i in range(3):
                e.write((a >> i) & 1, p[9 + i])
            for i in range(9, 3, -1):
                e.write((a >> i) & 1, p[9 + i])
            if a & 0xFFF0:
                e.write((a >> 3) & 1, p[12])
        if a:
            e.write(int(v < 0), p[1])

    # --------------------------------------------------------------- tokens --

    def _tokens(self, e: BoolEncoder, rng: random.Random, top: List[int], left: List[int],
                skip: bool, bpred: bool, segment: int) -> None:
        if skip:
            top[:8] = [0] * 8
            left[:8] = [0] * 8
            if not bpred:
                top[8] = left[8] = 0
            return
        first, kind = 0, 3
        if not bpred:
            n = self._block(e, self.coef[1], 0, top[8] + left[8], {0: rng.randint(-300, 300)})
            top[8] = left[8] = n
            first, kind = 1, 0
        for by in range(4):
            for bx in range(4):
                levels = {0: rng.randint(-40, 40)} if bpred and rng.random() < 0.5 else {}
                n = self._block(e, self.coef[kind], first, top[bx] + left[by], levels)
                top[bx] = left[by] = n
        for c in range(2):
            for by in range(2):
                for bx in range(2):
                    levels = {0: rng.randint(-30, 30)} if rng.random() < 0.6 else {}
                    t, l = 4 + 2 * c + bx, 4 + 2 * c + by
                    n = self._block(e, self.coef[2], 0, top[t] + left[l], levels)
                    top[t] = left[l] = n

    @staticmethod
    def _block(e: BoolEncoder, probs, first: int, ctx: int, levels: Dict[int, int]) -> int:
        """One block's tokens (``levels`` by zigzag position); 1 unless it is
        only an end of block."""
        levels = {i: v for i, v in levels.items() if v and i >= first}
        i = first
        p = probs[BANDS[i]][ctx]
        if not levels:
            e.write(0, int(p[0]))
            return 0
        last = max(levels)
        e.write(1, int(p[0]))
        while True:
            v = levels.get(i, 0)
            if not v:
                e.write(0, int(p[1]))
                i += 1
                p = probs[BANDS[i]][0]
                continue
            e.write(1, int(p[1]))
            a = abs(v)
            if a == 1:
                e.write(0, int(p[2]))
            else:
                e.write(1, int(p[2]))
                if a <= 4:
                    e.write(0, int(p[3]))
                    e.write(int(a > 2), int(p[4]))
                    if a > 2:
                        e.write(int(a == 4), int(p[5]))
                elif a <= 10:
                    e.write(1, int(p[3]))
                    e.write(0, int(p[6]))
                    e.write(int(a > 6), int(p[7]))
                    if a <= 6:
                        e.write(a - 5, 159)
                    else:
                        e.write((a - 7) >> 1, 165)
                        e.write((a - 7) & 1, 145)
                else:
                    e.write(1, int(p[3]))
                    e.write(1, int(p[6]))
                    cat = 0 if a <= 18 else 1 if a <= 34 else 2 if a <= 66 else 3
                    bits, base, cprobs = CATS[cat]
                    e.write(cat >> 1, int(p[8]))
                    e.write(cat & 1, int(p[9 + (cat >> 1)]))
                    for k in range(bits):
                        e.write(((a - base) >> (bits - 1 - k)) & 1, cprobs[k])
            e.write(int(v < 0), 128)
            nxt = 1 if a == 1 else 2
            i += 1
            if i == 16:
                return 1
            p = probs[BANDS[i]][nxt]
            e.write(int(i <= last), int(p[0]))
            if i > last:
                return 1


def tools_stream() -> List[bytes]:
    """The writer's stream: the frames that reach the tools above (see the
    module docstring), as samples in decode order (the seventh is hidden)."""
    w = Writer()
    seg_abs = dict(update_map=True, update_data=True, absolute=True, quant=(20, 40, 60, 90),
                   lf=(10, 20, 30, 40))
    frames = [
        Frame(key=True, size=(80, 48), color_space=1, segmentation=seg_abs,
              sharpness=3, lf_delta=dict(update=((2, -2, 4, -4), (3, -3, 5, -5))), log2parts=1,
              q_deltas=(3, -2, 5, -4, 2), skip_prob=None, seed=1),
        Frame(segmentation=dict(update_map=False, update_data=False), sign_bias=(1, 0),
              ymode_probs=(90, 100, 120, 60), uv_probs=(140, 90, 200), log2parts=2, far=True,
              seed=2),
        Frame(copy_golden=1, refs=(1, 2), seed=11),
        # the golden and alt-ref frames differ here; the two copies exchange them (ffmpeg)
        Frame(copy_golden=2, copy_altref=2, refs=(1, 2, 3), simple=True, level=30, seed=3),
        Frame(copy_altref=1, refs=(2, 3), refresh_entropy=False, ymode_probs=(20, 200, 30, 90),
              sign_bias=(0, 1), seed=4),
        # clamping_type 1 on the last key frame: fewer frames follow it than
        # cv2 has decoder threads (see runtime/vp8.py's full_range)
        Frame(key=True, size=(63, 33), clamping_type=1, segmentation=dict(
            update_map=True, update_data=True, absolute=False, quant=(-10, 0, 8, 20),
            lf=(-8, 0, 6, 12)), level=36, seed=5),
        Frame(refresh_golden=True, refresh_last=False, show=False, refs=(1,), far=True, seed=6),
        Frame(refs=(1, 2), copy_altref=2, q=90, seed=7),
        Frame(version=5, refs=(1, 3), seed=10),
    ]
    return [w.frame(f) for f in frames]


def inter_frame_first() -> bytes:
    """An inter frame with no key frame before it (the decoders refuse it)."""
    w = Writer()
    key = w.frame(Frame(key=True, size=(32, 32), seed=8))
    inter = w.frame(Frame(seed=9))
    del key
    return inter


# SHA-256 of ffmpeg's planes (the Y planes, and the U and V planes, of every picture in
# order: mpeg4_writer.planes_sha256) of each committed file under tests/data/vp8/, by
# its stem: (pictures, (Y, U and V))
PINNED_SHA256: Dict[str, Tuple[int, Tuple[str, str]]] = {
    "cv2_avi": (10, ("43a71f39ba8ee496b12539f0e00ac7e901f0534f0b125efd484e683a20108d99",
                      "7984f2bff80ccb9cd980a03c69e3f9bf1ca4cb08553f65ded265e30939c2d601")),
    "cv2_mkv": (8, ("c4c9182883ec7da776b1a1466b203b07dc777c2559c0be094acb550efd04bb9d",
                      "9312a131c9378d0c879229335ab7e5213a4e65538664df98f12fa9dc88db2f64")),
    "cv2_webm": (8, ("39d961dc6569b6be8a19eb530da15cb27b451c83c2d3d5d91f4a08c2a17f3efb",
                       "429a5770e74c1f94a4d3982e5fc54872d6da3d4ec29f951c9f57016694f1e390")),
    "good_altref": (30, ("4c8bd4aae5b93b4b4dcb36fc8abdc9902292251cba8f145602aaff0b5b772f9f",
                          "dbc47b905bfac8cae96ab0f23d754d5b8e616fdc98e860e2564cf5b2dfd4f910")),
    "load_1080": (16, ("ac23a3d68c4abd416629ba0064208216d990f145b458177c7cb5553e04bf5b6a",
                        "adc46860e1bfc6619fb84ca6a0550b1dd6d6b74b319abe98f5f31881f4569483")),
    "mediarecorder": (16, ("c6b3b5e06e2ae9e877158abb037fb0e6e8e984838ffd81f2db045ddea3b83511",
                            "ca233abc399a73ef2351cfe264728adafc9aaca52636e5d470835270ba726146")),
    "odd": (6, ("38f5506320a73c84a9c43852b12d25771b9e56aba06a09fd6a939451c6c24158",
                  "cd88d3e4c6101d476d05a8263883ace45996839f77ddd701ffba012722fab4a0")),
    "partitions": (6, ("742ea0bbe036862c06b1d13e0533e4427c3a3391cefbdf343ba69c128942c65f",
                         "31fb5f37fe2692086c87d2f834bb88ea099b4486662610efb9e5a4f823e9659a")),
    "resilient": (10, ("a7eeefcabcc46c85660de9f581ea327f94c3fe4ea8822234b7059f797ed05fab",
                        "3498d5c93b5423b6574db59cfa550e6eacdf94b80ad8b782e1e2d6b02448fc77")),
    "resize": (18, ("e6c2710626310bb467ecd1893158f3a18c49637f40b8761c3838917e342973b9",
                     "3e9343575522678c2da99e515f6b9a2ab20ed95c6dcf8d545086e4c316201af4")),
    "rt_static": (16, ("c6b3b5e06e2ae9e877158abb037fb0e6e8e984838ffd81f2db045ddea3b83511",
                        "ca233abc399a73ef2351cfe264728adafc9aaca52636e5d470835270ba726146")),
    "sharp": (8, ("3a37cc0f81581516b124c9b46dc6bcb1a1192f05f31d441af532b6a55f977339",
                    "19639e0008e0eddde43d60fc4a1c5e58d07f5591045ed466fad82d64b097a090")),
    "versions": (12, ("fa9fd34c89caf4fb83fceb28c1ce407a729b36f28b91c11ed28923f6db59898a",
                       "2347c8d9207cd8f68bdc0da9bb58ee604716e5bd871c29470004c884204fe604")),
    "writer": (8, ("372034b8120a0c7c26bf7e0099bf613e3a3de6bb19429ba0f909a1a047741872",
                     "89d8e66b47f06a9476d347c790bac42ab248a4e7a7bde7bf81c919da7390d753")),
}
