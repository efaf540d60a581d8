"""A VP9 syntax writer for the decoder's tests: the header-level tools that
no libvpx encoder setting emits, written around a key frame the caller
gives (a real encoder's), so that the pictures carry its content.

What it writes (VP9 Bitstream & Decoding Process Specification v0.6):
intra-only frames (hidden, with each ``reset_frame_context`` value),
``show_existing_frame``, inter frames whose every block takes its
reference from the segmentation feature ``SEG_LVL_REF_FRAME`` (so no
reference is coded) and, in some segments, ``SEG_LVL_SKIP``; absolute and
delta segment data with the quantiser and loop-filter features; tree-coded
and temporally predicted segment maps; loop-filter sharpness and deltas;
refresh patterns that refresh one slot, none or all eight; a sample that
holds only a hidden frame; superframes (Annex B). Blocks stay simple: every
block is 64x64 and skipped (no residual); intra-only frames predict from
the frame's edges with a mode a block, inter blocks copy their reference
(ZEROMV), except the first block of each inter frame outside the skip
segment, which codes a new vector (so the frame's interpolation filter,
bilinear in one frame, does work).

Every frame keeps the default probabilities: the first intra-only frame
resets all four saved contexts (``reset_frame_context`` 3), no frame
updates or saves one (``refresh_frame_context`` 0, frame-parallel or
error-resilient mode), so the writer needs no adaptation. The constant
tables are read from the decoder's source (``runtime/vp9.cpp``): the writer
shares them, so only the comparison with ffmpeg checks them.

:func:`tools_stream` returns the samples; the tests mux them into mp4 and
WebM (``tests/data/vp9/``) and hold the decode to ffmpeg's planes, whose
SHA-256 :data:`PINNED_SHA256` keeps for ``chip_smoke.py``.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parent.parent / "runtime" / "vp9.cpp"
# intra modes and the inter modes after them (the specification's order)
DC, V, H, D45, D135, D117, D153, D207, D63, TM = range(10)
NEARESTMV, NEARMV, ZEROMV, NEWMV = range(10, 14)
INTRA_MODE_TREE = (-DC, 2, -TM, 4, -V, 6, 8, 12, -H, 10, -D135, -D117, -D45, 14, -D63, 16, -D153,
                   -D207)
SEGMENT_TREE = (2, 4, 6, 8, 10, 12, 0, -1, -2, -3, -4, -5, -6, -7)
MV_JOINT_TREE = (0, 2, -1, 4, -2, -3)
MV_CLASS_TREE = (0, 2, -1, 4, 6, 8, -2, -3, 10, 12, -4, -5, -6, 14, 16, 18, -7, -8, -9, -10)
MV_FP_TREE = (0, 2, -1, 4, -2, -3)
# the frame header's 2-bit filter: smooth, regular, sharp, bilinear
FILTER_BILINEAR = 3
BASE_Q = 60                                  # base_q_idx (no block codes a residual)
NEW_MV = (6, -10)                            # the first block's vector difference
TREE_PROBS = (128, 96, 160, 128, 200, 60, 128)   # segmentation_tree_probs
PRED_PROBS = (150, 100, 40)                  # segmentation_pred_prob


# the decoder's tables the writer codes with
_NAMES = ("kKfYModeProbs", "kKfUvModeProbs", "kKfPartitionProbs", "kDefaultPartitionProbs",
          "kDefaultSkip", "kDefaultInterMode", "kDefaultMvJoints", "kDefaultMvClasses",
          "kDefaultMvClass0", "kDefaultMvBits", "kDefaultMvClass0Fp", "kDefaultMvFp")


def _tables() -> Dict[str, np.ndarray]:
    """The decoder's uint8 constant tables the writer uses, by name."""
    src = _SOURCE.read_text()
    out = {}
    for m in re.finditer(r"const uint8_t (k\w+)((?:\[\d+\])+) = \{(.*?)\};", src, re.S):
        if m.group(1) not in _NAMES:
            continue
        dims = [int(d) for d in re.findall(r"\[(\d+)\]", m.group(2))]
        vals = [int(v) for v in re.findall(r"-?\d+", m.group(3))]
        out[m.group(1)] = np.array(vals, np.int64).reshape(dims)
    missing = set(_NAMES) - set(out)
    if missing:
        raise RuntimeError(f"{_SOURCE} has no table {sorted(missing)}")
    return out


_T = _tables()


# ------------------------------------------------------------- encoders --

class BoolEncoder:
    """The boolean encoder that section 9.2's decoder inverts (libvpx's
    ``vpx_writer``): a marker bit 0 first, 32 zero bits of padding last."""

    def __init__(self):
        self.low, self.range, self.count = 0, 255, -24
        self.buf = bytearray()
        self.write(0, 128)

    def write(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        rng, low = (self.range - split, self.low + split) if bit else (split, self.low)
        shift = 8 - rng.bit_length()
        rng <<= shift
        count = self.count + shift
        if count >= 0:
            offset = shift - count
            if (low << (offset - 1)) & 0x80000000:
                x = len(self.buf) - 1
                while x >= 0 and self.buf[x] == 0xFF:
                    self.buf[x] = 0
                    x -= 1
                self.buf[x] += 1
            self.buf.append((low >> (24 - offset)) & 0xFF)
            low = (low << offset) & 0xFFFFFF
            shift = count
            count -= 8
        self.low, self.range, self.count = (low << shift) & 0xFFFFFFFF, rng, count

    def literal(self, n: int, v: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write((v >> i) & 1, 128)

    def tree(self, tree: Sequence[int], probs, value: int) -> None:
        """Write ``value``'s path through ``tree`` (leaves are -value)."""
        path = self._path(tree, 0, value)
        if path is None:
            raise ValueError(f"{value} is not a leaf of the tree")
        for node, bit in path:
            self.write(bit, int(probs[node >> 1]))

    def _path(self, tree, i, value):
        for bit in (0, 1):
            t = tree[i + bit]
            if t <= 0:
                if -t == value:
                    return [(i, bit)]
            else:
                rest = self._path(tree, t, value)
                if rest is not None:
                    return [(i, bit)] + rest
        return None

    def bytes(self) -> bytes:
        for _ in range(32):
            self.write(0, 128)
        out = bytes(self.buf)
        # no final byte that a superframe index could take for its marker
        return out + b"\0" if out[-1] & 0xE0 == 0xC0 else out


class BitWriter:
    """The uncompressed header's bits, most significant first."""

    def __init__(self):
        self.bits: List[int] = []

    def u(self, n: int, v: int) -> "BitWriter":
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def su(self, n: int, v: int) -> "BitWriter":
        return self.u(n, abs(v)).u(1, v < 0)

    def bytes(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return np.packbits(np.array(bits, np.uint8)).tobytes()


# ---------------------------------------------------------------- frames --

@dataclass
class Segmentation:
    """``segmentation_params``: the map (a segment id per 64x64 block, raster
    order; None keeps the map), temporal prediction (the blocks whose id
    repeats the previous map's are flagged), and the features of each
    segment {segment: {feature: value}} (0 ALT_Q, 1 ALT_LF, 2 REF_FRAME,
    3 SKIP), absolute or as deltas."""

    ids: Optional[List[int]] = None
    temporal: bool = False
    features: Dict[int, Dict[int, int]] = field(default_factory=dict)
    absolute: bool = False

    def active(self, seg: int, feature: int) -> bool:
        return feature in self.features.get(seg, {})


@dataclass
class Frame:
    """One frame: ``kind`` "intra_only" or "inter" (intra-only frames are
    always hidden)."""

    kind: str
    show: bool = True
    error_res: bool = False
    reset: int = 0
    refresh: int = 0
    ref_idx: Tuple[int, int, int] = (0, 1, 2)
    context_idx: int = 0
    lf_level: int = 0
    sharpness: int = 0
    lf_deltas: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None
    interp: int = 1
    render_size: Optional[Tuple[int, int]] = None
    seg: Optional[Segmentation] = None
    modes: Sequence[int] = (V, H, TM, D45, D135, D117, D153, D207, D63, DC)


class Writer:
    """Frames of one stream of ``width`` x ``height`` (multiples of 64),
    after a key frame that refreshed every slot; it keeps what the next
    frame's syntax depends on (the segment maps)."""

    def __init__(self, width: int, height: int):
        if width % 64 or height % 64 or width > 448:
            raise ValueError("the writer codes 64x64 blocks in one tile: width and height must "
                             "be multiples of 64, the width at most 448")
        self.w, self.h = width, height
        self.sb_cols, self.sb_rows = width // 64, height // 64
        self.seg_last = [0] * (self.sb_cols * self.sb_rows)

    # the uncompressed header ------------------------------------------------
    def _header(self, f: Frame, comp_size: int) -> bytes:
        b = BitWriter().u(2, 2).u(1, 0).u(1, 0).u(1, 0)   # marker, profile 0, not existing
        b.u(1, 1).u(1, f.show).u(1, f.error_res)           # frame_type 1 (not key)
        if not f.show:
            b.u(1, f.kind == "intra_only")
        if not f.error_res:
            b.u(2, f.reset)
        if f.kind == "intra_only":
            b.u(24, 0x498342).u(8, f.refresh).u(16, self.w - 1).u(16, self.h - 1)
            if f.render_size:
                b.u(1, 1).u(16, f.render_size[0] - 1).u(16, f.render_size[1] - 1)
            else:
                b.u(1, 0)
        else:
            b.u(8, f.refresh)
            for i in f.ref_idx:
                b.u(3, i).u(1, 0)                              # sign bias 0: no compound
            b.u(1, 1).u(1, 0)                                  # size from LAST, no render size
            b.u(1, 0).u(1, 0).u(2, f.interp)                  # no high precision; the filter
        if not f.error_res:
            b.u(1, 0).u(1, 1)                                  # no context refresh; parallel
        b.u(2, f.context_idx)
        b.u(6, f.lf_level).u(3, f.sharpness).u(1, f.lf_deltas is not None)
        if f.lf_deltas is not None:
            b.u(1, 1)
            for d in f.lf_deltas[0] + f.lf_deltas[1]:
                b.u(1, 1).su(6, d)
        b.u(8, BASE_Q).u(1, 0).u(1, 0).u(1, 0)
        s = f.seg
        b.u(1, s is not None)
        if s is not None:
            b.u(1, s.ids is not None)
            if s.ids is not None:
                for p in TREE_PROBS:
                    b.u(1, 1).u(8, p)
                b.u(1, s.temporal)
                if s.temporal:
                    for p in PRED_PROBS:
                        b.u(1, 1).u(8, p)
            b.u(1, 1).u(1, s.absolute)
            bits, signed = (8, 6, 2, 0), (1, 1, 0, 0)
            for i in range(8):
                for j in range(4):
                    on = s.active(i, j)
                    b.u(1, on)
                    if on:
                        v = s.features[i][j]
                        b.u(bits[j], abs(v))
                        if signed[j]:
                            b.u(1, v < 0)
        b.u(1, 0)                                              # one tile row (and column)
        return b.u(16, comp_size).bytes()

    # the compressed header: no updates --------------------------------------
    @staticmethod
    def _compressed(inter: bool) -> bytes:
        e = BoolEncoder()
        e.literal(2, 3)
        e.write(0, 128)                                        # ALLOW_32X32
        for _ in range(4):
            e.write(0, 128)                                    # no coefficient updates
        n = 3                                                  # skip
        if inter:
            n += 21 + 4 + 10 + 36 + 48       # modes, intra/inter, refs, y, partition
        for _ in range(n):
            e.write(0, 252)
        if inter:
            for _ in range(3 + 2 * (1 + 10 + 1 + 10) + 2 * (6 + 3)):
                e.write(0, 252)                                # vector probabilities
        return e.bytes()

    # the blocks -------------------------------------------------------------
    def _tiles(self, f: Frame) -> bytes:
        e = BoolEncoder()
        inter = f.kind == "inter"
        s = f.seg
        n = self.sb_cols * self.sb_rows
        if f.kind == "intra_only" or f.error_res:              # setup_past_independence
            self.seg_last = [0] * n
        if s is not None and s.ids is not None:
            ids = list(s.ids)
        elif s is not None:
            ids = list(self.seg_last)
        else:
            ids = [0] * n
        pred = [s is not None and s.ids is not None and s.temporal and ids[k] == self.seg_last[k]
                for k in range(n)]
        modes, skip_ctx = [None] * n, [0] * n
        for r in range(self.sb_rows):
            for c in range(self.sb_cols):
                k = r * self.sb_cols + c
                above, left = (k - self.sb_cols if r else None), (k - 1 if c else None)
                # PARTITION_NONE at 64x64 (context 12: no split above or to the left)
                probs = _T["kDefaultPartitionProbs"] if inter else _T["kKfPartitionProbs"]
                e.write(0, int(probs[12][0]))
                if s is not None and s.ids is not None:
                    if inter and s.temporal:
                        ctx = sum(pred[j] for j in (above, left) if j is not None)
                        e.write(pred[k], PRED_PROBS[ctx])
                        if not pred[k]:
                            e.tree(SEGMENT_TREE, TREE_PROBS, ids[k])
                    else:
                        e.tree(SEGMENT_TREE, TREE_PROBS, ids[k])
                seg = ids[k]
                if not (s is not None and s.active(seg, 3)):
                    ctx = (above is not None) + (left is not None)   # every block is skipped
                    e.write(1, int(_T["kDefaultSkip"][ctx]))
                if not inter:
                    m = f.modes[k % len(f.modes)]
                    a = modes[above] if above is not None else DC
                    lm = modes[left] if left is not None else DC
                    e.tree(INTRA_MODE_TREE, _T["kKfYModeProbs"][a][lm], m)
                    uv = f.modes[(k + 3) % len(f.modes)]
                    e.tree(INTRA_MODE_TREE, _T["kKfUvModeProbs"][m], uv)
                    modes[k] = m
                    continue
                if not (s is not None and s.active(seg, 2)):
                    raise ValueError("the writer's inter blocks take their reference from "
                                     "SEG_LVL_REF_FRAME: every segment needs it")
                skipped = s.active(seg, 3)
                mode = ZEROMV if skipped or k else NEWMV
                if not skipped:
                    # the context of the two nearest candidates' modes (counter_to_context)
                    counter = sum(3 if modes[j] == ZEROMV else 1
                                  for j in (above, left) if j is not None)
                    ctx = {0: 2, 1: 3, 2: 4, 3: 1, 4: 3, 6: 0}[counter]
                    probs = _T["kDefaultInterMode"][ctx]
                    if mode == ZEROMV:
                        e.write(0, int(probs[0]))
                    else:
                        e.write(1, int(probs[0]))
                        e.write(1, int(probs[1]))
                        e.write(1, int(probs[2]))
                        self._mv(e, *NEW_MV)
                modes[k] = mode
        if s is not None:
            self.seg_last = ids
        return e.bytes()

    @staticmethod
    def _mv(e: BoolEncoder, row: int, col: int) -> None:
        """A new vector's difference from the block's best candidate (none in
        the frame precedes the first block; the previous frame's vector
        there may), without high precision: even components."""
        joint = (1 if col else 0) | (2 if row else 0)
        e.tree(MV_JOINT_TREE, _T["kDefaultMvJoints"], joint)
        for comp, v in ((0, row), (1, col)):
            if not v:
                continue
            if v % 2:
                raise ValueError("without high precision a vector component is even")
            mag = abs(v) - 1
            e.write(v < 0, 128)
            cls = 0 if mag < 16 else min(10, (mag >> 3).bit_length() - 1)
            offset = mag - (0 if cls == 0 else 2 << (cls + 2))
            e.tree(MV_CLASS_TREE, _T["kDefaultMvClasses"][comp], cls)
            d, fr = offset >> 3, (offset >> 1) & 3
            if cls == 0:
                e.write(d, int(_T["kDefaultMvClass0"][comp]))
                e.tree(MV_FP_TREE, _T["kDefaultMvClass0Fp"][d], fr)
            else:
                for i in range(cls):
                    e.write((d >> i) & 1, int(_T["kDefaultMvBits"][i]))
                e.tree(MV_FP_TREE, _T["kDefaultMvFp"], fr)

    def frame(self, f: Frame) -> bytes:
        comp = self._compressed(f.kind == "inter")
        tiles = self._tiles(f)
        return self._header(f, len(comp)) + comp + tiles


def show_existing(slot: int) -> bytes:
    """A show_existing_frame frame: slot ``slot``'s picture shown again."""
    return bytes([0x88 | slot])


def superframe(frames: Sequence[bytes]) -> bytes:
    """Frames in one sample, with Annex B's index after them."""
    if len(frames) == 1:
        return frames[0]
    mag = max(1, (max(len(f) for f in frames).bit_length() + 7) // 8)
    marker = 0xC0 | ((mag - 1) << 3) | (len(frames) - 1)
    sizes = b"".join(len(f).to_bytes(mag, "little") for f in frames)
    index = bytes([marker]) + sizes + bytes([marker])
    return b"".join(frames) + index


def tools_stream(key_frame: bytes, width: int, height: int) -> Tuple[List[bytes], List[bool]]:
    """(samples, sync flags): ``key_frame`` (a key frame of ``width`` x
    ``height`` that refreshes every slot) and the frames after it that
    reach the header-level tools; 12 pictures from 13 samples (one sample
    holds only a hidden frame)."""
    w = Writer(width, height)
    n = w.sb_cols * w.sb_rows
    ids = [k % 3 for k in range(n)]
    refs = {0: {2: 1}, 1: {2: 2}, 2: {2: 3, 3: 0}}    # LAST, GOLDEN, ALTREF skipped
    seg_refs = Segmentation(ids=ids, features=refs, absolute=True)
    out = [key_frame]
    # an intra-only frame resets all four contexts; an error-resilient inter frame
    # shows a mosaic of the key frame (LAST), the intra-only frame (GOLDEN), and
    # slot 2 (ALTREF, skipped blocks), the first block moved by a bilinear vector
    io1 = w.frame(Frame("intra_only", show=False, reset=3, refresh=0b10,
                        seg=Segmentation(ids=[(k * 5) % 8 for k in range(n)],
                                         features={1: {0: -20}, 3: {0: 40}})))
    f1 = w.frame(Frame("inter", error_res=True, refresh=0b100, ref_idx=(0, 1, 2),
                       interp=FILTER_BILINEAR, seg=seg_refs))
    out.append(superframe([io1, f1]))
    out.append(show_existing(1))
    # temporal prediction of the map from f1's, loop-filter sharpness and deltas,
    # a segment's filter level as a delta, and a frame that refreshes no slot
    seg_t = Segmentation(ids=[(k + (k % 2)) % 3 for k in range(n)], temporal=True,
                         features={0: {2: 1, 1: -10}, 1: {2: 2, 1: 8}, 2: {2: 3, 3: 0}})
    out.append(w.frame(Frame("inter", refresh=0, ref_idx=(2, 1, 0), context_idx=1, lf_level=24,
                             sharpness=3, lf_deltas=((2, 0, -3, 1), (-2, 3)), seg=seg_t)))
    # intra-only frames with reset_frame_context 2 (the context they name), 0 and 1,
    # each hidden in a superframe before a frame that shows them
    io2 = w.frame(Frame("intra_only", show=False, reset=2, context_idx=2, refresh=0b1000,
                        render_size=(width - 20, height - 8), modes=(TM, D63, H, D207)))
    f3 = w.frame(Frame("inter", refresh=0b10000000, ref_idx=(3, 0, 2), context_idx=3, seg=seg_refs,
                       interp=0))
    out.append(superframe([io2, f3]))
    io3 = w.frame(Frame("intra_only", show=False, reset=0, refresh=0b10000, modes=(D45, D117, V)))
    io4 = w.frame(Frame("intra_only", show=False, reset=1, refresh=0b100000, modes=(D153, D135)))
    f4 = w.frame(Frame("inter", refresh=0b1000000, ref_idx=(4, 5, 7),
                       seg=Segmentation(ids=[(k * 2) % 3 for k in range(n)], features=refs)))
    out.append(superframe([io3, io4, f4]))
    out.append(show_existing(3))
    # a sample that holds only a hidden frame (no picture), then that frame shown
    out.append(w.frame(Frame("inter", show=False, refresh=0b1, ref_idx=(6, 1, 3),
                             seg=Segmentation(ids=[2 - k % 3 for k in range(n)], features=refs))))
    out.append(show_existing(0))
    out.append(show_existing(4))
    out.append(show_existing(5))
    # an error-resilient frame (no map kept: a new one) that refreshes all eight
    # slots, so that slot 2 then shows it
    out.append(w.frame(Frame("inter", error_res=True, refresh=0xFF, ref_idx=(0, 5, 7),
                             seg=Segmentation(ids=[(k + 1) % 3 for k in range(n)], features=refs))))
    out.append(show_existing(2))
    return out, [True] + [False] * (len(out) - 1)


def vpcc_box(full_range: bool = False) -> bytes:
    """A ``vpcC`` box (version 1): profile 0, level 1.0, 8-bit, 4:2:0
    co-located with luma, BT.601 colour, no initialisation data."""
    from cap4d_torch.utils.synthetic_assets import _full_box

    return _full_box(b"vpcC", 1, 0, bytes([0, 10, (8 << 4) | (1 << 1) | int(full_range), 6, 6, 6])
                     + struct.pack(">H", 0))


# The committed streams under tests/data/vp9/ (libvpx's encoder, driven by
# tests/test_torch_vp9.py, and tools_stream): name -> (pictures,
# mpeg4_writer.planes_sha256 of ffmpeg's planes: the SHA-256 of the Y planes
# and of the U and V planes, every picture in order). The tests hold the
# port's decode and ffmpeg's to them on the CPU; chip_smoke.py holds the
# card machine's decode (no ffmpeg there).
PINNED_SHA256: Dict[str, Tuple[int, Tuple[str, str]]] = {
    "aq_variance": (8, ("980511ad84c9ba5ab97c1c5cdaf39611d51215c2f76b75e6a3ee2064b86fc992",
                        "75fd68b62ae5cade4344572cc6a306e74b113697d4378a1e8e8e906b7a2c0c7f")),
    "color10": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color11": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color20": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color21": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color30": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color31": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color40": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color41": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color50": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color51": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color60": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "color61": (2, ("e14e6a951b01ee7d117d67481715a29d9429cb08b0c963993ff8ba0e8b223ecd",
                    "29e9bf1ba2e66e331672f5e6d7e80272e496bb42b7a2e5b6898a86ca0cd9460f")),
    "good_altref": (30, ("e5d522d7a21bce7e4173441d0dbf01c12039f5d2f4eed7409e39e10ddc21b8d6",
                         "aadd6975ff6f87bc174aea1d8fbab6821175653dde6df4e84a628411c87e9e2f")),
    "load_1080": (16, ("689a4007980f746cd7e4adbc0ecbc49a59716f7e5705b8b52e53491f5358d861",
                       "8dd4ff0dcb535388841c7a11a5ca3dd6ec9745821678939f592d2a938d43d914")),
    "lossless": (4, ("100085d95d078a177507bae3069a3661c3d05ae9b347f5fd0d8350d868f62906",
                     "56ee8b35164c0be4da1c652d1170171e666c953111c34475130dfa4cb39b050c")),
    "odd": (6, ("bf9cf527504f295738fc5d76ba618e20f88d9637936065fd7768e784ed46d66b",
                "10dcaf784255d7d1e7eb71cf598302649537c9ae757bb70598e89849328582b0")),
    "resilient": (10, ("2eea580617ff98ac12150f62609115b7749151401e433e2d911fc920bc65a308",
                       "e84db9be2dbf4f2f7561ce0d74710b448880a9f73d8b91c11a2b2c0c77c44a9c")),
    "resize": (20, ("5f4364e47bb094f776c3da0e7b7d93e639e76cf4db1fb4e39670377a0f831557",
                    "5bbe9efaffb67b85a35e2e8a0e8f4de0dbd7a4a8e0c0aa75949ec328c948c928")),
    "rt_cyclic": (16, ("174f7cddd2e9efae612ff3e7105273494ae32222fcd9ed03532dd4399bff1b8c",
                       "fc4c047a7546bcb1ac2a1fb770d5076ea1e9edea06ea699440888944dd95f40b")),
    "tiles": (6, ("efb8db589fe723e6477bcc89062b181d4b0fde7a2d13b098182893181cdb8d6e",
                  "b2caf8f0d8da96980b32e47e9a1204a334be2bd3152586264167420f223716a2")),
    "writer": (12, ("28856a5c4c6c9a1db94f19f2105ee579be3cc09b80ef85703a9fbbc8d8e81644",
                    "fc8050108d12178e8dc03b20076408ed793f8157557ccd14cbbb809482f349f2")),
}
