"""Seeded random-syntax MPEG-4 Part 2 streams: test input for the port's
MPEG-4 decoder (``runtime/mpeg4.cpp``), for the tools cv2's ``mp4v``
encoder never emits.

cv2's encoder writes Simple-profile I- and P-VOPs with one vector a
macroblock. This writer emits syntax, not pictures: every syntax element of
every VOP (coding type, times, quantiser, f_codes, intra_dc_vlc_thr,
macroblock types, 1 or 4 vectors, not-coded macroblocks, dquant, AC
prediction, coefficients with every escape type; in B-VOPs the four modes,
delta vectors, dbquant) is drawn from a seeded ``random.Random`` and coded
as ISO/IEC 14496-2 reads it back. The stream decodes to whatever that
syntax means; ffmpeg (cv2, in the tests) is the oracle.

What a draw may take is limited where the standard or ffmpeg's reading of
it is loose:

- the writer keeps the decoder's prediction state (the DC and AC
  predictors with their direction choice and quantiser rescaling, the
  vector predictors with their video-packet rules, the B-VOP predictors)
  and draws the reconstructed values, then codes the differences: DC
  levels times the DC scaler stay in 0..2047 (no clipping), dequantised
  coefficients stay small (at most 400 each, 1000 a block, so no inverse
  transform overflows 16 bits) and vectors stay within a window around
  the picture;
- escapes follow the standard's order (the table, then type 1, then type
  2, then type 3), so each is used where the standard uses it;
- video packets start anywhere; a not-coded VOP (vop_coded 0) appears only
  in streams without B-VOPs (ffmpeg outputs no picture for it, and its
  B-VOP times would follow the not-coded VOP's);
- B-VOPs sit between anchors of the same GOV (closed GOVs); the container
  carries their composition offsets (``ctts``) and an edit list, as
  ffmpeg's muxer writes them.
"""

from __future__ import annotations

import random
import struct
from typing import Dict, Optional, Tuple

from cap4d_torch.utils.synthetic_assets import _full_box, visual_sample_entry, write_mp4

# ----------------------------------------------------------------- tables --

ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
          34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
          37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
ALT_VERTICAL = [0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3, 11,
                4, 12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36,
                44, 52, 60, 37, 45, 53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63]
ALT_HORIZONTAL = [(v % 8) * 8 + v // 8 for v in ALT_VERTICAL]
DEFAULT_INTRA = [8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23,
                 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35,
                 23, 24, 26, 28, 30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32,
                 35, 38, 41, 45]
DEFAULT_INTER = [16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21,
                 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28,
                 21, 22, 23, 24, 26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27,
                 28, 30, 31, 33]
MCBPC_I = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6)]   # [dquant*4 + cbpc]
MCBPC_I_STUFFING = (1, 9)
# [mb_type][cbpc]: 0 inter, 1 inter+q, 2 inter4v, 3 intra, 4 intra+q
MCBPC_P = [[(1, 1), (3, 4), (2, 4), (5, 6)], [(3, 3), (7, 7), (6, 7), (5, 9)],
           [(2, 3), (5, 7), (4, 7), (5, 8)], [(3, 5), (4, 8), (3, 8), (3, 7)],
           [(4, 6), (4, 9), (3, 9), (2, 9)]]
MCBPC_P_STUFFING = (1, 9)
CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4), (2, 5), (3, 6), (5, 4),
        (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]
DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9)]
DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9),
            (1, 10)]
MV = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9), (9, 9),
      (17, 10), (16, 10), (15, 10), (14, 10), (13, 10), (12, 10), (11, 10), (10, 10), (9, 10),
      (8, 10), (7, 10), (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11),
      (2, 11), (3, 12), (2, 12)]
B_TYPES = ("direct", "interpolate", "backward", "forward")   # codes 1, 01, 001, 0001
DQUANT = {-1: 0, -2: 1, 1: 2, 2: 3}
DC_THRESHOLD = [99, 13, 15, 17, 19, 21, 23, 0]
TCOEF_INTRA = [
    0x2, 2, 0x6, 3, 0xf, 4, 0xd, 5, 0xc, 5, 0x15, 6, 0x13, 6, 0x12, 6, 0x17, 7, 0x1f, 8, 0x1e, 8,
    0x1d, 8, 0x25, 9, 0x24, 9, 0x23, 9, 0x21, 9, 0x21, 10, 0x20, 10, 0xf, 10, 0xe, 10, 0x7, 11,
    0x6, 11, 0x20, 11, 0x21, 11, 0x50, 12, 0x51, 12, 0x52, 12, 0xe, 4, 0x14, 6, 0x16, 7, 0x1c, 8,
    0x20, 9, 0x1f, 9, 0xd, 10, 0x22, 11, 0x53, 12, 0x55, 12, 0xb, 5, 0x15, 7, 0x1e, 9, 0xc, 10,
    0x56, 12, 0x11, 6, 0x1b, 8, 0x1d, 9, 0xb, 10, 0x10, 6, 0x22, 9, 0xa, 10, 0xd, 6, 0x1c, 9, 0x8,
    10, 0x12, 7, 0x1b, 9, 0x54, 12, 0x14, 7, 0x1a, 9, 0x57, 12, 0x19, 8, 0x9, 10, 0x18, 8, 0x23,
    11, 0x17, 8, 0x19, 9, 0x18, 9, 0x7, 10, 0x58, 12, 0x7, 4, 0xc, 6, 0x16, 8, 0x17, 9, 0x6, 10,
    0x5, 11, 0x4, 11, 0x59, 12, 0xf, 6, 0x16, 9, 0x5, 10, 0xe, 6, 0x4, 10, 0x11, 7, 0x24, 11,
    0x10, 7, 0x25, 11, 0x13, 7, 0x5a, 12, 0x15, 8, 0x5b, 12, 0x14, 8, 0x13, 8, 0x1a, 8, 0x15, 9,
    0x14, 9, 0x13, 9, 0x12, 9, 0x11, 9, 0x26, 11, 0x27, 11, 0x5c, 12, 0x5d, 12, 0x5e, 12, 0x5f,
    12]
TCOEF_INTER = [
    0x2, 2, 0xf, 4, 0x15, 6, 0x17, 7, 0x1f, 8, 0x25, 9, 0x24, 9, 0x21, 10, 0x20, 10, 0x7, 11,
    0x6, 11, 0x20, 11, 0x6, 3, 0x14, 6, 0x1e, 8, 0xf, 10, 0x21, 11, 0x50, 12, 0xe, 4, 0x1d, 8,
    0xe, 10, 0x51, 12, 0xd, 5, 0x23, 9, 0xd, 10, 0xc, 5, 0x22, 9, 0x52, 12, 0xb, 5, 0xc, 10,
    0x53, 12, 0x13, 6, 0xb, 10, 0x54, 12, 0x12, 6, 0xa, 10, 0x11, 6, 0x9, 10, 0x10, 6, 0x8, 10,
    0x16, 7, 0x55, 12, 0x15, 7, 0x14, 7, 0x1c, 8, 0x1b, 8, 0x21, 9, 0x20, 9, 0x1f, 9, 0x1e, 9,
    0x1d, 9, 0x1c, 9, 0x1b, 9, 0x1a, 9, 0x22, 11, 0x23, 11, 0x56, 12, 0x57, 12, 0x7, 4, 0x19, 9,
    0x5, 11, 0xf, 6, 0x4, 11, 0xe, 6, 0xd, 6, 0xc, 6, 0x13, 7, 0x12, 7, 0x11, 7, 0x10, 7, 0x1a, 8,
    0x19, 8, 0x18, 8, 0x17, 8, 0x16, 8, 0x15, 8, 0x14, 8, 0x13, 8, 0x18, 9, 0x17, 9, 0x16, 9,
    0x15, 9, 0x14, 9, 0x13, 9, 0x12, 9, 0x11, 9, 0x7, 10, 0x6, 10, 0x5, 10, 0x4, 10, 0x24, 11,
    0x25, 11, 0x26, 11, 0x27, 11, 0x58, 12, 0x59, 12, 0x5a, 12, 0x5b, 12, 0x5c, 12, 0x5d, 12,
    0x5e, 12, 0x5f, 12]
# the largest level of each run, by last (the tables' shapes)
INTRA_SHAPE = ([27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1], [8, 3, 2, 2, 2, 2, 2] + [1] * 14)
INTER_SHAPE = ([12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2] + [1] * 16, [3, 2] + [1] * 39)
ESCAPE = (0x3, 7)


class _Tcoef:
    """A TCOEF table: (last, run, level) -> (code, length), LMAX and RMAX."""

    def __init__(self, codes, shape):
        self.code, self.max_level, self.max_run = {}, [{}, {}], [{}, {}]
        k = 0
        for last in (0, 1):
            for run, top in enumerate(shape[last]):
                self.max_level[last][run] = top
                for level in range(1, top + 1):
                    self.code[last, run, level] = (codes[2 * k], codes[2 * k + 1])
                    self.max_run[last][level] = max(self.max_run[last].get(level, 0), run)
                    k += 1


INTRA_TCOEF = _Tcoef(TCOEF_INTRA, INTRA_SHAPE)
INTER_TCOEF = _Tcoef(TCOEF_INTER, INTER_SHAPE)


def y_dc_scale(q: int) -> int:
    return 8 if q < 5 else (2 * q if q < 9 else (q + 8 if q < 25 else 2 * q - 16))


def c_dc_scale(q: int) -> int:
    return 8 if q < 5 else ((q + 13) // 2 if q < 25 else q - 6)


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _rounded_div(a: int, b: int) -> int:
    return _cdiv(a + (b >> 1) if a >= 0 else a - (b >> 1), b)


def _mid(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


class BitWriter:
    """MSB-first bits into a bytearray."""

    def __init__(self):
        self.buf, self.acc, self.n = bytearray(), 0, 0

    def u(self, n: int, v: int) -> "BitWriter":
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            self.buf.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1
        return self

    def code(self, c: Tuple[int, int]) -> "BitWriter":
        return self.u(c[1], c[0])

    def stuffing(self) -> "BitWriter":
        """next_start_code() / next_resync_marker(): '0', then '1's to a byte."""
        self.u(1, 0)
        while self.n:
            self.u(1, 1)
        return self

    def bytes(self) -> bytes:
        assert self.n == 0
        return bytes(self.buf)


# ---------------------------------------------------------------- headers --

GOP = 12            # frames a GOV (closed), as cv2's encoder keeps them
TIME_RES = 30       # vop_time_increment_resolution
# how often each choice is drawn
MIX = dict(intra=0.06, not_coded=0.12, four_mv=0.3, dquant=0.2, coded=0.55, ac_pred=0.5,
           packet=0.04, hec=0.5, stuffing=0.02, big=0.08, long_run=0.08, vop_coded0=0.08,
           b_modb=(0.2, 0.25), dbquant=0.4)


def vol_header(w: int, h: int, time_res: int, *, verid: int = 2, quarter: bool = False,
               mpeg_quant: bool = False, matrices=(None, None), resync: bool = True,
               low_delay: bool = True, object_type: int = 1, tool: Optional[str] = None) -> bytes:
    """video_object_layer() (a start code 00 00 01 20 and its fields). ``tool``
    sets one field the port refuses (the writer's refusal streams)."""
    b = BitWriter()
    b.u(32, 0x120).u(1, 0).u(8, object_type).u(1, 1).u(4, verid).u(3, 1).u(4, 1)
    b.u(1, 1).u(2, 1).u(1, int(low_delay)).u(1, 0)                   # vol_control_parameters
    b.u(2, 2 if tool == "shape" else 0)                               # video_object_layer_shape
    if tool == "shape":
        b.u(1, 1).u(16, time_res).u(1, 1).u(1, 0)
        return b.stuffing().bytes()
    bits = max(1, (time_res - 1).bit_length())
    b.u(1, 1).u(16, time_res).u(1, 1).u(1, 0)                         # markers, fixed_vop_rate 0
    b.u(1, 1).u(13, w).u(1, 1).u(13, h).u(1, 1)
    b.u(1, int(tool == "interlaced")).u(1, 1)                         # interlaced, obmc_disable
    sprite = {"sprite": 1, "gmc": 2}.get(tool, 0)
    b.u(1 if verid == 1 else 2, sprite)
    if sprite:
        return b.stuffing().bytes()
    b.u(1, int(tool == "not_8_bit"))
    if tool == "not_8_bit":
        return b.u(4, 6).u(4, 10).stuffing().bytes()
    b.u(1, int(mpeg_quant))
    if mpeg_quant:
        for m in matrices:
            b.u(1, m is not None)
            if m is not None:
                values = [m[ZIGZAG[i]] for i in range(64)]
                n = 64
                while n > 1 and values[n - 1] == values[n - 2]:
                    n -= 1
                for v in values[:n]:
                    b.u(8, v)
                if n < 64:
                    b.u(8, 0)
    if verid != 1:
        b.u(1, int(quarter))
    b.u(1, int(tool != "complexity"))        # complexity_estimation_disable
    if tool == "complexity":
        return b.stuffing().bytes()
    b.u(1, int(not resync))
    b.u(1, int(tool in ("data_partitioned", "rvlc")))
    if tool in ("data_partitioned", "rvlc"):
        b.u(1, int(tool == "rvlc"))
    if verid != 1:
        b.u(1, int(tool == "newpred"))
        if tool == "newpred":
            return b.u(2, 0).u(1, 0).stuffing().bytes()
        b.u(1, int(tool == "reduced_resolution"))
    b.u(1, int(tool == "scalability"))
    return b.stuffing().bytes()


def vo_header(signal: Optional[Tuple[bool, int]] = None) -> bytes:
    """visual_object() of a video object, with video_signal_type (full range,
    matrix_coefficients) when ``signal`` is given."""
    b = BitWriter().u(32, 0x1B5).u(1, 1).u(4, 2).u(3, 1).u(4, 1)
    b.u(1, signal is not None)
    if signal is not None:
        full, matrix = signal
        b.u(3, 5).u(1, int(full)).u(1, 1).u(8, 1 if matrix == 1 else 5).u(8, 1).u(8, matrix)
    return b.stuffing().bytes()


def esds_box(dsi: bytes, object_type: int = 0x20) -> bytes:
    """``esds``: ES_Descriptor(DecoderConfigDescriptor(object type, visual,
    DecoderSpecificInfo), SLConfigDescriptor), lengths in four bytes as
    ffmpeg writes them."""
    def desc(tag, body):
        n = len(body)
        return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                      0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body
    dcd = desc(4, bytes([object_type, 0x11]) + b"\0" * 11 + desc(5, dsi))
    return _full_box(b"esds", 0, 0, desc(3, struct.pack(">HB", 1, 0) + dcd + desc(6, b"\x02")))


# ------------------------------------------------------------------- VOPs --

class _VopCoder:
    """Codes one VOP from its plan; keeps the decoder's prediction state."""

    def __init__(self, job: dict):
        self.j = job
        self.r = random.Random(job["seed"])
        self.mbw, self.mbh = job["mbw"], job["mbh"]
        self.w = BitWriter()
        self.stats: Dict[str, int] = {}
        self.b8s, self.mbs = 2 * self.mbw + 1, self.mbw + 1
        n_l = self.b8s * (2 * self.mbh + 1) + 1
        n_c = self.mbs * (self.mbh + 1) + 1
        self.dc = [[1024] * n_l, [1024] * n_c, [1024] * n_c]
        self.ac = [[[0] * 16 for _ in range(n_l)], [[0] * 16 for _ in range(n_c)],
                   [[0] * 16 for _ in range(n_c)]]
        self.mv = [[0, 0] for _ in range(n_l)]
        self.qtab = [0] * (self.mbw * self.mbh)
        self.last_mv = [[0, 0], [0, 0]]
        self.q = job["quant"]

    def count(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    # -- prediction state (as the decoder keeps it) --

    def lum(self, bx: int, by: int) -> int:
        return 1 + self.b8s + by * self.b8s + bx

    def bidx(self, n: int) -> int:
        if n < 4:
            return self.lum(2 * self.x + (n & 1), 2 * self.y + (n >> 1))
        return 1 + self.mbs + self.y * self.mbs + self.x

    def wrap(self, n: int) -> int:
        return self.b8s if n < 4 else self.mbs

    def clean_buffers(self) -> None:
        l_xy = self.lum(2 * self.x - 1, 2 * self.y - 1)
        for i in range(2 * self.b8s + 1):
            self.ac[0][l_xy + i] = [0] * 16
        c_xy = 1 + self.mbs + (self.y - 1) * self.mbs + self.x - 1
        for c in (1, 2):
            for i in range(self.mbs + 1):
                self.ac[c][c_xy + i] = [0] * 16
        self.last_mv = [[0, 0], [0, 0]]

    def dc_pred(self, n: int) -> Tuple[int, int]:
        """(predicted quantised DC, direction 0 left / 1 top)."""
        scale = y_dc_scale(self.q) if n < 4 else c_dc_scale(self.q)
        xy, wrap, dc = self.bidx(n), self.wrap(n), self.dc[0 if n < 4 else n - 3]
        a, b, c = dc[xy - 1], dc[xy - 1 - wrap], dc[xy - wrap]
        if self.first_line and n != 3:
            if n != 2:
                b = c = 1024
            if n != 1 and self.x == self.rx:
                b = a = 1024
        if self.x == self.rx and self.y == self.ry + 1 and n in (0, 4, 5):
            b = 1024
        if abs(a - b) < abs(b - c):
            return (c + (scale >> 1)) // scale, 1
        return (a + (scale >> 1)) // scale, 0

    def ac_pred(self, n: int, direction: int) -> Dict[int, int]:
        """{raster index: predicted level} of the first column (left) or row (top)."""
        xy = self.bidx(n)
        store = self.ac[0 if n < 4 else n - 3]
        if direction == 0:
            src, q = store[xy - 1], self.qtab[self.y * self.mbw + self.x - 1] if self.x else self.q
            same = self.x == 0 or q == self.q or n in (1, 3)
            return {i * 8: src[i] if same else _rounded_div(src[i] * q, self.q)
                    for i in range(1, 8)}
        src = store[xy - self.wrap(n)]
        q = self.qtab[(self.y - 1) * self.mbw + self.x] if self.y else self.q
        same = self.y == 0 or q == self.q or n in (2, 3)
        return {i: src[i + 8] if same else _rounded_div(src[i + 8] * q, self.q)
                for i in range(1, 8)}

    def mv_pred(self, block: int) -> Tuple[int, int]:
        off = (2, 1, 1, -1)[block]
        wrap = self.b8s
        xy = self.lum(2 * self.x + (block & 1), 2 * self.y + (block >> 1))
        A, B, C = self.mv[xy - 1], self.mv[xy - wrap], self.mv[xy + off - wrap]
        if self.first_line and block < 3:
            if block == 0:
                if self.x == self.rx:
                    return 0, 0
                if self.x + 1 == self.rx:
                    if self.x == 0:
                        return C[0], C[1]
                    return _mid(A[0], 0, C[0]), _mid(A[1], 0, C[1])
                return A[0], A[1]
            if block == 1:
                if self.x + 1 == self.rx:
                    return _mid(A[0], 0, C[0]), _mid(A[1], 0, C[1])
                return A[0], A[1]
            ax, ay = (0, 0) if self.x == self.rx else A
            return _mid(ax, B[0], C[0]), _mid(ay, B[1], C[1])
        return _mid(A[0], B[0], C[0]), _mid(A[1], B[1], C[1])

    def set_mv(self, block: int, v) -> None:
        self.mv[self.lum(2 * self.x + (block & 1), 2 * self.y + (block >> 1))] = list(v)

    # -- drawing --

    def draw_vector(self, fcode: int, qpel: bool) -> Tuple[int, int]:
        """A vector whose block stays within about 24 samples of the picture."""
        unit = 4 if qpel else 2
        lim = 32 << (fcode - 1)
        reach = self.r.choice([4, 16, 64]) * unit
        out = []
        for pos, size in ((self.x * 16, self.mbw * 16), (self.y * 16, self.mbh * 16)):
            lo = max(-lim, (-pos - 24) * unit)
            hi = min(lim - 1, (size - pos + 8) * unit)
            lo, hi = max(lo, -reach), min(hi, reach)
            out.append(self.r.randint(lo, hi) if lo <= hi else 0)
        return out[0], out[1]

    def code_mvd(self, value: int, pred: int, fcode: int) -> None:
        r = fcode - 1
        f = 1 << r
        d = (value - pred + 32 * f) % (64 * f) - 32 * f
        if d == 0:
            self.w.code(MV[0])
            return
        a = abs(d) - 1
        self.w.code(MV[(a >> r) + 1]).u(1, int(d < 0))
        if r:
            self.w.u(r, a & (f - 1))
        self.count(f"fcode{fcode}")

    def draw_levels(self, intra: bool, fixed: Dict[int, int]) -> Dict[int, int]:
        """{raster: level} of a block's coefficients (quantised), AC only for
        intra blocks; ``fixed`` are levels already chosen (predicted ones)."""
        j, r = self.j, self.r
        out = dict(fixed)
        n = r.choice([0, 1, 1, 2, 3, 4, 6])
        budget = 1000 - sum(abs(self.dequant(k, v, intra)) for k, v in out.items())
        for _ in range(n):
            pos = r.randrange(1 if intra else 0, 64)
            if r.random() < j["mix"]["long_run"]:
                pos = r.randrange(40, 64)
            if pos in out:
                continue
            top = 1
            while top < 60 and abs(self.dequant(pos, top + 1, intra)) <= min(400, budget):
                top += 1
            if abs(self.dequant(pos, 1, intra)) > min(400, budget):
                continue
            level = r.randint(1, top if r.random() < j["mix"]["big"] else min(top, 3))
            level = -level if r.random() < 0.5 else level
            out[pos] = level
            budget -= abs(self.dequant(pos, level, intra))
        return out

    def dequant(self, pos: int, level: int, intra: bool) -> int:
        q, a = self.q, abs(level)
        if not self.j["mpeg_quant"]:
            return a * 2 * q + ((q - 1) | 1)
        if intra:
            return (a * 2 * q * self.j["intra_matrix"][pos]) >> 4
        return ((2 * a + 1) * 2 * q * self.j["inter_matrix"][pos]) >> 5

    # -- coding --

    def tcoef(self, tab: _Tcoef, last: int, run: int, level: int) -> None:
        w, a, s = self.w, abs(level), int(level < 0)
        c = tab.code.get((last, run, a))
        if c:
            w.code(c).u(1, s)
            return
        top = tab.max_level[last].get(run)
        if top is not None and (last, run, a - top) in tab.code:
            w.code(ESCAPE).u(1, 0).code(tab.code[last, run, a - top]).u(1, s)
            self.count("escape1")
            return
        rmax = tab.max_run[last].get(a)
        if rmax is not None and (last, run - rmax - 1, a) in tab.code:
            w.code(ESCAPE).u(2, 2).code(tab.code[last, run - rmax - 1, a]).u(1, s)
            self.count("escape2")
            return
        assert 0 < a <= 2047, level
        w.code(ESCAPE).u(2, 3).u(1, last).u(6, run).u(1, 1).u(12, level & 0xFFF).u(1, 1)
        self.count("escape3")

    def code_coefficients(self, tab: _Tcoef, levels: Dict[int, int], scan, start: int) -> None:
        pairs, run = [], 0
        for i in range(start, 64):
            v = levels.get(scan[i], 0)
            if v:
                pairs.append((run, v))
                run = 0
            else:
                run += 1
        for k, (run, v) in enumerate(pairs):
            self.tcoef(tab, int(k == len(pairs) - 1), run, v)

    def intra_blocks(self, ac_pred: bool, use_dc_vlc: bool):
        """Draw the six blocks (updating the predictors); return their coded
        parts and the cbp."""
        blocks, cbp = [], 0
        for n in range(6):
            scale = y_dc_scale(self.q) if n < 4 else c_dc_scale(self.q)
            pred, direction = self.dc_pred(n)
            lo, hi = 0, 2047 // scale
            if use_dc_vlc:
                lo, hi = max(lo, pred - 255), min(hi, pred + 255)
            if self.r.random() < 0.7:
                lo, hi = max(lo, pred - 6), min(hi, pred + 6)
            dc = self.r.randint(lo, hi)
            self.dc[0 if n < 4 else n - 3][self.bidx(n)] = dc * scale
            predicted = self.ac_pred(n, direction) if ac_pred else {}
            levels = self.draw_levels(True, {})
            final = dict(levels)
            coded = {k: v - predicted.get(k, 0) for k, v in final.items()}
            for k, v in predicted.items():
                if k not in final:
                    coded[k] = -v
                    final[k] = 0
            coded = {k: v for k, v in coded.items() if v}
            store = self.ac[0 if n < 4 else n - 3][self.bidx(n)]
            for i in range(1, 8):
                store[i], store[8 + i] = final.get(i * 8, 0), final.get(i, 0)
            scan = (ALT_VERTICAL if direction == 0 else ALT_HORIZONTAL) if ac_pred else ZIGZAG
            if not use_dc_vlc and dc != pred:
                coded[0] = dc - pred
            blocks.append((n, dc - pred, coded, scan))
            cbp |= int(bool(coded)) << (5 - n)
        return blocks, cbp

    def write_intra_blocks(self, blocks, use_dc_vlc: bool) -> None:
        for n, diff, coded, scan in blocks:
            if use_dc_vlc:
                size = abs(diff).bit_length()
                self.w.code((DC_LUM if n < 4 else DC_CHROM)[size])
                if size:
                    self.w.u(size, diff if diff > 0 else diff + (1 << size) - 1)
            if coded:
                self.code_coefficients(INTRA_TCOEF, coded, scan, 0 if not use_dc_vlc else 1)

    def inter_blocks(self, cbp_mask: int = 63):
        blocks, cbp = [], 0
        for n in range(6):
            levels = self.draw_levels(False, {}) if (cbp_mask >> (5 - n)) & 1 else {}
            if levels and self.r.random() < self.j["mix"]["coded"]:
                blocks.append(levels)
                cbp |= 1 << (5 - n)
            else:
                blocks.append({})
        return blocks, cbp

    def write_inter_blocks(self, blocks) -> None:
        for levels in blocks:
            if levels:
                self.code_coefficients(INTER_TCOEF, levels, ZIGZAG, 0)

    def new_q(self, delta: int) -> None:
        self.q = min(31, max(1, self.q + delta))

    def intra_mb(self, p_vop: bool) -> None:
        mix, r = self.j["mix"], self.r
        dquant = r.random() < mix["dquant"]
        ac_pred = r.random() < mix["ac_pred"]
        use_dc_vlc = self.q < self.j["dc_thr"]
        dq = r.choice([-2, -1, 1, 2]) if dquant else 0
        self.new_q(dq)
        self.qtab[self.y * self.mbw + self.x] = self.q
        for i in range(4):
            self.set_mv(i, (0, 0))
        blocks, cbp = self.intra_blocks(ac_pred, use_dc_vlc)
        if p_vop:
            self.w.u(1, 0).code(MCBPC_P[4 if dquant else 3][cbp & 3])
        else:
            self.w.code(MCBPC_I[(4 if dquant else 0) + (cbp & 3)])
        self.w.u(1, int(ac_pred)).code(CBPY[cbp >> 2])
        if dquant:
            self.w.u(2, DQUANT[dq])
        self.write_intra_blocks(blocks, use_dc_vlc)
        self.count("intra")
        self.count("ac_pred", int(ac_pred))
        self.count("dc_as_ac", int(not use_dc_vlc))

    def p_mb(self, kind: str) -> None:
        r, j = self.r, self.j
        xy = self.y * self.mbw + self.x
        if kind == "not_coded":
            self.w.u(1, 1)
            self.qtab[xy] = self.q
            for i in range(4):
                self.set_mv(i, (0, 0))
            self.count("not_coded")
            return
        if kind == "intra":
            self.intra_mb(True)
            return
        four = kind == "inter4v"
        dquant = not four and r.random() < j["mix"]["dquant"]
        dq = r.choice([-2, -1, 1, 2]) if dquant else 0
        self.new_q(dq)
        self.qtab[xy] = self.q
        vectors = [self.draw_vector(j["f_code"], j["quarter"]) for _ in range(4 if four else 1)]
        blocks, cbp = self.inter_blocks()
        self.w.u(1, 0).code(MCBPC_P[2 if four else (1 if dquant else 0)][cbp & 3])
        self.w.code(CBPY[(cbp >> 2) ^ 15])
        if dquant:
            self.w.u(2, DQUANT[dq])
            self.count("dquant")
        for i, v in enumerate(vectors):
            px, py = self.mv_pred(i)
            self.code_mvd(v[0], px, j["f_code"])
            self.code_mvd(v[1], py, j["f_code"])
            for b in (range(4) if not four else (i,)):
                self.set_mv(b, v)
        self.write_inter_blocks(blocks)
        self.count("inter4v" if four else "inter")

    def b_mb(self) -> None:
        r, j = self.r, self.j
        if self.x == 0:
            self.last_mv = [[0, 0], [0, 0]]
        xy = self.y * self.mbw + self.x
        if j["future_not_coded"][xy]:
            self.count("b_skipped")
            return
        p1, p2 = j["mix"]["b_modb"]
        u = r.random()
        if u < p1:
            self.w.u(1, 1)
            self.count("b_direct")
            self.count("b_direct_from_4mv", j["future_four_mv"][xy])
            return
        mode = r.randrange(4)
        has_cbp = u >= p1 + p2
        blocks, cbp = self.inter_blocks() if has_cbp else ([{}] * 6, 0)
        dbq = 0
        if mode != 0 and cbp and r.random() < j["mix"]["dbquant"]:
            dbq = r.choice([-2, 2])
        self.w.u(1, 0).u(1, int(not has_cbp)).u(mode + 1, 1)
        if has_cbp:
            self.w.u(6, cbp)
        if mode != 0 and cbp:
            self.w.u(1, int(bool(dbq)))
            if dbq:
                self.w.u(1, int(dbq > 0))
                self.count("dbquant")
        self.new_q(dbq)
        if mode in (1, 3):
            v = self.draw_vector(j["f_code"], j["quarter"])
            for k in (0, 1):
                self.code_mvd(v[k], self.last_mv[0][k], j["f_code"])
            self.last_mv[0] = list(v)
        if mode in (1, 2):
            v = self.draw_vector(j["b_code"], j["quarter"])
            for k in (0, 1):
                self.code_mvd(v[k], self.last_mv[1][k], j["b_code"])
            self.last_mv[1] = list(v)
        if mode == 0:
            for _ in (0, 1):
                self.code_mvd(r.randint(-6, 6), 0, 1)
            self.count("b_direct_from_4mv", j["future_four_mv"][xy])
        self.count("b_" + B_TYPES[mode])
        self.write_inter_blocks(blocks)

    def packet_header(self, index: int) -> None:
        j, w = self.j, self.w
        w.stuffing()
        prefix = 16 if j["type"] == 0 else (j["f_code"] + 15 if j["type"] == 1 else
                                            max(j["f_code"], j["b_code"], 2) + 15)
        w.u(prefix, 0).u(1, 1)
        w.u(max(1, (self.mbw * self.mbh - 1).bit_length()), index)
        self.q = self.r.randint(1, 31)
        w.u(5, self.q)
        hec = self.r.random() < j["mix"]["hec"]
        w.u(1, int(hec))
        if hec:
            for _ in range(j["modulo"]):
                w.u(1, 1)
            w.u(1, 0).u(1, 1).u(j["time_bits"], j["time_inc"]).u(1, 1).u(2, j["type"])
            w.u(3, j["dc_thr_index"])
            if j["type"] != 0:
                w.u(3, j["f_code"])
            if j["type"] == 2:
                w.u(3, j["b_code"])
            self.count("hec")
        self.count("packets")

    def code(self) -> Tuple[bytes, Dict[str, int], list, list]:
        """The VOP's bytes (from its start code), its stats, and for an
        anchor its per-macroblock not-coded and 4MV maps."""
        j, w = self.j, self.w
        w.u(32, 0x1B6).u(2, j["type"])
        for _ in range(j["modulo"]):
            w.u(1, 1)
        w.u(1, 0).u(1, 1).u(j["time_bits"], j["time_inc"]).u(1, 1)
        if not j["coded"]:
            w.u(1, 0).stuffing()
            self.count("vop_coded0")
            return w.bytes(), self.stats, [0] * (self.mbw * self.mbh), [0] * (self.mbw * self.mbh)
        w.u(1, 1)
        if j["type"] == 1:
            w.u(1, j["rounding"])
        w.u(3, j["dc_thr_index"]).u(5, self.q)
        if j["type"] != 0:
            w.u(3, j["f_code"])
        if j["type"] == 2:
            w.u(3, j["b_code"])
        self.count(f"dc_thr{j['dc_thr_index']}")
        kinds = j["kinds"]
        total = self.mbw * self.mbh
        self.rx = self.ry = 0
        self.first_line = True
        for index in range(total):
            self.x, self.y = index % self.mbw, index // self.mbw
            if index and j["resync"] and self.r.random() < j["mix"]["packet"]:
                self.packet_header(index)
                self.rx, self.ry, self.first_line = self.x, self.y, True
                self.clean_buffers()
            if self.x == self.rx and self.y == self.ry + 1:
                self.first_line = False
            if j["type"] != 2 and self.r.random() < j["mix"]["stuffing"]:
                if j["type"] == 1:
                    w.u(1, 0)
                w.code(MCBPC_I_STUFFING if j["type"] == 0 else MCBPC_P_STUFFING)
                self.count("stuffing")
            if j["type"] == 0:
                self.intra_mb(False)
            elif j["type"] == 1:
                self.p_mb(kinds[index])
            else:
                self.b_mb()
        w.stuffing()
        four = [int(k == "inter4v") for k in kinds] if kinds else [0] * total
        nc = [int(k == "not_coded") for k in kinds] if kinds else [0] * total
        return w.bytes(), self.stats, nc, four


def _code_vop(job: dict):
    return _VopCoder(job).code()


# ---------------------------------------------------------------- streams --

def _gop_plan(n_frames: int, gop: int, b_frames: bool, r: random.Random):
    """[(display index, type)] in decode order: closed GOVs of ``gop`` frames
    (I first), anchors every 1-3 frames with B-VOPs between them."""
    plan = []
    for start in range(0, n_frames, gop):
        end = min(start + gop, n_frames)
        plan.append((start, 0))
        k = start
        while k + 1 < end:
            step = r.choice([1, 2, 3]) if b_frames else 1
            anchor = min(k + step, end - 1)
            plan.append((anchor, 1))
            plan += [(d, 2) for d in range(k + 1, anchor)]
            k = anchor
    return plan


def write_mpeg4_syntax_mp4(path, width: int, height: int, n_frames: int, seed: int, *,
                           b_frames: bool = False, quarter: bool = False,
                           mpeg_quant: bool = False, resync: bool = True,
                           signal: Optional[Tuple[bool, int]] = None,
                           user_data: Optional[bytes] = None, in_band: bool = False,
                           workers: int = 1) -> dict:
    """An mp4 of ``n_frames`` random-syntax VOPs (see the module docstring).

    ``b_frames``: B-VOPs between anchors (Advanced Simple, ``ctts``);
    ``quarter``: quarter-sample vectors; ``mpeg_quant``: MPEG quantisation
    with loaded intra and non-intra matrices; ``resync``: video packets with
    header extensions; ``signal``: video_signal_type (full range, matrix);
    ``user_data``: a user data header (b"XviD0050" names an Xvid build, so
    ffmpeg switches to the Xvid IDCT); ``in_band``: the VOS/VO/VOL headers
    also before the first VOP. Without B-VOPs some P-VOPs are not coded.
    ``workers`` > 1 codes the VOPs in a process pool (the caller needs a
    ``__main__`` guard). Returns the tools used, counted."""
    r = random.Random(seed)
    mix, gop, time_res = MIX, GOP, TIME_RES
    advanced = b_frames or quarter or mpeg_quant
    intra_m = inter_m = None
    if mpeg_quant:
        intra_m = [8] + [r.randint(8, 40) for _ in range(63)]
        inter_m = [r.randint(12, 40) for _ in range(64)]
        for m in (intra_m, inter_m):        # a repeated tail, as the syntax allows
            m_zz = [m[ZIGZAG[i]] for i in range(64)]
            tail = r.randint(40, 63)
            for i in range(tail, 64):
                m[ZIGZAG[i]] = m_zz[tail - 1]
    vol = vol_header(width, height, time_res, verid=2 if advanced else 1, quarter=quarter,
                     mpeg_quant=mpeg_quant, matrices=(intra_m, inter_m), resync=resync,
                     low_delay=not b_frames, object_type=0x11 if advanced else 1)
    headers = (BitWriter().u(32, 0x1B0).u(8, 0xF5 if advanced else 0x03).bytes()
               + vo_header(signal) + BitWriter().u(32, 0x100).bytes() + vol)
    if user_data:
        headers += BitWriter().u(32, 0x1B2).bytes() + user_data
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    time_bits = max(1, (time_res - 1).bit_length())
    plan = _gop_plan(n_frames, gop, b_frames, r)
    step = r.choice([1, 2, 3])               # ticks a frame
    jobs, anchors = [], {}
    time_base = last_time_base = 0
    for k, (display, vtype) in enumerate(plan):
        t = display * step
        seconds, inc = divmod(t, time_res)
        gov = vtype == 0 and display > 0
        if gov:
            time_base = seconds               # the GOV's time code sets the base
        if vtype != 2:
            last_time_base = time_base
            modulo, time_base = seconds - time_base, seconds
        else:
            modulo = seconds - last_time_base
        coded = not (vtype == 1 and not b_frames and r.random() < mix["vop_coded0"])
        kinds = None
        if vtype == 1:
            kinds = [r.choices(["not_coded", "intra", "inter4v", "inter"],
                               [mix["not_coded"], mix["intra"], mix["four_mv"],
                                1 - mix["not_coded"] - mix["intra"] - mix["four_mv"]])[0]
                     for _ in range(mbw * mbh)]
        dc_thr_index = r.randrange(8)
        job = dict(seed=r.getrandbits(32), mbw=mbw, mbh=mbh, type=vtype, modulo=modulo,
                   time_inc=inc, time_bits=time_bits, coded=coded, rounding=r.randrange(2),
                   dc_thr_index=dc_thr_index, dc_thr=DC_THRESHOLD[dc_thr_index],
                   quant=r.randint(1, 31), f_code=r.randint(1, 7), b_code=r.randint(1, 7),
                   quarter=quarter, mpeg_quant=mpeg_quant, intra_matrix=intra_m or DEFAULT_INTRA,
                   inter_matrix=inter_m or DEFAULT_INTER, resync=resync, mix=mix, kinds=kinds,
                   gov=gov, gov_seconds=seconds, display=display)
        jobs.append(job)
    # B-VOPs read their future reference's maps: the anchor decoded last before them
    future = None
    for job in jobs:
        if job["type"] != 2:
            future = job
        elif future is not None:
            kinds = future["kinds"] or ["intra"] * (mbw * mbh)
            job["future_not_coded"] = [int(k == "not_coded") for k in kinds]
            job["future_four_mv"] = [int(k == "inter4v") for k in kinds]
    if workers > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            coded_vops = pool.map(_code_vop, jobs, chunksize=1)
    else:
        coded_vops = [_code_vop(j) for j in jobs]
    stats: Dict = {"vops": [], "tools": {}}
    samples = []
    for k, (job, (vop, st, _, _)) in enumerate(zip(jobs, coded_vops)):
        pre = b""
        if k == 0 and in_band:
            pre = headers
        if job["gov"]:
            s = job["gov_seconds"]
            pre += BitWriter().u(32, 0x1B3).u(5, s // 3600).u(6, s // 60 % 60).u(1, 1).u(
                6, s % 60).u(1, 1).u(1, 0).stuffing().bytes()
            stats["tools"]["gov"] = stats["tools"].get("gov", 0) + 1
        samples.append(pre + vop)
        stats["vops"].append("IPB"[job["type"]] + ("" if job["coded"] else "0"))
        for key, v in st.items():
            stats["tools"][key] = stats["tools"].get(key, 0) + v
    for flag, on in (("quarter", quarter), ("mpeg_quant", mpeg_quant), ("b_frames", b_frames),
                     ("signal", signal is not None), ("cropped", width % 16 or height % 16)):
        stats["tools"][flag] = int(bool(on))
    delay = 1 if b_frames else 0
    ctts = [d + delay - i for i, (d, _) in enumerate(plan)] if b_frames else None
    write_mp4(path, samples, visual_sample_entry(b"mp4v", width, height, esds_box(headers)),
              width, height, sync=[t == 0 for _, t in plan], ctts=ctts,
              edit_start=ctts[0] if ctts else 0)
    return stats


def planes_sha256(frames) -> Tuple[str, str]:
    """(SHA-256 of the Y planes, of the U and V planes frame by frame) of
    [(Y, U, V)] uint8 planes: what :data:`PINNED_SHA256` holds."""
    import hashlib

    y, uv = hashlib.sha256(), hashlib.sha256()
    for f in frames:
        y.update(f[0].tobytes())
        for p in f[1:]:
            uv.update(p.tobytes())
    return y.hexdigest(), uv.hexdigest()


# The writer's streams, as the tests and chip_smoke.py write them:
# name -> (width, height, n_frames, seed, keyword arguments)
STREAMS = {
    "simple": (176, 144, 16, 1, dict(signal=(False, 1))),
    "simple_cropped": (120, 88, 16, 2, dict(signal=(True, 5), in_band=True)),
    "advanced": (160, 112, 20, 3, dict(b_frames=True, quarter=True, mpeg_quant=True)),
    "advanced_hpel": (136, 104, 20, 4, dict(b_frames=True, resync=True)),
    "xvid_idct": (128, 96, 14, 5, dict(user_data=b"XviD0050", quarter=True)),
    # user data that keys ffmpeg's workarounds: an old Xvid build (references
    # padded from the picture's size, quarter-sample chroma rounded up), a
    # DivX 5 build (the other chroma rounding), an old libavcodec (the edge)
    "xvid_old": (120, 88, 14, 9, dict(user_data=b"XviD0001", quarter=True)),
    "divx_qpel": (120, 88, 14, 9, dict(user_data=b"DivX503b1393", quarter=True, b_frames=True)),
    "lavc_old": (120, 88, 14, 9, dict(user_data=b"FFmpeg0.4.9b4654", b_frames=True)),
}

# SHA-256 of ffmpeg's decode (cv2 5.0.0's libavcodec 62.28.101) of each
# STREAMS file, over every frame cv2 reads (the coded VOPs in presentation
# order): (the Y planes, the U and V planes frame by frame).
# tests/test_torch_mpeg4.py holds them; chip_smoke.py holds the port's decode
# on the card's machine, which has no cv2, against them
PINNED_SHA256: Dict[str, Tuple[str, str]] = {
    "simple": ("54422fd2e0c1abd67e8fe15b6c06b083d9db3fb00165ceaf228adc8e74635295",
               "fc1539c14e7ed81f61dfe36d9bac1b58ad2f44e5b1ce3a29a070caa54dccfb05"),
    "simple_cropped": ("cfd3d78858b7be616de49aa7754a634cd139fbebc5308e0adf5c3ab170b7edf1",
                       "af2b46a81631460070db7afbb73da0d5fb6040af7f91c3b47b06b14a378c4868"),
    "advanced": ("384e8a1eace8052e8bc21cff937d5b36a3a37ec8877deb1c1b8f6e455f2048e5",
                 "6c313f6eed9195219e59d40cb38c25b69ad2eec8cadf930828a450d21f1a5e09"),
    "advanced_hpel": ("c2f2dd6f79bcec422534a177d21e77209878e84c3f158f9e82af1fd5ae8ee46f",
                      "1975eb1457dd5940bc0c13876e0dbf7e0803e2c94e979d2f196133b842768005"),
    "xvid_idct": ("7153dc801b2af3053ab0926f13b7aeb888d32e014de6c0fca8e064c4428990aa",
                  "29945f850096c48785824e684c8a1f08f449dba8311a2ecdfb16c3d8dba57eeb"),
    "xvid_old": ("c37948f54d7b5b312058ebf34df0abf5b5811ca01e31f20533839c2abd727661",
                 "3c93998d61424bb42ea6e2d6c0d8f9a529d3f06a788842b2823d31e08feb3204"),
    "divx_qpel": ("5f8f28c10ecf4a20d336bb81d82430691008a4b3d2b370e40144f56e67ccd0aa",
                  "2e23366fe4b34df9f85acdb8b437759a12e38a7e33dda6a23c67a30af289b6af"),
    "lavc_old": ("58cc12d4f40da5866defbecafaeba5776f87dd6280fdff275ae60e80cd4c4678",
                 "57e619538c7cdd82010a028a6959194fb3f1b41cb63f9ec23b87bb75536e9bc3"),
}

# The same for the cv2-written files under tests/data/mpeg4/ (cv2 5.0.0's
# VideoWriter, "mp4v"; tests/test_torch_mpeg4.py writes them)
PINNED_CV2_SHA256: Dict[str, Tuple[str, str]] = {
    "qcif_smooth": ("e9ffd11d706a0e203074037b7b84cd17db98a334ecc59f417eb4d9616566ee37",
                    "d27740396c343331b1241636a13317fb39a925ce9a39dd9e6e9f0d0a3652be1c"),
    "qvga_texture": ("63a14b51cb5f6eb50e972bcb1813618a9ec5d8899f096782ed586a19df612b85",
                     "cd82f5dd582b0eca67dd8c6920217fbdbb48ee3ee5b686b904857eff84f954af"),
    "crop_noisy": ("052442df17baf52c34b66545d5775d240d1987e96ffa863f7c6cdcaeb5b7dd91",
                   "23200f198d61c08a9eb4ac2476b52637639ec45e29348de0f2c8164ae09e3a36"),
}

# A stream at an odd height (B-VOPs, so every VOP is coded): cv2 converts its
# pictures through swscale's scaler with the left chroma siting ffmpeg's
# mpeg4 decoder gives them. The SHA-256 of the port's RGB frames (its frame
# count first; container_writer.rgb_sha256), held against cap4d_tpu's
# load_frame by tests/test_torch_swscale.py, and on the card by chip_smoke.py
ODD_STREAM = dict(n_frames=6, seed=1, b_frames=True)
PINNED_ODD_RGB_SHA256 = {
    (99, 57): (6, "f3fac20f083a28f2491a9fd1bf295d192b5f55838d56d314b3c54103bf673690"),
    (97, 57): (6, "460f447cd3af044d53b397ebf232d3fd49d92c5cd156312bd66b997214311a4c"),
}

REFUSALS = {"interlaced": "interlaced", "sprite": "sprite_enable 1", "gmc": "sprite_enable 2",
            "data_partitioned": "data_partitioned", "rvlc": "reversible_vlc",
            "short_header": "short_video_header", "scalability": "scalability",
            "shape": "video_object_layer_shape", "newpred": "newpred_enable",
            "reduced_resolution": "reduced_resolution_vop_enable", "not_8_bit": "not_8_bit",
            "studio": "studio profile", "complexity": "complexity_estimation_disable 0",
            "packed": "more than one VOP in one sample",
            "old_lavc_qpel": "old quarter-sample filter"}


def write_mpeg4_refusal_mp4(path, tool: str, width: int = 32, height: int = 32) -> str:
    """A two-VOP mp4 whose headers use a tool the port's decoder refuses (a
    key of :data:`REFUSALS`): a VOL with the tool's field set (or an H.263
    picture start code, the studio profile's VOS, quarter-sample under user
    data naming a libavcodec build before 4653, or two VOPs in the second
    sample), then I- and P-VOPs of random syntax. Returns the phrase the
    decoder's error names."""
    if tool not in REFUSALS:
        raise ValueError(f"unknown refusal {tool!r}; one of {sorted(REFUSALS)}")
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "ok.mp4"
        write_mpeg4_syntax_mp4(src, width, height, 2, 7, resync=False,
                               quarter=tool == "old_lavc_qpel")
        from cap4d_torch.data.mp4 import read_track
        t = read_track(src)
        samples = [t.sample(i) for i in range(len(t))]
    vol = vol_header(width, height, TIME_RES, verid=2, quarter=tool == "old_lavc_qpel",
                     tool=tool if tool not in ("short_header", "studio", "packed",
                                               "old_lavc_qpel") else None)
    profile = 0xE1 if tool == "studio" else 0x03
    dsi = (BitWriter().u(32, 0x1B0).u(8, profile).bytes() + vo_header()
           + BitWriter().u(32, 0x100).bytes() + vol)
    if tool == "old_lavc_qpel":
        dsi += BitWriter().u(32, 0x1B2).bytes() + b"FFmpeg0.4.9b4600"
    if tool == "short_header":
        # an H.263 picture: picture_start_code (22 bits), temporal reference, PTYPE ...
        samples[0] = BitWriter().u(22, 0x20).u(8, 0).u(5, 0b10000).u(3, 2).u(1, 0).u(
            4, 0).u(5, 8).u(1, 0).u(3, 0).u(4, 0).bytes()
        dsi = b""
    if tool == "packed":
        samples[1] = samples[1] + samples[1]
    write_mp4(path, samples, visual_sample_entry(b"mp4v", width, height, esds_box(dsi)),
              width, height, sync=[True, False])
    return REFUSALS[tool]
