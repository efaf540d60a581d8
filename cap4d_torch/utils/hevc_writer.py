"""Seeded random-syntax HEVC streams: test input for the port's HEVC
decoder (``runtime/hevc.cpp``), written without an encoder.

Neither the test machine's cv2 (its libavcodec has no software HEVC
encoder) nor the card's machine has one, so this writer emits syntax, not
pictures, as ``h264_writer.py`` does for H.264: every syntax element of
every CTU (SAO parameters and merges, the coding quadtree, transquant
bypass, NxN partitions, PCM samples, intra modes through the most probable
mode list or the remaining mode, chroma modes, the transform tree and its
coded block flags, cu_qp_delta, transform_skip, residuals with sign data
hiding and Rice-coded remainders; in P and B slices cu_skip_flag,
pred_mode_flag, the eight part modes, merge_idx, inter_pred_idc,
reference indices, motion vector differences, mvp flags and
rqt_root_cbf) is drawn from a seeded ``random.Random`` and CABAC-coded as
the standard's parsing process reads it back (ITU-T H.265, clauses 7 and
9). The stream decodes to whatever that syntax means; ffmpeg (inside cv2,
in the tests) is the oracle.

The writer keeps only the state coding needs: z-scan availability (slices,
tiles), each 4x4 unit's coding depth, intra mode and skip flag (the
contexts of split_cu_flag, cu_skip_flag and the mode lists), which
quantization group has coded its delta, and the CABAC contexts with their
wavefront and dependent-slice storage. It never reconstructs a pixel or a
motion vector. For inter streams (``write_hevc_inter_stream``) it keeps
the DPB as the RPS marks it (short- and long-term pictures, the reference
lists the RPS and list modifications build, the collocated picture) and a
model of ffmpeg's output process (``output_model``: bumping by
sps_max_num_reorder_pics and sps_max_dec_pic_buffering, IRAP pictures
that output or discard the pictures waiting), which gives each picture's
presentation rank.

Parameter sets: VPS, SPS (sub-layers, conformance window, scaling lists
default, signalled and predicted, PCM, short-term reference picture sets
with inter prediction and long-term pictures, AMP, temporal MVP, a VUI
with timing, HRD and bitstream restriction), PPS (tiles uniform and
explicit, wavefronts, dependent slices, sign hiding, transform skip,
cu_qp_delta, chroma QP offsets, deblocking control and override, PPS
scaling lists, transquant bypass, extra slice header bits, header
extensions, cabac_init_present_flag, weighted prediction,
lists_modification_present_flag, Log2ParMrgLevel). Pictures: IDR (W_RADL,
N_LP), CRA with leading pictures (RADL; RASL, which ffmpeg discards after
the CRA that starts the stream and decodes after a later one), BLA,
TRAIL_R/N, TSA and STSA, pic_output_flag 0, no_output_of_prior_pics_flag;
several slice segments a picture, I slices among a P or B picture's.

Where ffmpeg departs from the standard the writer steers clear or the
decoder copies ffmpeg (``runtime/hevc.cpp``'s header): wavefront slices
begin at the start of a CTB row (ffmpeg loads the stored contexts at a row
start without checking that the CTB above-right lies in the slice); tiles
and wavefronts never go together (Main profile forbids it, and ffmpeg's
row test counts in tile scan); a slice boundary's SAO follows the current
CTB's slice_loop_filter_across_slices_enabled_flag and the chroma
deblocking QP is clipped to 0..57, and a slice that overrides deblocking
to disabled keeps the offsets of the slice header before it (all copied
by the decoder). In inter streams: no predicted RPS derives a delta of 0
(ffmpeg would count it as a picture); no generated (missing) picture is
the collocated picture (ffmpeg's motion there is whatever its buffer pool
held); a picture names an absent picture only where ffmpeg generates it,
in an IRAP picture's RPS (ffmpeg 8 refuses a trailing picture that does);
long-term pictures named by LSB alone are unique in the DPB (ffmpeg takes
the first match in its own DPB order).

Containers: ``write_hevc_mp4`` (``hvc1``, or ``hev1`` with the parameter
sets in band as well; ``ctts`` and an edit list where pictures show out of
decode order), and through ``container_writer`` Matroska and AVI.
"""

from __future__ import annotations

import hashlib
import random
import re
import struct
from typing import List, Optional, Tuple

from cap4d_torch.utils.h264_writer import _Cabac, _Writer

# The CABAC contexts of I slices, in runtime/hevc.cpp's order, and their
# initValue for initType 0 (Tables 9-5 to 9-37).
C_SAO_MERGE, C_SAO_TYPE, C_SPLIT_CU, C_BYPASS, C_PART, C_PREV_INTRA = 0, 1, 2, 5, 6, 7
C_CHROMA_MODE, C_SPLIT_TU, C_CBF_LUMA, C_CBF_CHROMA, C_QP_DELTA, C_TS = 8, 9, 12, 14, 18, 20
C_LAST_X, C_LAST_Y, C_CSBF, C_SIG, C_GT1, C_GT2 = 22, 40, 58, 62, 104, 128
# the contexts of P and B slices, after the I-slice ones
C_SKIP, C_PRED_MODE, C_PART_INTER, C_MERGE_FLAG, C_MERGE_IDX = 134, 137, 138, 141, 142
C_INTER_PRED, C_REF_IDX, C_MVD_GT0, C_MVD_GT1, C_MVP, C_RQT_ROOT = 143, 148, 150, 151, 152, 153
_LAST = [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127, 111, 79, 108, 123, 63]
INIT = ([153, 200, 139, 141, 157, 154, 184, 184, 63, 153, 138, 138, 111, 141, 94, 138, 182, 154,
         154, 154, 139, 139] + _LAST + _LAST + [91, 171, 134, 141]
        + [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153, 125, 107, 125,
           141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 140, 139, 182, 182, 152, 136, 152,
           136, 153, 136, 139, 111, 136, 139, 111]
        + [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107, 122, 152, 140, 179,
           166, 182, 140, 227, 122, 197]
        + [138, 153, 136, 167, 152, 152])
# initType 1 and 2 (P and B slices; cabac_init_flag swaps them), the I-slice
# contexts then the inter ones (Tables 9-5 to 9-37), and initType 0's CNU
# for the inter contexts
_LAST1 = [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95, 94, 108, 123, 108]
_LAST2 = [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111, 79, 108, 123, 93]
INIT_INTER = {
    1: ([153, 185, 107, 139, 126, 154, 154, 154, 152, 124, 138, 94, 153, 111, 149, 107, 167, 154,
         154, 154, 139, 139] + _LAST1 + _LAST1 + [121, 140, 61, 154]
        + [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136, 153, 154, 166, 183,
           140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 123, 123, 107, 121, 107,
           121, 167, 151, 183, 140, 151, 183, 140]
        + [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 137, 169,
           194, 166, 167, 154, 167, 137, 182]
        + [107, 167, 91, 122, 107, 167]
        + [197, 185, 201, 149, 139, 154, 154, 110, 122, 95, 79, 63, 31, 31, 153, 153, 140, 198,
           168, 79]),
    2: ([153, 160, 107, 139, 126, 154, 154, 183, 152, 224, 167, 122, 153, 111, 149, 92, 167, 154,
         154, 154, 139, 139] + _LAST2 + _LAST2 + [121, 140, 61, 154]
        + [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136, 153, 154, 166, 183,
           140, 136, 153, 154, 166, 183, 140, 136, 153, 154, 170, 153, 138, 138, 122, 121, 122,
           121, 167, 151, 183, 140, 151, 183, 140]
        + [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153, 121, 136, 122, 169,
           208, 166, 167, 154, 152, 167, 182]
        + [107, 167, 91, 107, 107, 167]
        + [197, 185, 201, 134, 139, 154, 154, 154, 137, 95, 79, 63, 31, 31, 153, 153, 169, 198,
           168, 79]),
}
CTX_IDX_MAP = [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8]

# NAL unit types
TRAIL_N, TRAIL_R, RADL_N, RADL_R, RASL_N, RASL_R = 0, 1, 6, 7, 8, 9
BLA_W_LP, BLA_W_RADL, BLA_N_LP, IDR_W_RADL, IDR_N_LP, CRA = 16, 17, 18, 19, 20, 21
VPS, SPS, PPS, PREFIX_SEI = 32, 33, 34, 39


def _scans():
    """ScanOrder[log2 size][scanIdx] -> [(x, y)] (6.5.3-6.5.5)."""
    out = []
    for log2 in range(4):
        n = 1 << log2
        diag, x, y = [], 0, 0
        while len(diag) < n * n:
            while y >= 0:
                if x < n and y < n:
                    diag.append((x, y))
                y -= 1
                x += 1
            y, x = x, 0
        out.append([diag, [(j % n, j // n) for j in range(n * n)],
                    [(j // n, j % n) for j in range(n * n)]])
    return out


SCANS = _scans()


def contexts(qp: int, init_type: int = 0) -> List[int]:
    """The initial context states (pStateIdx << 1 | valMps) at SliceQpY for
    initType ``init_type`` (0: I slices)."""
    q = min(max(qp, 0), 51)
    out = []
    for v in (INIT + [154] * 20 if init_type == 0 else INIT_INTER[init_type]):
        m, n = (v >> 4) * 5 - 45, ((v & 15) << 3) - 16
        pre = min(max(((m * q) >> 4) + n, 1), 126)
        out.append((63 - pre) << 1 if pre <= 63 else ((pre - 64) << 1) | 1)
    return out


class _HCabac(_Cabac):
    """``h264_writer``'s arithmetic encoder with HEVC's I-slice contexts."""

    def __init__(self, w: _Writer, qp: int, init_type: int = 0):
        self.w = w
        self.st = contexts(qp, init_type)
        self.start()


def _ebsp(rbsp: bytes) -> bytes:
    """Emulation prevention: 0x03 after two zero bytes that precede a byte <= 3."""
    return re.sub(b"\x00\x00(?=[\x00-\x03])", b"\x00\x00\x03", rbsp)


def nal(kind: int, rbsp: bytes, tid: int = 0) -> bytes:
    """A NAL unit: the two-byte header (layer 0), then the escaped RBSP."""
    return bytes([kind << 1, tid + 1]) + _ebsp(rbsp)


# -------------------------------------------------------- parameter sets --

def _ptl(w: _Writer, profile: int, sub_layers_minus1: int) -> None:
    w.u(2, 0).u(1, 0).u(5, profile)
    w.u(32, (1 << (31 - profile)) | (1 << 30 if profile == 3 else 0))   # compatibility flags
    w.u(4, 0b1001).u(32, 0).u(12, 0)     # progressive, frame only; constraint flags
    w.u(8, 120)
    for _ in range(sub_layers_minus1):
        w.u(1, 0).u(1, 0)
    if sub_layers_minus1:
        for _ in range(sub_layers_minus1, 8):
            w.u(2, 0)


def vps_rbsp(sp: dict) -> bytes:
    w = _Writer()
    w.u(4, sp["vps_id"]).u(1, 1).u(1, 1).u(6, 0).u(3, sp["sub_layers"] - 1)
    w.u(1, int(sp.get("nesting", True))).u(16, 0xFFFF)
    _ptl(w, sp["profile"], sp["sub_layers"] - 1)
    w.u(1, 1)
    for _ in range(sp["sub_layers"]):
        w.ue(sp["dpb"] - 1).ue(sp["reorder"]).ue(0)
    w.u(6, 0).ue(0).u(1, 0).u(1, 0)
    return w.trailing()


def _scaling_list(w: _Writer, rng: random.Random) -> None:
    for size in range(4):
        for m in range(0, 6, 3 if size == 3 else 1):
            mode = rng.random()
            if mode < 0.3:
                w.u(1, 0).ue(0)                          # the default list
            elif mode < 0.5 and m >= (3 if size == 3 else 1):
                w.u(1, 0).ue(rng.randint(1, m // (3 if size == 3 else 1)))   # copy a previous one
            else:
                w.u(1, 1)
                nxt = 8
                if size > 1:
                    dc = rng.randint(-7, 40)
                    w.se(dc)
                    nxt = dc + 8
                for _ in range(min(64, 1 << (4 + (size << 1)))):
                    target = rng.randint(4, 60)
                    delta = (target - nxt + 128) % 256 - 128
                    w.se(delta)
                    nxt = (nxt + delta + 256) % 256


def _st_rps(w: _Writer, rng: random.Random, idx: int, num: int, sizes: List[int],
            empty: bool = False) -> int:
    """st_ref_pic_set(idx): an empty set, a random explicit one, or one
    predicted from an earlier set with every picture dropped; returns its
    NumDeltaPocs."""
    if idx:
        pred = not empty and rng.random() < 0.4 or (empty and idx == num and rng.random() < 0.5)
        w.u(1, int(pred))
        if pred:
            delta_idx = rng.randint(1, idx) if idx == num else 1
            if idx == num:
                w.ue(delta_idx - 1)
            w.u(1, rng.randint(0, 1)).ue(rng.randint(0, 5))
            for _ in range(sizes[idx - delta_idx] + 1):
                w.u(1, 0).u(1, 0)           # used_by_curr_pic_flag, use_delta_flag: dropped
            return 0
    if empty:
        w.ue(0).ue(0)
        return 0
    neg, pos = rng.randint(0, 3), rng.randint(0, 2)
    w.ue(neg).ue(pos)
    for _ in range(neg + pos):
        w.ue(rng.randint(0, 4)).u(1, rng.randint(0, 1))
    return neg + pos


def sps_rbsp(sp: dict, rng: random.Random) -> bytes:
    w = _Writer()
    w.u(4, sp["vps_id"]).u(3, sp["sub_layers"] - 1).u(1, int(sp.get("nesting", True)))
    _ptl(w, sp["profile"], sp["sub_layers"] - 1)
    w.ue(sp["id"]).ue(sp.get("chroma_format", 1))
    w.ue(sp["coded_w"]).ue(sp["coded_h"])
    crop = sp["crop"]
    w.u(1, int(any(crop)))
    if any(crop):
        for v in crop:
            w.ue(v // 2)
    w.ue(sp.get("bit_depth", 8) - 8).ue(sp.get("bit_depth", 8) - 8).ue(sp["log2_poc"] - 4)
    w.u(1, 1)
    for _ in range(sp["sub_layers"]):
        w.ue(sp["dpb"] - 1).ue(sp["reorder"]).ue(0)
    w.ue(sp["log2_min_cb"] - 3).ue(sp["log2_ctb"] - sp["log2_min_cb"])
    w.ue(sp["log2_min_tb"] - 2).ue(sp["log2_max_tb"] - sp["log2_min_tb"])
    depth_inter = rng.randint(0, sp["log2_ctb"] - sp["log2_min_tb"])
    sp["tu_depth_inter"] = depth_inter = sp.get("tu_depth_inter", depth_inter)
    w.ue(depth_inter).ue(sp["tu_depth"])
    w.u(1, int(sp["scaling"] is not None))
    if sp["scaling"] is not None:
        w.u(1, int(sp["scaling"] == "sps"))
        if sp["scaling"] == "sps":
            _scaling_list(w, rng)
    amp = rng.randint(0, 1)
    sp["amp"] = amp = int(sp.get("amp", amp))
    w.u(1, amp).u(1, int(sp["sao"])).u(1, int(sp["pcm"] is not None))
    if sp["pcm"] is not None:
        bl, bc, lo, hi, nofilter = sp["pcm"]
        w.u(4, bl - 1).u(4, bc - 1).ue(lo - 3).ue(hi - lo).u(1, int(nofilter))
    sizes: List[int] = []
    if "rps_sets" in sp:        # an inter stream's sets: (deltas, used flags) each
        w.ue(len(sp["rps_sets"]))
        for i, rps in enumerate(sp["rps_sets"]):
            _write_rps(w, rps, sp["rps_sets"][:i], i, len(sp["rps_sets"]), rng)
    else:
        w.ue(sp["num_rps"])
        for i in range(sp["num_rps"]):
            sizes.append(_st_rps(w, rng, i, sp["num_rps"], sizes, empty=i == sp["empty_rps"]))
    sp["rps_sizes"] = sizes
    w.u(1, int(sp["long_term"]))
    if sp["long_term"]:
        w.ue(sp["num_lt_sps"])
        if "lt_sps" in sp:       # (poc lsb, used) each
            for lsb, used in sp["lt_sps"]:
                w.u(sp["log2_poc"], lsb).u(1, int(used))
        else:
            for _ in range(sp["num_lt_sps"]):
                w.u(sp["log2_poc"], rng.randrange(1 << sp["log2_poc"])).u(1, rng.randint(0, 1))
    w.u(1, int(sp.get("tmvp", False))).u(1, int(sp["strong"]))   # temporal MVP, strong smoothing
    vui = sp["vui"]
    w.u(1, int(vui is not None))
    if vui is not None:
        w.u(1, 1).u(8, 1)                    # aspect_ratio_idc 1 (square)
        w.u(1, 0)
        w.u(1, 1).u(3, 5).u(1, int(vui["full_range"])).u(1, 1)
        w.u(8, vui["primaries"]).u(8, vui["transfer"]).u(8, vui["matrix"])
        w.u(1, int(vui.get("chroma_loc") is not None))
        if vui.get("chroma_loc") is not None:
            w.ue(vui["chroma_loc"]).ue(vui["chroma_loc"])
        w.u(1, 0).u(1, 0).u(1, 0)            # neutral chroma, field_seq_flag, frame field info
        w.u(1, int(vui.get("display_window", False)))
        if vui.get("display_window", False):
            w.ue(1).ue(2).ue(0).ue(1)
        w.u(1, 1).u(32, 1001).u(32, 30000).u(1, 0)
        w.u(1, int(vui.get("hrd", False)))
        if vui.get("hrd", False):
            # hrd_parameters(1, max_sub_layers_minus1): NAL HRD, one CPB
            w.u(1, 1).u(1, 0).u(1, 0).u(4, 2).u(4, 3).u(5, 23).u(5, 23).u(5, 23)
            for _ in range(sp["sub_layers"]):
                w.u(1, 0).u(1, 0).u(1, 0).ue(0)      # not fixed, not low delay, 1 CPB
                w.ue(5000).ue(6000).u(1, 0)
        w.u(1, 1).u(1, 0).u(1, 1).u(1, 1).ue(0).ue(2).ue(1).ue(15).ue(15)
    w.u(1, 0)
    return w.trailing()


def pps_rbsp(pp: dict, sp: dict, rng: random.Random) -> bytes:
    w = _Writer()
    w.ue(pp["id"]).ue(sp["id"]).u(1, int(pp["dependent"])).u(1, int(pp["output_flag"]))
    w.u(3, pp["extra_bits"]).u(1, int(pp["sdh"])).u(1, int(pp.get("cabac_init", False)))
    w.ue(pp.get("num_ref", (1, 1))[0] - 1).ue(pp.get("num_ref", (1, 1))[1] - 1)
    w.se(pp["init_qp"] - 26)
    w.u(1, int(pp["cip"])).u(1, int(pp["ts"])).u(1, int(pp["qp_delta"] is not None))
    if pp["qp_delta"] is not None:
        w.ue(pp["qp_delta"])
    w.se(pp["cqp"][0]).se(pp["cqp"][1]).u(1, int(pp["slice_cqp"]))
    w.u(1, int(pp.get("weighted", False))).u(1, int(pp.get("weighted_bi", False)))
    w.u(1, int(pp["bypass"])).u(1, int(pp["tiles"] is not None)).u(1, int(pp["wpp"]))
    if pp["tiles"] is not None:
        cols, rows, explicit = pp["tiles"]
        w.ue(len(cols) - 1).ue(len(rows) - 1).u(1, int(not explicit))
        if explicit:
            for c in cols[:-1]:
                w.ue(c - 1)
            for r in rows[:-1]:
                w.ue(r - 1)
        w.u(1, int(pp["lf_tiles"]))
    w.u(1, int(pp["lf_slices"]))
    db = pp["deblock"]          # (override_enabled, disabled, beta, tc) or None
    w.u(1, int(db is not None))
    if db is not None:
        w.u(1, int(db[0])).u(1, int(db[1]))
        if not db[1]:
            w.se(db[2]).se(db[3])
    w.u(1, int(pp["pps_scaling"]))
    if pp["pps_scaling"]:
        _scaling_list(w, rng)
    w.u(1, int(pp.get("list_mod", False))).ue(pp.get("par_mrg", 2) - 2)
    w.u(1, int(pp["header_ext"])).u(1, 0)
    return w.trailing()


# ---------------------------------------------------------- the picture --

class _Layout:
    """CTB raster/tile scan maps, tile ids and MinTbAddrZs of a picture."""

    def __init__(self, sp: dict, pp: dict):
        self.log2_ctb, self.log2_min_tb = sp["log2_ctb"], sp["log2_min_tb"]
        self.w, self.h = sp["coded_w"], sp["coded_h"]
        ctb = 1 << self.log2_ctb
        W, H = -(-self.w // ctb), -(-self.h // ctb)
        self.W, self.H = W, H
        if pp["tiles"] is None:
            cw, rh = [W], [H]
        else:
            cols, rows, explicit = pp["tiles"]
            if explicit:     # the last column and row take the rest, as the PPS codes them
                cw = list(cols[:-1]) + [W - sum(cols[:-1])]
                rh = list(rows[:-1]) + [H - sum(rows[:-1])]
                if min(cw + rh) < 1:
                    raise ValueError(f"tile sizes {cols} x {rows} do not fit {W} x {H} CTBs")
            else:
                nc, nr = len(cols), len(rows)
                cw = [((i + 1) * W) // nc - (i * W) // nc for i in range(nc)]
                rh = [((j + 1) * H) // nr - (j * H) // nr for j in range(nr)]
        cb, rb = [0], [0]
        for c in cw:
            cb.append(cb[-1] + c)
        for r in rh:
            rb.append(rb[-1] + r)
        self.rs2ts = [0] * (W * H)
        self.tile = [0] * (W * H)           # by raster address
        ts = 0
        self.tile_starts = []
        for j in range(len(rh)):
            for i in range(len(cw)):
                self.tile_starts.append(ts)
                for y in range(rb[j], rb[j + 1]):
                    for x in range(cb[i], cb[i + 1]):
                        self.rs2ts[y * W + x] = ts
                        self.tile[y * W + x] = j * len(cw) + i
                        ts += 1
        self.ts2rs = [0] * (W * H)
        for rs, t in enumerate(self.rs2ts):
            self.ts2rs[t] = rs
        shift = self.log2_ctb - self.log2_min_tb
        self.mw = W << shift
        zs = []
        for y in range(H << shift):
            for x in range(W << shift):
                v = self.rs2ts[W * (y >> shift) + (x >> shift)] << (2 * shift)
                for i in range(shift):
                    m = 1 << i
                    v += (m * m if m & x else 0) + (2 * m * m if m & y else 0)
                zs.append(v)
        self.zs = zs


class _PictureCoder:
    """The CTUs of one picture's slice segments."""

    def __init__(self, rng: random.Random, sp: dict, pp: dict, lay: _Layout):
        self.rng, self.sp, self.pp, self.lay = rng, sp, pp, lay
        self.u4w = sp["coded_w"] >> 2
        n4 = self.u4w * (sp["coded_h"] >> 2)
        self.ipm = [1] * n4
        self.depth = [0] * n4
        self.skip = [0] * n4
        self.slice_of = [-1] * (lay.W * lay.H)     # by raster address
        self.wpp_ctx = None

    def avail(self, xc, yc, xn, yn) -> bool:
        sp, lay = self.sp, self.lay
        if xn < 0 or yn < 0 or xn >= sp["coded_w"] or yn >= sp["coded_h"]:
            return False
        t = lay.log2_min_tb
        if lay.zs[(yn >> t) * lay.mw + (xn >> t)] > lay.zs[(yc >> t) * lay.mw + (xc >> t)]:
            return False
        c = lay.log2_ctb
        nb, cur = (yn >> c) * lay.W + (xn >> c), (yc >> c) * lay.W + (xc >> c)
        return self.slice_of[nb] == self.slice_of[cur] and lay.tile[nb] == lay.tile[cur]

    def u4(self, x, y) -> int:
        return (y >> 2) * self.u4w + (x >> 2)

    def fill(self, m, x0, y0, size, v):
        for y in range(y0, min(y0 + size, self.sp["coded_h"]), 4):
            for x in range(x0, min(x0 + size, self.sp["coded_w"]), 4):
                m[self.u4(x, y)] = v

    # ------------------------------------------------------- segments --
    def segment(self, sh: dict, ts: int, end_ts: int) -> Tuple[bytes, List[int]]:
        """The slice data of CTBs [ts, end_ts) in tile scan: (bytes, the
        byte offsets where each substream after the first starts)."""
        lay, pp = self.lay, self.pp
        W = lay.W
        w = _Writer()
        init = sh.get("init_type", 0)
        cab = _HCabac(w, sh["qp"], init)
        rs = lay.ts2rs[ts]
        tile_start = pp["tiles"] is not None and ts in lay.tile_starts and ts > 0
        if sh["dependent"] and not tile_start:
            cab.st = list(self.carry)
        if pp["wpp"] and rs % W == 0:
            if W == 1:
                cab.st = contexts(sh["qp"], init)
            elif sh["dependent"]:
                cab.st = list(self.wpp_ctx)
        self.qp_delta_coded = False
        starts = []
        while True:
            rs = lay.ts2rs[ts]
            self.slice_of[rs] = sh["slice_addr"]
            self.ctu(cab, sh, rs)
            ts += 1
            if pp["wpp"] and (ts % W == 2 or (W == 2 and ts % W == 0)):
                self.wpp_ctx = list(cab.st)
            last = ts == end_ts
            cab.terminate(int(last))
            if last:
                w.align(0)
                break
            nrs = lay.ts2rs[ts]
            new_tile = pp["tiles"] is not None and ts in lay.tile_starts
            new_row = pp["wpp"] and nrs % W == 0
            if new_tile or new_row:
                cab.terminate(1)                     # end_of_subset_one_bit
                w.align(0)
                starts.append(len(w.out))
                cab.start()
                if new_tile:
                    cab.st = contexts(sh["qp"], init)
                if new_row:
                    cab.st = contexts(sh["qp"], init) if W == 1 else list(self.wpp_ctx)
        self.carry = list(cab.st)
        return bytes(w.out), starts

    # ------------------------------------------------------------- CTU --
    def ctu(self, cab, sh, rs):
        sp, lay = self.sp, self.lay
        rx, ry = rs % lay.W, rs // lay.W
        if sh["sao_luma"] or sh["sao_chroma"]:
            self.sao(cab, sh, rs, rx, ry)
        self.quadtree(cab, sh, rx << sp["log2_ctb"], ry << sp["log2_ctb"], sp["log2_ctb"], 0)

    def sao(self, cab, sh, rs, rx, ry):
        rng, lay = self.rng, self.lay
        merge_left = merge_up = 0
        if rx > 0 and rs > sh["slice_addr"] and lay.tile[rs] == lay.tile[rs - 1]:
            merge_left = int(rng.random() < 0.25)
            cab.bin(C_SAO_MERGE, merge_left)
        if ry > 0 and not merge_left and rs - lay.W >= sh["slice_addr"] \
                and lay.tile[rs] == lay.tile[rs - lay.W]:
            merge_up = int(rng.random() < 0.25)
            cab.bin(C_SAO_MERGE, merge_up)
        if merge_left or merge_up:
            return
        kind = 0
        for c in range(3):
            if (c == 0 and not sh["sao_luma"]) or (c > 0 and not sh["sao_chroma"]):
                continue
            if c < 2:
                kind = rng.choice([0, 1, 2, 2])
                cab.bin(C_SAO_TYPE, int(kind > 0))
                if kind:
                    cab.bypass(int(kind == 2))
            if not kind:
                continue
            offsets = [rng.choice([0, 0, 1, 2, 3, 7]) for _ in range(4)]
            for v in offsets:
                for _ in range(v):
                    cab.bypass(1)
                if v < 7:
                    cab.bypass(0)
            if kind == 1:
                for v in offsets:
                    if v:
                        cab.bypass(rng.randint(0, 1))
                band = rng.randrange(32)
                for k in range(4, -1, -1):
                    cab.bypass((band >> k) & 1)
            else:
                if c < 2:
                    cls = rng.randrange(4)
                    cab.bypass(cls >> 1)
                    cab.bypass(cls & 1)

    def quadtree(self, cab, sh, x0, y0, log2, depth):
        sp, pp, rng = self.sp, self.pp, self.rng
        size = 1 << log2
        if x0 + size <= sp["coded_w"] and y0 + size <= sp["coded_h"] and log2 > sp["log2_min_cb"]:
            inc = int(self.avail(x0, y0, x0 - 1, y0) and self.depth[self.u4(x0 - 1, y0)] > depth)
            inc += int(self.avail(x0, y0, x0, y0 - 1) and self.depth[self.u4(x0, y0 - 1)] > depth)
            split = int(rng.random() < sp["split_p"][log2])
            cab.bin(C_SPLIT_CU + inc, split)
        else:
            split = int(log2 > sp["log2_min_cb"])
        if pp["qp_delta"] is not None and log2 >= sp["log2_ctb"] - pp["qp_delta"]:
            self.qp_delta_coded = False
        if split:
            h = size >> 1
            self.quadtree(cab, sh, x0, y0, log2 - 1, depth + 1)
            if x0 + h < sp["coded_w"]:
                self.quadtree(cab, sh, x0 + h, y0, log2 - 1, depth + 1)
            if y0 + h < sp["coded_h"]:
                self.quadtree(cab, sh, x0, y0 + h, log2 - 1, depth + 1)
            if x0 + h < sp["coded_w"] and y0 + h < sp["coded_h"]:
                self.quadtree(cab, sh, x0 + h, y0 + h, log2 - 1, depth + 1)
        else:
            self.coding_unit(cab, sh, x0, y0, log2, depth)

    # ------------------------------------------------------ inter CUs --
    def inter_cu(self, cab, sh, x0, y0, log2, depth) -> bool:
        """A P or B slice's CU: cu_skip_flag, pred_mode_flag, part_mode and
        its prediction units, rqt_root_cbf and the transform tree. Returns
        False for an intra CU, which the caller codes as in an I slice."""
        sp, rng, mix = self.sp, self.rng, sh["mix"]
        size = 1 << log2
        inc = int(self.avail(x0, y0, x0 - 1, y0) and self.skip[self.u4(x0 - 1, y0)] > 0)
        inc += int(self.avail(x0, y0, x0, y0 - 1) and self.skip[self.u4(x0, y0 - 1)] > 0)
        skip = int(rng.random() < mix["skip"])
        cab.bin(C_SKIP + inc, skip)
        self.fill(self.skip, x0, y0, size, skip)
        if skip:
            self.fill(self.ipm, x0, y0, size, 1)
            self.pu(cab, sh, size, size, depth, True)
            return True
        intra = int(rng.random() < mix["intra"])
        cab.bin(C_PRED_MODE, intra)
        if intra:
            return False
        self.intra = False
        self.fill(self.ipm, x0, y0, size, 1)
        part = self.part_mode(cab, log2)
        h, q = size // 2, size // 4
        blocks = {0: [(size, size)], 1: [(size, h)] * 2, 2: [(h, size)] * 2, 3: [(h, h)] * 4,
                  4: [(size, q), (size, size - q)], 5: [(size, size - q), (size, q)],
                  6: [(q, size), (size - q, size)], 7: [(size - q, size), (q, size)]}[part]
        merged = [self.pu(cab, sh, w, hh, depth, False) for w, hh in blocks]
        root = 1
        if not (part == 0 and merged[0]):
            root = int(rng.random() < mix["residual"])
            cab.bin(C_RQT_ROOT, root)
        if root:
            self.ttree(cab, sh, x0, y0, x0, y0, log2, 0, 0, sp["tu_depth_inter"], False, True,
                       True, inter_split=sp["tu_depth_inter"] == 0 and part != 0)
        self.intra = True
        return True

    def part_mode(self, cab, log2) -> int:
        """Draws and codes an inter CU's PartMode (0 2Nx2N, 1 2NxN, 2 Nx2N, 3
        NxN, 4 2NxnU, 5 2NxnD, 6 nLx2N, 7 nRx2N)."""
        sp, rng = self.sp, self.rng
        if log2 == sp["log2_min_cb"]:
            part = rng.choice([0, 0, 1, 2] + ([3] if log2 > 3 else []))
            cab.bin(C_PART, int(part == 0))
            if part:
                cab.bin(C_PART_INTER, int(part == 1))
                if part > 1 and log2 > 3:
                    cab.bin(C_PART_INTER + 1, int(part == 2))
            return part
        part = rng.choice([0, 0, 1, 2] + ([4, 5, 6, 7] if sp["amp"] else []))
        cab.bin(C_PART, int(part == 0))
        if part:
            cab.bin(C_PART_INTER, int(part in (1, 4, 5)))
            if sp["amp"]:
                cab.bin(C_PART_INTER + 2, int(part in (1, 2)))
                if part > 3:
                    cab.bypass(int(part in (5, 7)))
        return part

    def pu(self, cab, sh, w, h, depth, skip) -> bool:
        """A prediction unit's syntax: merge_idx, or inter_pred_idc (never
        bi-prediction for 8x4 and 4x8), the reference indices, the
        differences and the predictor flags. Returns merge_flag."""
        rng = self.rng
        merge = skip or rng.random() < sh["mix"]["merge"]
        if not skip:
            cab.bin(C_MERGE_FLAG, int(merge))
        if merge:
            top = sh["max_merge"]
            if top > 1:
                idx = rng.randrange(top)
                cab.bin(C_MERGE_IDX, int(idx > 0))
                for i in range(1, top - 1):
                    if idx < i:
                        break
                    cab.bypass(int(idx > i))
            return True
        idc = 0
        if sh["type"] == 0:
            if w + h == 12:
                idc = rng.randint(0, 1)
                cab.bin(C_INTER_PRED + 4, idc)
            else:
                idc = rng.choice([0, 1, 2, 2])
                cab.bin(C_INTER_PRED + depth, int(idc == 2))
                if idc != 2:
                    cab.bin(C_INTER_PRED + 4, idc)
        for lst in (0, 1):
            if idc == 1 - lst:
                continue
            n = sh["num_ref"][lst]
            if n > 1:
                ref = rng.randrange(n)
                for i in range(n - 1):
                    if i < 2:
                        cab.bin(C_REF_IDX + i, int(ref > i))
                    else:
                        cab.bypass(int(ref > i))
                    if ref <= i:
                        break
            if not (lst == 1 and sh["mvd_l1_zero"] and idc == 2):
                self.mvd(cab)
            cab.bin(C_MVP, rng.randint(0, 1))
        return False

    def mvd(self, cab) -> None:
        rng = self.rng

        def draw():
            r = rng.random()
            if r < 0.3:
                return 0
            v = (rng.randint(1, 8) if r < 0.75 else rng.randint(9, 64) if r < 0.95 else
                 rng.randint(65, 700))
            return v if rng.random() < 0.5 else -v

        v = (draw(), draw())
        for a in v:
            cab.bin(C_MVD_GT0, int(a != 0))
        for a in v:
            if a:
                cab.bin(C_MVD_GT1, int(abs(a) > 1))
        for a in v:
            if a:
                if abs(a) > 1:
                    cab.eg(abs(a) - 2, 1)
                cab.bypass(int(a < 0))

    def mpm(self, xp, yp):
        a = self.ipm[self.u4(xp - 1, yp)] if self.avail(xp, yp, xp - 1, yp) else 1
        ctb_top = (yp >> self.sp["log2_ctb"]) << self.sp["log2_ctb"]
        b = (self.ipm[self.u4(xp, yp - 1)]
             if self.avail(xp, yp, xp, yp - 1) and yp - 1 >= ctb_top else 1)
        if a == b:
            return [0, 1, 26] if a < 2 else [a, 2 + (a + 29) % 32, 2 + (a - 2 + 1) % 32]
        return [a, b, 0 if a and b else (1 if a != 1 and b != 1 else 26)]

    def coding_unit(self, cab, sh, x0, y0, log2, depth):
        sp, pp, rng = self.sp, self.pp, self.rng
        size = 1 << log2
        self.bypass = False
        if pp["bypass"]:
            self.bypass = rng.random() < 0.15
            cab.bin(C_BYPASS, int(self.bypass))
        self.fill(self.depth, x0, y0, size, depth)
        self.intra = True
        if sh.get("type", 2) != 2 and self.inter_cu(cab, sh, x0, y0, log2, depth):
            return
        nxn = False
        if log2 == sp["log2_min_cb"]:
            nxn = log2 > sp["log2_min_tb"] and rng.random() < 0.35
            cab.bin(C_PART, int(not nxn))
        pcm = sp["pcm"]
        if not nxn and pcm is not None and pcm[2] <= log2 <= pcm[3]:
            use = rng.random() < 0.12
            cab.terminate(int(use))
            if use:
                cab.w.align(0)
                bl, bc = pcm[0], pcm[1]
                for _ in range(size * size):
                    cab.w.u(bl, rng.randrange(1 << bl))
                for _ in range(size * size // 2):
                    cab.w.u(bc, rng.randrange(1 << bc))
                cab.start()
                self.fill(self.ipm, x0, y0, size, 1)
                return
        pb = size // 2 if nxn else size
        modes, codes = [], []
        for i in range(4 if nxn else 1):
            xp, yp = x0 + (i & 1) * pb, y0 + (i >> 1) * pb
            cand = self.mpm(xp, yp)
            if rng.random() < 0.45:
                idx = rng.randrange(3)
                mode, code = cand[idx], (1, idx)
            else:
                mode = rng.choice([m for m in range(35) if m not in cand])
                rem = mode - sum(1 for c in cand if c < mode)
                code = (0, rem)
            self.fill(self.ipm, xp, yp, pb, mode)
            modes.append(mode)
            codes.append(code)
        for flag, _ in codes:
            cab.bin(C_PREV_INTRA, flag)
        for flag, v in codes:
            if flag:
                cab.bypass(int(v > 0))
                if v > 0:
                    cab.bypass(int(v > 1))
            else:
                for k in range(4, -1, -1):
                    cab.bypass((v >> k) & 1)
        cm = rng.randrange(5)
        if cm == 4:
            cab.bin(C_CHROMA_MODE, 0)
            self.chroma_mode = modes[0]
        else:
            cab.bin(C_CHROMA_MODE, 1)
            cab.bypass(cm >> 1)
            cab.bypass(cm & 1)
            m = [0, 26, 10, 1][cm]
            self.chroma_mode = 34 if m == modes[0] else m
        self.ttree(cab, sh, x0, y0, x0, y0, log2, 0, 0, sp["tu_depth"] + int(nxn), nxn, True, True)

    def ttree(self, cab, sh, x0, y0, xb, yb, log2, depth, blk, max_depth, nxn, pcb, pcr,
              inter_split=False):
        """The transform tree; ``inter_split``: an inter CU of several
        prediction blocks (interSplitFlag where its depth is not coded);
        ``self.intra`` False codes an inter CU's tree."""
        sp, rng = self.sp, self.rng
        if sp["log2_min_tb"] < log2 <= sp["log2_max_tb"] and depth < max_depth and not (
                nxn and depth == 0):
            split = int(rng.random() < 0.45)
            cab.bin(C_SPLIT_TU + 5 - log2, split)
        else:
            split = int(log2 > sp["log2_max_tb"] or (nxn and depth == 0)
                        or (inter_split and depth == 0))
        if log2 > 2:
            cb = cr = 0
            if depth == 0 or pcb:
                cb = int(rng.random() < 0.55)
                cab.bin(C_CBF_CHROMA + depth, cb)
            if depth == 0 or pcr:
                cr = int(rng.random() < 0.55)
                cab.bin(C_CBF_CHROMA + depth, cr)
        else:
            cb, cr = pcb, pcr
        if split:
            h = 1 << (log2 - 1)
            for k, (dx, dy) in enumerate([(0, 0), (h, 0), (0, h), (h, h)]):
                self.ttree(cab, sh, x0 + dx, y0 + dy, x0, y0, log2 - 1, depth + 1, k, max_depth,
                           nxn, cb, cr)
            return
        intra = getattr(self, "intra", True)
        if intra or depth or cb or cr:
            luma = int(rng.random() < 0.7)
            cab.bin(C_CBF_LUMA + int(depth == 0), luma)
        else:
            luma = 1          # inferred
        if (luma or cb or cr) and self.pp["qp_delta"] is not None and not self.qp_delta_coded:
            self.qp_delta_coded = True
            v = rng.choice([0, 0, 1, -1, 2, -3, 5, -7, 12, -20, 25, -26])
            self.cu_qp_delta(cab, v)
        if luma:
            self.residual(cab, log2, 0, self.ipm[self.u4(x0, y0)] if intra else -1)
        if log2 > 2 or blk == 3:
            lc = log2 - 1 if log2 > 2 else 2
            if cb:
                self.residual(cab, lc, 1, self.chroma_mode if intra else -1)
            if cr:
                self.residual(cab, lc, 2, self.chroma_mode if intra else -1)

    def cu_qp_delta(self, cab, v):
        a = abs(v)
        cab.bin(C_QP_DELTA, int(a > 0))
        if a:
            for i in range(1, 5):
                cab.bin(C_QP_DELTA + 1, int(a > i))
                if a == i:
                    break
            if a >= 5:
                cab.eg(a - 5, 0)
            cab.bypass(int(v < 0))

    # ------------------------------------------------------- residuals --
    def _level(self) -> int:
        r = self.rng.random()
        if r < 0.55:
            return 1
        if r < 0.8:
            return 2
        if r < 0.93:
            return self.rng.randint(3, 8)
        if r < 0.99:
            return self.rng.randint(9, 200)
        return self.rng.randint(200, 32767)

    def residual(self, cab, log2, c, pred_mode):
        rng, pp = self.rng, self.pp
        n = 1 << log2
        if pp["ts"] and not self.bypass and log2 == 2:
            ts = int(rng.random() < 0.4)
            cab.bin(C_TS + int(c > 0), ts)
        scan = 0
        if log2 == 2 or (log2 == 3 and c == 0):
            scan = 2 if 6 <= pred_mode <= 14 else 1 if 22 <= pred_mode <= 30 else 0
        lsb = log2 - 2
        sub, pos = SCANS[lsb][scan], SCANS[2][scan]
        nsub = 1 << (2 * lsb)
        # the last significant coefficient: low frequencies more often
        last_sub = min(int(rng.random() ** 2.5 * nsub), nsub - 1)
        last_pos = rng.randrange(16)
        xs, ys = sub[last_sub]
        lx, ly = (xs << 2) + pos[last_pos][0], (ys << 2) + pos[last_pos][1]
        if scan == 2:
            lx, ly = ly, lx
        if c == 0:
            off, shift = 3 * (log2 - 2) + ((log2 - 1) >> 2), (log2 + 1) >> 2
        else:
            off, shift = 15, log2 - 2
        max_prefix = (log2 << 1) - 1
        codes = []
        for base_ctx, v in ((C_LAST_X, lx), (C_LAST_Y, ly)):
            if v < 4:
                p, suffix = v, None
            else:
                p = next(p for p in range(4, max_prefix + 1)
                         if (1 << ((p >> 1) - 1)) * (2 + (p & 1)) <= v
                         < (1 << ((p >> 1) - 1)) * (3 + (p & 1)))
                suffix = (v - (1 << ((p >> 1) - 1)) * (2 + (p & 1)), (p >> 1) - 1)
            for i in range(p):
                cab.bin(base_ctx + off + (i >> shift), 1)
            if p < max_prefix:
                cab.bin(base_ctx + off + (p >> shift), 0)
            codes.append(suffix)
        for suffix in codes:
            if suffix is not None:
                v, k = suffix
                for b in range(k - 1, -1, -1):
                    cab.bypass((v >> b) & 1)
        side = 1 << lsb
        csbf = [[0] * side for _ in range(side)]
        greater1_ctx, first_sub = 1, True
        density = rng.choice([0.15, 0.4, 0.8])
        for i in range(last_sub, -1, -1):
            xs, ys = sub[i]
            infer_dc = False
            if 0 < i < last_sub:
                ctx = (csbf[xs + 1][ys] if xs < side - 1 else 0) + (
                    csbf[xs][ys + 1] if ys < side - 1 else 0)
                csbf[xs][ys] = int(rng.random() < 0.6)
                cab.bin(C_CSBF + min(ctx, 1) + (2 if c else 0), csbf[xs][ys])
                infer_dc = True
            else:
                csbf[xs][ys] = 1
            prev = (csbf[xs + 1][ys] if xs < side - 1 else 0) + (
                (csbf[xs][ys + 1] << 1) if ys < side - 1 else 0)
            sig_pos = [last_pos] if i == last_sub else []
            start = last_pos - 1 if i == last_sub else 15
            for k in range(start, -1, -1):
                xc, yc = (xs << 2) + pos[k][0], (ys << 2) + pos[k][1]
                if csbf[xs][ys] and (k > 0 or not infer_dc):
                    if log2 == 2:
                        sctx = CTX_IDX_MAP[(yc << 2) + xc]
                    elif xc + yc == 0:
                        sctx = 0
                    else:
                        xp, yp = xc & 3, yc & 3
                        if prev == 0:
                            sctx = 2 if xp + yp == 0 else 1 if xp + yp < 3 else 0
                        elif prev == 1:
                            sctx = 2 if yp == 0 else 1 if yp == 1 else 0
                        elif prev == 2:
                            sctx = 2 if xp == 0 else 1 if xp == 1 else 0
                        else:
                            sctx = 2
                        if c == 0 and xs + ys > 0:
                            sctx += 3
                        if log2 == 3:
                            sctx += 9 if scan == 0 else 15
                        else:
                            sctx += 21 if c == 0 else 12
                    s = int(rng.random() < density)
                    cab.bin(C_SIG + (sctx if c == 0 else 27 + sctx), s)
                    if s:
                        sig_pos.append(k)
                        infer_dc = False
                elif k == 0 and infer_dc and csbf[xs][ys]:
                    sig_pos.append(0)
            if not sig_pos:
                continue
            ctx_set = 0 if (i == 0 or c > 0) else 2
            if not first_sub and greater1_ctx == 0:
                ctx_set += 1
            first_sub = False
            greater1_ctx = 1
            levels = [self._level() for _ in sig_pos]
            first_g1 = -1
            for m in range(min(len(sig_pos), 8)):
                g1 = int(levels[m] > 1)
                cab.bin(C_GT1 + (ctx_set << 2) + greater1_ctx + (16 if c else 0), g1)
                if g1:
                    greater1_ctx = 0
                    if first_g1 < 0:
                        first_g1 = m
                elif 0 < greater1_ctx < 3:
                    greater1_ctx += 1
            if first_g1 >= 0:
                cab.bin(C_GT2 + ctx_set + (4 if c else 0), int(levels[first_g1] > 2))
            hidden = pp["sdh"] and not self.bypass and sig_pos[0] - sig_pos[-1] > 3
            for m in range(len(sig_pos)):
                if not (hidden and m == len(sig_pos) - 1):
                    cab.bypass(rng.randint(0, 1))
            rice = 0
            for m, level in enumerate(levels):
                if m < 8:
                    base = 1 + int(level > 1) + (int(level > 2) if m == first_g1 else 0)
                    need = 3 if m == first_g1 else 2
                else:
                    base, need = 1, 1
                if base == need:
                    self.remaining(cab, level - base, rice)
                    if level > 3 * (1 << rice):
                        rice = min(rice + 1, 4)

    @staticmethod
    def remaining(cab, v, k):
        if (v >> k) < 4:
            for _ in range(v >> k):
                cab.bypass(1)
            cab.bypass(0)
            for b in range(k - 1, -1, -1):
                cab.bypass((v >> b) & 1)
            return
        for _ in range(4):
            cab.bypass(1)
        u, kk = v - (4 << k), k + 1
        while u >= (1 << kk):
            cab.bypass(1)
            u -= 1 << kk
            kk += 1
        cab.bypass(0)
        for b in range(kk - 1, -1, -1):
            cab.bypass((u >> b) & 1)


# ------------------------------------------------------------ the stream --

def _slice_header(sh: dict, sp: dict, pp: dict, lay: _Layout, rng: random.Random,
                  entry: List[int]) -> bytes:
    w = _Writer()
    w.u(1, int(sh["first"]))
    if 16 <= sh["nal"] <= 23:
        w.u(1, int(sh.get("no_output_prior", False)))
    w.ue(pp["id"])
    if not sh["first"]:
        if pp["dependent"]:
            w.u(1, int(sh["dependent"]))
        w.u(max(1, (lay.W * lay.H - 1).bit_length()) if lay.W * lay.H > 1 else 0, sh["address"])
    if not sh["dependent"]:
        for _ in range(pp["extra_bits"]):
            w.u(1, rng.randint(0, 1))
        w.ue(sh.get("type", 2))
        if pp["output_flag"]:
            w.u(1, int(sh["output"]))
        if sh["nal"] not in (IDR_W_RADL, IDR_N_LP):
            w.u(sp["log2_poc"], sh["poc"] & ((1 << sp["log2_poc"]) - 1))
            if "rps_bits" in sh:      # an inter stream's picture: the same in every slice
                for b in sh["rps_bits"]:
                    w.u(1, b)
            else:
                use_sps = sp["num_rps"] > 0 and rng.random() < 0.5
                w.u(1, int(use_sps))
                if use_sps:
                    if sp["num_rps"] > 1:
                        w.u((sp["num_rps"] - 1).bit_length(), sp["empty_rps"])
                else:
                    _st_rps(w, rng, sp["num_rps"], sp["num_rps"], sp["rps_sizes"], empty=True)
                if sp["long_term"]:
                    if sp["num_lt_sps"]:
                        w.ue(0)
                    w.ue(0)
        if sp["sao"]:
            w.u(1, int(sh["sao_luma"])).u(1, int(sh["sao_chroma"]))
        if sh.get("type", 2) != 2:
            _inter_fields(w, sh, pp)
        w.se(sh["qp"] - pp["init_qp"])
        if pp["slice_cqp"]:
            w.se(sh["cqp"][0]).se(sh["cqp"][1])
        db = pp["deblock"]
        override = db is not None and db[0] and sh["deblock_override"] is not None
        if db is not None and db[0]:
            w.u(1, int(override))
        if override:
            off = sh["deblock_override"]
            w.u(1, int(off == "off"))
            if off != "off":
                w.se(off[0]).se(off[1])
        disabled = sh["deblock_disabled"]
        if pp["lf_slices"] and (sh["sao_luma"] or sh["sao_chroma"] or not disabled):
            w.u(1, int(sh["lf_slices"]))
    if pp["tiles"] is not None or pp["wpp"]:
        w.ue(len(entry))
        if entry:
            bits = max(max(entry) - 1, 1).bit_length()
            w.ue(bits - 1)
            for e in entry:
                w.u(bits, e - 1)
    if pp["header_ext"]:
        n = rng.randint(0, 3)
        w.ue(n)
        for _ in range(n):
            w.u(8, rng.randrange(256))
    w.u(1, 1).align(0)
    return bytes(w.out)


def _inter_fields(w: _Writer, sh: dict, pp: dict) -> None:
    """A P or B slice header's fields from num_ref_idx_active_override_flag
    to five_minus_max_num_merge_cand."""
    b = sh["type"] == 0
    lists = 2 if b else 1
    nr = sh["num_ref"]
    w.u(1, int(sh["override"]))
    if sh["override"]:
        for lst in range(lists):
            w.ue(nr[lst] - 1)
    if pp.get("list_mod") and sh["total"] > 1:
        bits = (sh["total"] - 1).bit_length()
        for lst in range(lists):
            entries = sh["list_entry"][lst]
            w.u(1, int(entries is not None))
            for e in entries or ():
                w.u(bits, e)
    if b:
        w.u(1, int(sh["mvd_l1_zero"]))
    if pp.get("cabac_init"):
        w.u(1, int(sh["cabac_init"]))
    if sh["tmvp"]:
        if b:
            w.u(1, int(sh["col_from_l0"]))
        if nr[0 if sh["col_from_l0"] else 1] > 1:
            w.ue(sh["col_ref_idx"])
    if (pp.get("weighted") and not b) or (pp.get("weighted_bi") and b):
        wp = sh["wp"]
        w.ue(wp["luma_denom"]).se(wp["chroma_denom"] - wp["luma_denom"])
        for lst in range(lists):
            entries = wp["lists"][lst]
            for luma, _ in entries:
                w.u(1, int(luma is not None))
            for _, chroma in entries:
                w.u(1, int(chroma is not None))
            for luma, chroma in entries:
                if luma is not None:
                    w.se(luma[0]).se(luma[1])
                for dw, do in chroma or ():
                    w.se(dw).se(do)
    w.ue(5 - sh["max_merge"])


def _segments(rng: random.Random, pp: dict, lay: _Layout, max_slices: int):
    """[(first CTB in tile scan, dependent)] of a picture's slice segments:
    with wavefronts every segment begins a CTB row; with tiles a segment
    inside a tile ends in it, one across tiles holds whole tiles."""
    n = lay.W * lay.H
    if pp["wpp"]:
        cands = list(range(lay.W, n, lay.W))
    elif pp["tiles"] is not None:
        cands = []
        for t, start in enumerate(lay.tile_starts):
            end = lay.tile_starts[t + 1] if t + 1 < len(lay.tile_starts) else n
            if start:
                cands.append(start)
            if end - start > 1 and rng.random() < 0.5:
                cands += rng.sample(range(start + 1, end), min(2, end - start - 1))
        # a tile split inside must begin and end segments at its edges: keep every tile start
        cands = sorted(set(cands))
    else:
        cands = list(range(1, n))
    k = min(len(cands), rng.randint(0, max_slices - 1))
    starts = sorted(rng.sample(cands, k))
    if pp["tiles"] is not None and any(s not in lay.tile_starts for s in starts):
        starts = sorted(set(starts) | set(t for t in lay.tile_starts if t))
    out, slice_at_tile = [(0, False)], True
    for s in starts:
        at_tile = pp["tiles"] is not None and s in lay.tile_starts
        # a slice begun inside a tile ends in it: a segment at a tile start opens a slice
        dep = pp["dependent"] and rng.random() < 0.5 and (slice_at_tile or not at_tile)
        if not dep:
            slice_at_tile = pp["tiles"] is None or at_tile
        out.append((s, dep))
    return out


def write_hevc_stream(width: int, height: int, n_frames: int, seed: int, *, log2_ctb: int = 5,
                      log2_min_cb: int = 3, tiles=None, wpp: bool = False,
                      vui: Optional[dict] = None, plan: Optional[List[str]] = None,
                      max_slices: int = 3, tools: Optional[dict] = None) -> dict:
    """A stream of ``n_frames`` intra pictures of seeded random syntax at
    ``width`` x ``height`` (even; coded at the next multiple of the minimum
    coding block, the rest cut by the conformance window). ``tiles``:
    (columns, rows, explicit) with column widths and row heights in CTBs
    (explicit) or counts (uniform: lists of that length); ``plan``: the NAL
    type of each picture in decode order ("IDR", "IDR_N", "CRA", "BLA",
    "TRAIL", "TRAIL_N", "RADL", "RASL", "HIDDEN": a TRAIL with
    pic_output_flag 0), leading pictures taking order counts below their
    IRAP's; ``tools`` forces PPS/SPS choices (keys of the drawn dicts).
    Returns {"params": [VPS, SPS, PPS NAL units], "samples": [access units
    of 4-byte-length NAL units], "sync", "rank" (presentation index, -1 for
    a picture that shows nowhere), "shows", "sp" and "pp" (the drawn
    parameter sets)}."""
    rng = random.Random(seed)
    tools = dict(tools or {})
    mincb = 1 << log2_min_cb
    coded_w, coded_h = -(-width // mincb) * mincb, -(-height // mincb) * mincb
    plan = plan or ["IDR"] + ["TRAIL"] * (n_frames - 1)
    sp = dict(vps_id=rng.randrange(16), id=rng.randrange(16), profile=tools.pop("profile", 1),
              sub_layers=1, coded_w=coded_w, coded_h=coded_h,
              crop=(0, coded_w - width, 0, coded_h - height), log2_poc=rng.choice([4, 6, 8]),
              dpb=4, reorder=2, log2_ctb=log2_ctb, log2_min_cb=log2_min_cb,
              log2_min_tb=2, log2_max_tb=min(log2_ctb, 5),
              tu_depth=rng.randint(1, min(3, log2_ctb - 2)),
              scaling=rng.choice([None, None, "default", "sps"]), sao=rng.random() < 0.8,
              pcm=None, num_rps=rng.randint(0, 4), long_term=rng.random() < 0.4,
              num_lt_sps=rng.randint(0, 2), strong=rng.random() < 0.6, vui=vui,
              split_p={3: 0, 4: 0.5, 5: 0.7, 6: 0.85}, bit_depth=tools.pop("bit_depth", 8),
              chroma_format=tools.pop("chroma_format", 1))
    if rng.random() < 0.6:
        lo = rng.randint(log2_min_cb, min(log2_ctb, 5))
        sp["pcm"] = (rng.randint(4, 8), rng.randint(4, 8), lo, rng.randint(lo, min(log2_ctb, 5)),
                     rng.random() < 0.5)
    sp["empty_rps"] = rng.randrange(sp["num_rps"]) if sp["num_rps"] else -1
    cols = rows = None
    if tiles is not None:
        cols, rows, explicit = tiles
    pp = dict(id=rng.randrange(64), dependent=rng.random() < 0.5, output_flag=rng.random() < 0.3,
              extra_bits=rng.randint(0, 2), sdh=rng.random() < 0.6, init_qp=rng.randint(20, 40),
              cip=rng.random() < 0.3, ts=rng.random() < 0.6,
              qp_delta=rng.randint(0, log2_ctb - log2_min_cb) if rng.random() < 0.6 else None,
              cqp=(rng.randint(-12, 12), rng.randint(-12, 12)), slice_cqp=rng.random() < 0.5,
              bypass=rng.random() < 0.4,
              tiles=None if tiles is None else (cols, rows, explicit), wpp=wpp,
              lf_tiles=rng.random() < 0.5, lf_slices=rng.random() < 0.6,
              deblock=rng.choice([None, (True, False, rng.randint(-6, 6), rng.randint(-6, 6)),
                                  (True, True, 0, 0), (False, False, rng.randint(-6, 6),
                                                       rng.randint(-6, 6))]),
              pps_scaling=False, header_ext=rng.random() < 0.3)
    if sp["scaling"] is not None and rng.random() < 0.4:
        pp["pps_scaling"] = True
    for key, value in tools.items():
        (sp if key in sp else pp)[key] = value
    if "HIDDEN" in plan:
        pp["output_flag"] = True
    vps = nal(VPS, vps_rbsp(sp))
    sps = nal(SPS, sps_rbsp(sp, rng))
    lay = _Layout(sp, pp)
    pps = nal(PPS, pps_rbsp(pp, sp, rng))
    samples, sync, pocs, shows, kinds = [], [], [], [], []
    top = -1          # the highest order count so far
    irap_poc = 0
    for k, kind in enumerate(plan):
        nal_type = {"IDR": IDR_W_RADL, "IDR_N": IDR_N_LP, "CRA": CRA, "BLA": BLA_W_RADL,
                    "TRAIL": TRAIL_R, "TRAIL_N": TRAIL_N, "RADL": RADL_R, "RASL": RASL_N,
                    "HIDDEN": TRAIL_R, "P": TRAIL_R, "B": TRAIL_R}[kind]
        if kind in ("IDR", "IDR_N"):
            poc = irap_poc = 0
        elif kind in ("CRA", "BLA"):
            poc = irap_poc = top + 4           # room for up to three leading pictures
            if kind == "BLA":
                poc = irap_poc = poc & ((1 << sp["log2_poc"]) - 1)   # its MSB is 0
        elif kind in ("RADL", "RASL"):
            leads = sum(1 for j in range(k - 1, -1, -1) if plan[j] in ("RADL", "RASL"))
            poc = irap_poc - 1 - leads
        else:
            poc = top + 1
        top = max(top, poc) if kind not in ("IDR", "IDR_N", "BLA") else poc
        sh = dict(nal=nal_type, poc=poc, output=kind != "HIDDEN", qp=rng.randint(15, 45),
                  sao_luma=sp["sao"] and rng.random() < 0.8,
                  sao_chroma=sp["sao"] and rng.random() < 0.7,
                  cqp=tuple(rng.randint(max(-12, -12 - c), min(12, 12 - c)) for c in pp["cqp"]))
        db = pp["deblock"]
        # the slice's deblocking override: None (the PPS's), "off", or (beta, tc) / 2
        sh["deblock_override"] = None
        if db is not None and db[0] and rng.random() < 0.6:
            sh["deblock_override"] = ("off" if rng.random() < 0.3 else
                                      (rng.randint(-6, 6), rng.randint(-6, 6)))
        if sh["deblock_override"] is not None:
            sh["deblock_disabled"] = sh["deblock_override"] == "off"
        else:
            sh["deblock_disabled"] = db is not None and db[1]
        sh["lf_slices"] = pp["lf_slices"] and rng.random() < 0.6
        if kind in ("P", "B"):
            # an inter slice in an IRAP (CRA) picture: its header up to the order
            # count, then filler (the port refuses it at slice_type, as ffmpeg does)
            w = _Writer().u(1, 1).u(1, 0).ue(pp["id"])
            for _ in range(pp["extra_bits"]):
                w.u(1, 0)
            w.ue(1 if kind == "P" else 0)
            if pp["output_flag"]:
                w.u(1, 1)
            w.u(sp["log2_poc"], poc & ((1 << sp["log2_poc"]) - 1)).u(16, 0xA5A5)
            unit = bytes([CRA << 1, 1]) + _ebsp(w.trailing())
            samples.append(struct.pack(">I", len(unit)) + unit)
            sync.append(False)
            pocs.append(poc)
            kinds.append(kind)
            shows.append(True)
            continue
        coder = _PictureCoder(rng, sp, pp, lay)
        nals = []
        if rng.random() < 0.2:       # an SEI, which the decoder skips
            nals.append(nal(PREFIX_SEI, bytes([5, 20]) + bytes(rng.randrange(256) for _ in range(20))
                            + b"\x80"))      # user_data_unregistered: a UUID and 4 bytes
        segs = _segments(rng, pp, lay, max_slices)
        slice_addr = 0
        for j, (start, dep) in enumerate(segs):
            end = segs[j + 1][0] if j + 1 < len(segs) else lay.W * lay.H
            seg = dict(sh, first=j == 0, dependent=dep, address=lay.ts2rs[start])
            if not dep:
                slice_addr = lay.ts2rs[start]
                # each independent slice draws its own QP and filter flags
                if j:
                    seg["qp"] = rng.randint(15, 45)
                    seg["lf_slices"] = pp["lf_slices"] and rng.random() < 0.6
                    if db is not None and db[0] and rng.random() < 0.5:
                        seg["deblock_override"] = ("off" if rng.random() < 0.3 else
                                                   (rng.randint(-6, 6), rng.randint(-6, 6)))
                        seg["deblock_disabled"] = seg["deblock_override"] == "off"
                    seg["sao_luma"] = sp["sao"] and rng.random() < 0.8
                    seg["sao_chroma"] = sp["sao"] and rng.random() < 0.7
                sh_ind = seg
            else:
                seg = dict(sh_ind, first=False, dependent=True, address=lay.ts2rs[start])
            seg["slice_addr"] = slice_addr
            data, starts = coder.segment(seg, start, end)
            esc = _ebsp(b"\xff" + data)[1:]
            # entry points count the escaped bytes of each substream
            bounds = [0] + starts + [len(data)]
            sizes = [len(_ebsp(b"\xff" + data[:b])[1:]) for b in bounds]
            entry = [sizes[i + 1] - sizes[i] for i in range(len(starts))]
            head = _slice_header(seg, sp, pp, lay, rng, entry)
            # the header ends in its alignment bit's byte (never 0): the data escape alone
            nals.append(bytes([nal_type << 1, 1]) + _ebsp(head) + esc)
        sample = b"".join(struct.pack(">I", len(x)) + x for x in nals)
        samples.append(sample)
        sync.append(16 <= nal_type <= 21)
        pocs.append(poc)
        kinds.append(kind)
        # ffmpeg discards the RASL pictures of a BLA and of the CRA that starts
        # the stream (NoRaslOutputFlag 1); a later CRA's show
        irap = max(j for j in range(k + 1) if kinds[j] in ("IDR", "IDR_N", "CRA", "BLA"))
        shows.append(kind != "HIDDEN" and not (
            kind == "RASL" and (irap == 0 or kinds[irap] == "BLA")))
    # presentation order: by (IRAP period, POC)
    period, keys = 0, []
    for k, kind in enumerate(kinds):
        if kind in ("IDR", "IDR_N", "BLA") or (kind == "CRA" and k == 0):
            period += 1
        keys.append((period, pocs[k], k))
    rank = [-1] * len(plan)
    r = 0
    for _, _, k in sorted(keys):
        if shows[k]:
            rank[k] = r
            r += 1
    return dict(params=[vps, sps, pps], samples=samples, sync=sync, rank=rank, shows=shows,
                sp=sp, pp=pp)


# ------------------------------------------------------- inter streams --

_NAL_TYPES = {("TRAIL", False): TRAIL_N, ("TRAIL", True): TRAIL_R, ("TSA", False): 2,
              ("TSA", True): 3, ("STSA", False): 4, ("STSA", True): 5, ("RADL", False): RADL_N,
              ("RADL", True): RADL_R, ("RASL", False): RASL_N, ("RASL", True): RASL_R,
              ("BLA", True): BLA_W_LP, ("IDR", True): IDR_W_RADL, ("IDR_N", True): IDR_N_LP,
              ("CRA", True): CRA}


def _canonical(entries):
    """An RPS as (delta, used) pairs: the negative ones closest first, then
    the positive ones ascending (the order the decoder derives)."""
    return (sorted((e for e in entries if e[0] < 0), key=lambda e: -e[0])
            + sorted(e for e in entries if e[0] > 0))


def _predicted(target, ref, delta_rps):
    """(used_by_curr_pic_flag, use_delta_flag) for each of ``ref``'s pictures
    and the one at ``delta_rps`` that predict ``target`` from ``ref``, or
    None. A delta of 0 is never used (ffmpeg would count it)."""
    want = dict(target)
    flags, found = [], set()
    for c in [d + delta_rps for d, _ in ref] + [delta_rps]:
        if c in want and c not in found:
            flags.append((int(want[c]), 1))
            found.add(c)
        else:
            flags.append((0, 0))
    return flags if found == set(want) else None


def _write_rps(w: _Writer, rps, sets, idx: int, num: int, rng: random.Random) -> None:
    """st_ref_pic_set(idx) of ``rps`` ((delta, used) pairs, canonical):
    predicted from an earlier set (``sets``: the SPS's, in order) where one
    can, else explicit."""
    if idx:
        options = []
        for k in (range(1, idx + 1) if idx == num else [1]):
            for d in range(-6, 7):
                flags = _predicted(rps, sets[idx - k], d) if d else None
                if flags is not None:
                    options.append((k, d, flags))
        pred = bool(options) and rng.random() < 0.6
        w.u(1, int(pred))
        if pred:
            k, d, flags = rng.choice(options)
            if idx == num:
                w.ue(k - 1)
            w.u(1, int(d < 0)).ue(abs(d) - 1)
            for used, use_delta in flags:
                w.u(1, used)
                if not used:
                    w.u(1, use_delta)
            return
    neg = [e for e in rps if e[0] < 0]
    pos = [e for e in rps if e[0] > 0]
    w.ue(len(neg)).ue(len(pos))
    prev = 0
    for d, used in neg:
        w.ue(prev - d - 1).u(1, int(used))
        prev = d
    prev = 0
    for d, used in pos:
        w.ue(d - prev - 1).u(1, int(used))
        prev = d


def output_model(pictures, reorder: int, dpb: int):
    """ffmpeg's output process (libavcodec's hevc refs.c) over order counts:
    ``pictures`` in decode order as dicts with "poc", "irap_restart" (an
    IRAP picture with NoRaslOutputFlag), "new_sequence" (IDR or BLA),
    "discard" (no_output_of_prior_pics_flag, or a CRA's restart), "keep"
    [(poc, long-term POC mask or -1)], "output", "decoded" (False for a RASL
    picture ffmpeg skips). Returns the decode indices in output order and
    those discarded."""
    held, seq, order, discarded = [], 0, [], []
    for k, pic in enumerate(pictures):
        if not pic["decoded"]:
            continue
        if pic["irap_restart"]:
            for f in sorted(held, key=lambda f: f["poc"]):
                if f["out"]:
                    (discarded if pic["discard"] else order).append(f["k"])
                    f["out"] = False
        if pic["new_sequence"]:
            seq += 1
        generated = 0
        for f in held:
            f["ref"] = False
        for want, mask in pic["keep"]:
            hit = next((f for f in held if f["seq"] == seq and f["poc"] & mask == want
                        and (mask == -1 or f["poc"] != pic["poc"])), None)
            if hit is None:
                generated += 1
            else:
                hit["ref"] = True
        held = [f for f in held if f["ref"] or f["out"]]
        held.append(dict(poc=pic["poc"], k=k, ref=True, out=pic["output"], seq=seq))
        while True:
            waiting = [f for f in held if f["out"]]
            if not (len(waiting) > reorder or (waiting and len(held) + generated > dpb)):
                break
            first = min(waiting, key=lambda f: f["poc"])
            first["out"] = False
            order.append(first["k"])
            if not first["ref"]:
                held.remove(first)
    order += [f["k"] for f in sorted((f for f in held if f["out"]), key=lambda f: f["poc"])]
    return order, discarded


def write_hevc_inter_stream(width: int, height: int, seed: int, gop: List[dict], *,
                            log2_ctb: int = 6, log2_min_cb: int = 3, vui: Optional[dict] = None,
                            max_slices: int = 2, tools: Optional[dict] = None,
                            mix: Optional[dict] = None, draw: bool = False, tiles=None,
                            wpp: bool = False) -> dict:
    """A stream of inter pictures of seeded random syntax (the pictures of
    ``gop`` in decode order) at ``width`` x ``height``. Each picture is a
    dict: "nal" ("IDR", "IDR_N", "CRA", "BLA", "TRAIL", "TSA", "STSA",
    "RADL", "RASL"), "ref" (False: the _N type), "poc", "tid" (TemporalId),
    "slices" ("I", "P" or "B": the slices' type; a P or B picture may carry
    an I slice too), "refs" [(poc, used)] the short-term pictures it keeps,
    "lt" [(poc, used, msb)] the long-term ones, "output"
    (pic_output_flag), "no_output_prior", "tmvp" (False: off in this
    picture), "list_entry" (list 0's entries, forced; needs the PPS's
    lists_modification_present_flag). The writer keeps the DPB as the
    RPS marks it, so that every picture named is held, but for "missing"
    [poc] ones named on purpose (the decoder generates them, as ffmpeg
    does); lists, their modifications and the collocated picture follow
    from the RPS. ``tools`` forces SPS/PPS choices; ``mix`` the CU
    probabilities; ``draw`` draws the intra writer's other tools too (PCM,
    bypass, transform skip, QP deltas, chroma QP offsets, scaling lists,
    deblocking control, dependent slices); ``tiles`` and ``wpp`` as for
    write_hevc_stream. Returns write_hevc_stream's dict."""
    rng = random.Random(seed)
    tools = dict(tools or {})
    mix = dict(dict(skip=0.25, intra=0.12, merge=0.45, residual=0.6), **(mix or {}))
    mincb = 1 << log2_min_cb
    coded_w, coded_h = -(-width // mincb) * mincb, -(-height // mincb) * mincb
    sub_layers = max(p.get("tid", 0) for p in gop) + 1
    sp = dict(vps_id=rng.randrange(16), id=rng.randrange(16), profile=1, sub_layers=sub_layers,
              nesting=sub_layers == 1, coded_w=coded_w, coded_h=coded_h,
              crop=(0, coded_w - width, 0, coded_h - height), log2_poc=8, dpb=5, reorder=2,
              log2_ctb=log2_ctb, log2_min_cb=log2_min_cb, log2_min_tb=2,
              log2_max_tb=min(log2_ctb, 5), tu_depth=rng.randint(0, min(2, log2_ctb - 2)),
              tu_depth_inter=rng.randint(0, min(2, log2_ctb - 2)), scaling=None,
              sao=rng.random() < 0.8, pcm=None, long_term=False, num_lt_sps=0,
              strong=rng.random() < 0.5, vui=vui, tmvp=True, amp=rng.random() < 0.7,
              split_p={3: 0, 4: 0.4, 5: 0.6, 6: 0.8})
    pp = dict(id=rng.randrange(64), dependent=False, output_flag=False, extra_bits=0,
              sdh=rng.random() < 0.6, init_qp=rng.randint(22, 36), cip=False,
              ts=rng.random() < 0.4, qp_delta=None, cqp=(0, 0), slice_cqp=False, bypass=False,
              tiles=None, wpp=False, lf_tiles=True, lf_slices=rng.random() < 0.5,
              deblock=(True, False, 0, 0), pps_scaling=False, header_ext=False,
              cabac_init=False, num_ref=(1, 1), weighted=False, weighted_bi=False,
              list_mod=False, par_mrg=2)
    pp["tiles"], pp["wpp"] = tiles, wpp
    if draw:
        if rng.random() < 0.5:
            lo = rng.randint(log2_min_cb, min(log2_ctb, 5))
            sp["pcm"] = (rng.randint(4, 8), rng.randint(4, 8), lo,
                         rng.randint(lo, min(log2_ctb, 5)), rng.random() < 0.5)
        sp["scaling"] = rng.choice([None, "default", "sps"])
        pp.update(dependent=rng.random() < 0.5, bypass=rng.random() < 0.3,
                  qp_delta=rng.randint(0, log2_ctb - log2_min_cb) if rng.random() < 0.6 else None,
                  cqp=(rng.randint(-12, 12), rng.randint(-12, 12)), slice_cqp=rng.random() < 0.5,
                  deblock=rng.choice([None, (True, False, rng.randint(-6, 6), rng.randint(-6, 6)),
                                      (True, True, 0, 0)]),
                  pps_scaling=sp["scaling"] is not None and rng.random() < 0.4,
                  extra_bits=rng.randint(0, 2), header_ext=rng.random() < 0.3,
                  output_flag=rng.random() < 0.3, lf_tiles=rng.random() < 0.5,
                  cabac_init=rng.random() < 0.5, list_mod=rng.random() < 0.5,
                  par_mrg=rng.randint(2, log2_ctb), num_ref=(rng.randint(1, 3), rng.randint(1, 3)),
                  weighted=rng.random() < 0.4, weighted_bi=rng.random() < 0.4,
                  cip=rng.random() < 0.3)
    if any(p.get("lt") for p in gop):
        sp["long_term"] = True
    for key, value in tools.items():
        (sp if key in sp else pp)[key] = value
    if not any(p.get("output", True) for p in gop) or any(not p.get("output", True) for p in gop):
        pp["output_flag"] = True
    # the SPS's short-term sets: the stream's distinct ones, up to 6
    rps_of = []
    for pic in gop:
        rps_of.append(_canonical([(r - pic["poc"], u) for r, u in pic.get("refs", ())]))
    distinct = []
    for r in rps_of:
        if r and r not in distinct and len(distinct) < 6:
            distinct.append(r)
    sp["rps_sets"] = [r for r in distinct if rng.random() < 0.7]
    lt_lsb = sorted({(q & 255, u) for pic in gop for q, u, _ in pic.get("lt", ())})[:3]
    if sp["long_term"]:
        sp["lt_sps"] = lt_lsb
        sp["num_lt_sps"] = len(lt_lsb)
    vps = nal(VPS, vps_rbsp(sp))
    sps = nal(SPS, sps_rbsp(sp, rng))
    lay = _Layout(sp, pp)
    pps = nal(PPS, pps_rbsp(pp, sp, rng))
    samples, sync, model = [], [], []
    dpb = set()          # the POCs of the writer's DPB (reference pictures)
    first_irap = True
    restart_kind = None  # the IRAP picture decoding began at ("CRA" skips its RASL pictures)
    for k, pic in enumerate(gop):
        kind, poc, tid = pic["nal"], pic["poc"], pic.get("tid", 0)
        nal_type = _NAL_TYPES[kind, pic.get("ref", True)]
        irap = 16 <= nal_type <= 23
        missing = set(pic.get("missing", ()))
        if kind in ("IDR", "IDR_N"):
            dpb = set()
        named = [r for r, _ in pic.get("refs", ())] + [q for q, _, _ in pic.get("lt", ())]
        for r in named:
            if r not in dpb and r not in missing:
                raise ValueError(f"picture {k} (POC {poc}) names POC {r}, which the DPB does not hold")
        dpb = set(named) - missing
        # ffmpeg skips the RASL pictures of the CRA that starts the stream and of a BLA
        skipped = kind == "RASL" and restart_kind in ("CRA", "BLA")
        if irap:
            restart_kind = kind if first_irap or kind in ("IDR", "IDR_N", "BLA") else None
            first_irap = False
        rps = rps_of[k]
        lt = pic.get("lt", ())
        # the lists every P or B slice of the picture builds (8.3.4), and their
        # choices, shared by its P/B slices (one collocated picture)
        before = [poc + d for d, u in rps if d < 0 and u]
        after = [poc + d for d, u in rps if d > 0 and u]
        lt_curr = [q for q, u, _ in lt if u]
        total = len(before) + len(after) + len(lt_curr)
        ptype = pic.get("slices", "I")
        if ptype != "I" and not total:
            raise ValueError(f"picture {k}: a {ptype} picture without a reference it may use")
        tmvp = sp["tmvp"] and pic.get("tmvp", True) and kind not in ("IDR", "IDR_N")
        lists = None
        if ptype != "I":
            lists = _draw_lists(rng, ptype, before, after, lt_curr, total, pp, missing, tmvp)
            if pic.get("list_entry"):     # forced list 0 entries (a refusal: past 16 pictures)
                order = (before + after + lt_curr) * 16
                lists[0].update(n=len(pic["list_entry"]), entries=list(pic["list_entry"]),
                                pocs=[order[e] for e in pic["list_entry"]])
            tmvp = tmvp and lists["col"] is not None
        # the RPS, long-term pictures and slice_temporal_mvp_enabled_flag, as coded in every slice
        head = _Writer()
        if kind not in ("IDR", "IDR_N"):
            if rps in sp["rps_sets"] and rng.random() < 0.8:
                head.u(1, 1)
                if len(sp["rps_sets"]) > 1:
                    head.u((len(sp["rps_sets"]) - 1).bit_length(), sp["rps_sets"].index(rps))
            else:
                head.u(1, 0)
                _write_rps(head, rps, sp["rps_sets"], len(sp["rps_sets"]),
                           len(sp["rps_sets"]), rng)
            if sp["long_term"]:
                from_sps = [e for e in lt if (e[0] & 255, e[1]) in lt_lsb and not e[2]]
                rest = [e for e in lt if e not in from_sps]
                if sp["num_lt_sps"]:
                    head.ue(len(from_sps))
                head.ue(len(rest))
                prev_msb = 0
                for i, (q, used, msb) in enumerate(from_sps + rest):
                    if i < len(from_sps):
                        if sp["num_lt_sps"] > 1:
                            head.u((sp["num_lt_sps"] - 1).bit_length(), lt_lsb.index((q & 255, used)))
                    else:
                        head.u(sp["log2_poc"], q & 255).u(1, int(used))
                    head.u(1, int(msb))
                    if msb:
                        cycle = ((poc - (poc & 255)) - (q - (q & 255))) >> 8
                        delta = cycle - (prev_msb if i and i != len(from_sps) else 0)
                        if delta < 0:
                            raise ValueError(f"picture {k}: long-term MSB cycles must not fall")
                        head.ue(delta)
                        prev_msb = cycle
            if sp["tmvp"]:
                head.u(1, int(tmvp))
        coder = _PictureCoder(rng, sp, pp, lay)
        nals = []
        segs = _segments(rng, pp, lay, max_slices)
        sh = dict(nal=nal_type, poc=poc, output=pic.get("output", True), rps_bits=head.bits(),
                  no_output_prior=pic.get("no_output_prior", False))
        db = pp["deblock"]
        slice_addr, sh_ind = 0, None
        for j, (start, dep) in enumerate(segs):
            end = segs[j + 1][0] if j + 1 < len(segs) else lay.W * lay.H
            if not dep:
                slice_addr = lay.ts2rs[start]
                seg = dict(sh, first=j == 0, dependent=False, address=slice_addr,
                           qp=rng.randint(18, 40), lf_slices=pp["lf_slices"] and rng.random() < 0.6,
                           sao_luma=sp["sao"] and rng.random() < 0.8,
                           sao_chroma=sp["sao"] and rng.random() < 0.7, deblock_override=None,
                           cqp=tuple(rng.randint(max(-12, -12 - c), min(12, 12 - c))
                                     for c in pp["cqp"]))
                if db is not None and db[0] and rng.random() < 0.5:
                    seg["deblock_override"] = ("off" if rng.random() < 0.3 else
                                               (rng.randint(-6, 6), rng.randint(-6, 6)))
                seg["deblock_disabled"] = (seg["deblock_override"] == "off"
                                           if seg["deblock_override"] is not None
                                           else db is not None and db[1])
                stype = {"I": 2, "P": 1, "B": 0}[ptype]
                if stype != 2 and rng.random() < 0.1:
                    stype = 2                        # an I slice in an inter picture
                if stype != 2:
                    seg.update(_slice_lists(rng, stype, lists, pp, mix, tmvp, total))
                seg["type"] = stype
                sh_ind = seg
            else:
                seg = dict(sh_ind, first=False, dependent=True, address=lay.ts2rs[start])
            seg["slice_addr"] = slice_addr
            data, starts = coder.segment(seg, start, end)
            esc = _ebsp(b"\xff" + data)[1:]
            bounds = [0] + starts + [len(data)]
            sizes = [len(_ebsp(b"\xff" + data[:b])[1:]) for b in bounds]
            entry = [sizes[i + 1] - sizes[i] for i in range(len(starts))]
            head_bytes = _slice_header(seg, sp, pp, lay, rng, entry)
            nals.append(bytes([nal_type << 1, tid + 1]) + _ebsp(head_bytes) + esc)
        samples.append(b"".join(struct.pack(">I", len(x)) + x for x in nals))
        sync.append(irap)
        model.append(dict(poc=poc, irap_restart=irap and (k == 0 or kind != "CRA"),
                          new_sequence=kind in ("IDR", "IDR_N", "BLA"),
                          discard=pic.get("no_output_prior", False) or kind == "CRA",
                          keep=[(r, -1) for r, _ in pic.get("refs", ())]
                          + [(q if m else q & 255, -1 if m else 255) for q, _, m in lt],
                          output=pic.get("output", True), decoded=not skipped))
        dpb.add(poc)
    order, discarded = output_model(model, sp["reorder"], sp["dpb"])
    rank = [-1] * len(gop)
    for r, k in enumerate(order):
        rank[k] = r
    shows = [r >= 0 for r in rank]
    return dict(params=[vps, sps, pps], samples=samples, sync=sync, rank=rank, shows=shows,
                sp=sp, pp=pp, discarded=discarded)


def _draw_lists(rng: random.Random, ptype: str, before, after, lt_curr, total: int, pp: dict,
                missing, tmvp: bool) -> dict:
    """A picture's list sizes, modifications and collocated picture."""
    out = {}
    for lst in range(2 if ptype == "B" else 1):
        n = rng.choice([1, 1, 2, 2, 3, 4]) if total > 1 else rng.choice([1, 1, 2])
        order = (before + after if lst == 0 else after + before) + lt_curr
        tmp = []
        while len(tmp) < n:
            tmp += order
        entries = None
        if pp.get("list_mod") and total > 1 and rng.random() < 0.6:
            entries = [rng.randrange(total) for _ in range(n)]
            final = [tmp[e] for e in entries]
        else:
            final = tmp[:n]
        out[lst] = dict(n=n, entries=entries, pocs=final)
    col = None
    if tmvp:
        options = [(lst, i) for lst in out for i, q in enumerate(out[lst]["pocs"])
                   if q not in missing]
        if options:
            col = rng.choice(options)
    out["col"] = col
    return out


def _slice_lists(rng: random.Random, stype: int, lists: dict, pp: dict, mix: dict, tmvp: bool,
                 total: int) -> dict:
    """A P or B slice's header fields from its picture's list choices."""
    b = stype == 0
    n0 = lists[0]["n"]
    n1 = lists[1]["n"] if b else 0
    col = lists["col"]
    default = (pp["num_ref"][0], pp["num_ref"][1] if b else 0)
    out = dict(num_ref=(n0, n1), override=(n0, n1) != default or rng.random() < 0.3,
               list_entry=(lists[0]["entries"], lists[1]["entries"] if b else None),
               total=total, mvd_l1_zero=b and rng.random() < 0.4,
               cabac_init=pp.get("cabac_init") and rng.random() < 0.5, tmvp=tmvp,
               col_from_l0=True, col_ref_idx=0, max_merge=rng.randint(1, 5), mix=mix)
    if tmvp:
        out["col_from_l0"] = col[0] == 0
        out["col_ref_idx"] = col[1]
    out["init_type"] = (2 if out["cabac_init"] else 1) if not b else (1 if out["cabac_init"] else 2)
    if (pp.get("weighted") and not b) or (pp.get("weighted_bi") and b):
        luma_denom = rng.randint(0, 7)
        chroma_denom = rng.randint(0, 7)
        wl = []
        for lst in range(2 if b else 1):
            entries = []
            for _ in range(out["num_ref"][lst]):
                luma = ((rng.randint(-20, 20), rng.randint(-30, 30)) if rng.random() < 0.6 else None)
                chroma = ([(rng.randint(-20, 20), rng.randint(-100, 100)) for _ in range(2)]
                          if rng.random() < 0.5 else None)
                entries.append((luma, chroma))
            wl.append(entries)
        out["wp"] = dict(luma_denom=luma_denom, chroma_denom=chroma_denom, lists=wl)
    return out


# ------------------------------------------------------------ containers --

BT709 = dict(full_range=False, primaries=1, transfer=1, matrix=1, hrd=True)
BT601_FULL = dict(full_range=True, primaries=6, transfer=6, matrix=6, chroma_loc=2,
                  display_window=True)
# name -> write_hevc_stream's arguments: together they use every tool
# runtime/hevc.cpp names (tests/test_torch_hevc.py checks it); "phone"
# carries the parameter sets a phone encoder writes, at test size (coded
# 16 rows at a time, 136 rows in 144 with a conformance window, as 1080 in
# 1088)
# the PPS and SPS choices of a phone encoder's stream: SAO and deblocking on,
# no PCM, bypass, tiles, dependent slices, scaling lists or extra header bits
PHONE_TOOLS = dict(sao=True, deblock=(True, False, 0, 0), pcm=None, bypass=False, tiles=None,
                   dependent=False, output_flag=False, scaling=None, header_ext=False,
                   extra_bits=0, cip=False)
STREAMS = {
    "phone": dict(width=256, height=136, n_frames=3, seed=11, log2_ctb=6, log2_min_cb=4,
                  vui=BT709, tools=PHONE_TOOLS),
    "tiles_uniform": dict(width=136, height=72, n_frames=3, seed=3, log2_ctb=5,
                          tiles=([0, 0], [0, 0], False), max_slices=4,
                          tools=dict(lf_tiles=False, scaling="sps", pcm=(8, 7, 3, 4, True),
                                     bypass=True, sao=True, deblock=(True, False, 2, -3))),
    "wpp": dict(width=136, height=72, n_frames=3, seed=7, log2_ctb=4, wpp=True, vui=BT601_FULL,
                max_slices=4, tools=dict(dependent=True, ts=True, sdh=True, qp_delta=1,
                                         cqp=(-5, 7), slice_cqp=True, scaling="default",
                                         sao=True, deblock=None)),
    "tiles_explicit": dict(width=200, height=120, n_frames=2, seed=29, log2_ctb=5, log2_min_cb=4,
                           tiles=([2, 3, 2], [1, 3], True), max_slices=5,
                           tools=dict(dependent=True, lf_tiles=True, lf_slices=False,
                                      deblock=(False, True, 0, 0), pcm=(6, 5, 4, 5, False),
                                      scaling="sps", pps_scaling=True, cip=True,
                                      header_ext=True, strong=True, sao=True)),
    "open_gop": dict(width=64, height=48, n_frames=14, seed=5, log2_ctb=4, max_slices=2,
                     plan=["CRA", "RASL", "RADL", "TRAIL", "HIDDEN", "TRAIL_N", "CRA", "RASL",
                           "IDR", "RADL", "TRAIL", "BLA", "TRAIL", "IDR_N"],
                     tools=dict(long_term=True, num_lt_sps=2, num_rps=3, output_flag=True,
                                scaling="sps", bypass=True, ts=True)),
}
# Inter streams: each picture's NAL type, POC, TemporalId, slice type and
# the pictures its RPS keeps ((POC, used by the picture)), in decode order
_U, _F = True, False
GOP_PHONE = [dict(nal="IDR", poc=0, slices="I")] + [
    dict(nal="TRAIL", poc=k, slices="P",
         refs=[(k - 1, _U)] + ([(k - 2, k % 2 == 0)] if k >= 2 else [])) for k in range(1, 6)]
GOP_PYRAMID = [dict(nal="IDR", poc=0, slices="I"),
               dict(nal="TRAIL", poc=4, slices="B", refs=[(0, _U)]),      # lists alike (GPB)
               dict(nal="TRAIL", poc=2, slices="B", refs=[(0, _U), (4, _U)]),
               dict(nal="TRAIL", ref=False, poc=1, slices="B", refs=[(0, _U), (2, _U), (4, _F)]),
               dict(nal="TRAIL", ref=False, poc=3, slices="B", refs=[(2, _U), (4, _U)]),
               dict(nal="TRAIL", poc=8, slices="P", refs=[(4, _U), (2, _U)]),
               dict(nal="TRAIL", poc=6, slices="B", refs=[(4, _U), (8, _U)]),
               dict(nal="TRAIL", ref=False, poc=5, slices="B", refs=[(4, _U), (6, _U), (8, _F)]),
               dict(nal="TRAIL", ref=False, poc=7, slices="B", refs=[(6, _U), (8, _U)])]
GOP_LONG_TERM = [dict(nal="IDR", poc=0, slices="I"),
                 dict(nal="TRAIL", poc=1, slices="P", refs=[(0, _U)]),
                 dict(nal="TRAIL", poc=2, slices="P", refs=[(1, _U)], lt=[(0, _U, False)]),
                 dict(nal="TRAIL", poc=3, slices="B", refs=[(2, _U), (1, _F)], lt=[(0, _U, True)]),
                 dict(nal="TRAIL", poc=4, slices="P", refs=[(3, _U), (1, _U)], lt=[(0, _F, False)]),
                 dict(nal="TRAIL", poc=5, slices="B", refs=[(4, _U)], lt=[(0, _U, False)])]
GOP_TEMPORAL = [dict(nal="IDR", poc=0, slices="I"),
                dict(nal="TRAIL", poc=4, slices="P", refs=[(0, _U)]),
                # a sub-layer non-reference picture below the highest TemporalId,
                # which the TemporalId 2 pictures refer to
                dict(nal="TSA", ref=False, poc=2, tid=1, slices="B", refs=[(0, _U), (4, _U)]),
                dict(nal="TSA", poc=1, tid=2, slices="B", refs=[(0, _U), (2, _U), (4, _F)]),
                dict(nal="STSA", ref=False, poc=3, tid=2, slices="B", refs=[(2, _U), (4, _U)]),
                dict(nal="TRAIL", poc=8, slices="P", refs=[(4, _U)]),
                dict(nal="STSA", poc=6, tid=1, slices="B", refs=[(4, _U), (8, _U)]),
                dict(nal="TRAIL", ref=False, poc=5, tid=2, slices="B",
                     refs=[(4, _U), (6, _U), (8, _F)]),
                dict(nal="TRAIL", ref=False, poc=7, tid=2, slices="B", refs=[(6, _U), (8, _U)])]
# a stream that starts at a CRA whose RPS names pictures it never holds
# (generated, as ffmpeg generates them for an IRAP picture) and whose RASL
# pictures ffmpeg skips; a later CRA's RASL pictures refer across it
GOP_OPEN = [dict(nal="CRA", poc=8, slices="I", refs=[(5, _F), (6, _F)], missing=[5, 6]),
            dict(nal="RASL", poc=6, slices="B", refs=[(5, _U), (8, _U)], missing=[5]),
            dict(nal="RASL", ref=False, poc=7, slices="B", refs=[(6, _U), (8, _U)]),
            dict(nal="TRAIL", poc=9, slices="P", refs=[(8, _U)]),
            dict(nal="TRAIL", poc=10, slices="B", refs=[(9, _U), (8, _F)]),
            dict(nal="TRAIL", poc=12, slices="P", refs=[(10, _U), (8, _F)]),
            dict(nal="CRA", poc=16, slices="I", refs=[(12, _F)]),
            dict(nal="RASL", poc=14, slices="B", refs=[(12, _U), (16, _U)]),
            dict(nal="RASL", ref=False, poc=13, slices="B", refs=[(12, _U), (14, _U), (16, _F)]),
            dict(nal="RADL", ref=False, poc=15, slices="P", refs=[(16, _U)]),
            dict(nal="TRAIL", poc=17, slices="P", refs=[(16, _U)]),
            dict(nal="TRAIL", poc=18, slices="B", refs=[(17, _U), (16, _U)])]
# pic_output_flag 0 on one picture; the second IDR's no_output_of_prior_pics_flag
# discards the two pictures still waiting for output (POC 2 and 3)
GOP_OUTPUT = [dict(nal="IDR", poc=0, slices="I"),
              dict(nal="TRAIL", poc=2, slices="P", refs=[(0, _U)]),
              dict(nal="TRAIL", ref=False, poc=1, slices="B", refs=[(0, _U), (2, _U)]),
              dict(nal="TRAIL", poc=4, slices="P", refs=[(2, _U)], output=False),
              dict(nal="TRAIL", poc=3, slices="B", refs=[(2, _U), (4, _U)]),
              dict(nal="IDR", poc=0, slices="I", no_output_prior=True),
              dict(nal="TRAIL", poc=1, slices="P", refs=[(0, _U)]),
              dict(nal="TRAIL", poc=2, slices="P", refs=[(1, _U), (0, _F)])]
INTER_STREAMS = {
    "phone_ippp": dict(width=256, height=136, seed=41, gop=GOP_PHONE, log2_ctb=6, log2_min_cb=4,
                       vui=BT709, tools=dict(PHONE_TOOLS, num_ref=(2, 1))),
    "pyramid": dict(width=128, height=72, seed=42, gop=GOP_PYRAMID, log2_ctb=5, log2_min_cb=3,
                    max_slices=2, tools=dict(amp=True, par_mrg=3, weighted=True, reorder=2, dpb=5)),
    "long_term": dict(width=96, height=64, seed=43, gop=GOP_LONG_TERM, log2_ctb=4,
                      tools=dict(list_mod=True, cabac_init=True, weighted_bi=True, num_ref=(2, 2))),
    "temporal": dict(width=128, height=72, seed=44, gop=GOP_TEMPORAL, log2_ctb=5,
                     tools=dict(cip=True), mix=dict(intra=0.3)),
    "open_gop_inter": dict(width=96, height=64, seed=45, gop=GOP_OPEN, log2_ctb=4, max_slices=2),
    "output": dict(width=96, height=64, seed=46, gop=GOP_OUTPUT, log2_ctb=5, log2_min_cb=4,
                   tools=dict(cabac_init=True)),
}
STREAMS.update(INTER_STREAMS)
# the SHA-256 of ffmpeg's (Y, U, V) planes of each stream in output order
# (tests/test_torch_hevc.py, libavcodec's hevc decoder inside cv2 5.0.0);
# chip_smoke.py holds the port's planes against them on the card's machine
PINNED_SHA256 = {
    "phone": "192fed1c767214ed264c5a1e6a0f15a1d50d2f530e879b2b3d464016736ca64d",
    "tiles_uniform": "20f7c757cd1d011fa166797292d1c4fe3bc47550b75a80b9d4f141db7b6a0d4e",
    "wpp": "fc8debc3562c11c940f13c82f0ca8b3b8681d918e2a0efde1ec20b66e6847875",
    "tiles_explicit": "625845885fc914af72c53d01cb8e2498c21eefbff5b4c1efe207a161d85eb8dd",
    "open_gop": "05ea446821dca6af2d679e51d503a0315d54960bfec1564648b98789220c9e9a",
    "phone_ippp": "4ce6c40c3108ba00d0d3579f484897dbf97a8fca07e98adb24ba3fe1850c3ad4",
    "pyramid": "60c2662ea3f8c276a2945072353b5b9fe54925d1cd9679f59a16b575bf9c5cd1",
    "long_term": "2ca95106044fb0f700ddcfb910cc030a7b7ddb2c26cb4322564c9d9ffff68762",
    "temporal": "130f0a152eba3624e73fe83cd269d07803ee5f11aad26358fc8372733018d10c",
    "open_gop_inter": "49017bfcc6e957f3ddaa7452c123a356cb9441d74051efe831e924cf25f91257",
    "output": "c41176a58288eb8ae46f02246f8e5f393ffb0a401a32905fc39c22f9ecc037d1",
}
# cv2's RGB frames (container_writer.rgb_sha256) of "phone" in an hvc1 mp4
# whose tkhd turns it 90 degrees clockwise (a portrait phone recording):
# write_rotated_mp4
PINNED_ROTATED_RGB_SHA256 = "d6b6b815604179b0257725da7790220ba0c5030f681e5c4059c371bc70f4f8ac"


def write_rotated_mp4(path) -> None:
    """:data:`PINNED_ROTATED_RGB_SHA256`'s file: "phone" as ``hvc1`` with a
    90-degree ``tkhd`` matrix."""
    from cap4d_torch.utils import container_writer as cw

    kw = STREAMS["phone"]
    write_hevc_mp4(path, stream("phone"), kw["width"], kw["height"])
    cw.set_display_matrix(path, cw.rotation_matrix(90))


def stream(name: str) -> dict:
    """:data:`STREAMS`' stream ``name`` (write_hevc_stream's dict)."""
    kw = dict(STREAMS[name])
    if "gop" in kw:
        return write_hevc_inter_stream(kw.pop("width"), kw.pop("height"), kw.pop("seed"),
                                       kw.pop("gop"), **kw)
    return write_hevc_stream(kw.pop("width"), kw.pop("height"), kw.pop("n_frames"), **kw)


def write_stream_mp4(path, name: str) -> dict:
    """:data:`STREAMS`' stream ``name`` written as an ``hvc1`` mp4 at
    ``path``; returns the stream's dict."""
    st = stream(name)
    write_hevc_mp4(path, st, STREAMS[name]["width"], STREAMS[name]["height"])
    return st


def as_stream(st: dict, width: int, height: int):
    """``container_writer``'s Stream of a written stream: pictures that show
    nowhere (RASL pictures of the first CRA, pic_output_flag 0) are
    presented after the shown ones, so that the shown ones keep cv2's
    frame numbers."""
    from cap4d_torch.data import mp4
    from cap4d_torch.utils import container_writer as cw

    shown = sum(r >= 0 for r in st["rank"])
    rank, extra = [], shown
    for r in st["rank"]:
        rank.append(r if r >= 0 else extra)
        extra += r < 0
    params = tuple(b"\0\0\0\1" + p for p in st["params"])
    return cw.Stream("hevc", width, height, list(st["samples"]), list(st["sync"]), rank,
                     hvc=mp4.HvcConfig(params, 4, st["sp"]["profile"]))


def write_hevc_mp4(path, st: dict, width: int, height: int, fourcc: bytes = b"hvc1") -> None:
    """``st`` as an mp4: ``hvc1`` with the parameter sets in ``hvcC`` only,
    or ``hev1`` with an empty ``hvcC`` and the parameter sets in band before
    each IRAP sample; composition offsets and an edit list where pictures
    show out of decode order."""
    from cap4d_torch.data import mp4
    from cap4d_torch.utils import container_writer as cw

    s = as_stream(st, width, height)
    if fourcc == b"hev1":
        inband = b"".join(struct.pack(">I", len(p)) + p for p in st["params"])
        s.samples = [(inband if key else b"") + x for x, key in zip(s.samples, s.sync)]
        entry_s = cw.Stream(**{**s.__dict__, "hvc": mp4.HvcConfig((), 4, s.hvc.profile)})
    else:
        entry_s = s
    from cap4d_torch.utils import synthetic_assets as sa

    delay = max(j - r for j, r in enumerate(s.rank))
    ctts = [r - j + delay for j, r in enumerate(s.rank)] if delay else None
    sa.write_mp4(path, s.samples, cw.mp4_sample_entry(entry_s, fourcc), width, height,
                 sync=s.sync, ctts=ctts, edit_start=delay)


REFUSALS = {"p_slice": "P slices in an IRAP picture", "b_slice": "B slices in an IRAP picture",
            "main10": "Main 10", "422": "4:2:2", "main_rext": "format range extensions",
            "missing_ref": "names POC -1 for prediction, which the DPB does not hold"}


def write_hevc_refusal_mp4(path, tool: str) -> str:
    """An mp4 (``hvc1``) of a stream the port refuses; returns the name the
    error gives (:data:`REFUSALS`)."""
    plan, tools = ["IDR"], {}
    if tool == "missing_ref":     # a P picture predicting from a picture the stream never held
        gop = [dict(nal="IDR", poc=0, slices="I"),
               dict(nal="TRAIL", poc=1, slices="P", refs=[(0, _U), (-1, _U)], missing=[-1])]
        write_hevc_mp4(path, write_hevc_inter_stream(32, 32, 1, gop, log2_ctb=4), 32, 32)
        return REFUSALS[tool]
    if tool == "p_slice":
        plan = ["IDR", "P"]
    elif tool == "b_slice":
        plan = ["IDR", "B"]
    elif tool == "main10":
        tools = dict(profile=2, bit_depth=10)
    elif tool == "422":
        tools = dict(profile=4, chroma_format=2)
    elif tool == "main_rext":
        tools = dict(profile=4)
    st = write_hevc_stream(32, 32, len(plan), seed=1, log2_ctb=4, plan=plan, tools=tools,
                           max_slices=1)
    write_hevc_mp4(path, st, 32, 32)
    return REFUSALS[tool]


def planes_sha256(pictures) -> str:
    """The SHA-256 of (Y, U, V) uint8 planes of pictures in output order."""
    h = hashlib.sha256()
    for planes in pictures:
        for p in planes:
            h.update(p.tobytes())
    return h.hexdigest()
