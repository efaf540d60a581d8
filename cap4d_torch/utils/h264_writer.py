"""Seeded random-syntax H.264 streams: test input for the port's H.264
decoder (``runtime/h264.cpp``), written without an encoder.

Neither the test machine's cv2 nor the card's machine has an H.264 encoder,
so this writer emits syntax, not pictures. Every syntax element of every
macroblock (type and partitions, intra prediction modes, reference indices,
motion vector differences, coded block pattern, transform size, QP changes,
residual levels, I_PCM samples) is drawn from a seeded ``random.Random`` and
entropy-coded with CAVLC or CABAC as the standard's parsing process reads
it back (ITU-T H.264, clauses 7 and 9). The stream decodes to whatever that
syntax means; an independent decoder (ffmpeg, in the tests) is the oracle.

What a draw may take is limited only where the standard limits it:

- intra prediction modes are drawn from those whose neighbouring samples
  are available, which depends on slice and picture edges (and on
  ``constrained_intra_pred_flag``), never on pixels;
- references come from the writer's own model of the DPB (frame_num,
  short- and long-term marking, the sliding window, MMCO 1-6), so list
  modifications and MMCO commands name pictures the DPB holds;
- dequantised coefficients, and every intermediate of the inverse
  transforms, stay inside 16 bits (8.5.12.1): a block whose levels could
  leave them is scaled down before it is coded, a bound computed from
  |level| x LevelScale (``_fits``).

The writer keeps only the state coding needs: the neighbours' total
coefficient counts (CAVLC's nC), the CABAC context neighbours (skip, type,
cbp, coded_block_flag, |mvd| and ref_idx of each list, direct mode,
transform size, chroma mode), the intra modes for their prediction, and the
DPB. It never reconstructs a pixel. Slices are coded independently of each
other (neighbours in another slice are unavailable), so ``workers`` > 1
codes them in a process pool.

With ``b_frames`` the stream has B pictures (7.3.4, 7.3.5): groups of 0-3
between anchors, decoded after the anchor that closes them, a reference B
picture in a group's middle (a pyramid) or none; low-delay B pictures
(both lists from the past) with POC type 2. B slices draw B_Skip,
B_Direct_16x16, the 21 partition types and B_8x8 with every sub_mb_type,
ref_idx and mvd for both lists, spatial or temporal direct prediction,
list-1 modifications, and explicit weights where the PPS's
weighted_bipred_idc is 1 (|w| <= 64, so that w0 + w1 stays in range). The
order count comes from pic_order_cnt_lsb (type 0) or delta_pic_order_cnt[0]
against the SPS's cycle (type 1). The container follows what ffmpeg reads:
``ctts`` offsets from the display order, an edit list whose media time is
the first sample's offset, and a VUI bitstream restriction with the true
max_num_reorder_frames (ffmpeg's output delay) and max_dec_frame_buffering.
Where ffmpeg departs from the standard on B syntax, the writer steers
clear (``_b_pictures``, ``_marking``): no MMCO 5, at most one long-term
reference, the lists shared by a picture's slices with an inter slice
first, and temporal direct only where ffmpeg's frame_num matching finds
the co-located picture's references. Without ``b_frames`` the files are
what they were before B pictures existed.
"""

from __future__ import annotations

import random
import struct
from typing import Dict, List, Optional, Tuple

from cap4d_torch.utils.synthetic_assets import _Bits, _box, nal_unit, visual_sample_entry, write_mp4

# ----------------------------------------------------------------- tables --

ZIGZAG4 = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
ZIGZAG8 = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
           34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
           37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
# Tables 7-3 and 7-4, zig-zag order
DEFAULT_4 = ([6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42],
             [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34])
DEFAULT_8 = ([6, 10, 10, 13, 11, 13, 16, 16, 16, 16] + [18] * 5 + [23] * 6 + [25] * 7 + [27] * 8
             + [29] * 7 + [31] * 6 + [33] * 5 + [36] * 4 + [38] * 3 + [40] * 2 + [42],
             [9, 13, 13, 15, 13, 15, 17, 17, 17, 17] + [19] * 5 + [21] * 6 + [22] * 7 + [24] * 8
             + [25] * 7 + [27] * 6 + [28] * 5 + [30] * 4 + [32] * 3 + [33] * 2 + [35])
NORM4 = [[10, 16, 13], [11, 18, 14], [13, 20, 16], [14, 23, 18], [16, 25, 20], [18, 29, 23]]
NORM8 = [[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26], [26, 23, 42, 24, 33, 31],
         [28, 25, 45, 26, 35, 33], [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]]
CHROMA_QP = list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
                               38, 39, 39, 39, 39]
BLK_RASTER = [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]   # luma4x4BlkIdx -> y*4+x

# Table 9-5: coeff_token (length, code) by nC class, index TotalCoeff * 4 + TrailingOnes
_TOKEN_LEN = [
    1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13,
    13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16,
    15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16, 2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3,
    0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9,
    12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14,
    13, 14, 14, 14, 14, 4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7,
    6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9,
    10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6
]
_TOKEN_CODE = [
    1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14,
    5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12,
    11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8, 3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7,
    6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8,
    10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4, 15, 0, 0, 0,
    15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10,
    9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9,
    12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2, 3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
    58, 59, 60, 61, 62, 63
]
_CDC_TOKEN_LEN = [2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7]
_CDC_TOKEN_CODE = [1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0]
# Tables 9-7 to 9-10: total_zeros [TotalCoeff - 1][total_zeros], run_before [min(zerosLeft, 7) - 1]
_TZ_LEN = [[1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9], [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6], [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6], [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5], [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5], [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6], [6, 5, 3, 3, 3, 2, 3, 4, 3, 6], [6, 4, 5, 3, 2, 2, 3, 3, 6], [6, 6, 4, 2, 2, 3, 2, 5], [5, 5, 3, 2, 2, 2, 4], [4, 4, 3, 3, 1, 3], [4, 4, 2, 1, 3], [3, 3, 1, 2], [2, 2, 1], [1, 1]]
_TZ_CODE = [[1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1], [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0], [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0], [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0], [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0], [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0], [1, 1, 5, 4, 3, 3, 2, 1, 1, 0], [1, 1, 1, 3, 3, 2, 2, 1, 0], [1, 0, 1, 3, 2, 1, 1, 1], [1, 0, 1, 3, 2, 1, 1], [0, 1, 1, 2, 1, 3], [0, 1, 1, 1, 1], [0, 1, 1, 1], [0, 1, 1], [0, 1]]
_CDC_TZ_LEN = [[1, 2, 3, 3], [1, 2, 2], [1, 1]]
_CDC_TZ_CODE = [[1, 1, 1, 0], [1, 1, 0], [1, 0]]
_RUN_LEN = [[1, 1], [1, 2, 2], [2, 2, 2, 2], [2, 2, 2, 3, 3], [2, 2, 3, 3, 3, 3], [2, 3, 3, 3, 3, 3, 3], [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11]]
_RUN_CODE = [[1, 0], [1, 1, 0], [3, 2, 1, 0], [3, 2, 1, 1, 0], [3, 2, 3, 2, 1, 0], [3, 0, 1, 3, 2, 5, 4], [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1]]
# Table 9-4: codeNum -> coded_block_pattern (Intra_4x4/8x8, Inter)
_CBP_INTRA = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46, 16, 3, 5, 10, 12, 19, 21, 26,
    28, 35, 37, 42, 44, 1, 2, 4, 8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41
]
_CBP_INTER = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6, 9, 31, 35, 37, 42, 44, 33, 34,
    36, 40, 39, 43, 45, 46, 17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41
]
# Tables 9-44, 9-45: rangeTabLPS[pStateIdx][qCodIRangeIdx], transIdxLPS
_RANGE_LPS = [
    128, 176, 208, 240, 128, 167, 197, 227, 128, 158, 187, 216, 123, 150, 178, 205, 116, 142, 169,
    195, 111, 135, 160, 185, 105, 128, 152, 175, 100, 122, 144, 166, 95, 116, 137, 158, 90, 110,
    130, 150, 85, 104, 123, 142, 81, 99, 117, 135, 77, 94, 111, 128, 73, 89, 105, 122, 69, 85,
    100, 116, 66, 80, 95, 110, 62, 76, 90, 104, 59, 72, 86, 99, 56, 69, 81, 94, 53, 65, 77, 89,
    51, 62, 73, 85, 48, 59, 69, 80, 46, 56, 66, 76, 43, 53, 63, 72, 41, 50, 59, 69, 39, 48, 56,
    65, 37, 45, 54, 62, 35, 43, 51, 59, 33, 41, 48, 56, 32, 39, 46, 53, 30, 37, 43, 50, 29, 35,
    41, 48, 27, 33, 39, 45, 26, 31, 37, 43, 24, 30, 35, 41, 23, 28, 33, 39, 22, 27, 32, 37, 21,
    26, 30, 35, 20, 24, 29, 33, 19, 23, 27, 31, 18, 22, 26, 30, 17, 21, 25, 28, 16, 20, 23, 27,
    15, 19, 22, 25, 14, 18, 21, 24, 14, 17, 20, 23, 13, 16, 19, 22, 12, 15, 18, 21, 12, 14, 17,
    20, 11, 14, 16, 19, 11, 13, 15, 18, 10, 12, 15, 17, 10, 12, 14, 16, 9, 11, 13, 15, 9, 11, 12,
    14, 8, 10, 12, 14, 8, 9, 11, 13, 7, 9, 11, 12, 7, 9, 10, 12, 7, 8, 10, 11, 6, 8, 9, 11, 6, 7,
    9, 10, 6, 7, 8, 9, 2, 2, 2, 2
]
_TRANS_LPS = [
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21,
    21, 22, 22, 23, 24, 24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33,
    34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63
]
# Table 9-43 (frame coded 8x8 blocks): ctxIdxInc of significant / last by levelListIdx
_SIG8 = [
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5, 4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8,
    7, 7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11, 12, 13, 11, 6, 9, 14, 10, 9, 11, 12,
    13, 11, 14, 10, 12
]
_LAST8 = [
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8
]
# Tables 9-12 to 9-25: (m, n) of ctxIdx 0-459 for I slices and cabac_init_idc 0-2 (the
# field contexts, never used, are 0), as m0, n0, m1, n1, ...
_CABAC_I = [
    20, -15, 2, 54, 3, 74, 20, -15, 2, 54, 3, 74, -28, 127, -23, 104, -6, 53, -1, 54, 7, 51, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 41, 0, 63, 0, 63, 0, 63, -9, 83, 4, 86, 0, 97, -7, 72, 13, 41, 3, 62, 0, 11, 1,
    55, 0, 69, -17, 127, -13, 102, 0, 82, -7, 74, -21, 107, -27, 127, -31, 127, -24, 127, -18, 95,
    -27, 127, -21, 114, -30, 127, -17, 123, -12, 115, -16, 122, -11, 115, -12, 63, -2, 68, -15,
    84, -13, 104, -3, 70, -8, 93, -10, 90, -30, 127, -1, 74, -6, 97, -7, 91, -20, 127, -4, 56, -5,
    82, -7, 76, -22, 125, -7, 93, -11, 87, -3, 77, -5, 71, -4, 63, -4, 68, -12, 84, -7, 62, -7,
    65, 8, 61, 5, 56, -2, 66, 1, 64, 0, 61, -2, 78, 1, 50, 7, 52, 10, 35, 0, 44, 11, 38, 1, 45, 0,
    46, 5, 44, 31, 17, 1, 51, 7, 50, 28, 19, 16, 33, 14, 62, -13, 108, -15, 100, -13, 101, -13,
    91, -12, 94, -10, 88, -16, 84, -10, 86, -7, 83, -13, 87, -19, 94, 1, 70, 0, 72, -5, 74, 18,
    59, -8, 102, -15, 100, 0, 95, -4, 75, 2, 72, -11, 75, -3, 71, 15, 46, -13, 69, 0, 62, 0, 65,
    21, 37, -15, 72, 9, 57, 16, 54, 0, 62, 12, 72, 24, 0, 15, 9, 8, 25, 13, 18, 15, 9, 13, 19, 10,
    37, 12, 18, 6, 29, 20, 33, 15, 30, 4, 45, 1, 58, 0, 62, 7, 61, 12, 38, 11, 45, 15, 39, 11, 42,
    13, 44, 16, 45, 12, 41, 10, 49, 30, 34, 18, 42, 10, 55, 17, 51, 17, 46, 0, 89, 26, -19, 22,
    -17, 26, -17, 30, -25, 28, -20, 33, -23, 37, -27, 33, -23, 40, -28, 38, -17, 33, -11, 40, -15,
    41, -6, 38, 1, 41, 17, 30, -6, 27, 3, 26, 22, 37, -16, 35, -4, 38, -8, 38, -3, 37, 3, 38, 5,
    42, 0, 35, 16, 39, 22, 14, 48, 27, 37, 21, 60, 12, 68, 2, 97, -3, 71, -6, 42, -5, 50, -3, 54,
    -2, 62, 0, 58, 1, 63, -2, 72, -1, 74, -9, 91, -5, 67, -5, 27, -3, 39, -2, 44, 0, 46, -16, 64,
    -8, 68, -10, 78, -6, 77, -10, 86, -12, 92, -15, 55, -10, 60, -6, 62, -4, 65, -12, 73, -8, 76,
    -7, 80, -9, 88, -17, 110, -11, 97, -20, 84, -11, 79, -6, 73, -4, 74, -13, 86, -13, 96, -11,
    97, -19, 117, -8, 78, -5, 33, -4, 48, -2, 53, -3, 62, -13, 71, -10, 79, -12, 86, -13, 90, -14,
    97, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 31,
    21, 31, 31, 25, 50, -17, 120, -20, 112, -18, 114, -11, 85, -15, 92, -14, 89, -26, 71, -15, 81,
    -14, 80, 0, 68, -14, 70, -24, 56, -23, 68, -24, 50, -11, 74, 23, -13, 26, -13, 40, -15, 49,
    -14, 44, 3, 45, 6, 44, 34, 33, 54, 19, 82, -3, 75, -1, 23, 1, 34, 1, 43, 0, 54, -2, 55, 0, 61,
    1, 64, 0, 68, -9, 92, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0
]
_CABAC_P0 = [
    20, -15, 2, 54, 3, 74, 20, -15, 2, 54, 3, 74, -28, 127, -23, 104, -6, 53, -1, 54, 7, 51, 23,
    33, 23, 2, 21, 0, 1, 9, 0, 49, -37, 118, 5, 57, -13, 78, -11, 65, 1, 62, 12, 49, -4, 73, 17,
    50, 18, 64, 9, 43, 29, 0, 26, 67, 16, 90, 9, 104, -46, 127, -20, 104, 1, 67, -13, 78, -11, 65,
    1, 62, -6, 86, -17, 95, -6, 61, 9, 45, -3, 69, -6, 81, -11, 96, 6, 55, 7, 67, -5, 86, 2, 88, 0,
    58, -3, 76, -10, 94, 5, 54, 4, 69, -3, 81, 0, 88, -7, 67, -5, 74, -4, 74, -5, 80, -7, 72, 1,
    58, 0, 41, 0, 63, 0, 63, 0, 63, -9, 83, 4, 86, 0, 97, -7, 72, 13, 41, 3, 62, 0, 45, -4, 78, -3,
    96, -27, 126, -28, 98, -25, 101, -23, 67, -28, 82, -20, 94, -16, 83, -22, 110, -21, 91, -18,
    102, -13, 93, -29, 127, -7, 92, -5, 89, -7, 96, -13, 108, -3, 46, -1, 65, -1, 57, -9, 93, -3,
    74, -9, 92, -8, 87, -23, 126, 5, 54, 6, 60, 6, 59, 6, 69, -1, 48, 0, 68, -4, 69, -8, 88, -2,
    85, -6, 78, -1, 75, -7, 77, 2, 54, 5, 50, -3, 68, 1, 50, 6, 42, -4, 81, 1, 63, -4, 70, 0, 67,
    2, 57, -2, 76, 11, 35, 4, 64, 1, 61, 11, 35, 18, 25, 12, 24, 13, 29, 13, 36, -10, 93, -7, 73,
    -2, 73, 13, 46, 9, 49, -7, 100, 9, 53, 2, 53, 5, 53, -2, 61, 0, 56, 0, 56, -13, 63, -5, 60, -1,
    62, 4, 57, -6, 69, 4, 57, 14, 39, 4, 51, 13, 68, 3, 64, 1, 61, 9, 63, 7, 50, 16, 39, 5, 44, 4,
    52, 11, 48, -5, 60, -1, 59, 0, 59, 22, 33, 5, 44, 14, 43, -1, 78, 0, 60, 9, 69, 11, 28, 2, 40,
    3, 44, 0, 49, 0, 46, 2, 44, 2, 51, 0, 47, 4, 39, 2, 62, 6, 46, 0, 54, 3, 54, 2, 58, 4, 63, 6,
    51, 6, 57, 7, 53, 6, 52, 6, 55, 11, 45, 14, 36, 8, 53, -1, 82, 7, 55, -3, 78, 15, 46, 22, 31,
    -1, 84, 25, 7, 30, -7, 28, 3, 28, 4, 32, 0, 34, -1, 30, 6, 30, 6, 32, 9, 31, 19, 26, 27, 26,
    30, 37, 20, 28, 34, 17, 70, 1, 67, 5, 59, 9, 67, 16, 30, 18, 32, 18, 35, 22, 29, 24, 31, 23,
    38, 18, 43, 20, 41, 11, 63, 9, 59, 9, 64, -1, 94, -2, 89, -9, 108, -6, 76, -2, 44, 0, 45, 0,
    52, -3, 64, -2, 59, -4, 70, -4, 75, -8, 82, -17, 102, -9, 77, 3, 24, 0, 42, 0, 48, 0, 55, -6,
    59, -7, 71, -12, 83, -11, 87, -30, 119, 1, 58, -3, 29, -1, 36, 1, 38, 2, 43, -6, 55, 0, 58, 0,
    64, -3, 74, -10, 90, 0, 70, -4, 29, 5, 31, 7, 42, 1, 59, -2, 58, -3, 72, -3, 81, -11, 97, 0,
    58, 8, 5, 10, 14, 14, 18, 13, 27, 2, 40, 0, 58, -3, 70, -6, 79, -8, 85, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 12, 40, 11, 51, 14, 59, -4, 79, -7, 71, -5, 69, -9,
    70, -8, 66, -10, 68, -19, 73, -12, 69, -16, 70, -15, 67, -20, 62, -19, 70, -16, 66, -22, 65,
    -20, 63, 9, -2, 26, -9, 33, -9, 39, -7, 41, -2, 45, 3, 49, 9, 45, 27, 36, 59, -6, 66, -7, 35,
    -7, 42, -8, 45, -5, 48, -12, 56, -6, 60, -5, 62, -8, 66, -8, 76, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0
]
_CABAC_P1 = [
    20, -15, 2, 54, 3, 74, 20, -15, 2, 54, 3, 74, -28, 127, -23, 104, -6, 53, -1, 54, 7, 51, 22,
    25, 34, 0, 16, 0, -2, 9, 4, 41, -29, 118, 2, 65, -6, 71, -13, 79, 5, 52, 9, 50, -3, 70, 10, 54,
    26, 34, 19, 22, 40, 0, 57, 2, 41, 36, 26, 69, -45, 127, -15, 101, -4, 76, -6, 71, -13, 79, 5,
    52, 6, 69, -13, 90, 0, 52, 8, 43, -2, 69, -5, 82, -10, 96, 2, 59, 2, 75, -3, 87, -3, 100, 1,
    56, -3, 74, -6, 85, 0, 59, -3, 81, -7, 86, -5, 95, -1, 66, -1, 77, 1, 70, -2, 86, -5, 72, 0,
    61, 0, 41, 0, 63, 0, 63, 0, 63, -9, 83, 4, 86, 0, 97, -7, 72, 13, 41, 3, 62, 13, 15, 7, 51, 2,
    80, -39, 127, -18, 91, -17, 96, -26, 81, -35, 98, -24, 102, -23, 97, -27, 119, -24, 99, -21,
    110, -18, 102, -36, 127, 0, 80, -5, 89, -7, 94, -4, 92, 0, 39, 0, 65, -15, 84, -35, 127, -2,
    73, -12, 104, -9, 91, -31, 127, 3, 55, 7, 56, 7, 55, 8, 61, -3, 53, 0, 68, -7, 74, -9, 88, -13,
    103, -13, 91, -9, 89, -14, 92, -8, 76, -12, 87, -23, 110, -24, 105, -10, 78, -20, 112, -17, 99,
    -78, 127, -70, 127, -50, 127, -46, 127, -4, 66, -5, 78, -4, 71, -8, 72, 2, 59, -1, 55, -7, 70,
    -6, 75, -8, 89, -34, 119, -3, 75, 32, 20, 30, 22, -44, 127, 0, 54, -5, 61, 0, 58, -1, 60, -3,
    61, -8, 67, -25, 84, -14, 74, -5, 65, 5, 52, 2, 57, 0, 61, -9, 69, -11, 70, 18, 55, -4, 71, 0,
    58, 7, 61, 9, 41, 18, 25, 9, 32, 5, 43, 9, 47, 0, 44, 0, 51, 2, 46, 19, 38, -4, 66, 15, 38, 12,
    42, 9, 34, 0, 89, 4, 45, 10, 28, 10, 31, 33, -11, 52, -43, 18, 15, 28, 0, 35, -22, 38, -25, 34,
    0, 39, -18, 32, -12, 102, -94, 0, 0, 56, -15, 33, -4, 29, 10, 37, -5, 51, -29, 39, -9, 52, -34,
    69, -58, 67, -63, 44, -5, 32, 7, 55, -29, 32, 1, 0, 0, 27, 36, 33, -25, 34, -30, 36, -28, 38,
    -28, 38, -27, 34, -18, 35, -16, 34, -14, 32, -8, 37, -6, 35, 0, 30, 10, 28, 18, 26, 25, 29, 41,
    0, 75, 2, 72, 8, 77, 14, 35, 18, 31, 17, 35, 21, 30, 17, 45, 20, 42, 18, 45, 27, 26, 16, 54, 7,
    66, 16, 56, 11, 73, 10, 67, -10, 116, -23, 112, -15, 71, -7, 61, 0, 53, -5, 66, -11, 77, -9,
    80, -9, 84, -10, 87, -34, 127, -21, 101, -3, 39, -5, 53, -7, 61, -11, 75, -15, 77, -17, 91,
    -25, 107, -25, 111, -28, 122, -11, 76, -10, 44, -10, 52, -10, 57, -9, 58, -16, 72, -7, 69, -4,
    69, -5, 74, -9, 86, 2, 66, -9, 34, 1, 32, 11, 31, 5, 52, -2, 55, -2, 67, 0, 73, -8, 89, 3, 52,
    7, 4, 10, 8, 17, 8, 16, 19, 3, 37, -1, 61, -5, 73, -1, 70, -4, 78, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 25, 32, 21, 49, 21, 54, -5, 85, -6, 81, -10, 77, -7, 81,
    -17, 80, -18, 73, -4, 74, -10, 83, -9, 71, -9, 67, -1, 61, -8, 66, -14, 66, 0, 59, 2, 59, 17,
    -10, 32, -13, 42, -9, 49, -5, 53, 0, 64, 3, 68, 10, 66, 27, 47, 57, -5, 71, 0, 24, -1, 36, -2,
    42, -2, 52, -9, 57, -6, 63, -4, 65, -4, 67, -7, 82, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0
]
_CABAC_P2 = [
    20, -15, 2, 54, 3, 74, 20, -15, 2, 54, 3, 74, -28, 127, -23, 104, -6, 53, -1, 54, 7, 51, 29,
    16, 25, 0, 14, 0, -10, 51, -3, 62, -27, 99, 26, 16, -4, 85, -24, 102, 5, 57, 6, 57, -17, 73,
    14, 57, 20, 40, 20, 10, 29, 0, 54, 0, 37, 42, 12, 97, -32, 127, -22, 117, -2, 74, -4, 85, -24,
    102, 5, 57, -6, 93, -14, 88, -6, 44, 4, 55, -11, 89, -15, 103, -21, 116, 19, 57, 20, 58, 4, 84,
    6, 96, 1, 63, -5, 85, -13, 106, 5, 63, 6, 75, -3, 90, -1, 101, 3, 55, -4, 79, -2, 75, -12, 97,
    -7, 50, 1, 60, 0, 41, 0, 63, 0, 63, 0, 63, -9, 83, 4, 86, 0, 97, -7, 72, 13, 41, 3, 62, 7, 34,
    -9, 88, -20, 127, -36, 127, -17, 91, -14, 95, -25, 84, -25, 86, -12, 89, -17, 91, -31, 127,
    -14, 76, -18, 103, -13, 90, -37, 127, 11, 80, 5, 76, 2, 84, 5, 78, -6, 55, 4, 61, -14, 83, -37,
    127, -5, 79, -11, 104, -11, 91, -30, 127, 0, 65, -2, 79, 0, 72, -4, 92, -6, 56, 3, 68, -8, 71,
    -13, 98, -4, 86, -12, 88, -5, 82, -3, 72, -4, 67, -8, 72, -16, 89, -9, 69, -1, 59, 5, 66, 4,
    57, -4, 71, -2, 71, 2, 58, -1, 74, -4, 44, -1, 69, 0, 62, -7, 51, -4, 47, -6, 42, -3, 41, -6,
    53, 8, 76, -9, 78, -11, 83, 9, 52, 0, 67, -5, 90, 1, 67, -15, 72, -5, 75, -8, 80, -21, 83, -21,
    64, -13, 31, -25, 64, -29, 94, 9, 75, 17, 63, -8, 74, -5, 35, -2, 27, 13, 91, 3, 65, -7, 69, 8,
    77, -10, 66, 3, 62, -3, 68, -20, 81, 0, 30, 1, 7, -3, 23, -21, 74, 16, 66, -23, 124, 17, 37,
    44, -18, 50, -34, -22, 127, 4, 39, 0, 42, 7, 34, 11, 29, 8, 31, 6, 37, 7, 42, 3, 40, 8, 33, 13,
    43, 13, 36, 4, 47, 3, 55, 2, 58, 6, 60, 8, 44, 11, 44, 14, 42, 7, 48, 4, 56, 4, 52, 13, 37, 9,
    49, 19, 58, 10, 48, 12, 45, 0, 69, 20, 33, 8, 63, 35, -18, 33, -25, 28, -3, 24, 10, 27, 0, 34,
    -14, 52, -44, 39, -24, 19, 17, 31, 25, 36, 29, 24, 33, 34, 15, 30, 20, 22, 73, 20, 34, 19, 31,
    27, 44, 19, 16, 15, 36, 15, 36, 21, 28, 25, 21, 30, 20, 31, 12, 27, 16, 24, 42, 0, 93, 14, 56,
    15, 57, 26, 38, -24, 127, -24, 115, -22, 82, -9, 62, 0, 53, 0, 59, -14, 85, -13, 89, -13, 94,
    -11, 92, -29, 127, -21, 100, -14, 57, -12, 67, -11, 71, -10, 77, -21, 85, -16, 88, -23, 104,
    -15, 98, -37, 127, -10, 82, -8, 48, -8, 61, -8, 66, -7, 70, -14, 75, -10, 79, -9, 83, -12, 92,
    -18, 108, -4, 79, -22, 69, -16, 75, -2, 58, 1, 58, -13, 78, -9, 83, -4, 81, -13, 99, -13, 81,
    -6, 38, -13, 62, -6, 58, -2, 59, -16, 73, -10, 76, -13, 86, -9, 83, -10, 87, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 21, 33, 19, 50, 17, 61, -3, 78, -8, 74, -9, 72,
    -10, 72, -18, 75, -12, 71, -11, 63, -5, 70, -17, 75, -14, 72, -16, 67, -8, 53, -14, 59, -9, 52,
    -11, 68, 9, -2, 30, -10, 31, -4, 33, -1, 33, 7, 31, 12, 37, 23, 31, 38, 20, 64, -9, 71, -7, 37,
    -8, 44, -11, 49, -10, 56, -12, 59, -8, 63, -9, 67, -6, 68, -10, 79, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0
]

_INV_CBP_INTRA = {c: i for i, c in enumerate(_CBP_INTRA)}
_INV_CBP_INTER = {c: i for i, c in enumerate(_CBP_INTER)}
_CABAC_INIT = [_CABAC_I, _CABAC_P0, _CABAC_P1, _CABAC_P2]

SKIP, INTER, I4, I8, I16, PCM = range(6)
SLICE_P, SLICE_B, SLICE_I = 0, 1, 2

# B mb_type 1-21 (Table 7-14): shape (0 16x16, 1 16x8, 2 8x16) and each
# partition's prediction (bit 0 list 0, bit 1 list 1); B sub_mb_type (Table
# 7-18): prediction (0 direct), width, height
B_TYPES = [(0, 0, 0), (0, 1, 0), (0, 2, 0), (0, 3, 0), (1, 1, 1), (2, 1, 1), (1, 2, 2), (2, 2, 2),
           (1, 1, 2), (2, 1, 2), (1, 2, 1), (2, 2, 1), (1, 1, 3), (2, 1, 3), (1, 2, 3), (2, 2, 3),
           (1, 3, 1), (2, 3, 1), (1, 3, 2), (2, 3, 2), (1, 3, 3), (2, 3, 3)]
B_SUBS = [(0, 4, 4), (1, 8, 8), (2, 8, 8), (3, 8, 8), (1, 8, 4), (1, 4, 8), (2, 8, 4), (2, 4, 8),
          (3, 8, 4), (3, 4, 8), (1, 4, 4), (2, 4, 4), (3, 4, 4)]

# what the random macroblocks are made of: (skip, inter, intra) weights in P
# slices, the I_PCM share of intra macroblocks, the P_8x8 share of inter ones,
# the probability of a coded 8x8 block, the mean non-zero levels a block, the
# share of large levels, the spread of mvds; in B slices the B_Direct_16x16
# share of inter macroblocks (B_8x8 takes p8x8's) and the direct share of
# B_8x8's sub-macroblocks; slice QPs are drawn from QP_RANGE and a picture
# has 1..MAX_SLICES slices
MIX = dict(mb=(2, 5, 3), pcm=0.08, p8x8=0.3, coded=0.6, levels=3.0, large=0.06, mvd=6,
           b_direct=0.15, b_direct8=0.3)
QP_RANGE = (0, 44)
MAX_SLICES = 3


# ------------------------------------------------------------ bit writers --

class _Writer:
    """An MSB-first bit writer into a bytearray, with Exp-Golomb codes."""

    __slots__ = ("out", "acc", "n")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def u(self, n: int, v: int) -> "_Writer":
        if n:
            self.acc = (self.acc << n) | (v & ((1 << n) - 1))
            self.n += n
            while self.n >= 8:
                self.n -= 8
                self.out.append((self.acc >> self.n) & 0xFF)
            self.acc &= (1 << self.n) - 1
        return self

    def ue(self, v: int) -> "_Writer":
        n = (v + 1).bit_length()
        return self.u(2 * n - 1, v + 1)

    def se(self, v: int) -> "_Writer":
        return self.ue(2 * v - 1 if v > 0 else -2 * v)

    def bits(self) -> List[int]:
        return [b >> (7 - i) & 1 for b in self.out for i in range(8)] + [
            self.acc >> (self.n - 1 - i) & 1 for i in range(self.n)]

    def align(self, bit: int = 0) -> "_Writer":
        while self.n:
            self.u(1, bit)
        return self

    def trailing(self) -> bytes:
        self.u(1, 1).align()
        return bytes(self.out)


class _Cabac:
    """The arithmetic encoder of 9.3.4 over a :class:`_Writer`."""

    __slots__ = ("w", "st", "low", "range", "outstanding", "first")

    def __init__(self, w: _Writer, slice_type: int, cabac_init_idc: int, qp: int):
        self.w = w
        tab = _CABAC_INIT[0 if slice_type == SLICE_I else 1 + cabac_init_idc]
        q = min(max(qp, 0), 51)
        self.st = []
        for i in range(460):
            pre = min(max(((tab[2 * i] * q) >> 4) + tab[2 * i + 1], 1), 126)
            self.st.append((63 - pre) << 1 if pre <= 63 else ((pre - 64) << 1) | 1)
        self.start()

    def start(self) -> None:
        self.low, self.range, self.outstanding, self.first = 0, 510, 0, True

    def _put(self, b: int) -> None:
        if self.first:
            self.first = False
        else:
            self.w.u(1, b)
        if self.outstanding:
            self.w.u(self.outstanding, 0 if b else (1 << self.outstanding) - 1)
            self.outstanding = 0

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def bin(self, ci: int, b: int) -> None:
        s = self.st[ci]
        state, mps = s >> 1, s & 1
        lps = _RANGE_LPS[4 * state + ((self.range >> 6) & 3)]
        self.range -= lps
        if b != mps:
            self.low += self.range
            self.range = lps
            if state == 0:
                mps = 1 - mps
            state = _TRANS_LPS[state]
        elif state < 62:
            state += 1
        self.st[ci] = (state << 1) | mps
        if self.range < 256:
            self._renorm()

    def bypass(self, b: int) -> None:
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def eg(self, v: int, k: int) -> None:
        """k-th order Exp-Golomb suffix in bypass bins."""
        while v >= (1 << k):
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)

    def terminate(self, b: int) -> None:
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.w.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self._renorm()


# ---------------------------------------------------- the macroblock layer --

class _Mb:
    """What later macroblocks' coding reads of a coded one."""

    __slots__ = ("kind", "t8", "cbp", "cmode", "nz", "nzc", "cbf_dc", "ipred", "ref", "mvd",
                 "ref1", "mvd1", "direct8", "direct16")

    def __init__(self):
        self.kind = SKIP
        self.t8 = 0
        self.cbp = 0
        self.cmode = 0
        self.nz = [0] * 16                 # luma 4x4 blocks (raster): TotalCoeff / non-zero count
        self.nzc = [[0] * 4, [0] * 4]      # chroma AC blocks (raster 2x2)
        self.cbf_dc = 0                    # bit 0 luma DC, bits 1-2 chroma DC
        self.ipred = [2] * 16              # intra 4x4 / 8x8 modes (raster)
        self.ref = [-1] * 4                # ref_idx_l0 per 8x8
        self.mvd = [(0, 0)] * 16           # |mvd| per 4x4, for CABAC
        self.ref1 = [-1] * 4               # the same for list 1 (B slices)
        self.mvd1 = [(0, 0)] * 16
        self.direct8 = 0                   # B: the 8x8s in direct mode (bit per raster 8x8)
        self.direct16 = False              # B_Skip or B_Direct_16x16


def level_scales(sl4, sl8) -> Tuple[list, list]:
    """LevelScale4x4 [list][qP % 6][raster] and LevelScale8x8 (8.5.9) of
    scaling lists in zig-zag order."""
    ls4 = [[[0] * 16 for _ in range(6)] for _ in range(6)]
    ls8 = [[[0] * 64 for _ in range(6)] for _ in range(2)]
    for lst in range(6):
        for m in range(6):
            for k in range(16):
                r = ZIGZAG4[k]
                i, j = r >> 2, r & 3
                v = NORM4[m][0 if (i % 2 == 0 and j % 2 == 0) else (1 if (i % 2 and j % 2) else 2)]
                ls4[lst][m][r] = sl4[lst][k] * v
    for lst in range(2):
        for m in range(6):
            for k in range(64):
                r = ZIGZAG8[k]
                i, j = r >> 3, r & 7
                if i % 4 == 0 and j % 4 == 0:
                    c = 0
                elif i % 2 == 1 and j % 2 == 1:
                    c = 1
                elif i % 4 == 2 and j % 4 == 2:
                    c = 2
                elif (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
                    c = 3
                elif (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
                    c = 4
                else:
                    c = 5
                ls8[lst][m][r] = sl8[lst][k] * NORM8[m][c]
    return ls4, ls8


def _deq(level: int, scale: int, qp: int, shift: int) -> int:
    """|dequantised level| (8-336 / 8-337 with shift 4, 8x8's 8-340 with 6)."""
    v = abs(level) * scale
    q6 = qp // 6
    return v << (q6 - shift) if q6 >= shift else (v + (1 << (shift - 1 - q6))) >> (shift - q6)


# An inverse transform's outputs and intermediates are bounded by the sum of
# |d| of the block (4x4: each pass has gains <= 1) or 4x that sum (8x8: <= 2
# a pass); 32 is the final rounding.
_L1_4x4, _L1_8x8 = 32767 - 32, (32767 - 32) // 4


class _SliceCoder:
    """Draws and codes one slice's macroblocks."""

    def __init__(self, job: dict):
        self.j = job
        self.rng = random.Random(job["seed"])
        self.mix = MIX
        self.mbw, self.mbh = job["mbw"], job["mbh"]
        self.cabac_mode = job["cabac"]
        self.islice = job["slice_type"] == SLICE_I
        self.bslice = job["slice_type"] == SLICE_B
        self.n_ref = job["num_ref"]
        self.n_ref1 = job.get("num_ref1", 0)
        self.direct8x8 = job.get("direct8x8", True)
        self.t8mode = job["t8mode"]
        self.cip = job["constrained_intra"]
        self.qp = job["qp"]
        self.qp_lo, self.qp_hi = QP_RANGE
        self.cqp = job["cqp_offset"]
        self.ls4, self.ls8 = job["ls"]
        self.mbs: Dict[int, _Mb] = {}
        self.prev_qpd_nz = False
        self.stats = {"pcm": 0, "t8": 0, "i16": 0, "i4": 0, "i8": 0, "inter": 0, "skip": 0,
                      "p8x8": 0, "levels": 0, "escapes": 0}

    # --------------------------------------------------------- neighbours --
    def nb(self, dx: int, dy: int) -> Optional[_Mb]:
        x, y = self.x + dx, self.y + dy
        if x < 0 or y < 0 or x >= self.mbw:
            return None
        return self.mbs.get(y * self.mbw + x)

    def locate(self, x: int, y: int, maxw: int = 16, maxh: int = 16):
        """The macroblock holding location (x, y) relative to the current one
        (6.4.12), and the location inside it."""
        if y > maxh - 1:
            return None, 0, 0
        if x < 0:
            m = self.nb(-1, -1) if y < 0 else self.nb(-1, 0)
        elif x < maxw:
            m = self.nb(0, -1) if y < 0 else self.cur
        else:
            if y >= 0:
                return None, 0, 0
            m = self.nb(1, -1)
        return m, x % maxw, y % maxh

    def intra_ok(self, m: Optional[_Mb]) -> bool:
        return m is not None and (not self.cip or m.kind >= I4)

    # ------------------------------------------------------------- coding --
    def code(self) -> Tuple[bytes, dict]:
        j = self.j
        self.w = w = _Writer()
        for b in j["head"]:
            w.u(1, b)
        if self.cabac_mode:
            while w.n:
                w.u(1, 1)               # cabac_alignment_one_bit
            self.cab = _Cabac(w, j["slice_type"], j["cabac_init_idc"], self.qp)
        run = 0
        last = j["end_mb"] - 1
        for addr in range(j["first_mb"], j["end_mb"]):
            self.x, self.y = addr % self.mbw, addr // self.mbw
            self.cur = m = _Mb()
            self.mbs[addr] = m
            skip = not self.islice and self.rng.random() < self._p_skip()
            if self.cabac_mode:
                if not self.islice:
                    a, b = self.nb(-1, 0), self.nb(0, -1)
                    inc = (a is not None and a.kind != SKIP) + (b is not None and b.kind != SKIP)
                    self.cab.bin((24 if self.bslice else 11) + inc, int(skip))
                if skip:
                    self.skip()
                else:
                    self.macroblock()
                self.cab.terminate(int(addr == last))
            else:
                if skip:
                    self.skip()
                    run += 1
                    continue
                if not self.islice:
                    w.ue(run)
                    run = 0
                self.macroblock()
        if self.cabac_mode:
            w.align()
            return bytes(w.out), self.stats
        if run:
            w.ue(run)
        return w.trailing(), self.stats

    def _p_skip(self) -> float:
        s, i, n = self.mix["mb"]
        return s / (s + i + n)

    def skip(self) -> None:
        self.cur.kind = SKIP
        self.cur.ref = [0] * 4
        self.prev_qpd_nz = False
        self.stats["skip"] += 1
        if self.bslice:
            self.cur.direct8, self.cur.direct16 = 15, True
            self._count("b_skip")

    def _count(self, key: str) -> None:
        self.stats[key] = self.stats.get(key, 0) + 1

    def macroblock(self) -> None:
        r = self.rng
        s, i, n = self.mix["mb"]
        if not self.islice and r.random() < i / (i + n):
            return self.inter_b() if self.bslice else self.inter()
        if r.random() < self.mix["pcm"]:
            return self.pcm()
        kinds = [I4, I16] + ([I8] if self.t8mode else [])
        self.intra(r.choice(kinds))

    # ----------------------------------------------------------- mb_type --
    def mb_type_intra(self, t: int) -> None:
        """mb_type of an intra macroblock: 0 I_NxN, 1-24 I_16x16, 25 I_PCM."""
        if not self.cabac_mode:
            self.w.ue(t if self.islice else (23 if self.bslice else 5) + t)
            return
        c = self.cab
        if self.islice:
            a, b = self.nb(-1, 0), self.nb(0, -1)
            inc = (a is not None and a.kind not in (I4, I8)) + (b is not None and b.kind not in (I4, I8))
            c.bin(3 + inc, int(t != 0))
            off = (3, 6, 7, 8, 9, 10)
        elif self.bslice:
            self._b_prefix(13)                  # the prefix 1 1 1 1 0 1, then the I suffix
            c.bin(32, int(t != 0))
            off = (32, 33, 34, 34, 35, 35)
        else:
            c.bin(14, 1)
            c.bin(17, int(t != 0))
            off = (17, 18, 19, 19, 20, 20)
        if t == 0:
            return
        c.terminate(int(t == 25))
        if t == 25:
            return
        pred, chroma, luma = (t - 1) % 4, ((t - 1) // 4) % 3, int(t >= 13)
        c.bin(off[1], luma)
        c.bin(off[2], int(chroma != 0))
        if chroma:
            c.bin(off[3], int(chroma == 2))
        c.bin(off[4], pred >> 1)
        c.bin(off[5], pred & 1)

    # --------------------------------------------------------------- PCM --
    def pcm(self) -> None:
        m = self.cur
        m.kind, m.cbp, m.cbf_dc = PCM, 0x2F, 7
        m.nz = [16] * 16
        m.nzc = [[16] * 4, [16] * 4]
        self.prev_qpd_nz = False
        self.mb_type_intra(25)
        self.w.align(0)
        self.w.out += bytes(self.rng.getrandbits(8) for _ in range(384))
        if self.cabac_mode:
            self.cab.start()
        self.stats["pcm"] += 1

    # ------------------------------------------------------------- intra --
    def pred_mode(self, bx: int, by: int) -> int:
        a, xa, ya = self.locate(bx * 4 - 1, by * 4)
        b, xb, yb = self.locate(bx * 4, by * 4 - 1)
        if a is None or b is None:
            return 2
        if self.cip and (a.kind < I4 or b.kind < I4):
            return 2
        ma = a.ipred[(ya >> 2) * 4 + (xa >> 2)] if a.kind in (I4, I8) else 2
        mb = b.ipred[(yb >> 2) * 4 + (xb >> 2)] if b.kind in (I4, I8) else 2
        return min(ma, mb)

    def nxn_modes(self, bx: int, by: int) -> List[int]:
        x, y = bx * 4, by * 4
        left = self.intra_ok(self.locate(x - 1, y)[0])
        top = self.intra_ok(self.locate(x, y - 1)[0])
        tl = self.intra_ok(self.locate(x - 1, y - 1)[0])
        return [2] + ([0, 3, 7] if top else []) + ([1, 8] if left else []) + (
            [4, 5, 6] if top and left and tl else [])

    def intra(self, kind: int) -> None:
        r, m, w = self.rng, self.cur, self.w
        m.kind = kind
        a, b, d = self.nb(-1, 0), self.nb(0, -1), self.nb(-1, -1)
        left, top, tl = self.intra_ok(a), self.intra_ok(b), self.intra_ok(d)
        chroma_modes = [0] + ([1] if left else []) + ([2] if top else []) + (
            [3] if left and top and tl else [])
        cmode = r.choice(chroma_modes)
        if kind == I16:
            i16 = r.choice([2] + ([0] if top else []) + ([1] if left else []) + (
                [3] if left and top and tl else []))
            luma = 15 if r.random() < 0.5 else 0
            chroma = r.randrange(3)
            m.cbp = luma | chroma << 4
            self.mb_type_intra(1 + i16 + 4 * chroma + 12 * (luma == 15))
            self.stats["i16"] += 1
        else:
            self.mb_type_intra(0)
            if self.t8mode:
                m.t8 = int(kind == I8)
                if self.cabac_mode:
                    self.cab.bin(399 + self.t8_inc(), m.t8)
                else:
                    w.u(1, m.t8)
            self.stats["i8" if m.t8 else "i4"] += 1
            for i in range(4 if m.t8 else 16):
                if m.t8:
                    bx, by, size = (i & 1) * 2, (i >> 1) * 2, 2
                else:
                    rr = BLK_RASTER[i]
                    bx, by, size = rr & 3, rr >> 2, 1
                mode = r.choice(self.nxn_modes(bx, by))
                pred = self.pred_mode(bx, by)
                for yy in range(size):
                    for xx in range(size):
                        m.ipred[(by + yy) * 4 + bx + xx] = mode
                if self.cabac_mode:
                    self.cab.bin(68, int(mode == pred))
                    if mode != pred:
                        rem = mode if mode < pred else mode - 1
                        for k in range(3):
                            self.cab.bin(69, (rem >> k) & 1)
                else:
                    w.u(1, int(mode == pred))
                    if mode != pred:
                        w.u(3, mode if mode < pred else mode - 1)
        m.cmode = cmode
        if self.cabac_mode:
            inc = sum(1 for n in (a, b) if n is not None and I4 <= n.kind < PCM and n.cmode)
            self.cab.bin(64 + inc, int(cmode > 0))
            if cmode:
                self.cab.bin(67, int(cmode > 1))
                if cmode > 1:
                    self.cab.bin(67, int(cmode > 2))
        else:
            w.ue(cmode)
        if kind != I16:
            m.cbp = self.draw_cbp()
            self.code_cbp(_INV_CBP_INTRA)
        self.residual(i16=kind == I16)

    # ------------------------------------------------------------- inter --
    def inter(self) -> None:
        r, m, w = self.rng, self.cur, self.w
        m.kind = INTER
        self.stats["inter"] += 1
        if r.random() < self.mix["p8x8"]:
            ptype = 4 if (not self.cabac_mode and self.n_ref > 1 and r.random() < 0.3) else 3
        else:
            ptype = r.randrange(3)
        if self.cabac_mode:
            c = self.cab
            c.bin(14, 0)
            c.bin(15, int(ptype in (1, 2)))
            if ptype in (1, 2):
                c.bin(17, int(ptype == 1))
            else:
                c.bin(16, int(ptype == 3))
        else:
            w.ue(ptype)
        small = False
        if ptype >= 3:
            self.stats["p8x8"] += 1
            subs = [r.randrange(4) for _ in range(4)]
            small = any(subs)
            for s in subs:
                if self.cabac_mode:
                    c = self.cab
                    c.bin(21, int(s == 0))
                    if s:
                        c.bin(22, int(s > 1))
                        if s > 1:
                            c.bin(23, int(s == 2))
                else:
                    w.ue(s)
            for i in range(4):
                ref = r.randrange(self.n_ref) if ptype == 3 else 0
                if self.n_ref > 1 and ptype == 3:
                    self.code_ref(ref, (i & 1) * 8, (i >> 1) * 8)
                m.ref[i] = ref
            sizes = [(8, 8), (8, 4), (4, 8), (4, 4)]
            for i in range(4):
                x0, y0 = (i & 1) * 8, (i >> 1) * 8
                pw, ph = sizes[subs[i]]
                for y in range(0, 8, ph):
                    for x in range(0, 8, pw):
                        self.code_mvd(x0 + x, y0 + y, pw, ph)
        else:
            parts = {0: [(0, 0, 16, 16)], 1: [(0, 0, 16, 8), (0, 8, 16, 8)],
                     2: [(0, 0, 8, 16), (8, 0, 8, 16)]}[ptype]
            for x, y, pw, ph in parts:
                ref = r.randrange(self.n_ref)
                if self.n_ref > 1:
                    self.code_ref(ref, x, y)
                for yy in range(y // 8, (y + ph) // 8):
                    for xx in range(x // 8, (x + pw) // 8):
                        m.ref[yy * 2 + xx] = ref
            for x, y, pw, ph in parts:
                self.code_mvd(x, y, pw, ph)
        m.cbp = self.draw_cbp()
        self.code_cbp(_INV_CBP_INTER)
        if (m.cbp & 15) and self.t8mode and not small:
            m.t8 = int(r.random() < 0.5)
            if self.cabac_mode:
                self.cab.bin(399 + self.t8_inc(), m.t8)
            else:
                w.u(1, m.t8)
        self.residual(i16=False)

    def code_ref(self, ref: int, x: int, y: int, lst: int = 0) -> None:
        n_ref = self.n_ref1 if lst else self.n_ref
        if not self.cabac_mode:
            if n_ref == 2:
                self.w.u(1, 1 - ref)
            else:
                self.w.ue(ref)
            return
        inc = 0
        for n, xn, yn, bit in (self.locate(x - 1, y) + (1,), self.locate(x, y - 1) + (2,)):
            b8 = (yn >> 3) * 2 + (xn >> 3)
            if (n is not None and n.kind == INTER and not (n.direct8 >> b8) & 1
                    and (n.ref1 if lst else n.ref)[b8] > 0):
                inc += bit
        c = self.cab
        c.bin(54 + inc, int(ref > 0))
        for k in range(1, ref + 1):
            c.bin(58 if k == 1 else 59, int(k < ref))

    def code_mvd(self, x: int, y: int, pw: int, ph: int, lst: int = 0) -> None:
        r, m = self.rng, self.cur
        spread = self.mix["mvd"]
        mvd = []
        for _ in range(2):
            v = int(round(r.gauss(0, spread))) if r.random() < 0.9 else r.randint(-80, 80)
            mvd.append(v)
        if self.cabac_mode:
            a, xa, ya = self.locate(x - 1, y)
            b, xb, yb = self.locate(x, y - 1)
            for comp in range(2):
                s = 0
                if a is not None and a.kind == INTER:
                    s += (a.mvd1 if lst else a.mvd)[(ya >> 2) * 4 + (xa >> 2)][comp]
                if b is not None and b.kind == INTER:
                    s += (b.mvd1 if lst else b.mvd)[(yb >> 2) * 4 + (xb >> 2)][comp]
                inc = 0 if s < 3 else (2 if s > 32 else 1)
                base = 47 if comp else 40
                v = mvd[comp]
                av, c = abs(v), self.cab
                c.bin(base + inc, int(av > 0))
                if av:
                    incs = (3, 4, 5, 6, 6, 6, 6, 6)
                    for k in range(1, min(av, 9)):
                        c.bin(base + incs[k - 1], 1)
                    if av < 9:
                        c.bin(base + incs[av - 1], 0)
                    else:
                        c.eg(av - 9, 3)
                    c.bypass(int(v < 0))
        else:
            self.w.se(mvd[0]).se(mvd[1])
        am = (min(abs(mvd[0]), 64), min(abs(mvd[1]), 64))
        store = m.mvd1 if lst else m.mvd
        for yy in range(y >> 2, (y + ph) >> 2):
            for xx in range(x >> 2, (x + pw) >> 2):
                store[yy * 4 + xx] = am

    # ----------------------------------------------------------- B inter --
    def _b_prefix(self, v: int) -> None:
        """The CABAC bins of a B mb_type from 3 on (Table 9-37 (b), as ffmpeg
        reads them): 1 1, then the four bits of ``v``."""
        c, a, b = self.cab, self.nb(-1, 0), self.nb(0, -1)
        c.bin(27 + (a is not None and not a.direct16) + (b is not None and not b.direct16), 1)
        c.bin(30, 1)
        c.bin(31, (v >> 3) & 1)
        for k in (2, 1, 0):
            c.bin(32, (v >> k) & 1)

    def mb_type_b(self, t: int) -> None:
        """mb_type of an inter macroblock of a B slice (0 B_Direct_16x16, 1-21,
        22 B_8x8)."""
        if not self.cabac_mode:
            self.w.ue(t)
            return
        c, a, b = self.cab, self.nb(-1, 0), self.nb(0, -1)
        if t < 3:
            inc = (a is not None and not a.direct16) + (b is not None and not b.direct16)
            c.bin(27 + inc, int(t > 0))
            if t:
                c.bin(30, 0)
                c.bin(32, t - 1)
        elif t <= 10:
            self._b_prefix(t - 3)
        elif t in (11, 22):
            self._b_prefix(14 if t == 11 else 15)
        else:
            self._b_prefix((t + 4) >> 1)
            c.bin(32, (t + 4) & 1)

    def sub_mb_type_b(self, t: int) -> None:
        if not self.cabac_mode:
            self.w.ue(t)
            return
        c = self.cab
        c.bin(36, int(t > 0))
        if not t:
            return
        c.bin(37, int(t > 2))
        if t <= 2:
            c.bin(39, t - 1)
            return
        c.bin(38, int(t >= 7))
        if t >= 7:
            c.bin(39, int(t >= 11))
            if t >= 11:
                c.bin(39, t - 11)
                return
        v = t - (7 if t >= 7 else 3)
        c.bin(39, v >> 1)
        c.bin(39, v & 1)

    def inter_b(self) -> None:
        """An inter macroblock of a B slice: B_Direct_16x16, the 21 partition
        types, or B_8x8 (direct and every sub-partition)."""
        r, m, w, mix = self.rng, self.cur, self.w, self.mix
        m.kind = INTER
        self.stats["inter"] += 1
        u = r.random()
        if u < mix["b_direct"]:
            t = 0
        else:
            t = 22 if u < mix["b_direct"] + mix["p8x8"] else r.randint(1, 21)
        self.mb_type_b(t)
        self._count(f"b_type_{t}")
        small = False
        if t == 0:
            m.direct8, m.direct16 = 15, True
        elif t == 22:
            subs = [0 if r.random() < mix["b_direct8"] else r.randint(1, 12) for _ in range(4)]
            for i, sub in enumerate(subs):
                self.sub_mb_type_b(sub)
                self._count(f"b_sub_{sub}")
                if sub == 0:
                    m.direct8 |= 1 << i
                    small |= not self.direct8x8
                else:
                    small |= B_SUBS[sub][1] < 8 or B_SUBS[sub][2] < 8
            for lst in range(2):
                n_ref = self.n_ref1 if lst else self.n_ref
                for i, sub in enumerate(subs):
                    if (B_SUBS[sub][0] >> lst) & 1:
                        ref = r.randrange(n_ref)
                        if n_ref > 1:
                            self.code_ref(ref, (i & 1) * 8, (i >> 1) * 8, lst)
                        (m.ref1 if lst else m.ref)[i] = ref
                        self._ref_max(ref)
            for lst in range(2):
                for i, sub in enumerate(subs):
                    if (B_SUBS[sub][0] >> lst) & 1:
                        _, pw, ph = B_SUBS[sub]
                        for y in range(0, 8, ph):
                            for x in range(0, 8, pw):
                                self.code_mvd((i & 1) * 8 + x, (i >> 1) * 8 + y, pw, ph, lst)
        else:
            shape, p0, p1 = B_TYPES[t]
            parts = {0: [(0, 0, 16, 16)], 1: [(0, 0, 16, 8), (0, 8, 16, 8)],
                     2: [(0, 0, 8, 16), (8, 0, 8, 16)]}[shape]
            preds = (p0, p1)
            for lst in range(2):
                n_ref = self.n_ref1 if lst else self.n_ref
                for (x, y, pw, ph), pred in zip(parts, preds):
                    if (pred >> lst) & 1:
                        ref = r.randrange(n_ref)
                        if n_ref > 1:
                            self.code_ref(ref, x, y, lst)
                        for yy in range(y // 8, (y + ph) // 8):
                            for xx in range(x // 8, (x + pw) // 8):
                                (m.ref1 if lst else m.ref)[yy * 2 + xx] = ref
                        self._ref_max(ref)
            for lst in range(2):
                for (x, y, pw, ph), pred in zip(parts, preds):
                    if (pred >> lst) & 1:
                        self.code_mvd(x, y, pw, ph, lst)
        m.cbp = self.draw_cbp()
        self.code_cbp(_INV_CBP_INTER)
        if (m.cbp & 15) and self.t8mode and not small and (t != 0 or self.direct8x8):
            m.t8 = int(r.random() < 0.5)
            if self.cabac_mode:
                self.cab.bin(399 + self.t8_inc(), m.t8)
            else:
                w.u(1, m.t8)
        self.residual(i16=False)

    def _ref_max(self, ref: int) -> None:
        self.stats["ref_max"] = max(self.stats.get("ref_max", 0), ref)

    # ---------------------------------------------------------------- cbp --
    def draw_cbp(self) -> int:
        p = self.mix["coded"]
        luma = sum(1 << k for k in range(4) if self.rng.random() < p)
        return luma | self.rng.choice([0, 0, 1, 2] if p < 0.5 else [0, 1, 2]) << 4

    def t8_inc(self) -> int:
        a, b = self.nb(-1, 0), self.nb(0, -1)
        return (a is not None and a.t8) + (b is not None and b.t8)

    def code_cbp(self, inverse: dict) -> None:
        m = self.cur
        if not self.cabac_mode:
            self.w.ue(inverse[m.cbp])
            return
        c = self.cab
        for b8 in range(4):
            bx, by = (b8 & 1) * 8, (b8 >> 1) * 8
            cond = []
            for n, xw, yw in (self.locate(bx - 1, by), self.locate(bx, by - 1)):
                b8n = (yw >> 3) * 2 + (xw >> 3)
                if n is None or n.kind == PCM:
                    cond.append(0)
                elif n is m:
                    cond.append(int(not (m.cbp >> b8n) & 1))
                elif n.kind != SKIP and (n.cbp >> b8n) & 1:
                    cond.append(0)
                else:
                    cond.append(1)
            c.bin(73 + cond[0] + 2 * cond[1], (m.cbp >> b8) & 1)

        def cc(n):
            return 0 if n is None else (2 if n.kind == PCM else (0 if n.kind == SKIP else n.cbp >> 4))
        ca, cb = cc(self.nb(-1, 0)), cc(self.nb(0, -1))
        chroma = m.cbp >> 4
        c.bin(77 + (ca > 0) + 2 * (cb > 0), int(chroma > 0))
        if chroma:
            c.bin(81 + (ca == 2) + 2 * (cb == 2), int(chroma == 2))

    # ----------------------------------------------------------- residual --
    def draw_levels(self, n: int, at_least_one: bool = False) -> List[int]:
        r, mix = self.rng, self.mix
        k = min(n, int(r.expovariate(1.0 / mix["levels"])))
        if at_least_one:
            k = max(k, 1)
        out = [0] * n
        for pos in r.sample(range(n), k):
            if r.random() < mix["large"]:
                v = r.randint(4, 300 if self.qp < 20 else 40)
            else:
                v = r.choice((1, 1, 1, 1, 2, 2, 3))
            out[pos] = -v if r.random() < 0.5 else v
        return out

    def residual(self, i16: bool) -> None:
        m, r = self.cur, self.rng
        cbp_luma, cbp_chroma = m.cbp & 15, m.cbp >> 4
        if not (cbp_luma or cbp_chroma or i16):
            self.prev_qpd_nz = False
            return
        # mb_qp_delta within the stream's QP range
        dq = 0
        if r.random() < 0.3:
            dq = r.randint(max(-26, self.qp_lo - self.qp), min(25, self.qp_hi - self.qp))
        if self.cabac_mode:
            c = self.cab
            mv = 2 * dq - 1 if dq > 0 else -2 * dq
            c.bin(60 + int(self.prev_qpd_nz), int(mv > 0))
            for k in range(1, mv + 1):
                c.bin(62 if k == 1 else 63, int(k < mv))
        else:
            self.w.se(dq)
        self.prev_qpd_nz = dq != 0
        self.qp += dq
        intra = m.kind >= I4
        # draw every block, then scale down until the 16-bit bound holds
        lum = {}       # raster 4x4 (or 8x8 index) -> levels
        dc = None
        if i16:
            dc = self.draw_levels(16)
            if cbp_luma:
                for rr in range(16):
                    lum[rr] = self.draw_levels(15)
        else:
            for b8 in range(4):
                if (cbp_luma >> b8) & 1:
                    if m.t8:
                        # a coded 8x8 block always has a coefficient, as encoders
                        # write it (and CABAC must): ffmpeg's fast deblocking
                        # takes cbp bits 0-2 of an 8x8 macroblock for coefficients
                        lum[b8] = self.draw_levels(64, at_least_one=True)
                    else:
                        for k in range(4):
                            rr = ((b8 >> 1) * 2 + (k >> 1)) * 4 + (b8 & 1) * 2 + (k & 1)
                            lum[rr] = self.draw_levels(16)
        cdc = [self.draw_levels(4) for _ in range(2)] if cbp_chroma else None
        cac = [[self.draw_levels(15) for _ in range(4)] for _ in range(2)] if cbp_chroma == 2 else None
        while not self._fits(i16, intra, dc, lum, cdc, cac):
            for blocks in ([dc] if dc else []) + list(lum.values()) + (cdc or []) + [
                    b for comp in (cac or []) for b in comp]:
                for k, v in enumerate(blocks):
                    if v:
                        h = abs(v) // 2
                        if h == 0 and r.random() < 0.5 and not (m.t8 and sum(map(bool, blocks)) == 1):
                            blocks[k] = 0
                        else:
                            blocks[k] = max(h, 1) * (1 if v > 0 else -1)
        self.stats["levels"] += sum(sum(map(bool, b)) for b in lum.values())
        # code them in the syntax's order
        if i16:
            n = self.block(0, dc, 16, 0, 0, 0)
            m.cbf_dc |= int(n > 0)
            for i in range(16):
                rr = BLK_RASTER[i]
                if cbp_luma:
                    m.nz[rr] = self.block(1, lum[rr], 15, 0, rr & 3, rr >> 2)
        else:
            for b8 in range(4):
                if not (cbp_luma >> b8) & 1:
                    continue
                if m.t8:
                    lev = lum[b8]
                    if self.cabac_mode:
                        n = self.block(5, lev, 64, 0, 0, 0)
                        for k in range(4):
                            m.nz[((b8 >> 1) * 2 + (k >> 1)) * 4 + (b8 & 1) * 2 + (k & 1)] = n
                    else:
                        for k in range(4):
                            bx, by = (b8 & 1) * 2 + (k & 1), (b8 >> 1) * 2 + (k >> 1)
                            m.nz[by * 4 + bx] = self.block(2, lev[k::4], 16, 0, bx, by)
                    self.stats["t8"] += 1
                else:
                    for k in range(4):
                        bx, by = (b8 & 1) * 2 + (k & 1), (b8 >> 1) * 2 + (k >> 1)
                        m.nz[by * 4 + bx] = self.block(2, lum[by * 4 + bx], 16, 0, bx, by)
        if cbp_chroma:
            for comp in range(2):
                n = self.block(3, cdc[comp], 4, comp, 0, 0)
                m.cbf_dc |= int(n > 0) << (1 + comp)
            if cbp_chroma == 2:
                for comp in range(2):
                    for b in range(4):
                        m.nzc[comp][b] = self.block(4, cac[comp][b], 15, comp, b & 1, b >> 1)

    def _fits(self, i16, intra, dc, lum, cdc, cac) -> bool:
        qp, m = self.qp, self.cur
        q6, qm = qp // 6, qp % 6
        if i16:
            c = [0] * 16
            for k, v in enumerate(dc):
                c[ZIGZAG4[k]] = v
            if sum(map(abs, c)) > 32767:
                return False
            s = self.ls4[0][qm][0]
            dcy = []
            for i in range(4):
                for jj in range(4):
                    f = sum(c[a * 4 + b] * _H4[i][a] * _H4[jj][b] for a in range(4) for b in range(4))
                    v = abs(f) * s
                    dcy.append(v << (q6 - 6) if q6 >= 6 else (v + (1 << (5 - q6))) >> (6 - q6))
            for rr in range(16):
                ac = lum.get(rr, ())
                tot = dcy[rr] + sum(_deq(v, self.ls4[0][qm][ZIGZAG4[k + 1]], qp, 4)
                                    for k, v in enumerate(ac) if v)
                if tot > _L1_4x4:
                    return False
        else:
            lst = 0 if intra else 3
            for key, lev in lum.items():
                if m.t8:
                    tot = sum(_deq(v, self.ls8[0 if intra else 1][qm][ZIGZAG8[k]], qp, 6)
                              for k, v in enumerate(lev) if v)
                    if tot > _L1_8x8:
                        return False
                else:
                    tot = sum(_deq(v, self.ls4[lst][qm][ZIGZAG4[k]], qp, 4)
                              for k, v in enumerate(lev) if v)
                    if tot > _L1_4x4:
                        return False
        if cdc is not None:
            for comp in range(2):
                qpc = CHROMA_QP[min(max(qp + self.cqp[comp], 0), 51)]
                lst = (1 if intra else 4) + comp
                c0, c1, c2, c3 = cdc[comp]
                if abs(c0) + abs(c1) + abs(c2) + abs(c3) > 32767:
                    return False
                s = self.ls4[lst][qpc % 6][0]
                fs = [abs(c0 + c1 + c2 + c3), abs(c0 - c1 + c2 - c3), abs(c0 + c1 - c2 - c3),
                      abs(c0 - c1 - c2 + c3)]
                dcc = [((f * s) << (qpc // 6)) >> 5 for f in fs]
                for b in range(4):
                    ac = cac[comp][b] if cac else ()
                    tot = dcc[b] + sum(_deq(v, self.ls4[lst][qpc % 6][ZIGZAG4[k + 1]], qpc, 4)
                                       for k, v in enumerate(ac) if v)
                    if tot > _L1_4x4:
                        return False
        return True

    def block(self, cat: int, lev: List[int], n: int, comp: int, bx: int, by: int) -> int:
        """Code one residual block (cat 0 luma DC, 1 luma AC, 2 luma 4x4, 3
        chroma DC, 4 chroma AC, 5 luma 8x8); returns its non-zero count."""
        if self.cabac_mode:
            return self.cabac_block(cat, lev, n, comp, bx, by)
        if cat == 3:
            nc = -1
        elif cat == 4:
            nc = self.nc(bx, by, 8, lambda mb, xw, yw: mb.nzc[comp][(yw >> 2) * 2 + (xw >> 2)])
        else:
            nc = self.nc(bx, by, 16, lambda mb, xw, yw: mb.nz[(yw >> 2) * 4 + (xw >> 2)])
        return self.cavlc_block(lev, n, nc)

    def nc(self, bx, by, size, get) -> int:
        a, xa, ya = self.locate(bx * 4 - 1, by * 4, size, size)
        b, xb, yb = self.locate(bx * 4, by * 4 - 1, size, size)
        na = get(a, xa, ya) if a is not None else 0
        nb = get(b, xb, yb) if b is not None else 0
        if a is not None and b is not None:
            return (na + nb + 1) >> 1
        return na if a is not None else (nb if b is not None else 0)

    def cavlc_block(self, lev: List[int], n: int, nc: int) -> int:
        w = self.w
        nzp = [i for i, v in enumerate(lev) if v]
        total = len(nzp)
        rev = [lev[i] for i in reversed(nzp)]       # highest frequency first
        t1s = 0
        while t1s < min(3, total) and abs(rev[t1s]) == 1:
            t1s += 1
        if nc == -1:
            k = total * 4 + t1s
            w.u(_CDC_TOKEN_LEN[k], _CDC_TOKEN_CODE[k])
        else:
            t = 0 if nc < 2 else (1 if nc < 4 else (2 if nc < 8 else 3))
            k = t * 68 + total * 4 + t1s
            w.u(_TOKEN_LEN[k], _TOKEN_CODE[k])
        if total == 0:
            return 0
        sl = 1 if total > 10 and t1s < 3 else 0
        for i, v in enumerate(rev):
            if i < t1s:
                w.u(1, int(v < 0))
                continue
            code = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == t1s and t1s < 3:
                code -= 2
            if sl == 0:
                if code < 14:
                    w.u(code + 1, 1)
                elif code < 30:
                    w.u(15, 1).u(4, code - 14)
                else:
                    assert code - 30 < 4096, code
                    w.u(16, 1).u(12, code - 30)
                    self.stats["escapes"] += 1
            else:
                if code < (15 << sl):
                    w.u((code >> sl) + 1, 1).u(sl, code & ((1 << sl) - 1))
                else:
                    assert code - (15 << sl) < 4096, code
                    w.u(16, 1).u(12, code - (15 << sl))
                    self.stats["escapes"] += 1
            if sl == 0:
                sl = 1
            if abs(v) > (3 << (sl - 1)) and sl < 6:
                sl += 1
        if total < n:
            zeros = nzp[-1] + 1 - total
            if n == 4:
                w.u(_CDC_TZ_LEN[total - 1][zeros], _CDC_TZ_CODE[total - 1][zeros])
            else:
                w.u(_TZ_LEN[total - 1][zeros], _TZ_CODE[total - 1][zeros])
        else:
            zeros = 0
        pos = list(reversed(nzp))
        for i in range(total - 1):
            if zeros <= 0:
                break
            run = pos[i] - pos[i + 1] - 1
            t = min(zeros, 7) - 1
            w.u(_RUN_LEN[t][run], _RUN_CODE[t][run])
            zeros -= run
        return total

    def cbf_inc(self, cat: int, comp: int, bx: int, by: int) -> int:
        m = self.cur
        cond = []
        for k in range(2):
            if cat in (0, 3):
                n, xw, yw = (self.nb(-1, 0), 0, 0) if k == 0 else (self.nb(0, -1), 0, 0)
            elif cat == 4:
                n, xw, yw = (self.locate(bx * 4 - 1, by * 4, 8, 8) if k == 0
                             else self.locate(bx * 4, by * 4 - 1, 8, 8))
            else:
                n, xw, yw = (self.locate(bx * 4 - 1, by * 4) if k == 0
                             else self.locate(bx * 4, by * 4 - 1))
            if n is None:
                cond.append(int(m.kind >= I4))
            elif n.kind == PCM:
                cond.append(1)
            elif n.kind == SKIP:
                cond.append(0)
            elif cat == 0:
                cond.append(n.cbf_dc & 1 if n.kind == I16 else 0)
            elif cat in (1, 2):
                b8 = (yw >> 3) * 2 + (xw >> 3)
                cond.append(int(n.nz[(yw >> 2) * 4 + (xw >> 2)] != 0) if (n.cbp >> b8) & 1 else 0)
            elif cat == 3:
                cond.append((n.cbf_dc >> (1 + comp)) & 1 if n.cbp >> 4 else 0)
            else:
                cond.append(int(n.nzc[comp][(yw >> 2) * 2 + (xw >> 2)] != 0) if n.cbp >> 4 == 2 else 0)
        return cond[0] + 2 * cond[1]

    def cabac_block(self, cat, lev, n, comp, bx, by) -> int:
        c = self.cab
        nzp = [i for i, v in enumerate(lev) if v]
        if cat != 5:
            c.bin(85 + (0, 4, 8, 12, 16)[cat] + self.cbf_inc(cat, comp, bx, by), int(bool(nzp)))
            if not nzp:
                return 0
        sig_base = 402 if cat == 5 else 105 + (0, 15, 29, 44, 47)[cat]
        last_base = 417 if cat == 5 else 166 + (0, 15, 29, 44, 47)[cat]
        abs_base = 426 if cat == 5 else 227 + (0, 10, 20, 30, 39)[cat]
        last = nzp[-1]
        for i in range(n - 1):
            s = int(lev[i] != 0)
            si = _SIG8[i] if cat == 5 else (min(i, 2) if cat == 3 else i)
            c.bin(sig_base + si, s)
            if s:
                li = _LAST8[i] if cat == 5 else (min(i, 2) if cat == 3 else i)
                c.bin(last_base + li, int(i == last))
                if i == last:
                    break
        gt1 = eq1 = 0
        for i in reversed(nzp):
            v = abs(lev[i]) - 1
            c.bin(abs_base + (0 if gt1 else min(4, 1 + eq1)), int(v > 0))
            if v > 0:
                inc2 = abs_base + 5 + min(4 - (cat == 3), gt1)
                for k in range(1, min(v, 14)):
                    c.bin(inc2, 1)
                if v < 14:
                    c.bin(inc2, 0)
                else:
                    c.eg(v - 14, 0)
                    self.stats["escapes"] += 1
                gt1 += 1
            else:
                eq1 += 1
            c.bypass(int(lev[i] < 0))
        return len(nzp)


_H4 = [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]]


def _code_slice(job: dict) -> Tuple[bytes, dict]:
    return _SliceCoder(job).code()


# ----------------------------------------------------- parameter sets -----

def _scaling_list(b: _Bits, values: Optional[List[int]]) -> None:
    """scaling_list( ) of ``values`` (zig-zag order); None codes
    useDefaultScalingMatrixFlag. A tail that repeats the last value is cut
    with a delta to 0."""
    if values is None:
        b.se(-8)
        return
    last = 8
    n = len(values)
    cut = n
    while cut > 1 and values[cut - 1] == values[cut - 2]:
        cut -= 1
    for j in range(n):
        if j == cut and cut < n:
            b.se(((0 - last + 128) % 256) - 128)
            return
        b.se(((values[j] - last + 128) % 256) - 128)
        last = values[j]


def _draw_lists(rng: random.Random, n8: int):
    """Random scaling lists for an SPS or PPS: (present flags, lists), a list
    None meaning "use the default"."""
    present, lists = [], []
    for i in range(6 + n8):
        p = rng.random() < 0.6
        present.append(p)
        size = 16 if i < 6 else 64
        if not p:
            lists.append(None)
        elif rng.random() < 0.2:
            lists.append(None)
        else:
            base = rng.randint(6, 24)
            vals = [min(48, max(4, base + (k * rng.randint(0, 3)) // (2 if size == 16 else 8)
                                + rng.randint(-2, 2))) for k in range(size)]
            if rng.random() < 0.5:       # a repeated tail, cut short
                t = rng.randint(size // 2, size - 1)
                vals[t:] = [vals[t]] * (size - t)
            lists.append(vals)
    return present, lists


def _effective(sps_lists, pps_lists, t8mode: bool):
    """The scaling lists in force (7.4.2.1.1 and 7.4.2.2, rules A and B);
    arguments are (present, lists) or None when the set carries no matrix."""
    flat4, flat8 = [16] * 16, [16] * 64

    def resolve(pl, fallback):
        out = []
        present, lists = pl
        for i in range(8):
            deflt = (DEFAULT_4[0 if i < 3 else 1] if i < 6 else DEFAULT_8[i - 6])
            if i < len(present) and present[i]:
                out.append(lists[i] if lists[i] is not None else list(deflt))
            elif fallback is None and i in (0, 3, 6, 7):
                out.append(list(deflt))
            elif fallback is not None and i in (0, 3, 6, 7):
                out.append(fallback[i])
            else:
                out.append(out[i - 1] if i < 6 else list(deflt))
        return out

    seq = resolve(sps_lists, None) if sps_lists else [flat4] * 6 + [flat8] * 2
    if not pps_lists:
        return seq[:6], seq[6:]
    pic = resolve(pps_lists, seq if sps_lists else None)
    if not t8mode:
        pic[6:] = seq[6:]
    return pic[:6], pic[6:]


def _sps(sp: dict, refuse: Optional[str] = None) -> bytes:
    b = _Bits().u(8, 100).u(8, 0).u(8, 40).ue(sp["id"])
    b.ue(2 if refuse == "422" else 1)
    depth = 2 if refuse == "10bit" else 0
    b.ue(depth).ue(depth).u(1, 0)
    b.u(1, int(sp["lists"] is not None))
    if sp["lists"] is not None:
        present, lists = sp["lists"]
        for p, values in zip(present, lists):
            b.u(1, int(p))
            if p:
                _scaling_list(b, values)
    b.ue(sp["log2_mfn"] - 4).ue(sp["poc_type"])
    if sp["poc_type"] == 0:
        b.ue(sp["log2_poc"] - 4)
    elif sp["poc_type"] == 1 and sp.get("poc1"):
        # delta_pic_order_cnt[0] in every slice header, the drawn cycle
        poc1 = sp["poc1"]
        b.u(1, 0).se(poc1["non_ref"]).se(0).ue(len(poc1["cycle"]))
        for v in poc1["cycle"]:
            b.se(v)
    elif sp["poc_type"] == 1:
        # one reference frame a cycle, 2 apart; a non-reference frame 1 after
        b.u(1, 1).se(1).se(0).ue(1).se(2)
    b.ue(sp["max_refs"]).u(1, 0).ue(sp["mbw"] - 1)
    if refuse == "fields":
        b.ue(sp["mbh"] // 2 - 1).u(1, 0).u(1, 1)
    else:
        b.ue(sp["mbh"] - 1).u(1, 1)
    b.u(1, int(sp.get("direct8x8", True)))     # direct_8x8_inference_flag
    crop = sp["crop"]
    b.u(1, int(any(crop)))
    if any(crop):
        for v in crop:
            b.ue(v)
    vui, restrict = sp.get("vui"), sp.get("restrict")
    b.u(1, int(vui is not None or restrict is not None))
    if vui is not None or restrict is not None:
        b.u(1, 0).u(1, 0).u(1, int(vui is not None))
        if vui is not None:
            b.u(3, 5).u(1, int(vui["full_range"])).u(1, 1)
            b.u(8, 1).u(8, 1).u(8, vui["matrix"])
        b.u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, 0).u(1, int(restrict is not None))
        if restrict is not None:
            # motion vectors over picture boundaries; no byte or bit limits;
            # log2 of the longest mvs; max_num_reorder_frames,
            # max_dec_frame_buffering, as libx264 writes them
            b.u(1, 1).ue(0).ue(0).ue(11).ue(11).ue(restrict[0]).ue(restrict[1])
    return nal_unit(0x67, b.trailing().tobytes())


def _pps(pp: dict, refuse: Optional[str] = None) -> bytes:
    b = _Bits().ue(pp["id"]).ue(pp["sps_id"]).u(1, int(pp["cabac"])).u(1, 0)
    if refuse == "fmo":
        b.ue(1).ue(0).ue(0).ue(0)               # two slice groups, interleaved runs
    else:
        b.ue(0)
    b.ue(pp["num_ref_default"] - 1).ue(pp.get("num_ref_default1", 1) - 1)
    b.u(1, int(pp["weighted"])).u(2, pp.get("bipred", 0))
    b.se(pp["init_qp"] - 26).se(0).se(pp["cqp"][0]).u(1, 1).u(1, int(pp["cip"])).u(1, 0)
    if pp["high"]:
        b.u(1, int(pp["t8mode"])).u(1, int(pp["lists"] is not None))
        if pp["lists"] is not None:
            present, lists = pp["lists"]
            for i in range(6 + 2 * pp["t8mode"]):
                b.u(1, int(present[i]))
                if present[i]:
                    _scaling_list(b, lists[i])
        b.se(pp["cqp"][1])
    return nal_unit(0x68, b.trailing().tobytes())


# ------------------------------------------------------------- the stream --

def _pic_num(fn: int, cur_fn: int, max_fn: int) -> int:
    return fn - max_fn if fn > cur_fn else fn


def _marking(rng: random.Random, refs: list, max_lt: int, cur_fn: int, max_fn: int,
             max_refs: int, p_adaptive: float, b_stream: bool = False):
    """dec_ref_pic_marking( ) of a non-IDR reference picture drawn against
    the DPB model: (adaptive ops or None, refs after, MaxLongTermFrameIdx
    after, the current picture's entry). ``b_stream`` draws no MMCO 5
    (ffmpeg keeps such a picture's order count from before the reset, which
    B slices read) and keeps at most one long-term reference (ffmpeg's
    deblocking tells two long-term pictures apart only while their
    LongTermFrameIdx lie below their number)."""
    refs = [dict(r) for r in refs]
    cur = {"fn": cur_fn, "long": False, "lt": 0}
    shorts = [r for r in refs if not r["long"]]
    full = len(refs) >= max(max_refs, 1)
    if not (rng.random() < p_adaptive or (full and not shorts)):
        if full:
            oldest = min(shorts, key=lambda r: _pic_num(r["fn"], cur_fn, max_fn))
            refs.remove(oldest)
        return None, refs + [cur], max_lt, cur
    ops = []
    if rng.random() < 0.05 and not b_stream:
        ops.append((5,))
        refs, max_lt = [], -1
    else:
        # MMCO 6 (the current picture to long-term) comes last, so that no
        # later command unmarks it
        for _ in range(rng.randint(1, 3)):
            shorts = [r for r in refs if not r["long"]]
            longs = [r for r in refs if r["long"]]
            choice = rng.choice([1, 2, 3, 4, 6])
            if cur["long"]:
                break
            if choice == 1 and shorts:
                r = rng.choice(shorts)
                ops.append((1, cur_fn - _pic_num(r["fn"], cur_fn, max_fn) - 1))
                refs.remove(r)
            elif choice == 2 and longs:
                r = rng.choice(longs)
                ops.append((2, r["lt"]))
                refs.remove(r)
            elif choice == 4:
                new = rng.randint(-1, 3)
                ops.append((4, new + 1))
                max_lt = new
                refs = [r for r in refs if not (r["long"] and r["lt"] > new)]
            elif choice == 3 and shorts and max_lt >= 0 and not (b_stream and longs):
                r = rng.choice(shorts)
                idx = rng.randint(0, max_lt)
                ops.append((3, cur_fn - _pic_num(r["fn"], cur_fn, max_fn) - 1, idx))
                refs = [x for x in refs if not (x["long"] and x["lt"] == idx)]
                r["long"], r["lt"] = True, idx
            elif choice == 6 and max_lt >= 0 and not cur["long"] and not (b_stream and longs):
                idx = rng.randint(0, max_lt)
                ops.append((6, idx))
                refs = [x for x in refs if not (x["long"] and x["lt"] == idx)]
                cur["long"], cur["lt"] = True, idx
    while len(refs) + 1 > max(max_refs, 1):   # keep within max_num_ref_frames
        shorts = [r for r in refs if not r["long"]]
        if shorts:
            r = shorts[0]
            ops.append((1, cur_fn - _pic_num(r["fn"], cur_fn, max_fn) - 1))
        else:
            r = refs[0]
            ops.append((2, r["lt"]))
        refs.remove(r)
    if ops and ops[0][0] == 5:
        cur["fn"] = 0
    return ops, refs + [cur], max_lt, cur


def _header(sp: dict, pp: dict, s: dict) -> List[int]:
    """slice_header( ) as bits."""
    w = _Writer()
    w.ue(s["first_mb"]).ue(s["slice_type"]).ue(pp["id"]).u(sp["log2_mfn"], s["frame_num"])
    if s["idr"]:
        w.ue(s["idr_pic_id"])
    if sp["poc_type"] == 0:
        w.u(sp["log2_poc"], s["poc_lsb"])
    elif sp["poc_type"] == 1 and sp.get("poc1"):
        w.se(s["delta_poc"])
    bslice = s["slice_type"] == SLICE_B
    if bslice:
        w.u(1, int(s["direct_spatial"]))
    if s["slice_type"] in (SLICE_P, SLICE_B):
        override = s["num_ref"] != pp["num_ref_default"] or (
            bslice and s["num_ref1"] != pp.get("num_ref_default1", 1))
        w.u(1, int(override))
        if override:
            w.ue(s["num_ref"] - 1)
            if bslice:
                w.ue(s["num_ref1"] - 1)
        for mods in [s["mods"]] + ([s["mods1"]] if bslice else []):
            w.u(1, int(bool(mods)))
            if mods:
                for idc, v in mods:
                    w.ue(idc).ue(v)
                w.ue(3)
        if (pp["weighted"] and not bslice) or (bslice and pp.get("bipred") == 1):
            w.ue(s["luma_wd"]).ue(s["chroma_wd"])
            for weights in [s["weights"]] + ([s["weights1"]] if bslice else []):
                for lw, cw in weights:
                    w.u(1, int(lw is not None))
                    if lw is not None:
                        w.se(lw[0]).se(lw[1])
                    w.u(1, int(cw is not None))
                    if cw is not None:
                        for v in cw:
                            w.se(v)
    if s["nal_ref_idc"]:
        if s["idr"]:
            w.u(1, 0).u(1, int(s["ltrf"]))
        else:
            w.u(1, int(s["ops"] is not None))
            if s["ops"] is not None:
                for op in s["ops"]:
                    w.ue(op[0])
                    for v in op[1:]:
                        w.ue(v)
                w.ue(0)
    if pp["cabac"] and s["slice_type"] != SLICE_I:
        w.ue(s["cabac_init_idc"])
    w.se(s["qp"] - pp["init_qp"])
    w.ue(s["deblock"][0])
    if s["deblock"][0] != 1:
        w.se(s["deblock"][1]).se(s["deblock"][2])
    return w.bits()


def _b_plan(rng: random.Random, n: int, poc_type: int) -> List[Tuple[str, int]]:
    """The pictures of a B stream in decode order: (kind, display index).
    Kinds: "idr", "i", "p", "p_nonref" (anchors), "b" (a reference B
    picture), "b_nonref". With POC type 2 output order is decode order
    (low-delay B pictures: both lists from the past); otherwise groups of
    0-3 B pictures sit between anchors, each group decoded after the anchor
    that follows it, a pyramid's middle reference B picture first. A group
    never precedes an IDR picture (a closed GOP)."""
    plan = [("idr", 0)]
    if poc_type == 2:
        prev_nonref = False
        for d in range(1, n):
            u = rng.random()
            if u < 0.06:
                kind = "idr"
            elif u < 0.14:
                kind = "i"
            elif u < 0.6:
                kind = "b_nonref" if not prev_nonref and rng.random() < 0.4 else "b"
            elif u < 0.75 and not prev_nonref:
                kind = "p_nonref"
            else:
                kind = "p"
            prev_nonref = kind.endswith("nonref")
            plan.append((kind, d))
        return plan
    d = 0
    while d < n - 1:
        u = rng.random()
        if u < 0.06:
            plan.append(("idr", d + 1))
            d += 1
            continue
        g = min(rng.choice([0, 1, 2, 2, 3, 3]), n - 2 - d)
        kind = "i" if u < 0.18 else "p"
        if g == 0 and kind == "p" and rng.random() < 0.25:
            kind = "p_nonref"
        plan.append((kind, d + g + 1))
        group = list(range(d + 1, d + g + 1))
        if len(group) >= 2 and rng.random() < 0.6:
            mid = group[(len(group) - 1) // 2]
            plan.append(("b", mid))
            plan += [("b" if rng.random() < 0.15 else "b_nonref", x) for x in group if x != mid]
        else:
            plan += [("b" if rng.random() < 0.25 else "b_nonref", x) for x in group]
        d += g + 1
    return plan


def _ref_lists(refs: list, frame_num: int, poc: int, max_fn: int, bslice: bool, nums, mods):
    """RefPicList0 and RefPicList1 (8.2.4) of the DPB model ``refs`` as
    lists of reference entries (None where a list has no picture): the
    initial lists (P by PicNum, B by order count, the swap of 8.2.4.2.3),
    then ``mods``."""
    st = [r for r in refs if not r["long"]]
    lt = sorted((r for r in refs if r["long"]), key=lambda r: r["lt"])
    if not bslice:
        init = [sorted(st, key=lambda r: -_pic_num(r["fn"], frame_num, max_fn)) + lt]
    else:
        past = sorted((r for r in st if r["poc"] < poc), key=lambda r: -r["poc"])
        future = sorted((r for r in st if r["poc"] > poc), key=lambda r: r["poc"])
        init = [past + future + lt, future + past + lt]
        if len(init[1]) > 1 and [r["id"] for r in init[1]] == [r["id"] for r in init[0]]:
            init[1][0], init[1][1] = init[1][1], init[1][0]
    out = []
    for lst, n, mod in zip(init, nums, mods):
        lst = (lst[:n] + [None] * (n + 1))[:n + 1]
        pred, idx = frame_num, 0
        for idc, v in mod:
            if idc == 2:
                pic = next(r for r in refs if r["long"] and r["lt"] == v)
            else:
                pred = (pred - (v + 1) if idc == 0 else pred + (v + 1)) % max_fn
                num = pred - max_fn if pred > frame_num else pred
                pic = next(r for r in refs if not r["long"] and _pic_num(r["fn"], frame_num,
                                                                          max_fn) == num)
            lst = lst[:idx] + [pic] + [r for r in lst[idx:] if r is None or r["id"] != pic["id"]]
            lst = (lst + [None])[:n + 1]
            idx += 1
        out.append(lst[:n])
    return out


def _draw_mods(rng: random.Random, refs: list, frame_num: int, max_fn: int, n: int) -> list:
    """ref_pic_list_modification( ) naming 1..n pictures of ``refs``."""
    mods, pred = [], frame_num
    for _ in range(rng.randint(1, n)):
        r = rng.choice(refs)
        if r["long"]:
            mods.append((2, r["lt"]))
            continue
        p = _pic_num(r["fn"], frame_num, max_fn)
        nowrap = p if p >= 0 else p + max_fn
        idc = rng.randrange(2)
        d = ((pred - nowrap) if idc == 0 else (nowrap - pred)) % max_fn or max_fn
        mods.append((idc, d - 1))
        pred = nowrap
    return mods


def _poc1_expected(fn_offset: int, frame_num: int, is_ref: bool, poc1: dict) -> int:
    """expectedPicOrderCnt of POC type 1 (8-6 to 8-10) for frames."""
    cycle = poc1["cycle"]
    abs_fn = fn_offset + frame_num if cycle else 0
    if not is_ref and abs_fn > 0:
        abs_fn -= 1
    expected = 0
    if abs_fn > 0:
        count, in_cycle = divmod(abs_fn - 1, len(cycle))
        expected = count * sum(cycle) + sum(cycle[:in_cycle + 1])
    return expected + (0 if is_ref else poc1["non_ref"])


def _b_pictures(rng, sp, pps_list, scales, plan, cabac, mbw, mbh, stats, spatial):
    """The slices of a B stream's pictures (``plan``, decode order) against
    the DPB model, as :func:`write_h264_syntax_mp4`'s jobs and pictures.
    All P or B slices of a picture share its reference lists, and its first
    slice is one of them (ffmpeg, with frame threads, maps a co-located
    picture's references, and the current picture's, through the first
    slice's lists); a slice codes temporal direct prediction where
    ``spatial`` is False and every picture the co-located picture refers to
    sits in its list 0 ahead of any other picture of the same frame_num
    (ffmpeg's identity), else spatial."""
    n_mbs = mbw * mbh
    qp_lo, qp_hi = QP_RANGE
    max_fn = 1 << sp["log2_mfn"]
    max_lsb = 1 << sp["log2_poc"]
    refs, max_lt, prev_ref_fn, idr_id = [], -1, 0, 0
    prev_ref_poc, prev_fno, prev_fn, epoch = 0, 0, 0, 0
    pics: Dict[int, dict] = {}
    jobs, pictures = [], []
    for idx, (kind, disp) in enumerate(plan):
        idr = kind == "idr"
        is_ref = not kind.endswith("nonref")
        nal_ref_idc = rng.randint(1, 3) if is_ref else 0
        if idr:
            frame_num, idr_id, epoch = 0, (idr_id + 1) % 65536, disp
        else:
            frame_num = (prev_ref_fn + 1) % max_fn
        ops = None
        if is_ref and not idr:
            ops, new_refs, new_max_lt, cur = _marking(rng, refs, max_lt, frame_num, max_fn,
                                                     sp["max_refs"], 0.35, b_stream=True)
        reset = bool(ops) and ops[0][0] == 5
        # the order count, and the syntax that gives it
        fno = 0 if idr else prev_fno + (max_fn if prev_fn > frame_num else 0)
        delta_poc = 0
        if sp["poc_type"] == 2:
            poc = 0 if idr else 2 * (fno + frame_num) - (0 if is_ref else 1)
        else:
            poc = 2 * (disp - epoch)
            if sp["poc_type"] == 1:
                delta_poc = poc - _poc1_expected(fno, frame_num, is_ref, sp["poc1"])
            elif abs(poc - (0 if idr else prev_ref_poc)) >= max_lsb // 2:
                raise RuntimeError(f"POC {poc} lies too far from the previous reference's")
        pic = dict(id=idx, fn=0 if reset else frame_num, poc=0 if reset else poc, uses=set())
        pics[idx] = pic
        cls = SLICE_B if kind.startswith("b") else (SLICE_P if kind.startswith("p") else SLICE_I)
        pp = pps_list[rng.randrange(2)]
        ltrf = idr and rng.random() < 0.3
        n_sl = rng.randint(1, min(MAX_SLICES, n_mbs))
        cuts = sorted(rng.sample(range(1, n_mbs), n_sl - 1)) if n_sl > 1 else []
        bounds = [0] + cuts + [n_mbs]
        stats["slices_max"] = max(stats["slices_max"], n_sl)
        # the picture's lists, shared by its P or B slices
        nums, mods, lists, direct_spatial = [1, 0], [[], []], [[], []], True
        if cls != SLICE_I:
            bs = cls == SLICE_B
            most = min(4, len(refs))
            nums = [rng.randint(1, most), rng.randint(1, most) if bs else 0]
            if bs and not spatial and rng.random() < 0.5:
                nums[0] = min(4, len(refs))           # room for the co-located's references
            for lst in range(2 if bs else 1):
                if rng.random() < 0.4:
                    mods[lst] = _draw_mods(rng, refs, frame_num, max_fn, nums[lst])
                    stats["mods_l1" if lst else "mods"] += 1
            lists = _ref_lists(refs, frame_num, poc, max_fn, bs, nums[:2 if bs else 1], mods)
            if bs:
                col = pics[lists[1][0]["id"]]
                l0 = [r for r in lists[0] if r is not None]
                direct_spatial = spatial or not all(
                    next((r["id"] for r in l0 if r["fn"] == pics[u]["fn"]), None) == u
                    for u in col["uses"])
                if any(r is not None and r["long"] for r in lists[1]):
                    stats["long_term_l1"] += 1
        pic_jobs, any_inter = [], False
        for si in range(n_sl):
            # the first slice of a P or B picture is one: ffmpeg takes a
            # picture's lists for direct prediction from its first slice
            st = cls if (cls != SLICE_I and (si == 0 or rng.random() < 0.85)) else SLICE_I
            s = dict(first_mb=bounds[si], slice_type=st, frame_num=frame_num, idr=idr,
                     idr_pic_id=idr_id, poc_lsb=poc % max_lsb, delta_poc=delta_poc,
                     nal_ref_idc=nal_ref_idc, ltrf=ltrf, ops=ops, mods=mods[0], mods1=mods[1],
                     weights=[], weights1=[], direct_spatial=direct_spatial,
                     qp=rng.randint(qp_lo, qp_hi), cabac_init_idc=rng.randrange(3),
                     deblock=(rng.choice([0, 0, 1, 2]), rng.randint(-6, 6), rng.randint(-6, 6)),
                     num_ref=nums[0], num_ref1=nums[1])
            if st != SLICE_I:
                any_inter = True
                if (st == SLICE_P and pp["weighted"]) or (st == SLICE_B and pp["bipred"] == 1):
                    # B: |weights| <= 64 keeps w0 + w1 within [-128, 128] (7.4.3.2)
                    top = 64 if st == SLICE_B else 127
                    s["luma_wd"] = rng.randint(0, 6 if st == SLICE_B else 7)
                    s["chroma_wd"] = rng.randint(0, 6 if st == SLICE_B else 7)
                    n1 = nums[1] if st == SLICE_B else 0
                    for key, n in (("weights", nums[0]), ("weights1", n1)):
                        for _ in range(n):
                            lw = ((max(-top, min(top, (1 << s["luma_wd"]) + rng.randint(-40, 40))),
                                   rng.randint(-20, 20)) if rng.random() < 0.6 else None)
                            cw = ([v for _ in range(2) for v in (
                                max(-top, min(top, (1 << s["chroma_wd"]) + rng.randint(-40, 40))),
                                rng.randint(-20, 20))] if rng.random() < 0.5 else None)
                            s[key].append((lw, cw))
                    stats["weighted_b" if st == SLICE_B else "weighted_p"] += 1
                if st == SLICE_B:
                    stats["b_slices"] += 1
                    stats["bipred"].add(pp["bipred"])
                    stats["temporal" if not direct_spatial else "spatial"] += 1
                    if disp < max(d for _, d in plan[:idx + 1]):
                        stats["reordered_b"] += 1
                elif nums[0] >= 2:
                    stats["p_slices_2refs"] += 1
            if s["deblock"][0] != 1 and (s["deblock"][1] or s["deblock"][2]):
                stats["deblock"].add(s["deblock"][0])
            job = dict(head=_header(sp, pp, s), slice_type=st, first_mb=bounds[si],
                       end_mb=bounds[si + 1], mbw=mbw, mbh=mbh, cabac=cabac,
                       cabac_init_idc=s["cabac_init_idc"], qp=s["qp"],
                       num_ref=nums[0], num_ref1=nums[1], direct8x8=sp["direct8x8"],
                       t8mode=pp["t8mode"], constrained_intra=pp["cip"],
                       cqp_offset=pp["cqp"], ls=scales[pp["id"]],
                       seed=rng.getrandbits(64), nal=(nal_ref_idc << 5) | (5 if idr else 1),
                       matrix=pp["lists"] is not None or sp["lists"] is not None)
            pic_jobs.append(job)
        if any_inter:
            pic["uses"] = {r["id"] for lst in lists for r in lst if r is not None}
        jobs += pic_jobs
        pictures.append((len(pic_jobs), idr, rng.random() < 0.2))
        stats["frames"].append(kind)
        stats["pictures"].append(dict(kind=kind, display=disp, poc=pic["poc"], mods=any(mods)))
        # the model after this picture
        if is_ref:
            if idr:
                refs = [{"fn": 0, "long": ltrf, "lt": 0, "poc": 0, "id": idx}]
                max_lt = 0 if ltrf else -1
            else:
                cur.update(poc=pic["poc"], id=idx)
                refs, max_lt = new_refs, new_max_lt
                for op in ops or ():
                    stats["mmco"].add(op[0])
            prev_ref_fn = pic["fn"]
            prev_ref_poc = pic["poc"]
            stats["long_term"] += sum(r["long"] for r in refs)
        if reset:
            epoch = disp
        prev_fno, prev_fn = (0, 0) if reset else (fno, frame_num)
    return jobs, pictures


def write_h264_syntax_mp4(path, width: int, height: int, n_frames: int, seed: int,
                          entropy: str = "cavlc", full_range: Optional[bool] = None,
                          matrix: int = 1, workers: int = 1, b_frames: bool = False) -> dict:
    """Write an mp4 of ``n_frames`` H.264 pictures of seeded random syntax
    (module docstring; macroblock statistics :data:`MIX`) at ``width`` x
    ``height`` (even; cropped from whole macroblocks), High profile,
    ``entropy`` "cavlc" or "cabac"; ``full_range`` adds a VUI with that
    video_full_range_flag and ``matrix`` as matrix_coefficients (1 BT.709,
    6 BT.601). Sync samples are the IDR pictures. ``b_frames`` adds B
    pictures (:func:`_b_plan`, :func:`_b_pictures`) with the container's
    composition offsets, edit list and the VUI's reorder depth; without it
    the file is what it always was. ``workers`` > 1 codes the slices in a
    spawned process pool (the calling script needs its ``if __name__ ==
    "__main__"`` guard). Returns counts of the tools the stream uses."""
    if width % 2 or height % 2 or entropy not in ("cavlc", "cabac"):
        raise ValueError(f"even width and height, entropy cavlc|cabac (got {width}x{height}, "
                         f"{entropy!r})")
    rng = random.Random(seed)
    cabac = entropy == "cabac"
    mbw, mbh = -(-width // 16), -(-height // 16)
    n_mbs = mbw * mbh
    qp_lo, qp_hi = QP_RANGE
    sp = dict(id=rng.randrange(32), log2_mfn=rng.choice([4, 5, 9]),
              poc_type=rng.choice([0, 0, 1, 2]), log2_poc=rng.choice([5, 8]),
              max_refs=rng.randint(2, 4), mbw=mbw, mbh=mbh,
              crop=(0, (mbw * 16 - width) // 2, 0, (mbh * 16 - height) // 2),
              lists=_draw_lists(rng, 2) if rng.random() < 0.5 else None,
              vui=None if full_range is None else dict(full_range=full_range, matrix=matrix))
    pps_list = []
    for pid in rng.sample(range(1, 256), 2):
        t8mode = rng.random() < 0.7
        pps_list.append(dict(
            id=pid, sps_id=sp["id"], cabac=cabac, num_ref_default=rng.randint(1, 3),
            weighted=rng.random() < 0.5, init_qp=rng.randint(qp_lo, qp_hi),
            cqp=(rng.randint(-6, 6), rng.randint(-6, 6)), cip=rng.random() < 0.3, high=True,
            t8mode=t8mode, lists=_draw_lists(rng, 2 * t8mode) if rng.random() < 0.5 else None))
    pps_list[0]["high"] = pps_list[0]["t8mode"] = False    # one PPS without the High fields,
    pps_list[0]["lists"] = None                              # so Cr takes Cb's QP offset
    pps_list[0]["cqp"] = (pps_list[0]["cqp"][0],) * 2
    if b_frames:
        sp["log2_poc"] = rng.choice([6, 8])
        sp["direct8x8"] = rng.random() < 0.6
        if sp["poc_type"] == 1:
            sp["poc1"] = dict(non_ref=rng.randint(-4, 0),
                              cycle=[rng.randint(1, 6) for _ in range(rng.randint(1, 3))])
        for pp, idc in zip(pps_list, rng.sample([0, 1, 2], 2)):
            pp["num_ref_default1"], pp["bipred"] = rng.randint(1, 3), idc
        spatial = rng.random() < 0.5
        plan = _b_plan(rng, n_frames, sp["poc_type"])
        # display index -> decode index; the reorder depth (frames decoded
        # earlier and shown later, at most) and the composition delay
        shown = [d for _, d in plan]
        reorder = max(sum(e > d for e in shown[:i]) for i, d in enumerate(shown))
        delay = max(i - d for i, d in enumerate(shown))
        sp["restrict"] = (reorder, min(16, sp["max_refs"] + reorder))
    sps_nal = _sps(sp)
    pps_nals = [_pps(pp) for pp in pps_list]
    scales = {pp["id"]: level_scales(*_effective(sp["lists"], pp["lists"], pp["t8mode"]))
              for pp in pps_list}
    max_fn = 1 << sp["log2_mfn"]
    stats = {"frames": [], "slices_max": 0, "p_slices_2refs": 0, "mods": 0, "long_term": 0,
             "mmco": set(), "weighted_p": 0, "deblock": set(), "t8_with_matrix": 0,
             "cropped": any(sp["crop"]), "mb": {}}
    refs, max_lt, prev_ref_fn, poc_count, idr_id, prev_nonref = [], -1, 0, 0, 0, False
    jobs, pictures = [], []
    if b_frames:
        stats.update(pictures=[], b_slices=0, temporal=0, spatial=0, bipred=set(), mods_l1=0,
                     long_term_l1=0, weighted_b=0, reordered_b=0, poc_type=sp["poc_type"],
                     direct8x8=sp["direct8x8"], reorder=reorder)
        jobs, pictures = _b_pictures(rng, sp, pps_list, scales, plan, cabac, mbw, mbh, stats,
                                     spatial)
    for k in range(0 if b_frames else n_frames):
        u = rng.random()
        if k == 0 or u < 0.06:
            kind = "idr"
        elif u < 0.16:
            kind = "i"
        elif u < 0.34 and (sp["poc_type"] == 0 or not prev_nonref):
            kind = "p_nonref"
        else:
            kind = "p"
        idr = kind == "idr"
        nal_ref_idc = 0 if kind == "p_nonref" else rng.randint(1, 3)
        if kind == "i" and rng.random() < 0.3:
            nal_ref_idc = 0
        prev_nonref = nal_ref_idc == 0
        if idr:
            frame_num, poc_count, idr_id = 0, 0, (idr_id + 1) % 65536
        else:
            frame_num = (prev_ref_fn + 1) % max_fn
            poc_count += 1
        pp = pps_list[rng.randrange(2)]
        ltrf = idr and rng.random() < 0.3
        ops = None
        if nal_ref_idc and not idr:
            ops, new_refs, new_max_lt, cur = _marking(rng, refs, max_lt, frame_num, max_fn,
                                                     sp["max_refs"], 0.35)
        n_sl = rng.randint(1, min(MAX_SLICES, n_mbs))
        cuts = sorted(rng.sample(range(1, n_mbs), n_sl - 1)) if n_sl > 1 else []
        bounds = [0] + cuts + [n_mbs]
        stats["slices_max"] = max(stats["slices_max"], n_sl)
        pic_jobs = []
        for si in range(n_sl):
            st = SLICE_P if (kind.startswith("p") and refs and rng.random() < 0.85) else SLICE_I
            s = dict(first_mb=bounds[si], slice_type=st, frame_num=frame_num, idr=idr,
                     idr_pic_id=idr_id, poc_lsb=(2 * poc_count) % (1 << sp["log2_poc"]),
                     nal_ref_idc=nal_ref_idc, ltrf=ltrf, ops=ops, mods=[], weights=[],
                     qp=rng.randint(qp_lo, qp_hi), cabac_init_idc=rng.randrange(3),
                     deblock=(rng.choice([0, 0, 1, 2]), rng.randint(-6, 6), rng.randint(-6, 6)),
                     num_ref=1)
            if st == SLICE_P:
                s["num_ref"] = rng.randint(1, min(4, len(refs)))
                if rng.random() < 0.4:
                    pred = frame_num
                    for _ in range(rng.randint(1, s["num_ref"])):
                        r = rng.choice(refs)
                        if r["long"]:
                            s["mods"].append((2, r["lt"]))
                            continue
                        p = _pic_num(r["fn"], frame_num, max_fn)
                        nowrap = p if p >= 0 else p + max_fn
                        idc = rng.randrange(2)
                        d = ((pred - nowrap) if idc == 0 else (nowrap - pred)) % max_fn or max_fn
                        s["mods"].append((idc, d - 1))
                        pred = nowrap
                    stats["mods"] += 1
                if pp["weighted"]:
                    s["luma_wd"], s["chroma_wd"] = rng.randint(0, 7), rng.randint(0, 7)
                    for _ in range(s["num_ref"]):
                        lw = ((min(127, (1 << s["luma_wd"]) + rng.randint(-40, 40)),
                               rng.randint(-20, 20)) if rng.random() < 0.6 else None)
                        cw = ([v for _ in range(2) for v in (
                            min(127, (1 << s["chroma_wd"]) + rng.randint(-40, 40)),
                            rng.randint(-20, 20))] if rng.random() < 0.5 else None)
                        s["weights"].append((lw, cw))
                    stats["weighted_p"] += 1
                if s["num_ref"] >= 2:
                    stats["p_slices_2refs"] += 1
            if s["deblock"][0] != 1 and (s["deblock"][1] or s["deblock"][2]):
                stats["deblock"].add(s["deblock"][0])
            job = dict(head=_header(sp, pp, s), slice_type=st, first_mb=bounds[si],
                       end_mb=bounds[si + 1], mbw=mbw, mbh=mbh, cabac=cabac,
                       cabac_init_idc=s["cabac_init_idc"], qp=s["qp"],
                       num_ref=s["num_ref"], t8mode=pp["t8mode"], constrained_intra=pp["cip"],
                       cqp_offset=pp["cqp"], ls=scales[pp["id"]],
                       seed=rng.getrandbits(64), nal=(nal_ref_idc << 5) | (5 if idr else 1),
                       matrix=pp["lists"] is not None or sp["lists"] is not None)
            pic_jobs.append(job)
        jobs += pic_jobs
        pictures.append((len(pic_jobs), idr, rng.random() < 0.2))
        stats["frames"].append(kind)
        # the DPB after this picture
        if nal_ref_idc:
            if idr:
                refs = [{"fn": 0, "long": ltrf, "lt": 0}]
                max_lt = 0 if ltrf else -1
            else:
                refs, max_lt = new_refs, new_max_lt
                for op in ops or ():
                    stats["mmco"].add(op[0])
            prev_ref_fn = refs[-1]["fn"] if not idr else 0
            if ops and ops[0][0] == 5:
                prev_ref_fn, poc_count = 0, 0
            stats["long_term"] += sum(r["long"] for r in refs)
    if workers > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            coded = pool.map(_code_slice, jobs, chunksize=1)
    else:
        coded = [_code_slice(j) for j in jobs]
    samples, pos = [], 0
    for k, (n_sl, idr, aud) in enumerate(pictures):
        nals = [nal_unit(0x09, bytes([0x10]))] if aud else []
        for job, (rbsp, st) in zip(jobs[pos:pos + n_sl], coded[pos:pos + n_sl]):
            nals.append(nal_unit(job["nal"], rbsp))
            for key, v in st.items():
                if key == "ref_max":
                    stats["pictures"][k]["ref_max"] = max(v, stats["pictures"][k].get("ref_max", 0))
                    continue
                stats["mb"][key] = stats["mb"].get(key, 0) + v
            if job["matrix"] and st["t8"]:
                stats["t8_with_matrix"] += 1
        pos += n_sl
        samples.append(b"".join(struct.pack(">I", len(n)) + n for n in nals))
    avcc = _box(b"avcC", bytes([1, 100, 0, 40, 0xFF, 0xE1]), struct.pack(">H", len(sps_nal)),
                sps_nal, bytes([len(pps_nals)]),
                *[struct.pack(">H", len(p)) + p for p in pps_nals], bytes([0xFD, 0xF8, 0xF8, 0]))
    ctts = [d + delay - i for i, (_, d) in enumerate(plan)] if b_frames and delay else None
    write_mp4(path, samples, visual_sample_entry(b"avc1", width, height, avcc), width, height,
              sync=[p[1] for p in pictures], ctts=ctts, edit_start=ctts[0] if ctts else 0)
    stats["mmco"], stats["deblock"] = sorted(stats["mmco"]), sorted(stats["deblock"])
    if b_frames:
        stats["bipred"] = sorted(stats["bipred"])
    return stats


# SHA-256 of the concatenated Y planes of write_h264_syntax_mp4(path, w, h, n,
# seed, entropy), keyed (entropy, seed, w, h, n): ffmpeg's decode (cv2 5.0.0),
# held by tests/test_torch_h264.py; chip_smoke.py holds the port's decode on
# the card's machine, which has no cv2, against them
PINNED_LUMA_SHA256 = {
    ("cavlc", 1, 128, 96, 12): "afaefd8d5051859b3fd8377f6f162ced0cea667d05a88d8c0790508a4185f578",
    ("cabac", 1, 128, 96, 12): "3d722210bc6edd71c6a4264a8b39c4d2b7b160d5cbb8f2fe03314d3aa04504bf",
}

# The same for write_h264_syntax_mp4(..., b_frames=True): a CAVLC stream with
# POC type 0 and a B-pyramid, a CABAC one with POC type 1 (ffmpeg's decode,
# cv2 5.0.0; tests/test_torch_h264.py and chip_smoke.py hold them)
PINNED_B_LUMA_SHA256 = {
    ("cavlc", 1, 128, 96, 16): "9dd69e2f85d908aded9492a2bb205999efeb6700a628952c04b9039ee2634665",
    ("cabac", 5, 128, 96, 16): "814aec29819853f8e0136e17dc7808ddd819ee133f2b9bf13987aa654d24c3b5",
}

REFUSALS = {"sp_slice": "SP slices", "fields": "field coding", "422": "4:2:2",
            "10bit": "bit depth 10", "fmo": "slice groups"}


def write_h264_refusal_mp4(path, tool: str, width: int = 32, height: int = 32) -> str:
    """A two-picture mp4 whose headers use a tool the port's decoder refuses
    (a key of :data:`REFUSALS`): an I_PCM IDR picture, then a P picture of
    skipped macroblocks, or an SP slice for "sp_slice" (its header as a P
    slice's: the decoder refuses it at slice_type). Returns the phrase the
    decoder's error names."""
    mbw, mbh = width // 16, height // 16
    sp = dict(id=0, log2_mfn=4, poc_type=2, log2_poc=4, max_refs=1, mbw=mbw, mbh=mbh,
              crop=(0, 0, 0, 0), lists=None)
    pp = dict(id=0, sps_id=0, cabac=False, num_ref_default=1, weighted=False, init_qp=26,
              cqp=(0, 0), cip=False, high=False, t8mode=False, lists=None)
    sps_nal, pps_nal = _sps(sp, tool), _pps(pp, tool)
    samples = []
    for k in range(2):
        w = _Writer()
        st = SLICE_I if k == 0 else (3 if tool == "sp_slice" else SLICE_P)
        w.ue(0).ue(st).ue(0).u(4, k)
        if k == 0:
            w.ue(0)
        if st != SLICE_I:
            w.u(1, 0).u(1, 0)
        w.u(1, 0)
        if k == 0:
            w.u(1, 0)
        w.se(0).ue(1)
        if st == SLICE_I:
            for _ in range(mbw * mbh):
                w.ue(25).align()
                w.out += bytes([128]) * 384
        else:
            w.ue(mbw * mbh)
        samples.append(nal_unit(0x65 if k == 0 else 0x41, w.trailing()))
    samples = [struct.pack(">I", len(s)) + s for s in samples]
    avcc = _box(b"avcC", bytes([1, 100, 0, 40, 0xFF, 0xE1]), struct.pack(">H", len(sps_nal)),
                sps_nal, bytes([1]), struct.pack(">H", len(pps_nal)), pps_nal)
    write_mp4(path, samples, visual_sample_entry(b"avc1", width, height, avcc), width, height,
              sync=[True, False])
    return REFUSALS[tool]
