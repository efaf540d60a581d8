"""NVDEC's decoder caps (a probe of the card's video decoder), and the NV12
→ RGB conversion that every decoded YUV picture goes through.

The JAX package decodes video with cv2 (ffmpeg, on the host). The port
decodes on the host too, in its runtime: H.264 (``runtime/h264.py``),
MPEG-4 Part 2 (``runtime/mpeg4.py``) and VP9 (``runtime/vp9.py``), whatever
the reader's device; no codec goes to NVDEC (``libnvcuvid.so.1``, which
ships with NVIDIA's GPU libraries and which a container can use when its
``NVIDIA_DRIVER_CAPABILITIES`` include ``video``).

:func:`decoder_caps` asks ``cuvidGetDecoderCaps`` (through ctypes, on the
card's primary context, the one torch uses) what the card's NVDEC takes for
H.264 or VP9; ``chip_smoke.py`` records its answer, the probe ROADMAP keeps
for a hardware decode path. The decoder itself (``cuvidCreateVideoParser`` /
``cuvidCreateDecoder``) is not driven: on the H100 machine it was developed
for, the container grants ``compute,utility`` only, and every
``cuvidGetDecoderCaps`` and ``cuvidCreateDecoder`` call returns
``CUDA_ERROR_OUT_OF_MEMORY`` (2), for every codec.

:func:`nv12_to_rgb` is the colour conversion of decoded 4:2:0 planes: plain
PyTorch, on whatever device the planes are on, tested on the CPU against
cv2's decode of the port's own H.264 streams. :func:`yuv_to_rgb` is what
cv2 applies to a decoded picture of any size and chroma layout: that
unscaled converter where swscale takes it, and otherwise
:func:`swscale_bicubic`, a copy of swscale's generic scaler with
``SWS_BICUBIC`` to BGR24 (integer arithmetic only, so every device gives
the same bytes). The scaler is written in PyTorch, not in the runtime's
C++: each of its passes is a filter whose outputs are independent (no
error diffusion reaches BGR24), so it runs on the reader's device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# cudaVideoCodec (cuviddec.h), for the probe
CODEC_IDS = {"h264": 4, "vp9": 10}
CHROMA_420 = 1          # cudaVideoChromaFormat_420
# swscale's YCbCr -> RGB coefficients (crv, cbu, cgu, cgv), 16.16 fixed point
# for limited-range chroma, of each matrix (Rec. ITU-R BT.601, BT.709, the
# FCC's, SMPTE 240M, BT.2020 non-constant luminance): the integers the
# JAX package's cv2 reader converts with, so nv12_to_rgb equals its RGB
MATRICES = {"bt601": (104597, 132201, 25675, 53279), "bt709": (117489, 138438, 13975, 34925),
            "fcc": (104448, 132798, 24759, 53109), "smpte240m": (117579, 136230, 16907, 35559),
            "bt2020": (110013, 140363, 12277, 42626)}
CUDA_ERRORS = {2: "CUDA_ERROR_OUT_OF_MEMORY", 100: "CUDA_ERROR_NO_DEVICE",
               801: "CUDA_ERROR_NOT_SUPPORTED", 1: "CUDA_ERROR_INVALID_VALUE"}


class DecodeCaps(ctypes.Structure):
    """``CUVIDDECODECAPS`` of the Video Codec SDK's ``cuviddec.h`` (88 bytes;
    SDK 9-12 agree on the layout)."""

    _fields_ = [("eCodecType", ctypes.c_int), ("eChromaFormat", ctypes.c_int),
                ("nBitDepthMinus8", ctypes.c_uint), ("reserved1", ctypes.c_uint * 3),
                ("bIsSupported", ctypes.c_ubyte), ("nNumNVDECs", ctypes.c_ubyte),
                ("nOutputFormatMask", ctypes.c_ushort), ("nMaxWidth", ctypes.c_uint),
                ("nMaxHeight", ctypes.c_uint), ("nMaxMBCount", ctypes.c_uint),
                ("nMinWidth", ctypes.c_ushort), ("nMinHeight", ctypes.c_ushort),
                ("reserved3", ctypes.c_uint * 11)]


assert ctypes.sizeof(DecodeCaps) == 88


def decoder_caps(codec: str, card: int = 0) -> Dict:
    """``cuvidGetDecoderCaps`` for ``codec`` ("h264" or "vp9") at 8-bit
    4:2:0 on card ``card``'s primary context: {"status", "supported",
    "nvdecs", "formats", "min", "max", "max_mbs"}, or {"error": why} when
    ``libcuda.so.1`` or ``libnvcuvid.so.1`` does not load or a CUDA call
    fails."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
        cuvid = ctypes.CDLL("libnvcuvid.so.1")
    except OSError as e:
        return {"error": f"{e}"}
    dev, ctx = ctypes.c_int(0), ctypes.c_void_p()
    for name, rc in (("cuInit", lambda: cuda.cuInit(0)),
                     ("cuDeviceGet", lambda: cuda.cuDeviceGet(ctypes.byref(dev), card)),
                     ("cuDevicePrimaryCtxRetain",
                      lambda: cuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev))):
        status = rc()
        if status != 0:
            return {"error": f"{name} returned {status} ({CUDA_ERRORS.get(status, '?')})"}
    try:
        status = cuda.cuCtxPushCurrent_v2(ctx)
        if status != 0:
            return {"error": f"cuCtxPushCurrent returned {status}"}
        caps = DecodeCaps(eCodecType=CODEC_IDS[codec], eChromaFormat=CHROMA_420)
        status = cuvid.cuvidGetDecoderCaps(ctypes.byref(caps))
        cuda.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))
    finally:
        cuda.cuDevicePrimaryCtxRelease_v2(dev)
    return {"status": status, "supported": bool(caps.bIsSupported), "nvdecs": caps.nNumNVDECs,
            "formats": caps.nOutputFormatMask, "min": (caps.nMinWidth, caps.nMinHeight),
            "max": (caps.nMaxWidth, caps.nMaxHeight), "max_mbs": caps.nMaxMBCount}


def _fixed_point(matrix: str, full_range: bool, c_output: bool = False):
    """swscale's 16-bit multipliers for ``matrix``: (luma, luma offset,
    V→R, U→B, U→G, V→G), each a 16.16 coefficient times 2**13, rounded;
    with ``c_output`` the luma offset times 2**9 (yuv2rgb_y_offset, for the
    C full-chroma output) instead of 2**3."""
    crv, cbu, cgu, cgv = MATRICES[matrix]
    cgu, cgv = -cgu, -cgv
    cy, oy = 1 << 16, 0
    if full_range:      # chroma 0..255 instead of 16..240 (C division truncates)
        crv, cbu = crv * 224 // 255, cbu * 224 // 255
        cgu, cgv = -(-cgu * 224 // 255), -(-cgv * 224 // 255)
    else:               # luma 16..235 to 0..255
        cy, oy = cy * 255 // 219, 16 << 16
    r16 = lambda x: (x + (1 << 15)) >> 16  # noqa: E731
    return (r16(cy << 13), r16(oy << (9 if c_output else 3)), r16(crv << 13), r16(cbu << 13),
            r16(cgu << 13), r16(cgv << 13))


def nv12_to_rgb(y: torch.Tensor, uv: torch.Tensor, matrix: str = "bt601",
                full_range: bool = False) -> np.ndarray:
    """NV12 planes → RGB uint8 (H, W, 3) numpy, as ``VideoFrameReader``
    returns frames.

    ``y`` (H, W) and ``uv`` (ceil(H/2), ceil(W/2), 2) uint8 tensors (NV12's
    interleaved chroma plane), on any device. Chroma is repeated over each
    2x2 block of luma; ``matrix`` names the YCbCr matrix (:data:`MATRICES`),
    and limited range scales luma 16..235 and chroma 16..240 to 0..255.
    The arithmetic is swscale's unscaled 4:2:0 → BGR24 converter's (samples
    times 8, each term a signed 16 x 16 multiply keeping the high 16 bits,
    the sum clamped to 0..255), so the RGB equals cv2's bit for bit."""
    if matrix not in MATRICES:
        raise ValueError(f"matrix must be one of {sorted(MATRICES)}, got {matrix!r}")
    if y.dtype != torch.uint8 or uv.dtype != torch.uint8 or uv.shape[-1] != 2:
        raise ValueError(f"nv12_to_rgb takes uint8 planes, got {y.dtype} {tuple(y.shape)} "
                         f"and {uv.dtype} {tuple(uv.shape)}")
    h, w = y.shape
    if uv.shape[:2] != ((h + 1) // 2, (w + 1) // 2):
        raise ValueError(f"chroma plane {tuple(uv.shape)} does not fit luma {h}x{w}")
    return to_host(_unscaled(y, uv, 2, matrix, full_range))


def to_host(rgb: torch.Tensor, rotation: int = 0) -> np.ndarray:
    """An RGB picture on any device → numpy, turned ``rotation`` degrees
    clockwise (0, 90, 180 or 270: cv2's rotation of a frame whose container
    carries a display matrix) on that device first."""
    if rotation:
        rgb = torch.rot90(rgb, -(rotation // 90), (0, 1)).contiguous()
    return rgb.cpu().numpy()


def _unscaled(y: torch.Tensor, uv: torch.Tensor, rows: int, matrix: str,
              full_range: bool) -> torch.Tensor:
    """swscale's unscaled converter: each chroma sample over 2 columns and
    ``rows`` rows of luma; RGB on the planes' device."""
    h, w = y.shape
    cy, oy, vr, ub, ug, vg = _fixed_point(matrix, full_range)
    c = (uv.int() << 3) - (128 << 3)
    c = c.repeat_interleave(rows, 0).repeat_interleave(2, 1)[:h, :w]
    u, v = c[..., 0], c[..., 1]
    luma = (((y.int() << 3) - oy) * cy) >> 16
    r = luma + ((v * vr) >> 16)
    g = luma + ((u * ug) >> 16) + ((v * vg) >> 16)
    b = luma + ((u * ub) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


# --------------------------------------------- swscale's generic scaler --
#
# libswscale 9.5 (cv2 5.0.0's), x86-64, as cv2 runs it: sws_getContext(w, h,
# yuv4xxp, W, H, BGR24, SWS_BICUBIC) with the stream's matrix and range.
# - Filters (initFilter): bicubic with B = 0, C = 0.6 in 2^30 fixed point,
#   1 + 4 taps to enlarge, 1 + 4 src/dst to shrink, the identity where the
#   size and the sample position do not change; near-zero taps trimmed
#   (0.002 of the sum), widths rounded up to 4 horizontally and 2
#   vertically (x86's alignment; 1 for an unscaled vertical filter), taps
#   past an edge folded onto the edge sample, then normalised to 2^14
#   (horizontal) or 2^12 (vertical) with the rounding error carried along
#   the taps.
# - Chroma siting: the sample positions of get_local_pos, from the source
#   chroma position (src_h_chr_pos, src_v_chr_pos: 1/256 of a luma sample
#   from the first luma sample, as av_chroma_location_enum_to_pos gives
#   them; cv2 sets them from the frame's chroma location, left (0, 128)
#   for MPEG-4 Part 2, Matroska's ChromaSiting for VP8 and VP9) or, unset,
#   swscale's default: a subsampled plane's sample centred between its luma
#   samples (128 << sub) - 128. Either way (pos + 128) >> sub in 1/256 of a
#   chroma sample; the output's chroma keeps the default.
# - Horizontal pass: 8-bit samples times the taps, >> 7, capped at 2^15 - 1.
# - Output: an odd output width, or chroma not subsampled in the input,
#   forces full horizontal chroma interpolation, which the C
#   yuv2rgb_full_X converts in 2^22 fixed point with swscale's int32
#   wrap-around. Otherwise chroma is interpolated to half the output width
#   and the MMXEXT yuv2bgr24_X converts (each vertical tap a pmulhw of the
#   15-bit row by the 12-bit tap, summed in 16 bits from a rounder of 4;
#   then the unscaled converter's pmulhw arithmetic, chroma repeated over
#   pixel pairs), except the last two rows, which swscale leaves to the C
#   yuv2rgb_X and its lookup tables. One vertical tap for luma and chroma
#   takes yuv2bgr24_1 (a shift by 4: a rounder of 0).
# - No dither reaches BGR24.
# Two-tap vertical filters (pictures at most 8 rows high scaled, where
# swscale takes its bilinear yuv2packed2 or blended yuv2packed1) are not
# copied and raise.

SWS_ONE_H, SWS_ONE_V = 1 << 14, 1 << 12
# ffmpeg's chroma locations (AVChromaLocation) as av_chroma_location_enum_to_pos
# gives them: (horizontal, vertical) in 1/256 of a luma sample
CHROMA_POSITIONS = {"left": (0, 128), "center": (128, 128), "topleft": (0, 0), "top": (128, 0),
                    "bottomleft": (0, 256), "bottom": (128, 256)}


def _c_div(a: int, b: int) -> int:
    """C's integer division (truncating toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _rounded_div(a: int, b: int) -> int:
    """libavutil's ROUNDED_DIV."""
    return (a + (b >> 1)) // b if a >= 0 else -((-a + (b >> 1)) // b)


def _sample_pos(sub: int, pos: Optional[int] = None) -> int:
    """get_local_pos: a plane's first sample position, 1/256 sample units,
    for chroma subsampled by ``sub`` at the chroma position ``pos`` (1/256
    of a luma sample; None: unspecified, swscale's default)."""
    if pos is None or pos == -1 or pos <= -513:
        pos = (128 << sub) - 128
    return (pos + 128) >> sub


def _xinc(src: int, dst: int) -> int:
    return ((src << 16) + (dst >> 1)) // dst


@functools.lru_cache(maxsize=64)
def sws_filter(src: int, dst: int, one: int, align: int, src_pos: int,
               dst_pos: int) -> Tuple[np.ndarray, np.ndarray]:
    """swscale's initFilter for SWS_BICUBIC from ``src`` samples to ``dst``:
    (taps (dst, size) int64 summing to ``one``, first source index (dst,))."""
    inc = _xinc(src, dst)
    fone = 1 << (54 - min((src // dst).bit_length() - 1 if src >= dst else 0, 8))
    if abs(inc - 0x10000) < 10 and src_pos == dst_pos:
        size, filt, pos = 1, [[fone] for _ in range(dst)], list(range(dst))
    else:
        size = 5 if inc <= 1 << 16 else 1 + (4 * src + dst - 1) // dst
        size = max(min(size, src - 2), 1)
        b, c = 0, int(0.6 * (1 << 24))
        x = ((dst_pos * inc) >> 7) - ((src_pos * 0x10000) >> 7)
        filt, pos = [], []
        for _ in range(dst):
            xx = _c_div(x - (size - 2) * (1 << 16), 1 << 17)
            pos.append(xx)
            row = []
            for _ in range(size):
                d = abs(xx * (1 << 17) - x) << 13
                if inc > 1 << 16:
                    d = d * dst // src
                if d >= 1 << 31:
                    coeff = 0
                else:
                    dd = (d * d) >> 30
                    ddd = (dd * d) >> 30
                    if d < 1 << 30:
                        coeff = ((12 * (1 << 24) - 9 * b - 6 * c) * ddd
                                 + (-18 * (1 << 24) + 12 * b + 6 * c) * dd
                                 + (6 * (1 << 24) - 2 * b) * (1 << 30))
                    else:
                        coeff = ((-b - 6 * c) * ddd + (6 * b + 30 * c) * dd
                                 + (-12 * b - 48 * c) * d + (8 * b + 24 * c) * (1 << 30))
                row.append(_c_div(coeff, (1 << 54) // fone))
                xx += 1
            filt.append(row)
            x += 2 * inc
    # trim near-zero taps: from the left by moving the filter, then count the right
    min_size = 0
    for i in range(dst - 1, -1, -1):
        keep, cut = size, 0
        for _ in range(size):
            cut += abs(filt[i][0])
            if cut > 0.002 * fone or (i < dst - 1 and pos[i] >= pos[i + 1]):
                break
            filt[i] = filt[i][1:] + [0]
            pos[i] += 1
        cut = 0
        for j in range(size - 1, 0, -1):
            cut += abs(filt[i][j])
            if cut > 0.002 * fone:
                break
            keep -= 1
        min_size = max(min_size, keep)
    if min_size == 1 and align == 2:
        align = 1
    out_size = (min_size + align - 1) & ~(align - 1)
    filt = [[r[j] if j < size else 0 for j in range(out_size)] for r in filt]
    for i, r in enumerate(filt):          # taps past the edges fold onto them
        if pos[i] < 0:
            for j in range(1, out_size):
                left = max(j + pos[i], 0)
                r[left] += r[j]
                r[j] = 0
            pos[i] = 0
        if pos[i] + out_size > src:
            shift = pos[i] + min(out_size - src, 0)
            acc = 0
            for j in range(out_size - 1, -1, -1):
                if pos[i] + j >= src:
                    acc += r[j]
                    r[j] = 0
            for j in range(out_size - 1, -1, -1):
                r[j] = 0 if j < shift else r[j - shift]
            pos[i] -= shift
            r[src - 1 - pos[i]] += acc
    taps = np.zeros((dst, out_size), np.int64)
    for i, r in enumerate(filt):
        total = max((sum(r) + one // 2) // one, 1)
        err = 0
        for j in range(out_size):
            v = r[j] + err
            taps[i, j] = _rounded_div(v, total)
            err = v - int(taps[i, j]) * total
    return taps, np.array(pos, np.int64)


def _taps(src: int, dst: int, one: int, align: int, src_pos: int, dst_pos: int, device):
    taps, pos = sws_filter(src, dst, one, align, src_pos, dst_pos)
    index = np.minimum(pos[:, None] + np.arange(taps.shape[1]), src - 1)
    return (torch.from_numpy(taps).to(device=device, dtype=torch.int32),
            torch.from_numpy(index).to(device))


def _hscale(plane: torch.Tensor, dst: int, src_pos: int, dst_pos: int) -> torch.Tensor:
    """The horizontal pass: (rows, src) uint8 -> (rows, dst) int32, 15 bits."""
    taps, index = _taps(plane.shape[1], dst, SWS_ONE_H, 4, src_pos, dst_pos, plane.device)
    acc = (plane.int()[:, index] * taps).sum(-1, dtype=torch.int32)
    return torch.clamp(acc >> 7, max=(1 << 15) - 1)


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's complement wrap-around of ``x`` to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _pmulhw(a: torch.Tensor, b) -> torch.Tensor:
    return (a * b) >> 16


def _yuv_tables(matrix: str, full_range: bool, device):
    """The lookup tables of swscale's C yuv2rgb (ff_yuv2rgb_c_init_tables at
    24 bits per pixel): the luma table and each chroma term's offset into it
    (table_rV, table_gU, table_gV, table_bU), indexed by sample + 512."""
    crv, cbu, cgu, cgv = MATRICES[matrix]
    cgu, cgv = -cgu, -cgv
    cy, oy = 1 << 16, 0
    if full_range:
        crv, cbu, cgu, cgv = (_c_div(c * 224, 255) for c in (crv, cbu, cgu, cgv))
    else:
        cy, oy = cy * 255 // 219, 16 << 16
    crv, cbu, cgu, cgv = (_c_div(c * (1 << 16) + 0x8000, cy) for c in (crv, cbu, cgu, cgv))
    yoffs = (384 if full_range else 326) + 512
    base = -(384 << 16) - 512 * cy - oy
    luma = torch.clamp((base + torch.arange(2048, dtype=torch.int64) * cy + 0x8000) >> 16, 0, 255)
    cl = torch.clamp(torch.arange(1280, dtype=torch.int64) - 512, 0, 255)
    r_v, g_u, b_u = (yoffs - (c >> 9) + ((cl * c) >> 16) for c in (crv, cgu, cbu))
    g_v = -(cgv >> 9) + ((cl * cgv) >> 16)
    return tuple(t.to(device) for t in (luma, r_v, g_u, g_v, b_u))


def _vertical(rows: torch.Tensor, taps: torch.Tensor, index: torch.Tensor, start: int,
              stop: int, mmx: bool, rounder: int = 4) -> torch.Tensor:
    """Output rows [start, stop) of the vertical pass over the 15-bit
    ``rows``: the MMX filter (pmulhw per tap, 16-bit sums, times 8 the
    sample) or the C sum (times 2^27)."""
    out = None
    for j in range(taps.shape[1]):
        src = rows[index[start:stop, j]]
        c = taps[start:stop, j, None]
        if mmx:
            term = _pmulhw(src, _wrap(c, 16))
            out = _wrap((rounder if out is None else out) + term, 16)
        else:
            out = src * c if out is None else out + src * c
    return out


def swscale_bicubic(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, height: int,
                    width: int, matrix: str = "bt601", full_range: bool = False,
                    chroma_pos: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Y, U and V uint8 planes (any device; chroma subsampled by 1 or 2 in
    each direction, or by 4 horizontally) -> RGB uint8 (height, width, 3)
    numpy, as swscale's generic scaler with SWS_BICUBIC to BGR24 gives it
    (see the notes above this function). ``chroma_pos`` is the source's
    (src_h_chr_pos, src_v_chr_pos), None for swscale's default."""
    return to_host(_bicubic(y, u, v, height, width, matrix, full_range, chroma_pos))


def _bicubic(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, height: int, width: int,
             matrix: str, full_range: bool,
             chroma_pos: Optional[Tuple[int, int]]) -> torch.Tensor:
    """:func:`swscale_bicubic`'s RGB on the planes' device."""
    if matrix not in MATRICES:
        raise ValueError(f"matrix must be one of {sorted(MATRICES)}, got {matrix!r}")
    h, w = y.shape
    ch, cw = u.shape
    subs = {(-(-w >> s), s) for s in range(3)}
    sh = next((s for n, s in subs if n == cw), None)
    sv = next((s for s in (0, 1) if -(-h >> s) == ch), None)
    if sh is None or sv is None or v.shape != u.shape:
        raise ValueError(f"chroma planes {tuple(u.shape)} and {tuple(v.shape)} do not fit "
                         f"luma {h}x{w}")
    full = bool(width & 1) or (sh == 0 and sv == 0)
    dsh = 0 if full else 1
    cdw = -(-width >> dsh)
    lum_v = _taps(h, height, SWS_ONE_V, 2, 128, 128, y.device)
    hpos, vpos = chroma_pos or (None, None)
    chr_v = _taps(ch, height, SWS_ONE_V, 2, _sample_pos(sv, vpos), _sample_pos(0), y.device)
    if 2 in (lum_v[0].shape[1], chr_v[0].shape[1]):
        raise ValueError(f"scaling {w}x{h} to {width}x{height}: swscale's two-tap vertical "
                         "output (yuv2packed1/2, pictures at most 8 rows high) is not copied")
    yh = _hscale(y, width, 128, 128)
    uh, vh = (_hscale(c, cdw, _sample_pos(sh, hpos), _sample_pos(dsh)) for c in (u, v))
    cy, oy, vr, ub, ug, vg = _fixed_point(matrix, full_range)
    if full:      # the C yuv2rgb_full_X, every row
        yy = (_vertical(yh, *lum_v, 0, height, False).long() + (1 << 9)) >> 10
        uu, vv = ((_vertical(c, *chr_v, 0, height, False).long() + (1 << 9) - (128 << 19)) >> 10
                  for c in (uh, vh))
        k = _fixed_point(matrix, full_range, c_output=True)
        yy = (yy - k[1]) * k[0] + (1 << 21)
        r, g, b = yy + vv * k[2], yy + vv * k[5] + uu * k[4], yy + uu * k[3]
        rgb = torch.stack([_wrap(x, 32).clamp_(0, (1 << 30) - 1) >> 22 for x in (r, g, b)], -1)
        return rgb.to(torch.uint8)
    rgb = torch.empty(height, width, 3, dtype=torch.uint8, device=y.device)
    split = max(height - 2, 0)
    if split:     # MMXEXT yuv2bgr24_X (yuv2bgr24_1 for one tap)
        rounder = 0 if lum_v[0].shape[1] == 1 and chr_v[0].shape[1] == 1 else 4
        yy = _vertical(yh, *lum_v, 0, split, True, rounder)
        uu, vv = (_wrap(_vertical(c, *chr_v, 0, split, True, rounder) - (128 << 3), 16)
                  for c in (uh, vh))
        luma = _pmulhw(_wrap(yy - oy, 16), cy)
        rep = lambda t: t.repeat_interleave(2, 1)[:, :width]  # noqa: E731
        r = luma + rep(_pmulhw(vv, vr))
        g = luma + rep(_wrap(_pmulhw(uu, ug) + _pmulhw(vv, vg), 16))
        b = luma + rep(_pmulhw(uu, ub))
        rgb[:split] = torch.stack([_wrap(x, 16) for x in (r, g, b)], -1).clamp_(0, 255)
    if split < height:     # the C yuv2rgb_X for the last two rows
        table, r_v, g_u, g_v, b_u = _yuv_tables(matrix, full_range, y.device)
        yy = (_vertical(yh, *lum_v, split, height, False) + (1 << 18)) >> 19
        uu, vv = (((_vertical(c, *chr_v, split, height, False) + (1 << 18)) >> 19)
                  .repeat_interleave(2, 1)[:, :width].long() + 512 for c in (uh, vh))
        yy = yy.long()
        rgb[split:] = torch.stack([table[r_v[vv] + yy], table[g_u[uu] + g_v[vv] + yy],
                                   table[b_u[uu] + yy]], -1).to(torch.uint8)
    return rgb


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, height: int, width: int,
               matrix: str = "bt601", full_range: bool = False,
               chroma_pos: Optional[Tuple[int, int]] = None, rotation: int = 0) -> np.ndarray:
    """A decoded picture's planes (any device; ``u``/``v`` None for
    greyscale) -> RGB uint8 (height, width, 3) numpy, turned ``rotation``
    degrees clockwise on their device (:func:`to_host`), as cv2 converts it:
    swscale's unscaled converter (:func:`nv12_to_rgb`'s arithmetic, chroma
    repeated, which ignores the chroma siting) for 4:2:0 and 4:2:2 at the
    output size with an even height, grey repeated into the three channels,
    and :func:`swscale_bicubic` at the source's ``chroma_pos`` for
    everything else."""
    h, w = y.shape
    if u is None:
        if (h, w) != (height, width):
            raise ValueError(f"a {w}x{h} greyscale picture shown at {width}x{height}: "
                             "swscale's scaled grey path is not copied")
        rgb = y[..., None].expand(h, w, 3)
    elif (h, w) == (height, width) and not h & 1 and u.shape[1] == (w + 1) // 2 \
            and u.shape[0] in (h, h // 2):
        rgb = _unscaled(y, torch.stack([u, v], -1), 1 if u.shape[0] == h else 2, matrix,
                        full_range)
    else:
        rgb = _bicubic(y, u, v, height, width, matrix, full_range, chroma_pos)
    return to_host(rgb, rotation)
