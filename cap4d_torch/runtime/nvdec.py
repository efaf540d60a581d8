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
cv2's decode of the port's own H.264 streams.
"""

from __future__ import annotations

import ctypes
from typing import Dict

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


def _fixed_point(matrix: str, full_range: bool):
    """swscale's 16-bit multipliers for ``matrix``: (luma, luma offset,
    V→R, U→B, U→G, V→G), each a 16.16 coefficient times 2**13, rounded."""
    crv, cbu, cgu, cgv = MATRICES[matrix]
    cgu, cgv = -cgu, -cgv
    cy, oy = 1 << 16, 0
    if full_range:      # chroma 0..255 instead of 16..240 (C division truncates)
        crv, cbu = crv * 224 // 255, cbu * 224 // 255
        cgu, cgv = -(-cgu * 224 // 255), -(-cgv * 224 // 255)
    else:               # luma 16..235 to 0..255
        cy, oy = cy * 255 // 219, 16 << 16
    r16 = lambda x: (x + (1 << 15)) >> 16  # noqa: E731
    return (r16(cy << 13), r16(oy << 3), r16(crv << 13), r16(cbu << 13), r16(cgu << 13),
            r16(cgv << 13))


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
    cy, oy, vr, ub, ug, vg = _fixed_point(matrix, full_range)
    c = (uv.int() << 3) - (128 << 3)
    c = c.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]
    u, v = c[..., 0], c[..., 1]
    luma = (((y.int() << 3) - oy) * cy) >> 16
    r = luma + ((v * vr) >> 16)
    g = luma + ((u * ug) >> 16) + ((v * vg) >> 16)
    b = luma + ((u * ub) >> 16)
    rgb = torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)
    return rgb.cpu().numpy()
