"""ctypes wrapper of the runtime's VP8 decoder (``vp8.cpp``).

The JAX package decodes a VP8 track (``V_VP8`` in Matroska/WebM, what
browsers' MediaRecorder writes; ``VP80`` in an AVI, what cv2's VideoWriter
writes for that fourcc) on the host through cv2, whose ffmpeg opens its
native ``vp8`` decoder; this is the port's counterpart, in the runtime's
library, so it needs no codec library on either machine. It decodes
versions 0-3 (six-tap, bilinear and full-pixel prediction, the normal and
simple loop filters; the reserved versions 4-7 as ffmpeg decodes them, as
bilinear), key and inter frames, hidden (alt-ref) frames, segmentation,
token partitions and the golden and alt-ref buffers, bit for bit as ffmpeg
does. It raises ``ValueError`` naming the syntax element for anything else
(an inter frame before the first key frame, a broken stream).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np

from cap4d_torch.runtime.loader import _U8_P, lib

_ERR_BYTES = 512
# the Tool bits of vp8.cpp, in order
TOOLS = (
    "key_frame", "inter_frame", "hidden_frame", "version_0", "version_1", "version_2",
    "version_3", "size_change", "odd_size", "scaling_bits", "color_space", "clamping_type",
    "segmentation", "seg_map_update", "seg_map_kept", "seg_data_update", "seg_absolute",
    "seg_quant", "seg_filter", "filter_normal", "filter_simple", "filter_off", "sharpness",
    "lf_deltas", "lf_delta_update", "partitions_2", "partitions_4", "partitions_8",
    "quant_deltas", "refresh_golden", "refresh_altref", "golden_from_last",
    "golden_from_altref", "altref_from_last", "altref_from_golden", "sign_bias", "keep_entropy",
    "keep_last", "coef_updates", "no_skip_flag", "skip", "ref_golden", "ref_altref",
    "ymode_update", "uv_mode_update", "mv_updates", "b_pred_key", "b_pred_inter", "i16_inter",
    "nearest", "near", "zero", "new", "split_16x8", "split_8x16", "split_8x8", "split_4x4",
    "sub_left", "sub_above", "sub_zero", "sub_new", "mv_long", "token_cat6", "edge_mc", "far_mc",
    "version_reserved")


class Scan(NamedTuple):
    """What :func:`scan` reads of a sample's frame tag without decoding:
    whether it is a key frame, whether it shows a picture (show_frame), its
    version, and a key frame's width and height (0 for an inter frame)."""

    key: bool
    shows: bool
    version: int
    width: int
    height: int


def scan(sample: bytes, what: str = "") -> Scan:
    """The frame tag of ``sample`` (:class:`Scan`); ValueError names
    ``what`` and the reason for a sample that does not parse."""
    info = (ctypes.c_int * 5)()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    if lib().c4d_vp8_scan(sample, len(sample), info, err, _ERR_BYTES) != 0:
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}".lstrip(": "))
    return Scan(bool(info[0]), bool(info[1]), int(info[2]), int(info[3]), int(info[4]))


class Vp8Decoder:
    """A decoder of one track: :meth:`decode` takes the samples in decode
    order from a key frame on (after :meth:`reset` when it jumps) and
    returns each sample's picture as (Y, U, V) uint8 planes of the frame's
    size (which may change at a key frame), or None for a hidden frame.
    :attr:`matrix` is BT.601 (VP8 has no other); :attr:`full_range` is
    True for a key frame whose clamping_type bit is 1: ffmpeg reads the bit
    as the colour range, and cv2, whose ffmpeg decodes with frame threads
    that each keep the bit they read last, converts that key frame as full
    range and the inter frames after it as limited range (all but those the
    key frame's thread decodes again: ROADMAP's measured parity gaps).
    :attr:`chroma_location` is None: ffmpeg's ``vp8`` decoder sets none, so
    the container's (Matroska's ChromaSiting) reaches swscale."""

    matrix, chroma_location = "bt601", None

    def __init__(self, name: str = "VP8 stream"):
        self.name = name
        self._lib = lib()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        self._dec = self._lib.c4d_vp8_open(err, _ERR_BYTES)
        if not self._dec:
            raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
        self.full_range = False

    def decode(self, sample: bytes, what: str = "") -> Optional[Tuple[np.ndarray, ...]]:
        """One sample (a frame) → its picture, or None when it is hidden.
        Raises ValueError naming ``what`` (e.g. the frame) and the reason,
        after which the decoder holds no references."""
        info = (ctypes.c_int * 5)()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        where = f"{self.name} {what}".strip()
        if self._lib.c4d_vp8_decode(self._dec, sample, len(sample), info, err, _ERR_BYTES) != 0:
            raise ValueError(f"{where}: {err.value.decode(errors='replace')}")
        if not info[0]:
            return None
        w, h = int(info[1]), int(info[2])
        self.full_range = bool(info[4])
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.c4d_vp8_output(self._dec, y.ctypes.data_as(_U8_P), u.ctypes.data_as(_U8_P),
                                 v.ctypes.data_as(_U8_P))
        return y, u, v

    @property
    def tools(self) -> frozenset:
        """The names of the tools (:data:`TOOLS`) the decodes so far used."""
        words = (ctypes.c_ulonglong * 2)()
        self._lib.c4d_vp8_tools(self._dec, words)
        bits = int(words[0]) | int(words[1]) << 64
        return frozenset(t for i, t in enumerate(TOOLS) if bits >> i & 1)

    def reset(self) -> None:
        """Drop the references (before decoding from a key frame)."""
        self._lib.c4d_vp8_reset(self._dec)

    def close(self) -> None:
        if getattr(self, "_dec", None):
            self._lib.c4d_vp8_close(self._dec)
            self._dec = None

    def __del__(self):
        self.close()
