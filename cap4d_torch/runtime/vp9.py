"""ctypes wrapper of the runtime's VP9 decoder (``vp9.cpp``).

The JAX package decodes a VP9 track (``vp09`` in mp4/mov, ``V_VP9`` in
Matroska/WebM, ``VP90`` in an AVI) on the host through cv2, whose ffmpeg
opens its native ``vp9`` decoder; this is the port's counterpart, in the
runtime's library, so it needs no codec library on either machine. It
decodes profile 0 (8-bit 4:2:0): key, inter and intra-only frames,
superframes with hidden frames, show_existing_frame, segmentation, tiles,
lossless, compound prediction and scaled references, bit for bit as
ffmpeg does. It raises ``ValueError`` naming the tool or syntax element
for anything else (profiles 1-3, so high bit depth and other chroma
formats; a frame before the first key frame; an empty reference slot; a
broken stream).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np

from cap4d_torch.runtime.h264 import MATRIX_CODES
from cap4d_torch.runtime.loader import _U8_P, lib

_ERR_BYTES = 512
# VP9 color_space (section 7.2) -> ffmpeg's AVColorSpace, whose matrix cv2's
# swscale applies (MATRIX_CODES; 0 "unknown" and 6 "reserved" map to codes
# that swscale takes as BT.601)
COLOR_SPACE_AVCOL = {0: 2, 1: 5, 2: 1, 3: 6, 4: 7, 5: 9, 6: 3}
# the Tool bits of vp9.cpp, in order
TOOLS = (
    "key_frame", "inter_frame", "intra_only", "hidden_frame", "show_existing_frame", "superframe",
    "error_resilient", "frame_parallel", "refresh_frame_context", "reset_frame_context_0",
    "reset_frame_context_1", "reset_frame_context_2", "reset_frame_context_3",
    "frame_context_idx", "refresh_partial", "refresh_none", "size_change", "odd_size",
    "render_size", "scaled_reference", "color_space", "full_range", "lossless",
    "tx_mode_select", "tx_4x4", "tx_8x8", "tx_16x16", "tx_32x32", "adst", "wht", "compound",
    "reference_select", "switchable_interp", "filter_regular", "filter_smooth", "filter_sharp",
    "filter_bilinear", "high_precision_mv", "prev_frame_mvs", "sub8x8_intra", "sub8x8_inter",
    "nearestmv", "nearmv", "zeromv", "newmv", "intra_in_inter", "segmentation", "seg_temporal",
    "seg_alt_q", "seg_alt_lf", "seg_ref_frame", "seg_skip", "seg_abs_delta", "lf_delta_update",
    "lf_sharpness", "lf_16", "tile_columns", "tile_rows", "delta_q", "probability_updates",
    "mv_updates", "coef_cat6", "adaptation")


class Scan(NamedTuple):
    """What :func:`scan` reads of a sample's frame headers without decoding:
    its frame count (more than one: a superframe), whether the first frame
    is a key frame, whether any frame shows a picture (show_frame or
    show_existing_frame), whether any is an intra-only frame, and the OR of
    the frames' refresh_frame_flags."""

    frames: int
    key: bool
    shows: bool
    intra_only: bool
    refresh: int


def scan(sample: bytes, what: str = "") -> Scan:
    """The headers of ``sample``'s frames (:class:`Scan`); ValueError names
    ``what`` and the reason for a sample that does not parse."""
    info = (ctypes.c_int * 5)()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    if lib().c4d_vp9_scan(sample, len(sample), info, err, _ERR_BYTES) != 0:
        raise ValueError(f"{what}: {err.value.decode(errors='replace')}".lstrip(": "))
    return Scan(int(info[0]), bool(info[1]), bool(info[2]), bool(info[3]), int(info[4]))


class Vp9Decoder:
    """A decoder of one track: :meth:`decode` takes the samples in decode
    order from a key frame on (after :meth:`reset` when it jumps) and
    returns each sample's shown picture as (Y, U, V) uint8 planes of the
    frame's size (which may change from frame to frame), or None when the
    sample shows none (its frames are all hidden). :attr:`matrix` and
    :attr:`full_range` are the colour of the last picture returned.
    :attr:`chroma_location` is None: ffmpeg's ``vp9`` decoder sets none, so
    the container's (Matroska's ChromaSiting) reaches swscale."""

    chroma_location = None

    def __init__(self, name: str = "VP9 stream"):
        self.name = name
        self._lib = lib()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        self._dec = self._lib.c4d_vp9_open(err, _ERR_BYTES)
        if not self._dec:
            raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
        self.matrix, self.full_range = "bt601", False

    def decode(self, sample: bytes, what: str = "") -> Optional[Tuple[np.ndarray, ...]]:
        """One sample (a frame or a superframe) → its shown picture, or None.
        Raises ValueError naming ``what`` (e.g. the frame) and the reason,
        after which the decoder holds no references."""
        info = (ctypes.c_int * 5)()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        where = f"{self.name} {what}".strip()
        if self._lib.c4d_vp9_decode(self._dec, sample, len(sample), info, err, _ERR_BYTES) != 0:
            raise ValueError(f"{where}: {err.value.decode(errors='replace')}")
        if not info[0]:
            return None
        w, h = int(info[1]), int(info[2])
        self.matrix = MATRIX_CODES.get(COLOR_SPACE_AVCOL.get(int(info[3]), 2), "bt601")
        self.full_range = bool(info[4])
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.c4d_vp9_output(self._dec, y.ctypes.data_as(_U8_P), u.ctypes.data_as(_U8_P),
                                 v.ctypes.data_as(_U8_P))
        return y, u, v

    @property
    def tools(self) -> frozenset:
        """The names of the tools (:data:`TOOLS`) the decodes so far used."""
        bits = int(self._lib.c4d_vp9_tools(self._dec))
        return frozenset(t for i, t in enumerate(TOOLS) if bits >> i & 1)

    def reset(self) -> None:
        """Drop the references and all state (before decoding from a key frame)."""
        self._lib.c4d_vp9_reset(self._dec)

    def close(self) -> None:
        if getattr(self, "_dec", None):
            self._lib.c4d_vp9_close(self._dec)
            self._dec = None

    def __del__(self):
        self.close()

