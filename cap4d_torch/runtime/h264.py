"""ctypes wrapper of the runtime's H.264 decoder (``h264.cpp``).

The JAX package decodes H.264 on the host through cv2 (ffmpeg); this is the
port's counterpart, in the runtime's library, so it needs no codec library
on either machine. It decodes I, P and B slices (CAVLC and CABAC, the High
profile's 8x8 transform and scaling matrices, spatial and temporal direct
prediction, explicit and implicit weighted prediction, long-term
references, reference B pictures) of progressive 8-bit 4:2:0 streams, and
raises ``ValueError`` naming the tool or syntax element for anything else
(SP and SI slices, fields, other chroma formats or bit depths, FMO, a
reference the DPB does not hold, a broken stream).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np

from cap4d_torch.runtime.loader import _U8_P, lib

_ERR_BYTES = 512
# matrix_coefficients (H.264 Table E-5) -> nv12_to_rgb's matrix, as cv2's
# swscale maps them (0, 2 and 3: BT.601). swscale refuses 8 (YCgCo), 10 and
# up, and cv2's frames then follow no matrix; the port takes BT.2020 for 10
# and BT.601 for the others
MATRIX_CODES = {1: "bt709", 4: "fcc", 5: "bt601", 6: "bt601", 7: "smpte240m", 9: "bt2020",
                10: "bt2020"}


class Picture(NamedTuple):
    """What :meth:`H264Decoder.decode` reports of the picture it returned:
    its PicOrderCnt, nal_ref_idc, whether it is an IDR picture, and whether
    it holds memory_management_control_operation 5 (the order count starts
    over from it)."""

    poc: int
    nal_ref_idc: int
    idr: bool
    mmco5: bool


class H264Decoder:
    """A decoder of one track: ``avc_config`` is the track's
    :class:`cap4d_torch.data.mp4.AvcConfig` (SPS and PPS with start codes,
    NAL length size). :meth:`decode` takes the samples in decode order from
    a sync sample on (after :meth:`reset` when it jumps), and returns each
    sample's picture as (Y, U, V) uint8 planes of the cropped size; there is
    no output process, so B streams' pictures come in decode order, each
    with its :class:`Picture` in :attr:`picture`. :attr:`dpb_frames` is the
    SPS's max_dec_frame_buffering (None without a VUI bitstream
    restriction). :attr:`chroma_location` is left, ffmpeg's for an SPS
    without chroma_loc_info (the VUI's is not kept: 4:2:0 pictures have
    even heights and take swscale's unscaled converter, which ignores it)."""

    chroma_location = "left"

    def __init__(self, avc_config, name: str = "H.264 stream"):
        self.name = name
        self._lib = lib()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        params = b"".join(avc_config.sps) + b"".join(avc_config.pps)
        self._dec = self._lib.c4d_h264_open(params, len(params), int(avc_config.length_size), err,
                                            _ERR_BYTES)
        if not self._dec:
            raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
        w, h = ctypes.c_int(0), ctypes.c_int(0)
        if self._lib.c4d_h264_size(self._dec, ctypes.byref(w), ctypes.byref(h)) != 0:
            self.close()
            raise ValueError(f"{name}: the avcC holds no sequence parameter set")
        self.width, self.height = w.value, h.value
        full, matrix = ctypes.c_int(0), ctypes.c_int(2)
        self._lib.c4d_h264_colour(self._dec, ctypes.byref(full), ctypes.byref(matrix))
        self.full_range = bool(full.value)
        # the VUI's matrix_coefficients as nv12_to_rgb's name (BT.601 when unspecified)
        self.matrix = MATRIX_CODES.get(matrix.value, "bt601")
        frames = ctypes.c_int(-1)
        self._lib.c4d_h264_buffering(self._dec, ctypes.byref(frames))
        self.dpb_frames = frames.value if frames.value >= 0 else None
        self.picture = None

    def decode(self, sample: bytes, what: str = "") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One sample (an access unit of length-prefixed NAL units) → its
        picture; raises ValueError naming ``what`` (e.g. the frame) and the
        reason, after which the decoder holds no references."""
        y = np.empty((self.height, self.width), np.uint8)
        u = np.empty((self.height // 2, self.width // 2), np.uint8)
        v = np.empty_like(u)
        err = ctypes.create_string_buffer(_ERR_BYTES)
        info = (ctypes.c_int * 4)()
        self.picture = None
        status = self._lib.c4d_h264_decode(self._dec, sample, len(sample), y.ctypes.data_as(_U8_P),
                                           u.ctypes.data_as(_U8_P), v.ctypes.data_as(_U8_P),
                                           self.width, self.height, info, err, _ERR_BYTES)
        if status != 0:
            where = f"{self.name} {what}".strip()
            raise ValueError(f"{where}: {err.value.decode(errors='replace')}")
        self.picture = Picture(info[0], info[1], bool(info[2]), bool(info[3]))
        return y, u, v

    def scan(self, sample: bytes, what: str = "") -> Picture:
        """The :class:`Picture` of one sample from its parameter sets and
        first slice header, without decoding it (the presentation order of
        a container that carries no composition times). Feed every sample
        in decode order to a decoder that decodes nothing else: it keeps the
        order count's state from one sample to the next."""
        err = ctypes.create_string_buffer(_ERR_BYTES)
        info = (ctypes.c_int * 4)()
        if self._lib.c4d_h264_scan(self._dec, sample, len(sample), info, err, _ERR_BYTES) != 0:
            where = f"{self.name} {what}".strip()
            raise ValueError(f"{where}: {err.value.decode(errors='replace')}")
        return Picture(info[0], info[1], bool(info[2]), bool(info[3]))

    def reset(self) -> None:
        """Drop every reference picture (before decoding from a sync sample)."""
        self._lib.c4d_h264_reset(self._dec)

    def close(self) -> None:
        if getattr(self, "_dec", None):
            self._lib.c4d_h264_close(self._dec)
            self._dec = None

    def __del__(self):
        self.close()
