"""ctypes wrapper of the runtime's MPEG-4 Part 2 decoder (``mpeg4.cpp``).

The JAX package decodes an ``mp4v`` track (cv2's ``VideoWriter`` default)
on the host through cv2 (ffmpeg); this is the port's counterpart, in the
runtime's library, so it needs no codec library on either machine. It
decodes rectangular 8-bit 4:2:0 VOPs of the Simple and Advanced Simple
profiles (I-, P- and B-VOPs, 4MV, quarter-sample, MPEG quantisation,
resync markers), with ffmpeg's IDCT, and raises ``ValueError`` naming the
tool or syntax element for anything else (interlace, sprites and GMC, data
partitioning and RVLC, the short video header, scalability, non-rectangular
shapes, newpred, reduced resolution, not_8_bit, the studio profile,
complexity estimation, several VOPs in one sample, a broken stream).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np

from cap4d_torch.runtime.h264 import MATRIX_CODES
from cap4d_torch.runtime.loader import _U8_P, lib

_ERR_BYTES = 512
VOP_TYPES = ("I", "P", "B")


class Vop(NamedTuple):
    """What :meth:`Mpeg4Decoder.decode` reports of the VOP it decoded: its
    time in ticks of vop_time_increment_resolution, its coding type ("I",
    "P" or "B"), whether the Xvid IDCT decoded it (the user data names an
    Xvid build), and its vop_quant (0 when not coded: a not-coded VOP
    repeats the last reference)."""

    time: int
    type: str
    xvid_idct: bool
    quant: int


class Mpeg4Decoder:
    """A decoder of one track: ``dsi`` is the ``esds`` DecoderSpecificInfo
    (the VOS, VO and VOL headers; empty when they come in band).
    :meth:`decode` takes the samples in decode order from a sync sample on
    (after :meth:`reset` when it jumps) and returns each sample's picture as
    (Y, U, V) uint8 planes of the VOL's size, in decode order (a B-VOP after
    the reference that follows it), with its :class:`Vop` in :attr:`vop`.
    :attr:`chroma_location` is left, what ffmpeg's ``mpeg4`` decoder sets on
    every picture whatever the container says (cv2 hands it to swscale)."""

    chroma_location = "left"

    def __init__(self, dsi: bytes, name: str = "MPEG-4 stream"):
        self.name = name
        self._lib = lib()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        self._dec = self._lib.c4d_mpeg4_open(bytes(dsi), len(dsi), err, _ERR_BYTES)
        if not self._dec:
            raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
        self.width = self.height = None
        self.full_range, self.matrix = False, "bt601"
        self._info()
        self.vop = None

    def _info(self) -> bool:
        w, h, full, matrix = (ctypes.c_int(0) for _ in range(4))
        if self._lib.c4d_mpeg4_info(self._dec, ctypes.byref(w), ctypes.byref(h), ctypes.byref(full),
                                    ctypes.byref(matrix)) != 0:
            return False
        self.width, self.height = w.value, h.value
        self.full_range = bool(full.value)
        # the VO's matrix_coefficients as nv12_to_rgb's name (BT.601 when unspecified)
        self.matrix = MATRIX_CODES.get(matrix.value, "bt601")
        return True

    def decode(self, sample: bytes, what: str = "",
               size: Tuple[int, int] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One sample (a VOP, with any headers before it) → its picture;
        ``size`` (width, height) is the track's when the VOL comes in band.
        Raises ValueError naming ``what`` (e.g. the frame) and the reason,
        after which the decoder holds no references."""
        where = f"{self.name} {what}".strip()
        if self.width is None:
            if size is None:
                raise ValueError(f"{where}: no VOL header before the first VOP")
            self.width, self.height = size
        w, h = self.width, self.height
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        err = ctypes.create_string_buffer(_ERR_BYTES)
        info = (ctypes.c_longlong * 4)()
        self.vop = None
        status = self._lib.c4d_mpeg4_decode(self._dec, sample, len(sample), y.ctypes.data_as(_U8_P),
                                            u.ctypes.data_as(_U8_P), v.ctypes.data_as(_U8_P), w, h,
                                            info, err, _ERR_BYTES)
        if status != 0:
            raise ValueError(f"{where}: {err.value.decode(errors='replace')}")
        self._info()
        self.vop = Vop(int(info[0]), VOP_TYPES[info[1]], bool(info[2]), int(info[3]))
        return y, u, v

    def scan(self, data: bytes, what: str = "") -> Tuple[str, bool]:
        """The coding type ("I", "P", "B") and vop_coded of the first VOP in
        ``data`` (a sample or its first bytes), without decoding it; ("", False)
        when ``data`` holds no VOP. Use a decoder that decodes nothing else:
        the headers before the VOP (a VOL in band) are taken."""
        t, coded = ctypes.c_int(-1), ctypes.c_int(0)
        err = ctypes.create_string_buffer(_ERR_BYTES)
        where = f"{self.name} {what}".strip()
        if self._lib.c4d_mpeg4_scan(self._dec, data, len(data), ctypes.byref(t),
                                    ctypes.byref(coded), err, _ERR_BYTES) != 0:
            raise ValueError(f"{where}: {err.value.decode(errors='replace')}")
        self._info()
        if t.value == 3:
            raise ValueError(f"{where}: an S-VOP (sprite) is not supported")
        return ("", False) if t.value < 0 else (VOP_TYPES[t.value], bool(coded.value))

    def reset(self) -> None:
        """Drop the reference VOPs and the times (before decoding from a sync
        sample)."""
        self._lib.c4d_mpeg4_reset(self._dec)

    def close(self) -> None:
        if getattr(self, "_dec", None):
            self._lib.c4d_mpeg4_close(self._dec)
            self._dec = None

    def __del__(self):
        self.close()
