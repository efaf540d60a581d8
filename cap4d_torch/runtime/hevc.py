"""ctypes wrapper of the runtime's HEVC decoder (``hevc.cpp``).

The JAX package decodes an HEVC track (``hvc1``/``hev1`` in mp4/mov,
``V_MPEGH/ISO/HEVC`` in Matroska, ``HEVC``/``H265`` in an AVI) on the host
through cv2, whose ffmpeg opens its native ``hevc`` decoder; this is the
port's counterpart, in the runtime's library, so it needs no codec library
on either machine. It decodes Main and Main Still Picture streams (8-bit
4:2:0): I, P and B slices (merge, AMVP, TMVP, weighted prediction, the
RPS-driven DPB with long-term pictures and list modifications, temporal
sub-layers), bit for bit as ffmpeg does, a RASL picture of the CRA or BLA
picture that began decoding giving no picture, as ffmpeg discards it. Its
header scan reports each sample's TemporalId and replays ffmpeg's output
process, so that the pictures an IRAP picture's
no_output_of_prior_pics_flag discards show nowhere. It raises
``ValueError`` naming the tool or syntax element for anything else: other
profiles, chroma formats and bit depths (Main 10), the range, multilayer,
3D and screen content extensions, field coding, P and B slices in an IRAP
picture, a picture predicting from one the DPB does not hold, a broken
stream.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np

from cap4d_torch.runtime.h264 import MATRIX_CODES
from cap4d_torch.runtime.loader import _U8_P, lib

_ERR_BYTES = 512
# the Tool bits of hevc.cpp, in order
TOOLS = (
    "idr", "cra", "bla", "trail", "radl", "rasl_skipped", "ctb16", "ctb32", "ctb64",
    "tiles_uniform", "tiles_explicit", "wpp", "dependent_slices", "slices", "scaling_default",
    "scaling_sps", "scaling_pps", "scaling_pred", "pcm", "pcm_no_filter", "bypass",
    "transform_skip", "sign_hiding", "cu_qp_delta", "chroma_qp_offset", "slice_chroma_qp_offset",
    "sao_band", "sao_edge", "sao_merge", "deblock", "deblock_disabled", "deblock_override",
    "no_filter_across_slices", "no_filter_across_tiles", "constrained_intra",
    "strong_smoothing", "intra_nxn", "tu4", "tu8", "tu16", "tu32", "conformance_window", "vui",
    "full_range", "rps_syntax", "long_term_syntax", "entry_points", "header_extension",
    "poc_reorder", "min_cb16", "hrd", "output_flag", "planar", "dc", "angular", "chroma_dm",
    # inter pictures
    "p_slice", "b_slice", "skip", "merge", "amvp", "tmvp", "amp", "inter_nxn", "bi_pred",
    "bi_to_uni", "parallel_merge", "no_residual", "weighted_pred", "weighted_bipred",
    "long_term_ref", "list_modification", "missing_ref", "temporal_layers", "cabac_init_flag",
    "mvd_l1_zero", "mv_outside", "cip_inter", "discard_prior")
# chroma_sample_loc_type_top_field -> ffmpeg's chroma location (its AVChromaLocation - 1)
CHROMA_LOCATIONS = {0: "left", 1: "center", 2: "topleft", 3: "top", 4: "bottomleft",
                    5: "bottom"}


class Picture(NamedTuple):
    """What :meth:`HevcDecoder.decode` and :meth:`HevcDecoder.scan` report of
    a sample: its NAL unit type, whether it is an IRAP picture, its picture
    order count, whether it shows a picture (pic_output_flag, and not a
    RASL picture ffmpeg discards) and its TemporalId."""

    nal_type: int
    irap: bool
    poc: int
    shows: bool
    temporal_id: int


class HevcDecoder:
    """A decoder of one track: ``params`` are the configuration's parameter
    sets as Annex-B NAL units (``HvcConfig.params``; may be empty when they
    come in band), ``length_size`` the bytes of each sample's NAL length.
    :meth:`decode` takes the samples in decode order from an IRAP sample on
    (after :meth:`reset` when it jumps) and returns each sample's picture as
    (Y, U, V) uint8 planes of the conformance window, or None when it shows
    none; pictures come in decode order with their :class:`Picture` in
    :attr:`picture`. :attr:`matrix`, :attr:`full_range` and
    :attr:`chroma_location` are the active SPS's VUI as ffmpeg's ``hevc``
    decoder sets them (BT.601, limited range and left without one);
    :attr:`dpb_frames` is sps_max_dec_pic_buffering (None before an SPS)."""

    def __init__(self, params: Tuple[bytes, ...] = (), length_size: int = 4,
                 name: str = "HEVC stream"):
        self.name = name
        self._lib = lib()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        blob = b"".join(params)
        self._dec = self._lib.c4d_hevc_open(blob, len(blob), int(length_size), err, _ERR_BYTES)
        if not self._dec:
            raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
        self.matrix, self.full_range, self.chroma_location = "bt601", False, "left"
        self.picture: Optional[Picture] = None
        self.discarded: Tuple[int, ...] = ()
        self._colour(2, 0, -1)

    def _colour(self, matrix: int, full: int, loc: int) -> None:
        self.matrix = MATRIX_CODES.get(matrix, "bt601")
        self.full_range = bool(full)
        self.chroma_location = CHROMA_LOCATIONS.get(loc, "left")

    @property
    def dpb_frames(self) -> Optional[int]:
        dpb, reorder = ctypes.c_int(-1), ctypes.c_int(-1)
        self._lib.c4d_hevc_buffering(self._dec, ctypes.byref(dpb), ctypes.byref(reorder))
        return dpb.value if dpb.value >= 0 else None

    def decode(self, sample: bytes, what: str = "") -> Optional[Tuple[np.ndarray, ...]]:
        """One sample (an access unit of length-prefixed NAL units) → its
        picture, or None; raises ValueError naming ``what`` (e.g. the frame)
        and the reason, after which the decoder holds no POC state."""
        info = (ctypes.c_int * 10)()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        self.picture = None
        if self._lib.c4d_hevc_decode(self._dec, sample, len(sample), info, err, _ERR_BYTES) != 0:
            where = f"{self.name} {what}".strip()
            raise ValueError(f"{where}: {err.value.decode(errors='replace')}")
        self._colour(int(info[6]), int(info[7]), int(info[8]))
        self.picture = Picture(int(info[4]), bool(info[5]), int(info[3]), bool(info[0]),
                               int(info[9]))
        if not info[0]:
            return None
        w, h = int(info[1]), int(info[2])
        y = np.empty((h, w), np.uint8)
        u = np.empty((h // 2, w // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.c4d_hevc_output(self._dec, y.ctypes.data_as(_U8_P), u.ctypes.data_as(_U8_P),
                                  v.ctypes.data_as(_U8_P))
        return y, u, v

    def scan(self, sample: bytes, what: str = "") -> Picture:
        """The :class:`Picture` of one sample from its parameter sets and
        first slice header, without decoding it (the presentation order of
        a container without times). Feed every sample in decode order to a
        decoder that decodes nothing else: it keeps the POC state and a
        model of ffmpeg's DPB, whose output process sets :attr:`discarded`:
        the samples (counted from 0, the first scanned) whose pictures this
        sample's IRAP picture discards before they are output
        (no_output_of_prior_pics_flag), so that they show nowhere."""
        info = (ctypes.c_int * 6)()
        err = ctypes.create_string_buffer(_ERR_BYTES)
        self.discarded = ()
        if self._lib.c4d_hevc_scan(self._dec, sample, len(sample), info, err, _ERR_BYTES) != 0:
            where = f"{self.name} {what}".strip()
            raise ValueError(f"{where}: {err.value.decode(errors='replace')}")
        if info[0] < 0:
            raise ValueError(f"{self.name} {what}: the sample holds no slice".strip())
        if info[5]:
            out = (ctypes.c_int * int(info[5]))()
            n = self._lib.c4d_hevc_discarded(self._dec, out, int(info[5]))
            self.discarded = tuple(int(v) for v in out[:n])
        return Picture(int(info[0]), bool(info[1]), int(info[2]), bool(info[3]), int(info[4]))

    @property
    def tools(self) -> frozenset:
        """The names of the tools (:data:`TOOLS`) the decodes so far used."""
        words = (ctypes.c_ulonglong * 2)()
        self._lib.c4d_hevc_tools(self._dec, words)
        bits = int(words[0]) | int(words[1]) << 64
        return frozenset(t for i, t in enumerate(TOOLS) if bits >> i & 1)

    def reset(self) -> None:
        """Forget the POC and RASL state and the reference pictures (before
        decoding from an IRAP sample)."""
        self._lib.c4d_hevc_reset(self._dec)

    def close(self) -> None:
        if getattr(self, "_dec", None):
            self._lib.c4d_hevc_close(self._dec)
            self._dec = None

    def __del__(self):
        self.close()
