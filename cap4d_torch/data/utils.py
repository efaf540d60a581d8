"""Host-side image, crop and camera-ray helpers (numpy only).

Counterpart of ``cap4d_tpu/data/utils.py``. The card machine has no ``cv2``,
so ``rescale_image`` carries numpy copies of OpenCV's ``INTER_AREA``
(fractional-overlap box weights rounded to float32, ``computeResizeAreaTab``)
and ``INTER_LINEAR`` (half-pixel centres, clamped borders), and
frames (PNG or JPEG) are decoded by the port's native runtime
(``cap4d_torch/runtime``). Video files are read by :class:`VideoFrameReader`
(the port's own demuxers, chosen by content in ``data/container.py``:
mp4/mov, AVI and Matroska/WebM; Motion-JPEG, PNG, H.264, HEVC Main,
MPEG-4 Part 2, VP8 and VP9 decode on the host through the runtime).
"""

from __future__ import annotations

import bisect
import functools
import struct
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from cap4d_torch.data.container import read_track
from cap4d_torch.data.mp4 import slice_ref_idc
from cap4d_torch.runtime.h264 import H264Decoder
from cap4d_torch.runtime.hevc import HevcDecoder
from cap4d_torch.runtime.loader import MjpegDecoder, decode_bytes, decode_image
from cap4d_torch.runtime.mpeg4 import Mpeg4Decoder
from cap4d_torch.runtime.nvdec import CHROMA_POSITIONS, to_host, yuv_to_rgb
from cap4d_torch.runtime import vp8
from cap4d_torch.runtime.vp9 import Vp9Decoder, scan

CROP_MARGIN = 0.2


def crop_image(img: np.ndarray, crop_box: np.ndarray, bg_value=0) -> np.ndarray:
    """Crop with out-of-bounds padding at bg_value."""
    img_h, img_w = img.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in crop_box[:4])
    out = np.ones((y1 - y0, x1 - x0, *img.shape[2:]), dtype=img.dtype) * bg_value
    ix0, ix1 = min(max(x0, 0), img_w), min(max(x1, 0), img_w)
    iy0, iy1 = min(max(y0, 0), img_h), min(max(y1, 0), img_h)
    if ix1 > ix0 and iy1 > iy0:
        out[iy0 - y0 : iy1 - y0, ix0 - x0 : ix1 - x0, ...] = img[iy0:iy1, ix0:ix1, ...]
    return out


def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of OpenCV's INTER_AREA for a downscale."""
    scale = 1.0 / (dsize / ssize)
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            w[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def _linear_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) weights of OpenCV's INTER_LINEAR."""
    scale = 1.0 / (dsize / ssize)
    w = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fx = (dx + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        fx = fx - sx
        if sx < 0:
            fx, sx = 0.0, 0
        if sx >= ssize - 1:
            fx, sx = 0.0, ssize - 1
        w[dx, sx] += 1.0 - fx
        if fx != 0:
            w[dx, sx + 1] += fx
    return w


def rescale_image(img: np.ndarray, target_resolution: int) -> np.ndarray:
    """Square resize: area weights to shrink, bilinear to enlarge.

    Like ``cv2.resize`` it drops a trailing singleton channel axis. Float
    inputs are resized in float64 and returned in their dtype; integer inputs
    are rounded (OpenCV's fixed-point rounding may differ by one there).
    """
    h, w = img.shape[:2]
    weights = _area_weights if target_resolution < h else _linear_weights
    wy = weights(h, target_resolution)
    wx = weights(w, target_resolution)
    x = img.astype(np.float64)
    if x.ndim == 3 and x.shape[2] == 1:
        x = x[..., 0]
    out = np.einsum("yh,hw...->yw...", wy, x)
    out = np.einsum("xw,yw...->yx...", wx, out)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)
    return out.astype(img.dtype)


def apply_bg(img: np.ndarray, bg_weights: np.ndarray,
             bg_color: np.ndarray = np.array([255, 255, 255])) -> np.ndarray:
    w = bg_weights / 255.0
    return bg_color[None, None] * (1.0 - w) + img * w


def verts_to_pytorch3d(verts_2d: np.ndarray, crop_box: np.ndarray) -> np.ndarray:
    """Pixel coords → crop-relative pytorch3d NDC [-1,1], x/y negated."""
    out = verts_2d.copy()
    out[..., 0] = -((verts_2d[..., 0] - crop_box[..., 0]) / (crop_box[..., 2] - crop_box[..., 0]) * 2.0 - 1.0)
    out[..., 1] = -((verts_2d[..., 1] - crop_box[..., 1]) / (crop_box[..., 3] - crop_box[..., 1]) * 2.0 - 1.0)
    return out


def get_square_bbox(bbox: np.ndarray, border_margin: float = 0.1, mode: str = "max"):
    bbox = bbox.astype(int)
    bbox_h = bbox[3] - bbox[1]
    bbox_w = bbox[2] - bbox[0]
    center = ((bbox[2] + bbox[0]) // 2, (bbox[3] + bbox[1]) // 2)
    side = max(bbox_h, bbox_w) if mode == "max" else min(bbox_h, bbox_w)
    dim = int(side // 2.0 * (1.0 + border_margin))
    return (center[0] - dim, center[1] - dim, center[0] + dim, center[1] + dim)


def get_bbox_from_verts(verts_2d: np.ndarray, vert_mask: np.ndarray) -> np.ndarray:
    head = verts_2d[vert_mask]
    bbox = [head[..., 0].min(), head[..., 1].min(), head[..., 0].max(), head[..., 1].max()]
    return np.array(get_square_bbox(np.array(bbox), border_margin=CROP_MARGIN))


def load_camera_rays(crop_box, intr, extr, target_resolution: int) -> np.ndarray:
    """World-space unit ray directions of the crop-adjusted camera (3,H,W)."""
    scale = target_resolution / (crop_box[2] - crop_box[0])
    new_fx = intr[0, 0] * scale
    new_fy = intr[1, 1] * scale
    new_cx = (intr[0, 2] - crop_box[0]) * scale
    new_cy = (intr[1, 2] - crop_box[1]) * scale
    u, v = np.meshgrid(np.arange(target_resolution), np.arange(target_resolution))
    d = np.stack(((u - new_cx) / new_fx, (v - new_cy) / new_fy, np.ones_like(u)), axis=0)
    d = d / (np.linalg.norm(d, axis=0, keepdims=True) + 1e-8)
    h = d.shape[1]
    d = np.linalg.inv(extr[:3, :3]) @ d.reshape(3, -1)
    return d.reshape(3, h, -1)


class VideoFrameReader:
    """The frames of an mp4/mov, AVI or Matroska/WebM file, RGB uint8 (H, W,
    3) by frame index in presentation order (the JAX package's cv2 reader,
    same name, ``len`` and indexing: ``len`` is cv2's CAP_PROP_FRAME_COUNT,
    frame k what cv2's seek to k reads).

    Motion-JPEG, PNG, H.264, HEVC, MPEG-4 Part 2, VP8 and VP9 samples decode
    on the host through the runtime, whatever ``device`` is; the RGB
    conversion of all but PNG runs on ``device`` (the CPU when None).
    Motion-JPEG (``runtime/loader.py``'s :class:`MjpegDecoder`: the planes
    ffmpeg's ``mjpeg`` decoder gives, through libavcodec's simple IDCT,
    full-range BT.601), H.264 (``runtime/h264.py``: I, P and B slices, CAVLC
    and CABAC, progressive 8-bit 4:2:0), HEVC (``runtime/hevc.py``: Main
    and Main Still Picture streams, I, P and B slices, ``hvc1``/``hev1``,
    ``V_MPEGH/ISO/HEVC``, ``HEVC``/``H265``; a RASL picture of the stream's
    first CRA, a picture with pic_output_flag 0 and one a later IRAP
    picture's no_output_of_prior_pics_flag discards show no frame, as in
    ffmpeg; a later CRA's RASL picture decodes from the sync sample before
    that CRA, where cv2's seek lands),
    MPEG-4 Part 2 (``runtime/mpeg4.py``:
    Simple and Advanced Simple profile VOPs, ``mp4v`` with object type
    0x20), VP8 (``runtime/vp8.py``: ``vp08``, ``V_VP8``, ``VP80``) and VP9
    (``runtime/vp9.py``: profile 0, ``vp09``, ``V_VP9``, ``VP90``) share one
    path, :meth:`planes`, and are read as cv2 counts frames: frame k is the
    sample ``order[k]`` (``ctts`` order, the edit list applied, a
    fragmented mp4's runs read as ffmpeg reads them; Matroska's
    block times; in an AVI, which carries no times, H.264's and HEVC's picture
    order count from a header scan, for MPEG-4 ffmpeg's output order: each anchor
    VOP after the B-VOPs that follow it in the file, and for VP8 and VP9
    decode order), decoded from the last sync sample at or before it, or
    onward from where the decoder stands when that lies between the two.
    Pictures decoded on the way that show later are held (by decode index,
    at most the SPS's max_dec_frame_buffering, 16 without one, for H.264;
    4 for MPEG-4), so a sequential read decodes each sample once; a random
    read skips the samples nothing refers to (non-reference H.264 pictures,
    B-VOPs, HEVC sub-layer non-reference pictures at the stream's highest
    TemporalId) that show before its frame. Within a run of decoding, the order
    of the stream's own clock (H.264's picture order count, the VOP times)
    must be the order by the container's presentation times, where it has
    them, else ``ValueError`` names both frames and both orders. A
    not-coded MPEG-4 VOP (vop_coded 0) gives
    ffmpeg no picture, so cv2 reads one frame fewer for each: frame k is the
    k-th coded VOP, ``len`` stays cv2's count, and the frames past the
    last coded VOP raise ``IndexError``, as cv2's reader does; a VP9 sample
    whose frames are all hidden (show_frame 0), and a hidden VP8 frame
    (libvpx's alt-ref), count as such a VOP, while a VP9 superframe's
    hidden frames beside a shown one and a show_existing_frame sample each
    give the picture they show. cv2 converts every picture with swscale to
    the stream's size, and so does the port (``runtime/nvdec.py``'s
    :func:`yuv_to_rgb`): the unscaled converter for 4:2:0 and 4:2:2 at the
    stream's size with an even height, else a copy of swscale's bicubic
    scaler (an odd height, a VP8 or VP9 frame coded at another size) at the
    chroma siting cv2 hands swscale (left for MPEG-4 Part 2, whose ffmpeg
    decoder sets it on every picture; a Matroska track's ChromaSiting for
    VP8 and VP9; swscale's default for the rest), each bit for bit. cv2's
    count may differ from the frames it reads (AVI's ``dwLength``,
    Matroska's duration times its frame rate, an mp4 edit list that shows
    fewer frames than the samples, a fragmented mp4's duration times its
    frame rate, a recording cut short): frames past them raise
    ``IndexError``, as cv2's read does; a
    Matroska file without a duration gets a negative count from cv2, so
    ``len`` raises ``ValueError`` as Python's ``len`` does on the JAX
    reader, while indexing still reads its frames. The planes convert with
    the matrix and range the stream signals (H.264's VUI, MPEG-4's
    video_signal_type, VP9's color_space and color_range, VP8's
    clamping_type, which ffmpeg reads as the range; BT.601 and limited
    range without one), as cv2 converts them. A stream the decoder does not
    take raises ``ValueError`` naming the file, the frame and the tool or
    syntax element. An open GOP's leading picture (decoded after a sync
    sample, shown before it) read from that sync sample raises the
    missing-reference error and returns no picture; on the way to a later
    frame it is decoded as any other. A VP9 stream the decoder does not
    take (profiles 1-3, high bit depth) raises ``ValueError`` naming the
    tool on every device; nothing hands it to NVDEC. Other codecs raise
    ``ValueError`` naming the four-character code or CodecID. No file
    handle stays open between reads.

    Frames come out as cv2 hands them: turned clockwise by the track's
    rotation (``VideoTrack.rotation``: an mp4/mov display matrix, a
    Matroska projection roll) on ``device``, after the RGB conversion, so a
    portrait phone video reads upright, (W, H, 3); ``len`` does not
    change."""

    # the longest prefix of a sample read to find its VOP header
    SCAN_BYTES = 4096

    def __init__(self, video_path, device=None):
        self.path = Path(video_path)
        self.track = read_track(self.path)
        t = self.track
        # where the RGB conversion runs (the CPU when None)
        self._device = torch.device("cpu") if device is None else torch.device(device)
        self._h264 = self._mpeg4 = self._vp9 = self._vp8 = self._mjpeg = self._hevc = None
        self._order = t.order
        self._chroma_pos = None
        self._count = len(t) if t.frame_count is None else t.frame_count
        if t.codec in ("h264", "hevc", "mpeg4", "vp9", "vp8", "mjpeg"):
            if t.codec == "mjpeg":
                self._mjpeg = MjpegDecoder(str(self.path))
                self._hold_max = 0     # every sample is a picture of its own
            elif t.codec == "vp8":
                self._vp8 = vp8.Vp8Decoder(str(self.path))
                self._hold_max = 0     # pictures show in decode order
                self._scan_shown(lambda data, what: vp8.scan(data, what).shows)
            elif t.codec == "h264":
                self._h264 = H264Decoder(t.avc, str(self.path))
                self._hold_max = self._h264.dpb_frames or 16
                if not t.timed:
                    self._scan_pictures()
            elif t.codec == "hevc":
                self._hevc = HevcDecoder(t.hvc.params, t.hvc.length_size, str(self.path))
                self._scan_hevc()
                self._hold_max = self._hold_frames or 16
            elif t.codec == "mpeg4":
                self._mpeg4 = Mpeg4Decoder(t.m4v.dsi, str(self.path))
                self._hold_max = 4
                self._scan_vops()
            else:
                self._vp9 = Vp9Decoder(str(self.path))
                self._hold_max = 0     # pictures show in decode order
                self._scan_shown(lambda data, what: scan(data, what).shows)
            # the chroma siting cv2 hands swscale: the decoder's (ffmpeg's
            # decoders set it, but for VP8 and VP9), else the container's;
            # centre it leaves at swscale's default (Motion-JPEG: the same
            # RGB in every sampling layout, tests/test_torch_swscale.py)
            loc = self._decoder.chroma_location or t.chroma_location
            self._chroma_pos = None if loc in (None, "center") else CHROMA_POSITIONS[loc]
            self._frame_of = np.full(len(t), -1, np.int64)   # -1: not shown
            self._frame_of[self._order] = np.arange(len(self._order))
            # presentation times: the container's, else each sample's place
            self._pts = t.pts if t.timed else np.where(self._frame_of >= 0, self._frame_of,
                                                       len(t))
            self._next = None      # the decode index the decoder would take next
            self._origin = 0       # composition time of the sync sample decoding started at
            self._last = None      # (decode index, planes) of the last picture returned
            self._held = {}        # decode index -> planes, decoded and not yet shown
            self._run = []         # ((epoch, order count), pts, decode index) since the reset
            self._epoch = 0        # IDR pictures and MMCO 5 start a new order count
            self._lock = threading.Lock()

    def _scan_shown(self, shows_picture) -> None:
        """Each sample's frame headers (``runtime/vp9.py``'s or
        ``runtime/vp8.py``'s scan, which decodes nothing): frames are the
        samples that show a picture, in presentation order (decode order in
        an AVI)."""
        t = self.track
        shows = np.zeros(len(t), bool)
        for j in range(len(t)):
            # the whole sample: a VP9 superframe's index is at its end
            shows[j] = shows_picture(t.sample(j), f"{self.path} sample {j}")
        self._order = t.order[shows[t.order]] if t.timed else np.flatnonzero(shows)

    def _scan_vops(self) -> None:
        """Each sample's VOP coding type and vop_coded, read from its header
        (a decoder of its own, so the reading one keeps its state); frames
        are the coded VOPs in presentation order."""
        t = self.track
        scanner = Mpeg4Decoder(t.m4v.dsi, str(self.path))
        self._vop_type = np.empty(len(t), "<U1")
        coded = np.ones(len(t), bool)
        for j in range(len(t)):
            data = t.sample(j, self.SCAN_BYTES)
            kind, coded[j] = scanner.scan(data, f"sample {j}")
            if not kind and len(data) < int(t.sizes[j]):
                kind, coded[j] = scanner.scan(t.sample(j), f"sample {j}")
            if not kind:
                raise ValueError(f"{self.path}: sample {j} holds no VOP")
            self._vop_type[j] = kind
        scanner.close()
        if t.timed:
            self._order = t.order[coded[t.order]]
            return
        # ffmpeg's output order without container times: a B-VOP shows at
        # once, an anchor when the next anchor arrives
        order, anchor = [], None
        for j in np.flatnonzero(coded):
            if self._vop_type[j] == "B":
                order.append(j)
            else:
                if anchor is not None:
                    order.append(anchor)
                anchor = j
        self._order = np.array(order + ([anchor] if anchor is not None else []), np.int64)

    def _scan_pictures(self) -> None:
        """The presentation order of an H.264 track whose container has no
        times: each sample's picture order count from its parameter sets
        and first slice header (a decoder of its own, which decodes none),
        the order count starting over at IDR pictures and MMCO 5."""
        t = self.track
        scanner = H264Decoder(t.avc, str(self.path))
        keys, epoch = [], 0
        for j in range(len(t)):
            data = t.sample(j, self.SCAN_BYTES)
            try:
                pic = scanner.scan(data, f"sample {j}")
            except ValueError:       # the header may run past the bytes read
                full = t.sample(j)
                if full == data:
                    raise
                pic = scanner.scan(full, f"sample {j}")
            if (pic.idr and j) or pic.mmco5:
                epoch += 1
            keys.append((epoch, pic.poc, j))
        scanner.close()
        self._order = np.array([j for _, _, j in sorted(keys)], np.int64)

    def _scan_hevc(self) -> None:
        """Each sample's NAL type, TemporalId, POC and whether it shows, from
        its first slice header (a decoder of its own, which decodes none):
        frames are the samples that show a picture (not a RASL picture of
        the CRA that starts the stream, not pic_output_flag 0, not one an
        IRAP picture's no_output_of_prior_pics_flag discards before ffmpeg
        outputs it), in presentation order; in an AVI by picture order
        count, which starts over at IDR and BLA pictures."""
        t = self.track
        scanner = HevcDecoder(t.hvc.params, t.hvc.length_size, str(self.path))
        self._nal_type = np.zeros(len(t), np.int64)
        self._tid = np.zeros(len(t), np.int64)
        shows = np.zeros(len(t), bool)
        keys, epoch = [], 0
        for j in range(len(t)):
            data = t.sample(j, self.SCAN_BYTES)
            try:
                pic = scanner.scan(data, f"sample {j}")
            except ValueError:       # the header may run past the bytes read
                full = t.sample(j)
                if full == data:
                    raise
                pic = scanner.scan(full, f"sample {j}")
            if j and pic.nal_type in (16, 17, 18, 19, 20):     # BLA, IDR: NoRaslOutputFlag
                epoch += 1
            self._nal_type[j], shows[j], self._tid[j] = pic.nal_type, pic.shows, pic.temporal_id
            shows[list(scanner.discarded)] = False
            keys.append((epoch, pic.poc, j))
        self._top_tid = int(self._tid.max()) if len(t) else 0
        self._hold_frames = scanner.dpb_frames
        scanner.close()
        if t.timed:
            self._order = t.order[shows[t.order]]
        else:
            self._order = np.array([j for _, _, j in sorted(keys) if shows[j]], np.int64)

    def __len__(self) -> int:
        if self._count < 0:
            raise ValueError(
                f"{self.path}: cv2 gives this file a negative frame count ({self._count}): "
                "ffmpeg knows no duration for it (a Matroska file without Info/Duration), so "
                "the JAX reader has no length; its frames read by index")
        return self._count

    @property
    def _decoder(self):
        return next((d for d in (self._h264, self._hevc, self._mpeg4, self._vp9, self._vp8,
                                 self._mjpeg) if d is not None), None)

    def __getitem__(self, index: int) -> np.ndarray:
        if self._decoder is None:
            if not 0 <= index < len(self._order):
                raise IndexError(self._no_picture(index))
            sample = int(self._order[index])
            rgb = decode_bytes(self.track.sample(sample), f"{self.path} frame {index}",
                               (self.track.height, self.track.width))
            return to_host(torch.from_numpy(rgb), self.track.rotation)
        y, u, v = (None if p is None else torch.from_numpy(p).to(self._device)
                   for p in self.planes(index))
        dec = self._decoder
        return yuv_to_rgb(y, u, v, self.track.height, self.track.width, dec.matrix,
                          dec.full_range, self._chroma_pos, self.track.rotation)

    def _no_picture(self, index: int) -> str:
        """Why cv2's read of frame ``index`` fails (its count may exceed the
        frames it reads), for the IndexError."""
        t, n, shown = self.track, len(self.track), len(self._order)
        why = []
        if len(t.order) != n:
            why.append(f"the edit list (or a fragment's times or the end of the file) shows "
                       f"{len(t.order)} of its {n} samples")
        if shown < len(t.order):
            what = ("are not-coded VOPs (vop_coded 0)" if self._mpeg4 is not None else
                    "are RASL pictures of the stream's first CRA, have pic_output_flag 0 or "
                    "are discarded by a later IRAP picture's no_output_of_prior_pics_flag"
                    if self._hevc is not None else "hold only hidden frames (show_frame 0)")
            why.append(f"{len(t.order) - shown} {what}, which give ffmpeg no picture")
        return (f"{self.path} frame {index}: cv2 reads {shown} frames of this file "
                f"({'; '.join(why) or 'no frame past the last'}), though it counts {self._count}")

    def h264_planes(self, index: int):
        """Frame ``index`` of an H.264 track as its decoded (Y, U, V) uint8
        planes."""
        if self._h264 is None:
            raise ValueError(f"{self.path} is not an H.264 track ({self.track.codec})")
        return self.planes(index)

    def planes(self, index: int):
        """Frame ``index`` of a Motion-JPEG, H.264, HEVC, MPEG-4, VP8 or VP9
        track as its decoded (Y, U, V) uint8 planes (U and V None for a
        greyscale JPEG)."""
        if self._decoder is None:
            raise ValueError(f"{self.path} is a {self.track.codec} track, which decodes to RGB "
                             "only")
        t = self.track
        if not 0 <= index < len(self._order):
            raise IndexError(self._no_picture(index))
        sample = int(self._order[index])
        with self._lock:
            if self._last is not None and self._last[0] == sample:
                return self._last[1]
            planes = self._held.pop(sample, None)
            if planes is None:
                syncs = np.flatnonzero(t.sync[:sample + 1])
                sync = int(syncs[-1]) if len(syncs) else 0
                if self._hevc is not None and self._nal_type[sample] in (8, 9) and len(syncs) > 1:
                    # a RASL picture: ffmpeg discards it when decoding starts at its
                    # CRA, so start at the sync sample before (cv2's seek lands there)
                    sync = int(syncs[-2])
                if self._next is None or not sync <= self._next <= sample:
                    self._restart()
                    self._next, self._origin = sync, int(self._pts[sync])
                try:
                    while self._next <= sample:
                        j, self._next = self._next, self._next + 1
                        shown = self._frame_of[j]
                        if j == sample and self._pts[j] < self._origin and self._hevc is None:
                            # an open GOP's leading picture, decoded from the
                            # sync sample after it: its references lie before
                            raise ValueError(
                                f"{self.path} frame {index} (sample {j}): a leading picture of "
                                f"the open GOP at sync sample {sync} refers to pictures before "
                                f"it (a reference the {'DPB' if self._h264 else 'decoder'} does "
                                f"not hold); reading it from the GOP before is not supported")
                        if j < sample and 0 <= shown < index and self._unreferenced(j):
                            continue          # shown before this frame; nothing refers to it
                        got = self._decode(j, f"frame {index} (sample {j})")
                        if j == sample and got is None:
                            raise ValueError(
                                f"{self.path} frame {index} (sample {j}): the sample gives no "
                                f"picture when decoding starts at sync sample {sync} (a RASL "
                                "picture whose CRA is the file's first sync sample)")
                        if j == sample:
                            planes = got
                        elif shown > index:
                            self._hold(j, got)
                except ValueError:
                    self._restart()
                    raise
            self._last = (sample, planes)
            return planes

    def _unreferenced(self, j: int) -> bool:
        """Sample ``j`` holds a picture no other refers to."""
        if self._h264 is not None:
            return slice_ref_idc(self.track.sample(j), self.track.avc.length_size) == 0
        if self._mpeg4 is not None:
            return self._vop_type[j] == "B"
        if self._hevc is not None:
            # a sub-layer non-reference picture at the stream's highest TemporalId:
            # pictures of its own sub-layer do not refer to it, and none lies above
            # (one below the highest may be a reference of a higher sub-layer)
            return (self._nal_type[j] < 16 and self._nal_type[j] % 2 == 0
                    and self._tid[j] == self._top_tid)
        return False    # a VP8 or VP9 frame leaves probabilities and segments to the next

    def _restart(self) -> None:
        self._decoder.reset()
        self._next, self._last = None, None
        self._held.clear()
        self._run.clear()
        self._epoch = 0

    def _hold(self, j: int, planes) -> None:
        self._held[j] = planes
        if len(self._held) > self._hold_max:     # drop the one shown last
            del self._held[max(self._held, key=lambda k: self._frame_of[k])]

    def _decode(self, j: int, what: str):
        """Decode sample ``j``, and hold its place on the stream's clock (its
        picture order count, its VOP time) against the presentation times of
        the run's pictures."""
        t = self.track
        if self._h264 is not None:
            planes = self._h264.decode(t.sample(j), what)
            pic = self._h264.picture
            if (pic.idr and self._run) or pic.mmco5:
                self._epoch += 1
            key, clock = (self._epoch, pic.poc), "picture order count"
        elif self._hevc is not None:
            planes = self._hevc.decode(t.sample(j), what)
            pic = self._hevc.picture
            if pic.nal_type in (16, 17, 18, 19, 20) and self._run:
                self._epoch += 1
            key, clock = (self._epoch, pic.poc), "picture order count"
            if planes is None:
                return None
        elif self._mpeg4 is not None:
            planes = self._mpeg4.decode(t.sample(j), what, (t.width, t.height))
            key, clock = (0, self._mpeg4.vop.time), "VOP time"
        elif self._vp9 is not None or self._vp8 is not None:
            planes = (self._vp9 or self._vp8).decode(t.sample(j), what)
            key, clock = (0, j), "decode order"
        else:
            return self._mjpeg.decode(t.sample(j), what)    # each sample stands alone
        if not t.timed or self._frame_of[j] < 0:
            return planes   # the order came from this clock, or the picture shows nowhere
        pts = int(t.pts[j])
        at = bisect.bisect_left(self._run, (key,))
        for other in self._run[max(at - 1, 0):at + 1]:
            # equal times keep decode order, as the presentation order does
            if (other[0] < key) != (other[1:] < (pts, j)) or other[0] == key:
                (ke, pe, e), (kl, pl, l) = sorted([(key, pts, j), other], key=lambda r: r[1])
                raise ValueError(
                    f"{self.path}: frame {self._frame_of[e]} (sample {e}) shows before frame "
                    f"{self._frame_of[l]} (sample {l}) by the container's composition times "
                    f"({pe} < {pl}), but not by {clock} ({ke[1]} and {kl[1]}, "
                    f"after {ke[0]} and {kl[0]} order-count resets)")
        self._run.insert(at, (key, pts, j))
        return planes


@functools.lru_cache(maxsize=2)
def _open_video(path: str, mtime_ns: int, size: int, device) -> VideoFrameReader:
    return VideoFrameReader(path, device)


def open_video(path, device=None) -> VideoFrameReader:
    """A reader of ``path``, kept open for the last two files (keyed by path,
    modification time, size and device), so stage 1's several reference
    frames from one video parse its ``moov`` once."""
    st = Path(path).stat()
    return _open_video(str(Path(path).resolve()), st.st_mtime_ns, st.st_size,
                       None if device is None else str(device))


def _tiff_orientation(d: bytes) -> int:
    """IFD0's Orientation (tag 0x0112) of a TIFF header and IFD, read as
    OpenCV's ``ExifReader`` reads it: "II" twice is little-endian, anything
    else big-endian; magic 42; the value is the 16 bits at the entry's
    value field whatever its type and count; the first entry with the tag
    wins; a read past the end stops the parse (0: none found)."""
    fmt = "<H" if d[:2] == b"II" else ">H"

    def u16(o):
        if o + 1 >= len(d):
            raise IndexError(o)
        return struct.unpack_from(fmt, d, o)[0]

    try:
        if u16(2) != 42 or len(d) < 8:
            return 0
        off = struct.unpack_from(fmt[0] + "I", d, 4)[0]
        n = u16(off)
        for e in range(n):
            if u16(off + 2 + 12 * e) == 0x0112:
                return u16(off + 2 + 12 * e + 8)
    except IndexError:
        pass
    return 0


def exif_orientation(data: bytes) -> int:
    """The EXIF Orientation cv2.imread applies to an image file's bytes
    (0 for none): for a JPEG, the first Orientation found in its APP1
    segments that begin with "Exif\\0\\0", before its first scan, each read
    until it ends or breaks (libjpeg saves them, OpenCV parses each in
    turn and keeps the first value); for a PNG, its first ``eXIf`` chunk
    whose CRC holds and whose first two bytes are "II" or "MM" (libpng
    drops the others, and a second eXIf)."""
    if data[:2] == b"\xff\xd8":
        pos = 2
        while pos + 4 <= len(data):
            if data[pos] != 0xFF:
                return 0
            marker = data[pos + 1]
            if marker == 0xFF:              # fill byte
                pos += 1
                continue
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                pos += 2
                continue
            if marker in (0xDA, 0xD9):      # the first scan, or the end
                return 0
            size = struct.unpack_from(">H", data, pos + 2)[0]
            seg = data[pos + 4:pos + 2 + size]
            if marker == 0xE1 and seg[:6] == b"Exif\0\0":
                found = _tiff_orientation(seg[6:])
                if found:
                    return found
            pos += 2 + size
        return 0
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        pos = 8
        while pos + 12 <= len(data):
            size, kind = struct.unpack_from(">I4s", data, pos)
            body = data[pos + 8:pos + 8 + size]
            if kind == b"eXIf":
                crc = data[pos + 8 + size:pos + 12 + size]
                if crc == struct.pack(">I", zlib.crc32(kind + body)):
                    if len(body) >= 2 and body[0] == body[1] and body[:1] in (b"I", b"M"):
                        return _tiff_orientation(body)
                    return 0
            if kind == b"IEND":
                break
            pos += 12 + size
    return 0


def apply_orientation(rgb: np.ndarray, orientation: int) -> np.ndarray:
    """``rgb`` turned and mirrored for an EXIF Orientation 1-8 as OpenCV's
    ``ExifTransform`` does (5-8 transpose first); other values leave it."""
    if not 2 <= orientation <= 8:
        return rgb
    if orientation >= 5:
        rgb = rgb.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1), 8: (0,)}[orientation]
    return np.ascontiguousarray(np.flip(rgb, flip) if flip else rgb)


def _read_still(path: Path) -> np.ndarray:
    """A PNG or JPEG file as ``cv2.imread`` reads it: decoded, then its EXIF
    orientation applied."""
    return apply_orientation(decode_image(path), exif_orientation(path.read_bytes()))


def load_frame(frame_path: Path, frame_id: int, device=None) -> np.ndarray:
    """Frame ``frame_id`` of a directory of PNG or JPEG frames (sorted order;
    each turned by its EXIF orientation, as ``cv2.imread`` in the JAX
    package's ``FrameReader`` turns it) or of a video file
    (:class:`VideoFrameReader` on ``device``), RGB uint8.
    An index past the end warns and reads the last frame, as the JAX
    package's ``load_frame`` does; a video whose count cv2 gives as 0 reads
    its first frame (cv2's seek to frame -1 leaves a fresh capture there),
    and one whose count is negative raises ``ValueError``, as Python's
    ``len`` does on the JAX reader."""
    frame_path = Path(frame_path)
    if frame_path.is_dir():
        frames = sorted(frame_path.glob("*.*"))
        n, read = len(frames), lambda i: _read_still(frames[i])
    else:
        reader = open_video(frame_path, device)
        n, read = len(reader), lambda i: reader[max(i, 0)]
    if frame_id >= n:
        print(f"WARNING: Frame {frame_id} out of bounds for video with length {n}")
        frame_id = n - 1
    return read(frame_id)


def adjust_intrinsics_crop(fx, fy, cx, cy, bbox, target_resolution):
    """Intrinsics of a square crop ``bbox`` resized to ``target_resolution``."""
    scale = target_resolution / (bbox[2] - bbox[0])
    return fx * scale, fy * scale, (cx - bbox[0]) * scale, (cy - bbox[1]) * scale


def get_crop_mask(orig_resolution, target_resolution, crop_box) -> np.ndarray:
    """1 inside the original image, 0 outside, in crop coordinates."""
    m = np.ones(orig_resolution)
    m = crop_image(m, crop_box, bg_value=0)
    return rescale_image(m, target_resolution)
