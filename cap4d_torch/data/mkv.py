"""A Matroska / WebM demuxer in pure Python: the sample table of a file's
first video track, as ffmpeg's ``matroskadec`` (inside cv2) reads it.

What it walks: the EBML header (DocType ``matroska`` or ``webm``), then
the ``Segment``: ``Info`` (``TimestampScale``, ``Duration``), ``Tracks``
(the first ``TrackEntry`` whose ``TrackType`` is 1, ffmpeg's first video
stream: ``CodecID``, ``CodecPrivate``, ``PixelWidth``/``PixelHeight``,
``Colour``'s ``ChromaSitingHorz``/``ChromaSitingVert`` (the chroma location
ffmpeg gives the stream, which cv2's swscale applies to VP8 and VP9
pictures: ``chroma_location``), ``DefaultDuration``, ``ContentEncodings``)
and every ``Cluster``
(``Timestamp``, then its ``SimpleBlock``s and ``BlockGroup``s). ``Cues``,
``SeekHead``, ``Tags`` and the rest are skipped: every cluster is read, so
a file without ``Cues``, as live writers leave it, reads the same. A
``Segment`` or ``Cluster`` of unknown size (OBS, MediaRecorder) ends at the
next element of a level above it, or at the end of the file; a block cut
off by the end of the file ends the track.

Blocks: a ``SimpleBlock``'s key flag; a ``BlockGroup`` without a
``ReferenceBlock`` is a key frame. Xiph, fixed-size and EBML lacing split a
block into frames, the first keeps the block's key flag and time and the
others follow at the block's duration (``BlockDuration``, else
``DefaultDuration`` times the frames) divided among them, as ffmpeg times
them. Relative block times may be negative. ``ContentCompression`` with
header stripping (algorithm 3: the stripped bytes go back before each
frame) or zlib (algorithm 0) is undone per frame; encryption, other
algorithms and several encodings raise ``ValueError`` naming them.

Frame ``k`` is the k-th frame in presentation order (block times, ties in
file order, as ``mp4.sample_times`` orders). Times are in nanoseconds.
cv2's frame count is ``floor(duration × fps + 0.5)`` (``frame_count``),
with ``Info/Duration`` and the frame rate ffmpeg gives the stream:
``DefaultDuration`` reduced as ``av_reduce`` does; without it, MPEG-4's
VOL rate, else the blocks' mean rate. Without a ``Duration`` ffmpeg's
duration is ``AV_NOPTS_VALUE`` and cv2's count is negative.

Codecs (:data:`MKV_CODECS`): ``V_MJPEG``; ``V_MPEG4/ISO/ASP``, ``/SP`` and
``/AP`` (``CodecPrivate`` is the VOL); ``V_MPEG4/ISO/AVC`` (an avcC);
``V_MS/VFW/FOURCC`` through the BITMAPINFOHEADER's ``biCompression`` and
``data/avi.py``'s table (cv2 stores PNG so); ``V_VP9`` (profile 0 decodes
through ``runtime/vp9.py`` on any device; the profile is in each frame's
header, so the decoder refuses the others by name); ``V_VP8`` (through
``runtime/vp8.py``; a block's ``BlockAdditions``, where browsers put an
alpha plane, are skipped, as ffmpeg's ``vp8`` decoder ignores them for cv2).
``V_MPEGH/ISO/HEVC`` (``CodecPrivate`` is an hvcC; intra pictures decode
through ``runtime/hevc.py``). Anything else raises ``ValueError`` naming
the CodecID.

``Video/Projection``: ffmpeg turns a rectangular projection (ProjectionType
0, the default) whose ProjectionPosePitch is 0 and whose ProjectionPoseYaw
is 0 or ±180 into a display matrix (``mkv_create_display_matrix``: the
roll negated, turned, then mirrored for a yaw of 180), and cv2 rotates
the frames by its angle as it does an mp4's (``VideoTrack.rotation``);
other projections and poses turn nothing.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from cap4d_torch.data import avi
from cap4d_torch.data.mp4 import Mp4vConfig, VideoTrack, matrix_rotation, parse_avcc, parse_hvcc

MKV_CODECS = {"V_MJPEG": "mjpeg", "V_MPEG4/ISO/ASP": "mpeg4", "V_MPEG4/ISO/SP": "mpeg4",
              "V_MPEG4/ISO/AP": "mpeg4", "V_MPEG4/ISO/AVC": "h264", "V_VP9": "vp9",
              "V_VP8": "vp8", "V_MPEGH/ISO/HEVC": "hevc", "V_MS/VFW/FOURCC": None}
REFUSED_NAMES = {"V_AV1": "AV1",
                 "V_MPEG2": "MPEG-2 video", "V_MPEG1": "MPEG-1 video", "V_THEORA": "Theora",
                 "V_MPEGI/ISO/VVC": "VVC", "V_PRORES": "ProRes", "V_FFV1": "FFV1"}

EBML, SEGMENT, CLUSTER = 0x1A45DFA3, 0x18538067, 0x1F43B675
INFO, TRACKS, TRACK_ENTRY = 0x1549A966, 0x1654AE6B, 0xAE
SIMPLE_BLOCK, BLOCK_GROUP, BLOCK, REFERENCE_BLOCK, BLOCK_DURATION = 0xA3, 0xA0, 0xA1, 0xFB, 0x9B
TIMESTAMP = 0xE7
# the elements that end a Cluster of unknown size (those of the Segment's level and up)
_ABOVE_CLUSTER = {CLUSTER, 0x1C53BB6B, 0x1254C367, 0x1043A770, 0x1941A469, 0x114D9B74, INFO,
                  TRACKS, SEGMENT, EBML}
# bytes of a block read to parse its header and lace sizes
HEAD_BYTES = 4096
# Video/Colour's (ChromaSitingHorz, ChromaSitingVert) -> ffmpeg's chroma
# location (matroskadec: av_chroma_location_pos_to_enum((h - 1) << 7,
# (v - 1) << 7)); 0 (unspecified) in either gives none
CHROMA_SITING = {(1, 2): "left", (2, 2): "center", (1, 1): "topleft", (2, 1): "top"}


def projection_rotation(kind: int, yaw: float, pitch: float, roll: float) -> int:
    """The clockwise rotation cv2 gives a track whose Projection has these
    ProjectionType and poses (degrees): ffmpeg's matroskadec display matrix
    (av_display_rotation_set of the roll, negated unless the yaw mirrors,
    then av_display_matrix_flip) read as cv2 reads an mp4's."""
    if kind != 0 or (pitch, yaw, roll) == (0.0, 0.0, 0.0):
        return 0
    if pitch != 0.0 or yaw not in (0.0, 180.0, -180.0) or math.isnan(roll):
        return 0                       # "Ignoring non-2D rectangular projection"
    hflip = yaw != 0.0
    rad = -(roll * (2 * hflip - 1)) * math.pi / 180.0
    c, s = math.cos(rad), math.sin(rad)
    m = [int(c * 65536), int(-s * 65536), 0, int(s * 65536), int(c * 65536), 0, 0, 0, 1 << 30]
    if hflip:
        m = [-v if i % 3 == 0 else v for i, v in enumerate(m)]
    return matrix_rotation(m)


def _vint(buf: bytes, pos: int, keep_marker: bool = False) -> Tuple[int, int, bool]:
    """(value, length, all value bits set) of the EBML integer at ``pos``."""
    first = buf[pos]
    if first == 0:
        raise ValueError(f"an EBML integer longer than 8 bytes at byte {pos}")
    n = 9 - first.bit_length()
    v = first if keep_marker else first & ((1 << (8 - n)) - 1)
    if pos + n > len(buf):
        raise ValueError("an EBML integer runs past its buffer")
    for b in buf[pos + 1:pos + n]:
        v = (v << 8) | b
    full = (v & ((1 << (7 * n)) - 1)) == (1 << (7 * n)) - 1
    return v, n, full


def _elements(buf: bytes, start: int, end: int):
    """(id, payload start, payload end) of the elements in ``buf[start:end]``."""
    pos = start
    while pos < end:
        eid, a, _ = _vint(buf, pos, True)
        size, b, _ = _vint(buf, pos + a)
        stop = pos + a + b + size
        if stop > end:
            raise ValueError(f"element {eid:#x} of {size} bytes overruns its parent")
        yield eid, pos + a + b, stop
        pos = stop


def _uint(buf: bytes, a: int, b: int) -> int:
    return int.from_bytes(buf[a:b], "big")


def _float(buf: bytes, a: int, b: int) -> float:
    """An EBML float element (4 or 8 bytes; 0.0 when empty)."""
    if b - a in (4, 8):
        return struct.unpack(">f" if b - a == 4 else ">d", buf[a:b])[0]
    return 0.0


def _children(buf: bytes, a: int, b: int) -> Dict[int, List[Tuple[int, int]]]:
    out: Dict[int, List[Tuple[int, int]]] = {}
    for eid, x, y in _elements(buf, a, b):
        out.setdefault(eid, []).append((x, y))
    return out


class _File:
    """Element headers read by position from an open file."""

    def __init__(self, fh, where: str):
        self.fh, self.where = fh, where
        self.size = fh.seek(0, 2)

    def read(self, pos: int, n: int) -> bytes:
        self.fh.seek(pos)
        return self.fh.read(n)

    def header(self, pos: int):
        """(id, payload start, payload size or None when unknown)."""
        head = self.read(pos, 12)
        eid, a, _ = _vint(head, 0, True)
        size, b, unknown = _vint(head, a)
        return eid, pos + a + b, None if unknown else size


def _doc_type(f: _File) -> str:
    eid, a, size = f.header(0)
    if eid != EBML or size is None:
        raise ValueError(f"{f.where}: not an EBML file")
    body = f.read(a, size)
    kids = _children(body, 0, len(body))
    doc = body[slice(*kids[0x4282][0])].rstrip(b"\0").decode("latin-1") if 0x4282 in kids else ""
    if doc not in ("matroska", "webm"):
        raise ValueError(f"{f.where}: EBML DocType {doc!r} (the port reads matroska and webm)")
    return doc


class _Track:
    """What the first video TrackEntry says."""

    def __init__(self, buf: bytes, a: int, b: int, where: str):
        kids = _children(buf, a, b)

        def one(eid, default=None):
            return kids[eid][0] if eid in kids else default

        self.number = _uint(buf, *one(0xD7, (0, 0)))
        self.codec_id = buf[slice(*one(0x86, (0, 0)))].rstrip(b"\0").decode("latin-1")
        self.private = bytes(buf[slice(*one(0x63A2, (0, 0)))])
        self.default_duration = _uint(buf, *one(0x23E383, (0, 0)))
        self.width = self.height = 0
        self.chroma_location = None
        self.rotation = 0
        if 0xE0 in kids:
            video = _children(buf, *kids[0xE0][0])
            self.width = _uint(buf, *video.get(0xB0, [(0, 0)])[0])
            self.height = _uint(buf, *video.get(0xBA, [(0, 0)])[0])
            if 0x55B0 in video:
                colour = _children(buf, *video[0x55B0][0])
                siting = tuple(_uint(buf, *colour.get(e, [(0, 0)])[0]) for e in (0x55B7, 0x55B8))
                self.chroma_location = CHROMA_SITING.get(siting)
            if 0x7670 in video:
                proj = _children(buf, *video[0x7670][0])
                kind = _uint(buf, *proj[0x7671][0]) if 0x7671 in proj else 0
                pose = [_float(buf, *proj[e][0]) if e in proj else 0.0
                        for e in (0x7673, 0x7674, 0x7675)]
                self.rotation = projection_rotation(kind, *pose)
        self.prefix, self.zlib = b"", False
        if 0x6D80 in kids:
            self._encodings(buf, kids[0x6D80][0], where)

    def _encodings(self, buf: bytes, span: Tuple[int, int], where: str) -> None:
        encodings = _children(buf, *span).get(0x6240, [])
        if len(encodings) > 1:
            raise ValueError(f"{where}: the video track has {len(encodings)} ContentEncodings "
                             "(several combined encodings are not supported)")
        if not encodings:
            return
        enc = _children(buf, *encodings[0])
        scope = _uint(buf, *enc[0x5032][0]) if 0x5032 in enc else 1
        kind = _uint(buf, *enc[0x5033][0]) if 0x5033 in enc else 0
        if kind != 0 or 0x5035 in enc:
            raise ValueError(f"{where}: the video track is encrypted (ContentEncryption); "
                             "encrypted Matroska is not supported")
        comp = _children(buf, *enc[0x5034][0]) if 0x5034 in enc else {}
        algo = _uint(buf, *comp[0x4254][0]) if 0x4254 in comp else 0
        names = {0: "zlib", 1: "bzlib", 2: "lzo1x", 3: "header stripping"}
        if algo not in (0, 3):
            raise ValueError(f"{where}: ContentCompression algorithm {algo} "
                             f"({names.get(algo, 'unknown')}) is not supported; the port takes "
                             "zlib (0) and header stripping (3)")
        if scope & 2 and algo == 0:     # the codec private data is compressed too
            try:
                self.private = zlib.decompress(self.private)
            except zlib.error as e:
                raise ValueError(f"{where}: the CodecPrivate does not inflate ({e})") from e
        if scope & 1:
            if algo == 3:
                self.prefix = bytes(buf[slice(*comp[0x4255][0])]) if 0x4255 in comp else b""
            else:
                self.zlib = True


def _header_elements(f: _File, seg_start: int, seg_end: int):
    """(Info payload, first video _Track or None, the first Cluster's
    position) of a Segment."""
    info = tracks = None
    pos = seg_start
    while pos < seg_end:
        eid, a, size = f.header(pos)
        if eid == CLUSTER:
            return info, tracks, pos
        if size is None:
            raise ValueError(f"{f.where}: element {eid:#x} of unknown size in the Segment")
        if eid == INFO:
            info = f.read(a, size)
        elif eid == TRACKS:
            tracks = f.read(a, size)
        pos = a + size
    return info, tracks, seg_end


def _lace_sizes(head: bytes, pos: int, kind: int, total: int) -> Tuple[List[int], int]:
    """(frame sizes, bytes of the lace header) of a laced block: ``kind``
    1 Xiph, 2 fixed, 3 EBML; ``total`` the bytes after the flags."""
    count = head[pos] + 1
    pos += 1
    start = pos
    if count == 1:
        return [total - 1], 1
    if kind == 1:
        sizes = []
        for _ in range(count - 1):
            n = 0
            while True:
                b = head[pos]
                pos += 1
                n += b
                if b != 255:
                    break
            sizes.append(n)
    elif kind == 3:
        first, n, _ = _vint(head, pos)
        pos += n
        sizes = [first]
        for _ in range(count - 2):
            raw, n, _ = _vint(head, pos)
            pos += n
            sizes.append(sizes[-1] + raw - ((1 << (7 * n - 1)) - 1))
    else:
        if (total - 1) % count:
            raise ValueError(f"fixed-size lacing of {count} frames over {total - 1} bytes")
        return [(total - 1) // count] * count, 1
    used = pos - start + 1
    last = total - used - sum(sizes)
    if last < 0 or any(s < 0 for s in sizes):
        raise ValueError("lace sizes overrun their block")
    return sizes + [last], used


def _vol_frame_rate(data: bytes) -> Optional[float]:
    """ffmpeg's frame rate of an MPEG-4 stream from its VOL header:
    vop_time_increment_resolution over fixed_vop_time_increment (1 when
    the rate is not fixed); None without a VOL."""
    at = -1
    for k in range(len(data) - 3):
        if data[k:k + 3] == b"\0\0\1" and 0x20 <= data[k + 3] <= 0x2F:
            at = k + 4
            break
    if at < 0:
        return None
    bits = int.from_bytes(data[at:at + 24].ljust(24, b"\0"), "big")
    pos = 24 * 8

    def u(n):
        nonlocal pos
        pos -= n
        return (bits >> pos) & ((1 << n) - 1)

    u(1), u(8)                       # random_accessible_vol, video_object_type_indication
    verid = 1
    if u(1):                         # is_object_layer_identifier
        verid = u(4)
        u(3)
    if u(4) == 0xF:                  # aspect_ratio_info: extended PAR
        u(16)
    if u(1):                         # vol_control_parameters
        u(3)
        if u(1):                     # vbv_parameters
            u(79)
    shape = u(2)
    if shape == 3 and verid != 1:
        u(4)
    u(1)
    res = u(16)
    u(1)
    if not res:
        return None
    inc = u(max(1, (res - 1).bit_length())) if u(1) else 1
    return res / inc if inc else None


def av_reduce(num: int, den: int, limit: int) -> Tuple[int, int]:
    """ffmpeg's ``av_reduce``: the closest fraction to num/den whose terms
    are at most ``limit``."""
    g = math.gcd(num, den)
    num, den = num // g, den // g
    if num <= limit and den <= limit:
        return num, den
    a0, a1 = (0, 1), (1, 0)
    while den:
        x = num // den
        nxt = num - den * x
        a2 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
        if a2[0] > limit or a2[1] > limit:
            if a1[0]:
                x = (limit - a0[0]) // a1[0]
            if a1[1]:
                x = min(x, (limit - a0[1]) // a1[1])
            if den * (2 * x * a1[1] + a0[1]) > num * a1[1]:
                a1 = (x * a1[0] + a0[0], x * a1[1] + a0[1])
            break
        a0, a1 = a1, a2
        num, den = den, nxt
    return a1


def cv2_frame_count(duration: Optional[float], scale: int, fps: float) -> int:
    """cv2's CAP_PROP_FRAME_COUNT of a Matroska stream: ``duration`` (Info's
    Duration in units of ``scale`` ns, None without one) times ``fps``,
    rounded; without a duration ffmpeg's is AV_NOPTS_VALUE and so is the
    stream's, whose seconds (times the time base) cv2 then takes."""
    sec = 0.0
    if duration:
        sec = int(duration * scale * 1000 / 1_000_000) / 1_000_000
    if sec < 1e-6:
        tb = av_reduce(scale, 1_000_000_000, 2**31 - 1)
        sec = float(-(2**63)) * (tb[0] / tb[1])
    return int(math.floor(sec * fps + 0.5))


def read_track(path) -> VideoTrack:
    """The sample table of the first video track of the Matroska or WebM
    ``path``."""
    where = str(path)
    with open(path, "rb") as fh:
        try:
            return _read(_File(fh, where))
        except (struct.error, IndexError) as e:    # a field past the end of its element
            raise ValueError(f"{where}: malformed Matroska file ({e})") from e
        except ValueError as e:
            if str(e).startswith(where):
                raise
            raise ValueError(f"{where}: malformed Matroska file ({e})") from e


def _read(f: _File) -> VideoTrack:
    where = f.where
    _doc_type(f)
    pos = f.header(0)[1] + f.header(0)[2]
    while pos < f.size:
        eid, a, size = f.header(pos)
        if eid == SEGMENT:
            break
        if size is None:
            raise ValueError(f"element {eid:#x} of unknown size before the Segment")
        pos = a + size
    else:
        raise ValueError(f"{where}: no Segment")
    seg_start, seg_end = a, f.size if size is None else min(a + size, f.size)
    info, tracks, first_cluster = _header_elements(f, seg_start, seg_end)
    if tracks is None:
        raise ValueError(f"{where}: no Tracks before the first Cluster")
    scale, duration = 1_000_000, None
    if info is not None:
        kids = _children(info, 0, len(info))
        if 0x2AD7B1 in kids:
            scale = _uint(info, *kids[0x2AD7B1][0]) or 1_000_000
        if 0x4489 in kids:
            a, b = kids[0x4489][0]
            duration = struct.unpack(">f" if b - a == 4 else ">d", info[a:b])[0]
    track = None
    for eid, a, b in _elements(tracks, 0, len(tracks)):
        if eid != TRACK_ENTRY:
            continue
        kids = _children(tracks, a, b)
        if 0x83 in kids and _uint(tracks, *kids[0x83][0]) == 1:
            track = _Track(tracks, a, b, where)
            break
    if track is None:
        raise ValueError(f"{where}: no video track")
    codec, fourcc, private = _codec(track, where)
    offsets, sizes, times, keys = _blocks(f, first_cluster, seg_end, track, scale)
    if not offsets:
        raise ValueError(f"{where}: the video track has no blocks")
    offsets, sizes = np.array(offsets, np.int64), np.array(sizes, np.int64)
    pts = np.array(times, np.int64) * scale
    t = VideoTrack(where, codec, fourcc, track.width, track.height, 1_000_000_000, offsets,
                   sizes, pts, pts.copy(), np.array(keys, bool), np.argsort(pts, kind="stable"),
                   prefix=track.prefix, zlib=track.zlib, chroma_location=track.chroma_location,
                   rotation=track.rotation)
    avc = m4v = hvc = None
    annexb = False
    if codec == "h264" and track.codec_id == "V_MPEG4/ISO/AVC":
        avc = parse_avcc(private)
    elif codec == "h264":        # VfW: Annex-B, as in an AVI
        keys_at = np.flatnonzero(t.sync)
        avc, annexb = avi._avc_config(private, t.sample(int(keys_at[0])) if len(keys_at) else b"",
                                      where)
    elif codec == "hevc" and track.codec_id == "V_MPEGH/ISO/HEVC":
        hvc = parse_hvcc(private)
    elif codec == "hevc":        # VfW, as in an AVI
        hvc = avi.hevc_config(private)
        annexb = not avi.is_hvcc(private)
    elif codec == "mpeg4":
        m4v = Mp4vConfig(0x20, private)
    if track.default_duration:
        num, den = av_reduce(1_000_000_000, track.default_duration, 30000)
        fps = num / den
    else:
        fps = _vol_frame_rate(private or t.sample(0, 4096)) if codec == "mpeg4" else None
        if fps is None:
            span = (pts.max() - pts.min()) / 1e9
            fps = (len(pts) - 1) / span if span > 0 else 1e9 / scale
    return dataclasses.replace(t, avc=avc, m4v=m4v, hvc=hvc, annexb=annexb,
                               frame_count=cv2_frame_count(duration, scale, fps))


def _codec(track: _Track, where: str) -> Tuple[str, str, bytes]:
    """(codec, its name in the file, the codec private data after any
    BITMAPINFOHEADER)."""
    cid = track.codec_id
    if cid not in MKV_CODECS:
        name = REFUSED_NAMES.get(cid)
        raise ValueError(f"{where}: codec {cid!r}{f' ({name})' if name else ''} is not supported; "
                         "the port reads Matroska video as V_MJPEG, V_MPEG4/ISO/ASP (SP, AP), "
                         "V_MPEG4/ISO/AVC, V_MPEGH/ISO/HEVC, V_MS/VFW/FOURCC of those, V_VP8 and "
                         "V_VP9")
    if cid != "V_MS/VFW/FOURCC":
        return MKV_CODECS[cid], cid, track.private
    if len(track.private) < 40:
        raise ValueError(f"{where}: a V_MS/VFW/FOURCC track without its BITMAPINFOHEADER")
    fourcc = track.private[16:20].decode("latin-1")
    codec = avi.AVI_CODECS.get(fourcc)
    if codec is None:
        name = avi.REFUSED_NAMES.get(fourcc)
        raise ValueError(f"{where}: codec V_MS/VFW/FOURCC {fourcc!r}{f' ({name})' if name else ''}"
                         " is not supported; the port reads Motion-JPEG, PNG, MPEG-4 Part 2, "
                         "H.264, HEVC, VP8 and VP9 through it")
    if not track.width:
        track.width, track.height = struct.unpack_from("<ii", track.private, 4)
        track.width, track.height = abs(track.width), abs(track.height)
    return codec, fourcc, track.private[40:]


def _blocks(f: _File, pos: int, seg_end: int, track: _Track, scale: int):
    """(offsets, sizes, times in ``scale`` ns, key flags) of the track's
    frames, cluster by cluster."""
    offsets: List[int] = []
    sizes: List[int] = []
    times: List[int] = []
    keys: List[bool] = []
    while pos < seg_end:
        eid, a, size = f.header(pos)
        if eid != CLUSTER:
            if eid in (SEGMENT, EBML) or size is None:
                break
            pos = a + size
            continue
        end = seg_end if size is None else min(a + size, seg_end)
        cluster_ts, at = None, a
        while at < end:
            try:
                eid, ba, bsize = f.header(at)
            except ValueError:
                if at + 12 < f.size:
                    raise
                return offsets, sizes, times, keys      # a header cut off by the end of the file
            if size is None and eid in _ABOVE_CLUSTER:
                end = at
                break
            if bsize is None:
                raise ValueError(f"element {eid:#x} of unknown size in a Cluster")
            if ba + bsize > f.size:        # cut off by the end of the file
                return offsets, sizes, times, keys
            if eid == TIMESTAMP:
                cluster_ts = _uint(f.read(ba, bsize), 0, bsize)
            elif eid in (SIMPLE_BLOCK, BLOCK_GROUP):
                if cluster_ts is None:
                    raise ValueError(f"a block before its Cluster's Timestamp at byte {at}")
                _block(f, eid, ba, bsize, track, cluster_ts, scale, offsets, sizes, times, keys)
            at = ba + bsize
        pos = end
    return offsets, sizes, times, keys


def _block(f: _File, eid: int, a: int, size: int, track: _Track, cluster_ts: int, scale: int,
           offsets, sizes, times, keys) -> None:
    duration = None
    key = None
    if eid == BLOCK_GROUP:
        kids, at = {}, a
        while at < a + size:
            cid, ca, csize = f.header(at)
            if csize is None or ca + csize > a + size:
                raise ValueError(f"a BlockGroup child overruns its group at byte {at}")
            kids.setdefault(cid, (ca, csize))
            at = ca + csize
        if BLOCK not in kids:
            return
        key = REFERENCE_BLOCK not in kids
        if BLOCK_DURATION in kids:
            x, n = kids[BLOCK_DURATION]
            duration = _uint(f.read(x, n), 0, n)
        a, size = kids[BLOCK]
    head = f.read(a, min(size, HEAD_BYTES))
    number, n, _ = _vint(head, 0)
    if number != track.number:
        return
    rel, flags = struct.unpack_from(">hB", head, n)
    if key is None:
        key = bool(flags & 0x80)
    pos = n + 3
    lacing = (flags >> 1) & 3
    time = cluster_ts + rel
    if time < 0:
        raise ValueError(f"a block at a negative time ({time}) at byte {a}")
    if not lacing:
        frame_sizes, used = [size - pos], 0
    else:
        if size > len(head):
            head = f.read(a, size)
        frame_sizes, used = _lace_sizes(head, pos, lacing, size - pos)
        if len(frame_sizes) > 1 and duration is None:
            duration = track.default_duration * len(frame_sizes) // scale
        if len(frame_sizes) > 1 and not duration:
            raise ValueError(f"a laced block of {len(frame_sizes)} frames at byte {a} with no "
                             "duration (no BlockDuration or DefaultDuration): its frames have no "
                             "times")
    at = a + pos + used
    laces = len(frame_sizes)
    for k, s in enumerate(frame_sizes):
        offsets.append(at)
        sizes.append(s)
        times.append(time + (duration * k // laces if k else 0))
        keys.append(key and k == 0)
        at += s
