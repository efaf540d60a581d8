"""AVI and Matroska muxers for tests: the samples of an mp4 file (the
H.264 and MPEG-4 writers' streams, cv2's files) wrapped again in RIFF AVI
or in Matroska/WebM, in each layout the port's demuxers (``data/avi.py``,
``data/mkv.py``) must read, so that cv2 reading the same file is the
oracle.

AVI (:func:`write_avi`): ``strh``/``strf`` with the codec's four-character
code and extradata, ``NNdc`` chunks in ``movi``, and the index as
``idx1`` with offsets relative to ``movi`` or absolute, as OpenDML
(``indx`` super index, ``ix00`` standard indexes, a ``RIFF AVIX`` part
with the second half of the samples, ``idx1`` over the first), or none.
H.264 samples become Annex-B access units with 4-byte start codes; the
parameter sets go in ``strf``'s extradata, or in band before each key
frame. An audio stream may come first (the video stream is then ``01``),
and a decoy Motion-JPEG video stream after it (cv2 reads the first).

Matroska (:func:`write_mkv`): the EBML header, then ``Segment`` with
``SeekHead``, ``Info`` (TimestampScale 1 ms, ``Duration``), ``Tracks``,
``Cluster``s and ``Cues``; blocks as ``SimpleBlock``s or ``BlockGroup``s
(a ``ReferenceBlock`` on each non-key frame), optionally laced (Xiph,
fixed or EBML), with header stripping, zlib or an encryption marker, and
``Segment`` and ``Cluster`` of unknown size as live writers leave them.
Frame times are the presentation index times 1000/fps ms; a cluster's
timestamp may be its last block's time, so that the blocks' relative times
are negative.
"""

from __future__ import annotations

import struct
import zlib as _zlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from cap4d_torch.data import mp4

# codec -> the four-character code cv2's ffmpeg writes into an AVI
AVI_FOURCC = {"h264": b"H264", "mpeg4": b"FMP4", "mjpeg": b"MJPG", "png": b"MPNG", "vp9": b"VP90",
              "vp8": b"VP80"}
AVIIF_KEYFRAME = 0x10


@dataclass
class Stream:
    """Samples in decode order (H.264 with the mp4's NAL lengths), their
    sync flags and presentation indices, and what the codec needs."""

    codec: str
    width: int
    height: int
    samples: List[bytes]
    sync: List[bool]
    rank: List[int]
    avc: Optional[mp4.AvcConfig] = None
    dsi: bytes = b""


def stream_of_mp4(path) -> Stream:
    """The first video track of an mp4 file as a :class:`Stream`."""
    t = mp4.read_track(path)
    rank = [0] * len(t)
    for k, j in enumerate(t.order):
        rank[int(j)] = k
    return Stream(t.codec, t.width, t.height, [t.sample(i) for i in range(len(t))],
                  [bool(s) for s in t.sync], rank, t.avc, t.m4v.dsi if t.m4v else b"")


def _annexb_params(avc: mp4.AvcConfig) -> bytes:
    return b"".join(avc.sps) + b"".join(avc.pps)


def avcc(avc: mp4.AvcConfig) -> bytes:
    """An ``avcC`` payload (AVCDecoderConfigurationRecord) of ``avc``."""
    sps = [s[4:] for s in avc.sps]
    pps = [p[4:] for p in avc.pps]
    return (bytes([1, avc.profile, 0, avc.level, 0xFC | (avc.length_size - 1), 0xE0 | len(sps)])
            + b"".join(struct.pack(">H", len(s)) + s for s in sps) + bytes([len(pps)])
            + b"".join(struct.pack(">H", len(p)) + p for p in pps))


def _payloads(s: Stream, in_band: bool):
    """(extradata, samples) as an AVI or a VfW Matroska track carries them:
    H.264 as Annex-B, the parameter sets or the MPEG-4 headers in the
    extradata or before each key frame."""
    extra, out = b"", []
    for data, key in zip(s.samples, s.sync):
        if s.codec == "h264":
            data = mp4.annexb(data, s.avc.length_size)
            if in_band and key:
                data = _annexb_params(s.avc) + data
        elif s.codec == "mpeg4" and in_band and key:
            data = s.dsi + data
        out.append(data)
    if not in_band:
        extra = _annexb_params(s.avc) if s.codec == "h264" else s.dsi
    return extra, out


def bitmap_info_header(fourcc: bytes, width: int, height: int, extra: bytes = b"") -> bytes:
    """BITMAPINFOHEADER (40 bytes) with ``extra`` after it."""
    return struct.pack("<IiiHH4sIiiII", 40 + len(extra), width, height, 1, 24, fourcc,
                       abs(width * height) * 3, 0, 0, 0, 0) + extra


# -------------------------------------------------------------------- AVI --

def _chunk(fourcc: bytes, data: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(data)) + data + (b"\0" if len(data) & 1 else b"")


def _list(kind: bytes, *parts: bytes) -> bytes:
    body = kind + b"".join(parts)
    return b"LIST" + struct.pack("<I", len(body)) + body


def write_avi(path, s: Stream, *, index: str = "idx1", fourcc: Optional[bytes] = None,
              in_band: bool = False, audio: bool = False, top_down: bool = False,
              length: Optional[int] = None, decoy: Optional[bytes] = None) -> None:
    """Write ``s`` at 25 fps as an AVI. ``index``: "idx1" (offsets from
    ``movi``), "idx1_absolute", "odml" (``indx`` and ``ix00`` per part; a
    ``RIFF AVIX`` holds the second half of the samples) or "none".
    ``fourcc`` overrides the codec's; ``in_band`` moves the
    parameter sets into the key frames; ``audio`` puts a PCM stream first;
    ``top_down`` writes a negative height; ``length`` overrides
    ``strh.dwLength``; ``decoy`` (a JPEG) adds a second video stream, that
    JPEG in a chunk beside each of the first's."""
    if index not in ("idx1", "idx1_absolute", "odml", "none"):
        raise ValueError(f"index {index!r}")
    extra, samples = _payloads(s, in_band)
    fourcc = fourcc or AVI_FOURCC[s.codec]
    vid = b"01" if audio else b"00"
    other = b"%02d" % (int(vid) + 1)
    n = len(samples)
    parts = [list(range(n))]
    if index == "odml":
        parts = [list(range(n // 2)), list(range(n // 2, n))]
    # stream headers; the indx is laid out with a fixed size, filled in below
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, 1, 25, 0,
                       n if length is None else length, max(map(len, samples)), 0xFFFFFFFF, 0,
                       0, 0, s.width, s.height)
    strf = bitmap_info_header(fourcc, s.width, -s.height if top_down else s.height, extra)
    indx_size = 24 + 16 * len(parts)
    strls = []
    if audio:
        wave = struct.pack("<HHIIHH", 1, 1, 8000, 16000, 2, 16)
        strls.append(_list(b"strl", _chunk(b"strh", struct.pack(
            "<4s4sIHHIIIIIIIIhhhh", b"auds", b"\0" * 4, 0, 0, 0, 0, 1, 8000, 0, 8000, 640,
            0xFFFFFFFF, 2, 0, 0, 0, 0)), _chunk(b"strf", wave)))
    vstrl = [_chunk(b"strh", strh), _chunk(b"strf", strf)]
    if index == "odml":
        vstrl.append(_chunk(b"indx", b"\0" * indx_size))
    strls.append(_list(b"strl", *vstrl))
    if decoy:
        strls.append(_list(b"strl", _chunk(b"strh", strh.replace(fourcc, b"MJPG", 1)),
                           _chunk(b"strf", bitmap_info_header(b"MJPG", s.width, s.height))))
    avih = struct.pack("<IIIIIIIIII16x", 40_000, 0, 0, 0x10, n, 0, len(strls), 0,
                       s.width, s.height)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih), *strls,
                 *([_list(b"odml", _chunk(b"dmlh", struct.pack("<I", n)))]
                   if index == "odml" else []))
    out = bytearray()
    riff_starts, idx1, ix_chunks = [], [], []
    for p, members in enumerate(parts):
        riff_starts.append(len(out))
        out += b"RIFF\0\0\0\0" + (b"AVI " if p == 0 else b"AVIX")
        if p == 0:
            out += hdrl
        movi = len(out)
        out += b"LIST\0\0\0\0movi"
        entries = []
        for j in members:
            if audio and j % 4 == 0:
                if p == 0:
                    idx1.append((b"00wb", len(out), 640, True))
                out += _chunk(b"00wb", b"\0" * 640)
            pos = len(out)
            out += _chunk(vid + b"dc", samples[j])
            entries.append((pos, len(samples[j]), s.sync[j]))
            if p == 0:
                idx1.append((vid + b"dc", pos, len(samples[j]), s.sync[j]))
            if decoy:
                if p == 0:
                    idx1.append((other + b"dc", len(out), len(decoy), True))
                out += _chunk(other + b"dc", decoy)
        if index == "odml":
            base = movi   # ix00's base offset: chunk data lies at base + offset
            body = struct.pack("<HBBI4sQI", 2, 0, 1, len(entries), vid + b"dc", base, 0)
            body += b"".join(struct.pack("<II", pos + 8 - base, size | (0 if key else 1 << 31))
                             for pos, size, key in entries)
            ix_chunks.append((len(out), len(body) + 8, len(entries)))
            out += _chunk(b"ix" + vid, body)
        struct.pack_into("<I", out, movi + 4, len(out) - movi - 8)
        if p == 0 and index in ("idx1", "idx1_absolute", "odml"):
            anchor = movi + 8 if index != "idx1_absolute" else 0
            out += _chunk(b"idx1", b"".join(
                struct.pack("<4sIII", ckid, AVIIF_KEYFRAME if key else 0, pos - anchor, size)
                for ckid, pos, size, key in idx1))
        struct.pack_into("<I", out, riff_starts[-1] + 4, len(out) - riff_starts[-1] - 8)
    if index == "odml":
        at = bytes(out).index(b"indx") + 8
        body = struct.pack("<HBBI4s12x", 4, 0, 0, len(ix_chunks), vid + b"dc")
        body += b"".join(struct.pack("<QII", off, size, k) for off, size, k in ix_chunks)
        out[at:at + len(body)] = body
    Path(path).write_bytes(bytes(out))


# --------------------------------------------------------------- Matroska --

UNKNOWN = b"\x01\xff\xff\xff\xff\xff\xff\xff"


def _id(i: int) -> bytes:
    return i.to_bytes((i.bit_length() + 7) // 8, "big")


def vint(v: int, width: Optional[int] = None) -> bytes:
    """An EBML variable-size integer (a size, or a lace size)."""
    n = width or next(k for k in range(1, 9) if v < (1 << (7 * k)) - 1)
    return (v | (1 << (7 * n))).to_bytes(n, "big")


def el(i: int, payload: bytes) -> bytes:
    return _id(i) + vint(len(payload)) + payload


def uint(i: int, v: int, width: int = 0) -> bytes:
    return el(i, v.to_bytes(width or max(1, (v.bit_length() + 7) // 8), "big"))


def _lace(frames: List[bytes], how: str):
    """(lacing bits, lace header) of ``frames`` in one block."""
    head = bytes([len(frames) - 1])
    if how == "xiph":
        for f in frames[:-1]:
            head += b"\xff" * (len(f) // 255) + bytes([len(f) % 255])
        return 0x02, head
    if how == "fixed":
        if len({len(f) for f in frames}) != 1:
            raise ValueError("fixed lacing needs frames of one size")
        return 0x04, head
    head += vint(len(frames[0]))
    for a, b in zip(frames, frames[1:-1]):
        d = len(b) - len(a)
        w = next(k for k in range(1, 9) if abs(d) < (1 << (7 * k - 1)) - 1)
        head += vint(d + (1 << (7 * w - 1)) - 1, w)
    return 0x06, head


def write_mkv(path, s: Stream, *, doc_type: str = "matroska", blocks: str = "simple",
              cues: bool = True, duration: bool = True, default_duration: bool = True,
              unknown_sizes: bool = False, lacing: Optional[str] = None,
              strip: int = 0, compress: bool = False, encrypted: bool = False,
              fps: int = 25, audio: bool = False,
              codec_id: Optional[str] = None, codec_private: Optional[bytes] = None,
              negative: bool = False, vfw: bool = False, decoy: Optional[bytes] = None,
              block_additions: Optional[List[bytes]] = None) -> None:
    """Write ``s`` as Matroska (``doc_type`` "webm" for WebM). ``blocks``
    "simple" or "group", clusters of 8 frames or from a key frame on;
    ``lacing`` "xiph", "fixed" or "ebml" puts up to 3 frames a block (a key
    frame starts a block; streams without reordering); ``strip`` strips
    that many common leading bytes
    (ContentCompression 3) and ``compress`` zlib-compresses every frame
    (algorithm 0; with ``strip``, two ContentEncodings, which ffmpeg and
    the port refuse); ``encrypted`` adds a ContentEncryption; ``negative``
    gives each cluster its last block's time; ``vfw`` stores the codec as
    V_MS/VFW/FOURCC (H.264 then as Annex-B, as an AVI carries it);
    ``codec_id`` / ``codec_private`` override the track's; ``decoy`` (a
    JPEG) adds a second video track after it, that JPEG in a block beside
    each of the first's; ``block_additions`` (one payload a sample, with
    ``blocks="group"``) gives each block a BlockAdditions element
    (BlockAddID 1), where browsers put a VP8 alpha plane."""
    ms = 1000 // fps
    track_no = 2 if audio else 1
    if codec_id is None:
        if vfw or s.codec == "png":
            extra, samples = _payloads(s, in_band=False)
            codec_id = "V_MS/VFW/FOURCC"
            private = bitmap_info_header(AVI_FOURCC[s.codec], s.width, s.height, extra)
        else:
            codec_id = {"h264": "V_MPEG4/ISO/AVC", "mpeg4": "V_MPEG4/ISO/ASP",
                        "mjpeg": "V_MJPEG", "vp9": "V_VP9", "vp8": "V_VP8"}[s.codec]
            private = avcc(s.avc) if s.codec == "h264" else s.dsi
            samples = list(s.samples)
    else:
        samples, private = list(s.samples), b""
    if codec_private is not None:
        private = codec_private
    encodings = b""
    prefix = b""
    if strip:
        common = samples[0]
        for x in samples[1:]:
            while not x.startswith(common):
                common = common[:-1]
        prefix = common[:strip]
        if not prefix:
            raise ValueError("the samples share no leading bytes to strip")
        samples = [x[len(prefix):] for x in samples]
        encodings += el(0x6240, uint(0x5031, 1 if compress else 0) + uint(0x5032, 1)
                        + uint(0x5033, 0) + el(0x5034, uint(0x4254, 3) + el(0x4255, prefix)))
    if compress:
        samples = [_zlib.compress(x) for x in samples]
        encodings += el(0x6240, uint(0x5031, 0) + uint(0x5032, 1) + uint(0x5033, 0)
                        + el(0x5034, uint(0x4254, 0)))
    if encrypted:
        encodings += el(0x6240, uint(0x5031, 0) + uint(0x5032, 1) + uint(0x5033, 1)
                        + el(0x5035, uint(0x47E1, 5) + el(0x47E2, b"\x11" * 16)))
    video = el(0xAE, uint(0xD7, track_no) + uint(0x73C5, 0x1234 + track_no) + uint(0x83, 1)
               + uint(0x9C, 1 if lacing else 0) + el(0x86, codec_id.encode())
               + (el(0x63A2, private) if private else b"")
               + (uint(0x23E383, ms * 1_000_000 if default_duration is True else default_duration)
                  if default_duration else b"")
               + el(0xE0, uint(0xB0, s.width) + uint(0xBA, s.height))
               + (el(0x6D80, encodings) if encodings else b""))
    tracks = el(0x1654AE6B, (el(0xAE, uint(0xD7, 1) + uint(0x73C5, 0x1235) + uint(0x83, 2)
                                   + el(0x86, b"A_PCM/INT/LIT")
                                   + el(0xE1, el(0xB5, struct.pack(">d", 8000.0))
                                        + uint(0x9F, 1))) if audio else b"") + video
                + (el(0xAE, uint(0xD7, track_no + 1) + uint(0x73C5, 0x1236) + uint(0x83, 1)
                      + el(0x86, b"V_MJPEG") + el(0xE0, uint(0xB0, s.width) + uint(0xBA, s.height)))
                   if decoy else b""))
    n = len(samples)
    info = el(0x1549A966, uint(0x2AD7B1, 1_000_000) + el(0x4D80, b"cap4d container_writer")
              + el(0x5741, b"cap4d container_writer")
              + (el(0x4489, struct.pack(">d", float(n * ms if duration is True else duration)))
                 if duration else b""))

    # blocks: (decode indices) in each block, a key frame first in its block
    groups: List[List[int]] = []
    for j in range(n):
        if lacing and groups and not s.sync[j] and len(groups[-1]) < 3:
            groups[-1].append(j)
        else:
            groups.append([j])
    clusters, cluster = [], []
    for g in groups:
        if cluster and (sum(map(len, cluster)) >= 8 or s.sync[g[0]]):
            clusters.append(cluster)
            cluster = []
        cluster.append(g)
    clusters.append(cluster)

    body_parts, cue_points = [], []
    for cl in clusters:
        times = [s.rank[j] * ms for g in cl for j in g[:1]]
        cts = max(times) if negative else times[0]
        inner = uint(0xE7, cts)
        if audio:
            inner += el(0xA3, vint(1) + struct.pack(">hB", 0, 0x80) + b"\0" * 320)
        for g in cl:
            frames = [samples[j] for j in g]
            rel = s.rank[g[0]] * ms - cts
            # a block of one frame is not laced, as muxers write it
            flags, lace_head = _lace(frames, lacing) if len(frames) > 1 else (0, b"")
            key = s.sync[g[0]]
            block = vint(track_no) + struct.pack(">hB", rel, flags | (0x80 if key and
                                                                      blocks == "simple" else 0))
            block += lace_head + b"".join(frames)
            if decoy:
                inner += el(0xA3, vint(track_no + 1) + struct.pack(">hB", rel, 0x80) + decoy)
            if blocks == "simple":
                inner += el(0xA3, block)
            else:
                ref = b"" if key else el(0xFB, struct.pack(">b", -ms))
                more = (el(0x75A1, el(0xA6, uint(0xEE, 1) + el(0xA5, block_additions[g[0]])))
                        if block_additions else b"")
                inner += el(0xA0, el(0xA1, block) + more + ref)
            if key:
                cue_points.append((s.rank[g[0]] * ms, len(body_parts)))
        body_parts.append(inner)
    # the layout: SeekHead (fixed size), Info, Tracks, clusters, Cues
    seek_len = len(el(0x114D9B74, b"".join(
        el(0x4DBB, el(0x53AB, _id(i)) + uint(0x53AC, 0, 8)) for i in (
            0x1549A966, 0x1654AE6B, 0x1C53BB6B)[:3 if cues else 2])))
    at = seek_len + len(info) + len(tracks)
    cluster_pos, data = [], b""
    for inner in body_parts:
        cluster_pos.append(at + len(data))
        data += _id(0x1F43B675) + (UNKNOWN if unknown_sizes else vint(len(inner))) + inner
    cues_el = b""
    if cues:
        cues_el = el(0x1C53BB6B, b"".join(
            el(0xBB, uint(0xB3, t) + el(0xB7, uint(0xF7, track_no)
                                       + uint(0xF1, cluster_pos[c])))
            for t, c in cue_points))
    positions = {0x1549A966: seek_len, 0x1654AE6B: seek_len + len(info),
                 0x1C53BB6B: at + len(data)}
    seek = el(0x114D9B74, b"".join(
        el(0x4DBB, el(0x53AB, _id(i)) + uint(0x53AC, positions[i], 8))
        for i in (0x1549A966, 0x1654AE6B, 0x1C53BB6B)[:3 if cues else 2]))
    segment = seek + info + tracks + data + cues_el
    ebml = el(0x1A45DFA3, uint(0x4286, 1) + uint(0x42F7, 1) + uint(0x42F2, 4) + uint(0x42F3, 8)
              + el(0x4282, doc_type.encode()) + uint(0x4287, 4 if doc_type == "matroska" else 2)
              + uint(0x4285, 2))
    out = ebml + _id(0x18538067) + (UNKNOWN if unknown_sizes else vint(len(segment), 8)) + segment
    Path(path).write_bytes(out)


# The cv2-written files under tests/data/containers/ (cv2 5.0.0's
# VideoWriter; tests/test_torch_containers.py writes them): cv2's frame
# count and the SHA-256 of the port's RGB frames, every frame in order. The
# tests hold those frames against cap4d_tpu's cv2 reader; chip_smoke.py
# holds the card's read of the same files, on a machine without cv2, here
PINNED_CV2_RGB_SHA256 = {
    "mjpg_avi": (24, "342d8c47cd436a4a6169a3ddde90bc755fc312281764f2890f2ed9bf4f14508a"),
    "xvid_avi": (26, "60d79d5d6c3aa176bc8f0759501ecf2f86a07e87a098e15f24a64539c0a41db6"),
    "png_avi": (10, "da398da1ca8010cdba009979d893cee0026ad110820e845a98b560cf581ea778"),
    "mjpg_mkv": (20, "fb95c10fd552bea5e8829685a8c58b5d28b20592163d244fed1694629360a659"),
    "mp4v_mkv": (26, "be39e977d43e397cb01354fcd9d70ab171ef5e8460f757f0dce8be07f4d97071"),
    "vp90_webm": (6, "a12092ffe59acde1c994c260a8c9af1d822be1639503405eda222b28a32568b2"),
}
CV2_FILE_SUFFIX = {"mjpg_avi": ".avi", "xvid_avi": ".avi", "png_avi": ".avi", "mjpg_mkv": ".mkv",
                   "mp4v_mkv": ".mkv", "vp90_webm": ".webm"}


def rgb_sha256(frames) -> str:
    """SHA-256 of RGB frames, in order: what :data:`PINNED_CV2_RGB_SHA256`
    holds."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    return h.hexdigest()
