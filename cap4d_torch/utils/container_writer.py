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
from typing import List, Optional, Tuple

from cap4d_torch.data import mp4

# codec -> the four-character code cv2's ffmpeg writes into an AVI
AVI_FOURCC = {"h264": b"H264", "mpeg4": b"FMP4", "mjpeg": b"MJPG", "png": b"MPNG", "vp9": b"VP90",
              "vp8": b"VP80", "hevc": b"HEVC"}
AVIIF_KEYFRAME = 0x10


@dataclass
class Stream:
    """Samples in decode order (H.264 and HEVC with the mp4's NAL lengths),
    their sync flags and presentation indices, and what the codec needs."""

    codec: str
    width: int
    height: int
    samples: List[bytes]
    sync: List[bool]
    rank: List[int]
    avc: Optional[mp4.AvcConfig] = None
    dsi: bytes = b""
    vpc: Optional[mp4.VpcConfig] = None
    hvc: Optional[mp4.HvcConfig] = None


def stream_of_mp4(path) -> Stream:
    """The first video track of an mp4 file as a :class:`Stream`."""
    t = mp4.read_track(path)
    rank = [0] * len(t)
    for k, j in enumerate(t.order):
        rank[int(j)] = k
    return Stream(t.codec, t.width, t.height, [t.sample(i) for i in range(len(t))],
                  [bool(s) for s in t.sync], rank, t.avc, t.m4v.dsi if t.m4v else b"", t.vpc, t.hvc)


def _annexb_params(s: Stream) -> bytes:
    if s.codec == "hevc":
        return b"".join(s.hvc.params)
    return b"".join(s.avc.sps) + b"".join(s.avc.pps)


def hvcc(hvc: mp4.HvcConfig) -> bytes:
    """An ``hvcC`` payload (HEVCDecoderConfigurationRecord, 4-byte NAL
    lengths) holding ``hvc``'s parameter sets, one array per NAL type."""
    arrays: dict = {}
    for nal in hvc.params:
        body = nal[4:] if nal[:4] == b"\0\0\0\1" else nal[3:]
        arrays.setdefault((body[0] >> 1) & 0x3F, []).append(body)
    head = (bytes([1, hvc.profile & 0x1F]) + struct.pack(">I", 1 << (31 - (hvc.profile & 31)))
            + b"\x90" + b"\0" * 5 + bytes([120]) + struct.pack(">H", 0xF000)
            + bytes([0xFC, 0xFD, 0xF8, 0xF8]) + struct.pack(">H", 0) + bytes([0x0F, len(arrays)]))
    return head + b"".join(bytes([0x80 | kind]) + struct.pack(">H", len(nals))
                           + b"".join(struct.pack(">H", len(n)) + n for n in nals)
                           for kind, nals in sorted(arrays.items()))


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
        if s.codec in ("h264", "hevc"):
            data = mp4.annexb(data, (s.avc or s.hvc).length_size)
            if in_band and key:
                data = _annexb_params(s) + data
        elif s.codec == "mpeg4" and in_band and key:
            data = s.dsi + data
        out.append(data)
    if not in_band:
        extra = _annexb_params(s) if s.codec in ("h264", "hevc") else s.dsi
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
              block_additions: Optional[List[bytes]] = None,
              chroma_siting: Optional[Tuple[int, int]] = None,
              projection: Optional[Tuple[Optional[int], float, float, float]] = None) -> None:
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
    (BlockAddID 1), where browsers put a VP8 alpha plane; ``chroma_siting``
    (ChromaSitingHorz, ChromaSitingVert: 0 unspecified, 1 left or top
    collocated, 2 half) adds a Colour element with the two; ``projection``
    (ProjectionType, or None to leave it out, then ProjectionPoseYaw,
    ProjectionPosePitch and ProjectionPoseRoll in degrees, 8-byte floats)
    adds a Projection element."""
    ms = 1000 // fps
    track_no = 2 if audio else 1
    if codec_id is None:
        if vfw or s.codec == "png":
            extra, samples = _payloads(s, in_band=False)
            codec_id = "V_MS/VFW/FOURCC"
            private = bitmap_info_header(AVI_FOURCC[s.codec], s.width, s.height, extra)
        else:
            codec_id = {"h264": "V_MPEG4/ISO/AVC", "mpeg4": "V_MPEG4/ISO/ASP",
                        "mjpeg": "V_MJPEG", "vp9": "V_VP9", "vp8": "V_VP8",
                        "hevc": "V_MPEGH/ISO/HEVC"}[s.codec]
            private = (avcc(s.avc) if s.codec == "h264" else hvcc(s.hvc) if s.codec == "hevc"
                       else s.dsi)
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
               + el(0xE0, uint(0xB0, s.width) + uint(0xBA, s.height)
                    + (el(0x55B0, uint(0x55B7, chroma_siting[0]) + uint(0x55B8, chroma_siting[1]))
                       if chroma_siting else b"")
                    + (el(0x7670, (uint(0x7671, projection[0]) if projection[0] is not None
                                   else b"")
                          + b"".join(el(i, struct.pack(">d", v)) for i, v in
                                     zip((0x7673, 0x7674, 0x7675), projection[1:])))
                       if projection else b""))
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


# ------------------------------------------------------- fragmented mp4 --

# The layouts the tests hold against cv2 and chip_smoke.py reads on the
# card: name -> write_fragmented_mp4's keyword arguments
FRAGMENTED_LAYOUTS = {
    "gop": {},                       # ffmpeg's frag_keyframe: trex defaults, moof base, tfdt v1
    "count5_tfhd_implicit": dict(fragment=5, defaults="tfhd", base="implicit"),
    "sample_explicit_no_tfdt": dict(defaults="sample", base="explicit", tfdt=None),
    "tfdt_v0_trun_v1": dict(tfdt=0, trun_version=1),
    "trun_v0_negative": dict(delay=0),
    "audio_implicit": dict(audio=True, base="implicit", fragment=4),
    "audio_trun_v1": dict(audio=True, trun_version=1),
    "dash_mfra": dict(dash=True, mfra=True),
    "hybrid": dict(moov_samples=6),
    "cut_short": dict(fragment=4, cut="short"),
    "cut_no_mdat": dict(fragment=4, cut="no_mdat"),
    "live": dict(zero_durations=True, tfdt=None),
}
# edit lists in frames ((media time, frames), -1 an empty edit): the four
# ffmpeg reads with several media edits (a cut, a swap, a repeat, a delay
# and a cut), on a stream of sync samples
EDIT_LISTS = {"cut": [(0, 10), (20, 10)], "swap": [(20, 10), (0, 10)],
              "repeat": [(5, 5), (5, 5)], "delay_cut": [(-1, 4), (0, 10), (15, 5)]}

# trun/trex sample flags as ffmpeg's muxer writes them: a sync sample
# depends on no other; any other depends on others and is not a sync sample
SYNC_FLAGS, NON_SYNC_FLAGS = 0x02000000, 0x01010000
TFHD_BASE, TFHD_DESCRIPTION, TFHD_DURATION, TFHD_SIZE, TFHD_FLAGS, TFHD_MOOF = (
    0x1, 0x2, 0x8, 0x10, 0x20, 0x20000)
TRUN_DATA, TRUN_FIRST, TRUN_DURATION, TRUN_SIZE, TRUN_FLAGS, TRUN_CTS = (
    0x1, 0x4, 0x100, 0x200, 0x400, 0x800)
AUDIO_TICKS = 512       # PCM frames (2 bytes each) of an audio sample, one a video frame


def fragment_streams(d, mjpeg_frames) -> dict:
    """{name: (flat file, Stream)} of the streams FRAGMENTED_LAYOUTS wraps,
    written into the directory ``d``: the H.264 B and MPEG-4 B-VOP
    writers' (their planes pinned in ``h264_writer`` and ``mpeg4_writer``),
    the committed VP9 ``tests/data/vp9/writer.mp4`` and ``mjpeg_frames``
    (RGB uint8) as Motion-JPEG of the port's encoder."""
    from cap4d_torch.utils import h264_writer as hw
    from cap4d_torch.utils import mpeg4_writer as mw
    from cap4d_torch.utils import synthetic_assets as sa

    d = Path(d)
    hw.write_h264_syntax_mp4(d / "h264_b.mp4", 128, 96, 16, 1, "cavlc", b_frames=True)
    mw.write_mpeg4_syntax_mp4(d / "mpeg4_b.mp4", *mw.STREAMS["advanced"][:4],
                              **mw.STREAMS["advanced"][4])
    sa.write_mjpeg_video(d / "mjpeg.mov", mjpeg_frames)
    vp9 = Path(__file__).resolve().parents[2] / "tests" / "data" / "vp9" / "writer.mp4"
    return {name: (path, stream_of_mp4(path)) for name, path in (
        ("h264_b", d / "h264_b.mp4"), ("mpeg4_b", d / "mpeg4_b.mp4"), ("vp9", vp9),
        ("mjpeg", d / "mjpeg.mov"))}


def write_edited_mp4(path, s: Stream, edits) -> None:
    """``s`` as a flat mp4 (``synthetic_assets.write_mp4``) with the edit
    list ``edits``, whose media times count frames from the first shown
    (the stream's B-frame delay added, as ffmpeg's muxer writes it)."""
    from cap4d_torch.utils import synthetic_assets as sa

    delay = max(j - r for j, r in enumerate(s.rank))
    ctts = [r - j + delay for j, r in enumerate(s.rank)] if delay else None
    edits = [(t + delay if t >= 0 else t, *rest) for t, *rest in edits]
    sa.write_mp4(path, s.samples, mp4_sample_entry(s), s.width, s.height, sync=s.sync, ctts=ctts,
                 edits=edits)


def mp4_sample_entry(s: Stream, fourcc: Optional[bytes] = None) -> bytes:
    """The mp4 sample entry of ``s``'s codec (``avc1``, ``hvc1``, ``mp4v``,
    ``vp09``, ``vp08``, ``jpeg``, ``png ``; ``fourcc`` overrides the code, as
    ``hev1``)."""
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_torch.utils.mpeg4_writer import esds_box

    if s.codec == "h264":
        kids = [sa._box(b"avcC", avcc(s.avc))]
    elif s.codec == "hevc":
        kids = [sa._box(b"hvcC", hvcc(s.hvc))]
    elif s.codec == "mpeg4":
        kids = [esds_box(s.dsi)]
    elif s.codec == "vp9":
        v = s.vpc
        kids = [sa._full_box(b"vpcC", 1, 0, bytes([
            v.profile, v.level, (v.bit_depth << 4) | (v.chroma_subsampling << 1) | v.full_range,
            v.colour_primaries, v.transfer, v.matrix, 0, 0]))]
    else:
        kids = []
    fourcc = fourcc or {"h264": b"avc1", "hevc": b"hvc1", "mpeg4": b"mp4v", "vp9": b"vp09",
                        "vp8": b"vp08", "mjpeg": b"jpeg", "png": b"png "}[s.codec]
    return sa.visual_sample_entry(fourcc, s.width, s.height, *kids)


def _trak(track_id: int, handler: bytes, entry: bytes, stbl: List[bytes], width: int,
          height: int, duration: int, edts: bytes = b"") -> bytes:
    from cap4d_torch.utils import synthetic_assets as sa

    media = (sa._full_box(b"vmhd", 0, 1, b"\0" * 8) if handler == b"vide" else
             sa._full_box(b"smhd", 0, 0, b"\0" * 4))
    minf = sa._box(b"minf", media, sa._box(b"dinf", sa._full_box(
        b"dref", 0, 0, struct.pack(">I", 1), sa._full_box(b"url ", 0, 1))),
        sa._box(b"stbl", sa._full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry), *stbl))
    mdia = sa._box(b"mdia", sa._full_box(b"mdhd", 0, 0, struct.pack(
        ">IIIIHH", 0, 0, sa.VIDEO_TIMESCALE, duration, 0x55C4, 0)),
        sa._full_box(b"hdlr", 0, 0, b"\0" * 4, handler, b"\0" * 12, b"Handler\0"), minf)
    tkhd = sa._full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, track_id, 0, duration),
                        b"\0" * 8, struct.pack(">hhhH", 0, 0, 0, 0x100 if handler == b"soun" else 0),
                        sa.UNITY_MATRIX, struct.pack(">II", width << 16, height << 16))
    return sa._box(b"trak", tkhd, edts, mdia)


def _flat_stbl(sizes: List[int], offsets: List[int], sync: List[bool],
               cts: Optional[List[int]], ticks: int) -> List[bytes]:
    """Sample tables of samples stored one a chunk (the hybrid file's moov)."""
    from cap4d_torch.utils import synthetic_assets as sa

    n = len(sizes)
    stbl = [sa._full_box(b"stts", 0, 0, struct.pack(">I", 1 if n else 0),
                         struct.pack(">II", n, ticks) if n else b"")]
    if cts is not None and n:
        stbl.append(sa._full_box(b"ctts", 0, 0, struct.pack(f">I{2 * n}i", n, *[
            v for c in cts for v in (1, c)])))
    if n and not all(sync):
        keys = [i + 1 for i, k in enumerate(sync) if k]
        stbl.append(sa._full_box(b"stss", 0, 0, struct.pack(f">I{len(keys)}I", len(keys), *keys)))
    stbl += [sa._full_box(b"stsc", 0, 0, struct.pack(">I", 1 if n else 0),
                          struct.pack(">III", 1, 1, 1) if n else b""),
             sa._full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
             sa._full_box(b"stco", 0, 0, struct.pack(f">I{n}I", n, *offsets))]
    return stbl


def write_fragmented_mp4(path, s: Stream, *, fragment="gop", defaults: str = "trex",
                         base: str = "moof", tfdt: Optional[int] = 1, trun_version: int = 0,
                         delay: Optional[int] = None, edits=None, audio: bool = False,
                         dash: bool = False, mfra: bool = False, moov_samples: int = 0,
                         cut: Optional[str] = None, tfdt_frames: Optional[List[int]] = None,
                         zero_durations: bool = False,
                         non_sync_flags: int = NON_SYNC_FLAGS) -> None:
    """Write ``s`` at 24 fps as a fragmented mp4.

    ``fragment``: "gop" (a fragment from each sync sample on, ffmpeg's
    ``frag_keyframe``) or a sample count. ``defaults``: the sample
    duration and flags in "trex", in "tfhd", or every field in each
    "sample" of the ``trun`` (a run whose non-first sample is a sync sample
    carries flags per sample in every mode). ``base``: "moof"
    (default-base-is-moof, data offsets from the moof), "explicit"
    (base-data-offset, the file offset of the traf's data) or "implicit"
    (neither: the first traf's data offset is from its moof, a later
    traf's data follows the previous traf's). ``tfdt``: its version, None
    for none; ``tfdt_frames`` overrides each fragment's decode time (in
    frames). ``trun_version`` 0 writes composition offsets plus ``delay``
    frames (None: the least that makes them non-negative; a negative
    offset is written as the signed number), 1 signed offsets with
    ``delay`` 0; the edit list's media time is ``delay`` unless ``edits``
    (``synthetic_assets.edit_box``'s edits; ``[]`` for none) is given.
    ``audio``: a PCM track whose traf comes first in each moof, its data
    first in each mdat. ``dash``: ``styp`` and ``sidx`` before each
    fragment (DASH media segments joined after their init segment).
    ``mfra``: ``mfra/tfra/mfro`` at the end. ``moov_samples``: that many
    first samples in a flat ``mdat`` and the moov's tables (a hybrid file).
    ``cut``: "short" ends the file after the first half of the last
    fragment's samples (its ``mdat`` keeps its size), "no_mdat" before the
    last fragment's ``mdat``. ``zero_durations`` writes 0 as the
    mvhd, tkhd and mdhd durations, as a live writer leaves them;
    ``non_sync_flags`` are the sample flags of a sample that is no sync
    sample."""
    from cap4d_torch.utils import synthetic_assets as sa

    box, full = sa._box, sa._full_box
    ticks, n = sa.FRAME_TICKS, len(s.samples)
    offsets_frames = [r - j for j, r in enumerate(s.rank)]
    if delay is None:
        delay = max(0, -min(offsets_frames)) if trun_version == 0 else 0
    cts = [(c + delay) * ticks for c in offsets_frames]
    has_cts = any(cts)
    edts = sa.edit_box(edits if edits is not None else [(delay, n)], ticks) if (
        edits or (edits is None and delay)) else b""
    duration = 0 if zero_durations else n * ticks
    entry = mp4_sample_entry(s)
    audio_entry = box(b"sowt", b"\0" * 6, struct.pack(">H", 1), b"\0" * 8,
                      struct.pack(">HHHHI", 1, 16, 0, 0, sa.VIDEO_TIMESCALE << 16))
    ftyp = box(b"ftyp", b"iso6" if dash else b"isom", struct.pack(">I", 0x200),
               b"iso6dashmsix" if dash else b"isomiso2iso5mp41")
    # a hybrid file's flat part: ftyp, mdat with the first samples, then the moov
    m = moov_samples
    head = ftyp
    flat_offsets = []
    if m:
        pos = len(ftyp) + 8
        for j in range(m):
            flat_offsets.append(pos)
            pos += len(s.samples[j])
        head += box(b"mdat", *s.samples[:m])
    stbl = _flat_stbl([len(x) for x in s.samples[:m]], flat_offsets, s.sync[:m],
                      cts[:m] if has_cts else None, ticks)
    trex_dur, trex_flags = (ticks, non_sync_flags) if defaults == "trex" else (0, 0)
    mvex = box(b"mvex", full(b"mehd", 0, 0, struct.pack(">I", duration)),
               full(b"trex", 0, 0, struct.pack(">IIIII", 1, 1, trex_dur, 0, trex_flags)),
               *([full(b"trex", 0, 0, struct.pack(">IIIII", 2, 1, ticks, 2 * AUDIO_TICKS, 0))]
                 if audio else []))
    traks = [_trak(1, b"vide", entry, stbl, s.width, s.height, duration, edts)]
    if audio:
        traks.append(_trak(2, b"soun", audio_entry, _flat_stbl([], [], [], None, 1), 0, 0,
                           duration))
    mvhd = full(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, sa.VIDEO_TIMESCALE, duration,
                                           0x10000, 0x100), b"\0" * 10, sa.UNITY_MATRIX,
                b"\0" * 24, struct.pack(">I", 3 if audio else 2))
    out = bytearray(head + box(b"moov", mvhd, *traks, mvex))

    # the fragments: runs of decode indices
    rest = list(range(m, n))
    runs: List[List[int]] = []
    for j in rest:
        new = (s.sync[j] if fragment == "gop" else (j - m) % fragment == 0) or not runs
        if new:
            runs.append([j])
        else:
            runs[-1].append(j)
    tfra = []
    for seq, run in enumerate(runs, 1):
        last = seq == len(runs)
        video = [s.samples[j] for j in run]
        pcm = [b"\0" * (2 * AUDIO_TICKS)] * len(run) if audio else []
        per_sample_flags = defaults == "sample" or any(s.sync[j] for j in run[1:])
        start = run[0] if tfdt_frames is None else tfdt_frames[seq - 1]

        def trafs(moof_size: int, moof_pos: int):
            data_pos = moof_pos + moof_size + 8      # the mdat's payload
            parts, implicit_first = [], True
            tracks = ([(2, pcm)] if audio else []) + [(1, video)]
            at = data_pos
            for track, samples in tracks:
                size_all = sum(map(len, samples))
                if track == 2:
                    tf_flags = TFHD_DURATION | TFHD_SIZE
                    tf_fields = struct.pack(">II", ticks, 2 * AUDIO_TICKS)
                    count, tr_flags, rows, tr_first = len(samples), 0, b"", b""
                    decode_time = start * ticks
                else:
                    tf_flags, tf_fields = 0, b""
                    if defaults == "tfhd":
                        tf_flags |= TFHD_DESCRIPTION | TFHD_DURATION | TFHD_FLAGS
                        tf_fields = struct.pack(">III", 1, ticks, non_sync_flags)
                    tr_flags = TRUN_SIZE | (TRUN_CTS if has_cts else 0)
                    if defaults == "sample":
                        tr_flags |= TRUN_DURATION
                    tr_first = b""
                    if per_sample_flags:
                        tr_flags |= TRUN_FLAGS
                    elif s.sync[run[0]]:
                        tr_flags |= TRUN_FIRST
                        tr_first = struct.pack(">I", SYNC_FLAGS)
                    count = len(run)
                    rows = b""
                    for j in run:
                        if tr_flags & TRUN_DURATION:
                            rows += struct.pack(">I", ticks)
                        rows += struct.pack(">I", len(s.samples[j]))
                        if tr_flags & TRUN_FLAGS:
                            rows += struct.pack(">I", SYNC_FLAGS if s.sync[j] else non_sync_flags)
                        if tr_flags & TRUN_CTS:
                            rows += struct.pack(">i", cts[j])
                    decode_time = start * ticks
                data_offset = b""
                if base == "moof":
                    tf_flags |= TFHD_MOOF
                    tr_flags |= TRUN_DATA
                    data_offset = struct.pack(">i", at - moof_pos)
                elif base == "explicit":
                    tf_flags |= TFHD_BASE
                    tf_fields = struct.pack(">Q", at) + tf_fields
                elif implicit_first:
                    tr_flags |= TRUN_DATA
                    data_offset = struct.pack(">i", at - moof_pos)
                implicit_first = False
                tfhd = full(b"tfhd", 0, tf_flags, struct.pack(">I", track), tf_fields)
                dt = b"" if tfdt is None else full(
                    b"tfdt", tfdt, 0, struct.pack(">Q" if tfdt else ">I", decode_time))
                trun = full(b"trun", trun_version if track == 1 else 0, tr_flags,
                            struct.pack(">I", count), data_offset, tr_first, rows)
                parts.append(box(b"traf", tfhd, dt, trun))
                at += size_all
            return parts

        mfhd = full(b"mfhd", 0, 0, struct.pack(">I", seq))
        size = len(box(b"moof", mfhd, *trafs(0, 0)))
        if dash:      # the segment's earliest presentation time, its moof and mdat
            seg_pts = min(s.rank[j] for j in run) + delay
            out += box(b"styp", b"msdh", struct.pack(">I", 0), b"msdhmsix")
            out += full(b"sidx", 1, 0, struct.pack(">IIQQHH", 1, sa.VIDEO_TIMESCALE,
                                                   seg_pts * ticks, 0, 0, 1),
                        struct.pack(">III", size + 8 + sum(map(len, video + pcm)),
                                    len(run) * ticks, 0x90000000))
        moof_pos = len(out)
        out += box(b"moof", mfhd, *trafs(size, moof_pos))
        tfra.append((start * ticks, moof_pos))
        payload = b"".join(pcm) + b"".join(video)
        if last and cut == "no_mdat":
            break
        if last and cut == "short":     # the file ends after half the run's samples
            out += struct.pack(">I4s", 8 + len(payload), b"mdat")
            out += b"".join(pcm) + b"".join(video[:len(video) // 2])
            break
        out += box(b"mdat", payload)
    if mfra:      # tfra (version 1, one-byte traf, trun and sample numbers), then mfro
        body = full(b"tfra", 1, 0, struct.pack(">III", 1, 0, len(tfra)),
                    b"".join(struct.pack(">QQBBB", t, p, 1, 1, 1) for t, p in tfra))
        out += box(b"mfra", body, full(b"mfro", 0, 0, struct.pack(">I", 8 + len(body) + 16)))
    Path(path).write_bytes(bytes(out))


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


# SHA-256 of the port's RGB frames of every FRAGMENTED_LAYOUTS layout of
# each stream (layouts_sha256) and of EDIT_LISTS' files (rgb_sha256, with the
# frame count); tests/test_torch_fragmented.py holds those frames against
# cv2, chip_smoke.py reads the same files on the card
PINNED_FRAGMENTED_RGB_SHA256 = {
    "h264_b": "c3ec1b04ab576931f11b5797c01c1eafd20303f015997059001ed0bf33f9356e",
    "mpeg4_b": "91233b63e4bd02899bec73d232ff376bb30865e786a559361f07f0c4442a30cb",
    "vp9": "4aa7432bf164b7f73ec92eb6da3b20bc010d29492f3b6fa993df860676bfdd95",
    "mjpeg": "d2fa827e5271d6e06e505fdd93db95ef7ae4caca6d40439da72d6d682cb0b937",
}
PINNED_EDIT_RGB_SHA256 = {
    "cut": (20, "08e49bdeb8b49dff5bafc43c349a82ae351f187167a9cdf2b2586fe5ee9243dd"),
    "swap": (20, "ca1873fb37f9a70ae16766e1d8e504a00977679290c01e99dd6fa83bcd5d86b2"),
    "repeat": (10, "83389b99f611eea66dbf428f0c4ae94bf2102f6b06ec56a82d812b1ffbb91430"),
    "delay_cut": (15, "53112772d44f633249c8e3c1f2ce546946926e4a4dd1be4c48005ab1124f4078"),
    "fragmented": (20, "326b60f7cda25fb6bc3da12c53fbbc67f1eda21bf8bd58007761c6cfe4136d55"),
}
# the fragmented file of PINNED_EDIT_RGB_SHA256: the MPEG-4 B-VOP stream with
# two media edits, of which ffmpeg takes only the first's time offset
FRAGMENTED_EDITS = [(1, 10), (6, 5)]


def layouts_sha256(readers) -> str:
    """SHA-256 of each reader's length and RGB frames (up to the first that
    raises IndexError), reader after reader."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for r in readers:
        h.update(struct.pack("<q", len(r)))
        for k in range(len(r)):
            try:
                frame = r[k]
            except IndexError:
                break
            h.update(np.ascontiguousarray(frame).tobytes())
    return h.hexdigest()


def rgb_sha256(frames) -> str:
    """SHA-256 of RGB frames, in order: what :data:`PINNED_CV2_RGB_SHA256`
    holds."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    return h.hexdigest()


# ------------------------------------------------------- display matrix --

def rotation_matrix(degrees: float, mirror: str = "") -> Tuple[int, ...]:
    """A display matrix (9 fields: 16.16, 16.16, 2.30 fixed point, row by
    row) turning the picture ``degrees`` clockwise, as ffmpeg's
    ``av_display_rotation_set`` writes it, then mirrored ("h": the first
    column negated, "v": the second)."""
    import math

    r = -degrees * math.pi / 180.0
    c, s = math.cos(r), math.sin(r)
    m = [int(c * 65536), int(-s * 65536), 0, int(s * 65536), int(c * 65536), 0, 0, 0, 1 << 30]
    for i in range(9):
        m[i] *= -1 if (mirror == "h" and i % 3 == 0) or (mirror == "v" and i % 3 == 1) else 1
    return tuple(m)


def set_display_matrix(path, tkhd: Optional[Tuple[int, ...]] = None,
                       mvhd: Optional[Tuple[int, ...]] = None) -> None:
    """Overwrite, in place, the display matrix of the mp4/mov ``path``'s
    first ``tkhd`` (the video track in the files the writers make) and of
    its ``mvhd`` (each None: left as it is)."""
    data = bytearray(Path(path).read_bytes())
    for kind, fields, (v0, v1) in ((b"mvhd", mvhd, (36, 48)), (b"tkhd", tkhd, (40, 52))):
        if fields is not None:
            at = data.index(kind) + 4              # the box's version byte
            struct.pack_into(">9i", data, at + (v1 if data[at] == 1 else v0), *fields)
    Path(path).write_bytes(bytes(data))
