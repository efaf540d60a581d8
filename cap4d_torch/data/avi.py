"""A RIFF AVI demuxer in pure Python: the sample table of a file's first
video stream, as ffmpeg's ``avidec`` (inside cv2) reads it.

What it walks: ``RIFF AVI`` and any ``RIFF AVIX`` parts after it (OpenDML
files past 1 GiB); in ``hdrl`` the ``strl`` lists in order, taking the first
whose ``strh.fccType`` is ``vids`` (ffmpeg's first video stream, the one cv2
reads): ``strh``'s ``dwScale``, ``dwRate``, ``dwStart`` and ``dwLength``,
``strf``'s BITMAPINFOHEADER (``biCompression``, width, height, negative for
a top-down picture, and the extradata after its 40 bytes) and an OpenDML
``indx``. The stream's samples are its ``NNdc``/``NNdb`` chunks.

The index, in ffmpeg's order: the OpenDML super index and the standard
indexes (``ix##``) it points to, across the ``AVIX`` parts; else ``idx1``,
whose offsets count from the ``movi`` list or from the start of the file
(decided from its first entry, as ``avidec`` does); else a scan of every
``movi`` list. Key frames: ``AVIIF_KEYFRAME`` in ``idx1`` (the first entry
when none has it), bit 31 of a standard index entry's size clear; after a
scan, the samples that hold an IDR picture or an I-VOP (every Motion-JPEG
and PNG sample).

AVI carries no presentation times: ``pts`` are the decode indices and the
track says so (``timed`` False); ``VideoFrameReader`` takes a reordering
stream's presentation order from the stream (H.264's picture order count,
MPEG-4's B-VOPs). cv2's frame count is ``dwLength`` (``frame_count``);
``dwStart`` is read and moves no frame: frame k is the k-th picture.

Codecs (:data:`AVI_CODECS`, by ``biCompression``, else ``strh``'s handler):
Motion-JPEG, PNG (``MPNG``), MPEG-4 Part 2 (``FMP4``, ``XVID``, ``DIVX``,
``DX50``, ``MP4V``; the VOL in the extradata or in band), H.264 (``H264``,
``X264``, ``AVC1``, ``DAVC``: Annex-B access units, the parameter sets from
the extradata, an avcC there, or the first key frame) and VP9 (``VP90``, one
frame or superframe a chunk, as ffmpeg's avienc writes it; cv2 reads such a
file, so the port does), VP8 (``VP80``, cv2's VideoWriter's fourcc for
it: one frame a chunk, the key frames by the frame tag's bit 0) and HEVC
(``HEVC``, ``H265``, ``hvc1``, ``hev1``: Annex-B access units, the parameter
sets from the extradata, an hvcC there, or in band; presentation order from
the picture order count, as for H.264; key frames after a scan are the IRAP
pictures). Anything
else raises
``ValueError`` naming the four-character code, as do a zero-size video
chunk (a dropped frame: ffmpeg's index skips it and its timestamps jump),
an index entry past the end of the file and a malformed header.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from cap4d_torch.data.mp4 import (AvcConfig, HvcConfig, Mp4vConfig, VideoTrack,
                                  first_slice_header, length_prefixed, parse_avcc, parse_hvcc,
                                  split_annexb)

_MJPEG = ("MJPG", "mjpg", "AVRn", "AVDJ", "ACDV", "QIVG", "SLMJ", "CJPG", "IJPG", "JPGL", "dmb1",
          "JPEG")
_MPEG4 = ("FMP4", "XVID", "DIVX", "DX50", "MP4V", "MP4S", "M4S2")
_H264 = ("H264", "X264", "AVC1", "DAVC")
_VP9 = ("VP90",)
_VP8 = ("VP80",)
_HEVC = ("HEVC", "H265", "hevc", "h265", "hvc1", "hev1", "HVC1", "HEV1")
# biCompression -> codec (CODECS' names)
AVI_CODECS = {**{f: "mjpeg" for f in _MJPEG}, "MPNG": "png", "PNG ": "png", "png ": "png",
              **{f: "mpeg4" for f in _MPEG4 + tuple(x.lower() for x in _MPEG4)},
              **{f: "h264" for f in _H264 + tuple(x.lower() for x in _H264)},
              **{f: "vp9" for f in _VP9}, **{f: "vp8" for f in _VP8},
              **{f: "hevc" for f in _HEVC}}
# what a refused four-character code is, where the name says little
REFUSED_NAMES = {"DIV3": "MS-MPEG-4 v3", "div3": "MS-MPEG-4 v3", "MP43": "MS-MPEG-4 v3",
                 "mp43": "MS-MPEG-4 v3", "MP42": "MS-MPEG-4 v2", "mp42": "MS-MPEG-4 v2",
                 "MPG4": "MS-MPEG-4 v1", "DIV4": "MS-MPEG-4 v3",
                 "AV01": "AV1",
                 "WMV3": "WMV9", "mpg2": "MPEG-2 video", "MPG2": "MPEG-2 video"}
AVIIF_KEYFRAME = 0x10
# bytes of a sample read to find its picture type after an index-less scan
SCAN_BYTES = 4096


def _header(buf: bytes, pos: int) -> Tuple[str, int]:
    kind, size = struct.unpack_from("<4sI", buf, pos)
    return kind.decode("latin-1"), size


def _chunks(buf: bytes, start: int, end: int):
    """(fourcc, payload start, payload size) of the chunks in ``buf[start:end]``;
    a list's fourcc is "LIST" and its payload starts at its type."""
    pos = start
    while pos + 8 <= end:
        kind, size = _header(buf, pos)
        yield kind, pos + 8, min(size, end - pos - 8)
        pos += 8 + size + (size & 1)


def _stream_number(ckid: bytes) -> int:
    """``NN`` of a chunk id ``NNxx``, -1 when it is not one."""
    a, b = ckid[0] - 48, ckid[1] - 48
    return 10 * a + b if 0 <= a <= 9 and 0 <= b <= 9 else -1


class _Avi:
    """The parts of one file: its header list, each ``movi`` list's
    (fourcc position, end) and the ``idx1`` of the first part."""

    def __init__(self, fh, where: str):
        self.fh, self.where = fh, where
        self.size = fh.seek(0, 2)
        self.hdrl: Optional[bytes] = None
        self.movi: List[Tuple[int, int]] = []
        self.idx1: Optional[bytes] = None
        pos, part = 0, 0
        while pos + 12 <= self.size:
            kind, size, form = struct.unpack("<4sI4s", self._read(pos, 12))
            if kind != b"RIFF" or form != (b"AVI " if part == 0 else b"AVIX"):
                if part == 0:
                    raise ValueError(f"{where}: not a RIFF AVI file")
                break      # trailing bytes after the last part
            end = min(pos + 8 + size, self.size) if size else self.size
            self._part(pos + 12, end, part)
            pos, part = end + (end & 1), part + 1
        if self.hdrl is None:
            raise ValueError(f"{where}: an AVI file without its hdrl header list")

    def _read(self, pos: int, n: int) -> bytes:
        self.fh.seek(pos)
        return self.fh.read(n)

    def _part(self, start: int, end: int, part: int) -> None:
        pos = start
        while pos + 8 <= end:
            kind, size = _header(self._read(pos, 8), 0)
            stop = min(pos + 8 + size, end)
            if kind == "LIST" and stop - pos >= 12:
                form = self._read(pos + 8, 4)
                if form == b"hdrl" and part == 0:
                    self.hdrl = self._read(pos + 12, stop - pos - 12)
                elif form == b"movi":
                    self.movi.append((pos + 8, stop))
            elif kind == "idx1" and part == 0:
                self.idx1 = self._read(pos + 8, stop - pos - 8)
            pos += 8 + size + (size & 1)


def _video_stream(hdrl: bytes, where: str):
    """(stream number, strh fields, strf payload, indx payload) of the first
    ``vids`` stream."""
    number = 0
    for kind, a, n in _chunks(hdrl, 0, len(hdrl)):
        if kind != "LIST" or hdrl[a:a + 4] != b"strl":
            continue
        kids = {}
        for k, ka, kn in _chunks(hdrl, a + 4, a + n):
            kids.setdefault(k, hdrl[ka:ka + kn])
        strh = kids.get("strh", b"")
        if len(strh) >= 36 and strh[:4] == b"vids":
            if "strf" not in kids or len(kids["strf"]) < 40:
                raise ValueError(f"{where}: the video stream has no BITMAPINFOHEADER (strf)")
            return number, struct.unpack_from("<4s4sIHHIIIII", strh), kids["strf"], kids.get("indx")
        number += 1
    raise ValueError(f"{where}: no video stream (no strl whose strh is 'vids')")


def _odml_index(avi: _Avi, indx: bytes, number: int):
    """[(data offset, size, key)] from an OpenDML index: a super index whose
    entries name standard indexes (``ix##`` chunks), or a standard index."""
    longs, sub, kind, n = struct.unpack_from("<HBBI", indx)
    if kind == 0:                                    # AVI_INDEX_OF_INDEXES
        out = []
        for e in range(n):
            off = struct.unpack_from("<Q", indx, 24 + 16 * e)[0]
            size = _header(avi._read(off, 8), 0)[1] if off + 8 <= avi.size else -1
            if size < 0 or off + 8 + size > avi.size:
                raise ValueError(f"{avi.where}: an OpenDML index entry points past the end "
                                 "of the file")
            out += _odml_index(avi, avi._read(off + 8, size), number)
        return out
    if kind != 1 or sub != 0 or longs != 2:
        raise ValueError(f"{avi.where}: an OpenDML index of type {kind}, sub-type {sub} "
                         f"({longs} words an entry; field indexes are not supported)")
    base = struct.unpack_from("<Q", indx, 12)[0]
    if 24 + 8 * n > len(indx):
        raise ValueError(f"{avi.where}: an OpenDML index lists {n} entries but holds fewer")
    raw = np.frombuffer(indx, "<u4", 2 * n, 24).reshape(n, 2).astype(np.int64)
    return [(base + int(o), int(s) & 0x7FFFFFFF, not int(s) >> 31) for o, s in raw]


def _idx1_index(avi: _Avi, number: int):
    """[(data offset, size, key)] of the stream's ``idx1`` entries, offsets
    anchored as ``avidec`` anchors them: the first entry of the index lands
    on the first chunk of ``movi``, unless it already names the position
    just past the ``movi`` type with the first chunk at least 500 bytes on."""
    idx = avi.idx1
    n = len(idx) // 16
    if not n or not avi.movi:
        return []
    movi = avi.movi[0][0]                    # the position of the "movi" type
    first_chunk, pos = None, movi + 4
    while pos + 8 <= avi.movi[0][1]:
        kind, size = _header(avi._read(pos, 8), 0)
        if _stream_number(kind.encode("latin-1")) >= 0:
            first_chunk = pos
            break
        pos += (12 if kind == "LIST" else 8 + size + (size & 1))
    entries = np.frombuffer(idx, np.dtype([("id", "S4"), ("flags", "<u4"), ("off", "<u4"),
                                           ("size", "<u4")]), n)
    shift = 0
    first = int(entries["off"][0])
    if first_chunk is not None and (movi + 4 != first or first + 500 > first_chunk):
        shift = first_chunk - first
    anykey = bool(np.any(entries["flags"] & AVIIF_KEYFRAME))
    out = []
    for e in range(n):
        ckid = bytes(entries["id"][e]).ljust(4, b"\0")
        if _stream_number(ckid) != number or ckid[2:] not in (b"dc", b"db"):
            continue
        key = bool(entries["flags"][e] & AVIIF_KEYFRAME) or (not anykey and not out)
        out.append((int(entries["off"][e]) + shift + 8, int(entries["size"][e]), key))
    return out


def _scan_movi(avi: _Avi, number: int):
    """[(data offset, size, None)] of the stream's chunks in every ``movi``
    list; a chunk cut off by the end of the file ends the scan."""
    tags = (b"%02ddc" % number, b"%02ddb" % number)
    out = []
    for start, end in avi.movi:
        pos = start + 4
        while pos + 8 <= end:
            kind, size = _header(avi._read(pos, 8), 0)
            if kind == "LIST":
                pos += 12                     # a "rec " list: its chunks follow
                continue
            if kind.encode("latin-1") in tags:
                if pos + 8 + size > avi.size:
                    break
                out.append((pos + 8, size, None))
            pos += 8 + size + (size & 1)
    return out


def _key_by_content(codec: str, data: bytes, length_size: Optional[int]) -> bool:
    """Whether a sample's first bytes hold an IDR picture (H.264: Annex-B,
    or NAL lengths of ``length_size`` bytes), an I-VOP (MPEG-4) or a VP9 key
    frame (its first frame's frame_type) or VP8 key frame; every
    Motion-JPEG and PNG sample is one."""
    if codec == "h264":
        head = first_slice_header(data if length_size else length_prefixed(data), length_size or 4)
        return head >= 0 and head & 0x1F == 5
    if codec == "mpeg4":
        at = data.find(b"\0\0\1\xb6")
        return 0 <= at and at + 4 < len(data) and data[at + 4] >> 6 == 0
    if codec == "vp9":
        return vp9_key(data)
    if codec == "vp8":
        return vp8_key(data)
    if codec == "hevc":
        return hevc_irap(data if length_size else length_prefixed(data), length_size or 4)
    return True


def hevc_irap(sample: bytes, length_size: int) -> bool:
    """Whether the first VCL NAL unit of an HEVC sample of length-prefixed NAL
    units is an IRAP picture's (nal_unit_type 16-23)."""
    pos = 0
    while pos + length_size < len(sample):
        n = int.from_bytes(sample[pos:pos + length_size], "big")
        pos += length_size
        if n and pos < len(sample):
            kind = (sample[pos] >> 1) & 0x3F
            if kind < 32:
                return 16 <= kind <= 23
        pos += n
    return False


def is_hvcc(extra: bytes) -> bool:
    """Whether extradata is an hvcC record, by ffmpeg's hevc decoder's test
    (not a start code in its first three bytes)."""
    return len(extra) > 3 and bool(extra[0] or extra[1] or extra[2] > 1)


def hevc_config(extra: bytes) -> HvcConfig:
    """The parameter sets of an HEVC stream's extradata: an hvcC (samples then
    carry its NAL lengths), or Annex-B VPS/SPS/PPS (samples Annex-B), or
    none (in band)."""
    if is_hvcc(extra):
        return parse_hvcc(extra)
    params = tuple(b"\0\0\0\1" + nal for nal in split_annexb(extra)) if extra.strip(b"\0") else ()
    return HvcConfig(params, 4, 0)


def vp8_key(data: bytes) -> bool:
    """Whether a VP8 sample is a key frame: bit 0 of its frame tag clear."""
    return bool(data) and not data[0] & 1


def vp9_key(data: bytes) -> bool:
    """Whether a VP9 sample's first frame is a key frame: frame_marker 2,
    then after the profile bits show_existing_frame 0 and frame_type 0."""
    if not data:
        return False
    bits = int.from_bytes(data[:2].ljust(2, b"\0"), "big")
    profile = (bits >> 13 & 1) | (bits >> 12 & 1) << 1
    at = 11 - (profile == 3)           # the bit after the profile (and its reserved bit)
    return bits >> 14 == 2 and not bits >> at & 1 and not bits >> (at - 1) & 1


def _avc_config(extra: bytes, first_key: bytes, where: str) -> Tuple[AvcConfig, bool]:
    """(the parameter sets, whether samples are Annex-B) of an H.264
    stream: an avcC in the extradata (samples then carry its NAL lengths),
    Annex-B parameter sets there, or those of the first key frame."""
    if extra[:1] == b"\x01":
        return parse_avcc(extra), False
    sps, pps = [], []
    for source in (extra, first_key):
        if not source:
            continue
        for nal in split_annexb(source):
            if nal and nal[0] & 0x1F == 7:
                sps.append(b"\0\0\0\1" + nal)
            elif nal and nal[0] & 0x1F == 8:
                pps.append(b"\0\0\0\1" + nal)
        if sps:
            break
    if not sps or not pps:
        raise ValueError(f"{where}: an H.264 stream with no sequence and picture parameter sets "
                         "(neither in strf's extradata nor in its first key frame)")
    return AvcConfig(tuple(sps), tuple(pps), 4, sps[0][5], sps[0][7]), True


def read_track(path) -> VideoTrack:
    """The sample table of the first video stream of the AVI ``path``."""
    where = str(path)
    with open(path, "rb") as fh:
        try:
            return _read(fh, where)
        except (struct.error, IndexError) as e:    # a field past the end of its chunk
            raise ValueError(f"{where}: malformed AVI header or index ({e})") from e


def _read(fh, where: str) -> VideoTrack:
    avi = _Avi(fh, where)
    number, strh, strf, indx = _video_stream(avi.hdrl, where)
    _, handler, _, _, _, _, scale, rate, start, length = strh
    _, width, height, _, _, compression = struct.unpack_from("<IiiHH4s", strf)
    fourcc = compression.decode("latin-1")
    codec = AVI_CODECS.get(fourcc)
    if codec is None and compression.strip(b"\0") == b"":
        fourcc = handler.decode("latin-1")
        codec = AVI_CODECS.get(fourcc)
    if codec is None:
        name = REFUSED_NAMES.get(fourcc)
        raise ValueError(f"{where}: codec {fourcc!r}{f' ({name})' if name else ''} is not "
                         "supported; the port reads AVI video as Motion-JPEG (MJPG), PNG (MPNG), "
                         "MPEG-4 Part 2 (FMP4, XVID, DIVX, DX50, MP4V), H.264 (H264, X264, "
                         "AVC1, DAVC), HEVC (HEVC, H265, hvc1, hev1), VP8 (VP80) and VP9 (VP90)")
    entries = []
    if indx is not None and len(indx) >= 24 and struct.unpack_from("<I", indx, 4)[0]:
        entries = _odml_index(avi, indx, number)
    if not entries and avi.idx1:
        entries = _idx1_index(avi, number)
    scanned = not entries
    if scanned:
        entries = _scan_movi(avi, number)
    if not entries:
        raise ValueError(f"{where}: the video stream has no samples")
    offsets = np.array([e[0] for e in entries], np.int64)
    sizes = np.array([e[1] for e in entries], np.int64)
    if np.any(sizes == 0):
        k = int(np.flatnonzero(sizes == 0)[0])
        raise ValueError(f"{where}: sample {k} is a zero-size chunk (a dropped frame); AVI files "
                         "with dropped frames are not supported")
    if np.any(offsets + sizes > avi.size):
        k = int(np.flatnonzero(offsets + sizes > avi.size)[0])
        raise ValueError(f"{where}: the index puts sample {k} past the end of the file (a cut "
                         "file)")
    extra = bytes(strf[40:])

    def head(j: int, limit: Optional[int] = None) -> bytes:
        fh.seek(int(offsets[j]))
        return fh.read(int(sizes[j]) if limit is None else min(limit, int(sizes[j])))

    if scanned:
        length_size = None
        if codec == "h264" and extra[:1] == b"\1":
            length_size = parse_avcc(extra).length_size
        elif codec == "hevc" and is_hvcc(extra):
            length_size = parse_hvcc(extra).length_size
        sync = np.array([_key_by_content(codec, head(j, SCAN_BYTES), length_size)
                         for j in range(len(entries))])
    else:
        sync = np.array([bool(e[2]) for e in entries])
    avc = m4v = hvc = None
    annexb = False
    if codec == "h264":
        keys = np.flatnonzero(sync)
        avc, annexb = _avc_config(extra, head(int(keys[0])) if len(keys) else b"", where)
    elif codec == "hevc":
        hvc = hevc_config(extra)
        annexb = not is_hvcc(extra)
    elif codec == "mpeg4":
        m4v = Mp4vConfig(0x20, extra)
    n = len(entries)
    index = np.arange(n, dtype=np.int64)
    pts = (start + index) * max(scale, 1)
    return VideoTrack(where, codec, fourcc, abs(width), abs(height), max(rate, 1), offsets, sizes,
                      pts, pts.copy(), sync, index, avc, None, m4v, timed=False,
                      frame_count=int(length), annexb=annexb, hvc=hvc)
