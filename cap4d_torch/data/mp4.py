"""An ISO-BMFF (``.mp4`` / ``.mov``) demuxer in pure Python: the sample
table of a file's first video track.

The JAX package reads video through cv2's ``VideoCapture`` (ffmpeg's mov
demuxer); the card's machine has neither cv2 nor ffmpeg, so the port reads
the container itself and hands each sample's bytes to a decoder
(``data/utils.py``'s ``VideoFrameReader``).

What it walks: ``ftyp`` (optional, as in older QuickTime files), then
``moov/trak/mdia/{mdhd,hdlr,minf/stbl}``, taking the first track whose
handler is ``vide``; in ``stbl`` the boxes ``stsd``, ``stts``, ``ctts``,
``stss``, ``stsc``, ``stsz``/``stz2`` and ``stco``/``co64``, and the track's
``edts/elst``.

Codecs (the first sample description; ``stsc`` may name no other):

- ``avc1``/``avc3``: H.264, with ``avcC``'s SPS and PPS as Annex-B NAL units
  and its NAL length size;
- ``vp09``: VP9, with ``vpcC``'s profile, bit depth, chroma subsampling,
  range and colour description: profile 0, 8-bit, 4:2:0 (what
  ``runtime/vp9.py`` decodes); any other raises ``ValueError`` naming it;
- ``vp08``: VP8 (``runtime/vp8.py``), with or without a ``vpcC``, as cv2
  reads it (cv2's own writer puts VP8 only in WebM, Matroska and AVI);
- ``mp4v`` whose ``esds`` object type is 0x20: MPEG-4 Part 2 video (cv2's
  ``VideoWriter`` default), with the DecoderSpecificInfo (the VOS, VO and
  VOL headers) as :class:`Mp4vConfig`;
- ``jpeg``/``mjpa``, and ``mp4v`` whose ``esds`` object type is 0x6C:
  Motion-JPEG (each sample one JPEG image);
- ``png ``: PNG (each sample one PNG image).

An ``mp4v`` of any other object type (MPEG-1 or MPEG-2 video, 0x60-0x65 and
0x6A, ...) raises ``ValueError`` naming it. Anything else (HEVC's
``hvc1``/``hev1``, AV1's ``av01``, ...) raises naming the four-character
code, as do
fragmented files (a ``moof`` box), files without a video track and a
malformed ``moov`` (a table that overruns its box, or that lists more
samples than the file can hold).

Frame ``k`` is the k-th sample in presentation order (decode times from
``stts`` plus ``ctts``'s offsets, ties kept in decode order), as cv2's
``CAP_PROP_POS_FRAMES`` counts them.

The edit list: leading empty edits (``media_time`` -1, a delay) change no
frame. The first non-empty edit's ``media_time`` drops the samples presented
before it, as ffmpeg's mov demuxer does when it builds its index (it decodes
them as references and discards them); an ``elst`` whose ``media_time``
equals the first presentation time (x264's B-frame delay) drops nothing.
The edit's duration is not applied: frames past it stay, where ffmpeg may
drop them. An edit list of more than one non-empty edit raises. Every file
that cv2 writes carries an ``elst`` that skips nothing, and the tests hold
the frame count and frame order against cv2 on those.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

# the codec of each sample entry the port reads
CODECS = {"avc1": "h264", "avc3": "h264", "vp09": "vp9", "vp08": "vp8", "jpeg": "mjpeg",
          "mjpa": "mjpeg",
          "png ": "png", "mp4v": "mpeg4"}
# esds objectTypeIndication (ISO/IEC 14496-1, Table 5) -> codec, for mp4v
MP4V_OBJECT_TYPES = {0x20: "mpeg4", 0x6C: "mjpeg"}
MP4V_OBJECT_NAMES = {0x60: "MPEG-2 Simple Profile video", 0x61: "MPEG-2 Main Profile video",
                     0x62: "MPEG-2 SNR Profile video", 0x63: "MPEG-2 Spatial Profile video",
                     0x64: "MPEG-2 High Profile video", 0x65: "MPEG-2 4:2:2 Profile video",
                     0x6A: "MPEG-1 video", 0x21: "H.264 (in an mp4v entry)"}
VISUAL_ENTRY_BYTES = 78   # after the box header: SampleEntry's 8 + VisualSampleEntry's 70


@dataclass(frozen=True)
class AvcConfig:
    """``avcC``: parameter sets as Annex-B NAL units (start code included) and
    the size in bytes of each sample's NAL length prefix."""

    sps: Tuple[bytes, ...]
    pps: Tuple[bytes, ...]
    length_size: int
    profile: int
    level: int


@dataclass(frozen=True)
class VpcConfig:
    """``vpcC`` (VP codec configuration, version 1)."""

    profile: int
    level: int
    bit_depth: int
    chroma_subsampling: int
    full_range: bool
    colour_primaries: int
    transfer: int
    matrix: int


@dataclass(frozen=True)
class Mp4vConfig:
    """``esds`` of an MPEG-4 Part 2 track: the objectTypeIndication and the
    DecoderSpecificInfo's bytes (the VOS, VO and VOL headers with their
    start codes; empty when the entry carries none and they come in band)."""

    object_type: int
    dsi: bytes


@dataclass(frozen=True)
class VideoTrack:
    """The first video track of ``path`` (an mp4/mov, AVI or Matroska file).
    Sample arrays are in decode order; ``order[k]`` is the decode index of
    frame ``k`` (presentation order).

    ``timed`` is False where the container carries no presentation times
    (AVI): ``pts`` are then the decode indices and ``order`` is decode
    order, and a codec that reorders takes its presentation order from its
    own clock (``VideoFrameReader``). ``frame_count`` is cv2's
    CAP_PROP_FRAME_COUNT where it is not the number of samples (AVI's
    ``dwLength``; Matroska's duration times its frame rate, negative
    without a duration). How :meth:`sample` restores each sample's bytes:
    zlib-compressed (``zlib``), after a stripped header (``prefix``; both
    Matroska ContentCompression), or Annex-B access units to rewrite with
    4-byte NAL lengths (``annexb``: H.264 in AVI)."""

    path: str
    codec: str
    fourcc: str
    width: int
    height: int
    timescale: int
    offsets: np.ndarray
    sizes: np.ndarray
    dts: np.ndarray
    pts: np.ndarray
    sync: np.ndarray
    order: np.ndarray
    avc: Optional[AvcConfig] = None
    vpc: Optional[VpcConfig] = None
    m4v: Optional[Mp4vConfig] = None
    timed: bool = True
    frame_count: Optional[int] = None
    prefix: bytes = b""
    zlib: bool = False
    annexb: bool = False

    def __len__(self) -> int:
        return len(self.order)

    def sample(self, index: int, limit: Optional[int] = None) -> bytes:
        """The bytes of the sample at decode index ``index``; with ``limit``,
        those of its first ``limit`` stored bytes only (a header scan)."""
        size = int(self.sizes[index])
        want = size if limit is None or self.zlib else min(size, limit)
        with open(self.path, "rb") as fh:
            fh.seek(int(self.offsets[index]))
            data = fh.read(want)
        if len(data) != want:
            raise ValueError(f"{self.path}: sample {index} runs past the end of the file")
        if self.zlib:
            try:
                data = zlib.decompress(data)
            except zlib.error as e:
                raise ValueError(f"{self.path}: sample {index} does not inflate ({e})") from e
        data = self.prefix + data
        return length_prefixed(data) if self.annexb else data


# ------------------------------------------------------------------ boxes ----

def iter_boxes(buf: bytes, start: int = 0, end: Optional[int] = None,
               where: str = "") -> Iterator[Tuple[str, int, int]]:
    """(type, payload start, payload end) of each box in ``buf[start:end]``."""
    end = len(buf) if end is None else end
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", buf, pos)
        header = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError(f"{where}: truncated box header")
            size = struct.unpack_from(">Q", buf, pos + 8)[0]
            header = 16
        elif size == 0:
            size = end - pos
        if size < header or pos + size > end:
            raise ValueError(f"{where}: box {kind!r} of {size} bytes overruns its parent")
        yield kind.decode("latin-1"), pos + header, pos + size
        pos += size


def _children(buf: bytes, start: int, end: int, where: str) -> Dict[str, Tuple[int, int]]:
    """The first box of each type among the children of a box."""
    out: Dict[str, Tuple[int, int]] = {}
    for kind, a, b in iter_boxes(buf, start, end, where):
        out.setdefault(kind, (a, b))
    return out


def _child(boxes: Dict[str, Tuple[int, int]], kind: str, where: str) -> Tuple[int, int]:
    """The payload range of the child ``kind``; raises when it is missing."""
    if kind not in boxes:
        raise ValueError(f"{where}: the video track has no {kind} box")
    return boxes[kind]


def _top_level(fh, where: str) -> Dict[str, Tuple[int, int]]:
    """{type: (payload offset, payload size)} of the file's top-level boxes,
    found by seeking (``mdat`` is never read here)."""
    fh.seek(0, 2)
    file_size = fh.tell()
    pos, out = 0, {}
    while pos + 8 <= file_size:
        fh.seek(pos)
        head = fh.read(16)
        size, kind = struct.unpack_from(">I4s", head, 0)
        header = 8
        if size == 1:
            size, header = struct.unpack_from(">Q", head, 8)[0], 16
        elif size == 0:
            size = file_size - pos
        name = kind.decode("latin-1")
        if size < header:
            raise ValueError(f"{where}: malformed box header at byte {pos}")
        out.setdefault(name, (pos + header, min(size, file_size - pos) - header))
        pos += size
    return out


# --------------------------------------------------------- sample entries ----

def parse_avcc(p: bytes) -> AvcConfig:
    """``avcC``'s payload → :class:`AvcConfig`."""
    if len(p) < 7 or p[0] != 1:
        raise ValueError("malformed avcC")
    length_size = (p[4] & 3) + 1
    if length_size == 3:
        raise ValueError("avcC gives a 3-byte NAL length, which H.264 does not allow")
    pos, sets = 5, []
    for count_mask in (0x1F, 0xFF):
        n = p[pos] & count_mask
        pos += 1
        group = []
        for _ in range(n):
            size = struct.unpack_from(">H", p, pos)[0]
            if pos + 2 + size > len(p):
                raise ValueError("malformed avcC: parameter set overruns the box")
            group.append(b"\x00\x00\x00\x01" + p[pos + 2:pos + 2 + size])
            pos += 2 + size
        sets.append(tuple(group))
    return AvcConfig(sets[0], sets[1], length_size, p[1], p[3])


def annexb(sample: bytes, length_size: int) -> bytes:
    """A sample of length-prefixed NAL units rewritten with start codes."""
    out, pos = bytearray(), 0
    while pos < len(sample):
        if pos + length_size > len(sample):
            raise ValueError("truncated NAL length")
        n = int.from_bytes(sample[pos:pos + length_size], "big")
        pos += length_size
        if pos + n > len(sample):
            raise ValueError(f"NAL of {n} bytes overruns its sample")
        out += b"\x00\x00\x00\x01" + sample[pos:pos + n]
        pos += n
    return bytes(out)


def length_prefixed(data: bytes) -> bytes:
    """An Annex-B access unit rewritten with 4-byte NAL lengths (the inverse
    of :func:`annexb`); zero bytes before a start code are dropped (a NAL
    unit never ends in one). A unit cut short (a header scan) keeps its
    last NAL as far as it goes."""
    starts, pos = [], data.find(b"\0\0\1")
    if pos < 0 or data[:pos].strip(b"\0"):
        raise ValueError("not an Annex-B access unit (no start code before its first NAL)")
    while pos >= 0:
        starts.append(pos + 3)
        pos = data.find(b"\0\0\1", pos + 3)
    out = bytearray()
    for a, b in zip(starts, starts[1:] + [len(data) + 3]):
        nal = data[a:b - 3].rstrip(b"\0")
        if nal:
            out += struct.pack(">I", len(nal)) + nal
    return bytes(out)


def split_annexb(data: bytes) -> Tuple[bytes, ...]:
    """The NAL units of an Annex-B byte string."""
    out, pos = [], 0
    lp = length_prefixed(data)
    while pos < len(lp):
        n = int.from_bytes(lp[pos:pos + 4], "big")
        out.append(lp[pos + 4:pos + 4 + n])
        pos += 4 + n
    return tuple(out)


def first_slice_header(sample: bytes, length_size: int) -> int:
    """The NAL header byte of the first slice NAL unit (type 1 or 5) of an
    H.264 sample of length-prefixed NAL units; -1 if it holds none."""
    pos = 0
    while pos + length_size <= len(sample):
        n = int.from_bytes(sample[pos:pos + length_size], "big")
        pos += length_size
        if n and pos < len(sample) and sample[pos] & 0x1F in (1, 5):
            return sample[pos]
        pos += n
    return -1


def slice_ref_idc(sample: bytes, length_size: int) -> int:
    """nal_ref_idc of the first slice NAL unit (type 1 or 5) of an H.264
    sample of length-prefixed NAL units; -1 if it holds none (a cut or
    corrupt sample: the decoder then names what is wrong)."""
    head = first_slice_header(sample, length_size)
    return (head >> 5) & 3 if head >= 0 else -1


def parse_vpcc(p: bytes) -> VpcConfig:
    """``vpcC``'s payload (a full box, version 1) → :class:`VpcConfig`."""
    if len(p) < 12 or p[0] != 1:
        raise ValueError(f"vpcC version {p[0] if p else None} (the port reads version 1)")
    b = p[6]
    return VpcConfig(p[4], p[5], b >> 4, (b >> 1) & 7, bool(b & 1), p[7], p[8], p[9])


def _descriptor(p: bytes, pos: int) -> Tuple[int, int, int]:
    """(tag, payload start, payload end) of an MPEG-4 descriptor."""
    tag, pos, size = p[pos], pos + 1, 0
    for _ in range(4):
        b = p[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def parse_esds(p: bytes) -> Mp4vConfig:
    """``esds``'s DecoderConfigDescriptor: its objectTypeIndication and its
    DecoderSpecificInfo (tag 0x05), if any."""
    tag, a, _ = _descriptor(p, 4)
    if tag != 0x03:
        raise ValueError("malformed esds: no ES_Descriptor")
    flags = p[a + 2]
    pos = a + 3
    if flags & 0x80:
        pos += 2                       # dependsOn_ES_ID
    if flags & 0x40:
        pos += 1 + p[pos]              # URL
    if flags & 0x20:
        pos += 2                       # OCR_ES_Id
    tag, a, b = _descriptor(p, pos)
    if tag != 0x04:
        raise ValueError("malformed esds: no DecoderConfigDescriptor")
    dsi, pos = b"", a + 13           # objectType, streamType, buffer size, two bit rates
    while pos + 2 <= min(b, len(p)):
        tag, da, db = _descriptor(p, pos)
        if tag == 0x05:
            if db > len(p):
                raise ValueError("malformed esds: DecoderSpecificInfo overruns the box")
            dsi = bytes(p[da:db])
            break
        pos = db
    return Mp4vConfig(p[a], dsi)


def _sample_entry(buf: bytes, a: int, b: int, where: str):
    """(codec, fourcc, width, height, avcC, vpcC, esds) of the first ``stsd``
    entry."""
    entries = list(iter_boxes(buf, a + 8, b, where))
    if not entries:
        raise ValueError(f"{where}: the video track has no sample description")
    fourcc, ea, eb = entries[0]
    if eb - ea < VISUAL_ENTRY_BYTES:
        raise ValueError(f"{where}: sample entry {fourcc!r} is truncated")
    width, height = struct.unpack_from(">HH", buf, ea + 24)
    kids = _children(buf, ea + VISUAL_ENTRY_BYTES, eb, where)
    codec = CODECS.get(fourcc)
    m4v = None
    if fourcc == "mp4v":
        if "esds" not in kids:
            raise ValueError(f"{where}: 'mp4v' sample entry without esds")
        m4v = parse_esds(buf[slice(*kids["esds"])])
        codec = MP4V_OBJECT_TYPES.get(m4v.object_type)
        if codec is None:
            name = MP4V_OBJECT_NAMES.get(m4v.object_type, "an object type the port does not know")
            raise ValueError(f"{where}: codec 'mp4v' with esds object type "
                             f"{m4v.object_type:#04x} ({name}) is not supported; the port reads "
                             "mp4v as MPEG-4 Part 2 video (0x20) or Motion-JPEG (0x6c)")
        if codec != "mpeg4":
            m4v = None
    if codec is None:
        raise ValueError(f"{where}: codec {fourcc!r} is not supported; the port reads "
                         "H.264 (avc1/avc3), MPEG-4 Part 2 (mp4v), VP8 (vp08), VP9 (vp09), "
                         "Motion-JPEG "
                         "and PNG")
    avc = vpc = None
    if codec == "h264":
        if "avcC" not in kids:
            raise ValueError(f"{where}: {fourcc!r} sample entry without avcC")
        avc = parse_avcc(buf[slice(*kids["avcC"])])
    if codec == "vp9":
        if "vpcC" not in kids:
            raise ValueError(f"{where}: 'vp09' sample entry without vpcC")
        vpc = parse_vpcc(buf[slice(*kids["vpcC"])])
        if (vpc.profile, vpc.bit_depth) != (0, 8) or vpc.chroma_subsampling not in (0, 1):
            sub = {0: "4:2:0", 1: "4:2:0", 2: "4:2:2", 3: "4:4:4"}.get(vpc.chroma_subsampling,
                                                                     "unknown")
            raise ValueError(f"{where}: VP9 profile {vpc.profile}, {vpc.bit_depth}-bit {sub} "
                             "(vpcC) is not supported; the port decodes VP9 profile 0, 8-bit "
                             "4:2:0")
    return codec, fourcc, width, height, avc, vpc, m4v


# ---------------------------------------------------------- sample tables ----

def _table(buf: bytes, box: Optional[Tuple[int, int]], fields: str, where: str,
           name: str) -> np.ndarray:
    """A full box of ``entry_count`` then ``entry_count`` records of the
    big-endian struct ``fields``, as an (n, len(fields)) int64 array."""
    if box is None:
        raise ValueError(f"{where}: the video track has no {name} box")
    a, b = box
    n = struct.unpack_from(">I", buf, a + 4)[0]
    rec = struct.calcsize(">" + fields)
    if a + 8 + n * rec > b:
        raise ValueError(f"{where}: {name} lists {n} entries but holds fewer")
    dtype = np.dtype([(f"f{i}", ">" + c) for i, c in enumerate(fields)])
    arr = np.frombuffer(buf, dtype, n, a + 8)
    return np.stack([arr[f].astype(np.int64) for f in dtype.names], -1).reshape(n, len(fields))


def sample_sizes(buf: bytes, stbl: Dict[str, Tuple[int, int]], file_size: int,
                 where: str) -> np.ndarray:
    """Per-sample sizes from ``stsz`` or ``stz2``."""
    if "stsz" in stbl:
        a, b = stbl["stsz"]
        size, n = struct.unpack_from(">II", buf, a + 4)
        if size:
            if size * n > file_size:
                raise ValueError(f"{where}: stsz lists {n} samples of {size} bytes, more than "
                                 "the file holds")
            return np.full(n, size, np.int64)
        if a + 12 + 4 * n > b:
            raise ValueError(f"{where}: stsz lists {n} sizes but holds fewer")
        return np.frombuffer(buf, ">u4", n, a + 12).astype(np.int64)
    if "stz2" in stbl:
        a, b = stbl["stz2"]
        field, n = buf[a + 7], struct.unpack_from(">I", buf, a + 8)[0]
        if field == 4:
            raw = np.frombuffer(buf, np.uint8, (n + 1) // 2, a + 12)
            return np.stack([raw >> 4, raw & 15], -1).reshape(-1)[:n].astype(np.int64)
        if field not in (8, 16):
            raise ValueError(f"{where}: stz2 field size {field}")
        return np.frombuffer(buf, f">u{field // 8}", n, a + 12).astype(np.int64)
    raise ValueError(f"{where}: the video track has no stsz or stz2 box")


def sample_offsets(sizes: np.ndarray, chunk_offsets: np.ndarray, stsc: np.ndarray,
                   where: str) -> np.ndarray:
    """Each sample's file offset from its chunk's offset (``stco``/``co64``),
    the chunk runs of ``stsc`` (first chunk, samples per chunk, description)
    and the sizes of the samples before it in its chunk."""
    n_chunks = len(chunk_offsets)
    if len(stsc) == 0 or stsc[0, 0] != 1 or np.any(np.diff(stsc[:, 0]) <= 0):
        raise ValueError(f"{where}: malformed stsc")
    if np.any(stsc[:, 2] != 1):
        raise ValueError(f"{where}: samples use more than one sample description")
    run_end = np.minimum(np.append(stsc[1:, 0], n_chunks + 1), n_chunks + 1)
    per_chunk = np.repeat(stsc[:, 1], np.maximum(run_end - stsc[:, 0], 0))[:n_chunks]
    if len(per_chunk) != n_chunks or per_chunk.sum() != len(sizes):
        raise ValueError(f"{where}: stsc and stco give {int(per_chunk.sum())} samples, "
                         f"stsz {len(sizes)}")
    chunk_of = np.repeat(np.arange(n_chunks), per_chunk)
    first = np.concatenate([[0], np.cumsum(per_chunk)[:-1]])
    before = np.concatenate([[0], np.cumsum(sizes)])
    return chunk_offsets[chunk_of] + before[:-1] - before[first[chunk_of]]


def sample_times(stts: np.ndarray, ctts: Optional[np.ndarray], n: int,
                 where: str) -> Tuple[np.ndarray, np.ndarray]:
    """(decode times, presentation times) of ``n`` samples."""
    if stts[:, 0].sum() != n:
        raise ValueError(f"{where}: stts covers {int(stts[:, 0].sum())} samples, stsz {n}")
    deltas = np.repeat(stts[:, 1], stts[:, 0])
    dts = np.concatenate([[0], np.cumsum(deltas)[:-1]]).astype(np.int64)
    if ctts is None:
        return dts, dts.copy()
    if ctts[:, 0].sum() != n:
        raise ValueError(f"{where}: ctts covers {int(ctts[:, 0].sum())} samples, stsz {n}")
    offs = np.repeat(ctts[:, 1], ctts[:, 0])
    # version 0 stores unsigned offsets, but writers put negative ones there
    # too; read both as signed 32-bit, as ffmpeg does
    offs = offs.astype(np.uint32).astype(np.int32).astype(np.int64)
    return dts, dts + offs


def edit_start(buf: bytes, elst: Optional[Tuple[int, int]], where: str) -> Optional[int]:
    """The media time (in the track's timescale) the first non-empty edit
    starts at, None without one; raises on more than one non-empty edit."""
    if elst is None:
        return None
    a, _ = elst
    version = buf[a]
    fields = "QqhH" if version == 1 else "IihH"
    table = _table(buf, elst, fields, where, "elst")
    media = table[table[:, 1] != -1]
    if len(media) == 0:
        return None
    if len(media) > 1:
        raise ValueError(f"{where}: an edit list of {len(media)} media edits is not supported")
    return int(media[0, 1])


def read_track(path) -> VideoTrack:
    """The sample table of the first video track of the mp4/mov ``path``."""
    where = str(path)
    with open(path, "rb") as fh:
        top = _top_level(fh, where)
        if "moof" in top:
            raise ValueError(f"{where}: fragmented mp4 (moof) is not supported")
        if "moov" not in top:
            raise ValueError(f"{where}: no moov box (not an mp4/mov file, or a cut one)")
        off, size = top["moov"]
        fh.seek(off)
        buf = fh.read(size)
        file_size = fh.seek(0, 2)
    try:
        return _first_video_track(buf, file_size, where)
    except (struct.error, IndexError) as e:     # a field past the end of its box
        raise ValueError(f"{where}: malformed moov box ({e})") from e


def _first_video_track(buf: bytes, file_size: int, where: str) -> VideoTrack:
    moov = _children(buf, 0, len(buf), where)
    if "mvex" in moov:
        raise ValueError(f"{where}: fragmented mp4 (mvex) is not supported")
    for kind, ta, tb in iter_boxes(buf, 0, len(buf), where):
        if kind != "trak":
            continue
        trak = _children(buf, ta, tb, where)
        if "mdia" not in trak:
            continue
        mdia = _children(buf, *trak["mdia"], where)
        if "hdlr" not in mdia or buf[mdia["hdlr"][0] + 8:mdia["hdlr"][0] + 12] != b"vide":
            continue
        return _video_track(buf, trak, mdia, file_size, where)
    raise ValueError(f"{where}: no video track")


def _video_track(buf: bytes, trak, mdia, file_size: int, where: str) -> VideoTrack:
    a, _ = _child(mdia, "mdhd", where)
    timescale = struct.unpack_from(">I", buf, a + (20 if buf[a] == 1 else 12))[0]
    minf = _children(buf, *_child(mdia, "minf", where), where)
    stbl = _children(buf, *_child(minf, "stbl", where), where)
    codec, fourcc, width, height, avc, vpc, m4v = _sample_entry(buf, *_child(stbl, "stsd", where),
                                                           where)
    sizes = sample_sizes(buf, stbl, file_size, where)
    n = len(sizes)
    if "co64" in stbl:
        chunks = _table(buf, stbl["co64"], "Q", where, "co64")[:, 0]
    else:
        chunks = _table(buf, stbl.get("stco"), "I", where, "stco")[:, 0]
    offsets = sample_offsets(sizes, chunks, _table(buf, stbl.get("stsc"), "III", where, "stsc"),
                             where)
    ctts = _table(buf, stbl["ctts"], "II", where, "ctts") if "ctts" in stbl else None
    dts, pts = sample_times(_table(buf, stbl.get("stts"), "II", where, "stts"), ctts, n, where)
    if "stss" in stbl:
        sync = np.zeros(n, bool)
        idx = _table(buf, stbl["stss"], "I", where, "stss")[:, 0] - 1
        if np.any((idx < 0) | (idx >= n)):
            raise ValueError(f"{where}: stss names a sample outside 1..{n}")
        sync[idx] = True
    else:
        sync = np.ones(n, bool)
    order = np.argsort(pts, kind="stable")
    edts = _children(buf, *trak["edts"], where) if "edts" in trak else {}
    start = edit_start(buf, edts.get("elst"), where)
    if start is not None:
        order = order[pts[order] >= start]
    return VideoTrack(where, codec, fourcc, width, height, timescale, offsets, sizes, dts, pts,
                      sync, order, avc, vpc, m4v)

