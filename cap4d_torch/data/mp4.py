"""An ISO-BMFF (``.mp4`` / ``.mov``) demuxer in pure Python: the sample
table of a file's first video track, as ffmpeg's mov demuxer (inside cv2)
indexes it when it opens a seekable file.

The JAX package reads video through cv2's ``VideoCapture`` (ffmpeg's mov
demuxer); the card's machine has neither cv2 nor ffmpeg, so the port reads
the container itself and hands each sample's bytes to a decoder
(``data/utils.py``'s ``VideoFrameReader``).

What it walks: ``ftyp`` (optional, as in older QuickTime files), then
``moov/trak/mdia/{mdhd,hdlr,minf/stbl}``, taking the first track whose
handler is ``vide``; in ``stbl`` the boxes ``stsd``, ``stts``, ``ctts``,
``stss``, ``stsc``, ``stsz``/``stz2`` and ``stco``/``co64``, and the track's
``edts/elst``; then, where ``moov/mvex`` holds a ``trex`` for the track, the
top-level ``moof`` and ``sidx`` boxes (fragmented mp4: MediaRecorder, OBS,
ffmpeg's ``frag_keyframe``, DASH segments joined). ``styp``, ``mfra``,
``emsg``, ``prft``, ``free`` and ``mdat`` carry no samples; ``mehd`` is read
by no one (ffmpeg's count ignores it).

Codecs (the first sample description; ``stsc`` and the fragments may name
no other):

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

- ``hvc1``/``hev1``: HEVC, with ``hvcC``'s parameter-set arrays (VPS,
  SPS, PPS as Annex-B NAL units) and its NAL length size; ``hev1`` may
  carry its parameter sets in band as well.

An ``mp4v`` of any other object type (MPEG-1 or MPEG-2 video, 0x60-0x65 and
0x6A, ...) raises ``ValueError`` naming it. Anything else (AV1's ``av01``,
...) raises naming the four-character code, as do files without a video
track and a malformed ``moov`` or ``moof`` (a table that overruns its box,
a flat table that lists more samples than the file can hold, a ``traf`` of
a track without ``trex``).

The display matrix: ffmpeg's mov demuxer multiplies the video track's
``tkhd`` matrix by the ``mvhd`` matrix read before it (each term shifted
by 16, 16 or 30 bits, the sum kept in 32 bits), and cv2 takes the angle of
the product (``av_display_rotation_get``, rounded half to even and
negated, as OpenCV's ``get_rotation_angle`` does) and rotates every frame
it reads by 90, 180 or 270 degrees clockwise; any other angle (a vertical
mirror reads 0, 45 degrees is reported but not applied) leaves the frame
as decoded. :attr:`VideoTrack.rotation` is that rotation. Phones record
portrait video so: landscape samples and a 90-degree matrix. Flat,
fragmented and hybrid files keep the matrix in ``moov`` alike.

Frame ``k`` is the k-th frame in presentation order (decode times plus the
composition offsets, ties kept in decode order), as cv2's
``CAP_PROP_POS_FRAMES`` counts them.

Fragments (ffmpeg's ``mov_read_tfhd``/``mov_read_trun``): each ``traf`` of
the video track, others skipped (their runs still move the implicit data
offset). ``tfhd`` gives the base (``base-data-offset``, the ``moof`` with
``default-base-is-moof``, else the ``moof`` for the first ``traf`` and the
end of the last run's data for a later one; a run without data offset
starts at its ``traf``'s base) and overrides ``trex``'s sample description,
duration, size and flags. A run's decode time is, in ffmpeg's order: where
the last run of its ``traf`` ended; ``tfdt`` (v0/v1) less the edit list's
offset; a ``sidx``'s time for its ``moof``; the track's end. ``tfdt``
therefore wins over the summed durations: a gap stays a gap, and a sample
whose time is not past the index entry before its run is decoded and
shows no frame (ffmpeg's "fragments can overlap in time"). ``trun`` v0 and
v1 composition offsets are both read signed. A sample is a key frame
unless its flags (per sample, the first-sample flags, ``tfhd``'s or
``trex``'s defaults) set ``sample_is_non_sync_sample`` or
``sample_depends_on`` 1. A ``moov`` that holds samples is read first and
its fragments after (hybrid files). A recording cut short keeps the
samples before the first the file does not hold whole (a sample cut in
two is dropped with those after it, where ffmpeg decodes it damaged); a
file with none left raises ``ValueError``, as cv2 reads nothing.

cv2's frame count: the moov's sample count (ffmpeg's ``nb_frames``, edit
list or not); where the moov lists no sample, floor(duration × fps + 0.5)
with ffmpeg's duration of the file (the longest track, each track's the
larger of its ``mdhd`` duration and its runs' end, a ``sidx`` setting it
to its own end; or the span from the earliest track start to the latest
end) and the video's mean rate over its samples.

The edit list (ffmpeg's ``mov_fix_index``) on a flat track: leading empty
edits (``media_time`` -1) are a delay; every edit from the first media
edit on shows the samples presented in [media time, media time +
duration), one edit after another (an edit may repeat samples or put them
out of order; an empty edit there reads as media time -1), and the samples
outside every edit are decoded as references where needed and give no
frame. ``media_rate`` is read as 1 for every edit, as ffmpeg reads it. An
edit list of empty edits only shows nothing. cv2's count stays the
sample count, so frames past the edited ones raise ``IndexError``, as cv2's
read does. Several edits whose edited index cv2 cannot seek in (see
:func:`edited_order`) raise ``ValueError``. In a fragmented file ffmpeg
takes only the time offset (the first media edit's time less a leading
empty edit) from the edit list, and every sample shows; a hybrid file whose
moov's edits drop or repeat samples raises. Every file that cv2 writes
carries an ``elst`` that skips nothing.
"""

from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# the codec of each sample entry the port reads
CODECS = {"avc1": "h264", "avc3": "h264", "vp09": "vp9", "vp08": "vp8", "jpeg": "mjpeg",
          "mjpa": "mjpeg", "png ": "png", "mp4v": "mpeg4", "hvc1": "hevc", "hev1": "hevc"}
# esds objectTypeIndication (ISO/IEC 14496-1, Table 5) -> codec, for mp4v
MP4V_OBJECT_TYPES = {0x20: "mpeg4", 0x6C: "mjpeg"}
MP4V_OBJECT_NAMES = {0x60: "MPEG-2 Simple Profile video", 0x61: "MPEG-2 Main Profile video",
                     0x62: "MPEG-2 SNR Profile video", 0x63: "MPEG-2 Spatial Profile video",
                     0x64: "MPEG-2 High Profile video", 0x65: "MPEG-2 4:2:2 Profile video",
                     0x6A: "MPEG-1 video", 0x21: "H.264 (in an mp4v entry)"}
VISUAL_ENTRY_BYTES = 78   # after the box header: SampleEntry's 8 + VisualSampleEntry's 70
# the identity display matrix (16.16, 16.16, 2.30 fixed point), row by row
UNITY_MATRIX = (1 << 16, 0, 0, 0, 1 << 16, 0, 0, 0, 1 << 30)


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
class HvcConfig:
    """``hvcC`` (HEVCDecoderConfigurationRecord): the NAL units of its
    arrays (VPS, SPS, PPS, SEI) as Annex-B NAL units (start code included),
    in the record's order, the size in bytes of each sample's NAL length
    prefix, and general_profile_idc."""

    params: Tuple[bytes, ...]
    length_size: int
    profile: int


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
    Sample arrays are in decode order, ``len`` counts the samples;
    ``order[k]`` is the decode index of frame ``k`` (presentation order, an
    edit list applied: a sample may show twice, or not at all).

    ``timed`` is False where the container carries no presentation times
    (AVI): ``pts`` are then the decode indices and ``order`` is decode
    order, and a codec that reorders takes its presentation order from its
    own clock (``VideoFrameReader``). ``frame_count`` is cv2's
    CAP_PROP_FRAME_COUNT where it is not the number of samples (AVI's
    ``dwLength``; Matroska's duration times its frame rate, negative
    without a duration; a fragmented mp4's duration times its frame rate).
    ``chroma_location`` is the chroma siting the container gives the
    stream (Matroska's ChromaSiting), as ffmpeg names it; None where it
    gives none. How :meth:`sample` restores each sample's bytes:
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
    chroma_location: Optional[str] = None
    rotation: int = 0
    hvc: Optional["HvcConfig"] = None

    def __len__(self) -> int:
        return len(self.sizes)

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


def _top_level(fh, where: str) -> List[Tuple[str, int, int, int]]:
    """(type, offset, header bytes, size) of each of the file's top-level
    boxes in file order, found by seeking (``mdat`` is never read here); a
    box the end of the file cuts keeps its stated size."""
    fh.seek(0, 2)
    file_size = fh.tell()
    pos, out = 0, []
    while pos + 8 <= file_size:
        fh.seek(pos)
        head = fh.read(16)
        size, kind = struct.unpack_from(">I4s", head, 0)
        header = 8
        if size == 1:
            size, header = struct.unpack_from(">Q", head, 8)[0], 16
        elif size == 0:
            size = file_size - pos
        if size < header:
            raise ValueError(f"{where}: malformed box header at byte {pos}")
        out.append((kind.decode("latin-1"), pos, header, size))
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


def parse_hvcc(p: bytes) -> HvcConfig:
    """``hvcC``'s payload → :class:`HvcConfig`, read as ffmpeg's ``hevc``
    decoder reads its extradata (the version byte is not checked)."""
    if len(p) < 23:
        raise ValueError(f"malformed hvcC ({len(p)} bytes, a record has at least 23)")
    length_size = (p[21] & 3) + 1
    if length_size == 3:
        raise ValueError("hvcC gives a 3-byte NAL length, which HEVC in mp4 does not allow")
    pos, params = 23, []
    for _ in range(p[22]):
        if pos + 3 > len(p):
            raise ValueError("malformed hvcC: an array overruns the box")
        n = struct.unpack_from(">H", p, pos + 1)[0]
        pos += 3
        for _ in range(n):
            if pos + 2 > len(p):
                raise ValueError("malformed hvcC: a NAL unit overruns the box")
            size = struct.unpack_from(">H", p, pos)[0]
            if pos + 2 + size > len(p):
                raise ValueError("malformed hvcC: a NAL unit overruns the box")
            params.append(b"\x00\x00\x00\x01" + p[pos + 2:pos + 2 + size])
            pos += 2 + size
    return HvcConfig(tuple(params), length_size, p[1] & 0x1F)


def display_rotation(tkhd: Tuple[int, ...], mvhd: Optional[Tuple[int, ...]]) -> int:
    """The clockwise rotation cv2 gives the frames of a track whose ``tkhd``
    holds the display matrix ``tkhd`` (9 signed 32-bit fields, row by row)
    under a movie whose ``mvhd`` holds ``mvhd`` (None: no mvhd before the
    track, which ffmpeg reads as zeros): 0, 90, 180 or 270."""
    movie = mvhd or (0,) * 9
    shift = (16, 16, 30)
    m = []
    for i in range(3):
        for j in range(3):
            v = sum((tkhd[3 * i + e] * movie[3 * e + j]) >> shift[e] for e in range(3))
            m.append((v + (1 << 31)) % (1 << 32) - (1 << 31))      # ffmpeg keeps 32 bits
    # ffmpeg attaches no display matrix when the product is the identity
    return 0 if tuple(m) == UNITY_MATRIX else matrix_rotation(m)


def matrix_rotation(m) -> int:
    """The clockwise rotation cv2 applies for the display matrix ``m`` that
    ffmpeg attaches to a stream: 0, 90, 180 or 270 (any other angle, 0)."""
    fp = [v / 65536.0 for v in m]
    s0, s1 = math.hypot(fp[0], fp[3]), math.hypot(fp[1], fp[4])
    if s0 == 0.0 or s1 == 0.0:
        return 0                   # av_display_rotation_get gives NaN: cv2 turns nothing
    angle = -round(-math.atan2(fp[1] / s1, fp[0] / s0) * 180 / math.pi)   # cvRound: half even
    angle += 360 if angle < 0 else 0
    return angle if angle in (90, 180, 270) else 0


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
    """(codec, fourcc, width, height, avcC, vpcC, esds, hvcC) of the first
    ``stsd`` entry."""
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
                         "H.264 (avc1/avc3), HEVC (hvc1/hev1), MPEG-4 Part 2 (mp4v), VP8 (vp08), "
                         "VP9 (vp09), Motion-JPEG and PNG")
    avc = vpc = hvc = None
    if codec == "hevc":
        if "hvcC" not in kids:
            raise ValueError(f"{where}: {fourcc!r} sample entry without hvcC")
        hvc = parse_hvcc(buf[slice(*kids["hvcC"])])
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
    return codec, fourcc, width, height, avc, vpc, m4v, hvc


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
    dts = np.concatenate([[0], np.cumsum(deltas)])[:n].astype(np.int64)
    if ctts is None:
        return dts, dts.copy()
    if ctts[:, 0].sum() != n:
        raise ValueError(f"{where}: ctts covers {int(ctts[:, 0].sum())} samples, stsz {n}")
    offs = np.repeat(ctts[:, 1], ctts[:, 0])
    # version 0 stores unsigned offsets, but writers put negative ones there
    # too; read both as signed 32-bit, as ffmpeg does
    offs = offs.astype(np.uint32).astype(np.int32).astype(np.int64)
    return dts, dts + offs


# ------------------------------------------------------------- edit lists ----

def edit_list(buf: bytes, elst: Optional[Tuple[int, int]], where: str) -> Optional[np.ndarray]:
    """``elst``'s (duration in the movie's timescale, media time in the
    track's) rows, None without one; ``media_rate`` is not read (ffmpeg
    reads every edit at rate 1, dwells and fast edits too)."""
    if elst is None:
        return None
    fields = "QqhH" if buf[elst[0]] == 1 else "IihH"
    return _table(buf, elst, fields, where, "elst")[:, :2]


def _rescale(a: int, b: int, c: int) -> int:
    """av_rescale: a * b / c rounded to the nearest, halves away from 0."""
    q, r = divmod(abs(a) * b + c // 2, c)
    return q if a >= 0 else -q


def edited_order(dts: np.ndarray, pts: np.ndarray, sync: np.ndarray,
                 edits: Optional[np.ndarray], media_scale: int, movie_scale: int,
                 where: str, seekable: bool = True) -> np.ndarray:
    """The frames of a flat track as ffmpeg's mov_fix_index shows them: the
    edits from the first with a media time on, each the samples presented
    in [media time, media time + duration) in presentation order (decode
    order on ties), one after another; empty edits (media time -1) before
    it are a delay, and one after it reads as an edit at media time -1. No
    edit list: every sample; one of empty edits only: none.

    cv2's seek finds frame k by the times of ffmpeg's edited index, so the
    port reads frame k of several edits as the k-th frame only where that
    index is a plain timeline (:func:`_plain_timeline`); several edits that
    make another (edits of a stream that reorders, one after another, whose
    decodes overlap) raise ``ValueError``, as cv2's seek there departs from
    its sequential read. One edit keeps the stream's own times. ``seekable`` False skips that check (a hybrid file's
    moov, whose edits the caller holds to showing every sample)."""
    by_pts = np.argsort(pts, kind="stable")
    if edits is None or not len(edits):
        return by_pts
    media = np.flatnonzero(edits[:, 1] != -1)
    if not len(media):
        return by_pts[:0]
    if movie_scale <= 0:
        raise ValueError(f"{where}: an edit list with a movie timescale of {movie_scale}")
    sorted_pts = pts[by_pts]
    spans = []
    for k, (duration, time) in enumerate(edits):
        length = _rescale(int(duration), media_scale, movie_scale)
        spans.append((None if k < media[0] else int(time), length))
    parts = [by_pts[slice(*np.searchsorted(sorted_pts, [t, t + d]))] for t, d in spans
             if t is not None]
    bad = _plain_timeline(dts, pts, sync, spans) if seekable and len(parts) > 1 else ""
    if bad:
        raise ValueError(f"{where}: an edit list of {len(parts)} media edits whose edited index "
                         f"is no plain timeline ({bad}): cv2's seek there departs from its "
                         "sequential read, so the port refuses the file")
    return np.concatenate(parts)


def _plain_timeline(dts: np.ndarray, pts: np.ndarray, sync: np.ndarray, spans) -> str:
    """Where ffmpeg's edited index (mov_fix_index) is not a plain timeline,
    what breaks it; "" where it is. Each edit ((media time or None for a
    leading empty edit, length)) walks the samples from the sync sample
    presented at or before its start to the second sync sample past its end
    (the first one without reordering), times each with a counter that
    starts where the edits before it end and runs from its first sample
    inside it, and shows the samples inside it at that time plus their
    composition offset. The timeline is plain when the index's times rise
    and the shown frames follow one another a frame apart."""
    n = len(dts)
    reorders = bool(np.any(pts != dts))
    frame = int(np.median(np.diff(np.sort(pts)))) if n > 1 else 1
    index, shown = [], []
    end = 0
    for t, d in spans:
        counter, end = end, end + d
        if t is None:
            continue
        keys = np.flatnonzero(sync & (pts <= t) & (dts <= t))
        i = int(keys[-1]) if len(keys) else 0
        before, started, past, times = [], False, False, []
        while i < n:
            step = int(dts[i + 1] - dts[i]) if i + 1 < n else d
            c = int(pts[i])
            index.append(counter)
            if t <= c < t + d:
                if not started:       # the samples before it end where it starts
                    started, at = True, counter
                    for pos, dur in reversed(before):
                        at -= dur
                        index[pos] = at
                times.append(counter + c - int(dts[i]))
            elif not started:
                before.append((len(index) - 1, step))
            if started:
                counter += step
            if c + step >= t + d and sync[i]:
                if reorders and not past:
                    past = True
                    i += 1
                    continue
                break
            i += 1
        shown += sorted(times)      # the decoder gives them in presentation order
    if np.any(np.diff(index) <= 0):
        return "its times fall back where an edit starts"
    if shown and np.any(np.diff(shown) != frame):
        k = int(np.flatnonzero(np.diff(shown) != frame)[0]) + 1
        return f"frame {k} is not one frame after frame {k - 1}"
    return ""


def time_offset(edits: Optional[np.ndarray], media_scale: int, movie_scale: int) -> int:
    """ffmpeg's time_offset of a track: the first media edit's media time
    less a leading empty edit's duration (in the track's timescale)."""
    if edits is None or not len(edits):
        return 0
    empty, first = 0, 0
    if edits[0, 1] == -1:
        empty = _rescale(int(edits[0, 0]), media_scale, movie_scale) if movie_scale > 0 else 0
        first = 1
    start = int(edits[first, 1]) if first < len(edits) and edits[first, 1] >= 0 else 0
    return start - empty


# -------------------------------------------------------------- fragments ----

# tfhd and trun flags (ISO/IEC 14496-12 8.8.7, 8.8.8)
TFHD_BASE, TFHD_DESCRIPTION, TFHD_DURATION, TFHD_SIZE, TFHD_FLAGS, TFHD_MOOF = (
    0x1, 0x2, 0x8, 0x10, 0x20, 0x20000)
TRUN_DATA, TRUN_FIRST, TRUN_DURATION, TRUN_SIZE, TRUN_FLAGS, TRUN_CTS = (
    0x1, 0x4, 0x100, 0x200, 0x400, 0x800)
# sample flags that make a sample no key frame, as ffmpeg's mov_read_trun
# reads them: sample_is_non_sync_sample, and sample_depends_on 1
NON_SYNC_BITS = 0x00010000 | 0x01000000


@dataclass
class _Trak:
    """What a track's moov boxes give the fragment walk, and its state there:
    times in the track's timescale, ``dts`` corrected by ``offset``
    (ffmpeg's time_offset), ``end`` (ffmpeg's track_end) not."""

    timescale: int
    duration: int                      # mdhd's, then ffmpeg's st->duration
    offset: int                        # time_offset
    trex: Optional[Tuple[int, int, int, int]] = None   # description, duration, size, flags
    end: int = 0
    last_dts: Optional[int] = None     # the last index entry's
    first_pts: Optional[int] = None
    frames_for_fps: int = 0
    duration_for_fps: int = 0
    has_sidx: bool = False


@dataclass
class _Samples:
    """The video track's samples in ffmpeg's index order."""

    offsets: list
    sizes: list
    dts: list
    cts: list
    sync: list
    shown: list


def _walk_fragments(frags, traks: Dict[int, _Trak], video: int, out: _Samples, file_size: int,
                    top, where: str) -> None:
    """Each top-level ``sidx`` and ``moof`` (``frags``: (type, box offset,
    box size, payload)), in file order, as ffmpeg's mov demuxer reads them
    when it opens a seekable file: the video track's samples into ``out``,
    every track's durations into ``traks``."""
    sidx_pts: Dict[Tuple[int, int], int] = {}
    for kind, box_at, box_size, p in frags:
        if kind == "sidx":
            _read_sidx(p, box_at + box_size, traks, sidx_pts, file_size, top, where)
            continue
        implicit = box_at
        next_dts: Dict[int, int] = {}
        for tkind, ta, tb in iter_boxes(p, 0, len(p), where):
            if tkind != "traf":
                continue
            traf = list(iter_boxes(p, ta, tb, where))
            heads = [(a, b) for k, a, b in traf if k == "tfhd"]
            if not heads:
                raise ValueError(f"{where}: a traf without tfhd")
            a, _ = heads[0]
            flags = int.from_bytes(p[a + 1:a + 4], "big")
            track_id = struct.unpack_from(">I", p, a + 4)[0]
            t = traks.get(track_id)
            if t is None or t.trex is None:
                raise ValueError(f"{where}: a traf of track {track_id}, which has no trex "
                                 "(ffmpeg refuses the file)")
            pos = a + 8
            base = implicit
            if flags & TFHD_BASE:
                base = struct.unpack_from(">Q", p, pos)[0]
                pos += 8
            elif flags & TFHD_MOOF:
                base = box_at
            defaults = list(t.trex)      # description, duration, size, flags
            for i, bit in enumerate((TFHD_DESCRIPTION, TFHD_DURATION, TFHD_SIZE, TFHD_FLAGS)):
                if flags & bit:
                    defaults[i] = struct.unpack_from(">I", p, pos)[0]
                    pos += 4
            description, duration, size, sflags = defaults
            if track_id == video and description != 1:
                raise ValueError(f"{where}: a fragment's samples use sample description "
                                 f"{description}; the port reads the first only")
            tfdt = None
            for k, da, db in traf:
                if k == "tfdt":
                    tfdt = (struct.unpack_from(">Q", p, da + 4)[0] if p[da] == 1 else
                            struct.unpack_from(">I", p, da + 4)[0])
            for k, ra, rb in traf:
                if k != "trun":
                    continue
                # ffmpeg's order: a run after another in the traf continues
                # it; else tfdt (it wins over the summed durations, and a
                # sample it puts at or before the index entry ahead of it
                # is decoded and dropped), else the sidx's time, else the
                # track's end; a run without data offset starts at the
                # traf's base, the one after it too
                if track_id in next_dts:
                    dts = next_dts[track_id] - t.offset
                elif tfdt is not None:
                    dts = tfdt - t.offset
                elif (box_at, track_id) in sidx_pts:
                    dts = sidx_pts[box_at, track_id]
                else:
                    dts = t.end - t.offset
                implicit = _read_trun(p, ra, rb, t, track_id == video, base, dts,
                                      (duration, size, sflags), out, where)
                next_dts[track_id] = t.end


def _read_trun(p: bytes, a: int, b: int, t: _Trak, is_video: bool, base: int, dts: int,
               defaults, out: _Samples, where: str) -> int:
    """One ``trun``: the video track's samples into ``out``; returns the end
    of its data (the next implicit base)."""
    flags = int.from_bytes(p[a + 1:a + 4], "big")
    n = struct.unpack_from(">I", p, a + 4)[0]
    pos = a + 8
    data = 0
    if flags & TRUN_DATA:
        data = struct.unpack_from(">i", p, pos)[0]
        pos += 4
    duration, size, sflags = defaults
    first = sflags
    if flags & TRUN_FIRST:
        first = struct.unpack_from(">I", p, pos)[0]
        pos += 4
    fields = [f for f in (TRUN_DURATION, TRUN_SIZE, TRUN_FLAGS, TRUN_CTS) if flags & f]
    if pos + 4 * len(fields) * n > b:
        raise ValueError(f"{where}: trun lists {n} samples but holds fewer")
    rows = np.frombuffer(p, ">u4", n * len(fields), pos).reshape(n, len(fields)).astype(np.int64)
    col = {f: rows[:, i] for i, f in enumerate(fields)}
    durations = col.get(TRUN_DURATION, np.full(n, duration, np.int64))
    sizes = col.get(TRUN_SIZE, np.full(n, size, np.int64))
    sample_flags = col.get(TRUN_FLAGS, np.array([first] + [sflags] * (n - 1), np.int64)[:n])
    # composition offsets are signed in both versions, as ffmpeg reads them
    cts = col.get(TRUN_CTS, np.zeros(n, np.int64)).astype(np.uint32).astype(np.int32)
    starts = base + data + np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    times = dts + np.concatenate([[0], np.cumsum(durations)[:-1]]).astype(np.int64)
    if n:
        # fragments may overlap in time: ffmpeg decodes the samples whose
        # dts is not past the index entry before them and drops their pictures
        prev = t.last_dts
        shown = times > prev if prev is not None else np.ones(n, bool)
        if t.first_pts is None:
            t.first_pts = int(times[0] + cts[0])
        t.last_dts = int(times[-1])
        if is_video:
            out.offsets += starts.tolist()
            out.sizes += sizes.tolist()
            out.dts += times.tolist()
            out.cts += cts.astype(np.int64).tolist()
            out.sync += ((sample_flags & NON_SYNC_BITS) == 0).tolist()
            out.shown += shown.tolist()
    t.frames_for_fps += n
    t.duration_for_fps += int(durations.sum())
    t.end = dts + int(durations.sum()) + t.offset
    t.duration = max(t.duration, t.end)
    return int(base + data + sizes.sum())


def _read_sidx(p: bytes, end: int, traks: Dict[int, _Trak], sidx_pts, file_size: int, top,
               where: str) -> None:
    """A ``sidx``: each referenced fragment's presentation time (ffmpeg times
    a fragment without tfdt by it), and the track's duration."""
    version = p[0]
    track_id, scale = struct.unpack_from(">II", p, 4)
    if scale == 0:
        raise ValueError(f"{where}: sidx with a timescale of 0")
    if version == 0:
        pts, first = struct.unpack_from(">II", p, 12)
        pos = 20
    else:
        pts, first = struct.unpack_from(">QQ", p, 12)
        pos = 28
    count = struct.unpack_from(">H", p, pos + 2)[0]
    pos += 4
    t = traks.get(track_id)
    if t is None:
        return
    offset = end + first
    for _ in range(count):
        size, duration = struct.unpack_from(">II", p, pos)
        pos += 12
        if size & 0x80000000:
            raise ValueError(f"{where}: sidx reference_type 1 (a sidx of sidx boxes) is not "
                             "supported, as ffmpeg does not read it")
        sidx_pts[offset, track_id] = _rescale(pts, t.timescale, scale)
        offset += size
        pts += duration
    t.duration = t.end = pts       # as ffmpeg sets them: in the sidx's timescale
    # the sidx reaches the end of the file, or an mfra that ends it: ffmpeg's index is complete
    if offset == file_size or any(k == "mfra" and s == offset and s + n == file_size
                                  for k, s, _, n in top):
        for other in traks.values():      # ffmpeg gives tracks without a sidx this one's duration
            if other is not t and not other.has_sidx:
                other.duration = other.end = _rescale(t.duration, other.timescale, t.timescale)
    t.has_sidx = True


def frame_count(traks: Dict[int, _Trak], video: int) -> int:
    """cv2's CAP_PROP_FRAME_COUNT of a track whose moov lists no sample:
    floor(duration × fps + 0.5), the duration ffmpeg gives the file (the
    longest track, or the span from the earliest start to the latest end,
    in microseconds) and the video's mean frame rate over its samples."""
    v = traks[video]
    if not v.duration_for_fps:
        return 0
    spans = [(_rescale(t.first_pts, 1_000_000, t.timescale) if t.first_pts is not None else None,
              _rescale(t.duration, 1_000_000, t.timescale)) for t in traks.values()]
    duration = max(d for _, d in spans)
    started = [(s, d) for s, d in spans if s is not None]
    if started:
        duration = max(duration, max(s + d for s, d in started) - min(s for s, _ in started))
    fps = v.timescale * v.frames_for_fps / v.duration_for_fps
    return int(math.floor(duration / 1_000_000 * fps + 0.5))


# ------------------------------------------------------------------ tracks ----

def read_track(path) -> VideoTrack:
    """The sample table of the first video track of the mp4/mov ``path``
    (its moov's tables and, after them, its fragments')."""
    where = str(path)
    with open(path, "rb") as fh:
        top = _top_level(fh, where)
        moov = next((box for box in top if box[0] == "moov"), None)
        if moov is None:
            raise ValueError(f"{where}: no moov box (not an mp4/mov file, or a cut one)")
        _, start, header, size = moov
        fh.seek(start + header)
        buf = fh.read(size - header)
        file_size = fh.seek(0, 2)
        # the fragments' boxes; a moof the end of the file cuts is not read
        frags = []
        for kind, start, header, size in top:
            if kind in ("moof", "sidx") and start + size <= file_size:
                fh.seek(start + header)
                frags.append((kind, start, size, fh.read(size - header)))
    try:
        return _first_video_track(buf, file_size, where, frags, top)
    except (struct.error, IndexError) as e:     # a field past the end of its box
        raise ValueError(f"{where}: malformed moov or moof box ({e})") from e


def _display_matrix(buf: bytes, a: int, b: int, kind: str, where: str) -> Tuple[int, ...]:
    """The display matrix of the ``mvhd`` or ``tkhd`` box whose payload is
    ``buf[a:b]`` (version 0 or 1)."""
    at = a + {"mvhd": (36, 48), "tkhd": (40, 52)}[kind][buf[a] == 1]
    if at + 36 > b:
        raise ValueError(f"{where}: a {kind} box of {b - a} bytes, too short for its display "
                         "matrix")
    return struct.unpack_from(">9i", buf, at)


def _first_video_track(buf: bytes, file_size: int, where: str, frags, top) -> VideoTrack:
    moov = _children(buf, 0, len(buf), where)
    movie_scale = struct.unpack_from(">I", buf, moov["mvhd"][0] + (20 if buf[moov["mvhd"][0]] == 1
                                                                     else 12))[0] \
        if "mvhd" in moov else 0
    traks: Dict[int, _Trak] = {}
    video = movie_matrix = None
    for kind, ta, tb in iter_boxes(buf, 0, len(buf), where):
        if kind == "mvhd" and movie_matrix is None:
            movie_matrix = _display_matrix(buf, ta, tb, kind, where)
        if kind != "trak":
            continue
        trak = _children(buf, ta, tb, where)
        if "mdia" not in trak or "tkhd" not in trak:
            continue
        mdia = _children(buf, *trak["mdia"], where)
        if "mdhd" not in mdia:
            continue
        a, _ = trak["tkhd"]
        track_id = struct.unpack_from(">I", buf, a + (20 if buf[a] == 1 else 12))[0]
        a, _ = mdia["mdhd"]
        scale, duration = struct.unpack_from(">IQ" if buf[a] == 1 else ">II", buf,
                                             a + (20 if buf[a] == 1 else 12))
        edts = _children(buf, *trak["edts"], where) if "edts" in trak else {}
        edits = edit_list(buf, edts.get("elst"), where)
        traks.setdefault(track_id, _Trak(scale, duration, time_offset(edits, scale, movie_scale)))
        if video is None and "hdlr" in mdia and \
                buf[mdia["hdlr"][0] + 8:mdia["hdlr"][0] + 12] == b"vide":
            tkhd = _display_matrix(buf, *trak["tkhd"], "tkhd", where)
            video = (track_id, trak, mdia, edits, display_rotation(tkhd, movie_matrix))
    if video is None:
        raise ValueError(f"{where}: no video track")
    if "mvex" in moov:
        for kind, a, _ in iter_boxes(buf, *moov["mvex"], where):
            if kind == "trex":
                track_id, *trex = struct.unpack_from(">5I", buf, a + 4)
                if track_id in traks:
                    traks[track_id].trex = tuple(trex)
    return _video_track(buf, *video, traks, movie_scale, file_size, where, frags, top)


def _video_track(buf: bytes, track_id: int, trak, mdia, edits, rotation: int, traks,
                 movie_scale: int, file_size: int, where: str, frags, top) -> VideoTrack:
    t = traks[track_id]
    minf = _children(buf, *_child(mdia, "minf", where), where)
    stbl = _children(buf, *_child(minf, "stbl", where), where)
    codec, fourcc, width, height, avc, vpc, m4v, hvc = _sample_entry(
        buf, *_child(stbl, "stsd", where), where)
    sizes = sample_sizes(buf, stbl, file_size, where)
    n = len(sizes)
    if "co64" in stbl:
        chunks = _table(buf, stbl["co64"], "Q", where, "co64")[:, 0]
    else:
        chunks = _table(buf, stbl.get("stco"), "I", where, "stco")[:, 0]
    stsc = _table(buf, stbl.get("stsc"), "III", where, "stsc")
    offsets = (sample_offsets(sizes, chunks, stsc, where) if n or len(stsc) or len(chunks)
               else np.zeros(0, np.int64))
    stts = _table(buf, stbl.get("stts"), "II", where, "stts")
    ctts = _table(buf, stbl["ctts"], "II", where, "ctts") if "ctts" in stbl else None
    dts, pts = sample_times(stts, ctts, n, where)
    if "stss" in stbl:
        sync = np.zeros(n, bool)
        idx = _table(buf, stbl["stss"], "I", where, "stss")[:, 0] - 1
        if np.any((idx < 0) | (idx >= n)):
            raise ValueError(f"{where}: stss names a sample outside 1..{n}")
        sync[idx] = True
    else:
        sync = np.ones(n, bool)
    fragmented = t.trex is not None and any(k == "moof" for k, *_ in frags)
    order = edited_order(dts, pts, sync, edits, t.timescale, movie_scale, where, not fragmented)
    if not fragmented:
        if not n:
            raise ValueError(f"{where}: the video track has no samples")
        return VideoTrack(where, codec, fourcc, width, height, t.timescale, offsets, sizes, dts,
                          pts, sync, order, avc, vpc, m4v, frame_count=n, rotation=rotation,
                          hvc=hvc)
    if n and (len(order) != n or np.any(order != np.argsort(pts, kind="stable"))):
        raise ValueError(f"{where}: an edit list that drops or repeats samples of a moov that "
                         "fragments follow (a hybrid file): cv2's seek there does not follow its "
                         "read")
    # the moov's samples, then the fragments'
    t.end = t.duration_for_fps = int(stts[:, 0] @ stts[:, 1]) if n else 0
    t.frames_for_fps = n
    t.last_dts = int(dts[-1] - t.offset) if n else None
    t.first_pts = int(pts[0] - t.offset) if n else None
    out = _Samples(offsets.tolist(), sizes.tolist(), (dts - t.offset).tolist(),
                   (pts - dts).tolist(), sync.tolist(), [True] * n)
    _walk_fragments(frags, traks, track_id, out, file_size, top, where)
    offsets = np.array(out.offsets, np.int64)
    sizes = np.array(out.sizes, np.int64)
    if not len(offsets):
        raise ValueError(f"{where}: the video track has no samples")
    # a recording cut short: cv2 reads the samples before the first the file
    # does not hold whole (one the end cuts in two, which ffmpeg decodes
    # damaged, goes with those after it)
    past = np.flatnonzero(offsets + sizes > file_size)
    keep = int(past[0]) if len(past) else len(offsets)
    if keep == 0:
        raise ValueError(f"{where}: no sample of the video track lies in the file "
                         f"({len(offsets)} listed past its {file_size} bytes)")
    dts = np.array(out.dts[:keep], np.int64)
    cts = np.array(out.cts[:keep], np.int64)
    shift = -min(0, int(np.min(out.cts)))      # ffmpeg's dts_shift
    pts = dts + cts + shift
    shown = np.flatnonzero(np.array(out.shown[:keep], bool))
    order = shown[np.argsort(pts[shown], kind="stable")]
    t.first_pts += shift
    count = n or frame_count(traks, track_id)
    return VideoTrack(where, codec, fourcc, width, height, t.timescale, offsets[:keep],
                      sizes[:keep], dts, pts, np.array(out.sync[:keep], bool), order, avc, vpc,
                      m4v, frame_count=count, rotation=rotation, hvc=hvc)
