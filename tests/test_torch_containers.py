"""AVI and Matroska/WebM input of the port (``cap4d_torch/data/avi.py``,
``data/mkv.py``, ``data/container.py`` and ``VideoFrameReader``) against
cv2, which reads the same files through ffmpeg.

- The committed files under ``tests/data/containers/`` were written by cv2
  5.0.0's ``VideoWriter`` (:func:`write_cv2_containers`): AVI with
  ``MJPG``, ``XVID`` and ``PNG `` (stored as ``MPNG``), Matroska with
  ``MJPG`` and ``mp4v``, WebM with ``VP90``. On each, ``len`` is cv2's
  CAP_PROP_FRAME_COUNT and every frame, read in order and shuffled, equals
  cap4d_tpu's ``load_frame`` bit for bit (Motion-JPEG too: the port
  decodes video samples to ffmpeg's mjpeg planes and converts them as
  swscale does, as ``tests/test_torch_video.py`` holds it).
- The H.264 and MPEG-4 writers' streams, wrapped by
  ``utils/container_writer.py`` in every AVI index layout and Matroska
  variant: Y, U and V bit for bit against ffmpeg (cv2's libavcodec driven
  through ctypes on the writer's own samples, as
  ``tests/test_torch_mpeg4.py`` drives it), RGB equal to cap4d_tpu's
  ``load_frame`` and to cv2's sequential read, and each sample decoded once
  on a sequential read.
- The sample table of the same samples in mp4, AVI and Matroska is one.
- Refusals name the four-character code, CodecID or element; cut and
  corrupt files raise ``ValueError``, never ``struct.error``.
"""

import contextlib
import ctypes
import io
import re
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from cap4d_torch.data import avi, container, mkv, mp4
from cap4d_torch.data.utils import VideoFrameReader, load_frame
from cap4d_torch.utils import container_writer as cw
from cap4d_torch.utils import h264_writer as hw
from cap4d_torch.utils import hevc_writer
from cap4d_torch.utils import mpeg4_writer as mw
from cap4d_tpu.data import utils as ju
from tests.test_torch_mpeg4 import _content, _libs
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)
from tests.test_torch_video import _frames

DATA = Path(__file__).parent / "data" / "containers"
# name -> (fourcc, suffix, content, width, height, frames, fps)
CV2_FILES = {"mjpg_avi": ("MJPG", ".avi", "noise", 160, 120, 24, 25),
             "xvid_avi": ("XVID", ".avi", "smooth", 176, 144, 26, 25),
             "png_avi": ("PNG ", ".avi", "smooth", 96, 64, 10, 10),
             "mjpg_mkv": ("MJPG", ".mkv", "noise", 144, 112, 20, 30),
             "mp4v_mkv": ("mp4v", ".mkv", "texture", 200, 120, 26, 24),
             "vp90_webm": ("VP90", ".webm", "smooth", 64, 48, 6, 25)}


def write_cv2_containers(out_dir) -> dict:
    """Write :data:`CV2_FILES` with cv2's VideoWriter into ``out_dir``;
    {name: path}. Motion-JPEG takes smooth frames with mild noise
    (``test_torch_video._frames``), whose decodes stay within the recorded
    gap; the others ``test_torch_mpeg4._content``."""
    out = {}
    for name, (fourcc, suffix, kind, w, h, n, fps) in CV2_FILES.items():
        path = Path(out_dir) / f"{name}{suffix}"
        wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
        assert wr.isOpened(), name
        frames = ([np.ascontiguousarray(f[..., ::-1]) for f in _frames(n, h, w, seed=3)]
                  if kind == "noise" else [_content(kind, k, w, h) for k in range(n)])
        for f in frames:
            wr.write(f)
        wr.release()
        out[name] = path
    return out


def _quiet(fn, *args, **kw):
    """``fn`` with its standard output (load_frame's warnings) swallowed;
    the exception class it raised, if any."""
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            return fn(*args, **kw)
        except (IndexError, ValueError) as e:
            return type(e)


def _cv2_count(path) -> int:
    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def cv2_sequential(path):
    """cv2's frames in a sequential read, RGB."""
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame[..., ::-1])
    cap.release()
    return out


# ----------------------------------------------- ffmpeg's planes (ctypes) --

def ffmpeg_decode(codec: str, packets):
    """ffmpeg's (Y, U, V) of every picture it outputs for ``packets`` (in
    decode order), one thread: libavcodec's ``codec`` decoder inside cv2.
    Reads AVPacket.data (offset 24) and AVFrame's data, linesize, width and
    height (0, 64, 104, 108), as FFmpeg 5-8 lay them out."""
    avutil, avcodec = _libs()
    dec = avcodec.avcodec_find_decoder_by_name(codec.encode())
    ctx = ctypes.c_void_p(avcodec.avcodec_alloc_context3(dec))
    assert avutil.av_opt_set(ctx, b"threads", b"1", 0) == 0
    assert avcodec.avcodec_open2(ctx, dec, None) == 0
    pkt, frame = ctypes.c_void_p(avcodec.av_packet_alloc()), ctypes.c_void_p(avutil.av_frame_alloc())
    out = []

    def drain():
        while avcodec.avcodec_receive_frame(ctx, frame) == 0:
            f = frame.value
            data = (ctypes.c_void_p * 8).from_address(f)
            stride = (ctypes.c_int * 8).from_address(f + 64)
            w, h = (ctypes.c_int.from_address(f + off).value for off in (104, 108))
            planes = []
            for i, (pw, ph) in enumerate([(w, h)] + [((w + 1) // 2, (h + 1) // 2)] * 2):
                buf = (ctypes.c_uint8 * (stride[i] * ph)).from_address(data[i])
                planes.append(np.frombuffer(buf, np.uint8).reshape(ph, stride[i])[:, :pw].copy())
            out.append(tuple(planes))

    try:
        for s in packets:
            assert avcodec.av_new_packet(pkt, len(s)) == 0
            ctypes.memmove(ctypes.c_void_p.from_address(pkt.value + 24).value, s, len(s))
            avcodec.avcodec_send_packet(ctx, pkt)
            avcodec.av_packet_unref(pkt)
            drain()
        avcodec.avcodec_send_packet(ctx, None)
        drain()
    finally:
        avcodec.av_packet_free(ctypes.byref(pkt))
        avutil.av_frame_free(ctypes.byref(frame))
        avcodec.avcodec_free_context(ctypes.byref(ctx))
    return out


def writer_planes(s: cw.Stream):
    """ffmpeg's planes of a writer's stream, from its own samples (the
    parameter sets or the VOL before the first)."""
    if s.codec == "h264":
        params = b"".join(s.avc.sps) + b"".join(s.avc.pps)
        packets = [(params if i == 0 else b"") + mp4.annexb(x, s.avc.length_size)
                   for i, x in enumerate(s.samples)]
        return ffmpeg_decode("h264", packets)
    return ffmpeg_decode("mpeg4", [(s.dsi if i == 0 else b"") + x
                                   for i, x in enumerate(s.samples)])


# ------------------------------------------------------------------ files --

# the writers' streams: name -> writer call; the H.264 B streams are the
# ones whose luma tier-1 pins (h264_writer.PINNED_B_LUMA_SHA256)
STREAMS = {
    "h264_cavlc": lambda p: hw.write_h264_syntax_mp4(p, 64, 48, 12, 2, "cavlc"),
    "h264_cavlc_b": lambda p: hw.write_h264_syntax_mp4(p, 128, 96, 16, 1, "cavlc", b_frames=True),
    "h264_cabac_b": lambda p: hw.write_h264_syntax_mp4(p, 128, 96, 16, 5, "cabac", b_frames=True),
    "mpeg4_b": lambda p: mw.write_mpeg4_syntax_mp4(p, *mw.STREAMS["advanced"][:4],
                                                   **mw.STREAMS["advanced"][4]),
    "mpeg4_simple": lambda p: mw.write_mpeg4_syntax_mp4(p, *mw.STREAMS["simple"][:4],
                                                        **mw.STREAMS["simple"][4]),
}
# container variants: name -> (suffix, muxer, keyword arguments)
VARIANTS = {
    "avi_idx1": (".avi", cw.write_avi, {}),
    "avi_idx1_absolute_top_down": (".avi", cw.write_avi, dict(index="idx1_absolute",
                                                               top_down=True)),
    "avi_odml": (".avi", cw.write_avi, dict(index="odml")),
    "avi_no_index": (".avi", cw.write_avi, dict(index="none")),
    "avi_in_band_audio": (".avi", cw.write_avi, dict(in_band=True, audio=True)),
    "mkv": (".mkv", cw.write_mkv, {}),
    "mkv_group_negative": (".mkv", cw.write_mkv, dict(blocks="group", negative=True)),
    "mkv_live": (".mkv", cw.write_mkv, dict(unknown_sizes=True, cues=False, duration=False)),
    "mkv_vfw_audio": (".mkv", cw.write_mkv, dict(vfw=True, audio=True)),
    "mkv_strip": (".mkv", cw.write_mkv, dict(strip=3)),
    "mkv_zlib": (".mkv", cw.write_mkv, dict(compress=True)),
    "mkv_xiph": (".mkv", cw.write_mkv, dict(lacing="xiph")),
    "mkv_ebml": (".mkv", cw.write_mkv, dict(lacing="ebml")),
}
# lacing times frames by the block's duration: only streams that do not reorder
CASES = [(s, v) for s in STREAMS for v in VARIANTS
         if not (v in ("mkv_xiph", "mkv_ebml") and s not in ("h264_cavlc", "mpeg4_simple"))]


@pytest.fixture(scope="module")
def cv2_files():
    assert {n: spec[1] for n, spec in CV2_FILES.items()} == cw.CV2_FILE_SUFFIX
    return {name: DATA / f"{name}{spec[1]}" for name, spec in CV2_FILES.items()}


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{name: (mp4 path, Stream, ffmpeg's planes)} of :data:`STREAMS`."""
    d = tmp_path_factory.mktemp("container_streams")
    out = {}
    for name, write in STREAMS.items():
        path = d / f"{name}.mp4"
        write(path)
        s = cw.stream_of_mp4(path)
        out[name] = (path, s, writer_planes(s))
    return out


def _counted(reader):
    calls, decode = [0], reader._decoder.decode

    def counted(*args):
        calls[0] += 1
        return decode(*args)

    reader._decoder.decode = counted
    return calls


def _assert_planes(got, want, what):
    assert len(got) == len(want), f"{what}: {len(got)} frames, ffmpeg {len(want)}"
    for k, (a, b) in enumerate(zip(got, want)):
        for name, p, q in zip("YUV", a, b):
            np.testing.assert_array_equal(p, q, err_msg=f"{what} frame {k} plane {name}")


# ----------------------------------------------------- cv2-written files --

@pytest.mark.parametrize("name", [n for n in CV2_FILES if n != "vp90_webm"])
def test_cv2_files_match_jax(cv2_files, name):
    """len is cv2's count; every frame, in order and shuffled, equals the
    JAX reader's bit for bit and hashes to the pin chip_smoke.py holds on
    the card."""
    path = cv2_files[name]
    codec = {"MJPG": "mjpeg", "XVID": "mpeg4", "PNG ": "png", "mp4v": "mpeg4"}[CV2_FILES[name][0]]
    reader = VideoFrameReader(path, device="cpu")
    assert reader.track.codec == codec
    n = _cv2_count(path)
    assert len(reader) == n == CV2_FILES[name][5]
    want = [ju.load_frame(path, k) for k in range(n)]
    order = list(range(n)) + [int(k) for k in np.random.default_rng(4).permutation(n)]
    got = {}
    for k in order:
        got[k] = load_frame(path, k, device="cpu")
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} frame {k}")
    assert (n, cw.rgb_sha256([got[k] for k in range(n)])) == cw.PINNED_CV2_RGB_SHA256[name]
    assert sum(p.stat().st_size for p in cv2_files.values()) <= 400_000


def test_cv2_files_written_again(tmp_path, cv2_files):
    """cv2 writes the same pictures again (the port's decode of a fresh
    write hashes to the committed file's pin); the committed AVI files have
    only an idx1 index, with offsets from movi, and ffmpeg's in-band VOL."""
    again = write_cv2_containers(tmp_path)
    for name, path in again.items():
        if name == "vp90_webm":
            assert mkv.read_track(path).codec == "vp9"
            continue
        reader = VideoFrameReader(path, device="cpu")
        frames = [reader[k] for k in range(len(reader))]
        assert (len(frames), cw.rgb_sha256(frames)) == cw.PINNED_CV2_RGB_SHA256[name], name
    t = avi.read_track(cv2_files["xvid_avi"])
    assert (t.codec, t.fourcc, t.m4v.dsi, t.timed) == ("mpeg4", "XVID", b"", False)
    assert list(np.flatnonzero(t.sync)) == [0, 12, 24]
    assert avi.read_track(cv2_files["png_avi"]).fourcc == "MPNG"
    t = mkv.read_track(cv2_files["mp4v_mkv"])
    assert t.m4v.dsi.startswith(b"\0\0\1\xb0") and t.frame_count == 26


def test_vp9_webm_takes_the_vp9_path(cv2_files):
    """A VP9 WebM takes the path a vp09 mp4 takes: the port's VP9 decoder
    (``runtime/vp9.py``) on the host, on ``device="cpu"`` and on the default
    device alike; every frame equals cap4d_tpu's load_frame (cv2), read in
    order and shuffled, and hashes to the pin chip_smoke.py holds on the
    card."""
    path = cv2_files["vp90_webm"]
    t = container.read_track(path)
    assert (t.codec, t.fourcc, t.width, t.height, len(t)) == ("vp9", "V_VP9", 64, 48, 6)
    reader = VideoFrameReader(path)
    assert len(reader) == len(ju.VideoFrameReader(path)) == 6
    for k in list(range(6)) + list(np.random.default_rng(4).permutation(6)):
        want = ju.load_frame(path, int(k))
        np.testing.assert_array_equal(load_frame(path, int(k), device="cpu"), want, err_msg=f"{k}")
        np.testing.assert_array_equal(reader[int(k)], want, err_msg=f"frame {k}")
    frames = [reader[k] for k in range(6)]
    assert (6, cw.rgb_sha256(frames)) == cw.PINNED_CV2_RGB_SHA256["vp90_webm"]


# ------------------------------------------------- the writers' streams --

@pytest.mark.parametrize("stream,variant", CASES)
def test_writer_stream_in_container(streams, tmp_path, stream, variant):
    """Y, U and V equal ffmpeg's, in order (one decode a sample) and
    shuffled; the RGB equals cap4d_tpu's load_frame and cv2's sequential
    read; len is cv2's count (a Matroska file without a duration: both
    readers' len raise ValueError)."""
    _, s, ref = streams[stream]
    suffix, mux, kw = VARIANTS[variant]
    path = tmp_path / f"{stream}_{variant}{suffix}"
    mux(path, s, **kw)
    reader = VideoFrameReader(path, device="cpu")
    count = _cv2_count(path)
    if count < 0:
        with pytest.raises(ValueError, match="negative frame count"):
            len(reader)
        assert _quiet(ju.load_frame, path, 0) is ValueError
        assert _quiet(load_frame, path, 0, device="cpu") is ValueError
    else:
        assert len(reader) == count == len(s.samples)
    calls = _counted(reader)
    n = len(reader._order)
    _assert_planes([reader.planes(k) for k in range(n)], ref, f"{stream} in {variant}")
    assert calls[0] == len(s.samples)
    shuffled = VideoFrameReader(path, device="cpu")
    order = np.random.default_rng(5).permutation(n)
    got = {int(k): shuffled.planes(int(k)) for k in order}
    _assert_planes([got[k] for k in range(n)], ref, f"{stream} in {variant}, shuffled")
    seq = cv2_sequential(path)
    assert len(seq) == n
    for k in range(n):
        rgb = reader[k]
        np.testing.assert_array_equal(rgb, seq[k], err_msg=f"cv2's sequential read, frame {k}")
        if count >= 0:
            np.testing.assert_array_equal(load_frame(path, k, device="cpu"), ju.load_frame(path, k),
                                          err_msg=f"{stream} in {variant} frame {k}")


@pytest.mark.parametrize("stream", list(STREAMS))
def test_sample_tables_agree(streams, tmp_path, stream):
    """The same samples in mp4, AVI and Matroska: one sample table (bytes,
    sizes, sync flags) and one presentation order."""
    path, s, _ = streams[stream]
    cw.write_avi(tmp_path / "s.avi", s)
    cw.write_mkv(tmp_path / "s.mkv", s)
    tracks = [container.read_track(p) for p in (path, tmp_path / "s.avi", tmp_path / "s.mkv")]
    samples = [[t.sample(i) for i in range(len(t))] for t in tracks]
    assert samples[0] == samples[1] == samples[2]
    assert [len(x) for x in samples[0]] == list(tracks[0].sizes)
    for t in tracks[1:]:
        np.testing.assert_array_equal(t.sync, tracks[0].sync)
        assert (t.codec, t.width, t.height) == (tracks[0].codec, tracks[0].width, tracks[0].height)
    orders = [VideoFrameReader(p, device="cpu")._order
              for p in (path, tmp_path / "s.avi", tmp_path / "s.mkv")]
    np.testing.assert_array_equal(orders[1], orders[0])
    np.testing.assert_array_equal(orders[2], orders[0])
    assert tracks[1].timed is False and tracks[2].timed is True


def test_avi_random_read_skips_unreferenced(streams, tmp_path):
    """In an AVI (no times) a random read decodes from the last sync sample
    and skips the non-reference pictures and B-VOPs that show before its
    frame, as it does in mp4."""
    for stream in ("h264_cavlc_b", "mpeg4_b"):
        _, s, ref = streams[stream]
        cw.write_avi(tmp_path / f"{stream}.avi", s)
        for path in (streams[stream][0], tmp_path / f"{stream}.avi"):
            reader = VideoFrameReader(path, device="cpu")
            calls = _counted(reader)
            last = len(reader._order) - 1
            _assert_planes([reader.planes(last)], ref[last:], f"{path.name} last frame")
            sample = int(reader._order[last])
            sync = int(np.flatnonzero(reader.track.sync[:sample + 1])[-1])
            skipped = sum(reader._frame_of[j] < last and reader._unreferenced(j)
                          for j in range(sync, sample))
            assert calls[0] == sample - sync + 1 - skipped > 0, (path.name, calls[0])


@pytest.mark.parametrize("kind", ["avi", "mkv"])
def test_first_video_stream_is_read(streams, tmp_path, kind):
    """With an audio stream before it and a second video stream after it,
    cv2 and the port read the first video stream."""
    _, s, ref = streams["mpeg4_b"]
    path = tmp_path / f"two.{kind}"
    (cw.write_avi if kind == "avi" else cw.write_mkv)(path, s, audio=True, decoy=_jpegs(1)[0])
    reader = VideoFrameReader(path, device="cpu")
    assert reader.track.codec == "mpeg4" and len(reader) == _cv2_count(path) == len(ref)
    _assert_planes([reader.planes(k) for k in range(len(ref))], ref, f"{kind} with a decoy")
    for k, want in enumerate(cv2_sequential(path)):
        np.testing.assert_array_equal(reader[k], want, err_msg=f"{kind} frame {k}")


# ------------------------------------------------------- frame counts --

@pytest.mark.parametrize("kind,kw", [
    ("mkv", dict(default_duration=False)),            # MPEG-4's VOL rate, H.264's block rate
    ("mkv", dict(default_duration=33_366_667)),       # 30000/1001 by av_reduce
    ("mkv", dict(duration=16 * 40 - 21.0)),            # rounded down
    ("mkv", dict(fps=24)),                            # 41 ms frames
    ("avi", dict(length=0)),                          # cv2 counts 0: frame 0 for any k
    ("avi", dict(length=13)),                         # fewer than the samples
    ("avi", dict(length=19)),                         # more: the reads past them fail
])
def test_frame_count_and_bounds_follow_cv2(streams, tmp_path, kind, kw):
    """cv2's count however the container states it, and load_frame at and
    past it, as cap4d_tpu's load_frame reads it (IndexError where cv2's
    read fails)."""
    for stream in ("mpeg4_simple", "h264_cabac_b"):
        _, s, _ = streams[stream]
        path = tmp_path / f"{stream}.{kind}"
        (cw.write_mkv if kind == "mkv" else cw.write_avi)(path, s, **kw)
        n = _cv2_count(path)
        assert len(VideoFrameReader(path, device="cpu")) == n
        for k in range(max(n, 0) + 2):
            want, got = _quiet(ju.load_frame, path, k), _quiet(load_frame, path, k, device="cpu")
            if isinstance(want, type):
                assert got is want, (stream, k, want, got)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{stream} {kw} frame {k}")


# ------------------------------------------------------ Motion-JPEG --

def _strip_dht(jpeg: bytes) -> bytes:
    """A JPEG with its DHT segments cut out and an AVI1 APP0 marker, as
    cameras write Motion-JPEG."""
    out, pos = bytearray(jpeg[:2]), 2
    out += b"\xff\xe0" + struct.pack(">H", 16) + b"AVI1" + b"\0" * 10
    while pos < len(jpeg):
        marker = jpeg[pos + 1]
        if marker == 0xDA:
            return bytes(out + jpeg[pos:])
        size = struct.unpack_from(">H", jpeg, pos + 2)[0]
        if marker not in (0xC4, 0xE0):
            out += jpeg[pos:pos + 2 + size]
        pos += 2 + size
    raise ValueError("no SOS")


def _jpegs(n, h=72, w=96):
    return [cv2.imencode(".jpg", np.ascontiguousarray(f[..., ::-1]),
                         [cv2.IMWRITE_JPEG_QUALITY, 85])[1].tobytes() for f in _frames(n, h, w, 5)]


def test_mjpeg_without_dht_takes_the_standard_tables(tmp_path):
    """Camera Motion-JPEG (no DHT, an AVI1 marker): the runtime decodes it
    with the Annex K.3 tables, equal to the frames with their tables and to
    cv2's read of the AVI, in order and shuffled."""
    jpegs = _jpegs(6)
    bare = [_strip_dht(j) for j in jpegs]
    assert all(b"\xff\xc4" not in b[:b.index(b"\xff\xda")] for b in bare)
    s = cw.Stream("mjpeg", 96, 72, bare, [True] * 6, list(range(6)))
    cw.write_avi(tmp_path / "cam.avi", s)
    s.samples = jpegs
    cw.write_avi(tmp_path / "tables.avi", s)
    for k in list(range(6)) + [int(k) for k in np.random.default_rng(2).permutation(6)]:
        got = load_frame(tmp_path / "cam.avi", k, device="cpu")
        np.testing.assert_array_equal(got, load_frame(tmp_path / "tables.avi", k, device="cpu"))
        np.testing.assert_array_equal(got, ju.load_frame(tmp_path / "cam.avi", k),
                                      err_msg=f"frame {k}")


@pytest.mark.parametrize("lacing", ["xiph", "fixed", "ebml"])
def test_mjpeg_lacing(tmp_path, lacing):
    """Motion-JPEG in laced Matroska blocks (frames padded after their EOI
    to one size for fixed lacing): every frame at cv2's place."""
    jpegs = _jpegs(10)
    if lacing == "fixed":
        size = max(map(len, jpegs))
        jpegs = [j + b"\0" * (size - len(j)) for j in jpegs]
    sync = [k % 4 == 0 for k in range(10)]
    s = cw.Stream("mjpeg", 96, 72, jpegs, sync, list(range(10)))
    path = tmp_path / f"{lacing}.mkv"
    cw.write_mkv(path, s, lacing=lacing)
    t = mkv.read_track(path)
    assert [t.sample(i) for i in range(10)] == jpegs and list(t.sync) == sync
    assert len(VideoFrameReader(path, device="cpu")) == _cv2_count(path) == 10
    for k in list(range(10)) + [int(k) for k in np.random.default_rng(1).permutation(10)]:
        np.testing.assert_array_equal(load_frame(path, k, device="cpu"), ju.load_frame(path, k),
                                      err_msg=f"{lacing} frame {k}")


# -------------------------------------------------------------- refusals --

def _mjpeg_stream():
    return cw.Stream("mjpeg", 96, 72, _jpegs(3), [True] * 3, [0, 1, 2])


@pytest.mark.parametrize("case,phrase", [
    ("avi_av1", "'AV01' \\(AV1\\)"), ("avi_hevc", "Main 10"),
    ("avi_msmpeg4", "'DIV3' \\(MS-MPEG-4 v3\\)"), ("mkv_theora", "'V_THEORA' \\(Theora\\)"),
    ("mkv_hevc", "chroma_format_idc 2 \\(4:2:2\\)"), ("mkv_av1", "'V_AV1' \\(AV1\\)"),
    ("mkv_vfw_msmpeg4", "V_MS/VFW/FOURCC 'MP43' \\(MS-MPEG-4 v3\\)"),
    ("mkv_encrypted", "encrypted \\(ContentEncryption\\)"),
    ("mkv_two_encodings", "2 ContentEncodings"), ("avi_zero_size", "zero-size chunk"),
    ("avi_divx_packed", "more than one VOP in one sample"),
    ("ebml_doctype", "EBML DocType 'mka2'"), ("unknown", "first bytes are 47 49 46 38"),
])
def test_refusals_name_what_they_refuse(tmp_path, case, phrase):
    """Each raises ValueError naming the file and the fourcc, CodecID or
    element, at open (the packed DivX bitstream at its packed frame). HEVC
    decodes in both containers: its refusals name the tool (a Main 10 SPS in
    an AVI's extradata, a 4:2:2 SPS in a Matroska hvcC)."""
    path = tmp_path / f"{case}.bin"
    s = _mjpeg_stream()
    if case in ("avi_hevc", "mkv_hevc"):
        hevc_writer.write_hevc_refusal_mp4(tmp_path / "src.mp4",
                                           "main10" if case == "avi_hevc" else "422")
        hevc = cw.stream_of_mp4(tmp_path / "src.mp4")
        (cw.write_avi if case == "avi_hevc" else cw.write_mkv)(path, hevc)
    elif case.startswith("avi_") and case not in ("avi_zero_size", "avi_divx_packed"):
        cw.write_avi(path, s, fourcc={"avi_av1": b"AV01", "avi_msmpeg4": b"DIV3"}[case])
    elif case in ("mkv_theora", "mkv_av1"):
        cw.write_mkv(path, s, codec_id={"mkv_theora": "V_THEORA", "mkv_av1": "V_AV1"}[case])
    elif case == "mkv_vfw_msmpeg4":
        cw.write_mkv(path, s, codec_id="V_MS/VFW/FOURCC",
                     codec_private=cw.bitmap_info_header(b"MP43", 96, 72))
    elif case == "mkv_encrypted":
        cw.write_mkv(path, s, encrypted=True)
    elif case == "mkv_two_encodings":
        cw.write_mkv(path, s, strip=2, compress=True)
    elif case == "avi_zero_size":
        s.samples[1] = b""
        cw.write_avi(path, s)
    elif case == "avi_divx_packed":
        mw.write_mpeg4_refusal_mp4(tmp_path / "packed.mp4", "packed")
        cw.write_avi(path, cw.stream_of_mp4(tmp_path / "packed.mp4"), fourcc=b"DX50")
    elif case == "ebml_doctype":
        cw.write_mkv(path, s, doc_type="mka2")
    else:
        path.write_bytes(b"GIF89a" + b"\0" * 40)
    with pytest.raises(ValueError) as e:
        reader = VideoFrameReader(path, device="cpu")
        for k in range(len(reader.track)):
            reader[k]
    assert str(path) in str(e.value)
    assert re.search(phrase, str(e.value)), str(e.value)


@pytest.mark.parametrize("kind", ["avi", "mkv"])
def test_cut_and_corrupt_files_raise_value_error(streams, tmp_path, kind):
    """A file cut at any length, or with bytes overwritten (0, 1, 2^32 - 1
    or random words): the demuxer returns a table whose samples lie in the
    file, or raises ValueError, never another error."""
    _, s, _ = streams["h264_cavlc_b"]
    src = tmp_path / f"src.{kind}"
    (cw.write_avi if kind == "avi" else cw.write_mkv)(src, s, **(
        dict(index="odml") if kind == "avi" else dict(blocks="group")))
    data = src.read_bytes()
    rng = np.random.default_rng(11)
    path = tmp_path / f"bad.{kind}"
    trials = [data[:int(c)] for c in rng.integers(0, len(data), 80)]
    for _ in range(200):
        d = bytearray(data)
        for j in rng.integers(0, len(d) - 4, rng.integers(1, 5)):
            d[j:j + 4] = struct.pack("<I", int(rng.choice([0, 1, 0xFFFFFFFF,
                                                           rng.integers(0, 1 << 32)])))
        trials.append(bytes(d))
    for d in trials:
        path.write_bytes(d)
        try:
            t = container.read_track(path)
        except ValueError:
            continue
        assert np.all(t.offsets + t.sizes <= len(d)) and len(t) <= len(d)


def test_probe_by_content_not_extension(streams, tmp_path):
    """The demuxer follows the bytes: an AVI named .mp4 and an mp4 named
    .mkv read; an mp4 cut after its ftyp names its missing moov; an empty
    file names its emptiness."""
    path, s, _ = streams["mpeg4_simple"]
    cw.write_avi(tmp_path / "avi.mp4", s)
    (tmp_path / "mp4.mkv").write_bytes(path.read_bytes())
    assert container.read_track(tmp_path / "avi.mp4").fourcc == "FMP4"
    assert container.read_track(tmp_path / "mp4.mkv").fourcc == "mp4v"
    (tmp_path / "cut.avi").write_bytes(b"\0\0\0\x10ftypmp42\0\0\0\0")
    with pytest.raises(ValueError, match="no moov box"):
        container.read_track(tmp_path / "cut.avi")
    (tmp_path / "empty.mkv").write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        load_frame(tmp_path / "empty.mkv", 0, device="cpu")
