"""The port's VP8 decoder (``cap4d_torch/runtime/vp8.cpp`` through
``runtime/vp8.py`` and ``VideoFrameReader``) against ffmpeg's native
``vp8`` decoder, the one cv2 opens, on streams of libvpx's own encoder
(cv2's bundled library, called through ``tests/test_torch_vp9.py``'s ctypes
encoder functions), of cv2's ``VP80`` VideoWriter and of
``cap4d_torch/utils/vp8_writer.py`` (the header-level tools no encoder
setting reaches).

- Planes: ffmpeg's Y, U and V come from cv2's own libavcodec through
  ctypes, fed the samples the port's demuxers read from the file; the
  port's planes equal them bit for bit, every picture, read in order and
  shuffled. libvpx's own decoder (``vpx_codec_vp8_dx``) is a second
  reference: it agrees with ffmpeg on every libvpx and cv2 stream, and on
  the writer's stream it departs where :data:`LIBVPX_DEPARTURES` says
  (the port follows ffmpeg).
- RGB: ``VideoFrameReader(path, device="cpu")[k]`` against cap4d_tpu's
  ``load_frame(path, k)`` (cv2's decode and swscale conversion) on every
  frame, in order and shuffled; ``len`` against cv2's frame count.
- Pinned: the SHA-256 of ffmpeg's planes of each committed file, kept in
  ``vp8_writer.PINNED_SHA256``, which ``chip_smoke.py`` holds on the card's
  machine (no cv2, ffmpeg or libvpx there).
- The files under ``tests/data/vp8/`` were written by
  :func:`write_vp8_streams` (libvpx v1.15.2 and cv2 5.0.0, one thread); a
  test writes the libvpx and writer streams again and holds them to the
  same pins.
"""

import ctypes
import subprocess
import sys
import textwrap
from pathlib import Path

import cv2
import numpy as np
import pytest

from cap4d_torch.data import avi, container, mkv, mp4
from cap4d_torch.data.utils import VideoFrameReader, load_frame
from cap4d_torch.runtime import vp8 as rv
from cap4d_torch.utils import container_writer as cw
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_torch.utils import vp8_writer as vw
from cap4d_torch.utils import vp9_writer as vw9
from cap4d_tpu.data import utils as ju
from tests.test_torch_containers import cv2_sequential, ffmpeg_decode
from tests.test_torch_mpeg4 import _content, _libs
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)
from tests.test_torch_vp9 import (REALTIME, _assert_planes_equal, _port_planes, encode,
                                  file_samples, libvpx_planes, planes_sha256)

DATA = Path(__file__).parent / "data" / "vp8"


def _libvpx(w, h, n, **kw):
    """(samples, sync flags) of libvpx's VP8 encoder (one thread)."""
    pk = encode(w, h, n, codec="vp8", **kw)
    return [p for p, _ in pk], [k for _, k in pk]


def _concat(*parts):
    """Streams one after another, each from its key frame."""
    return [x for p in parts for x in p[0]], [k for p in parts for k in p[1]]


# name -> (container width, height, the stream's (samples, sync) builder): libvpx's
# settings of each tool, and the writer's
STREAMS = {
    # lag and auto alt-ref: hidden frames, golden and alt-ref, sign bias, SPLITMV
    "good_altref": (176, 144, lambda: _libvpx(176, 144, 30, kind="smooth", lag=16,
                                              two_pass=True,
                                              controls={"auto_alt_ref": 1, "cpu_used": 1})),
    # realtime with a static threshold and noise sensitivity: skips, segmentation.
    # (VP8's realtime mode picks its speed from timing unless cpu_used is
    # negative, a fixed speed: the encodes are then deterministic)
    "rt_static": (176, 144, lambda: _libvpx(176, 144, 16, deadline=REALTIME,
                                            cfg={"end_usage": 1, "bitrate": 300},
                                            controls={"cpu_used": -8, "static_threshold": 200,
                                                      "noise_sensitivity": 3})),
    "partitions": (176, 144, lambda: _libvpx(176, 144, 6, controls={"token_partitions": 3,
                                                                     "cpu_used": 4})),
    # g_profile 1, 2 and 3: bilinear, simple loop filter, full-pixel chroma
    "versions": (96, 64, lambda: _concat(*[_libvpx(96, 64, 4, cfg={"profile": v},
                                                   controls={"cpu_used": 4})
                                           for v in (1, 2, 3)])),
    # error-resilient mode: refresh_entropy_probs 0
    "resilient": (176, 144, lambda: _libvpx(176, 144, 10, cfg={"error_resilient": 1},
                                            controls={"cpu_used": 2})),
    # scaling bits (ignored by ffmpeg), then key frames of another size
    "resize": (176, 144, lambda: _concat(
        _libvpx(176, 144, 8, controls={"cpu_used": 2}, at={4: {"scale_mode": (1, 1)}}),
        _libvpx(120, 96, 6, controls={"cpu_used": 2}),
        _libvpx(176, 144, 4, controls={"cpu_used": 2}))),
    "odd": (99, 57, lambda: _libvpx(99, 57, 6, controls={"cpu_used": 4})),
    "sharp": (176, 144, lambda: _libvpx(176, 144, 8, kind="noisy",
                                        controls={"sharpness": 7, "cpu_used": 4})),
    "writer": (80, 48, lambda: (vw.tools_stream(), None)),
    # the card's timed load: 1080x1920 (portrait), a key frame every 8
    "load_1080": (1080, 1920, lambda: _libvpx(1080, 1920, 16, kind="smooth", deadline=REALTIME,
                                              cfg={"end_usage": 1, "bitrate": 1200,
                                                   "kf_max_dist": 8},
                                              controls={"cpu_used": -8})),
}
MP4 = {"good_altref", "load_1080"}       # also (load_1080: only) in mp4, as vp08
WEBM = set(STREAMS) - {"load_1080"}
# cv2's own VP80 writes: name -> (suffix, content, width, height, frames)
CV2_FILES = {"cv2_webm": (".webm", "smooth", 96, 64, 8), "cv2_mkv": (".mkv", "texture", 112, 80, 8),
             "cv2_avi": (".avi", "smooth", 80, 64, 10)}
# MediaRecorder's WebM layout: unknown sizes, no Cues, no Duration, 1 ms timecodes
RECORDER = "mediarecorder"


def stream_samples(name):
    """(samples, sync flags) of :data:`STREAMS`' ``name`` (sync from the frame tags)."""
    samples, sync = STREAMS[name][2]()
    return samples, sync if sync is not None else [avi.vp8_key(s) for s in samples]


def write_vp8_streams(out_dir, names=None) -> dict:
    """Encode :data:`STREAMS` and mux each into WebM (and mp4 for :data:`MP4`),
    plus the MediaRecorder-shaped WebM; {file name: path}."""
    out = {}
    names = list(STREAMS) + [RECORDER] if names is None else names
    for name in [n for n in names if n in STREAMS]:
        w, h, _ = STREAMS[name]
        samples, sync = stream_samples(name)
        s = cw.Stream("vp8", w, h, samples, sync, list(range(len(samples))))
        if name in MP4:
            path = Path(out_dir) / f"{name}.mp4"
            sa.write_mp4(path, samples, sa.visual_sample_entry(b"vp08", w, h, vw9.vpcc_box()),
                         w, h, sync=sync)
            out[path.name] = path
        if name in WEBM:
            path = Path(out_dir) / f"{name}.webm"
            cw.write_mkv(path, s, doc_type="webm")
            out[path.name] = path
        if name == "rt_static" and RECORDER in names:
            path = Path(out_dir) / f"{RECORDER}.webm"
            cw.write_mkv(path, s, doc_type="webm", unknown_sizes=True, cues=False,
                         duration=False, default_duration=False, fps=30)
            out[path.name] = path
    return out


def write_cv2_files(out_dir) -> dict:
    """cv2's VideoWriter with fourcc VP80 into WebM, Matroska and AVI; {name: path}."""
    out = {}
    for name, (suffix, kind, w, h, n) in CV2_FILES.items():
        path = Path(out_dir) / f"{name}{suffix}"
        wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"VP80"), 25, (w, h))
        assert wr.isOpened(), name
        for k in range(n):
            wr.write(_content(kind, k, w, h))
        wr.release()
        out[name] = path
    return out


# ------------------------------------------------------------------ files --

FILES = sorted(p.name for p in DATA.glob("*.*"))
# where libvpx's decoder departs from ffmpeg (and so from the port): file ->
# pictures. The writer's stream: picture 4 reads the golden frame after a
# frame that copied the alt-ref to the golden buffer and the golden frame to
# the alt-ref buffer (ffmpeg exchanges them, libvpx copies its new alt-ref
# back), picture 7 is of the reserved version 5 (ffmpeg: bilinear, libvpx:
# six-tap)
LIBVPX_DEPARTURES = {"writer.webm": [4, 7]}


def _stem(file_name):
    return file_name.rsplit(".", 1)[0]


@pytest.fixture(scope="module")
def refs():
    """{file name: ffmpeg's planes} of the committed files."""
    return {f: ffmpeg_decode("vp8", file_samples(DATA / f)) for f in FILES}


def test_committed_files_and_budget():
    """Every stream is committed (WebM, mp4 for some), with cv2's three VP80
    files and the MediaRecorder layout, pinned, within 1 MB together."""
    want = sorted([f"{n}.webm" for n in WEBM] + [f"{n}.mp4" for n in MP4] + [f"{RECORDER}.webm"]
                  + [f"{n}{spec[0]}" for n, spec in CV2_FILES.items()])
    assert FILES == want
    assert set(vw.PINNED_SHA256) == {_stem(f) for f in FILES}
    assert sum((DATA / f).stat().st_size for f in FILES) <= 1_000_000


@pytest.mark.parametrize("file_name", FILES)
def test_planes_bit_for_bit_and_pinned(refs, file_name):
    """Every picture's Y, U and V equal ffmpeg's, read in order and
    shuffled; ffmpeg's and the port's hash to the pin; libvpx's own decoder
    gives the same pictures but where LIBVPX_DEPARTURES says."""
    path, ref = DATA / file_name, refs[file_name]
    n, pin = vw.PINNED_SHA256[_stem(file_name)]
    assert (len(ref), planes_sha256(ref)) == (n, pin)
    port, reader = _port_planes(path)
    _assert_planes_equal(port, ref, file_name)
    t = reader.track
    assert t.codec == "vp8" and t.fourcc == {".mp4": "vp08", ".avi": "VP80"}.get(
        path.suffix, "V_VP8")
    if file_name.startswith("load_1080"):
        return
    order = np.random.default_rng(5).permutation(len(ref))
    _assert_planes_equal(_port_planes(path, order)[0], ref, f"{file_name} shuffled")
    other = libvpx_planes(file_samples(path), "vp8")
    assert len(other) == len(ref)
    differ = [k for k, (a, b) in enumerate(zip(other, ref))
              if any(not np.array_equal(p, q) for p, q in zip(a, b))]
    assert differ == LIBVPX_DEPARTURES.get(file_name, []), differ


@pytest.mark.parametrize("file_name", [f for f in FILES if not f.startswith(("load_1080",
                                                                             RECORDER))])
def test_rgb_matches_cap4d_tpu(file_name):
    """len is cv2's frame count; every frame's RGB equals cap4d_tpu's
    load_frame (cv2's decode and conversion: frames coded at another size
    or of an odd height through swscale's scaler, the writer's
    clamping_type 1 as full range), in order and shuffled; past the
    pictures (hidden frames) both raise IndexError."""
    path = DATA / file_name
    reader = VideoFrameReader(path, device="cpu")
    jax_reader = ju.VideoFrameReader(path)
    assert len(reader) == len(jax_reader) == int(cv2.VideoCapture(str(path)).get(
        cv2.CAP_PROP_FRAME_COUNT))
    pictures = len(reader._order)
    want = [ju.load_frame(path, k) for k in range(pictures)]
    for k in list(range(pictures)) + list(np.random.default_rng(6).permutation(pictures)):
        np.testing.assert_array_equal(reader[int(k)], want[k], err_msg=f"{file_name} frame {k}")
    for k in range(pictures, len(reader)):
        with pytest.raises(IndexError):
            ju.load_frame(path, k)
        with pytest.raises(IndexError, match="only hidden frames"):
            reader[k]
    if _stem(file_name) == "writer":        # the key frame of clamping_type 1, then not
        reader.planes(5)
        assert reader._vp8.full_range
        reader.planes(7)
        assert not reader._vp8.full_range


def test_mediarecorder_webm_reads_as_cv2():
    """The MediaRecorder layout (unknown element sizes, no Cues, no Duration):
    cv2 counts no frames (a negative count), so len raises as Python's len
    does on the JAX reader, and each frame equals cv2's sequential read and
    the port's load_frame raises ValueError as cap4d_tpu's does."""
    path = DATA / f"{RECORDER}.webm"
    reader = VideoFrameReader(path, device="cpu")
    assert int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT)) < 0
    with pytest.raises(ValueError, match="negative frame count"):
        len(reader)
    seq = cv2_sequential(path)
    assert len(seq) == len(reader._order) == 16
    for k in list(range(16)) + [3, 11, 0]:
        np.testing.assert_array_equal(reader[k], seq[k], err_msg=f"frame {k}")
    with pytest.raises(ValueError):
        load_frame(path, 0, device="cpu")


def test_load_1080_rgb_matches_cv2():
    """The 1080x1920 load (vp08 in mp4): each frame's RGB equals cv2's
    sequential read and, at two frames read at random, cap4d_tpu's load_frame."""
    path = DATA / "load_1080.mp4"
    reader = VideoFrameReader(path, device="cpu")
    seq = cv2_sequential(path)
    assert len(reader) == len(seq) == 16
    for k in range(16):
        np.testing.assert_array_equal(reader[k], seq[k], err_msg=f"frame {k}")
    for k in (13, 6):
        np.testing.assert_array_equal(reader[k], ju.load_frame(path, k), err_msg=f"frame {k}")


def test_ffmpeg_opens_its_native_decoder():
    """The decoder ffmpeg (and so cv2) opens for AV_CODEC_ID_VP8 is its native
    ``vp8``, the one the tests name, not ``libvpx``."""
    _, avcodec = _libs()
    avcodec.avcodec_find_decoder.restype = ctypes.c_void_p
    avcodec.avcodec_find_decoder.argtypes = [ctypes.c_int]
    codec = avcodec.avcodec_find_decoder(139)       # AV_CODEC_ID_VP8
    assert ctypes.c_char_p.from_address(codec).value == b"vp8"


def test_streams_written_again(tmp_path):
    """libvpx (one thread), the writer and cv2 write the same pictures again:
    fresh files decode to the pins (the port's decode)."""
    again = write_vp8_streams(tmp_path, [n for n in STREAMS if n != "load_1080"] + [RECORDER])
    again.update({p.name: p for p in write_cv2_files(tmp_path).values()})
    assert sorted(again) == [f for f in FILES if not f.startswith("load_1080")]
    for file_name, path in again.items():
        n, pin = vw.PINNED_SHA256[_stem(file_name)]
        port = _port_planes(path)[0]
        assert (len(port), planes_sha256(port)) == (n, pin), file_name


# which stream reaches each decoder tool (runtime/vp8.py's TOOLS)
TOOL_STREAMS = {
    "key_frame": "good_altref", "inter_frame": "good_altref", "hidden_frame": "good_altref",
    "version_0": "good_altref", "version_1": "versions", "version_2": "versions",
    "version_3": "versions", "size_change": "resize", "odd_size": "odd",
    "scaling_bits": "resize", "color_space": "writer", "clamping_type": "writer",
    "segmentation": "rt_static", "seg_map_update": "rt_static", "seg_map_kept": "writer",
    "seg_data_update": "rt_static", "seg_absolute": "writer", "seg_quant": "rt_static",
    "seg_filter": "writer", "filter_normal": "good_altref", "filter_simple": "versions",
    "filter_off": "good_altref", "sharpness": "sharp", "lf_deltas": "good_altref",
    "lf_delta_update": "good_altref", "partitions_2": "writer", "partitions_4": "writer",
    "partitions_8": "partitions", "quant_deltas": "writer", "refresh_golden": "good_altref",
    "refresh_altref": "good_altref", "golden_from_last": "writer",
    "golden_from_altref": "writer", "altref_from_last": "writer",
    "altref_from_golden": "good_altref", "sign_bias": "good_altref",
    "keep_entropy": "resilient", "keep_last": "good_altref", "coef_updates": "good_altref",
    "no_skip_flag": "writer", "skip": "good_altref", "ref_golden": "good_altref",
    "ref_altref": "good_altref", "ymode_update": "writer", "uv_mode_update": "writer",
    "mv_updates": "good_altref", "b_pred_key": "good_altref", "b_pred_inter": "good_altref",
    "i16_inter": "good_altref", "nearest": "good_altref", "near": "good_altref",
    "zero": "good_altref", "new": "good_altref", "split_16x8": "good_altref",
    "split_8x16": "good_altref", "split_8x8": "good_altref", "split_4x4": "good_altref",
    "sub_left": "good_altref", "sub_above": "good_altref", "sub_zero": "good_altref",
    "sub_new": "good_altref", "mv_long": "good_altref", "token_cat6": "good_altref",
    "edge_mc": "good_altref", "far_mc": "writer", "version_reserved": "writer",
}


def test_streams_cover_the_tools():
    """Every tool of the decoder (the bits vp8.cpp sets as it decodes) is
    reached by the stream TOOL_STREAMS names for it, a stream held to ffmpeg
    above; the decoder has no tool that no stream reaches."""
    assert set(TOOL_STREAMS) == set(rv.TOOLS)
    used = {}
    for name in set(TOOL_STREAMS.values()):
        dec = rv.Vp8Decoder(name)
        for s in file_samples(DATA / f"{name}.webm"):
            dec.decode(s)
        used[name] = dec.tools
    missing = [t for t, name in TOOL_STREAMS.items() if t not in used[name]]
    assert not missing, missing


def _count_decodes(reader):
    calls, decode = [0], reader._vp8.decode

    def counted(*args):
        calls[0] += 1
        return decode(*args)

    reader._vp8.decode = counted
    return calls


@pytest.mark.parametrize("file_name", ["good_altref.webm", "resize.webm", "load_1080.mp4"])
def test_reads_decode_each_sample_once(file_name):
    """A sequential read decodes each sample once (a hidden alt-ref frame on
    the way to the next picture); a random read decodes from the key frame
    at or before its sample, no further back."""
    path = DATA / file_name
    reader = VideoFrameReader(path, device="cpu")
    calls = _count_decodes(reader)
    for k in range(len(reader._order)):
        reader.planes(k)
    assert calls[0] == int(reader._order[-1]) + 1
    t = reader.track
    for k in (len(reader._order) - 1, len(reader._order) // 2):
        fresh = VideoFrameReader(path, device="cpu")
        calls = _count_decodes(fresh)
        fresh.planes(k)
        sample = int(fresh._order[k])
        key = int(np.flatnonzero(t.sync[:sample + 1])[-1])
        assert calls[0] == sample - key + 1, (k, calls)
    assert t.sync.sum() == {"good_altref.webm": 1, "resize.webm": 4, "load_1080.mp4": 2}[file_name]


_FUZZ = textwrap.dedent("""
    import random, sys
    from hypothesis import HealthCheck, given, settings, strategies as st
    from cap4d_torch.data import container
    from cap4d_torch.runtime.vp8 import Vp8Decoder

    t = container.read_track(sys.argv[1])
    samples = [t.sample(i) for i in range(len(t))]

    @settings(max_examples=int(sys.argv[2]), deadline=None, derandomize=True, database=None,
              suppress_health_check=list(HealthCheck))
    @given(st.integers(0, len(samples) - 1), st.integers(0, 2**32 - 1),
           st.sampled_from(["cut", "flip", "both", "bytes"]))
    def fuzz(k, seed, how):
        rng = random.Random(seed)
        dec = Vp8Decoder()
        try:
            for j in range(k):
                dec.decode(samples[j])
        except ValueError:
            return
        s = bytearray(samples[k])
        if how in ("flip", "both"):
            for _ in range(rng.randint(1, 8)):
                i = rng.randrange(len(s) * 8)
                s[i // 8] ^= 1 << (i % 8)
        if how == "bytes":
            for _ in range(rng.randint(1, 40)):
                s[rng.randrange(len(s))] = rng.randrange(256)
        if how in ("cut", "both"):
            s = s[:rng.randrange(len(s))]
        for sample in [bytes(s)] + samples[k + 1:k + 3]:
            try:
                dec.decode(sample)
            except ValueError:
                pass

    fuzz()
    print("fuzz ok")
""")


@pytest.mark.parametrize("name", ["good_altref", "writer"])
def test_corrupt_samples_raise_or_decode_never_crash(name):
    """Truncated, bit-flipped and overwritten samples (hypothesis, in a
    subprocess so that a crash fails this test instead of killing the
    worker), and the samples after them: each decodes or raises ValueError,
    never a signal."""
    proc = subprocess.run([sys.executable, "-c", _FUZZ, str(DATA / f"{name}.webm"), "60"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "fuzz ok" in proc.stdout, (proc.returncode,
                                                               proc.stderr[-2000:])


def test_refusals_name_the_element(tmp_path):
    """An inter frame before the first key frame, a key frame without its
    start code or of size 0, a cut frame tag and a first partition or token
    partition past the sample raise ValueError naming it, with the file and
    the frame through the reader."""
    inter = vw.inter_frame_first()
    with pytest.raises(ValueError, match="an inter frame before the first key frame"):
        rv.Vp8Decoder().decode(inter)
    path = tmp_path / "inter.webm"
    cw.write_mkv(path, cw.Stream("vp8", 32, 32, [inter], [True], [0]), doc_type="webm")
    with pytest.raises(ValueError) as e:
        VideoFrameReader(path, device="cpu")[0]
    assert str(path) in str(e.value) and "sample 0" in str(e.value)
    assert "an inter frame before the first key frame" in str(e.value)
    key = file_samples(DATA / "odd.webm")[0]
    for bad, phrase in [(key[:3] + b"\0\0\0" + key[6:], "start code"),
                        (key[:6] + b"\0\0" + key[8:], "size 0"),
                        (key[:2], "frame tag"),
                        (key[:60], "first partition"),
                        (key[:3] + b"\x9d\x01", "key frame header")]:
        with pytest.raises(ValueError, match=phrase):
            rv.Vp8Decoder().decode(bad)
    parts = file_samples(DATA / "partitions.webm")[0]
    first = int.from_bytes(parts[:3], "little") >> 5
    with pytest.raises(ValueError, match="token partition"):
        rv.Vp8Decoder().decode(parts[:10 + first + 12])


def test_scan_reads_headers_only():
    """The frame tags of the writer's stream: key frames (and their sizes),
    shown pictures, versions; a sample too short raises."""
    scans = [rv.scan(s) for s in file_samples(DATA / "writer.webm")]
    assert [s.key for s in scans] == [True, False, False, False, False, True, False, False, False]
    assert [s.shows for s in scans] == [True] * 6 + [False, True, True]
    assert [(s.width, s.height) for s in scans if s.key] == [(80, 48), (63, 33)]
    assert [s.version for s in scans] == [0] * 8 + [5]
    with pytest.raises(ValueError, match="frame tag"):
        rv.scan(b"\x00\x01")


def test_cv2_avi_and_matroska_layouts(tmp_path):
    """cv2's VP80 AVI: the key frames its index flags are the frame tags'
    (``avi.vp8_key``); the same samples in Matroska block groups with
    BlockAdditions (a browser's alpha plane) read as cv2 reads them (ffmpeg
    ignores the additions), and as an AVI written by the port's writer."""
    t = avi.read_track(DATA / "cv2_avi.avi")
    samples = file_samples(DATA / "cv2_avi.avi")
    assert (t.codec, t.fourcc, t.timed) == ("vp8", "VP80", False)
    assert list(t.sync) == [avi.vp8_key(s) for s in samples]
    s = cw.Stream("vp8", 80, 64, samples, list(t.sync), list(range(len(samples))))
    cw.write_mkv(tmp_path / "alpha.webm", s, doc_type="webm", blocks="group",
                 block_additions=[bytes([k]) * 32 for k in range(len(samples))])
    cw.write_avi(tmp_path / "port.avi", s)
    assert mkv.read_track(tmp_path / "alpha.webm").codec == "vp8"
    for path in (tmp_path / "alpha.webm", tmp_path / "port.avi"):
        reader = VideoFrameReader(path, device="cpu")
        assert len(reader) == int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))
        for k, want in enumerate(cv2_sequential(path)):
            np.testing.assert_array_equal(reader[k], want, err_msg=f"{path.name} frame {k}")
    assert mp4.read_track(DATA / "good_altref.mp4").fourcc == "vp08"
    assert container.read_track(DATA / "cv2_mkv.mkv").fourcc == "V_VP8"
