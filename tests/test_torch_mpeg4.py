"""The port's MPEG-4 Part 2 decoder (``cap4d_torch/runtime/mpeg4.cpp``
through ``runtime/mpeg4.py`` and ``VideoFrameReader``) against ffmpeg, the
decoder inside cv2, on ``mp4v`` files that cv2 writes and on streams of
seeded random syntax written by ``cap4d_torch/utils/mpeg4_writer.py`` (the
tools cv2's encoder never emits: B-VOPs, quarter-sample, 4MV, MPEG
quantisation, resync markers, not-coded VOPs, ...).

- Planes: ffmpeg's Y, U and V come from cv2's own libavcodec (the shared
  library cv2 5.0 ships, driven through ctypes with one thread; on these
  files cv2's ``CAP_PROP_CONVERT_RGB`` 0 read returns the same Y, where the
  stream signals BT.601 limited range, and a grey conversion otherwise).
  The port's planes equal them bit for bit, every frame. ffmpeg's x86 IDCT
  gives the output of its C "simple" IDCT here, which the port runs;
  ffmpeg's 8-wide no-rounding half-sample averages are approximate, and the
  port does as they do.
- RGB: ``load_frame`` against cap4d_tpu's ``load_frame`` (cv2's decode and
  swscale conversion) bit for bit, every frame, in order and shuffled.
- Pinned: the SHA-256 of ffmpeg's planes of each file, kept in
  ``mpeg4_writer.PINNED_SHA256``, which ``chip_smoke.py`` holds on the
  card's machine (no cv2 there).
- The cv2 files under ``tests/data/mpeg4/`` were written by
  :func:`write_cv2_streams` (cv2 5.0.0); a test writes them again and holds
  the decode of both to the same pins.
"""

import ctypes
import glob
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import cv2
import numpy as np
import pytest

from cap4d_torch.data import mp4
from cap4d_torch.data.utils import VideoFrameReader, load_frame
from cap4d_torch.utils import mpeg4_writer as mw
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_tpu.data import utils as ju
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

DATA = Path(__file__).parent / "data" / "mpeg4"
# name -> (content, width, height, frames, fps): cv2 keeps a GOP of 12 and
# picks its quantiser by rate control, so the lower frame rates and busier
# contents land on coarser quantisers
CV2_STREAMS = {"qcif_smooth": ("smooth", 176, 144, 24, 25),
               "qvga_texture": ("texture", 320, 240, 14, 8),
               "crop_noisy": ("noisy", 200, 120, 14, 4)}


def _content(kind, k, w, h):
    """Frame ``k`` (BGR) of a content: smooth waves and a moving disc, a
    drifting texture, or that texture with noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    if kind == "smooth":
        r = 128 + 80 * np.sin(x / 23 + 0.15 * k) * np.cos(y / 31)
        g = 128 + 60 * np.cos((x + y) / 40 - 0.1 * k)
        b = 100 + 0.4 * x - 0.2 * y
        img = np.stack([b, g, r], -1)
        cx, cy = w / 2 + 0.3 * w * np.cos(0.2 * k), h / 2 + 0.25 * h * np.sin(0.2 * k)
        img[(x - cx) ** 2 + (y - cy) ** 2 < (0.12 * h) ** 2] = (40, 200, 230)
    else:
        rng = np.random.default_rng(7)
        tex = rng.integers(30, 226, (h // 10 + 4, w // 10 + 4, 3)).astype(np.float32)
        tex = cv2.resize(tex, (w + 12, h + 12), interpolation=cv2.INTER_CUBIC)
        img = tex[(k // 2) % 12:(k // 2) % 12 + h, (3 * k) % 12:(3 * k) % 12 + w]
        if kind == "noisy":
            img = img + np.random.default_rng(k).normal(0, 40, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_cv2_streams(out_dir) -> dict:
    """Write :data:`CV2_STREAMS` with cv2's VideoWriter ("mp4v", its
    default codec) into ``out_dir``; {name: path}."""
    out = {}
    for name, (kind, w, h, n, fps) in CV2_STREAMS.items():
        path = Path(out_dir) / f"{name}.mp4"
        wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        assert wr.isOpened()
        for k in range(n):
            wr.write(_content(kind, k, w, h))
        wr.release()
        out[name] = path
    return out


# ------------------------------------------- ffmpeg's planes through ctypes --

def _libs():
    libs = Path(cv2.__file__).parent.parent / "opencv_python.libs"
    avutil = ctypes.CDLL(glob.glob(str(libs / "libavutil-*.so*"))[0], mode=ctypes.RTLD_GLOBAL)
    avcodec = ctypes.CDLL(glob.glob(str(libs / "libavcodec-*.so*"))[0])
    p = ctypes.c_void_p
    for lib, name, res, args in [
            (avcodec, "avcodec_find_decoder_by_name", p, [ctypes.c_char_p]),
            (avcodec, "avcodec_alloc_context3", p, [p]),
            (avcodec, "avcodec_open2", ctypes.c_int, [p, p, p]),
            (avcodec, "avcodec_free_context", None, [ctypes.POINTER(p)]),
            (avcodec, "av_packet_alloc", p, []), (avcodec, "av_packet_free", None, [ctypes.POINTER(p)]),
            (avcodec, "av_new_packet", ctypes.c_int, [p, ctypes.c_int]),
            (avcodec, "avcodec_send_packet", ctypes.c_int, [p, p]),
            (avcodec, "avcodec_receive_frame", ctypes.c_int, [p, p]),
            (avcodec, "av_packet_unref", None, [p]), (avutil, "av_frame_alloc", p, []),
            (avutil, "av_frame_free", None, [ctypes.POINTER(p)]),
            (avutil, "av_opt_set", ctypes.c_int, [p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int])]:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return avutil, avcodec


def ffmpeg_planes(path):
    """ffmpeg's (Y, U, V) of every picture it outputs, in output order
    (presentation order; a not-coded VOP gives none): libavcodec's mpeg4
    decoder, one thread, the track's samples with its DecoderSpecificInfo
    before the first. Reads AVPacket.data (offset 24) and AVFrame's data,
    linesize, width and height (0, 64, 104, 108), as FFmpeg 5-8 lay them out."""
    avutil, avcodec = _libs()
    t = mp4.read_track(path)
    codec = avcodec.avcodec_find_decoder_by_name(b"mpeg4")
    ctx = ctypes.c_void_p(avcodec.avcodec_alloc_context3(codec))
    assert avutil.av_opt_set(ctx, b"threads", b"1", 0) == 0
    assert avcodec.avcodec_open2(ctx, codec, None) == 0
    pkt, frame = ctypes.c_void_p(avcodec.av_packet_alloc()), ctypes.c_void_p(avutil.av_frame_alloc())
    out = []

    def drain():
        while avcodec.avcodec_receive_frame(ctx, frame) == 0:
            f = frame.value
            data = (ctypes.c_void_p * 8).from_address(f)
            stride = (ctypes.c_int * 8).from_address(f + 64)
            w, h = (ctypes.c_int.from_address(f + off).value for off in (104, 108))
            planes = []
            for i, (pw, ph) in enumerate([(w, h), ((w + 1) // 2, (h + 1) // 2)] + [((w + 1) // 2, (h + 1) // 2)]):
                buf = (ctypes.c_uint8 * (stride[i] * ph)).from_address(data[i])
                planes.append(np.frombuffer(buf, np.uint8).reshape(ph, stride[i])[:, :pw].copy())
            out.append(tuple(planes))

    try:
        for i in range(len(t)):
            s = (t.m4v.dsi if i == 0 else b"") + t.sample(i)
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


def cv2_luma(path):
    """cv2's reads with ``CAP_PROP_CONVERT_RGB`` 0, in order."""
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return out


planes_sha256 = mw.planes_sha256


# ------------------------------------------------------------------ files --

@pytest.fixture(scope="module")
def writer_streams(tmp_path_factory):
    """{name: (path, writer stats, ffmpeg's planes)} of mpeg4_writer.STREAMS."""
    d = tmp_path_factory.mktemp("mpeg4")
    out = {}
    for name, (w, h, n, seed, kw) in mw.STREAMS.items():
        path = d / f"{name}.mp4"
        stats = mw.write_mpeg4_syntax_mp4(path, w, h, n, seed, **kw)
        out[name] = (path, stats, ffmpeg_planes(path))
    return out


@pytest.fixture(scope="module")
def cv2_streams():
    """{name: (path, ffmpeg's planes)} of the committed cv2 files."""
    return {name: (DATA / f"{name}.mp4", ffmpeg_planes(DATA / f"{name}.mp4"))
            for name in CV2_STREAMS}


def _port_planes(path, order=None):
    reader = VideoFrameReader(path, device="cpu")
    n = len(reader._order)
    got = {}
    for k in (range(n) if order is None else order):
        got[int(k)] = reader.planes(int(k))
    return [got[k] for k in range(n)], reader


def _assert_planes_equal(port, ref, what):
    assert len(port) == len(ref), f"{what}: {len(port)} frames, ffmpeg {len(ref)}"
    for k, (a, b) in enumerate(zip(port, ref)):
        for name, p, q in zip("YUV", a, b):
            assert p.shape == q.shape, f"{what} frame {k} {name}: {p.shape} vs {q.shape}"
            np.testing.assert_array_equal(p, q, err_msg=f"{what} frame {k} plane {name}")


@pytest.mark.parametrize("name", list(CV2_STREAMS))
def test_cv2_streams_planes_bit_for_bit(cv2_streams, name):
    """Every frame's Y, U and V of a cv2-written file equal ffmpeg's, read in
    order and shuffled; ffmpeg's Y equals cv2's own read."""
    path, ref = cv2_streams[name]
    t = mp4.read_track(path)
    assert (t.codec, t.fourcc, t.m4v.object_type) == ("mpeg4", "mp4v", 0x20)
    assert list(np.flatnonzero(t.sync)) == list(range(0, len(t), 12))
    luma = cv2_luma(path)
    assert len(luma) == len(ref) == len(t)
    for k, (y, r) in enumerate(zip(luma, ref)):
        np.testing.assert_array_equal(y, r[0], err_msg=f"cv2's read of frame {k}")
    port, _ = _port_planes(path)
    _assert_planes_equal(port, ref, name)
    order = np.random.default_rng(1).permutation(len(t))
    shuffled, reader = _port_planes(path, order)
    _assert_planes_equal(shuffled, ref, f"{name} shuffled")
    assert reader._mpeg4.vop.type in "IP" and not reader._mpeg4.vop.xvid_idct


def test_cv2_streams_cover_sizes_and_quantisers(cv2_streams):
    """The committed files: three sizes (one not a multiple of 16), GOPs of
    12, I- and P-VOPs only, several quantisers."""
    quants, sizes = set(), set()
    for path, _ in cv2_streams.values():
        reader = VideoFrameReader(path, device="cpu")
        sizes.add((reader.track.width, reader.track.height))
        for k in range(len(reader)):
            reader.planes(k)
            quants.add(reader._mpeg4.vop.quant)
        assert set(reader._vop_type) == {"I", "P"}
    assert {(176, 144), (320, 240), (200, 120)} == sizes
    assert len(quants) >= 4, quants
    assert sum(p.stat().st_size for p, _ in cv2_streams.values()) <= 200_000


def test_cv2_streams_pinned_and_rewritten(cv2_streams, tmp_path):
    """The committed files' planes hash to the pins (ffmpeg's and the
    port's); cv2 writes the same pictures again from write_cv2_streams."""
    again = write_cv2_streams(tmp_path)
    for name, (path, ref) in cv2_streams.items():
        want = mw.PINNED_CV2_SHA256[name]
        assert planes_sha256(ref) == want, name
        assert planes_sha256(_port_planes(path)[0]) == want, name
        assert planes_sha256(ffmpeg_planes(again[name])) == want, f"{name} written again"


@pytest.mark.parametrize("name", list(mw.STREAMS))
def test_writer_streams_planes_bit_for_bit(writer_streams, name):
    """Every frame's Y, U and V of a random-syntax stream equal ffmpeg's (in
    order and shuffled), and hash to the pins."""
    path, stats, ref = writer_streams[name]
    port, reader = _port_planes(path)
    _assert_planes_equal(port, ref, name)
    order = np.random.default_rng(2).permutation(len(ref))
    _assert_planes_equal(_port_planes(path, order)[0], ref, f"{name} shuffled")
    assert planes_sha256(ref) == mw.PINNED_SHA256[name], name
    assert reader._mpeg4.vop.xvid_idct == name.startswith("xvid")


def test_writer_streams_cover_the_tools(writer_streams):
    """Together the streams use every tool the writer exists for."""
    tools = {}
    for _, stats, _ in writer_streams.values():
        for key, v in stats["tools"].items():
            tools[key] = tools.get(key, 0) + v
    need = ["inter4v", "not_coded", "vop_coded0", "b_direct", "b_interpolate", "b_backward",
            "b_forward", "b_direct_from_4mv", "b_skipped", "dbquant", "dquant", "quarter",
            "mpeg_quant", "packets", "hec", "escape1", "escape2", "escape3", "ac_pred",
            "dc_as_ac", "stuffing", "signal", "cropped", "gov"]
    need += [f"dc_thr{i}" for i in range(8)] + [f"fcode{i}" for i in range(1, 8)]
    missing = [k for k in need if not tools.get(k)]
    assert not missing, missing


@pytest.mark.parametrize("name", ["qcif_smooth", "crop_noisy", "simple", "advanced"])
def test_load_frame_rgb_matches_jax(cv2_streams, writer_streams, name):
    """RGB of the port's load_frame equals cap4d_tpu's (cv2) on every frame,
    read in order and shuffled, one past the end included."""
    path = cv2_streams[name][0] if name in cv2_streams else writer_streams[name][0]
    n = len(VideoFrameReader(path, device="cpu"))
    for k in list(range(n + 1)) + list(np.random.default_rng(3).permutation(n)):
        try:
            want = ju.load_frame(path, int(k))
        except IndexError:
            with pytest.raises(IndexError, match="not-coded VOPs"):
                load_frame(path, int(k), device="cpu")
            continue
        np.testing.assert_array_equal(load_frame(path, int(k), device="cpu"), want,
                                      err_msg=f"{name} frame {k}")


def test_xvid_user_data_switches_the_idct(cv2_streams, tmp_path):
    """The cv2 files with user data naming an Xvid build: ffmpeg decodes
    them with the Xvid IDCT, and so does the port, bit for bit. Against the
    simple IDCT's pictures the Xvid IDCT's differ by 1 at each I-VOP and by
    at most 3 (a sample of 255) within the 12-VOP GOPs of these files."""
    for name, (path, simple) in cv2_streams.items():
        t = mp4.read_track(path)
        xvid = tmp_path / f"{name}_xvid.mp4"
        entry = sa.visual_sample_entry(b"mp4v", t.width, t.height,
                                       mw.esds_box(t.m4v.dsi + b"\0\0\1\xb2XviD0050"))
        sa.write_mp4(xvid, [t.sample(i) for i in range(len(t))], entry, t.width, t.height,
                     sync=list(t.sync))
        ref = ffmpeg_planes(xvid)
        port, reader = _port_planes(xvid)
        _assert_planes_equal(port, ref, f"{name} with Xvid user data")
        assert reader._mpeg4.vop.xvid_idct
        drift = [max(int(np.abs(a.astype(int) - b).max()) for a, b in zip(f, g))
                 for f, g in zip(simple, ref)]
        assert [drift[k] for k in np.flatnonzero(t.sync)] == [1] * int(t.sync.sum()), drift
        assert max(drift) <= 3, drift


def _count_decodes(reader):
    """The reader's decode calls, counted: a list whose first item is the count."""
    calls, decode = [0], reader._mpeg4.decode

    def counted(*args):
        calls[0] += 1
        return decode(*args)

    reader._mpeg4.decode = counted
    return calls


def test_sequential_read_decodes_each_sample_once(writer_streams):
    """A B-VOP stream read frame by frame decodes each sample once and puts
    B-VOPs in presentation order; a random read skips the B-VOPs shown
    before its frame."""
    path, stats, ref = writer_streams["advanced"]
    reader = VideoFrameReader(path, device="cpu")
    calls = _count_decodes(reader)
    samples = []
    for k in range(len(reader)):
        reader.planes(k)
        samples.append(reader._last[0])
    assert calls[0] == len(reader), calls
    assert "B" in stats["vops"] and list(reader.track.order) != list(range(len(reader)))
    pts = list(reader.track.pts[samples])
    assert pts == sorted(pts)
    last = len(reader) - 1
    fresh = VideoFrameReader(path, device="cpu")
    calls = _count_decodes(fresh)
    fresh.planes(last)
    sample = int(fresh.track.order[last])
    sync = int(np.flatnonzero(fresh.track.sync[:sample + 1])[-1])
    between = fresh._vop_type[sync:sample]
    assert calls[0] == int(np.sum(between != "B")) + 1, calls


_FUZZ = textwrap.dedent("""
    import random, sys
    from hypothesis import HealthCheck, given, settings, strategies as st
    from cap4d_torch.data import mp4
    from cap4d_torch.runtime.mpeg4 import Mpeg4Decoder

    t = mp4.read_track(sys.argv[1])
    samples = [t.sample(i) for i in range(len(t))]
    size = (t.width, t.height)

    @settings(max_examples=int(sys.argv[2]), deadline=None, derandomize=True, database=None,
              suppress_health_check=list(HealthCheck))
    @given(st.integers(0, len(samples) - 1), st.integers(0, 2**32 - 1),
           st.sampled_from(["cut", "flip", "both"]))
    def fuzz(k, seed, how):
        rng = random.Random(seed)
        dec = Mpeg4Decoder(t.m4v.dsi)
        for j in range(k):
            dec.decode(samples[j], "", size)
        s = bytearray(samples[k])
        if how != "cut":
            for _ in range(rng.randint(1, 8)):
                i = rng.randrange(len(s) * 8)
                s[i // 8] ^= 1 << (i % 8)
        if how != "flip":
            s = s[:rng.randrange(len(s))]
        try:
            dec.decode(bytes(s), "", size)
        except ValueError:
            pass

    fuzz()
    print("fuzz ok")
""")


@pytest.mark.parametrize("name", ["advanced", "advanced_hpel", "simple"])
def test_corrupt_samples_raise_or_decode_never_crash(writer_streams, name):
    """Truncated and bit-flipped samples (hypothesis, in a subprocess so that
    a crash fails this test instead of killing the worker): each decodes to
    a picture or raises ValueError, never a signal."""
    proc = subprocess.run([sys.executable, "-c", _FUZZ, str(writer_streams[name][0]), "120"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "fuzz ok" in proc.stdout, (proc.returncode,
                                                               proc.stderr[-2000:])


@pytest.mark.parametrize("tool", sorted(mw.REFUSALS))
def test_refusals_name_the_tool(tmp_path, tool):
    """Each refused tool raises ValueError naming the file, the frame (or
    the header) and the tool."""
    path = tmp_path / f"{tool}.mp4"
    phrase = mw.write_mpeg4_refusal_mp4(path, tool)
    with pytest.raises(ValueError) as e:
        reader = VideoFrameReader(path, device="cpu")
        for k in range(len(reader)):
            reader.planes(k)
    msg = str(e.value)
    assert str(path) in msg and phrase in msg, msg
    if tool in ("short_header", "packed"):
        assert "frame" in msg or "sample" in msg, msg


def test_demuxer_keeps_the_decoder_specific_info(writer_streams):
    """esds: object type 0x20 and the DecoderSpecificInfo (VOS, VO, VOL, user
    data) with their start codes."""
    path = writer_streams["xvid_idct"][0]
    t = mp4.read_track(path)
    assert t.codec == "mpeg4" and t.m4v.dsi.startswith(b"\0\0\1\xb0")
    assert b"\0\0\1\x20" in t.m4v.dsi and t.m4v.dsi.endswith(b"XviD0050")
    assert os.path.getsize(path) > len(t.m4v.dsi)
