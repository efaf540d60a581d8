"""The port's VP9 decoder (``cap4d_torch/runtime/vp9.cpp`` through
``runtime/vp9.py`` and ``VideoFrameReader``) against ffmpeg's native
``vp9`` decoder, the one cv2 opens, on streams of libvpx's own encoder
(the library cv2 ships, driven here through ctypes) and of
``cap4d_torch/utils/vp9_writer.py`` (the header-level tools no encoder
setting reaches).

- Planes: ffmpeg's Y, U and V come from cv2's own libavcodec through
  ctypes, fed the samples that the port's demuxers read from the file; the
  port's planes equal them bit for bit, every picture, read in order and
  shuffled. libvpx's own decoder (``vpx_codec_vp9_dx``) is a second
  reference; on these streams it agrees with ffmpeg everywhere.
- RGB: ``VideoFrameReader(path, device="cpu")[k]`` against cap4d_tpu's
  ``load_frame(path, k)`` (cv2's decode and swscale conversion) on every
  frame, in order and shuffled; ``len`` against cv2's frame count.
- Pinned: the SHA-256 of ffmpeg's planes of each stream, kept in
  ``vp9_writer.PINNED_SHA256``, which ``chip_smoke.py`` holds on the card's
  machine (no cv2 or libvpx there).
- The files under ``tests/data/vp9/`` were written by
  :func:`write_vp9_streams` (libvpx v1.15.2 inside cv2 5.0.0, one thread);
  a test writes them again and holds the decode of both to the same pins.
"""

import ctypes
import glob
import subprocess
import sys
import textwrap
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from cap4d_torch.data import avi, container, mkv, mp4
from cap4d_torch.data.utils import VideoFrameReader
from cap4d_torch.runtime import vp9 as rv
from cap4d_torch.runtime.nvdec import MATRICES, nv12_to_rgb
from cap4d_torch.utils import container_writer as cw
from cap4d_torch.utils import mpeg4_writer as mw
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_torch.utils import vp9_writer as vw
from cap4d_tpu.data import utils as ju
from tests.test_torch_containers import ffmpeg_decode
from tests.test_torch_mpeg4 import _libs
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

DATA = Path(__file__).parent / "data" / "vp9"
LIBS = Path(cv2.__file__).parent.parent / "opencv_python.libs"
_P = ctypes.c_void_p


# ----------------------------------------------- libvpx's encoder, via ctypes --

def _vpx():
    lib = ctypes.CDLL(glob.glob(str(LIBS / "libvpx-*.so*"))[0])
    for name, res, args in [
            ("vpx_codec_vp9_cx", _P, []), ("vpx_codec_vp9_dx", _P, []),
            ("vpx_codec_vp8_cx", _P, []), ("vpx_codec_vp8_dx", _P, []),
            ("vpx_codec_enc_config_default", ctypes.c_int, [_P, _P, ctypes.c_uint]),
            ("vpx_codec_enc_init_ver", ctypes.c_int, [_P, _P, _P, ctypes.c_long, ctypes.c_int]),
            ("vpx_codec_dec_init_ver", ctypes.c_int, [_P, _P, _P, ctypes.c_long, ctypes.c_int]),
            ("vpx_codec_encode", ctypes.c_int, [_P, _P, ctypes.c_int64, ctypes.c_ulong,
                                                ctypes.c_long, ctypes.c_ulong]),
            ("vpx_codec_decode", ctypes.c_int, [_P, ctypes.c_char_p, ctypes.c_uint, _P,
                                                ctypes.c_long]),
            ("vpx_codec_get_cx_data", _P, [_P, _P]), ("vpx_codec_get_frame", _P, [_P, _P]),
            ("vpx_codec_destroy", ctypes.c_int, [_P]),
            ("vpx_img_alloc", _P, [_P, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint]),
            ("vpx_img_free", None, [_P]), ("vpx_codec_error_detail", ctypes.c_char_p, [_P])]:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib   # vpx_codec_control_ is variadic: called with explicit ctypes values


VPX_ENCODER_ABI = 37          # libvpx v1.15's VPX_ENCODER_ABI_VERSION
VPX_DECODER_ABI = 12
# vp8e_enc_control_id in libvpx v1.15 (VP9E_SET_ROI_MAP at 40 moves the later ones)
CONTROLS = {"scale_mode": 11, "cpu_used": 13, "auto_alt_ref": 14, "noise_sensitivity": 15,
            "sharpness": 16, "static_threshold": 17, "token_partitions": 18, "arnr_max_frames": 21,
            "arnr_strength": 22, "lossless": 32, "tile_columns": 33, "tile_rows": 34,
            "frame_parallel": 35, "aq_mode": 36, "color_space": 46, "color_range": 51,
            "render_size": 53, "delta_q_uv": 67}
# vpx_codec_enc_cfg_t fields by byte offset (libvpx v1.15, x86-64); g_profile selects
# VP8's version
CFG = {"threads": 4, "profile": 8, "w": 12, "h": 16, "timebase": 28, "error_resilient": 36,
       "pass": 40,
       "lag": 44, "end_usage": 72, "stats_buf": 80, "stats_size": 88, "bitrate": 112,
       "kf_max_dist": 168}
GOOD, REALTIME = 1000000, 1      # vpx_codec_encode deadlines


def content(k, w, h, kind):
    """Frame ``k`` of a content, as I420 (Y, U, V) uint8 planes of any size:
    smooth waves with a moving disc, a drifting texture, or that texture
    with noise (BT.601 limited range)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    if kind == "smooth":
        r = 128 + 80 * np.sin(x / 23 + 0.15 * k) * np.cos(y / 31)
        g = 128 + 60 * np.cos((x + y) / 40 - 0.1 * k)
        b = 100 + 0.4 * x - 0.2 * y
        cx, cy = w / 2 + 0.3 * w * np.cos(0.2 * k), h / 2 + 0.25 * h * np.sin(0.2 * k)
        disc = (x - cx) ** 2 + (y - cy) ** 2 < (0.12 * h) ** 2
        r, g, b = np.where(disc, 230, r), np.where(disc, 200, g), np.where(disc, 40, b)
    else:
        tex = np.random.default_rng(7).integers(30, 226, (h // 8 + 6, w // 8 + 6, 3))
        tex = cv2.resize(tex.astype(np.float32), (w + 24, h + 24), interpolation=cv2.INTER_CUBIC)
        img = tex[(k // 2) % 12:(k // 2) % 12 + h, (3 * k) % 12:(3 * k) % 12 + w]
        if kind == "noisy":
            img = img + np.random.default_rng(k).normal(0, 30, img.shape)
        b, g, r = np.moveaxis(np.clip(img, 0, 255), -1, 0)
    luma = 0.257 * r + 0.504 * g + 0.098 * b + 16
    cb, cr = -0.148 * r - 0.291 * g + 0.439 * b + 128, 0.439 * r - 0.368 * g - 0.071 * b + 128
    ch, cw_ = (h + 1) // 2, (w + 1) // 2
    sub = [np.pad(c, ((0, 2 * ch - h), (0, 2 * cw_ - w)), mode="edge").reshape(ch, 2, cw_, 2)
           .mean((1, 3)) for c in (cb, cr)]
    return [np.clip(np.round(p), 0, 255).astype(np.uint8) for p in [luma] + sub]


def encode(w, h, n, kind="texture", deadline=GOOD, lag=0, cfg=None, controls=None, at=None,
           two_pass=False, codec="vp9"):
    """libvpx's VP9 (or, with ``codec="vp8"``, VP8) encoder, one thread
    (deterministic): [(sample, key)]. ``cfg`` sets config fields
    (:data:`CFG` names), ``controls`` vpx_codec_control_ values (ints, or
    tuples passed as an int array), ``at`` {frame: {control: value}} before
    that frame."""
    args = (w, h, n, kind, deadline, lag, cfg, controls, at, codec)
    if two_pass:
        stats = _encode(*args, 1)
        return _encode(*args, 2, stats)
    return _encode(*args, 0)


def _encode(w, h, n, kind, deadline, lag, cfg, controls, at, codec, pass_, stats=None):
    lib = _vpx()
    iface = getattr(lib, f"vpx_codec_{codec}_cx")()
    conf = (ctypes.c_uint8 * 4096)()
    assert lib.vpx_codec_enc_config_default(iface, conf, 0) == 0
    u32 = np.frombuffer(conf, np.uint32, count=1024)
    fields = {"threads": 1, "w": w, "h": h, "lag": lag, "pass": pass_, **(cfg or {})}
    u32[CFG["timebase"] // 4:CFG["timebase"] // 4 + 2] = (1, 30)
    for key, v in fields.items():
        u32[CFG[key] // 4] = v
    if stats is not None:
        buf = ctypes.create_string_buffer(stats, len(stats))
        ctypes.c_void_p.from_buffer(conf, CFG["stats_buf"]).value = ctypes.addressof(buf)
        ctypes.c_size_t.from_buffer(conf, CFG["stats_size"]).value = len(stats)
    ctx = (ctypes.c_uint8 * 512)()
    assert lib.vpx_codec_enc_init_ver(ctx, iface, conf, 0, VPX_ENCODER_ABI) == 0

    def control(name, value):
        arg = (ctypes.byref((ctypes.c_int * len(value))(*value)) if isinstance(value, tuple)
               else ctypes.c_int(value))
        assert lib.vpx_codec_control_(_P(ctypes.addressof(ctx)), ctypes.c_int(CONTROLS[name]),
                                      arg) == 0, (name, lib.vpx_codec_error_detail(ctx))

    for name, value in (controls or {}).items():
        control(name, value)
    img = lib.vpx_img_alloc(None, 0x102, w, h, 1)           # VPX_IMG_FMT_I420
    planes = (ctypes.c_void_p * 4).from_address(img + 48)
    strides = (ctypes.c_int * 4).from_address(img + 80)
    out, stat = [], []

    def drain():
        it = ctypes.c_void_p(0)
        while True:
            p = lib.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
            if not p:
                return
            kind_ = ctypes.c_int.from_address(p).value
            data = ctypes.string_at(ctypes.c_void_p.from_address(p + 8).value,
                                    ctypes.c_size_t.from_address(p + 16).value)
            if kind_ == 0:        # VPX_CODEC_CX_FRAME_PKT; flags bit 0 VPX_FRAME_IS_KEY
                out.append((data, bool(ctypes.c_uint32.from_address(p + 40).value & 1)))
            elif kind_ == 1:      # VPX_CODEC_STATS_PKT
                stat.append(data)

    try:
        for k in range(n):
            for name, value in (at or {}).get(k, {}).items():
                control(name, value)
            for i, p in enumerate(content(k, w, h, kind)):
                for j in range(p.shape[0]):
                    ctypes.memmove(planes[i] + j * strides[i], p[j].ctypes.data, p.shape[1])
            assert lib.vpx_codec_encode(ctx, img, k, 1, 0, deadline) == 0
            drain()
        while True:
            before = len(out) + len(stat)
            assert lib.vpx_codec_encode(ctx, None, -1, 1, 0, deadline) == 0
            drain()
            if len(out) + len(stat) == before:
                break
    finally:
        lib.vpx_img_free(img)
        lib.vpx_codec_destroy(ctx)
    return b"".join(stat) if pass_ == 1 else out


# name -> (width, height, frames, encode's keywords): libvpx's settings of each tool.
# libvpx's default is frame-parallel mode (no backward adaptation): the streams
# that should adapt turn it off
STREAMS = {
    "good_altref": (176, 144, 30, dict(kind="smooth", lag=16, two_pass=True, controls={
        "auto_alt_ref": 1, "cpu_used": 1, "frame_parallel": 0})),
    "rt_cyclic": (176, 144, 16, dict(deadline=REALTIME, cfg={"end_usage": 1, "bitrate": 300},
                                     controls={"cpu_used": 8, "aq_mode": 3, "frame_parallel": 0})),
    "tiles": (528, 128, 6, dict(controls={"tile_columns": 1, "tile_rows": 1, "cpu_used": 4,
                                          "frame_parallel": 0})),
    "lossless": (96, 64, 4, dict(kind="noisy", controls={"lossless": 1, "cpu_used": 4,
                                                          "frame_parallel": 0})),
    "aq_variance": (176, 144, 8, dict(kind="noisy", controls={"aq_mode": 1, "cpu_used": 4,
                                                              "delta_q_uv": -8,
                                                              "frame_parallel": 0})),
    "resilient": (176, 144, 10, dict(cfg={"error_resilient": 1}, controls={
        "frame_parallel": 1, "sharpness": 7, "cpu_used": 2})),
    "resize": (176, 144, 20, dict(controls={"cpu_used": 2, "frame_parallel": 0}, at={
        4: {"scale_mode": (1, 1)}, 8: {"scale_mode": (3, 3)}, 12: {"scale_mode": (2, 0)},
        16: {"scale_mode": (0, 0)}})),
    "odd": (99, 57, 6, dict(controls={"cpu_used": 4, "render_size": (80, 50)})),
    **{f"color{cs}{rng}": (64, 48, 2, dict(controls={"cpu_used": 4, "color_space": cs,
                                                      "color_range": rng}))
       for cs in range(1, 7) for rng in (0, 1)},
    "writer": (192, 128, 0, {}),
    # the card's timed load: 1080x1920 (portrait), a key frame every 4
    "load_1080": (1080, 1920, 16, dict(kind="smooth", deadline=REALTIME, cfg={
        "end_usage": 1, "bitrate": 1200, "kf_max_dist": 4}, controls={"cpu_used": 8})),
}
MP4_ONLY = {"load_1080"}       # (the size budget of tests/data)


def stream_samples(name):
    """(samples, sync flags) of :data:`STREAMS`' ``name``."""
    w, h, n, kw = STREAMS[name]
    if name == "writer":
        key = encode(w, h, 1, controls={"cpu_used": 4})[0][0]
        return vw.tools_stream(key, w, h)
    pk = encode(w, h, n, **kw)
    return [p for p, _ in pk], [k for _, k in pk]


def write_vp9_streams(out_dir, names=None) -> dict:
    """Encode :data:`STREAMS` and mux each into mp4 (``vp09`` with a vpcC)
    and WebM; {file name: path}."""
    out = {}
    for name in names or STREAMS:
        w, h, _, kw = STREAMS[name]
        samples, sync = stream_samples(name)
        full = bool(kw.get("controls", {}).get("color_range"))
        path = Path(out_dir) / f"{name}.mp4"
        sa.write_mp4(path, samples, sa.visual_sample_entry(b"vp09", w, h, vw.vpcc_box(full)), w, h,
                     sync=sync)
        out[path.name] = path
        if name not in MP4_ONLY:
            path = Path(out_dir) / f"{name}.webm"
            cw.write_mkv(path, cw.Stream("vp9", w, h, samples, sync, list(range(len(samples)))),
                         doc_type="webm")
            out[path.name] = path
    return out


# ----------------------------------------------- ffmpeg's and libvpx's planes --

AV_CODEC_ID_VP9 = 167


def ffmpeg_planes(samples):
    """ffmpeg's (Y, U, V) of every picture its native ``vp9`` decoder
    outputs for ``samples`` (one thread; tests/test_torch_containers.py's
    ``ffmpeg_decode``)."""
    return ffmpeg_decode("vp9", samples)


def libvpx_planes(samples, codec="vp9"):
    """libvpx's own decoder's (Y, U, V) of every picture (vpx_image_t's
    planes, strides and d_w/d_h at 48, 80 and 24/28)."""
    lib = _vpx()
    ctx = (ctypes.c_uint8 * 512)()
    cfg = (ctypes.c_uint32 * 8)(1)                          # threads 1
    iface = getattr(lib, f"vpx_codec_{codec}_dx")()
    assert lib.vpx_codec_dec_init_ver(ctx, iface, cfg, 0, VPX_DECODER_ABI) == 0
    out = []
    try:
        for s in samples:
            assert lib.vpx_codec_decode(ctx, s, len(s), None, 0) == 0
            it = ctypes.c_void_p(0)
            while True:
                img = lib.vpx_codec_get_frame(ctx, ctypes.byref(it))
                if not img:
                    break
                data = (ctypes.c_void_p * 4).from_address(img + 48)
                stride = (ctypes.c_int * 4).from_address(img + 80)
                w, h = (ctypes.c_uint.from_address(img + off).value for off in (24, 28))
                planes = []
                for i, (pw, ph) in enumerate([(w, h)] + [((w + 1) // 2, (h + 1) // 2)] * 2):
                    buf = (ctypes.c_uint8 * (stride[i] * ph)).from_address(data[i])
                    plane = np.frombuffer(buf, np.uint8).reshape(ph, stride[i])
                    planes.append(plane[:, :pw].copy())
                out.append(tuple(planes))
    finally:
        lib.vpx_codec_destroy(ctx)
    return out


def file_samples(path):
    t = container.read_track(path)
    return [t.sample(i) for i in range(len(t))]


planes_sha256 = mw.planes_sha256


# ------------------------------------------------------------------ files --

FILES = sorted(p.name for p in DATA.glob("*.*"))


def _stream_of(file_name):
    return file_name.rsplit(".", 1)[0]


@pytest.fixture(scope="module")
def refs():
    """{file name: ffmpeg's planes} of the committed files."""
    return {f: ffmpeg_planes(file_samples(DATA / f)) for f in FILES}


def _port_planes(path, order=None):
    reader = VideoFrameReader(path, device="cpu")
    n = len(reader._order)
    got = {}
    for k in (range(n) if order is None else order):
        got[int(k)] = reader.planes(int(k))
    return [got[k] for k in range(n)], reader


def _assert_planes_equal(port, ref, what):
    assert len(port) == len(ref), f"{what}: {len(port)} pictures, ffmpeg {len(ref)}"
    for k, (a, b) in enumerate(zip(port, ref)):
        for name, p, q in zip("YUV", a, b):
            assert p.shape == q.shape, f"{what} picture {k} {name}: {p.shape} vs {q.shape}"
            np.testing.assert_array_equal(p, q, err_msg=f"{what} picture {k} plane {name}")


def test_committed_files_and_budget():
    """Every stream is committed in mp4 and WebM (the 1080x1920 load in mp4
    only), pinned, and the files fit in 1 MB together."""
    want = sorted([f"{n}.mp4" for n in STREAMS]
                  + [f"{n}.webm" for n in STREAMS if n not in MP4_ONLY])
    assert FILES == want
    assert set(vw.PINNED_SHA256) == set(STREAMS)
    assert sum((DATA / f).stat().st_size for f in FILES) <= 1_000_000


@pytest.mark.parametrize("file_name", FILES)
def test_planes_bit_for_bit_and_pinned(refs, file_name):
    """Every picture's Y, U and V equal ffmpeg's, read in order and
    shuffled; ffmpeg's and the port's hash to the pin; libvpx's own decoder
    gives the same pictures."""
    path, ref = DATA / file_name, refs[file_name]
    name = _stream_of(file_name)
    n, pin = vw.PINNED_SHA256[name]
    assert (len(ref), planes_sha256(ref)) == (n, pin)
    port, reader = _port_planes(path)
    _assert_planes_equal(port, ref, file_name)
    if name != "load_1080":
        order = np.random.default_rng(5).permutation(len(ref))
        _assert_planes_equal(_port_planes(path, order)[0], ref, f"{file_name} shuffled")
        assert planes_sha256(libvpx_planes(file_samples(path))) == pin
    t = reader.track
    assert (t.codec, t.fourcc) == ("vp9", "vp09" if file_name.endswith(".mp4") else "V_VP9")


# Streams whose RGB the port does not give as cv2 does (ROADMAP, "Measured
# parity gaps"): the reserved colour space 6 swscale refuses, and cv2
# returns its output buffer as it stands (black, or bytes of an earlier
# conversion). An odd frame height and frames coded at another size than
# the stream's take swscale's generic scaler, which runtime/nvdec.py copies
# (swscale_bicubic): those are exact, in test_rgb_matches_cap4d_tpu
RGB_GAPS = {"color60", "color61"}


@pytest.mark.parametrize("file_name", [f for f in FILES if not f.startswith("load_1080")
                                       and _stream_of(f) not in RGB_GAPS])
def test_rgb_matches_cap4d_tpu(file_name):
    """len is cv2's frame count; every frame's RGB equals cap4d_tpu's
    load_frame (cv2's decode and conversion: swscale's scaler for the odd
    height of ``odd`` and the frames ``resize`` codes at other sizes), read
    in order and shuffled; past the pictures both raise IndexError."""
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


@pytest.mark.parametrize("file_name", [f for f in FILES if _stream_of(f) in RGB_GAPS])
def test_rgb_parity_gaps(file_name):
    """The reserved colour space converts as BT.601 where cv2 converts
    nothing; the port's RGB has cv2's length and shapes. The planes are
    exact (test_planes_bit_for_bit_and_pinned)."""
    path = DATA / file_name
    reader = VideoFrameReader(path, device="cpu")
    assert len(reader) == int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))
    for k in range(len(reader)):
        got, want = reader[k], ju.load_frame(path, k)
        assert got.shape == want.shape, k
        y, u, v = (torch.from_numpy(p) for p in reader.planes(k))
        uv = torch.stack([u, v], -1)
        np.testing.assert_array_equal(got, nv12_to_rgb(y, uv, "bt601", reader._vp9.full_range))
        assert not any(np.array_equal(want, nv12_to_rgb(y, uv, m, r))
                       for m in MATRICES for r in (False, True)), "cv2 converted colour space 6"


def test_load_1080_rgb_matches_cv2():
    """The 1080x1920 load: each frame's RGB equals cv2's sequential read and,
    at two frames read at random, cap4d_tpu's load_frame."""
    path = DATA / "load_1080.mp4"
    reader = VideoFrameReader(path, device="cpu")
    cap = cv2.VideoCapture(str(path))
    assert len(reader) == int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 16
    for k in range(len(reader)):
        ok, bgr = cap.read()
        assert ok
        np.testing.assert_array_equal(reader[k], bgr[..., ::-1], err_msg=f"frame {k}")
    for k in (13, 6):
        np.testing.assert_array_equal(reader[k], ju.load_frame(path, k), err_msg=f"frame {k}")


def test_ffmpeg_opens_its_native_decoder():
    """The decoder ffmpeg (and so cv2) opens for AV_CODEC_ID_VP9 is its native
    ``vp9``, the one ffmpeg_planes names, not ``libvpx-vp9``."""
    _, avcodec = _libs()
    avcodec.avcodec_find_decoder.restype = _P
    avcodec.avcodec_find_decoder.argtypes = [ctypes.c_int]
    codec = avcodec.avcodec_find_decoder(AV_CODEC_ID_VP9)
    assert ctypes.c_char_p.from_address(codec).value == b"vp9"


def test_streams_written_again(refs, tmp_path):
    """libvpx (one thread) and the writer write the same pictures again: the
    files from write_vp9_streams decode to the pins (the port's decode)."""
    again = write_vp9_streams(tmp_path, [n for n in STREAMS if n != "load_1080"])
    for file_name, path in again.items():
        n, pin = vw.PINNED_SHA256[_stream_of(file_name)]
        port = _port_planes(path)[0]
        assert (len(port), planes_sha256(port)) == (n, pin), file_name


# which stream reaches each decoder tool (runtime/vp9.py's TOOLS)
TOOL_STREAMS = {
    "key_frame": "good_altref", "inter_frame": "good_altref", "intra_only": "writer",
    "hidden_frame": "good_altref", "show_existing_frame": "writer", "superframe": "good_altref",
    "error_resilient": "resilient", "frame_parallel": "odd",
    "refresh_frame_context": "good_altref", "reset_frame_context_0": "writer",
    "reset_frame_context_1": "writer", "reset_frame_context_2": "writer",
    "reset_frame_context_3": "writer", "frame_context_idx": "good_altref",
    "refresh_partial": "good_altref", "refresh_none": "writer", "size_change": "resize",
    "odd_size": "odd", "render_size": "odd", "scaled_reference": "resize",
    "color_space": "color21", "full_range": "color11", "lossless": "lossless",
    "tx_mode_select": "good_altref", "tx_4x4": "good_altref", "tx_8x8": "good_altref",
    "tx_16x16": "good_altref", "tx_32x32": "good_altref", "adst": "good_altref",
    "wht": "lossless", "compound": "good_altref", "reference_select": "good_altref",
    "switchable_interp": "good_altref", "filter_regular": "good_altref",
    "filter_smooth": "good_altref", "filter_sharp": "tiles", "filter_bilinear": "writer",
    "high_precision_mv": "good_altref", "prev_frame_mvs": "good_altref",
    "sub8x8_intra": "good_altref", "sub8x8_inter": "good_altref", "nearestmv": "good_altref",
    "nearmv": "good_altref", "zeromv": "good_altref", "newmv": "good_altref",
    "intra_in_inter": "good_altref", "segmentation": "rt_cyclic", "seg_temporal": "rt_cyclic",
    "seg_alt_q": "rt_cyclic", "seg_alt_lf": "writer", "seg_ref_frame": "writer",
    "seg_skip": "writer", "seg_abs_delta": "writer", "lf_delta_update": "good_altref",
    "lf_sharpness": "writer", "lf_16": "good_altref", "tile_columns": "tiles",
    "tile_rows": "tiles", "delta_q": "aq_variance", "probability_updates": "good_altref",
    "mv_updates": "good_altref", "coef_cat6": "good_altref", "adaptation": "good_altref",
}


def test_streams_cover_the_tools():
    """Every tool of the decoder (the bits vp9.cpp sets as it decodes) is
    reached by the stream TOOL_STREAMS names for it, a stream held to ffmpeg
    above; the decoder has no tool that no stream reaches (what it does not
    take, it refuses by name: test_refusals_name_the_tool)."""
    assert set(TOOL_STREAMS) == set(rv.TOOLS)
    used = {}
    for name in set(TOOL_STREAMS.values()):
        dec = rv.Vp9Decoder(name)
        for s in file_samples(DATA / f"{name}.mp4"):
            dec.decode(s)
        used[name] = dec.tools
    missing = [t for t, name in TOOL_STREAMS.items() if t not in used[name]]
    assert not missing, missing


def _count_decodes(reader):
    """The reader's decode calls, counted: a list whose first item is the count."""
    calls, decode = [0], reader._vp9.decode

    def counted(*args):
        calls[0] += 1
        return decode(*args)

    reader._vp9.decode = counted
    return calls


@pytest.mark.parametrize("file_name", ["good_altref.mp4", "writer.webm", "load_1080.mp4"])
def test_reads_decode_each_sample_once(file_name):
    """A sequential read decodes each sample once (a superframe's hidden
    frames with the picture they precede, a hidden-only sample on the way to
    the next picture); a random read decodes from the key frame at or
    before its sample, no further back."""
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
    assert t.sync.sum() == (4 if file_name.startswith("load") else 1)


_FUZZ = textwrap.dedent("""
    import random, sys
    from hypothesis import HealthCheck, given, settings, strategies as st
    from cap4d_torch.data import container
    from cap4d_torch.runtime.vp9 import Vp9Decoder

    t = container.read_track(sys.argv[1])
    samples = [t.sample(i) for i in range(len(t))]

    @settings(max_examples=int(sys.argv[2]), deadline=None, derandomize=True, database=None,
              suppress_health_check=list(HealthCheck))
    @given(st.integers(0, len(samples) - 1), st.integers(0, 2**32 - 1),
           st.sampled_from(["cut", "flip", "both", "bytes"]))
    def fuzz(k, seed, how):
        rng = random.Random(seed)
        dec = Vp9Decoder()
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


@pytest.mark.parametrize("name", ["good_altref", "tiles", "writer", "resize"])
def test_corrupt_samples_raise_or_decode_never_crash(name):
    """Truncated, bit-flipped and overwritten samples (hypothesis, in a
    subprocess so that a crash fails this test instead of killing the
    worker), and the samples after them: each decodes or raises ValueError,
    never a signal."""
    proc = subprocess.run([sys.executable, "-c", _FUZZ, str(DATA / f"{name}.webm"), "60"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "fuzz ok" in proc.stdout, (proc.returncode,
                                                               proc.stderr[-2000:])


def _profile_key_frame(profile: int) -> bytes:
    """The first bytes of a key frame of ``profile`` (frame_marker, profile
    bits, show_existing_frame 0, frame_type 0, ...)."""
    lo, hi = profile & 1, profile >> 1
    bits = [1, 0, lo, hi] + ([0] if profile == 3 else []) + [0, 0, 1, 0]
    bits += [int(b) for b in f"{0x498342:024b}"] + [0] * 64
    bits += [0] * (-len(bits) % 8)
    return np.packbits(np.array(bits, np.uint8)).tobytes()


@pytest.mark.parametrize("profile,phrase", [(1, "8-bit 4:2:2, 4:4:0 or 4:4:4"),
                                            (2, "10- or 12-bit 4:2:0"),
                                            (3, "10- or 12-bit 4:2:2, 4:4:0 or 4:4:4")])
def test_refusals_name_the_tool(tmp_path, profile, phrase):
    """Profiles 1-3 (4:4:4 and the other chroma formats, 10- and 12-bit)
    raise ValueError naming the profile, the file and the frame, on every
    device (no NVDEC fallback); a vpcC that names them is refused by the
    demuxer; a stream that starts with an inter frame names it."""
    sample = _profile_key_frame(profile)
    with pytest.raises(ValueError, match=f"VP9 profile {profile} \\({phrase}\\)"):
        rv.Vp9Decoder().decode(sample)
    path = tmp_path / f"p{profile}.webm"
    cw.write_mkv(path, cw.Stream("vp9", 64, 48, [sample], [True], [0]), doc_type="webm")
    with pytest.raises(ValueError) as e:
        VideoFrameReader(path, device="cpu")[0]
    assert str(path) in str(e.value) and f"VP9 profile {profile} ({phrase})" in str(e.value)
    assert "sample 0" in str(e.value), e.value
    bit_depth, sub = (10, 1) if profile == 2 else (8, 3)
    entry = sa.visual_sample_entry(b"vp09", 64, 48, sa._full_box(
        b"vpcC", 1, 0, bytes([profile, 10, (bit_depth << 4) | (sub << 1), 2, 2, 2, 0, 0])))
    sa.write_mp4(tmp_path / "p.mp4", [sample], entry, 64, 48)
    with pytest.raises(ValueError, match=f"VP9 profile {profile}, {bit_depth}-bit "
                                         f"{'4:2:0' if sub == 1 else '4:4:4'} \\(vpcC\\)"):
        mp4.read_track(tmp_path / "p.mp4")
    inter = bytes([0x86]) + b"\0" * 16
    with pytest.raises(ValueError, match="before the first key frame"):
        rv.Vp9Decoder().decode(inter)


def _split_superframe(sample: bytes):
    """The frames of a sample (Annex B's index at its end)."""
    marker = sample[-1]
    if marker & 0xE0 != 0xC0:
        return [sample]
    n, mag = (marker & 7) + 1, ((marker >> 3) & 3) + 1
    index = sample[len(sample) - 2 - mag * n:]
    sizes = [int.from_bytes(index[1 + mag * i:1 + mag * (i + 1)], "little") for i in range(n)]
    return [sample[sum(sizes[:i]):sum(sizes[:i + 1])] for i in range(n)]


def test_hidden_sample_is_no_frame(tmp_path):
    """A sample that holds only a hidden frame (the first superframe's
    alt-ref, split from the frame it precedes): cv2 counts the samples but
    reads one frame fewer, frame k being the k-th picture, as the port's
    reader does; an AVI (VP90) of the same samples reads the same."""
    t = mp4.read_track(DATA / "good_altref.mp4")
    samples = file_samples(DATA / "good_altref.mp4")
    first = next(j for j, s in enumerate(samples) if len(_split_superframe(s)) > 1)
    frames = _split_superframe(samples[first])
    assert [rv.scan(f).shows for f in frames] == [False, True]
    split = samples[:first] + frames + samples[first + 1:]
    keys = list(t.sync[:first]) + [False, False] + list(t.sync[first + 1:])
    path = tmp_path / "hidden.mp4"
    sa.write_mp4(path, split, sa.visual_sample_entry(b"vp09", 176, 144, vw.vpcc_box()), 176, 144,
                 sync=keys)
    cap = cv2.VideoCapture(str(path))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(split) == len(samples) + 1
    reads = 0
    while cap.read()[0]:
        reads += 1
    assert reads == len(samples)
    reader = VideoFrameReader(path, device="cpu")
    assert len(reader) == len(split) and len(reader._order) == len(samples)
    shuffled = list(np.random.default_rng(8).permutation(len(samples))[:6])
    for k in [first - 1, first, first + 1] + shuffled:
        np.testing.assert_array_equal(reader[int(k)], ju.load_frame(path, int(k)),
                                      err_msg=f"frame {k}")
    with pytest.raises(IndexError):
        ju.load_frame(path, len(samples))
    with pytest.raises(IndexError, match="only hidden frames"):
        reader[len(samples)]
    avi_path = tmp_path / "hidden.avi"
    cw.write_avi(avi_path, cw.Stream("vp9", 176, 144, split, keys, list(range(len(split)))))
    a = avi.read_track(avi_path)
    assert (a.codec, a.fourcc, a.frame_count) == ("vp9", "VP90", len(split))
    assert list(a.sync) == [avi.vp9_key(s) for s in split]
    reader = VideoFrameReader(avi_path, device="cpu")
    for k in (0, first, len(samples) - 1):
        np.testing.assert_array_equal(reader[k], ju.load_frame(avi_path, k),
                                      err_msg=f"AVI frame {k}")


def test_scan_reads_headers_only():
    """The header scan of each sample of the writer's stream: frame counts,
    key frames, shown pictures, intra-only frames and refresh flags."""
    scans = [rv.scan(s) for s in file_samples(DATA / "writer.mp4")]
    assert [s.frames for s in scans] == [1, 2, 1, 1, 2, 3, 1, 1, 1, 1, 1, 1, 1]
    assert [s.key for s in scans] == [True] + [False] * 12
    assert [s.shows for s in scans] == [True] * 7 + [False] + [True] * 5
    assert [s.intra_only for s in scans] == [False, True, False, False, True, True] + [False] * 7
    assert scans[0].refresh == 0xFF and scans[2].refresh == 0 and scans[3].refresh == 0
    with pytest.raises(ValueError, match="frame marker"):
        rv.scan(b"\x00\x01")
