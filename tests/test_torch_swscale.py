"""The port's copy of swscale's conversions (``cap4d_torch/runtime/nvdec.py``:
``swscale_bicubic``, ``yuv_to_rgb``) and of ffmpeg's Motion-JPEG planes
(``runtime/loader.py``'s ``decode_jpeg_planes``) against the libraries cv2
runs, driven through ctypes: libswscale 9.5 (``sws_getContext(w, h,
yuv4xxp, W, H, BGR24, SWS_BICUBIC)`` with the matrix and range set by
``sws_setColorspaceDetails``) and libavcodec's ``mjpeg`` decoder.

- Seeded random planes, odd and even widths and heights, enlarged and
  shrunk at several ratios, under every matrix and both ranges, and the
  other chroma layouts a Motion-JPEG frame may have: the port's RGB equals
  ``sws_scale``'s byte for byte (no tolerance).
- Files at an odd size (Motion-JPEG, and libvpx's VP8 and VP9
  ``odd.webm``): every frame equals cap4d_tpu's ``load_frame`` (cv2).
  H.264 has no such file: 4:2:0 H.264 crops in units of two samples, so
  its pictures are of even size.
- Motion-JPEG in every sampling layout cv2's encoder writes, at even and
  odd sizes: ``load_frame`` equals cap4d_tpu's.
"""

import ctypes
import glob
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from cap4d_torch.data import container, mkv
from cap4d_torch.data.utils import VideoFrameReader, load_frame
from cap4d_torch.runtime import loader as tl
from cap4d_torch.runtime.nvdec import (CHROMA_POSITIONS, MATRICES, swscale_bicubic, sws_filter,
                                        yuv_to_rgb)
from cap4d_torch.utils import container_writer as cw
from cap4d_torch.utils import mpeg4_writer as mw
from cap4d_tpu.data import utils as ju
from tests.test_torch_containers import ffmpeg_decode
from tests.test_torch_mpeg4 import _content
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)
from tests.test_torch_video import _frames

LIBS = Path(cv2.__file__).parent.parent / "opencv_python.libs"
SWS_BICUBIC = 4
# nv12_to_rgb's matrices as swscale's SWS_CS_* numbers
SWS_CS = {"bt709": 1, "fcc": 4, "bt601": 5, "smpte240m": 7, "bt2020": 9}
# chroma layouts: pixel format -> (horizontal, vertical) subsampling shift
LAYOUTS = {"yuv420p": (1, 1), "yuv422p": (1, 0), "yuv444p": (0, 0), "yuv440p": (0, 1),
           "yuv411p": (2, 0)}


def _sws():
    avutil = ctypes.CDLL(glob.glob(str(LIBS / "libavutil-*.so*"))[0])
    sws = ctypes.CDLL(glob.glob(str(LIBS / "libswscale-*.so*"))[0])
    avutil.av_get_pix_fmt.restype = ctypes.c_int
    avutil.av_get_pix_fmt.argtypes = [ctypes.c_char_p]
    sws.sws_getContext.restype = ctypes.c_void_p
    sws.sws_getContext.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    sws.sws_scale.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    sws.sws_freeContext.argtypes = [ctypes.c_void_p]
    sws.sws_getCoefficients.restype = ctypes.c_void_p
    sws.sws_getCoefficients.argtypes = [ctypes.c_int]
    sws.sws_setColorspaceDetails.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_void_p] + [ctypes.c_int] * 4
    sws.sws_alloc_context.restype = ctypes.c_void_p
    sws.sws_init_context.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    avutil.av_opt_set_int.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int]
    return avutil, sws


def sws_scale(planes, fmt, width, height, matrix="bt601", full_range=False, chroma_pos=None):
    """libswscale's RGB (height, width, 3) of Y, U and V ``planes`` in pixel
    format ``fmt`` through SWS_BICUBIC to BGR24, as cv2 converts a frame;
    ``chroma_pos`` sets src_h_chr_pos and src_v_chr_pos (a context built by
    sws_alloc_context and sws_init_context, as cv2 builds it)."""
    avutil, sws = _sws()
    h, w = planes[0].shape
    src, dst = avutil.av_get_pix_fmt(fmt.encode()), avutil.av_get_pix_fmt(b"bgr24")
    if chroma_pos is None:
        ctx = sws.sws_getContext(w, h, src, width, height, dst, SWS_BICUBIC, None, None, None)
    else:
        ctx = sws.sws_alloc_context()
        for key, value in (("srcw", w), ("srch", h), ("src_format", src), ("dstw", width),
                           ("dsth", height), ("dst_format", dst), ("sws_flags", SWS_BICUBIC),
                           ("src_h_chr_pos", chroma_pos[0]), ("src_v_chr_pos", chroma_pos[1])):
            assert avutil.av_opt_set_int(ctypes.c_void_p(ctx), key.encode(), value, 0) >= 0, key
        assert sws.sws_init_context(ctypes.c_void_p(ctx), None, None) >= 0
    assert ctx
    try:
        table = sws.sws_getCoefficients(SWS_CS[matrix])
        assert sws.sws_setColorspaceDetails(ctx, table, int(full_range), table, 1, 0, 1 << 16,
                                            1 << 16) >= 0
        src = [np.ascontiguousarray(p) for p in planes]
        out = np.zeros((height, width * 3 + 64), np.uint8)
        assert sws.sws_scale(ctx, (ctypes.c_void_p * 4)(*[p.ctypes.data for p in src]),
                             (ctypes.c_int * 4)(*[p.strides[0] for p in src]), 0, h,
                             (ctypes.c_void_p * 4)(out.ctypes.data),
                             (ctypes.c_int * 4)(out.strides[0])) == height
    finally:
        sws.sws_freeContext(ctx)
    return out[:, :width * 3].reshape(height, width, 3)[..., ::-1]


def _planes(h, w, fmt, seed):
    rng = np.random.default_rng(seed)
    sh, sv = LAYOUTS[fmt]
    return [rng.integers(0, 256, (h, w), dtype=np.uint8)] + [
        rng.integers(0, 256, (-(-h >> sv), -(-w >> sh)), dtype=np.uint8) for _ in range(2)]


# (source height, width) -> (output height, width): the unscaled generic path
# (odd heights), odd widths (full horizontal chroma interpolation), enlarging
# and shrinking at several ratios, a portrait frame
SIZES = [((57, 99), (57, 99)), ((57, 98), (57, 98)), ((99, 57), (99, 57)),
         ((33, 40), (33, 40)), ((72, 88), (144, 176)), ((48, 64), (57, 99)),
         ((144, 176), (72, 88)), ((144, 176), (96, 128)), ((96, 120), (144, 176)),
         ((60, 44), (37, 23)), ((120, 60), (40, 180)), ((17, 30), (41, 11))]
CASES = [(src, dst, m, r) for i, (src, dst) in enumerate(SIZES)
         for m, r in [(list(MATRICES)[(i + j) % 5], bool((i + j) % 2)) for j in range(2)]]


@pytest.mark.parametrize("src,dst,matrix,full_range", CASES)
def test_scaler_matches_sws_scale(src, dst, matrix, full_range):
    """4:2:0 planes through swscale_bicubic and through libswscale: the same
    bytes, whatever the sizes, the matrix and the range."""
    planes = _planes(*src, "yuv420p", hash((src, dst)) % 1000)
    want = sws_scale(planes, "yuv420p", dst[1], dst[0], matrix, full_range)
    got = swscale_bicubic(*(torch.from_numpy(p) for p in planes), *dst, matrix, full_range)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("location", ["left", "topleft", "top", "center"])
@pytest.mark.parametrize("src,dst,fmt", [((57, 99), (57, 99), "yuv420p"),
                                         ((57, 98), (57, 98), "yuv420p"),
                                         ((48, 64), (57, 99), "yuv420p"),
                                         ((99, 57), (66, 40), "yuv420p"),
                                         ((57, 99), (57, 99), "yuv422p")])
def test_scaler_chroma_siting_matches_sws_scale(src, dst, fmt, location):
    """A source chroma position (ffmpeg's chroma locations, as cv2 hands a
    frame's to swscale) through swscale_bicubic and through libswscale: the
    same bytes."""
    planes = _planes(*src, fmt, hash((src, dst, location)) % 1000)
    pos = CHROMA_POSITIONS[location]
    want = sws_scale(planes, fmt, dst[1], dst[0], "bt601", False, pos)
    got = swscale_bicubic(*(torch.from_numpy(p) for p in planes), *dst, "bt601", False, pos)
    np.testing.assert_array_equal(got, want)
    if location == "left":       # the default siting gives other bytes
        assert not np.array_equal(swscale_bicubic(*(torch.from_numpy(p) for p in planes), *dst),
                                  want)


@pytest.mark.parametrize("fmt", list(LAYOUTS))
@pytest.mark.parametrize("src,dst", [((57, 98), (57, 98)), ((56, 99), (56, 99)),
                                     ((56, 98), (56, 98)), ((40, 64), (60, 90))])
def test_yuv_to_rgb_matches_sws_scale_for_every_layout(fmt, src, dst):
    """yuv_to_rgb, which picks the unscaled converter (4:2:0 and 4:2:2 at the
    output size with an even height) or the scaler (the rest, 4:4:4 with full
    chroma interpolation forced), equals libswscale on every layout."""
    planes = _planes(*src, fmt, 7)
    want = sws_scale(planes, fmt, dst[1], dst[0])
    got = yuv_to_rgb(*(torch.from_numpy(p) for p in planes), *dst)
    np.testing.assert_array_equal(got, want)


def test_filters_and_refusals():
    """The bicubic filters sum to one (2^14 across, 2^12 down) and stay
    inside the source; the identity where nothing scales; two-tap vertical
    filters (pictures of at most 8 rows, scaled) raise."""
    for src, dst in ((99, 57), (57, 99), (40, 200), (33, 33)):
        taps, pos = sws_filter(src, dst, 1 << 14, 4, 128, 128)
        assert (taps.sum(1) == 1 << 14).all()
        assert (pos >= 0).all() and (pos + (taps != 0).sum(1) <= src).all()
    taps, pos = sws_filter(57, 57, 1 << 12, 2, 128, 128)
    assert taps.shape == (57, 1) and (pos == np.arange(57)).all()
    y, u, v = (torch.from_numpy(p) for p in _planes(8, 16, "yuv420p", 1))
    with pytest.raises(ValueError, match="two-tap vertical"):
        swscale_bicubic(y, u, v, 9, 16)
    with pytest.raises(ValueError, match="do not fit"):
        swscale_bicubic(y, u[:-1], v, 8, 16)


@pytest.mark.parametrize("kind,width", [("mjpeg", 99), ("vp8", 99), ("vp9", 99), ("mpeg4", 99),
                                        ("mpeg4", 97)])
def test_odd_size_files_match_cv2(tmp_path, kind, width):
    """A 99x57 file of each codec (cv2's writers round odd sizes down, so
    Motion-JPEG samples cv2 encodes go into the port's AVI writer; VP8 and
    VP9 are libvpx's; MPEG-4 Part 2 the writer's, at 97x57 too, converted
    with the left chroma siting ffmpeg's mpeg4 decoder gives its pictures):
    every frame, in order and shuffled, equals cap4d_tpu's load_frame (cv2
    sends each through swscale's scaler); the MPEG-4 frames hash to the pin
    chip_smoke.py holds on the card."""
    if kind == "mjpeg":
        jpegs = [cv2.imencode(".jpg", _content("smooth", k, 99, 57))[1].tobytes() for k in range(6)]
        path = tmp_path / "odd.avi"
        cw.write_avi(path, cw.Stream("mjpeg", 99, 57, jpegs, [True] * 6, list(range(6))))
    elif kind == "mpeg4":
        path = tmp_path / "odd.mp4"
        mw.write_mpeg4_syntax_mp4(path, width, 57, **mw.ODD_STREAM)
    else:
        path = Path(__file__).parent / "data" / kind / "odd.webm"
    reader = VideoFrameReader(path, device="cpu")
    assert (reader.track.codec, reader.track.width, reader.track.height) == (kind, width, 57)
    n = len(reader)
    for k in list(range(n)) + [int(k) for k in np.random.default_rng(4).permutation(n)]:
        np.testing.assert_array_equal(reader[k], ju.load_frame(path, k), err_msg=f"frame {k}")
    if kind == "mpeg4":
        frames = [reader[k] for k in range(n)]
        assert (n, cw.rgb_sha256(frames)) == mw.PINNED_ODD_RGB_SHA256[width, 57]


@pytest.mark.parametrize("siting", [None, (1, 2), (2, 2), (1, 1), (2, 1), (0, 2), (1, 0)])
@pytest.mark.parametrize("kind", ["vp8", "vp9"])
def test_matroska_chroma_siting_matches_cv2(tmp_path, kind, siting):
    """The odd-sized VP8 and VP9 WebM again with a Colour element's
    ChromaSitingHorz/Vert (left, centre, top-left, top, and each with one
    of the two unspecified): cv2 converts with the siting ffmpeg gives the
    stream, and so does the port, frame for frame."""
    t = container.read_track(Path(__file__).parent / "data" / kind / "odd.webm")
    s = cw.Stream(kind, t.width, t.height, [t.sample(i) for i in range(len(t))],
                  [bool(x) for x in t.sync], [int(x) for x in np.argsort(t.order)])
    path = tmp_path / "sited.webm"
    cw.write_mkv(path, s, doc_type="webm", chroma_siting=siting)
    reader = VideoFrameReader(path, device="cpu")
    assert reader.track.chroma_location == mkv.CHROMA_SITING.get(siting)
    for k in range(len(reader)):
        np.testing.assert_array_equal(reader[k], ju.load_frame(path, k), err_msg=f"frame {k}")


@pytest.mark.parametrize("size", [(72, 96), (57, 99)])
@pytest.mark.parametrize("layout", ["411", "420", "422", "440", "444", "gray"])
def test_mjpeg_layouts_match_cv2(tmp_path, layout, size):
    """Motion-JPEG samples of each sampling layout cv2's encoder writes (and
    greyscale), at an even and an odd size: the port's frames equal
    cap4d_tpu's load_frame; the 4:2:0 planes equal ffmpeg's mjpeg decoder's."""
    h, w = size
    frames = _frames(3, h, w, 5)
    if layout == "gray":
        jpegs = [cv2.imencode(".jpg", np.ascontiguousarray(f[..., 0]))[1].tobytes() for f in frames]
    else:
        flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{layout}")
        jpegs = [cv2.imencode(".jpg", np.ascontiguousarray(f[..., ::-1]),
                              [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])[1].tobytes()
                 for f in frames]
    path = tmp_path / f"{layout}.avi"
    cw.write_avi(path, cw.Stream("mjpeg", w, h, jpegs, [True] * 3, [0, 1, 2]))
    for k in (0, 2, 1):
        np.testing.assert_array_equal(load_frame(path, k, device="cpu"), ju.load_frame(path, k),
                                      err_msg=f"frame {k}")
    if layout == "420":
        for got, want in zip((tl.decode_jpeg_planes(j).planes for j in jpegs),
                             ffmpeg_decode("mjpeg", jpegs)):
            for p, q in zip(got, want):
                np.testing.assert_array_equal(p, q)


def test_mjpeg_refuses_what_it_does_not_copy():
    """A progressive JPEG sample and an RGB-coded one raise ValueError naming
    them; the cv2-written Motion-JPEG files' planes equal ffmpeg's."""
    f = _frames(1, 32, 48, 2)[0]
    prog = cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    with pytest.raises(ValueError, match="progressive"):
        tl.MjpegDecoder().decode(prog, "sample 0")
    rgb = _adobe_rgb(cv2.imencode(".jpg", f)[1].tobytes())
    with pytest.raises(ValueError, match="coded as RGB"):
        tl.MjpegDecoder().decode(rgb)
    data = Path(__file__).parent / "data" / "containers"
    for name in ("mjpg_avi.avi", "mjpg_mkv.mkv"):
        t = container.read_track(data / name)
        samples = [t.sample(i) for i in range(len(t))]
        for got, want in zip((tl.decode_jpeg_planes(s).planes for s in samples),
                             ffmpeg_decode("mjpeg", samples)):
            for p, q in zip(got, want):
                np.testing.assert_array_equal(p, q, err_msg=name)


def _adobe_rgb(jpeg: bytes) -> bytes:
    """The JPEG with its JFIF APP0 marker replaced by an Adobe APP14 marker
    of transform 0 (RGB components)."""
    assert jpeg[2:4] == b"\xff\xe0"
    app14 = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    return jpeg[:2] + app14 + jpeg[4 + int.from_bytes(jpeg[4:6], "big"):]


def test_chip_smoke_mjpeg_pin(tmp_path):
    """The Motion-JPEG load chip_smoke.py times on the card: ffmpeg's mjpeg
    planes of its 24 1080p frames hash to the pin it holds there, and so do
    the port's."""
    import chip_smoke
    from cap4d_torch.utils import mpeg4_writer as mw
    from cap4d_torch.utils import synthetic_assets as sa

    sa.write_mjpeg_video(tmp_path / "m.mp4", [chip_smoke.test_image(1080, 1920, k)
                                              for k in range(24)])
    t = container.read_track(tmp_path / "m.mp4")
    ref = ffmpeg_decode("mjpeg", [t.sample(i) for i in range(len(t))])
    assert (len(ref), mw.planes_sha256(ref)) == chip_smoke.MJPEG_1080_PLANES_SHA256
    reader = VideoFrameReader(tmp_path / "m.mp4", device="cpu")
    port = [reader.planes(k) for k in range(24)]
    assert (len(port), mw.planes_sha256(port)) == chip_smoke.MJPEG_1080_PLANES_SHA256
