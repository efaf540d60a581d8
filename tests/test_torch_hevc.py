"""The port's HEVC decoder (``cap4d_torch/runtime/hevc.cpp`` through
``runtime/hevc.py`` and ``VideoFrameReader``) against ffmpeg, the decoder
inside cv2, on streams of seeded random syntax written by
``cap4d_torch/utils/hevc_writer.py`` (cv2's libavcodec has no software
HEVC encoder).

- Planes: ffmpeg's Y, U and V come from cv2's own libavcodec, driven
  through ctypes with one thread (``test_torch_containers.ffmpeg_decode``);
  the port's planes equal them bit for bit, every picture, read in a
  shuffled order from an ``hvc1`` mp4. Where the stream signals BT.601
  limited range, or no colour, cv2's ``CAP_PROP_CONVERT_RGB`` 0 read
  returns the same luma.
- RGB: ``load_frame`` against cap4d_tpu's ``load_frame`` (cv2's decode and
  swscale conversion) bit for bit, every frame, in a shuffled order, in
  ``hvc1`` and ``hev1`` (parameter sets in band) mp4, Matroska
  (``V_MPEGH/ISO/HEVC``) and AVI (``HEVC``, parameter sets in the
  extradata or in band); ``len`` is cv2's count.
- The streams together use every tool the decoder names
  (``test_streams_cover_the_tools``); ffmpeg's departures from the standard
  that the decoder copies are listed in ``runtime/hevc.cpp``'s header and
  exercised here (SAO around PCM and bypass blocks, CTB 16 chroma, minimum
  CB 16 with constrained intra prediction).
- Pinned: the SHA-256 of ffmpeg's planes of each stream, kept in
  ``hevc_writer.PINNED_SHA256``, which ``chip_smoke.py`` holds on the card's
  machine (no cv2 there).
- Refused by name: P and B slices, Main 10, 4:2:2 and the range extensions
  profile, each a ``ValueError`` naming the file.
"""

import contextlib
import ctypes
import io
import random
import struct

import cv2
import numpy as np
import pytest

from cap4d_torch.data import mp4
from cap4d_torch.data.utils import VideoFrameReader, load_frame
from cap4d_torch.runtime.h264 import MATRIX_CODES
from cap4d_torch.runtime.hevc import TOOLS, HevcDecoder
from cap4d_torch.utils import container_writer as cw
from cap4d_torch.utils import hevc_writer as hw
from cap4d_tpu.data import utils as ju
from tests.test_torch_containers import _counted, _libs, ffmpeg_decode
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

CONTAINERS = ("hvc1", "hev1", "mkv", "avi", "avi_inband")


@pytest.fixture(scope="module")
def streams():
    """name -> write_hevc_stream's dict."""
    return {name: hw.stream(name) for name in hw.STREAMS}


@pytest.fixture(scope="module")
def files(streams, tmp_path_factory):
    """(name, container) -> path."""
    d = tmp_path_factory.mktemp("hevc")
    out = {}
    for name, st in streams.items():
        w, h = hw.STREAMS[name]["width"], hw.STREAMS[name]["height"]
        s = hw.as_stream(st, w, h)
        out[name, "hvc1"] = d / f"{name}_hvc1.mp4"
        hw.write_hevc_mp4(out[name, "hvc1"], st, w, h)
        out[name, "hev1"] = d / f"{name}_hev1.mp4"
        hw.write_hevc_mp4(out[name, "hev1"], st, w, h, b"hev1")
        out[name, "mkv"] = d / f"{name}.mkv"
        cw.write_mkv(out[name, "mkv"], s)
        out[name, "avi"] = d / f"{name}.avi"
        cw.write_avi(out[name, "avi"], s)
        out[name, "avi_inband"] = d / f"{name}_inband.avi"
        cw.write_avi(out[name, "avi_inband"], s, in_band=True)
    return out


def ffmpeg_planes(st):
    """ffmpeg's (Y, U, V) of a written stream's pictures in output order."""
    params = b"".join(b"\0\0\0\1" + p for p in st["params"])
    return ffmpeg_decode("hevc", [(params if k == 0 else b"") + mp4.annexb(s, 4)
                                  for k, s in enumerate(st["samples"])])


@pytest.mark.parametrize("name", list(hw.STREAMS))
def test_planes_match_ffmpeg(streams, files, name):
    """Y, U and V of every frame equal ffmpeg's, read in a shuffled order
    (the reader restarts at the IRAP sample before each), and the pin is
    ffmpeg's."""
    want = ffmpeg_planes(streams[name])
    assert hw.planes_sha256(want) == hw.PINNED_SHA256[name]
    reader = VideoFrameReader(files[name, "hvc1"], device="cpu")
    order = list(range(len(want)))
    random.Random(len(want)).shuffle(order)
    for k in order:
        got = reader.planes(k)
        for c in range(3):
            np.testing.assert_array_equal(got[c], want[k][c], err_msg=f"{name} frame {k} plane {c}")
    assert hw.planes_sha256(reader.planes(k) for k in range(len(want))) == hw.PINNED_SHA256[name]


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("name", list(hw.STREAMS))
def test_rgb_matches_cap4d_tpu(files, name, container):
    """len is cv2's count, and every load_frame(k) up to it, in a shuffled
    order, equals cap4d_tpu's bit for bit (an IndexError where cv2 reads no
    frame: pictures that show nowhere)."""
    path = files[name, container]
    reader = VideoFrameReader(path, device="cpu")
    cap = cv2.VideoCapture(str(path))
    assert len(reader) == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    order = list(range(len(reader)))
    random.Random(7).shuffle(order)
    for k in order:
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                want = ju.load_frame(path, k)
            except IndexError:
                with pytest.raises(IndexError):
                    reader[k]
                continue
        np.testing.assert_array_equal(reader[k], want, err_msg=f"{name} {container} frame {k}")
        np.testing.assert_array_equal(load_frame(path, k, device="cpu"), want)


@pytest.mark.parametrize("name", ["phone", "tiles_uniform", "open_gop"])
def test_cv2_luma(files, name):
    """cv2's CAP_PROP_CONVERT_RGB 0 read gives the Y plane of streams that
    signal BT.601 limited range or no colour; the port's equals it."""
    path = files[name, "hvc1"]
    reader = VideoFrameReader(path, device="cpu")
    if reader._hevc.matrix != "bt601" or reader._hevc.full_range:
        reader.planes(0)
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    k = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        y = reader.planes(k)[0]
        if reader._hevc.matrix == "bt601" and not reader._hevc.full_range:
            np.testing.assert_array_equal(frame.reshape(y.shape), y, err_msg=f"{name} frame {k}")
        k += 1
    cap.release()
    assert k == len(reader._order)


@pytest.mark.parametrize("container", CONTAINERS)
def test_open_gop_frames_read_at_random(files, container):
    """Every frame of the open-GOP stream read by a fresh reader (its first
    read): a later CRA's RASL pictures decode from the sync sample before
    that CRA, where cv2's seek lands, and equal cap4d_tpu's frames."""
    path = files["open_gop", container]
    for k in range(len(VideoFrameReader(path, device="cpu")._order)):
        with contextlib.redirect_stdout(io.StringIO()):
            want = ju.load_frame(path, k)
        np.testing.assert_array_equal(VideoFrameReader(path, device="cpu")[k], want,
                                      err_msg=f"{container} frame {k}")


def test_streams_cover_the_tools(streams):
    """The writer's streams together use every tool runtime/hevc.cpp names."""
    used = set()
    for st in streams.values():
        dec = HevcDecoder(tuple(b"\0\0\0\1" + p for p in st["params"]))
        for s in st["samples"]:
            dec.decode(s)
        used |= dec.tools
    assert used == set(TOOLS), sorted(set(TOOLS) - used)


def test_sequential_read_decodes_each_sample_once(files):
    """A sequential read decodes every sample once (pictures that show later
    are held); a random read restarts at the IRAP sample before it."""
    reader = VideoFrameReader(files["open_gop", "hvc1"], device="cpu")
    calls = _counted(reader)
    for k in range(len(reader._order)):
        reader[k]
    assert calls[0] == len(reader.track)


def test_scan_matches_decode(streams):
    """The header scan gives each sample's NAL type, POC and whether it
    shows, as decoding does."""
    st = streams["open_gop"]
    params = tuple(b"\0\0\0\1" + p for p in st["params"])
    dec, scanner = HevcDecoder(params), HevcDecoder(params)
    for j, s in enumerate(st["samples"]):
        got = dec.decode(s)
        assert scanner.scan(s) == dec.picture
        assert (got is not None) == dec.picture.shows == st["shows"][j]


def _ffmpeg_colour(st):
    """(colorspace, color_range, chroma_sample_location) of ffmpeg's hevc
    decoder's codec context after it decodes the stream's first picture,
    read through ctypes (av_opt_get_int)."""
    avutil, avcodec = _libs()
    avutil.av_opt_get_int.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int64)]
    dec = avcodec.avcodec_find_decoder_by_name(b"hevc")
    ctx = ctypes.c_void_p(avcodec.avcodec_alloc_context3(dec))
    assert avutil.av_opt_set(ctx, b"threads", b"1", 0) == 0
    assert avcodec.avcodec_open2(ctx, dec, None) == 0
    pkt, frame = ctypes.c_void_p(avcodec.av_packet_alloc()), ctypes.c_void_p(avutil.av_frame_alloc())
    try:
        data = b"".join(b"\0\0\0\1" + p for p in st["params"]) + mp4.annexb(st["samples"][0], 4)
        assert avcodec.av_new_packet(pkt, len(data)) == 0
        ctypes.memmove(ctypes.c_void_p.from_address(pkt.value + 24).value, data, len(data))
        avcodec.avcodec_send_packet(ctx, pkt)
        avcodec.avcodec_send_packet(ctx, None)
        while avcodec.avcodec_receive_frame(ctx, frame) == 0:
            pass
        out = []
        for name in (b"colorspace", b"color_range", b"chroma_sample_location"):
            v = ctypes.c_int64(-1)
            assert avutil.av_opt_get_int(ctx, name, 0, ctypes.byref(v)) == 0
            out.append(v.value)
        return tuple(out)
    finally:
        avcodec.av_packet_free(ctypes.byref(pkt))
        avutil.av_frame_free(ctypes.byref(frame))
        avcodec.avcodec_free_context(ctypes.byref(ctx))


@pytest.mark.parametrize("name", ["phone", "wpp", "tiles_uniform"])
def test_colour_matches_ffmpeg(streams, name):
    """matrix, range and chroma siting are those ffmpeg's hevc decoder sets
    on its codec context (read through ctypes): BT.709 limited range and
    left for the phone stream, BT.601 full range and top left for the
    wavefront one, unspecified (BT.601 to swscale), limited and left
    without a VUI."""
    st = streams[name]
    dec = HevcDecoder(tuple(b"\0\0\0\1" + p for p in st["params"]))
    dec.decode(st["samples"][0])
    space, rng, loc = _ffmpeg_colour(st)
    assert dec.matrix == MATRIX_CODES.get(space, "bt601")
    assert dec.full_range == (rng == 2)                     # AVCOL_RANGE_JPEG
    assert dec.chroma_location == {1: "left", 2: "center", 3: "topleft", 4: "top",
                                   5: "bottomleft", 6: "bottom"}[loc]
    assert (dec.matrix, dec.full_range, dec.chroma_location) == {
        "phone": ("bt709", False, "left"), "wpp": ("bt601", True, "topleft"),
        "tiles_uniform": ("bt601", False, "left")}[name]


@pytest.mark.parametrize("tool", list(hw.REFUSALS))
def test_refusals(tmp_path, tool):
    """Each refused tool raises ValueError naming it and the file."""
    path = tmp_path / f"{tool}.mp4"
    name = hw.write_hevc_refusal_mp4(path, tool)
    with pytest.raises(ValueError, match=name) as e:
        reader = VideoFrameReader(path, device="cpu")
        for k in range(len(reader)):
            reader[k]
    assert str(path) in str(e.value)


def test_rotated_phone_recording(tmp_path):
    """A portrait phone recording (an hvc1 track turned 90 degrees by its
    tkhd): the port's frames are cv2's, upright, and hash to the pin
    chip_smoke.py holds."""
    path = tmp_path / "portrait.mp4"
    hw.write_rotated_mp4(path)
    reader = VideoFrameReader(path, device="cpu")
    frames = [reader[k] for k in range(len(reader))]
    assert frames[0].shape == (256, 136, 3)
    assert cw.rgb_sha256(frames) == hw.PINNED_ROTATED_RGB_SHA256
    with contextlib.redirect_stdout(io.StringIO()):
        np.testing.assert_array_equal(frames[1], ju.load_frame(path, 1))


def test_corrupt_samples_raise_value_error(streams):
    """Samples cut short or with bytes overwritten decode or raise
    ValueError, never another error or a crash."""
    st = streams["wpp"]
    params = tuple(b"\0\0\0\1" + p for p in st["params"])
    rng = np.random.default_rng(3)
    for trial in range(40):
        data = bytearray(st["samples"][trial % len(st["samples"])])
        if trial % 2:
            data = data[:int(rng.integers(6, len(data)))]
        else:
            for at in rng.integers(8, len(data), 6):
                data[at] = int(rng.integers(0, 256))
        dec = HevcDecoder(params)
        try:
            dec.decode(bytes(data))
        except ValueError:
            pass



def _units(sample):
    """The NAL units of a sample of 4-byte-length NAL units."""
    out, i = [], 0
    while i < len(sample):
        (n,) = struct.unpack_from(">I", sample, i)
        out.append(sample[i + 4:i + 4 + n])
        i += 4 + n
    return out


def _parameter_sets_in_a_picture(case):
    """A one-picture stream of three slices at 64x48 whose sample carries
    parameter sets after its first slice: the same SPS or PPS again, a new
    larger SPS under the active id (between slices, or after the last), the
    active PPS id with another content, or another PPS on another, larger
    SPS followed by a slice of that other picture."""
    kw = dict(log2_ctb=4, max_slices=3)
    a = hw.write_hevc_stream(64, 48, 1, seed=3, tools=dict(dependent=False), **kw)
    # the same seed draws the same parameter set ids
    big = hw.write_hevc_stream(256, 144, 1, seed=3, tools=dict(dependent=False), **kw)
    qp = hw.write_hevc_stream(64, 48, 1, seed=3,
                              tools=dict(dependent=False, init_qp=a["pp"]["init_qp"] ^ 1), **kw)
    other = hw.write_hevc_stream(256, 144, 1, seed=103, tools=dict(dependent=False), **kw)
    assert big["sp"]["id"] == a["sp"]["id"] and big["params"][1] != a["params"][1]
    assert qp["pp"]["id"] == a["pp"]["id"] and qp["params"][2] != a["params"][2]
    assert other["sp"]["id"] != a["sp"]["id"] and other["pp"]["id"] != a["pp"]["id"]
    us = _units(a["samples"][0])
    slices = [k for k, u in enumerate(us) if (u[0] >> 1) & 0x3F <= 21]
    assert len(slices) == 3
    k = slices[0] + 1
    inserted = {"sps_repeated": [a["params"][1]], "pps_repeated": [a["params"][2]],
                "sps_replaced": [big["params"][1]], "pps_replaced": [qp["params"][2]],
                "other_pps": list(other["params"]) + [_units(other["samples"][0])[-1]]}
    if case == "sps_after_last_slice":
        us = us + [big["params"][1]]
    else:
        us = us[:k] + inserted[case] + us[k:]
    return dict(a, samples=[b"".join(struct.pack(">I", len(u)) + u for u in us)])


@pytest.mark.parametrize("case", ["sps_repeated", "pps_repeated", "sps_after_last_slice"])
def test_parameter_sets_that_leave_the_picture_alone(tmp_path, case):
    """A repeated SPS or PPS between the slices of a picture, or a new SPS
    after its last, in band (hev1): the picture is ffmpeg's (which keeps a
    repeated set and decodes the picture under the sets its first slice
    found)."""
    st = _parameter_sets_in_a_picture(case)
    want = ffmpeg_planes(st)
    assert len(want) == 1
    path = tmp_path / f"{case}.mp4"
    hw.write_hevc_mp4(path, st, 64, 48, b"hev1")
    got = VideoFrameReader(path, device="cpu").planes(0)
    for c in range(3):
        np.testing.assert_array_equal(got[c], want[0][c], err_msg=f"{case} plane {c}")


@pytest.mark.parametrize("case,error", [
    ("sps_replaced", "PPS .* whose SPS a new one has replaced"),
    ("pps_replaced", "another PPS than its picture's first"),
    ("other_pps", "another PPS than its picture's first")])
def test_parameter_sets_that_change_inside_a_picture_raise(tmp_path, case, error):
    """A new SPS under the active id between two slices of a picture (its
    PPS goes with it, as in ffmpeg), a new PPS under the picture's id, or a
    slice naming another PPS on a larger SPS: ValueError naming the file, as
    ffmpeg refuses those slices ("PPS changed between slices"), never a
    read past the picture's maps."""
    path = tmp_path / f"{case}.mp4"
    hw.write_hevc_mp4(path, _parameter_sets_in_a_picture(case), 64, 48, b"hev1")
    with pytest.raises(ValueError, match=error) as e:
        VideoFrameReader(path, device="cpu").planes(0)
    assert str(path) in str(e.value)


# (mode, seed): streams drawn at random beyond STREAMS, as the decoder was
# swept against ffmpeg: several slices, tiles, wavefronts, a minimum CB of
# 16 (constrained intra prediction's left column), open GOPs
SWEEP = [("slices", 3), ("slices", 17), ("tiles", 9), ("tiles", 22), ("wpp", 5), ("wpp", 14),
         ("mincb16", 2), ("mincb16", 7), ("plan", 4), ("plan", 11)]


@pytest.mark.parametrize("mode,seed", SWEEP)
def test_random_streams_match_ffmpeg(mode, seed):
    """Every picture of a randomly drawn stream equals ffmpeg's, in output
    order (the decoder's pictures sorted by the writer's presentation
    ranks)."""
    ctb = [4, 5, 6][seed % 3]
    kw = dict(log2_ctb=ctb, max_slices=4)
    w, h, n = 136, 72, 2
    if mode == "tiles":
        cols = -(-w // (1 << ctb))
        kw["tiles"] = ([1, cols - 2, 1], [1, 1], True) if seed % 2 and cols >= 3 else (
            [0, 0], [0, 0], False)
        if ctb == 6:
            kw["tiles"] = ([0, 0], [0], False)
    elif mode == "wpp":
        kw["wpp"] = True
    elif mode == "mincb16":
        kw.update(log2_min_cb=4, log2_ctb=5 + seed % 2, wpp=seed % 3 == 0)
        w, h = 144, 80
    elif mode == "plan":
        kw.update(max_slices=2, plan=["CRA", "RASL", "RADL", "TRAIL", "HIDDEN", "IDR", "RADL",
                                      "TRAIL", "BLA", "TRAIL_N"])
        w, h = 40, 24
    st = hw.write_hevc_stream(w, h, n, seed=seed, **kw)
    want = ffmpeg_planes(st)
    dec = HevcDecoder(tuple(b"\0\0\0\1" + p for p in st["params"]))
    got = []
    for j, s in enumerate(st["samples"]):
        planes = dec.decode(s)
        if planes is not None:
            got.append((st["rank"][j], planes))
    got = [p for _, p in sorted(got, key=lambda t: t[0])]
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c], err_msg=f"{mode} {seed} picture {k} plane {c}")
