"""The port's HEVC inter prediction (P and B slices in
``cap4d_torch/runtime/hevc.cpp``: merge, AMVP, TMVP, weighted prediction,
the RPS-driven DPB) against ffmpeg, the decoder inside cv2, on streams of
seeded random syntax written by ``cap4d_torch/utils/hevc_writer.py``
(``write_hevc_inter_stream``; cv2's libavcodec has no software HEVC
encoder).

``tests/test_torch_hevc.py`` runs every stream of ``hevc_writer.STREAMS``,
the inter ones among them, through its plane, container, tool-coverage and
refusal tests; this module adds what inter pictures bring:

- Planes: Y, U and V of every picture equal ffmpeg's (one thread, through
  ctypes) bit for bit, read in order by a fresh reader and one frame each
  by a fresh reader (a random read from the sync sample cv2's seek lands
  on), and a seed sweep of ``write_hevc_inter_stream`` over GOP shapes and
  drawn tools (tiles, wavefronts, dependent slices, PCM, bypass, scaling
  lists, QP deltas, weighted prediction, list modifications, constrained
  intra prediction) matches ffmpeg too.
- Output: ``len`` and the frames shown follow ffmpeg's output process
  (pic_output_flag 0, no_output_of_prior_pics_flag discarding pictures
  still waiting, RASL pictures of the first CRA): the writer's model, the
  decoder's header scan and ffmpeg's count agree, and a sequential read
  decodes each sample once.
- Random reads skip only the sub-layer non-reference pictures at the
  stream's highest TemporalId; one below it is decoded for the higher
  sub-layer that refers to it.
- A new SPS in band (hev1) drops the reference pictures as ffmpeg does; a
  slice whose RPS differs from its picture's first slice's and a list
  entry past the initial list raise ValueError.
"""

import contextlib
import io
import random

import cv2
import numpy as np
import pytest

from cap4d_torch.data import mp4
from cap4d_torch.data.utils import VideoFrameReader
from cap4d_torch.runtime.hevc import TOOLS, HevcDecoder
from cap4d_torch.utils import container_writer as cw
from cap4d_torch.utils import hevc_writer as hw
from cap4d_tpu.data import utils as ju
from tests.test_torch_containers import _counted, ffmpeg_decode
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

INTER = list(hw.INTER_STREAMS)
INTER_TOOLS = set(TOOLS[TOOLS.index("p_slice"):])


def ffmpeg_planes(st):
    """ffmpeg's (Y, U, V) of a written stream's pictures in output order."""
    params = b"".join(b"\0\0\0\1" + p for p in st["params"])
    return ffmpeg_decode("hevc", [(params if k == 0 else b"") + mp4.annexb(s, 4)
                                  for k, s in enumerate(st["samples"])])


@pytest.fixture(scope="module")
def streams():
    return {name: hw.stream(name) for name in INTER}


@pytest.fixture(scope="module")
def files(streams, tmp_path_factory):
    """name -> an hvc1 mp4 of the stream."""
    d = tmp_path_factory.mktemp("hevc_inter")
    out = {}
    for name, st in streams.items():
        out[name] = d / f"{name}.mp4"
        hw.write_hevc_mp4(out[name], st, hw.STREAMS[name]["width"], hw.STREAMS[name]["height"])
    return out


@pytest.mark.parametrize("name", INTER)
def test_planes_in_order_and_at_random(streams, files, name):
    """Every frame's planes equal ffmpeg's: a fresh reader read in order, and
    a fresh reader for each frame (its first read starts at the sync sample
    cv2's seek lands on)."""
    want = ffmpeg_planes(streams[name])
    assert hw.planes_sha256(want) == hw.PINNED_SHA256[name]
    reader = VideoFrameReader(files[name], device="cpu")
    assert len(reader._order) == len(want)
    for k in range(len(want)):
        got = reader.planes(k)
        for c in range(3):
            np.testing.assert_array_equal(got[c], want[k][c], err_msg=f"{name} frame {k} plane {c}")
    for k in range(len(want)):
        got = VideoFrameReader(files[name], device="cpu").planes(k)
        for c in range(3):
            np.testing.assert_array_equal(got[c], want[k][c],
                                          err_msg=f"{name} frame {k} plane {c} (fresh reader)")


@pytest.mark.parametrize("name", INTER)
def test_sequential_read_decodes_each_sample_once(files, name):
    """Reading every frame in order decodes every sample once (pictures
    that show later are held, up to the SPS's DPB size), but for the two
    pictures of the output stream that show nowhere and that nothing after
    them needs: the read of the frame after them starts at its IDR."""
    reader = VideoFrameReader(files[name], device="cpu")
    calls = _counted(reader)
    for k in range(len(reader._order)):
        reader.planes(k)
    assert calls[0] == len(reader.track) - (2 if name == "output" else 0)


def test_streams_cover_the_inter_tools(streams):
    """The inter streams alone use every inter tool runtime/hevc.cpp names."""
    used = set()
    for st in streams.values():
        dec = HevcDecoder(tuple(b"\0\0\0\1" + p for p in st["params"]))
        for s in st["samples"]:
            dec.decode(s)
        used |= dec.tools
    assert INTER_TOOLS <= used, sorted(INTER_TOOLS - used)


@pytest.mark.parametrize("name", INTER)
def test_scan_matches_decode_and_output(streams, name):
    """The header scan gives each sample's NAL type, POC, TemporalId and
    whether it shows as decoding does; the pictures it lets show are the
    writer's model of ffmpeg's output process and ffmpeg's count."""
    st = streams[name]
    params = tuple(b"\0\0\0\1" + p for p in st["params"])
    dec, scanner = HevcDecoder(params), HevcDecoder(params)
    shows = []
    for j, s in enumerate(st["samples"]):
        dec.decode(s)
        pic = scanner.scan(s)
        assert pic == dec.picture, j
        shows.append(pic.shows)
        for k in scanner.discarded:
            shows[k] = False
    assert shows == st["shows"]
    assert sum(shows) == len(ffmpeg_planes(st))


def test_output_stream_discards_prior_pictures(streams, files, tmp_path):
    """pic_output_flag 0 and an IDR's no_output_of_prior_pics_flag: the
    pictures waiting for output when the IDR arrives show nowhere (ffmpeg
    discards them), cv2 counts every sample and reads the others, and the
    frames past them raise IndexError as cv2 reads none."""
    st = streams["output"]
    assert st["discarded"] == [1, 4] and not st["shows"][3]
    path = files["output"]
    reader = VideoFrameReader(path, device="cpu")
    cap = cv2.VideoCapture(str(path))
    assert len(reader) == int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(st["samples"])
    cap.release()
    assert len(reader._order) == sum(st["shows"]) == 5
    with pytest.raises(IndexError, match="no_output_of_prior_pics_flag"):
        reader[len(reader._order)]
    avi = tmp_path / "output.avi"
    cw.write_avi(avi, hw.as_stream(st, 96, 64))
    for k in range(len(reader._order)):
        with contextlib.redirect_stdout(io.StringIO()):
            want = ju.load_frame(avi, k)
        np.testing.assert_array_equal(VideoFrameReader(avi, device="cpu")[k], want, err_msg=str(k))


def test_random_reads_skip_only_top_sub_layer_non_references(files):
    """A random read skips a sub-layer non-reference picture (an even NAL
    type) only at the stream's highest TemporalId: the TSA_N picture at
    TemporalId 1 is decoded, since the TemporalId 2 picture after it
    refers to it; the STSA_N and TRAIL_N pictures at TemporalId 2 that
    show before the frame read are not."""
    reader = VideoFrameReader(files["temporal"], device="cpu")
    assert reader._top_tid == 2
    skipped = [j for j in range(len(reader.track)) if reader._unreferenced(j)]
    assert [int(reader._nal_type[j]) for j in skipped] == [4, 0, 0]      # STSA_N, TRAIL_N x2
    assert not reader._unreferenced(2) and reader._nal_type[2] == 2 and reader._tid[2] == 1
    want = ffmpeg_planes(hw.stream("temporal"))
    # frame 8 is sample 5: samples 0-5 but the STSA_N (sample 4, frame 3) decode
    fresh = VideoFrameReader(files["temporal"], device="cpu")
    calls = _counted(fresh)
    np.testing.assert_array_equal(fresh.planes(8)[0], want[8][0])
    assert calls[0] == 5
    # frame 7 is sample 8: the TRAIL_N at sample 7 (frame 5) is skipped as well
    fresh = VideoFrameReader(files["temporal"], device="cpu")
    calls = _counted(fresh)
    np.testing.assert_array_equal(fresh.planes(7)[0], want[7][0])
    assert calls[0] == 7


def test_phone_recording_reads_every_frame(files):
    """A phone-like hvc1 P stream (CTB 64, TMVP, BT.709) reads every frame
    in the port, and its RGB equals cap4d_tpu's."""
    path = files["phone_ippp"]
    reader = VideoFrameReader(path, device="cpu")
    assert len(reader) == 6
    frames = [reader[k] for k in range(6)]
    assert all(f.shape == (136, 256, 3) for f in frames)
    for k in (1, 5):
        with contextlib.redirect_stdout(io.StringIO()):
            np.testing.assert_array_equal(frames[k], ju.load_frame(path, k))


def test_corrupt_inter_samples_raise_value_error(streams):
    """Inter samples cut short or with bytes overwritten decode or raise
    ValueError, never another error or a crash; the DPB recovers at the
    next IDR."""
    st = streams["pyramid"]
    params = tuple(b"\0\0\0\1" + p for p in st["params"])
    rng = np.random.default_rng(5)
    for trial in range(30):
        dec = HevcDecoder(params)
        for j, s in enumerate(st["samples"]):
            data = bytearray(s)
            if j == 1 + trial % (len(st["samples"]) - 1):
                if trial % 2:
                    data = data[:int(rng.integers(6, len(data)))]
                else:
                    for at in rng.integers(8, len(data), 6):
                        data[at] = int(rng.integers(0, 256))
            try:
                dec.decode(bytes(data))
            except ValueError:
                dec.reset()
                break


# a BLA picture after pictures still waiting for output (ffmpeg outputs them
# first, in order count), whose RPS names a picture of the old sequence
# (generated) and whose RASL picture ffmpeg skips
GOP_BLA = [dict(nal="IDR", poc=0, slices="I"),
           dict(nal="TRAIL", poc=2, slices="P", refs=[(0, True)]),
           dict(nal="TRAIL", ref=False, poc=1, slices="B", refs=[(0, True), (2, True)]),
           dict(nal="BLA", poc=8, slices="I", refs=[(2, False)], missing=[2]),
           dict(nal="RASL", poc=6, slices="B", refs=[(2, True), (8, True)], missing=[2]),
           dict(nal="RADL", ref=False, poc=7, slices="P", refs=[(8, True)]),
           dict(nal="TRAIL", poc=9, slices="P", refs=[(8, True)]),
           dict(nal="TRAIL", poc=10, slices="B", refs=[(9, True), (8, False)])]


def test_bla_restart_reads_as_cv2(tmp_path):
    """A BLA picture in the middle of an inter stream: the pictures before
    it show first, its RASL picture nowhere, its RADL picture before it;
    every frame equals cap4d_tpu's in mp4 (times from the ranks) and AVI
    (the order count scan, which starts over at the BLA), and len is
    cv2's."""
    st = hw.write_hevc_inter_stream(96, 64, 7, GOP_BLA, log2_ctb=4)
    assert st["rank"] == [0, 2, 1, 4, -1, 3, 5, 6]
    mp4_path, avi_path = tmp_path / "bla.mp4", tmp_path / "bla.avi"
    hw.write_hevc_mp4(mp4_path, st, 96, 64)
    cw.write_avi(avi_path, hw.as_stream(st, 96, 64))
    want = ffmpeg_planes(st)
    for path in (mp4_path, avi_path):
        reader = VideoFrameReader(path, device="cpu")
        cap = cv2.VideoCapture(str(path))
        assert len(reader) == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        assert len(reader._order) == len(want) == 7
        for k in range(7):
            np.testing.assert_array_equal(reader.planes(k)[0], want[k][0], err_msg=f"{path} {k}")
            with contextlib.redirect_stdout(io.StringIO()):
                np.testing.assert_array_equal(VideoFrameReader(path, device="cpu")[k],
                                              ju.load_frame(path, k), err_msg=f"{path} {k}")


# (GOP, seed): streams drawn at random beyond STREAMS, as the decoder was
# swept against ffmpeg: each draws its CTB and minimum CB, size, slices,
# tiles or wavefronts and the PPS/SPS tools
GOPS = {"phone": hw.GOP_PHONE, "pyramid": hw.GOP_PYRAMID, "long_term": hw.GOP_LONG_TERM,
        "temporal": hw.GOP_TEMPORAL, "open": hw.GOP_OPEN, "output": hw.GOP_OUTPUT,
        "bla": GOP_BLA}
SWEEP = [("phone", 3), ("phone", 12), ("pyramid", 5), ("pyramid", 21), ("long_term", 8),
         ("long_term", 30), ("temporal", 2), ("temporal", 17), ("open", 9), ("open", 26),
         ("output", 11), ("output", 33), ("bla", 6), ("bla", 19)]


@pytest.mark.parametrize("gop,seed", SWEEP)
def test_random_inter_streams_match_ffmpeg(gop, seed):
    """Every picture of a randomly drawn inter stream equals ffmpeg's, in
    output order (the decoder's pictures sorted by the writer's
    presentation ranks), and ffmpeg shows the pictures the writer's model
    of its output process shows."""
    r = random.Random(seed * 7 + 1)
    ctb = r.choice([4, 5, 6])
    kw = dict(log2_ctb=ctb, log2_min_cb=r.choice([3, 3, 4]) if ctb > 4 else 3, draw=True,
              max_slices=r.choice([1, 2, 4]))
    w, h = r.choice([(96, 64), (136, 72), (64, 48), (200, 120)])
    mode = r.random()
    if mode < 0.25:
        kw["wpp"] = True
    elif mode < 0.5 and -(-w // (1 << ctb)) >= 2 and -(-h // (1 << ctb)) >= 2:
        kw["tiles"] = ([0, 0], [0, 0], False)
    st = hw.write_hevc_inter_stream(w, h, seed, GOPS[gop], **kw)
    want = ffmpeg_planes(st)
    dec = HevcDecoder(tuple(b"\0\0\0\1" + p for p in st["params"]))
    got = []
    for j, s in enumerate(st["samples"]):
        planes = dec.decode(s)
        if st["rank"][j] >= 0:
            assert planes is not None, j
            got.append((st["rank"][j], planes))
    got = [p for _, p in sorted(got, key=lambda t: t[0])]
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        for c in range(3):
            np.testing.assert_array_equal(a[c], b[c], err_msg=f"{gop} {seed} picture {k} plane {c}")


def _nals(sample: bytes):
    """The NAL units of a length-prefixed sample."""
    out, i = [], 0
    while i < len(sample):
        n = int.from_bytes(sample[i:i + 4], "big")
        out.append(sample[i + 4:i + 4 + n])
        i += 4 + n
    return out


def _sample(nals) -> bytes:
    return b"".join(len(x).to_bytes(4, "big") + x for x in nals)


def test_slice_naming_other_references_than_its_first_slice_raises():
    """A picture whose first slice is an I slice whose RPS gives nothing for
    prediction, and whose second slice is a P slice whose RPS does: the
    lists come from the first slice's RPS (ffmpeg's frame RPS), so the P
    slice raises ValueError instead of building a list from nothing."""
    gop = [dict(nal="IDR", poc=0, slices="I"),
           dict(nal="TRAIL", poc=1, slices="I", refs=[(0, False)]),
           dict(nal="TRAIL", poc=2, slices="P", refs=[(1, True), (0, False)])]
    st = hw.write_hevc_inter_stream(64, 64, 3, gop, log2_ctb=4, max_slices=4)
    first, second = _nals(st["samples"][1]), _nals(st["samples"][2])
    assert len(second) >= 2, "the P picture was written as one slice"
    dec = HevcDecoder(tuple(b"\0\0\0\1" + p for p in st["params"]))
    dec.decode(st["samples"][0])
    with pytest.raises(ValueError, match="Zero refs in the frame RPS"):
        dec.decode(_sample([first[0], second[1]]))


def test_list_entry_past_the_initial_list_raises():
    """17 pictures for prediction (16 short-term, one long-term) and a
    list_entry of 16: the initial list holds 16 pictures (ffmpeg's
    "Invalid reference index"), so the slice raises ValueError."""
    gop = [dict(nal="IDR", poc=0, slices="I")]
    gop += [dict(nal="TRAIL", poc=k, slices="P", refs=[(j, True) for j in range(max(0, k - 16), k)])
            for k in range(1, 17)]
    gop.append(dict(nal="TRAIL", poc=17, slices="P", refs=[(j, True) for j in range(1, 17)],
                    lt=[(0, True, False)], list_entry=[16, 0], tmvp=False))
    st = hw.write_hevc_inter_stream(32, 32, 2, gop, log2_ctb=4, max_slices=1,
                                    tools=dict(list_mod=True))
    dec = HevcDecoder(tuple(b"\0\0\0\1" + p for p in st["params"]))
    for s in st["samples"][:-1]:
        dec.decode(s)
    with pytest.raises(ValueError, match="list_entry 16 past the 16 pictures"):
        dec.decode(st["samples"][-1])


# an SPS sent anew before a CRA picture (a spliced or resized hev1 stream):
# ffmpeg drops every reference picture and starts a sequence, so the CRA's
# RPS names generated pictures and a RASL picture that predicts from the
# CRA alone still shows; a trailing picture after the new SPS finds none
GOP_BEFORE = [dict(nal="IDR", poc=0, slices="I"),
              dict(nal="TRAIL", poc=4, slices="P", refs=[(0, True)]),
              dict(nal="TRAIL", poc=5, slices="P", refs=[(4, True)])]
GOP_AFTER = [dict(nal="CRA", poc=8, slices="I", refs=[(5, False)], missing=[5]),
             dict(nal="RASL", poc=6, slices="P", refs=[(8, True)]),
             dict(nal="TRAIL", poc=9, slices="B", refs=[(8, True)]),
             dict(nal="TRAIL", poc=10, slices="P", refs=[(9, True), (8, False)])]


@pytest.mark.parametrize("size", [(64, 48), (96, 64)])
def test_new_sps_before_a_cra_reads_as_ffmpeg(tmp_path, size):
    """A hev1 file whose second SPS (in band, before a CRA picture) is new,
    at the first one's size or larger: every frame's planes equal
    ffmpeg's, in order and one frame a fresh reader, and len is cv2's."""
    a = hw.write_hevc_inter_stream(64, 48, 1, GOP_BEFORE, log2_ctb=4)
    b = hw.write_hevc_inter_stream(*size, 11, GOP_AFTER, log2_ctb=4)
    inband = _sample(b["params"])
    samples = list(a["samples"]) + [inband + b["samples"][0]] + list(b["samples"][1:])
    want = ffmpeg_decode("hevc", [(b"".join(b"\0\0\0\1" + p for p in a["params"]) if j == 0
                                   else b"") + mp4.annexb(s, 4) for j, s in enumerate(samples)])
    assert [w[0].shape for w in want] == [(48, 64)] * 3 + [size[::-1]] * 4
    st = dict(a, samples=samples, sync=list(a["sync"]) + [False] * len(b["samples"]),
              rank=[0, 1, 2, 4, 3, 5, 6])
    path = tmp_path / "spliced.mp4"
    hw.write_hevc_mp4(path, st, 64, 48, fourcc=b"hev1")
    cap = cv2.VideoCapture(str(path))
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    reader = VideoFrameReader(path, device="cpu")
    assert len(reader) == count == len(want)
    for k in range(len(want)):
        for got in (reader.planes(k), VideoFrameReader(path, device="cpu").planes(k)):
            for c in range(3):
                np.testing.assert_array_equal(got[c], want[k][c], err_msg=f"frame {k} plane {c}")


def test_new_sps_before_a_trailing_picture_raises():
    """A new SPS before a trailing picture drops the pictures it predicts
    from (ffmpeg: "Error constructing the frame RPS"): ValueError."""
    a = hw.write_hevc_inter_stream(64, 48, 1, GOP_BEFORE, log2_ctb=4)
    # the SPS anew on its id, strong intra smoothing turned round, and the PPS on it again
    sp = dict(a["sp"], strong=not a["sp"]["strong"])
    sps = hw.nal(hw.SPS, hw.sps_rbsp(sp, random.Random(0)))
    assert sps != a["params"][1]
    dec = HevcDecoder(tuple(b"\0\0\0\1" + p for p in a["params"]))
    for s in a["samples"][:2]:
        dec.decode(s)
    with pytest.raises(ValueError, match="which the DPB does not hold"):
        dec.decode(_sample([sps, a["params"][2]]) + a["samples"][2])
