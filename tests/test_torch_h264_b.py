"""B slices in the port's H.264 decoder (``cap4d_torch/runtime/h264.cpp``)
and presentation-order reads in ``VideoFrameReader``, against ffmpeg (cv2)
and cap4d_tpu's cv2 reader, on streams of seeded random syntax written by
``h264_writer.write_h264_syntax_mp4(..., b_frames=True)``.

- Luma bit for bit against ffmpeg's sequential read, every frame, read in
  order and shuffled; RGB (so chroma) bit for bit against cap4d_tpu's
  ``load_frame`` (cv2's ``CAP_PROP_POS_FRAMES`` seek) on every frame.
- A sequential read of n frames makes n decode calls; a random read decodes
  from the last sync sample and skips the non-reference samples shown
  before its frame.
- The B_Skip stream of ``synthetic_assets.write_h264_mp4(..., b_frames=)``
  decodes to the rounded averages of its anchors (an oracle independent of
  ffmpeg, which the card's machine lacks).
- A container whose composition times contradict the picture order count
  raises, naming both frames.
"""

import struct

import numpy as np
import pytest
import torch

from cap4d_torch.data import mp4
from cap4d_torch.data.utils import VideoFrameReader, load_frame
from cap4d_torch.runtime.h264 import H264Decoder
from cap4d_torch.runtime.nvdec import nv12_to_rgb
from cap4d_torch.utils import h264_writer as hw
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_tpu.data import utils as ju
from tests.test_torch_h264 import ffmpeg_luma
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

N_FRAMES = 16
# (entropy, seed, width, height): together they use every B tool the decoder
# takes (test_b_streams_cover_the_tools); 110x74 is cropped; the CAVLC ones
# have POC type 0 (one without direct_8x8_inference_flag), CABAC seed 5 type
# 1 with reordering and seed 7 type 2 (low-delay B pictures)
STREAMS = [("cavlc", 1, 128, 96), ("cavlc", 2, 128, 96), ("cabac", 5, 128, 96),
           ("cabac", 7, 110, 74)]


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{(entropy, seed): (path, writer stats, ffmpeg's luma)}."""
    d = tmp_path_factory.mktemp("h264_b")
    out = {}
    for entropy, seed, w, h in STREAMS:
        path = d / f"{entropy}_{seed}.mp4"
        stats = hw.write_h264_syntax_mp4(path, w, h, N_FRAMES, seed, entropy, b_frames=True)
        out[entropy, seed] = (path, stats, ffmpeg_luma(path))
    return out


def counted(reader):
    """Count the reader's decode calls: a list whose first item is the count."""
    calls, decode = [0], reader._h264.decode

    def decode_counted(*args):
        calls[0] += 1
        return decode(*args)

    reader._h264.decode = decode_counted
    return calls


@pytest.mark.parametrize("entropy,seed,w,h", STREAMS)
def test_b_luma_matches_ffmpeg_bit_for_bit(streams, entropy, seed, w, h):
    """In order (n decode calls for n frames) and shuffled."""
    path, _, ref = streams[entropy, seed]
    assert len(ref) == N_FRAMES
    reader = VideoFrameReader(path, device="cpu")
    calls = counted(reader)
    for k in range(N_FRAMES):
        y = reader.h264_planes(k)[0]
        assert y.shape == (h, w)
        np.testing.assert_array_equal(y, ref[k], err_msg=f"{entropy} seed {seed} frame {k}")
    assert calls[0] == N_FRAMES
    reader = VideoFrameReader(path, device="cpu")
    for k in np.random.default_rng(seed).permutation(N_FRAMES):
        np.testing.assert_array_equal(reader.h264_planes(int(k))[0], ref[k],
                                      err_msg=f"{entropy} seed {seed} frame {k} (shuffled)")


def test_b_streams_cover_the_tools(streams):
    """Together, in each entropy mode: B_Skip, B_Direct_16x16, every B
    16x16/16x8/8x16 list combination, B_8x8 with every sub_mb_type (direct
    and 4x4 included), spatial and temporal direct; across the streams:
    reference and non-reference B pictures and a B-pyramid, list-1
    modifications, long-term pictures in list 1, weighted_bipred_idc 0, 1
    and 2 (explicit weights written), direct_8x8_inference_flag 0 and 1, POC
    types 0 and 1 with reordering and 2 without, a cropped size."""
    stats = {key: v[1] for key, v in streams.items()}
    for entropy in ("cavlc", "cabac"):
        mb = {}
        for (e, _), s in stats.items():
            if e == entropy:
                for key, v in s["mb"].items():
                    mb[key] = mb.get(key, 0) + v
        assert all(mb.get(f"b_type_{t}", 0) > 0 for t in range(23)), (entropy, mb)
        assert all(mb.get(f"b_sub_{t}", 0) > 0 for t in range(13)), (entropy, mb)
        assert mb["b_skip"] > 0
        assert sum(s["temporal"] for (e, _), s in stats.items() if e == entropy) > 0
        assert sum(s["spatial"] for (e, _), s in stats.items() if e == entropy) > 0
    kinds = {k for s in stats.values() for k in s["frames"]}
    assert {"idr", "p", "b", "b_nonref"} <= kinds
    assert any(s["reorder"] >= 2 for s in stats.values())                       # a pyramid
    assert sum(s["mods_l1"] for s in stats.values()) > 0
    assert sum(s["long_term_l1"] for s in stats.values()) > 0
    assert {0, 1, 2} <= {i for s in stats.values() for i in s["bipred"]}
    assert sum(s["weighted_b"] for s in stats.values()) > 0
    assert {True, False} == {s["direct8x8"] for s in stats.values()}
    assert {(0, True), (1, True), (2, False)} <= {(s["poc_type"], s["reorder"] > 0)
                                                  for s in stats.values()}
    assert any(s["cropped"] for s in stats.values())


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_b_load_frame_rgb_matches_jax(streams, entropy):
    """RGB frames of ``load_frame`` (a cached reader, reads out of order)
    equal cap4d_tpu's cv2 reader's, every frame: chroma and bi-prediction
    against ffmpeg, and the frame numbering against cv2's seek."""
    for (e, seed), (path, _, _) in streams.items():
        if e != entropy:
            continue
        for k in np.random.default_rng(seed + 10).permutation(N_FRAMES):
            port = load_frame(path, int(k), device="cpu")
            jax = ju.load_frame(path, int(k))
            np.testing.assert_array_equal(port, jax, err_msg=f"{entropy} seed {seed} frame {k}")


def test_decoder_reports_order_count_and_reference(streams):
    """Each picture's PicOrderCnt and nal_ref_idc, as the writer coded them."""
    for (entropy, seed), (path, stats, _) in streams.items():
        t = mp4.read_track(path)
        dec = H264Decoder(t.avc)
        for j, want in enumerate(stats["pictures"]):
            dec.decode(t.sample(j))
            assert dec.picture.poc == want["poc"], (entropy, seed, j)
            assert (dec.picture.nal_ref_idc > 0) == (not want["kind"].endswith("nonref"))
            assert dec.picture.idr == (want["kind"] == "idr") and not dec.picture.mmco5


def test_random_read_skips_non_reference_samples(streams):
    """A fresh read of frame k decodes its sync sample and every sample up
    to k's but the non-reference ones shown before k."""
    path, _, ref = streams["cavlc", 1]
    t = mp4.read_track(path)
    shown = np.empty(len(t), np.int64)
    shown[t.order] = np.arange(len(t))
    skipped_any = False
    for k in range(N_FRAMES):
        reader = VideoFrameReader(path, device="cpu")
        calls = counted(reader)
        np.testing.assert_array_equal(reader.h264_planes(k)[0], ref[k])
        s = int(t.order[k])
        sync = int(np.flatnonzero(t.sync[:s + 1])[-1])
        skip = [j for j in range(sync, s)
                if shown[j] < k and mp4.slice_ref_idc(t.sample(j), t.avc.length_size) == 0]
        skipped_any |= bool(skip)
        assert calls[0] == s + 1 - sync - len(skip), k
    assert skipped_any


@pytest.mark.parametrize("size", [(110, 74), (64, 48)])
def test_b_skip_stream_decodes_to_the_averages(tmp_path, size):
    """I_PCM anchors and B_Skip pictures: every B frame is (past + future +
    1) >> 1 of its anchors in Y, U and V, read in order and shuffled; the RGB
    is the planes' conversion."""
    w, h = size
    path = tmp_path / "bskip.mp4"
    frames = sa.write_h264_mp4(path, 14, w, h, gop=7, b_frames=2)
    reader = VideoFrameReader(path)                  # no device: decodes on the host
    calls = counted(reader)
    for k in range(14):
        for got, want in zip(reader.h264_planes(k), frames[k]):
            np.testing.assert_array_equal(got, want)
    assert calls[0] == 14
    assert not all(np.array_equal(frames[1][0], frames[k][0]) for k in (0, 3))  # B != anchors
    reader = VideoFrameReader(path)
    for k in np.random.default_rng(1).permutation(14):
        for got, want in zip(reader.h264_planes(int(k)), frames[k]):
            np.testing.assert_array_equal(got, want)
        y, u, v = (torch.from_numpy(p) for p in frames[k])
        np.testing.assert_array_equal(reader[int(k)], nv12_to_rgb(y, torch.stack([u, v], -1)))
    assert [f[0].tobytes() for f in frames] == [f.tobytes() for f in ffmpeg_luma(path)]


def test_composition_times_against_order_count_raise(tmp_path):
    """The first B picture's composition time moved past the second's: the
    reader raises, naming both frames and both orders, and returns neither."""
    path = tmp_path / "reordered.mp4"
    sa.write_h264_mp4(path, 8, 64, 48, gop=8, b_frames=2)   # decode order: I0 I3 B1 B2 ...
    data = bytearray(path.read_bytes())
    at = data.index(b"ctts") + 12                     # after version/flags and entry_count
    entries = list(struct.unpack_from(">16I", data, at))   # (count, offset) of 8 samples
    entries[5] += 3 * sa.FRAME_TICKS // 2             # sample 2 (B1) now shows after B2
    struct.pack_into(">16I", data, at, *entries)
    path.write_bytes(bytes(data))
    reader = VideoFrameReader(path, device="cpu")
    with pytest.raises(ValueError, match=r"frame 1 \(sample [23]\) shows before frame 2 .*"
                                         r"composition times .*not by picture order count"):
        for k in range(8):
            reader.h264_planes(k)


def test_open_gop_leading_picture_raises(streams, tmp_path):
    """The stream again with its first I anchor as a sync sample too (an
    open GOP): a read of a frame shown before that anchor and decoded after
    it raises the missing-reference error and returns no picture; a
    sequential read decodes them all."""
    path, stats, ref = streams["cavlc", 1]
    t = mp4.read_track(path)
    anchor = stats["frames"].index("i")
    lead = next(j for j, p in enumerate(stats["pictures"])
                if j > anchor and p["display"] < stats["pictures"][anchor]["display"])
    avcc = sa._box(b"avcC", bytes([1, 100, 0, 40, 0xFF, 0xE1]),
                   *[struct.pack(">H", len(n) - 4) + n[4:] for n in t.avc.sps],
                   bytes([len(t.avc.pps)]),
                   *[struct.pack(">H", len(n) - 4) + n[4:] for n in t.avc.pps])
    ctts = [int(p - d) // sa.FRAME_TICKS for p, d in zip(t.pts, t.dts)]
    open_gop = tmp_path / "open_gop.mp4"
    sa.write_mp4(open_gop, [t.sample(j) for j in range(len(t))],
                 sa.visual_sample_entry(b"avc1", t.width, t.height, avcc), t.width, t.height,
                 sync=[j in (0, anchor) for j in range(len(t))], ctts=ctts, edit_start=ctts[0])
    frame = int(np.flatnonzero(t.order == lead)[0])
    reader = VideoFrameReader(open_gop, device="cpu")
    with pytest.raises(ValueError, match=f"frame {frame} .*leading picture.*"
                                         "reference the DPB does not hold"):
        reader.h264_planes(frame)
    reader = VideoFrameReader(open_gop, device="cpu")
    for k in range(N_FRAMES):
        np.testing.assert_array_equal(reader.h264_planes(k)[0], ref[k])
