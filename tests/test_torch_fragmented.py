"""Fragmented mp4 and edit lists of several edits in the port's mp4 demuxer
(``cap4d_torch/data/mp4.py``) against cv2, which reads the same files
through ffmpeg's mov demuxer.

- Every layout of ``container_writer.FRAGMENTED_LAYOUTS`` (fragments per
  GOP and per sample count, defaults in ``trex``, ``tfhd`` or per sample,
  each ``tfhd`` base-offset mode, with and without ``tfdt``, ``trun`` v0
  and v1 composition offsets, an interleaved audio track, DASH segments
  with ``mfra``, a hybrid moov, cut recordings) written around the H.264
  B and MPEG-4 B-VOP writers' streams, a committed VP9 mp4 and a
  Motion-JPEG stream: ``len`` is cv2's CAP_PROP_FRAME_COUNT, Y, U and V
  equal ffmpeg's planes of the flat file (one decode a sample on a
  sequential read), and every ``load_frame(k)`` up to the count, in order
  and shuffled, equals cap4d_tpu's byte for byte, an ``IndexError`` where
  it raises one. The RGB frames of all layouts hash to the pin
  ``chip_smoke.py`` holds on the card.
- ``tfdt`` against the summed durations (a gap, an overlap, every fragment
  at 0): ffmpeg's rule, which the port copies.
- Edit lists of several media edits on flat files: the four of
  ``container_writer.EDIT_LISTS``, partial durations, ``media_rate`` 0 and
  2, empty edits in the middle, only empty edits; on B streams where
  ffmpeg's edited index is a plain timeline, and the refusal where it is
  not (cv2's seek there departs from its read); in a fragmented file
  (ffmpeg applies only the time offset).
"""

import contextlib
import hashlib
import io
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from cap4d_torch.data import mp4
from cap4d_torch.data.utils import VideoFrameReader, load_frame
from cap4d_torch.utils import container_writer as cw
from cap4d_torch.utils import h264_writer as hw
from cap4d_torch.utils import mpeg4_writer as mw
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_torch.utils import vp9_writer as vw
from cap4d_tpu.data import utils as ju
from tests.test_torch_containers import _counted, _cv2_count, cv2_sequential, ffmpeg_decode
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

def _quiet(fn, *args, **kw):
    """``fn``'s result, or the class of the IndexError or ValueError it
    raised; load_frame's warnings swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            return fn(*args, **kw)
        except (IndexError, ValueError) as e:
            return type(e)


def _assert_reads_as_cv2(path, what, shuffled=True):
    """len is cv2's count; load_frame(k) for every k up to the count (in
    order, then shuffled) equals cap4d_tpu's, an exception where it raises
    one; the reader's frames in order equal cv2's sequential read. Returns
    the port's frames."""
    n = _cv2_count(path)
    reader = VideoFrameReader(path, device="cpu")
    assert len(reader) == n, f"{what}: len {len(reader)}, cv2 counts {n}"
    ks = list(range(n + 1))
    if shuffled:
        ks += [int(k) for k in np.random.default_rng(n).permutation(n + 1)]
    for k in ks:
        want, got = _quiet(ju.load_frame, path, k), _quiet(load_frame, path, k, device="cpu")
        if isinstance(want, type):
            assert got is want, f"{what} frame {k}: cap4d_tpu raises {want}, the port {got}"
        else:
            assert not isinstance(got, type), f"{what} frame {k}: the port raises {got}"
            np.testing.assert_array_equal(got, want, err_msg=f"{what} frame {k}")
    seq = cv2_sequential(path)
    frames = [reader[k] for k in range(len(reader._order))]
    assert len(frames) == len(seq), f"{what}: {len(frames)} frames, cv2 reads {len(seq)}"
    for k, (a, b) in enumerate(zip(frames, seq)):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: cv2's sequential read, frame {k}")
    return frames


# ------------------------------------------------------------- streams --

def fragment_streams(d: Path) -> dict:
    """container_writer's streams, the Motion-JPEG one chip_smoke.py's
    test images."""
    import chip_smoke

    return cw.fragment_streams(d, [chip_smoke.test_image(48, 64, k) for k in range(12)])


def _planes(name: str, s: cw.Stream):
    """ffmpeg's planes of the flat stream, in presentation order."""
    if name == "h264_b":
        params = b"".join(s.avc.sps) + b"".join(s.avc.pps)
        return ffmpeg_decode("h264", [(params if i == 0 else b"") + mp4.annexb(x, 4)
                                      for i, x in enumerate(s.samples)])
    if name == "mpeg4_b":
        return ffmpeg_decode("mpeg4", [(s.dsi if i == 0 else b"") + x
                                       for i, x in enumerate(s.samples)])
    return ffmpeg_decode(name, s.samples)


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{name: (flat path, Stream, ffmpeg's planes)}; the planes hash to the
    writers' pins."""
    d = tmp_path_factory.mktemp("fragment_streams")
    out = {}
    for name, (path, s) in fragment_streams(d).items():
        out[name] = (path, s, _planes(name, s))
    luma = hashlib.sha256(b"".join(p[0].tobytes() for p in out["h264_b"][2])).hexdigest()
    assert luma == hw.PINNED_B_LUMA_SHA256["cavlc", 1, 128, 96, 16]
    assert mw.planes_sha256(out["mpeg4_b"][2]) == mw.PINNED_SHA256["advanced"]
    assert (len(out["vp9"][2]), mw.planes_sha256(out["vp9"][2])) == vw.PINNED_SHA256["writer"]
    return out


# ------------------------------------------------------------ layouts --

@pytest.mark.parametrize("layout", list(cw.FRAGMENTED_LAYOUTS))
@pytest.mark.parametrize("stream", ["h264_b", "mpeg4_b", "vp9", "mjpeg"])
def test_fragmented_layout_reads_as_cv2(streams, tmp_path, stream, layout):
    """len, every load_frame in order and shuffled and the sequential read
    equal cv2's; the planes equal ffmpeg's of the flat file, one decode a
    sample on a sequential read."""
    flat, s, ref = streams[stream]
    path = tmp_path / f"{stream}_{layout}.mp4"
    cw.write_fragmented_mp4(path, s, **cw.FRAGMENTED_LAYOUTS[layout])
    _assert_reads_as_cv2(path, f"{stream} {layout}")
    reader = VideoFrameReader(path, device="cpu")
    flat_frame = VideoFrameReader(flat, device="cpu")._frame_of
    calls = _counted(reader)
    for k in range(len(reader._order)):
        want = ref[flat_frame[int(reader._order[k])]]
        for name, p, q in zip("YUV", reader.planes(k), want):
            np.testing.assert_array_equal(p, q, err_msg=f"{stream} {layout} frame {k} {name}")
    assert calls[0] == len(reader.track), (calls[0], len(reader.track))


def test_layouts_hash_to_the_chip_pin(streams, tmp_path):
    """The port's RGB frames of every layout of every stream hash to
    ``container_writer.PINNED_FRAGMENTED_RGB_SHA256``, which chip_smoke.py
    holds on the card (the frames are cv2's: the test above)."""
    for stream, (_, s, _) in streams.items():
        readers = []
        for layout, kw in cw.FRAGMENTED_LAYOUTS.items():
            path = tmp_path / f"{stream}_{layout}.mp4"
            cw.write_fragmented_mp4(path, s, **kw)
            readers.append(VideoFrameReader(path, device="cpu"))
        assert cw.layouts_sha256(readers) == cw.PINNED_FRAGMENTED_RGB_SHA256[stream], stream


@pytest.mark.parametrize("case", ["gap", "overlap", "all_at_zero", "overlap_no_tfdt_dash"])
def test_tfdt_against_summed_durations(streams, tmp_path, case):
    """tfdt wins over the durations summed so far, as ffmpeg reads it: a gap
    lengthens cv2's count, a sample whose time is not past the index entry
    before its run is decoded and gives no frame (all of a fragment at time
    0: only the first fragment shows); without tfdt, a DASH segment's sidx
    times it."""
    _, s, _ = streams["mpeg4_b"]
    kw = {"gap": dict(tfdt_frames=[0, 14]), "overlap": dict(tfdt_frames=[0, 10]),
          "all_at_zero": dict(tfdt_frames=[0, 0]),
          "overlap_no_tfdt_dash": dict(fragment=5, dash=True, tfdt=None)}[case]
    path = tmp_path / f"{case}.mp4"
    cw.write_fragmented_mp4(path, s, **kw)
    frames = _assert_reads_as_cv2(path, case)
    assert len(frames) == {"gap": 20, "overlap": 18, "all_at_zero": 12,
                           "overlap_no_tfdt_dash": 20}[case]


def test_sample_flags_as_ffmpeg_reads_them(streams, tmp_path):
    """A sample is a key frame unless its flags set sample_is_non_sync_sample
    or sample_depends_on 1; first-sample flags override the defaults of
    trex and tfhd; the port's sync flags equal the flat file's stss."""
    flat, s, _ = streams["mpeg4_b"]
    want = mp4.read_track(flat).sync
    for non_sync in (0x01010000, 0x00010000, 0x01000000):
        for defaults in ("trex", "tfhd", "sample"):
            path = tmp_path / f"flags_{non_sync:x}_{defaults}.mp4"
            cw.write_fragmented_mp4(path, s, defaults=defaults, fragment=7,
                                    non_sync_flags=non_sync)
            np.testing.assert_array_equal(mp4.read_track(path).sync, want)
    # a run whose flags say every sample is a key frame: ffmpeg seeks to each
    cw.write_fragmented_mp4(tmp_path / "gop.mp4", s)
    data = bytearray((tmp_path / "gop.mp4").read_bytes())
    at = data.index(b"trex") + 4 + 20
    struct.pack_into(">I", data, at, cw.SYNC_FLAGS)
    (tmp_path / "all_sync.mp4").write_bytes(bytes(data))
    assert mp4.read_track(tmp_path / "all_sync.mp4").sync.all()


def test_malformed_fragments_raise(streams, tmp_path):
    """A trun whose samples lie past the end of the file (cv2 reads nothing
    from it), a traf of a track without trex and a trun that lists more
    samples than it holds raise ValueError naming them."""
    _, s, _ = streams["mjpeg"]
    path = tmp_path / "one.mp4"
    cw.write_fragmented_mp4(path, s, fragment=len(s.samples))
    data = bytearray(path.read_bytes())
    trun = data.index(b"trun") + 4
    bad = bytearray(data)
    struct.pack_into(">i", bad, trun + 8, len(data) + 1000)     # the data offset
    (tmp_path / "past.mp4").write_bytes(bytes(bad))
    assert cv2_sequential(tmp_path / "past.mp4") == []
    with pytest.raises(ValueError, match="no sample of the video track lies in the file"):
        mp4.read_track(tmp_path / "past.mp4")
    bad = bytearray(data)
    struct.pack_into(">I", bad, data.index(b"tfhd") + 8, 7)     # track_ID
    (tmp_path / "trex.mp4").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="track 7, which has no trex"):
        mp4.read_track(tmp_path / "trex.mp4")
    bad = bytearray(data)
    struct.pack_into(">I", bad, trun + 4, 1 << 20)               # sample_count
    (tmp_path / "count.mp4").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="trun lists 1048576 samples but holds fewer"):
        mp4.read_track(tmp_path / "count.mp4")


# --------------------------------------------------------- edit lists --

@pytest.fixture(scope="module")
def sync_stream(tmp_path_factory):
    """30 Motion-JPEG samples (every one a sync sample), 48x32."""
    import chip_smoke

    d = tmp_path_factory.mktemp("edits")
    sa.write_mjpeg_video(d / "flat.mov", [chip_smoke.test_image(32, 48, k) for k in range(30)])
    return cw.stream_of_mp4(d / "flat.mov")


_write_edited = cw.write_edited_mp4


@pytest.mark.parametrize("name", list(cw.EDIT_LISTS))
def test_edit_lists_read_as_cv2(sync_stream, tmp_path, name):
    """The four edit lists of several media edits: cv2's frames (the edits'
    samples one after another, repeated or swapped), cv2's count (all the
    samples) and IndexError past the edited frames, below the count; the
    frames hash to the pin chip_smoke.py holds on the card."""
    path = tmp_path / f"{name}.mov"
    _write_edited(path, sync_stream, cw.EDIT_LISTS[name])
    frames = _assert_reads_as_cv2(path, name)
    assert len(VideoFrameReader(path, device="cpu")) == 30
    assert len(frames) == sum(n for t, n in cw.EDIT_LISTS[name] if t >= 0)
    assert (len(frames), cw.rgb_sha256(frames)) == cw.PINNED_EDIT_RGB_SHA256[name]


@pytest.mark.parametrize("edits", [
    [(0, 5.5)], [(0.5, 5)], [(2.49, 3), (7, 2.25)],   # durations and times off the frame grid
    [(5, 30)], [(0, 20)],                              # one edit: samples before and after it go
    [(0, 0)], [(-1, 3), (-1, 2)],                      # an empty edit, only empty edits: nothing
    [(0, 10, 2)], [(3, 10, 0)],                        # media_rate 2 and 0 read as 1
    [(5, 5), (-1, 3), (20, 5)],                        # an empty edit after a media edit
])
def test_edit_durations_rates_and_empty_edits(sync_stream, tmp_path, edits):
    """ffmpeg applies each edit's duration (a frame shows while its time is
    below the edit's end), reads every media_rate as 1, and reads an empty
    edit after a media edit as an edit at media time -1; the port reads
    each as cv2 does."""
    path = tmp_path / "edit.mov"
    _write_edited(path, sync_stream, edits)
    _assert_reads_as_cv2(path, str(edits), shuffled=False)


@pytest.mark.parametrize("stream,edits", [
    ("mpeg4_b", [(3, 12)]),                    # a trim from a B-VOP on
    ("h264_b", [(5, 8)]),
    ("mpeg4_b", [(14, 7), (12, 1)]),           # two edits, the later first
    ("mpeg4_b", [(15, 5), (12, 1)]),
])
def test_b_stream_edits_read_as_cv2(streams, tmp_path, stream, edits):
    """Edits of streams that reorder whose edited index is a plain timeline
    (a trim, and edits whose decodes do not overlap): frame k is the k-th
    edited frame, decoded from the sync sample before its edit, as cv2
    reads it."""
    path = tmp_path / "edit.mp4"
    _write_edited(path, streams[stream][1], edits)
    _assert_reads_as_cv2(path, f"{stream} {edits}")


@pytest.mark.parametrize("stream,edits", [("mpeg4_b", [(1, 5), (9, 6)]),
                                          ("h264_b", [(2, 3), (-1, 2), (12, 3)])])
def test_edits_cv2_cannot_seek_raise(streams, tmp_path, stream, edits):
    """Edits whose edited index is no plain timeline (the second edit's
    decode from its sync sample overlaps the first's): cv2's seek departs
    from its own sequential read, so the port raises ValueError naming the
    edit list."""
    path = tmp_path / "edit.mp4"
    _write_edited(path, streams[stream][1], edits)
    seq = cv2_sequential(path)
    seeks = [_quiet(ju.load_frame, path, k) for k in range(len(seq))]
    assert any(isinstance(f, type) or not np.array_equal(f, g) for f, g in zip(seeks, seq))
    with pytest.raises(ValueError, match="edit list of .* media edits whose edited index"):
        mp4.read_track(path)


def test_fragmented_edit_list(streams, tmp_path):
    """In a fragmented file ffmpeg takes only the first media edit's time
    offset from the edit list: every sample shows, as cv2 reads it."""
    _, s, _ = streams["mpeg4_b"]
    path = tmp_path / "edits.mp4"
    cw.write_fragmented_mp4(path, s, edits=cw.FRAGMENTED_EDITS)
    frames = _assert_reads_as_cv2(path, "fragmented edits")
    assert len(frames) == len(s.samples)
    assert (len(frames), cw.rgb_sha256(frames)) == cw.PINNED_EDIT_RGB_SHA256["fragmented"]
