"""Video input of the port (``cap4d_torch/data/mp4.py``, the runtime's
in-memory decode, ``VideoFrameReader`` / ``load_frame``, ``nv12_to_rgb``)
against cap4d_tpu's cv2 reader and cv2 itself, on files that cv2 or the
port's own writers (``utils/synthetic_assets.py``) write into ``tmp_path``.

Exact, no tolerance (cv2 5.0.0 on ffmpeg):
- Motion-JPEG: the port's video samples decode to the planes of ffmpeg's
  mjpeg decoder (libavcodec's simple IDCT, ``runtime/loader.py``'s
  ``decode_jpeg_planes``) and convert as swscale converts ``yuvj420p``
  (full-range BT.601), so every frame equals cap4d_tpu's ``load_frame``
  byte for byte (the reference frame set too); still images keep
  libjpeg's decode, as ``cv2.imread`` does.
- ``nv12_to_rgb`` (BT.601, limited range, chroma repeated over 2x2, in
  swscale's fixed point) against cv2's decode of the port's H.264 stream:
  bit for bit. A wrong range gives a mean of 5.9, a wrong matrix 7.9.
  (H.264 decoding itself is tested in ``test_torch_h264.py``.)
"""

import struct

import cv2
import numpy as np
import pytest
import torch

from cap4d_torch.data import mp4
from cap4d_torch.data.utils import VideoFrameReader, load_frame
from cap4d_torch.runtime import loader as tl
from cap4d_torch.runtime.nvdec import nv12_to_rgb, yuv_to_rgb
from cap4d_torch.utils import container_writer as cw
from cap4d_torch.utils import mpeg4_writer as mw
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_tpu.data import utils as ju
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

H, W = 96, 128
NV12_MAX, NV12_MEAN = 3, 1.0


def _frames(n, h=H, w=W, seed=0):
    """``n`` RGB frames of smooth moving content with mild noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    tint = np.array([1.0, 0.5, -0.7])
    return [np.clip(128 + 90 * np.sin(x / 9 + 0.6 * k + y / 23)[..., None] * tint
                    + rng.normal(0, 3, (h, w, 3)), 0, 255).astype(np.uint8) for k in range(n)]


def _cv2_write(path, fourcc, frames, fps=24):
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                         (frames[0].shape[1], frames[0].shape[0]))
    assert wr.isOpened(), fourcc
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()
    return path


def _vp9_key(sample: bytes) -> bool:
    """Whether a VP9 sample's first frame is a key frame (profile 0/1/2
    uncompressed header: frame_marker, profile bits, show_existing_frame,
    frame_type 0)."""
    b = sample[0]
    return (b >> 6) == 2 and not (b >> 3) & 1 and not (b >> 2) & 1


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """{label: (path, the frames written)}: Motion-JPEG .mp4 and .mov
    written by cv2 and by the port, VP9 .mp4 written by cv2, the port's
    H.264 (frames as YUV planes)."""
    d = tmp_path_factory.mktemp("videos")
    frames = _frames(7)
    out = {label: (_cv2_write(d / name, "MJPG", frames), frames)
           for label, name in (("mjpeg_mp4", "a.mp4"), ("mjpeg_mov", "a.mov"))}
    for label, name in (("port_mjpeg_mp4", "p.mp4"), ("port_mjpeg_mov", "p.mov")):
        sa.write_mjpeg_video(d / name, frames)
        out[label] = (d / name, frames)
    out["vp9"] = (_cv2_write(d / "v.mp4", "vp09", _frames(12, seed=1)), None)
    out["mpeg4"] = (_cv2_write(d / "m.mp4", "mp4v", _frames(14, seed=2)), None)
    out["h264"] = (d / "h.mp4", sa.write_h264_mp4(d / "h.mp4", 12, W, H, gop=4))
    return out


@pytest.mark.parametrize("label,codec,fourcc", [
    ("mjpeg_mp4", "mjpeg", "mp4v"), ("mjpeg_mov", "mjpeg", "jpeg"),
    ("port_mjpeg_mp4", "mjpeg", "mp4v"), ("port_mjpeg_mov", "mjpeg", "jpeg"),
    ("vp9", "vp9", "vp09"), ("h264", "h264", "avc1"), ("mpeg4", "mpeg4", "mp4v")])
def test_demuxer_frame_count_and_sync_table(videos, label, codec, fourcc):
    """Frame count against cv2's CAP_PROP_FRAME_COUNT; the sync table
    against the samples' own frame types; presentation order is decode
    order in these files."""
    path, _ = videos[label]
    t = mp4.read_track(path)
    assert (t.codec, t.fourcc, t.width, t.height) == (codec, fourcc, W, H)
    assert len(t) == int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))
    np.testing.assert_array_equal(t.order, np.arange(len(t)))
    samples = [t.sample(i) for i in range(len(t))]
    if codec == "mjpeg":
        assert t.sync.all() and all(s[:2] == b"\xff\xd8" for s in samples)
    elif codec == "vp9":
        np.testing.assert_array_equal(t.sync, [_vp9_key(s) for s in samples])
        assert t.sync[0] and (t.vpc.profile, t.vpc.bit_depth) == (0, 8)
    elif codec == "mpeg4":   # the sync samples are the I-VOPs (vop_coding_type 0)
        types = [s[s.index(b"\0\0\1\xb6") + 4] >> 6 for s in samples]
        np.testing.assert_array_equal(t.sync, [v == 0 for v in types])
        assert list(np.flatnonzero(t.sync)) == [0, 12] and set(types) == {0, 1}
    else:
        types = [mp4.annexb(s, t.avc.length_size)[4] & 0x1F for s in samples]
        np.testing.assert_array_equal(t.sync, [k % 4 == 0 for k in range(12)])
        assert types == [5 if k % 4 == 0 else 1 for k in range(12)]


@pytest.mark.parametrize("length_size", [1, 2, 4])
def test_avcc_and_annexb(length_size):
    """avcC's parameter sets come out as Annex-B NAL units, and a sample of
    length-prefixed NALs is rewritten with start codes, for each NAL
    length size."""
    sps, pps = b"\x67\x42\xc0\x1e\xab", b"\x68\xce\x3c\x80"
    avcc = (bytes([1, 66, 0xC0, 30, 0xFC | (length_size - 1), 0xE1])
            + struct.pack(">H", len(sps)) + sps + bytes([1]) + struct.pack(">H", len(pps)) + pps)
    cfg = mp4.parse_avcc(avcc)
    assert cfg.sps == (b"\0\0\0\1" + sps,) and cfg.pps == (b"\0\0\0\1" + pps,)
    assert (cfg.length_size, cfg.profile, cfg.level) == (length_size, 66, 30)
    nals = [b"\x65" + bytes(range(1, 40)), b"\x06\x05\x01", b"\x41\x9a"]
    sample = b"".join(len(n).to_bytes(length_size, "big") + n for n in nals)
    assert mp4.annexb(sample, length_size) == b"".join(b"\0\0\0\1" + n for n in nals)
    with pytest.raises(ValueError, match="overruns"):
        mp4.annexb(sample[:-1], length_size)


def test_annexb_stream_decodes_as_the_mp4(videos, tmp_path):
    """The H.264 file's samples rewritten as an Annex-B elementary stream
    (SPS and PPS first, as a parser is fed) decode in cv2 to the same frames
    as the mp4."""
    path, _ = videos["h264"]
    t = mp4.read_track(path)
    raw = tmp_path / "h.h264"
    raw.write_bytes(b"".join(t.avc.sps + t.avc.pps) + b"".join(
        mp4.annexb(t.sample(i), t.avc.length_size) for i in range(len(t))))
    a, b = cv2.VideoCapture(str(raw)), cv2.VideoCapture(str(path))
    for k in range(len(t)):
        (ok_a, fa), (ok_b, fb) = a.read(), b.read()
        assert ok_a and ok_b, k
        np.testing.assert_array_equal(fa, fb)


def test_sample_tables_co64_chunks_and_ctts(tmp_path):
    """Offsets from multi-sample chunks and 64-bit chunk offsets, and
    presentation order from ctts (a B-frame-like reordering), on a file
    the port's writer makes and on a bare table."""
    frames = _frames(6, 32, 48)
    jpegs = []
    for k, f in enumerate(frames):
        tl.encode_jpeg(tmp_path / f"{k}.jpg", f)
        jpegs.append((tmp_path / f"{k}.jpg").read_bytes())
    # decode order D0..D5 shown as 0, 2, 1, 3, 5, 4
    pts_frames = [0, 2, 1, 3, 5, 4]
    ctts = [p - d + 1 for d, p in enumerate(pts_frames)]
    path = tmp_path / "reordered.mp4"
    # the edit starts at the first presentation time (ffmpeg's B-frame
    # delay): one at 0 would end before the last frame, which cv2 then drops
    sa.write_mp4(path, jpegs, sa.visual_sample_entry(b"jpeg", 48, 32), 48, 32, ctts=ctts,
                 per_chunk=4, co64=True, edit_start=1)
    t = mp4.read_track(path)
    np.testing.assert_array_equal(t.order, [0, 2, 1, 3, 5, 4])
    for d in range(6):
        assert t.sample(d) == jpegs[d]
    reader = VideoFrameReader(path, device="cpu")
    for k in range(6):
        y, u, v = (torch.from_numpy(x) for x in tl.MjpegDecoder().decode(jpegs[t.order[k]]))
        np.testing.assert_array_equal(reader[k], yuv_to_rgb(y, u, v, 32, 48, "bt601", True))
    # offsets above 4 GiB, chunks of 3, 3 and 1 samples
    sizes = np.array([10, 20, 30, 40, 50, 60, 70], np.int64)
    chunks = np.array([5 << 32, (5 << 32) + 1000, (6 << 32)], np.int64)
    np.testing.assert_array_equal(
        mp4.sample_offsets(sizes, chunks, np.array([[1, 3, 1], [3, 1, 1]]), "t"),
        [5 << 32, (5 << 32) + 10, (5 << 32) + 30, (5 << 32) + 1000, (5 << 32) + 1040,
         (5 << 32) + 1090, 6 << 32])
    with pytest.raises(ValueError, match="stsc and stco give 8 samples, stsz 7"):
        mp4.sample_offsets(sizes, chunks, np.array([[1, 3, 1], [3, 2, 1]]), "t")
    dts, pts = mp4.sample_times(np.array([[7, 100]]), np.array([[1, 0xFFFFFF9C], [6, 200]]),
                                7, "t")
    np.testing.assert_array_equal(pts - dts, [-100] + [200] * 6)


@pytest.mark.parametrize("shape", [None, (H, W), (H, W - 8), (H + 16, W)])
@pytest.mark.parametrize("kind", [".jpg", ".png"])
def test_decode_bytes_with_any_expected_shape(tmp_path, kind, shape):
    """A sample decodes to the same pixels as its file, whether the expected
    shape (a track's size) is right, wrong or not given."""
    path = tmp_path / f"f{kind}"
    cv2.imwrite(str(path), _frames(1)[0][..., ::-1])
    out = tl.decode_bytes(path.read_bytes(), "sample", shape)
    np.testing.assert_array_equal(out, tl.decode_image(path))
    assert out.shape == (H, W, 3)


@pytest.mark.parametrize("label", ["mjpeg_mp4", "mjpeg_mov", "port_mjpeg_mp4",
                                   "port_mjpeg_mov"])
def test_load_frame_mjpeg_matches_jax(videos, label):
    """The port's load_frame on a Motion-JPEG file equals cap4d_tpu's (cv2)
    byte for byte for every index, in order and shuffled, one past the end
    included (both warn and read the last frame); a sample decoded as a
    still image keeps libjpeg's decode (cv2.imdecode), which differs."""
    path, frames = videos[label]
    t = mp4.read_track(path)
    n = len(frames) + 1
    for k in list(range(n)) + [int(k) for k in np.random.default_rng(3).permutation(n)]:
        port = load_frame(path, k, device="cpu")
        ref = ju.load_frame(path, k)
        assert port.shape == ref.shape == (H, W, 3) and port.dtype == np.uint8
        np.testing.assert_array_equal(port, ref, err_msg=f"{label} frame {k}")
    sample = t.sample(0)
    still = cv2.imdecode(np.frombuffer(sample, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(tl.decode_bytes(sample, "sample 0"), still)
    assert not np.array_equal(load_frame(path, 0, device="cpu"), still)


def test_nv12_to_rgb_against_cv2_h264(videos):
    """nv12_to_rgb of the H.264 writer's known YUV equals cap4d_tpu's
    VideoFrameReader (cv2's h264 decoder) on that file, frames read in a
    shuffled order (random access); the wrong range or matrix is caught."""
    path, planes = videos["h264"]
    reader = ju.VideoFrameReader(path)
    assert len(reader) == len(planes) == 12
    for k in np.random.default_rng(0).permutation(12):
        y, u, v = (torch.from_numpy(p) for p in planes[k])
        uv = torch.stack([u, v], -1)
        ref = reader[int(k)].astype(int)
        np.testing.assert_array_equal(nv12_to_rgb(y, uv), ref, err_msg=f"frame {k}")
        assert np.abs(nv12_to_rgb(y, uv, full_range=True).astype(int) - ref).mean() > 4
        assert np.abs(nv12_to_rgb(y, uv, "bt709").astype(int) - ref).mean() > 4
    with pytest.raises(ValueError, match="does not fit"):
        nv12_to_rgb(y, uv[:-1])


@pytest.mark.parametrize("label,name", [("h264", "H.264"), ("vp9", "VP9")])
def test_h264_vp9_need_the_card(videos, label, name):
    """Neither needs the card any more: H.264 (``runtime/h264.py``) and VP9
    (``runtime/vp9.py``) decode on the host whatever the device, so
    ``load_frame`` on the CPU and a reader on the default device both
    decode the written frames: H.264 to the frames written, VP9 (cv2's
    ``vp09`` mp4) to cap4d_tpu's load_frame on every frame."""
    path, frames = videos[label]
    if label == "h264":
        rgb = load_frame(path, 0, device="cpu")
        reader = VideoFrameReader(path)
        np.testing.assert_array_equal(reader[0], rgb)
        for got, want in zip(reader.h264_planes(5), frames[5]):
            np.testing.assert_array_equal(got, want)
        return
    reader = VideoFrameReader(path)
    assert (reader.track.codec, len(reader)) == ("vp9", 12)
    for k in range(len(reader)):
        want = ju.load_frame(path, k)
        np.testing.assert_array_equal(load_frame(path, k, device="cpu"), want, err_msg=f"{name} {k}")
        np.testing.assert_array_equal(reader[k], want, err_msg=f"{name} frame {k}")


def test_demuxer_refusals(tmp_path, videos):
    """Codecs the port does not read name their four-character code (or,
    for an mp4v entry, its esds object type; an HEVC entry without hvcC
    names the missing box); a fragmented file whose only
    run lies past the end of the file (cv2 reads no frame of it either) and
    files without a video track raise."""
    mpeg2 = sa.visual_sample_entry(b"mp4v", 16, 16, mw.esds_box(b"", 0x61))
    sa.write_mp4(tmp_path / "p2.mp4", [b"\0" * 8], mpeg2, 16, 16)
    with pytest.raises(ValueError, match="esds object type 0x61 \\(MPEG-2 Main Profile video\\)"):
        mp4.read_track(tmp_path / "p2.mp4")
    hevc = sa.visual_sample_entry(b"hvc1", 16, 16)      # HEVC decodes: its hvcC is required
    sa.write_mp4(tmp_path / "h.mp4", [b"\0" * 8], hevc, 16, 16)
    with pytest.raises(ValueError, match="'hvc1' sample entry without hvcC"):
        VideoFrameReader(tmp_path / "h.mp4", device="cpu")
    av1 = sa.visual_sample_entry(b"av01", 16, 16)
    sa.write_mp4(tmp_path / "a.mp4", [b"\0" * 8], av1, 16, 16)
    with pytest.raises(ValueError, match="codec 'av01' is not supported"):
        VideoFrameReader(tmp_path / "a.mp4", device="cpu")
    data = videos["mjpeg_mp4"][0].read_bytes()
    s = cw.stream_of_mp4(videos["mjpeg_mp4"][0])
    cw.write_fragmented_mp4(tmp_path / "frag.mp4", s, fragment=len(s.samples))
    frag = bytearray((tmp_path / "frag.mp4").read_bytes())
    struct.pack_into(">i", frag, frag.index(b"trun") + 12, len(frag) + 4096)   # data offset
    (tmp_path / "frag.mp4").write_bytes(bytes(frag))
    cap = cv2.VideoCapture(str(tmp_path / "frag.mp4"))
    assert not cap.read()[0]
    cap.release()
    with pytest.raises(ValueError, match="no sample of the video track lies in the file"):
        mp4.read_track(tmp_path / "frag.mp4")
    (tmp_path / "audio.mp4").write_bytes(data.replace(b"vide", b"soun"))
    with pytest.raises(ValueError, match="no video track"):
        mp4.read_track(tmp_path / "audio.mp4")


@pytest.mark.parametrize("label", ["h264", "port_mjpeg_mp4"])
def test_demuxer_corrupt_moov_raises_value_error(tmp_path, videos, label):
    """Bytes of the moov box overwritten at random (fields set to 0, 1 or
    2^32 - 1 among them): the demuxer returns a table or raises ValueError,
    never another error, and never allocates past the file's size."""
    data = videos[label][0].read_bytes()
    moov = data.index(b"moov") - 4
    rng = np.random.default_rng(7)
    path = tmp_path / "corrupt.mp4"
    for _ in range(300):
        d = bytearray(data)
        for j in rng.integers(moov, len(d) - 4, rng.integers(1, 5)):
            d[j:j + 4] = struct.pack(">I", int(rng.choice([0, 1, 0xFFFFFFFF,
                                                           rng.integers(0, 1 << 32)])))
        path.write_bytes(bytes(d))
        try:
            t = mp4.read_track(path)
        except ValueError:
            continue
        assert len(t) <= len(data)


def test_reference_frame_set_from_mjpeg_video_matches_jax(tmp_path):
    """Stage 1's reference loader on a Motion-JPEG video (``images/cam0.mp4``,
    reference frame 1) through both packages' build_frame_set; and in the
    port, equal to the same frames written as a PNG directory (a white
    background directory sends both through the same path)."""
    from cap4d_torch.data import datasets as tdata
    from cap4d_torch.flame import compute as tcompute
    from cap4d_torch.utils.png import write_png
    from cap4d_tpu.data import datasets as jdata
    from cap4d_tpu.flame import compute as jcompute

    flame_dir = sa.make_asset_dir(tmp_path)
    ref_dir = sa.make_reference_dir(tmp_path, resolution=96, n_timesteps=3)
    pngs = sorted((ref_dir / "images" / "cam0").glob("*.png"))
    frames = [tl.decode_image(p) for p in pngs]
    video = _cv2_write(ref_dir / "images" / "cam0.mp4", "MJPG", frames)
    fit = dict(np.load(ref_dir / "fit.npz"))
    fit["camera_order"] = np.array(["cam0.mp4"])
    np.savez(ref_dir / "fit.npz", **fit)
    (ref_dir / "reference_images.json").write_text('[["cam0.mp4", 1]]')
    head = np.genfromtxt(flame_dir / "head_vertices.txt").astype(int)
    sets = []
    for data, comp in ((jdata, jcompute), (tdata, tcompute)):
        fm = comp.load_cap4d_flame_model(flame_dir, 150, 65, add_mouth=True)
        items, extr = data.load_reference_items(ref_dir)
        sets.append(data.build_frame_set(fm, items, head, extr, 64, is_reference=True))
    j, t = sets
    for k in range(3):
        np.testing.assert_array_equal(load_frame(video, k, device="cpu"),
                                      ju.load_frame(video, k), err_msg=f"frame {k}")
    assert np.abs(t.images).max() > 0.1
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_allclose(t.out_crop_mask, j.out_crop_mask, atol=1e-6)

    # the decoded frames as a PNG directory with a white background
    # directory: the same Python path, so the same floats
    reader = VideoFrameReader(video, device="cpu")
    decoded = [reader[k] for k in range(3)]
    video.rename(ref_dir / "cam0.mp4")
    for sub, imgs in (("images", decoded),
                      ("bg", [np.full_like(frames[0], 255)] * 3)):
        (ref_dir / sub / "cam0.mp4").mkdir(parents=True)
        for k, img in enumerate(imgs):
            write_png(ref_dir / sub / "cam0.mp4" / f"{k:05d}.png", img)
    fm = tcompute.load_cap4d_flame_model(flame_dir, 150, 65, add_mouth=True)
    items, extr = tdata.load_reference_items(ref_dir)
    from_pngs = tdata.build_frame_set(fm, items, head, extr, 64, is_reference=True)
    np.testing.assert_array_equal(from_pngs.images, t.images)
