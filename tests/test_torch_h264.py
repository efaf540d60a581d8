"""The port's H.264 decoder (``cap4d_torch/runtime/h264.cpp`` through
``runtime/h264.py`` and ``VideoFrameReader``) against ffmpeg (cv2) and
cap4d_tpu's cv2 reader, on streams of seeded random syntax written by
``cap4d_torch/utils/h264_writer.py`` (neither machine has an H.264 encoder).

- Luma: with ``CAP_PROP_CONVERT_RGB`` 0, ``cv2.VideoCapture.read`` returns
  ffmpeg's decoded Y plane as it is; the port's must equal it bit for bit,
  every frame, read in a shuffled order (each read a seek: decode from the
  last sync sample, or on from where the decoder stands).
- RGB, so chroma: ``load_frame`` against cap4d_tpu's ``load_frame`` (cv2's
  decode and swscale conversion) bit for bit, every frame, shuffled.
  ``nv12_to_rgb`` does swscale's fixed-point arithmetic, and every
  coefficient is above 1, so a chroma sample off by one moves its 2x2
  pixels unless they clip; the same holds for the VUI's signals (BT.709
  and BT.601, limited and full range).
- Exact: the I_PCM + P_Skip stream of ``synthetic_assets.write_h264_mp4``
  decodes to the planes it was written from (an oracle independent of
  ffmpeg that also covers chroma).
"""

import hashlib
import subprocess
import sys
import textwrap

import cv2
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
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)
from tests.test_torch_video import NV12_MAX, NV12_MEAN

N_FRAMES = 12
# (entropy, seed, width, height): together they use every tool the decoder
# takes (test_streams_cover_the_tools); 110x74 is a cropped odd-macroblock size
STREAMS = [("cavlc", 1, 128, 96), ("cavlc", 2, 110, 74), ("cavlc", 3, 128, 96),
           ("cabac", 1, 128, 96), ("cabac", 2, 110, 74), ("cabac", 3, 128, 96)]


def ffmpeg_luma(path):
    """ffmpeg's Y planes of every frame, in presentation order."""
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


def luma_sha256(planes) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes() for p in planes)).hexdigest()


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{(entropy, seed): (path, writer stats, ffmpeg's luma)}."""
    d = tmp_path_factory.mktemp("h264")
    out = {}
    for entropy, seed, w, h in STREAMS:
        path = d / f"{entropy}_{seed}.mp4"
        stats = hw.write_h264_syntax_mp4(path, w, h, N_FRAMES, seed, entropy)
        out[entropy, seed] = (path, stats, ffmpeg_luma(path))
    return out


@pytest.mark.parametrize("entropy,seed,w,h", STREAMS)
def test_luma_matches_ffmpeg_bit_for_bit(streams, entropy, seed, w, h):
    path, _, ref = streams[entropy, seed]
    assert len(ref) == N_FRAMES
    reader = VideoFrameReader(path, device="cpu")
    assert len(reader) == N_FRAMES
    for k in np.random.default_rng(seed).permutation(N_FRAMES):
        y = reader.h264_planes(int(k))[0]
        assert y.shape == (h, w) and ref[k].shape == (h, w)
        np.testing.assert_array_equal(y, ref[k], err_msg=f"{entropy} seed {seed} frame {k}")


def test_streams_cover_the_tools(streams):
    """The streams above use, together: P slices with >= 2 active
    references, list modifications, MMCO long-term references, 8x8
    transforms under explicit scaling matrices, explicit weights, I_PCM in
    CABAC slices, several slices a picture, deblocking idc 0 and 2 with
    non-zero offsets, a cropped size, CAVLC level escapes and UEG0 suffixes."""
    stats = {key: v[1] for key, v in streams.items()}
    total = lambda name: sum(s[name] for s in stats.values())  # noqa: E731
    assert total("p_slices_2refs") > 0 and total("mods") > 0 and total("weighted_p") > 0
    assert total("t8_with_matrix") > 0 and total("long_term") > 0
    assert any({3, 6} & set(s["mmco"]) for s in stats.values())
    assert sum(s["mb"]["pcm"] for (e, _), s in stats.items() if e == "cabac") > 0
    assert max(s["slices_max"] for s in stats.values()) >= 2
    assert {0, 2} <= set().union(*(s["deblock"] for s in stats.values()))
    assert any(s["cropped"] for s in stats.values())
    for entropy in ("cavlc", "cabac"):
        assert sum(s["mb"]["escapes"] for (e, _), s in stats.items() if e == entropy) > 0
        kinds = {k for (e, _), s in stats.items() if e == entropy for k in s["frames"]}
        assert kinds == {"idr", "i", "p", "p_nonref"}, kinds


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_load_frame_rgb_matches_jax(streams, entropy):
    """RGB frames of ``load_frame`` (a cached reader; reads out of order)
    equal cap4d_tpu's cv2 reader's on every frame: the exact check of the
    port's chroma against ffmpeg's."""
    for (e, seed), (path, _, _) in streams.items():
        if e != entropy:
            continue
        for k in np.random.default_rng(seed + 10).permutation(N_FRAMES):
            port = load_frame(path, int(k), device="cpu")
            jax = ju.load_frame(path, int(k))
            assert port.shape == jax.shape and port.dtype == np.uint8
            np.testing.assert_array_equal(port, jax, err_msg=f"{entropy} seed {seed} frame {k}")


def test_pcm_stream_decodes_to_the_written_frames(tmp_path):
    """The I_PCM + P_Skip stream: Y, U and V equal the frames it was written
    from, read in a shuffled order; the RGB is their conversion."""
    path = tmp_path / "pcm.mp4"
    frames = sa.write_h264_mp4(path, 12, 110, 74, gop=4)
    reader = VideoFrameReader(path)                  # no device: decodes on the host
    for k in np.random.default_rng(0).permutation(12):
        for got, want in zip(reader.h264_planes(int(k)), frames[k]):
            np.testing.assert_array_equal(got, want)
        y, u, v = (torch.from_numpy(p) for p in frames[k])
        np.testing.assert_array_equal(reader[int(k)], nv12_to_rgb(y, torch.stack([u, v], -1)))


def test_vui_colour_signal_follows_cv2(tmp_path):
    """Streams whose VUI signals BT.709 in full and in limited range, BT.601
    in full range, the FCC's and SMPTE 240M's matrices: cv2 converts with
    the signalled range and matrix, and so does the port, bit for bit; a
    limited-range BT.601 conversion of the same planes is off."""
    for entropy, seed, w, h, full_range, matrix, name in [
            ("cavlc", 7, 64, 48, True, 1, "bt709"), ("cabac", 8, 110, 74, False, 1, "bt709"),
            ("cabac", 9, 110, 74, True, 6, "bt601"), ("cavlc", 10, 64, 48, False, 4, "fcc"),
            ("cabac", 11, 64, 48, True, 7, "smpte240m")]:
        path = tmp_path / f"vui_{seed}.mp4"
        hw.write_h264_syntax_mp4(path, w, h, 6, seed, entropy, full_range=full_range,
                                 matrix=matrix)
        cap = cv2.VideoCapture(str(path))
        reader = VideoFrameReader(path, device="cpu")
        assert reader._h264.full_range == full_range and reader._h264.matrix == name
        wrong = 0.0
        for k in range(6):
            ok, bgr = cap.read()
            assert ok
            ref = bgr[..., ::-1]
            np.testing.assert_array_equal(reader[k], ref, err_msg=f"{path.name} frame {k}")
            y, u, v = (torch.from_numpy(p) for p in reader.h264_planes(k))
            wrong = max(wrong, float(np.abs(nv12_to_rgb(y, torch.stack([u, v], -1))
                                            - ref.astype(int)).mean()))
        cap.release()
        # the FCC's Kr, Kb lie within 0.004 of BT.601's: off, but by little
        assert wrong > (0.05 if name == "fcc" else 2), (path.name, wrong)


@pytest.mark.parametrize("tool", sorted(hw.REFUSALS))
def test_refused_tools_raise_value_error_naming_them(tmp_path, tool):
    path = tmp_path / f"{tool}.mp4"
    phrase = hw.write_h264_refusal_mp4(path, tool)
    reader = VideoFrameReader(path, device="cpu")
    with pytest.raises(ValueError, match=f"{path.name} frame .*{phrase}"):
        for k in range(len(reader)):
            reader[k]


def test_a_missing_reference_raises(streams, tmp_path):
    """A P picture decoded without its references (no reset to a sync
    sample), and a B picture decoded without its list-1 anchor, name the
    missing reference; the decoder then starts over. The B picture after
    the IDR alone misses a frame_num (the anchor is a reference picture);
    after a reset at the anchor, as a read from an open GOP's I picture
    starts, it misses the IDR, which its reference index 1 names."""
    path, stats, ref = streams["cavlc", 1]
    t = mp4.read_track(path)
    k = stats["frames"].index("p")
    dec = H264Decoder(t.avc, str(path))
    with pytest.raises(ValueError, match="reference the DPB does not hold"):
        dec.decode(t.sample(k), f"frame {k}")
    np.testing.assert_array_equal(dec.decode(t.sample(0))[0], ref[0])

    path = tmp_path / "b.mp4"
    stats = hw.write_h264_syntax_mp4(path, 128, 96, 6, 1, "cavlc", b_frames=True)
    pics = stats["pictures"]
    assert pics[1]["kind"] == "i" and pics[2]["kind"] == "b" and pics[2]["ref_max"] >= 1
    assert pics[2]["display"] < pics[1]["display"]              # sample 1 is its list-1 anchor
    t = mp4.read_track(path)
    dec = H264Decoder(t.avc, str(path))
    first = dec.decode(t.sample(0))[0]
    with pytest.raises(ValueError, match="frame 2: a gap in frame_num .a picture is missing"):
        dec.decode(t.sample(2), "frame 2")
    dec.decode(t.sample(1))
    with pytest.raises(ValueError, match="frame 2: .*reference the DPB does not hold"):
        dec.decode(t.sample(2), "frame 2")
    np.testing.assert_array_equal(dec.decode(t.sample(0))[0], first)


_FUZZ = textwrap.dedent("""
    import random, sys
    from hypothesis import HealthCheck, given, settings, strategies as st
    from cap4d_torch.data import mp4
    from cap4d_torch.runtime.h264 import H264Decoder

    t = mp4.read_track(sys.argv[1])
    samples = [t.sample(i) for i in range(len(t))]

    @settings(max_examples=int(sys.argv[2]), deadline=None, derandomize=True, database=None,
              suppress_health_check=list(HealthCheck))
    @given(st.integers(0, len(samples) - 1), st.integers(0, 2**32 - 1),
           st.sampled_from(["cut", "flip", "both"]))
    def fuzz(k, seed, how):
        rng = random.Random(seed)
        dec = H264Decoder(t.avc)
        for j in range(k):
            dec.decode(samples[j])
        s = bytearray(samples[k])
        if how != "cut":
            for _ in range(rng.randint(1, 8)):
                i = rng.randrange(len(s) * 8)
                s[i // 8] ^= 1 << (i % 8)
        if how != "flip":
            s = s[:rng.randrange(len(s))]
        try:
            dec.decode(bytes(s))
        except ValueError:
            pass

    fuzz()
    print("fuzz ok")
""")


@pytest.mark.parametrize("entropy", ["cavlc", "cabac", "cabac_b"])
def test_corrupt_samples_raise_or_decode_never_crash(streams, entropy, tmp_path):
    """Truncated and bit-flipped samples (hypothesis, in a subprocess so
    that a crash fails this test instead of killing the worker): each
    decodes to a picture or raises ValueError, never a signal; "cabac_b" a
    stream with B pictures (POC type 1, temporal direct)."""
    if entropy == "cabac_b":
        path = tmp_path / "b.mp4"
        hw.write_h264_syntax_mp4(path, 128, 96, 12, 5, "cabac", b_frames=True)
    else:
        path = streams[entropy, 3][0]
    proc = subprocess.run([sys.executable, "-c", _FUZZ, str(path), "150"], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and "fuzz ok" in proc.stdout, (proc.returncode, proc.stderr[-2000:])


@pytest.mark.parametrize("entropy,seed,w,h,n,b_frames",
                         [(*key, False) for key in sorted(hw.PINNED_LUMA_SHA256)]
                         + [(*key, True) for key in sorted(hw.PINNED_B_LUMA_SHA256)])
def test_pinned_hashes_are_ffmpegs(tmp_path, entropy, seed, w, h, n, b_frames):
    """The SHA-256 of the concatenated luma that chip_smoke.py checks on the
    card's machine (which has no cv2) is ffmpeg's decode, and the port's;
    with B pictures too."""
    path = tmp_path / "pinned.mp4"
    hw.write_h264_syntax_mp4(path, w, h, n, seed, entropy, b_frames=b_frames)
    want = (hw.PINNED_B_LUMA_SHA256 if b_frames else hw.PINNED_LUMA_SHA256)[entropy, seed, w, h, n]
    assert luma_sha256(ffmpeg_luma(path)) == want
    reader = VideoFrameReader(path, device="cpu")
    assert luma_sha256(reader.h264_planes(k)[0] for k in range(n)) == want


def _rgb_to_yuv420(rgb):
    """BT.601 limited-range planes of an RGB image (chroma averaged 2x2)."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    cb = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    cr = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    sub = lambda c: c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean((1, 3))  # noqa: E731
    return tuple(np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in (y, sub(cb), sub(cr)))


def test_reference_frame_set_from_h264_video_matches_jax(tmp_path):
    """Stage 1's reference loader on an H.264 video (``images/cam0.mp4``,
    reference frame 1) through both packages' build_frame_set."""
    from cap4d_torch.data import datasets as tdata
    from cap4d_torch.flame import compute as tcompute
    from cap4d_torch.runtime import loader as tl
    from cap4d_tpu.data import datasets as jdata
    from cap4d_tpu.flame import compute as jcompute

    flame_dir = sa.make_asset_dir(tmp_path)
    ref_dir = sa.make_reference_dir(tmp_path, resolution=96, n_timesteps=3)
    pngs = sorted((ref_dir / "images" / "cam0").glob("*.png"))
    planes = [_rgb_to_yuv420(tl.decode_image(p)) for p in pngs]
    sa.write_h264_mp4(ref_dir / "images" / "cam0.mp4", 3, 96, 96, gop=2, frames=planes[::2])
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
    d = np.abs(t.images - j.images) * 127.5
    assert np.abs(t.images).max() > 0.1 and d.max() <= NV12_MAX and d.mean() <= NV12_MEAN
    np.testing.assert_allclose(t.out_crop_mask, j.out_crop_mask, atol=1e-6)
