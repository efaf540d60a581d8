"""Orientation as cv2 applies it, in the port's readers: an mp4/mov track's
display matrix and a Matroska track's projection roll
(``VideoTrack.rotation``, applied by ``VideoFrameReader``), and a still
frame's EXIF orientation in ``load_frame`` on a directory.

- Display matrix: an ``mp4v`` file written by cv2's VideoWriter, one of
  ``h264_writer``'s streams, a committed VP9 mp4 and a Motion-JPEG mp4,
  each with the ``tkhd`` and ``mvhd`` matrices of :data:`MATRICES`
  (identity, 90, 180 and 270 degrees, the two mirrors, 45 and 80 degrees,
  a 90-degree ``mvhd`` over an identity ``tkhd`` and over a 90-degree one,
  a fragmented file at 90): every frame equals cap4d_tpu's ``load_frame``
  bit for bit, shape included.
- Matroska: ``Video/Projection`` poses cv2 turns and those it ignores.
- EXIF: a JPEG with each of the eight orientations, at an even and an odd
  size, in both TIFF byte orders, against cap4d_tpu's ``load_frame`` (its
  ``FrameReader`` reads with ``cv2.imread``); malformed Exif blocks,
  Orientation 0 and 9, several APP1 segments and PNG ``eXIf`` chunks
  against ``cv2.imread``; the fused loader (``load_frame_native``) reads
  no EXIF in either package.
"""

import shutil
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from cap4d_torch.data import mp4
from cap4d_torch.data.utils import VideoFrameReader, exif_orientation, load_frame
from cap4d_torch.runtime import loader
from cap4d_torch.utils import container_writer as cw
from cap4d_torch.utils import h264_writer as hw
from cap4d_torch.utils import synthetic_assets as sa
from cap4d_tpu.data import utils as ju
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

VP9_MP4 = Path(__file__).parent / "data" / "vp9" / "odd.mp4"
U = mp4.UNITY_MATRIX
H_MIRROR = (-65536, 0, 0, 0, 65536, 0, 0, 0, 1 << 30)
V_MIRROR = (65536, 0, 0, 0, -65536, 0, 0, 0, 1 << 30)
# name -> (tkhd matrix, mvhd matrix, fragmented, cv2's clockwise turn)
MATRICES = {
    "identity": (U, U, False, 0), "rot90": (cw.rotation_matrix(90), U, False, 90),
    "rot180": (cw.rotation_matrix(180), U, False, 180),
    "rot270": (cw.rotation_matrix(270), U, False, 270),
    "h_mirror": (H_MIRROR, U, False, 180), "v_mirror": (V_MIRROR, U, False, 0),
    "rot45": (cw.rotation_matrix(45), U, False, 0), "rot80": (cw.rotation_matrix(80), U, False, 0),
    "mvhd90": (U, cw.rotation_matrix(90), False, 90),
    "mvhd90_tkhd90": (cw.rotation_matrix(90), cw.rotation_matrix(90), False, 180),
    "fragmented90": (cw.rotation_matrix(90), U, True, 90),
}


def _content(k, w, h):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 5 + k * 17) % 256, (y * 7 + 3 * k) % 256, (x * y) % 256], -1)
    img[: h // 3, : w // 4] = (250, 30, 30)           # a corner marks the orientation
    return img.astype(np.uint8)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{codec: path} of the four small flat mp4 files the matrices go into."""
    d = tmp_path_factory.mktemp("orientation")
    out = {}
    path = d / "mp4v.mp4"
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for k in range(4):
        wr.write(_content(k, 64, 48)[..., ::-1])
    wr.release()
    out["mp4v"] = path
    out["h264"] = d / "h264.mp4"
    hw.write_h264_syntax_mp4(out["h264"], 48, 32, 3, seed=3, entropy="cabac")
    out["vp9"] = d / "vp9.mp4"
    shutil.copy(VP9_MP4, out["vp9"])
    out["mjpeg"] = d / "mjpeg.mp4"
    sa.write_mjpeg_video(out["mjpeg"], [_content(k, 40, 24) for k in range(3)])
    return out


@pytest.mark.parametrize("case", list(MATRICES))
@pytest.mark.parametrize("codec", ["mp4v", "h264", "vp9", "mjpeg"])
def test_display_matrix_matches_cap4d_tpu(tmp_path, sources, codec, case):
    """Every frame of the file with the case's matrices equals cap4d_tpu's
    load_frame (cv2's read, rotated by it) bit for bit, shape included, and
    the track's rotation is cv2's CAP_PROP_ORIENTATION_META where cv2 turns
    the frame."""
    tkhd, mvhd, fragmented, turn = MATRICES[case]
    path = tmp_path / f"{codec}_{case}.mp4"
    if fragmented:
        cw.write_fragmented_mp4(path, cw.stream_of_mp4(sources[codec]), fragment=2)
    else:
        shutil.copy(sources[codec], path)
    cw.set_display_matrix(path, tkhd, mvhd)
    assert mp4.read_track(path).rotation == turn
    cap = cv2.VideoCapture(str(path))
    meta = cap.get(cv2.CAP_PROP_ORIENTATION_META)
    cap.release()
    assert meta % 360 == turn or (turn == 0 and meta % 90), (meta, turn)
    reader = VideoFrameReader(path, device="cpu")
    assert len(reader) == int(ju.VideoFrameReader(path).n)
    for k in range(len(reader)):
        try:
            want = ju.load_frame(path, k)
        except IndexError:                  # a sample of hidden frames only: cv2 reads fewer
            with pytest.raises(IndexError):
                reader[k]
            continue
        got = reader[k]
        assert got.shape == want.shape, (k, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{codec} {case} frame {k}")
        np.testing.assert_array_equal(load_frame(path, k, device="cpu"), want)
    if turn in (90, 270):
        assert reader[0].shape[:2] == (reader.track.width, reader.track.height)


def test_display_rotation_rules():
    """The angle arithmetic on its own: rounding half to even near 90, a
    scaled matrix, a missing mvhd (ffmpeg multiplies by zeros: no turn), a
    mirror combined with a turn."""
    assert mp4.display_rotation(cw.rotation_matrix(89.6), U) == 90
    assert mp4.display_rotation(cw.rotation_matrix(-90), U) == 270
    assert mp4.display_rotation((0, 131072, 0, -131072, 0, 0, 0, 0, 1 << 30), U) == 90
    assert mp4.display_rotation(cw.rotation_matrix(90), None) == 0
    assert mp4.display_rotation(cw.rotation_matrix(90, "h"), U) == 90
    assert mp4.display_rotation(cw.rotation_matrix(135), U) == 0



@pytest.mark.parametrize("kind", ["mvhd", "tkhd"])
def test_short_matrix_box_raises(tmp_path, sources, kind):
    """An mvhd or tkhd box that ends before its display matrix (its tail
    made a free box, so the boxes around it still parse): ValueError naming
    the file and the box, never a matrix read out of the next box."""
    path = tmp_path / f"short_{kind}.mp4"
    data = bytearray(sources["mjpeg"].read_bytes())
    at = data.index(kind.encode()) - 4
    size = struct.unpack_from(">I", data, at)[0]
    cut = 48
    struct.pack_into(">I", data, at, size - cut)
    struct.pack_into(">I4s", data, at + size - cut, cut, b"free")
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=f"{kind} box of .* too short") as e:
        mp4.read_track(path)
    assert str(path) in str(e.value)

# (ProjectionType, yaw, pitch, roll) -> cv2's clockwise turn
PROJECTIONS = {"roll90": ((0, 0.0, 0.0, 90.0), 270), "roll-90": ((0, 0.0, 0.0, -90.0), 90),
               "roll180": ((0, 0.0, 0.0, 180.0), 180), "no_type_roll90": ((None, 0.0, 0.0, 90.0), 270),
               "yaw180": ((0, 180.0, 0.0, 0.0), 180), "yaw180_roll90": ((0, 180.0, 0.0, 90.0), 90),
               "roll45": ((0, 0.0, 0.0, 45.0), 0), "pitch": ((0, 0.0, 10.0, 90.0), 0),
               "yaw90": ((0, 90.0, 0.0, 90.0), 0), "equirect": ((1, 0.0, 0.0, 90.0), 0),
               "mesh": ((3, 0.0, 0.0, 90.0), 0)}


@pytest.mark.parametrize("case", list(PROJECTIONS))
def test_matroska_projection_matches_cap4d_tpu(tmp_path, sources, case):
    """A Matroska track's Projection: the rectangular poses cv2 turns by
    (the roll, mirrored by a yaw of 180) and those it ignores."""
    projection, turn = PROJECTIONS[case]
    path = tmp_path / f"{case}.mkv"
    cw.write_mkv(path, cw.stream_of_mp4(sources["mp4v"]), projection=projection)
    reader = VideoFrameReader(path, device="cpu")
    assert reader.track.rotation == turn
    for k in range(len(reader)):
        want = ju.load_frame(path, k)
        assert reader[k].shape == want.shape
        np.testing.assert_array_equal(reader[k], want, err_msg=f"{case} frame {k}")


# ------------------------------------------------------------------ EXIF --

def tiff(orientation, order="<", tags=None, ifd=8):
    """A TIFF header and IFD0 holding Orientation (or ``tags``: (tag, value)
    SHORT entries), in byte order ``order``."""
    tags = [(0x0112, orientation)] if tags is None else tags
    head = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, ifd)
    body = struct.pack(order + "H", len(tags)) + b"".join(
        struct.pack(order + "HHIHH", t, 3, 1, v, 0) for t, v in tags)
    return head + b"\0" * (ifd - 8) + body + struct.pack(order + "I", 0)


def with_app1(jpeg: bytes, *payloads: bytes, header=b"Exif\0\0") -> bytes:
    """``jpeg`` with an APP1 segment of each payload after its SOI."""
    segs = b"".join(b"\xff\xe1" + struct.pack(">H", len(header + p) + 2) + header + p
                    for p in payloads)
    return jpeg[:2] + segs + jpeg[2:]


def _jpeg(h, w, seed=0):
    img = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    img[: h // 3, : w // 3] = 255
    return cv2.imencode(".jpg", img)[1].tobytes()


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("size", [(48, 64), (37, 51)])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cap4d_tpu(tmp_path, orientation, size, order):
    """Each of the eight orientations, little- and big-endian, at an even
    and an odd size: load_frame on the directory equals cap4d_tpu's
    (cv2.imread applies the orientation), shape included."""
    (tmp_path / "frames").mkdir()
    path = tmp_path / "frames" / "000.jpg"
    path.write_bytes(with_app1(_jpeg(*size), tiff(orientation, order)))
    want = ju.load_frame(tmp_path / "frames", 0)
    got = load_frame(tmp_path / "frames", 0)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.shape[:2] == (size[::-1] if orientation >= 5 else size)


def _cases():
    """name -> JPEG bytes of the malformed and unusual Exif blocks."""
    j = _jpeg(30, 44)
    t6 = tiff(6)
    return {
        "orientation0": with_app1(j, tiff(0)), "orientation9": with_app1(j, tiff(9)),
        "orientation_be_long": with_app1(j, t6.replace(b"\x03\x00\x01\x00", b"\x04\x00\x01\x00")),
        "magic43": with_app1(j, t6[:2] + b"\x2b\x00" + t6[4:]),
        "byte_order_XX": with_app1(j, b"XX" + t6[2:]),
        "ifd_past_end": with_app1(j, t6[:4] + struct.pack("<I", 400) + t6[8:]),
        "ifd_at_4": with_app1(j, t6[:4] + struct.pack("<I", 4) + t6[8:]),
        "cut_in_ifd": with_app1(j, t6[:12]), "cut_in_entry": with_app1(j, t6[:18]),
        "cut_after_value": with_app1(j, t6[:20]), "cut_in_value": with_app1(j, t6[:19]),
        "empty": with_app1(j, b""), "no_tiff": with_app1(j, b"XX"),
        "bad_exif_header": with_app1(j, t6, header=b"Exif\0\1"),
        "too_many_entries": with_app1(j, t6[:8] + struct.pack("<H", 500) + t6[10:]),
        "second_tag": with_app1(j, tiff(0, tags=[(0x010F, 1), (0x0112, 8)])),
        "tag_twice": with_app1(j, tiff(0, tags=[(0x0112, 3), (0x0112, 6)])),
        "two_segments": with_app1(j, tiff(3), tiff(6)),
        "no_orientation_then_6": with_app1(j, tiff(0, tags=[(0x010F, 1)]), tiff(6)),
        "broken_then_6": with_app1(j, b"XX", tiff(6)),
        "xmp_then_exif": with_app1(with_app1(j, tiff(6)), b"http://ns.adobe.com/xap/1.0/\0<x/>",
                                   header=b""),
        "ifd_at_16": with_app1(j, tiff(6, ifd=16)),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_exif_malformed_matches_cv2(tmp_path, case):
    """Malformed and unusual Exif blocks read as cv2.imread reads them."""
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(_cases()[case])
    want = cv2.imread(str(path))[..., ::-1]
    got = load_frame(tmp_path, 0)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _png_chunk(kind, data, crc=None):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) if crc is None else crc))


@pytest.mark.parametrize("case", ["le3", "be6", "le8_after_idat", "exif_prefix", "mixed_IM",
                                  "bad_crc", "duplicate"])
def test_png_exif_matches_cv2(tmp_path, case):
    """A PNG's eXIf chunk: cv2 applies it before or after IDAT, drops one
    that does not begin "II"/"MM" or fails its CRC, and keeps the first of
    two."""
    img = np.random.default_rng(1).integers(0, 255, (30, 44, 3), np.uint8)
    png = cv2.imencode(".png", img)[1].tobytes()
    chunk = {"le3": _png_chunk(b"eXIf", tiff(3)), "be6": _png_chunk(b"eXIf", tiff(6, ">")),
             "le8_after_idat": _png_chunk(b"eXIf", tiff(8)),
             "exif_prefix": _png_chunk(b"eXIf", b"Exif\0\0" + tiff(6)),
             "mixed_IM": _png_chunk(b"eXIf", b"IM" + tiff(6)[2:]),
             "bad_crc": _png_chunk(b"eXIf", tiff(6), crc=0),
             "duplicate": _png_chunk(b"eXIf", tiff(3)) + _png_chunk(b"eXIf", tiff(6))}[case]
    at = png.index(b"IEND") - 4 if case == "le8_after_idat" else 33
    path = tmp_path / "000.png"
    path.write_bytes(png[:at] + chunk + png[at:])
    want = cv2.imread(str(path))[..., ::-1]
    got = load_frame(tmp_path, 0)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert exif_orientation(path.read_bytes()) == {"le3": 3, "be6": 6, "le8_after_idat": 8,
                                                    "duplicate": 3}.get(case, 0)


def test_fused_loader_ignores_exif_as_cap4d_tpu(tmp_path):
    """The fused reference loader reads no EXIF in either package: the
    port's load_frame_native equals cap4d_tpu's on an EXIF-rotated JPEG,
    and both equal the unrotated file's."""
    from cap4d_tpu.runtime import loader as jl

    raw = _jpeg(48, 64, seed=4)
    (tmp_path / "plain.jpg").write_bytes(raw)
    (tmp_path / "turned.jpg").write_bytes(with_app1(raw, tiff(6)))
    box = (4, 2, 44, 42)
    for name in ("plain", "turned"):
        want = jl.load_frame_native(tmp_path / f"{name}.jpg", box, 32)
        assert want is not None
        np.testing.assert_array_equal(loader.load_frame_native(tmp_path / f"{name}.jpg", box, 32),
                                      want)
    np.testing.assert_array_equal(loader.load_frame_native(tmp_path / "turned.jpg", box, 32),
                                  loader.load_frame_native(tmp_path / "plain.jpg", box, 32))
