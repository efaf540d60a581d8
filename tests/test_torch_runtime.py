"""The port's native runtime (cap4d_torch/runtime) against cap4d_tpu's, which
builds the same crop/resize code on libpng and libjpeg, and against cv2: the
port's own PNG and JPEG codecs decode bit for bit as those libraries do, the
fused loader and its pool give the same floats, the JPEG encoder writes what
cv2.imwrite writes at quality 95, and stage 1's reference frames may be
JPEGs."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from cap4d_torch.runtime import loader as tl
from cap4d_torch.utils.png import read_png, write_png
from cap4d_tpu.runtime import loader as jl

SIZES = [(96, 96), (37, 53), (17, 9), (1, 1), (300, 211)]
JPEG_PARAMS = {
    "q95": [cv2.IMWRITE_JPEG_QUALITY, 95],
    "q40": [cv2.IMWRITE_JPEG_QUALITY, 40],
    "444": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "422": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "440": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
    "restart": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
    "progressive": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "progressive_rst": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
}


def _image(h, w, seed=0):
    """A smooth RGB uint8 image with noise (edges and flat areas)."""
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.uniform(0, 255, (8, 8, 3)), (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(size, kind): path} of PNGs and JPEGs written by cv2 and by the port."""
    root = tmp_path_factory.mktemp("runtime")
    out = {}
    for i, (h, w) in enumerate(SIZES):
        img = _image(h, w, i)
        out[(h, w), "png_port"] = root / f"{h}x{w}_port.png"
        write_png(out[(h, w), "png_port"], img)
        out[(h, w), "png_cv2"] = root / f"{h}x{w}_cv2.png"
        cv2.imwrite(str(out[(h, w), "png_cv2"]), img[..., ::-1])
        out[(h, w), "png_gray16"] = root / f"{h}x{w}_gray16.png"
        cv2.imwrite(str(out[(h, w), "png_gray16"]), img[..., 0].astype(np.uint16) * 257 + 3)
        out[(h, w), "jpg_gray"] = root / f"{h}x{w}_gray.jpg"
        cv2.imwrite(str(out[(h, w), "jpg_gray"]), img[..., 0])
        for name, params in JPEG_PARAMS.items():
            out[(h, w), f"jpg_{name}"] = root / f"{h}x{w}_{name}.jpg"
            cv2.imwrite(str(out[(h, w), f"jpg_{name}"]), img[..., ::-1], params)
        out[(h, w), "jpg_port"] = root / f"{h}x{w}_port.jpg"
        tl.encode_jpeg(out[(h, w), "jpg_port"], img)
    return out


def _cv2_rgb(path):
    return cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]


def test_decode_matches_libpng_and_libjpeg(files):
    """Every file decodes to cv2's pixels (libpng, libjpeg-turbo), bit for bit."""
    for (size, kind), path in files.items():
        out = tl.decode_image(path)
        assert out.shape == (*size, 3), (kind, out.shape)
        np.testing.assert_array_equal(out, _cv2_rgb(path), err_msg=f"{size} {kind}")


def test_png_decode_matches_read_png(files):
    for (size, kind), path in files.items():
        if kind.startswith("png") and kind != "png_gray16":
            np.testing.assert_array_equal(tl.decode_image(path), read_png(path))


def _png(path, w, h, depth, ctype, rows, palette=None, trns=None, interlace=0):
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    body = b"".join(b"\0" + r for r in rows)
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                                 0, 0, interlace))
    if palette is not None:
        data += chunk(b"PLTE", palette)
    if trns is not None:
        data += chunk(b"tRNS", trns)
    path.write_bytes(data + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


def test_png_palette_and_low_depth(tmp_path):
    """Palettes (with tRNS, which the decoder drops as alpha is dropped) and
    1/2/4-bit grey, against cv2."""
    rng = np.random.default_rng(3)
    w, h = 13, 7
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    for depth in (1, 2, 4):
        idx = rng.integers(0, 2 ** depth, (h, w))
        rows = [np.packbits(np.unpackbits(r.astype(np.uint8)[:, None], axis=1)[:, -depth:]
                            .reshape(-1)).tobytes() for r in idx]
        for ctype, kw in ((3, dict(palette=pal[:2 ** depth].tobytes(), trns=b"\x00\x80")),
                          (0, {})):
            path = tmp_path / f"d{depth}_c{ctype}.png"
            _png(path, w, h, depth, ctype, rows, **kw)
            np.testing.assert_array_equal(tl.decode_image(path), _cv2_rgb(path), err_msg=path.name)


def test_encode_jpeg_matches_cv2_imwrite(files, tmp_path):
    """The port's encoder at quality 95 against cv2.imwrite at quality 95
    (4:2:0, libjpeg's tables): the decoded images' mean abs difference."""
    diffs = []
    for i, (h, w) in enumerate(SIZES):
        img = _image(h, w, i)
        ref = tmp_path / f"{h}x{w}.jpg"
        cv2.imwrite(str(ref), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
        ours = _cv2_rgb(files[(h, w), "jpg_port"]).astype(int)
        diffs.append(np.abs(ours - _cv2_rgb(ref).astype(int)).mean())
    assert max(diffs) == 0.0, diffs


@pytest.mark.parametrize("kind", ["png_port", "png_cv2", "jpg_q95", "jpg_444", "jpg_progressive",
                                  "jpg_port"])
def test_load_frame_native_matches_jax(files, kind):
    """The fused decode → pad-crop → resize → [-1, 1] against the JAX
    package's native loader: the same floats, bit for bit."""
    assert jl.native_available()
    for size in SIZES:
        path = files[size, kind]
        h, w = size
        for box, res in (([0, 0, w, h], 32), ([-7, 3, w + 5, h + 15], 24), ([1, 1, 4, 4], 20)):
            ours = tl.load_frame_native(path, box, res)
            ref = jl.load_frame_native(path, box, res)
            np.testing.assert_array_equal(ours, ref, err_msg=f"{path.name} {box} {res}")
        np.testing.assert_array_equal(tl.load_frame_native(path, None, 16),
                                      jl.load_frame_native(path, None, 16))


def test_prefetcher_matches_jax(files):
    paths = [files[size, kind] for size in SIZES for kind in ("png_port", "jpg_q95", "jpg_port")]
    boxes = [[-3, -2, 40, 41]] * len(paths)
    ref_pool = jl.NativePrefetcher(n_threads=4)
    tickets = [ref_pool.submit(p, b, 32) for p, b in zip(paths, boxes)]
    ref = np.stack([ref_pool.wait(t, 32) for t in tickets])
    ref_pool.close()
    np.testing.assert_array_equal(tl.load_frames(paths, boxes, 32, n_threads=4), ref)
    with tl.NativePrefetcher(n_threads=3) as pool:
        tickets = [pool.submit(p, b, 32) for p, b in zip(paths[::-1], boxes)]
        out = [pool.wait(t, 32) for t in tickets]
    np.testing.assert_array_equal(np.stack(out[::-1]), ref)


def test_errors_name_the_file(tmp_path, files):
    """No fallback: a file the runtime cannot read raises with its name and
    the reason."""
    # a progressive JPEG cut after its third scan: libjpeg would smooth its
    # blocks, which the port's decoder refuses to imitate
    prog = files[(96, 96), "jpg_progressive"].read_bytes()
    third = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"][3]
    bad = {"missing.png": None, "x.bmp": b"BM" + bytes(64),
           "cut.png": files[(96, 96), "png_cv2"].read_bytes()[:300],
           "cut_progressive.jpg": prog[:third] + b"\xff\xd9"}
    for name, data in bad.items():
        if data is not None:
            (tmp_path / name).write_bytes(data)
    reasons = {"missing.png": "cannot be opened", "x.bmp": "neither a PNG nor a JPEG",
               "cut.png": "malformed or truncated PNG", "cut_progressive.jpg": "left unrefined"}
    for name, reason in reasons.items():
        with pytest.raises(IOError, match=reason):
            tl.decode_image(tmp_path / name)
        with pytest.raises(IOError, match=name):
            tl.load_frame_native(tmp_path / name, None, 8)
    with tl.NativePrefetcher(n_threads=2) as pool:
        t = pool.submit(tmp_path / "x.bmp", None, 8)
        with pytest.raises(IOError, match="x.bmp"):
            pool.wait(t, 8)
        t = pool.submit(files[(17, 9), "png_cv2"], None, 8)
        with pytest.raises(ValueError, match="submitted at 8"):
            pool.wait(t, 16)
    with pytest.raises(ValueError, match="uint8"):
        tl.encode_jpeg(tmp_path / "f.jpg", np.zeros((4, 4, 3), np.float32))


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( {\n")
    monkeypatch.setattr(tl, "SOURCE", src)
    monkeypatch.setattr(tl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tl, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build broken.cpp:\n.*error"):
        tl.lib()


def test_load_frame_reads_jpeg_and_refuses_video(tmp_path, files):
    from cap4d_torch.data.utils import load_frame

    d = tmp_path / "frames"
    d.mkdir()
    for i, kind in enumerate(("jpg_q95", "png_cv2")):
        (d / f"{i:05d}{files[(37, 53), kind].suffix}").write_bytes(
            files[(37, 53), kind].read_bytes())
    np.testing.assert_array_equal(load_frame(d, 0), _cv2_rgb(files[(37, 53), "jpg_q95"]))
    np.testing.assert_array_equal(load_frame(d, 1), _cv2_rgb(files[(37, 53), "png_cv2"]))
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\0\0\0\x18ftypmp42")
    with pytest.raises(ValueError, match="video input needs a video decoder"):
        load_frame(video, 0)


def test_jpeg_reference_frame_set_matches_jax(tmp_path):
    """A reference directory of JPEG photos through both packages'
    build_frame_set (the JAX package on its native loader)."""
    from cap4d_torch.data import datasets as tdata
    from cap4d_torch.flame import compute as tcompute
    from cap4d_torch.utils import synthetic_assets as sa
    from cap4d_tpu.data import datasets as jdata
    from cap4d_tpu.flame import compute as jcompute

    flame_dir = sa.make_asset_dir(tmp_path)
    ref_dir = sa.make_reference_dir(tmp_path, resolution=96)
    for png in sorted((ref_dir / "images").rglob("*.png")):
        tl.encode_jpeg(png.with_suffix(".jpg"), read_png(png))
        png.unlink()
    head = np.genfromtxt(flame_dir / "head_vertices.txt").astype(int)
    sets = []
    for data, comp in ((jdata, jcompute), (tdata, tcompute)):
        fm = comp.load_cap4d_flame_model(flame_dir, 150, 65, add_mouth=True)
        items, extr = data.load_reference_items(ref_dir)
        sets.append(data.build_frame_set(fm, items, head, extr, 64, is_reference=True))
    j, t = sets
    assert np.abs(t.images).max() > 0.1
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_allclose(t.out_crop_mask, j.out_crop_mask, atol=1e-6)


def test_stage1_runs_on_jpeg_references(tmp_path):
    """The port's stage 1 end to end (small model, CPU) on a reference
    directory of JPEG photos."""
    import torch

    from cap4d_torch.inference.generate_images import run_generation
    from cap4d_torch.utils import synthetic_assets as sa

    flame_dir = sa.make_asset_dir(tmp_path)
    ref_dir = sa.make_reference_dir(tmp_path, resolution=96)
    for png in sorted((ref_dir / "images").rglob("*.png")):
        tl.encode_jpeg(png.with_suffix(".jpg"), read_png(png))
        png.unlink()
    cfg = sa.write_gen_config(tmp_path, sa.write_model_config(tmp_path),
                              sa.make_gen_bank(tmp_path), n_samples=7, n_ddim_steps=1)
    res = run_generation(cfg, ref_dir, tmp_path / "out", allow_random_weights=True,
                         flame_asset_dir=flame_dir, dtype=torch.float32, device="cpu")
    assert np.isfinite(res["z_gen"]).all() and res["images"].shape == (7, 64, 64, 3)
    assert len(list((tmp_path / "out" / "reference_images" / "images").glob("*.png"))) == 1
