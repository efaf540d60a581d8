"""cap4d_torch host I/O that replaces yaml / cv2 on the card machine: the YAML
subset reader against yaml.safe_load, the zlib PNG writer/reader and the
numpy INTER_AREA / INTER_LINEAR resize against cv2."""

from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

from cap4d_torch.data.utils import rescale_image
from cap4d_torch.utils.config import dump_yaml, load_yaml, parse_yaml
from cap4d_torch.utils.png import read_png, write_png
from cap4d_tpu.mmdm.model import load_yaml as jax_load_yaml
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").glob("*/*.yaml"))


@pytest.mark.parametrize("rel", CONFIGS)
def test_yaml_reader_matches_safe_load(rel, tmp_path):
    """Same tree as cap4d_tpu's load_yaml (yaml.safe_load + number coercion),
    and a dump → read round trip that yaml also reads back."""
    path = REPO / rel
    ref = jax_load_yaml(path)
    assert load_yaml(path) == ref
    dump_yaml(ref, tmp_path / "c.yaml")
    assert load_yaml(tmp_path / "c.yaml") == ref
    assert jax_load_yaml(tmp_path / "c.yaml") == ref


def test_yaml_reader_syntax():
    text = ("a:\n- 1\n- [2, [3, 4]]\n- {x: 1e-3}\nb: 'q # r' # comment\n"
            "c:\n  - k: v\n    n: ~\n  -\n    deep: [ ]\nd: yes\ne: \"3\"\n")
    assert parse_yaml(text) == yaml.safe_load(text) | {"a": [1, [2, [3, 4]], {"x": 1e-3}], "e": 3}
    with pytest.raises(ValueError):
        parse_yaml("a: &anchor 1\n")
    with pytest.raises(ValueError):
        parse_yaml("a: |\n  block\n")


@pytest.mark.parametrize("shape", [(37, 51, 3), (16, 24)])
def test_png_roundtrip_against_cv2(shape, tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=shape).astype(np.uint8)
    write_png(tmp_path / "a.png", img)
    back = read_png(tmp_path / "a.png")
    expect = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(back, expect)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"))[..., ::-1], expect)


def test_png_reader_on_cv2_files(tmp_path):
    """cv2 (libpng) picks its own row filters; the reader undoes all five."""
    rng = np.random.default_rng(1)
    smooth = (np.add.outer(np.arange(48), np.arange(64))[..., None] * [1, 2, 3]) % 256
    for i, img in enumerate([smooth.astype(np.uint8),
                             rng.integers(0, 256, size=(33, 47, 3)).astype(np.uint8)]):
        p = tmp_path / f"{i}.png"
        cv2.imwrite(str(p), img[..., ::-1])
        np.testing.assert_array_equal(read_png(p), img)
        cv2.imwrite(str(p), img[..., 0])
        np.testing.assert_array_equal(read_png(p), cv2.imread(str(p))[..., ::-1])


@pytest.mark.parametrize("src,dst", [(300, 512), (37, 100), (64, 128), (700, 512),
                                     (1024, 512), (333, 64), (512, 64), (100, 37)])
def test_resize_matches_cv2(src, dst):
    rng = np.random.default_rng(src * 1000 + dst)
    interp = cv2.INTER_AREA if dst < src else cv2.INTER_LINEAR
    img = rng.uniform(0, 255, size=(src, src, 3))
    np.testing.assert_allclose(rescale_image(img, dst),
                               cv2.resize(img, (dst, dst), interpolation=interp), atol=1e-9)
    img32 = img.astype(np.float32)
    np.testing.assert_allclose(rescale_image(img32, dst),
                               cv2.resize(img32, (dst, dst), interpolation=interp), atol=1e-4)
    mask = np.ones((src, src, 1), np.float32)
    out = rescale_image(mask, dst)
    assert out.shape == cv2.resize(mask, (dst, dst), interpolation=interp).shape == (dst, dst)
    u8 = rng.integers(0, 256, size=(src, src, 3)).astype(np.uint8)
    diff = rescale_image(u8, dst).astype(int) - cv2.resize(u8, (dst, dst), interpolation=interp)
    assert np.abs(diff).max() <= 1
