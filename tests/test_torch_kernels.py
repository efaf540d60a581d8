"""Plain PyTorch versions of the port's three kernels against the JAX
package's Pallas kernels (interpret mode on the CPU) and plain references.

On the CPU each wrapper takes its plain version because the tensors lie on
the CPU; the kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_torch.ops.flash_attention import attention_plain, flash_attention
from cap4d_torch.ops.norms import group_norm_silu, group_norm_silu_plain
from cap4d_torch.ops.rasterize import rasterize_meshes, rasterize_meshes_plain
from cap4d_tpu.ops.attention import _einsum_attention
from cap4d_tpu.ops.flash_attention import _flash_fwd
from cap4d_tpu.ops.norms import fused_group_norm_silu
from cap4d_tpu.ops.rasterize import rasterize_meshes as jax_rasterize
from cap4d_tpu.ops.rasterize import rasterize_meshes_pallas
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)


def test_attention_plain_matches_pallas_interpret_and_einsum():
    """(S=512, d=64) as test_networks.py's fwd-kernel case; fp32, 2e-5."""
    rng = np.random.default_rng(5)
    B, S, H, D = 1, 512, 3, 64
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = flash_attention(tq, tk, tv).numpy()
    np.testing.assert_array_equal(out, attention_plain(tq, tk, tv).numpy())

    ein = np.asarray(_einsum_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(out, ein, atol=2e-5)
    bhsd = [jnp.asarray(np.ascontiguousarray(a[0].transpose(1, 0, 2))) for a in (q, k, v)]
    pallas = np.asarray(_flash_fwd(*bhsd, block_q=256, block_k=256, interpret=True))
    np.testing.assert_allclose(out[0].transpose(1, 0, 2), pallas, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 16, 16, 320)])
@pytest.mark.parametrize("silu,eps", [(True, 1e-5), (False, 1e-6)])
def test_group_norm_plain_matches_jax(shape, silu, eps):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    bias = (0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    ref = np.asarray(fused_group_norm_silu(jnp.asarray(x), jnp.asarray(scale),
                                           jnp.asarray(bias), 32, eps, silu))
    args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 32, eps, silu)
    out = group_norm_silu(*args).numpy()
    np.testing.assert_array_equal(out, group_norm_silu_plain(*args).numpy())
    np.testing.assert_allclose(out, ref, atol=1e-5)
    # bf16 activations: fp32 statistics, one bf16 rounding of the output
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref_b = np.asarray(fused_group_norm_silu(xb, jnp.asarray(scale), jnp.asarray(bias),
                                             32, eps, silu).astype(jnp.float32))
    out_b = group_norm_silu(torch.from_numpy(x).bfloat16(), *args[1:]).float().numpy()
    np.testing.assert_allclose(out_b, ref_b, rtol=1e-2, atol=1e-2)


@pytest.fixture(scope="module")
def random_mesh():
    rng = np.random.default_rng(5)
    n_v, n_f = 40, 60
    verts = rng.uniform(-1.2, 1.2, size=(2, n_v, 3)).astype(np.float32)
    verts[..., 2] = rng.uniform(0.5, 3.0, size=(2, n_v))
    faces = rng.integers(0, n_v, size=(n_f, 3)).astype(np.int32)
    return verts, faces


def _compare(frag, jfrag, min_agree):
    p = frag.pix_to_face.numpy()
    jp = np.asarray(jfrag.pix_to_face)
    agree = (p == jp).mean()
    assert agree >= min_agree, agree
    m = (p == jp) & (jp >= 0)
    np.testing.assert_allclose(frag.zbuf.numpy()[m], np.asarray(jfrag.zbuf)[m], atol=1e-5)
    np.testing.assert_allclose(frag.bary_coords.numpy()[m], np.asarray(jfrag.bary_coords)[m],
                               atol=1e-5)
    assert np.isinf(frag.zbuf.numpy()[p < 0]).all()
    assert (frag.bary_coords.numpy()[p < 0] == 0).all()


def test_rasterize_plain_matches_jax(random_mesh):
    """Against the XLA scan (_rasterize_single) and the Pallas kernel in
    interpret mode; edge pixels may flip where XLA contracts to FMA."""
    verts, faces = random_mesh
    size = (32, 32)
    frag = rasterize_meshes(torch.from_numpy(verts), torch.from_numpy(faces), size)
    assert frag.pix_to_face.dtype == torch.int32
    for chunk in (7, 64):   # chunking does not change the result
        again = rasterize_meshes_plain(torch.from_numpy(verts), torch.from_numpy(faces), size, chunk)
        np.testing.assert_array_equal(again.pix_to_face.numpy(), frag.pix_to_face.numpy())
    _compare(frag, jax_rasterize(jnp.asarray(verts), jnp.asarray(faces), size, chunk=16), 0.995)
    _compare(frag, rasterize_meshes_pallas(jnp.asarray(verts), jnp.asarray(faces), size,
                                           interpret=True), 0.995)


def test_rasterize_z_tie_lowest_face_wins():
    """Equal z: the lowest face index wins, across chunk boundaries too."""
    tri = np.array([[-1, -1, 2.0], [1, -1, 2.0], [0, 1, 2.0]], np.float32)
    far = tri + np.array([0, 0, 1.0], np.float32)
    verts = np.concatenate([far, tri, tri, tri])[None]           # faces 0 far, 1..3 tied
    faces = np.arange(12, dtype=np.int32).reshape(4, 3)
    size = (16, 16)
    for chunk in (1, 2, 64):
        frag = rasterize_meshes_plain(torch.from_numpy(verts), torch.from_numpy(faces), size, chunk)
        center = frag.pix_to_face.numpy()[0, 8, 8]
        assert center == 1, (chunk, center)
    jfrag = rasterize_meshes_pallas(jnp.asarray(verts), jnp.asarray(faces), size, interpret=True)
    np.testing.assert_array_equal(frag.pix_to_face.numpy(), np.asarray(jfrag.pix_to_face))
    jx = jax_rasterize(jnp.asarray(verts), jnp.asarray(faces), size, chunk=2)
    np.testing.assert_array_equal(frag.pix_to_face.numpy(), np.asarray(jx.pix_to_face))


def test_rasterize_helpers_match_jax(tmp_path):
    """interpolate_face_attributes, clip_barycentric, ndc_transform_verts and
    load_obj against cap4d_tpu.ops.rasterize."""
    from cap4d_torch.ops import rasterize as T
    from cap4d_tpu.ops import rasterize as J

    rng = np.random.default_rng(2)
    p2f = rng.integers(-1, 5, size=(2, 6, 7)).astype(np.int32)
    bary = rng.normal(size=(2, 6, 7, 3)).astype(np.float32)
    attrs = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        T.interpolate_face_attributes(torch.from_numpy(p2f), torch.from_numpy(bary),
                                      torch.from_numpy(attrs)).numpy(),
        np.asarray(J.interpolate_face_attributes(jnp.asarray(p2f), jnp.asarray(bary),
                                                 jnp.asarray(attrs))), atol=1e-6)
    np.testing.assert_allclose(T.clip_barycentric(torch.from_numpy(bary)).numpy(),
                               np.asarray(J.clip_barycentric(jnp.asarray(bary))), atol=1e-6)
    verts = rng.normal(size=(2, 9, 3)).astype(np.float32) * 0.1 + [0, 0, 1.5]
    K = np.tile(np.array([[300, 0, 128], [0, 310, 120], [0, 0, 1]], np.float32), (2, 1, 1))
    E = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    E[1, :3, 3] = [0.01, -0.02, 0.1]
    np.testing.assert_allclose(
        T.ndc_transform_verts(*(torch.from_numpy(np.asarray(a, np.float32)) for a in (verts, K, E)),
                              (256, 200)).numpy(),
        np.asarray(J.ndc_transform_verts(jnp.asarray(verts, jnp.float32), jnp.asarray(K),
                                         jnp.asarray(E), (256, 200))), rtol=1e-5, atol=1e-6)
    obj = tmp_path / "m.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nf 1/1 2/2 3/3\n")
    for a, b in zip(T.load_obj(obj), J.load_obj(obj)):
        np.testing.assert_array_equal(a, b)
