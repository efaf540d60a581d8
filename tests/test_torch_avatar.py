"""Parity of the port's avatar modules (``cap4d_torch.avatar``) with
``cap4d_tpu.avatar`` on the CPU: binding math, the gaussian store and its
densification (on the JAX store's active rows), the deform net (one random
reference-key state dict loaded into both), losses, LPIPS (random weights
through ``convert_torch_lpips``), UV assets and mesh properties, including
the gradients that the JAX package routes through its fused custom VJPs.

Tolerances: fp32 formulas evaluated in another order, 1e-5 absolute on
unit-scale values; network outputs 1e-4 (convolutions summed in another
order); gradients 1e-4 of the largest gradient.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cap4d_tpu.avatar import binding as jb
from cap4d_tpu.avatar import flame_avatar as jfa
from cap4d_tpu.avatar import gaussians as jg
from cap4d_tpu.avatar import losses as jl
from cap4d_tpu.avatar.convert_ref import convert_deform_net_state_dict
from cap4d_tpu.avatar.deform_net import UnetGenerator as JaxUnet
from cap4d_tpu.flame.compute import load_cap4d_flame_model as jax_flame
from cap4d_torch.avatar import binding as tb
from cap4d_torch.avatar import flame_avatar as tfa
from cap4d_torch.avatar import gaussians as tg
from cap4d_torch.avatar import losses as tl
from cap4d_torch.avatar.convert_ref import deform_state_dict_from_flax
from cap4d_torch.avatar.deform_net import UnetGenerator
from cap4d_torch.avatar.lpips import LPIPS, LPIPSNet, load_lpips
from cap4d_torch.flame.compute import load_cap4d_flame_model as torch_flame
from cap4d_torch.utils import synthetic_assets as sa
from tests.test_torch_threads import share_cores  # noqa: F401 (autouse)


def _close(a, b, atol=1e-5, rtol=1e-5, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol, err_msg=msg)


def _mesh(seed=0, n_verts=30, n_faces=40):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(n_verts, 3)).astype(np.float32)
    faces = np.stack([rng.choice(n_verts, 3, replace=False) for _ in range(n_faces)]).astype(np.int32)
    return verts, faces


def test_binding_math_matches_jax():
    verts, faces = _mesh()
    o_t, s_t = tb.compute_face_orientation(torch.as_tensor(verts), torch.as_tensor(faces).long())
    o_j, s_j = jb.compute_face_orientation(jnp.asarray(verts), jnp.asarray(faces))
    _close(o_t, o_j), _close(s_t, s_j)
    q_t = tb.rotmat_to_quat(o_t)
    _close(q_t, jb.rotmat_to_quat(o_j))
    _close(tb.quat_to_rotvec(q_t), jb.quat_to_rotvec(jb.rotmat_to_quat(o_j)), atol=1e-4)
    a = np.random.default_rng(1).normal(size=(7, 4)).astype(np.float32)
    b = np.random.default_rng(2).normal(size=(7, 4)).astype(np.float32)
    _close(tb.quat_multiply(torch.as_tensor(a), torch.as_tensor(b)),
           jb.quat_multiply(jnp.asarray(a), jnp.asarray(b)))
    _close(tb.quat_normalize(torch.as_tensor(a)), jb.quat_normalize(jnp.asarray(a)))


def test_face_frames_and_rotation_loss_match_fused_jax():
    """face_frame_pack (plain indexing, autograd) against the JAX fused
    face_frame_pack2 with its corner-table VJP: values and gradients."""
    verts, faces = _mesh(seed=3)
    verts_b = verts + np.random.default_rng(4).normal(scale=0.05, size=verts.shape).astype(np.float32)
    w = np.random.default_rng(5).normal(size=(len(faces), 16)).astype(np.float32)
    cat, table = jb.build_corner_table(faces, len(verts))

    def jax_loss(va, vb):
        pa, pb = jb.face_frame_pack2(va, vb, jnp.asarray(faces), jnp.asarray(cat),
                                     jnp.asarray(table))
        return jnp.sum(pa * w) + jb.relative_rotation_loss_pack(pb, pa), (pa, pb)

    (lj, (pa_j, pb_j)), gj = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(verts), jnp.asarray(verts_b))
    va, vb = (torch.as_tensor(v).requires_grad_(True) for v in (verts, verts_b))
    f = torch.as_tensor(faces).long()
    pa, pb = tb.face_frame_pack(va, f), tb.face_frame_pack(vb, f)
    lt = (pa * torch.as_tensor(w)).sum() + tb.relative_rotation_loss_pack(pb, pa)
    gt = torch.autograd.grad(lt, (va, vb))
    _close(pa, pa_j), _close(pb, pb_j), _close(lt, lj, atol=1e-4)
    for a, b in zip(gt, gj):
        scale = float(np.abs(np.asarray(b)).max())
        _close(a / scale, np.asarray(b) / scale, atol=1e-4)


def _store(n0=12, n_faces=5, seed=0):
    rng = np.random.default_rng(seed)
    binding = rng.integers(0, n_faces, size=n0).astype(np.int32)
    binding[:n_faces] = np.arange(n_faces)
    counts = np.bincount(binding, minlength=n_faces)[binding].astype(np.float32)
    return binding, counts


def test_init_and_world_gaussians_match_jax():
    binding, counts = _store()
    gp_j, aux_j = jg.init_gaussians(binding, 5, capacity=20, sh_degree=1,
                                    gaussian_counts=counts, rng=np.random.default_rng(3))
    gp_t, aux_t = tg.init_gaussians(binding, 5, sh_degree=1, gaussian_counts=counts,
                                    rng=np.random.default_rng(3))
    n0 = len(binding)
    for f in tg.FIELDS:
        _close(gp_t[f], np.asarray(getattr(gp_j, f))[:n0], atol=0, rtol=0, msg=f)
    np.testing.assert_array_equal(aux_t["binding_counter"].numpy(),
                                  np.asarray(aux_j.binding_counter))
    verts, faces = _mesh(seed=6, n_faces=5)
    pack = jb.face_frame_pack(jnp.asarray(verts), jnp.asarray(faces))
    rng = np.random.default_rng(7)
    gp_j = gp_j.replace(rotation=jnp.asarray(rng.normal(size=(20, 4)).astype(np.float32)),
                        xyz=jnp.asarray(rng.normal(size=(20, 3)).astype(np.float32)))
    gp_t["rotation"] = torch.as_tensor(np.array(gp_j.rotation)[:n0])
    gp_t["xyz"] = torch.as_tensor(np.array(gp_j.xyz)[:n0])
    w_j = jg.world_gaussians_pack(gp_j, aux_j, pack)
    w_t = tg.world_gaussians(gp_t, aux_t, torch.as_tensor(np.asarray(pack)))
    for key, jkey in (("means3d", "means3d_ch"), ("quats", "quats_ch"), ("scales", "scales_ch")):
        _close(w_t[key], np.stack([np.asarray(c)[:n0] for c in w_j[jkey]], -1), msg=key)
    _close(w_t["opacities"], np.asarray(w_j["opacities"])[:n0])
    _close(w_t["sh"], np.asarray(w_j["sh"])[:n0])


@pytest.mark.parametrize("max_screen_size", [None, 20.0])
def test_densify_and_prune_matches_jax_active_rows(max_screen_size):
    binding, counts = _store(n0=24, n_faces=6, seed=1)
    n0, cap, F = len(binding), 64, 6
    rng = np.random.default_rng(11)
    gp_j, aux_j = jg.init_gaussians(binding, F, capacity=cap, sh_degree=1,
                                    gaussian_counts=counts, rng=np.random.default_rng(2))
    scaling = np.zeros((cap, 3), np.float32)
    scaling[:n0] = rng.uniform(-6, -1, size=(n0, 3))
    opacity = np.zeros((cap, 1), np.float32)
    opacity[:n0, 0] = rng.uniform(-7, 2, size=n0)
    rotation = np.asarray(gp_j.rotation).copy()
    rotation[:n0] = rng.normal(size=(n0, 4))
    gp_j = gp_j.replace(scaling=jnp.asarray(scaling), opacity=jnp.asarray(opacity),
                        rotation=jnp.asarray(rotation))
    accum = np.zeros(cap, np.float32)
    accum[:n0] = rng.uniform(0, 4e-4, size=n0)
    denom = np.zeros(cap, np.float32)
    denom[:n0] = rng.integers(0, 3, size=n0)
    radii = np.zeros(cap, np.float32)
    radii[:n0] = rng.uniform(0, 40, size=n0)
    aux_j = aux_j.replace(xyz_gradient_accum=jnp.asarray(accum), denom=jnp.asarray(denom),
                          max_radii2d=jnp.asarray(radii))
    mom = {f: rng.normal(size=np.asarray(getattr(gp_j, f)).shape).astype(np.float32)
           for f in tg.FIELDS}
    moments_j = (jg.GaussianParams(**{f: jnp.asarray(v) for f, v in mom.items()}),
                 jg.GaussianParams(**{f: jnp.asarray(v * v) for f, v in mom.items()}))
    face_scaling = rng.uniform(0.01, 0.05, size=(F, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    p_j, a_j, m_j, dropped = jg.densify_and_prune(
        gp_j, aux_j, moments_j, jnp.asarray(face_scaling), key, max_grad=2e-4,
        min_opacity=0.005, extent=1.0, percent_dense=0.01, max_screen_size=max_screen_size)
    assert int(dropped) == 0
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.as_tensor(np.asarray(jax.random.normal(k, (cap, 3)))[:n0]) for k in (k1, k2))

    t = lambda a: torch.as_tensor(np.asarray(a)[:n0])
    gp_t = {f: t(getattr(gp_j, f)) for f in tg.FIELDS}
    aux_t = {"binding": t(aux_j.binding).long(),
             "binding_counter": torch.as_tensor(np.asarray(aux_j.binding_counter)),
             "max_radii2d": t(radii), "xyz_gradient_accum": t(accum), "denom": t(denom)}
    mo_t = {"gauss_m": {f: t(v) for f, v in mom.items()},
            "gauss_v": {f: t(v * v) for f, v in mom.items()}}
    p_t, a_t, m_t = tg.densify_and_prune(gp_t, aux_t, mo_t, torch.as_tensor(face_scaling), noise,
                                         max_grad=2e-4, min_opacity=0.005, extent=1.0,
                                         percent_dense=0.01, max_screen_size=max_screen_size)
    act = np.asarray(a_j.active)
    assert act.sum() == p_t["xyz"].shape[0] and act.sum() != n0
    for f in tg.FIELDS:
        _close(p_t[f], np.asarray(getattr(p_j, f))[act], msg=f)
        _close(m_t["gauss_m"][f], np.asarray(getattr(m_j[0], f))[act], msg=f)
        _close(m_t["gauss_v"][f], np.asarray(getattr(m_j[1], f))[act], msg=f)
    np.testing.assert_array_equal(a_t["binding"].numpy(), np.asarray(a_j.binding)[act])
    np.testing.assert_array_equal(a_t["binding_counter"].numpy(), np.asarray(a_j.binding_counter))

    # opacity reset and densification statistics
    jr, jm = jg.reset_opacity(p_j, m_j)
    tg.reset_opacity(p_t, m_t)
    _close(p_t["opacity"], np.asarray(jr.opacity)[act])
    assert float(m_t["gauss_m"]["opacity"].abs().sum()) == 0
    n = p_t["xyz"].shape[0]
    g = rng.normal(size=(n, 2)).astype(np.float32)
    vis = rng.uniform(size=n) > 0.3
    r = rng.uniform(0, 30, size=n).astype(np.float32)
    tg.add_densification_stats(a_t, torch.as_tensor(g), torch.as_tensor(vis), torch.as_tensor(r))
    gfull, vfull, rfull = (np.zeros((cap,) + x.shape[1:], x.dtype) for x in (g, vis, r))
    gfull[act], vfull[act], rfull[act] = g, vis, r
    a2 = jg.add_densification_stats(a_j, jnp.asarray(gfull), jnp.asarray(vfull), jnp.asarray(rfull))
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        _close(a_t[k], np.asarray(getattr(a2, k))[act], msg=k)


def _random_reference_state_dict(num_downs, seed=0):
    """Reference-key UnetGenerator state dict with every layer nonzero."""
    net = UnetGenerator(num_downs=num_downs, zero_init_last=False)
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) * (0.02 if k.endswith("bias")
                                                       else 1.0 / np.sqrt(v[0].numel()))
            for k, v in net.state_dict().items()}


def test_deform_net_matches_jax_from_reference_state_dict():
    sd = _random_reference_state_dict(5)
    net = UnetGenerator(num_downs=5)
    net.load_state_dict(sd)
    params = convert_deform_net_state_dict({k: v.numpy() for k, v in sd.items()}, num_downs=5)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 27)).astype(np.float32)
    out_j = JaxUnet(num_downs=5).apply({"params": params}, jnp.asarray(x))
    out_t = net(torch.as_tensor(x))
    _close(out_t, out_j, atol=1e-4, rtol=1e-4)
    # the flax tree maps back onto the same reference keys
    for k, v in deform_state_dict_from_flax(params, 5).items():
        _close(v, sd[k].numpy(), atol=0, rtol=0, msg=k)
    fresh = UnetGenerator(num_downs=5)
    assert float(fresh(torch.as_tensor(x)).detach().abs().max()) == 0.0   # zero-initialised last layer


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(size=(40, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(np.float32)
    ta, tb_ = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    _close(tl.l1_loss(ta, tb_), jl.l1_loss(ja, jb_))
    _close(tl.l2_loss(ta, tb_), jl.l2_loss(ja, jb_))
    _close(tl.psnr(ta, tb_), jl.psnr(ja, jb_), atol=1e-4)
    _close(tl.ssim(ta, tb_), jl.ssim(ja, jb_))
    _close(tl.ssim(ta.permute(2, 0, 1), tb_.permute(2, 0, 1), channel_first=True),
           jl.ssim(ja, jb_))
    _close(tl.error_map(ta, tb_), jl.error_map(ja, jb_))


def test_lpips_matches_jax_with_random_weights(tmp_path):
    from cap4d_tpu.avatar.lpips import LPIPS as JaxLPIPS, convert_torch_lpips, save_lpips_npz
    from tests.test_lpips import _LIN_CH, _make_torch_vgg

    vgg = _make_torch_vgg(seed=0)
    torch.manual_seed(1)
    lins = [torch.nn.Conv2d(c, 1, 1, bias=False) for c in _LIN_CH]
    vgg_sd = {f"features.{i}.{leaf}": p.detach()
              for i, m in enumerate(vgg) if isinstance(m, torch.nn.Conv2d)
              for leaf, p in (("weight", m.weight), ("bias", m.bias))}
    lin_sd = {f"lin{k}.model.1.weight": lin.weight.detach().abs() for k, lin in enumerate(lins)}
    net = LPIPSNet()
    net.load_state_dict({**vgg_sd, **lin_sd})
    ours = LPIPS(net)
    params = convert_torch_lpips({k: v.numpy() for k, v in vgg_sd.items()},
                                 {k: v.numpy() for k, v in lin_sd.items()})
    rng = np.random.default_rng(2)
    x, y = (rng.uniform(size=(32, 32, 3)).astype(np.float32) for _ in range(2))
    ref = JaxLPIPS(params)(jnp.asarray(x), jnp.asarray(y))
    _close(ours(torch.as_tensor(x), torch.as_tensor(y)), ref, atol=1e-5, rtol=1e-4)
    path = tmp_path / "lpips_vgg.npz"
    save_lpips_npz(params, path)
    loaded = load_lpips(path)
    assert loaded.available and not load_lpips(tmp_path / "missing.npz").available
    _close(loaded(torch.as_tensor(x), torch.as_tensor(y)), ref, atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """UV assets of the synthetic template at 16², built by both packages
    from the same rasterization (JAX's fragments handed to the port), so
    that everything derived from them compares exactly."""
    from cap4d_torch.ops.rasterize import Fragments

    root = tmp_path_factory.mktemp("avatar_assets")
    flame_dir = sa.make_asset_dir(root)
    tv, tf, tuv, tfuv, deformable = tfa.load_avatar_template(flame_dir)
    uv_j = jfa.build_uv_assets(*jfa.load_avatar_template(flame_dir), 16)
    own = tfa.build_uv_assets(tv, tf, tuv, tfuv, deformable, 16)
    frag = jfa.rasterize_meshes(*_uv_ndc(tuv, tfuv), (16, 16))
    real = tfa.rasterize_meshes
    tfa.rasterize_meshes = lambda *a, **k: Fragments(*(torch.as_tensor(np.asarray(x))
                                                       for x in frag))
    try:
        uv_t = tfa.build_uv_assets(tv, tf, tuv, tfuv, deformable, 16)
    finally:
        tfa.rasterize_meshes = real
    return flame_dir, tv, uv_t, uv_j, own


def _uv_ndc(uvs, faces_uv):
    uvs = uvs * 2.0 - 1.0
    uvs[..., 1] = -uvs[..., 1]
    verts = np.concatenate([uvs, np.ones_like(uvs[:, :1])], axis=-1).astype(np.float32)
    return jnp.asarray(verts)[None], jnp.asarray(faces_uv.astype(np.int32))


def test_uv_assets_and_allocation_match_jax(assets):
    flame_dir, tv, uv_t, uv_j, own = assets
    for name in ("pix_to_face", "uv_mask", "deform_mask", "remesh_faces", "template_faces"):
        np.testing.assert_array_equal(getattr(uv_t, name).numpy(), np.asarray(getattr(uv_j, name)),
                                      err_msg=name)
    _close(uv_t.bary, uv_j.bary)
    _close(uv_t.pos_enc, uv_j.pos_enc)
    b_t, c_t = tfa.allocate_gaussians(uv_t, torch.as_tensor(tv), 400, 1)
    b_j, c_j = jfa.allocate_gaussians(uv_j, jnp.asarray(tv), 400, 1)
    np.testing.assert_array_equal(b_t, b_j)
    np.testing.assert_array_equal(c_t, c_j)
    # the port's own rasterization of the grid-aligned UV chart: texel
    # centres that fall exactly on a triangle edge may go to the other
    # face (or fall outside) where XLA contracts the edge function into an
    # FMA; they are at most 5 % of the texels
    differ = own.pix_to_face.numpy() != np.asarray(uv_j.pix_to_face)
    assert differ.mean() <= 0.05, differ.sum()


def test_mesh_properties_and_regularizers_match_jax(assets):
    """Values and gradients of the per-timestep mesh state; the JAX side
    runs its fused resample/face-frame VJPs, the port their plain forms."""
    flame_dir, _, uv_t, uv_j, _ = assets
    sd = _random_reference_state_dict(4, seed=3)
    params = convert_deform_net_state_dict({k: v.numpy() for k, v in sd.items()}, num_downs=4)
    net = UnetGenerator(num_downs=4)
    net.load_state_dict(sd)
    fm_j = jax_flame(flame_dir, 150, 65, add_mouth=True, add_lower_jaw=True)
    fm_t = torch_flame(flame_dir, 150, 65, add_mouth=True, add_lower_jaw=True)
    rng = np.random.default_rng(4)
    shape = rng.normal(scale=0.3, size=150).astype(np.float32)
    expr = rng.normal(scale=0.3, size=65).astype(np.float32)
    rot, tra, eye, base = (rng.normal(scale=0.05, size=3).astype(np.float32) for _ in range(4))
    offset = rng.normal(scale=0.01, size=3).astype(np.float32)
    w = rng.normal(size=(uv_t.remesh_faces.shape[0], 16)).astype(np.float32)

    def jax_loss(p, off):
        neck = jfa.relative_neck_rotation(jnp.asarray(base), jnp.asarray(rot), off)
        m = jfa.mesh_properties(fm_j, uv_j, JaxUnet(num_downs=4), p, jnp.asarray(shape),
                                jnp.asarray(expr), jnp.asarray(rot), jnp.asarray(tra),
                                jnp.asarray(eye), neck)
        loss = (jfa.laplacian_loss(m.deform_output) + jnp.sum(m.face_pack * w)
                + jb.relative_rotation_loss_pack(m.neutral_pack, m.face_pack))
        return loss, m

    (lj, mj), gj = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(offset))
    off_t = torch.as_tensor(offset).requires_grad_(True)
    neck = tfa.relative_neck_rotation(*(torch.as_tensor(a) for a in (base, rot)), off_t)
    mt = tfa.mesh_properties(fm_t, uv_t, net, *(torch.as_tensor(a) for a in
                                                (shape, expr, rot, tra, eye)), neck)
    lt = (tfa.laplacian_loss(mt.deform_output) + (mt.face_pack * torch.as_tensor(w)).sum()
          + tb.relative_rotation_loss_pack(mt.neutral_pack, mt.face_pack))
    for name in ("face_pack", "neutral_pack", "deform_output", "verts"):
        _close(getattr(mt, name), getattr(mj, name), atol=2e-4, msg=name)
    _close(lt, lj, rtol=1e-4)
    *g_params, g_off = torch.autograd.grad(lt, list(net.parameters()) + [off_t])
    g_net = dict(zip([k for k, _ in net.named_parameters()], g_params))
    ref = deform_state_dict_from_flax(jax.tree.map(np.asarray, gj[0]), 4)
    top = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    for k, v in ref.items():
        _close(g_net[k] / top, v.numpy() / top, atol=1e-4, msg=k)
    scale = float(np.abs(np.asarray(gj[1])).max())
    _close(g_off / scale, np.asarray(gj[1]) / scale, atol=1e-4)
