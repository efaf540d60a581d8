"""Avatar fitting trainer: one training iteration, Adam per group, camera
renders, checkpoints (counterpart of ``cap4d_tpu/avatar/trainer.py``).

Reference: gaussianavatars/train.py:43-248 (losses, densification cadence)
and cap4d_gaussian_model.py:381-441 (optimizer groups, exponential learning
rates; torch Adam with eps 1e-15, SparseAdam for the per-frame neck rows).

An iteration is :meth:`AvatarTrainer.step`: FLAME ×2, UV resampling, the
deform U-Net, face frames (for the SMPL body: one SMPL forward, UV
resampling, face frames), world gaussians, the 3DGS render (kernels K4/K5
on the card), the losses, one ``torch.autograd.grad``, the densification
statistics and the Adam updates, every one written into the trainer's own
tensors. Its inputs are device tensors: the camera (a row of
:class:`CameraBank`, gathered by a one-element index), the timestep, and
the schedules (learning rates, Adam's bias corrections, the LPIPS ramp)
as rows of float32 tables built once on the host (:meth:`schedule_tables`).
Nothing in it reads the device on the host, so the fit captures it as a
CUDA graph and replays it (``avatar/step_compiler.py``, the counterpart of
the JAX package's compiled steps and chunked dispatch); with a pair
``budget`` its render has static shapes too. ``train_step`` runs the same
step eagerly for one host-chosen camera. The JAX package's padded-capacity
store (``grow_capacity``), eval render prewarm and raster-cap truncation
reactions have no counterpart: the store is recaptured when densification
resizes it, and the pair budget grows instead of dropping pairs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cap4d_torch.avatar import gaussians as G
from cap4d_torch.avatar.binding import relative_rotation_loss_pack, safe_norm
from cap4d_torch.avatar.flame_avatar import (
    FlameAvatarConfig,
    FlameVariant,
    allocate_gaussians,
    bank_row,
    build_uv_assets,
    laplacian_loss,
    load_avatar_template,
    make_deform_net,
    relative_deformation_loss,
)
from cap4d_torch.avatar.losses import l1_loss, ssim
from cap4d_torch.avatar.lpips import LPIPS
from cap4d_torch.flame.compute import load_cap4d_flame_model
from cap4d_torch.ops.gsplat_tiles import count_candidates, rasterize_gaussians
from cap4d_torch.smpl.avatar import SMPLVariant, build_smpl_variant, load_smpl_template
from cap4d_torch.smpl.model import build_smpl_model, load_smpl_pkl
from cap4d_torch.utils.device import resolve_device

Variant = Union[FlameVariant, SMPLVariant]


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0, max_steps=1_000_000):
    """Log-linear learning-rate interpolation (utils/general_utils.py:29-61)."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
    else:
        delay = 1.0
    t = np.clip(step / max_steps, 0, 1)
    return float(delay * np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t))


ADAM_B1, ADAM_B2 = 0.9, 0.999


def adam_terms(p, g, m, v, lr, bias1, bias2, eps=1e-15, b1=ADAM_B1, b2=ADAM_B2, wd=0.0):
    """torch.optim.Adam semantics (L2 through the gradient, bias correction
    by ``bias1`` = 1 − β1^step and ``bias2`` = 1 − β2^step) → new (p, m, v).
    ``lr`` and the corrections are floats or 0-d tensors."""
    g = g + wd * p
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / bias1
    vhat = v / bias2
    return p - lr * mhat / (torch.sqrt(vhat) + eps), m, v


def adam_update(p, g, m, v, step, lr, eps=1e-15, b1=ADAM_B1, b2=ADAM_B2, wd=0.0):
    """:func:`adam_terms` at Adam step ``step`` → new (p, m, v)."""
    return adam_terms(p, g, m, v, lr, 1 - b1 ** step, 1 - b2 ** step, eps=eps, b1=b1, b2=b2, wd=wd)


def lpips_ramp(iteration: int, opt: Dict[str, Any]) -> float:
    """λ_LPIPS at ``iteration`` (train.py:152-158)."""
    ramp = max(opt["lpips_linear_end"] - opt["lpips_linear_start"], 1)
    return float(np.clip((iteration - opt["lpips_linear_start"]) / ramp, 0.0, 1.0)
                 * opt["lambda_lpips_end"])


# columns of AvatarTrainer.schedule_tables' per-iteration and per-Adam-step tables
ITER_COLUMNS = ("lr_xyz", "lr_deform", "lr_neck", "lpips_w", "photo_w")
ADAM_COLUMNS = ("bias1", "bias2")


class CameraBank:
    """The training cameras on the device, stacked (counterpart of
    ``cap4d_tpu/avatar/train.py:67 _build_cam_bank``): rt (N, 4, 4), K
    (N, 3, 3), the images (N, H, W, 3), masks (N, H, W) and timesteps (N,).
    An image set that is exactly 8-bit (PNG-loaded) is stored as uint8 and
    divided by 255 on the device, which gives the float32 image bit for bit
    (checked here on the host); any other set stays float32. Needs one
    resolution: :meth:`build` returns None for a mixed split."""

    def __init__(self, rt, K, gt, mask, t, width: int, height: int):
        self.rt, self.K, self.gt, self.mask, self.t = rt, K, gt, mask, t
        self.width, self.height = width, height
        # a device divisor: the card divides by a host scalar through its
        # reciprocal, which is not the host's float32 division
        self.scale = torch.full((), 255.0, device=gt.device)

    @classmethod
    def build(cls, cams, device) -> Optional["CameraBank"]:
        if not cams or any((c.height, c.width) != (cams[0].height, cams[0].width) for c in cams):
            return None
        H, W = cams[0].height, cams[0].width
        images = [np.asarray(c.image, np.float32) for c in cams]
        u8 = [np.rint(np.clip(im * 255.0, 0, 255)).astype(np.uint8) for im in images]
        exact = all(np.array_equal(q.astype(np.float32) / 255.0, im) for q, im in zip(u8, images))
        masks = [np.ones((H, W), np.float32) if c.mask is None else np.asarray(c.mask, np.float32)
                 for c in cams]

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.stack(a), dtype=dtype, device=device)

        return cls(t([c.rt for c in cams]), t([c.intrinsics for c in cams]),
                   t(u8, torch.uint8) if exact else t(images), t(masks),
                   t([int(c.timestep) for c in cams], torch.int64), W, H)

    def camera(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The step's camera inputs for the bank row that the one-element
        index tensor ``idx`` names, gathered on the device."""
        gt = bank_row(self.gt, idx)
        if gt.dtype == torch.uint8:
            gt = gt.to(torch.float32) / self.scale
        return {"rt": bank_row(self.rt, idx), "K": bank_row(self.K, idx), "gt": gt,
                "mask": bank_row(self.mask, idx), "t": self.t.index_select(0, idx.view(1))}


class AvatarTrainer:
    """Fit state: gaussian store, deform net, neck rows, the variant's
    parameter bank (FLAME or SMPL), Adam moments."""

    def __init__(self, variant: Variant, config: FlameAvatarConfig, opt: Dict[str, Any],
                 gauss, aux, deform_net: torch.nn.Module, neck_weight: torch.Tensor,
                 flame_bank: Dict[str, torch.Tensor], moments: Dict[str, Any], lpips: LPIPS,
                 spatial_lr_scale: float, device: torch.device):
        self.variant = variant
        self.uv = variant.uv
        self.config = config
        self.opt = opt
        self.gauss = gauss
        self.aux = aux
        self.deform_net = deform_net
        self.neck_weight = neck_weight
        self.flame_bank = flame_bank
        self.moments = moments
        self.lpips = lpips
        self.spatial_lr_scale = spatial_lr_scale
        self.device = device
        self.active_sh_degree = 0
        self.iteration = 0
        self.step_graphs = None   # the fit's dispatcher (avatar/step_compiler.py), when it had one
        self.frame_graphs = None  # the animation's frame render (avatar/render_graph.py)
        self._tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def shape_key(self) -> str:
        """The bank's identity key: FLAME's "shape", SMPL's "betas"."""
        return "shape" if "shape" in self.flame_bank else "betas"

    @property
    def n_active(self) -> int:
        return int(self.gauss["xyz"].shape[0])

    @classmethod
    def create(cls, scene, model_params: Dict[str, Any], opt_params: Dict[str, Any],
               flame_asset_dir: str | Path = "data/assets/flame", lpips: Optional[LPIPS] = None,
               seed: int = 0, device=None) -> "AvatarTrainer":
        """The FLAME head avatar."""
        device = resolve_device(device)
        config = FlameAvatarConfig(
            uv_resolution=model_params["uv_resolution"],
            n_unet_layers=model_params["n_unet_layers"],
            use_expr_mask=model_params["use_expr_mask"],
            static_neck=model_params["static_neck"],
            use_lower_jaw=model_params["use_lower_jaw"],
            n_gaussians_init=model_params["n_gaussians_init"],
            n_points_per_triangle=model_params["n_points_per_triangle"],
            sh_degree=model_params["sh_degree"],
            gaussian_init_type=model_params.get("gaussian_init_type", "scaled"),
        )
        flame_model = load_cap4d_flame_model(flame_asset_dir, n_shape_params=150, n_expr_params=65,
                                             add_mouth=True, add_lower_jaw=config.use_lower_jaw,
                                             device=device)
        tv, tf, tuv, tfuv, deformable = load_avatar_template(flame_asset_dir)
        uv = build_uv_assets(tv, tf, tuv, tfuv, deformable, config.uv_resolution, device=device)
        return cls._from_variant(FlameVariant(flame_model, uv, config), config, tv, scene,
                                 opt_params, lpips, seed, device)

    @classmethod
    def create_smpl(cls, scene, model_params: Dict[str, Any], opt_params: Dict[str, Any],
                    smpl_asset_dir: str | Path = "data/assets/smpl", lpips: Optional[LPIPS] = None,
                    seed: int = 0, device=None) -> "AvatarTrainer":
        """The full-body SMPL avatar (SMPLGaussianModel, cap4d_gaussian_model.py:458+):
        uv resolution 256 unless given, a static neck, no lower jaw, and the
        deform net built but gated off (its parameters still take Adam's
        weight decay on zero gradients)."""
        device = resolve_device(device)
        config = FlameAvatarConfig(
            uv_resolution=model_params.get("uv_resolution", 256),
            n_unet_layers=model_params["n_unet_layers"],
            use_expr_mask=model_params.get("use_expr_mask", False),
            static_neck=model_params.get("static_neck", True),
            use_lower_jaw=False,
            n_gaussians_init=model_params["n_gaussians_init"],
            n_points_per_triangle=model_params["n_points_per_triangle"],
            sh_degree=model_params["sh_degree"],
            gaussian_init_type=model_params.get("gaussian_init_type", "scaled"),
        )
        smpl_model = build_smpl_model(load_smpl_pkl(Path(smpl_asset_dir) / "SMPL_NEUTRAL.pkl"),
                                      device=device)
        variant = build_smpl_variant(smpl_model, smpl_asset_dir, config.uv_resolution,
                                     device=device)
        tv, *_ = load_smpl_template(smpl_asset_dir)
        return cls._from_variant(variant, config, tv, scene, opt_params, lpips, seed, device)

    @classmethod
    def _from_variant(cls, variant: Variant, config: FlameAvatarConfig, template_verts, scene,
                      opt_params, lpips, seed, device) -> "AvatarTrainer":
        """Gaussians allocated over the variant's UV remesh, the deform net,
        the parameter bank over the train+test(+target) timesteps
        (cap4d_gaussian_model.py:167-199), zero neck rows and Adam moments."""
        uv = variant.uv
        binding, counts = allocate_gaussians(uv, torch.as_tensor(template_verts, device=device),
                                             config.n_gaussians_init, config.n_points_per_triangle)
        n_faces = uv.remesh_faces.shape[0]
        gauss, aux = G.init_gaussians(
            binding, n_faces, sh_degree=config.sh_degree,
            gaussian_counts=counts if config.gaussian_init_type == "scaled" else None,
            rng=np.random.default_rng(seed), device=device)
        label = "SMPL avatar" if variant.name == "smpl" else "Avatar"
        print(f"{label} init: {len(binding)} gaussians over {n_faces} remesh faces")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            deform_net = make_deform_net(config)
        deform_net.to(device)

        meshes = scene.train_meshes + scene.test_meshes
        base_rot = (scene.tgt_meshes or meshes)[0].get("rot", np.zeros(3, np.float32))
        meshes = meshes + scene.tgt_meshes
        bank = variant.build_bank(meshes, base_rot, device=device)
        neck = torch.zeros((len(meshes), 3), device=device)
        moments = {**G.zero_moments(gauss),
                   "deform_m": {k: torch.zeros_like(p) for k, p in deform_net.named_parameters()},
                   "deform_v": {k: torch.zeros_like(p) for k, p in deform_net.named_parameters()},
                   "neck_m": torch.zeros_like(neck), "neck_v": torch.zeros_like(neck)}
        return cls(variant, config, opt_params, gauss, aux, deform_net, neck, bank, moments,
                   (lpips or LPIPS(None)).to(device),
                   float(getattr(scene, "cameras_extent", 1.0)), device)

    # ------------------------------------------------------------- mesh state

    def _neck_offset(self, t) -> torch.Tensor:
        if self.config.static_neck:
            return torch.zeros(3, device=self.device)
        return bank_row(self.neck_weight, t)

    def mesh_at_timestep(self, timestep: int):
        """Face frames for one timestep (select_mesh_by_timestep)."""
        with torch.no_grad():
            return self.variant.mesh_props(self.deform_net, self.flame_bank, int(timestep),
                                           self._neck_offset(int(timestep)))

    def camera_tensors(self, cam) -> Dict[str, torch.Tensor]:
        """The camera's matrices (and image and mask, when it has them) on the
        trainer's device, cached on the camera."""
        cache = getattr(cam, "_tensors", None)
        if cache is None or cache["rt"].device != self.device:
            cache = {"rt": torch.as_tensor(cam.rt, dtype=torch.float32, device=self.device),
                     "K": torch.as_tensor(cam.intrinsics, dtype=torch.float32, device=self.device)}
            if cam.image is not None:
                cache["gt"] = torch.as_tensor(cam.image, dtype=torch.float32, device=self.device)
                mask = cam.mask if cam.mask is not None else np.ones((cam.height, cam.width))
                cache["mask"] = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
            cam._tensors = cache
        return cache

    # ------------------------------------------------------------- schedules

    def learning_rates(self, iteration: int) -> Dict[str, float]:
        opt, sls = self.opt, self.spatial_lr_scale
        return {
            "xyz": expon_lr(iteration, opt["position_lr_init"] * sls, opt["position_lr_final"] * sls,
                            lr_delay_mult=opt["position_lr_delay_mult"],
                            max_steps=opt["position_lr_max_steps"]),
            "deform": expon_lr(iteration, opt["deform_net_lr_init"], opt["deform_net_lr_final"],
                               lr_delay_mult=opt["deform_net_lr_delay_mult"],
                               max_steps=opt["deform_net_lr_max_steps"]),
            "neck": expon_lr(iteration, opt["neck_lr_init"], opt["neck_lr_final"],
                             lr_delay_mult=opt["neck_lr_delay_mult"],
                             max_steps=opt["neck_lr_max_steps"]),
        }

    def schedule_tables(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Float32 tables of the schedules on the device, built on the host in
        float64 from the same expressions a host-side step would use: per
        iteration 0..n-1 the :data:`ITER_COLUMNS` (the three learning rates,
        w_LPIPS·λ_LPIPS, and the photometric weight 1 − λ_LPIPS, 1 without
        LPIPS weights), per Adam step 0..n-1 the :data:`ADAM_COLUMNS`
        (1 − β^step). Cached; rebuilt only for a larger ``n``."""
        if self._tables is not None and self._tables[0].shape[0] >= n:
            return self._tables
        rows = []
        for it in range(n):
            lr, lam = self.learning_rates(it), lpips_ramp(it, self.opt)
            rows.append([lr["xyz"], lr["deform"], lr["neck"], self.opt["w_lpips"] * lam,
                         (1 - lam) if self.lpips.available else 1.0])
        adam = [[1 - ADAM_B1 ** s, 1 - ADAM_B2 ** s] for s in range(n)]
        self._tables = tuple(torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                                             device=self.device) for a in (rows, adam))
        return self._tables

    def schedule(self, iteration, adam_step) -> Dict[str, torch.Tensor]:
        """The schedules of one iteration as 0-d tensors: ``iteration`` and
        ``adam_step`` are ints (rows read as views) or one-element index
        tensors (rows gathered on the device)."""
        need = 1 + max(int(iteration), int(adam_step)) if not torch.is_tensor(iteration) else 0
        per_iter, per_adam = self.schedule_tables(need)
        row = bank_row(per_iter, iteration).unbind(0)
        bias = bank_row(per_adam, adam_step).unbind(0)
        return dict(zip(ITER_COLUMNS + ADAM_COLUMNS, row + bias))

    # ------------------------------------------------------------- training

    def losses(self, cam: Dict[str, Any], sched: Dict[str, torch.Tensor], m2d: torch.Tensor,
               width: int, height: int, budget: Optional[int] = None):
        """All loss terms of one iteration (train.py:125-177) → (losses,
        render output). ``cam`` holds rt, K, gt, mask and the timestep t (an
        int or a one-element tensor); ``sched`` is :meth:`schedule`'s."""
        opt = self.opt
        t = cam["t"]
        gp = self.gauss
        mesh = self.variant.mesh_props(self.deform_net, self.flame_bank, t, self._neck_offset(t))
        world = G.world_gaussians(gp, self.aux, mesh.face_pack)
        out = rasterize_gaussians(world["means3d"], world["quats"], world["scales"],
                                  world["opacities"], world["sh"], cam["rt"], cam["K"],
                                  width, height, sh_degree=self.active_sh_degree,
                                  means2d_offset=m2d, budget=budget)
        mask = cam["mask"][..., None]
        image_cf = (out["render"] * mask).permute(2, 0, 1)
        gt_cf = (cam["gt"] * mask).permute(2, 0, 1)

        losses = {}
        lam_ds = opt["lambda_dssim"]
        # the reference hands the photometric objective to LPIPS as λ ramps
        # to 1 (train.py:152-165); without LPIPS weights l1/SSIM keep full
        # weight (photo_w is then 1)
        photo_w = sched["photo_w"]
        losses["l1"] = l1_loss(image_cf, gt_cf) * (1 - lam_ds) * photo_w
        losses["ssim"] = (1 - ssim(image_cf, gt_cf, channel_first=True)) * lam_ds * photo_w
        if self.lpips.available:
            losses["lpips"] = sched["lpips_w"] * self.lpips(
                image_cf.permute(1, 2, 0), gt_cf.permute(1, 2, 0))
        vis = out["visibility"].to(torch.float32)
        nvis = torch.clamp(vis.sum(), min=1)
        xyz_pen = F.relu(safe_norm(gp["xyz"], dim=1) - opt["threshold_xyz"])
        losses["xyz"] = (xyz_pen * vis).sum() / nvis * opt["lambda_xyz"]
        if opt["lambda_scale"] != 0:
            sc_pen = safe_norm(F.relu(torch.exp(gp["scaling"]) - opt["threshold_scale"]), dim=1)
            losses["scale"] = (sc_pen * vis).sum() / nvis * opt["lambda_scale"]
        if opt["lambda_laplacian"] != 0:
            losses["lap"] = laplacian_loss(mesh.deform_output) * opt["lambda_laplacian"]
        if opt["lambda_relative_deform"] != 0:
            neutral = G.world_gaussians(gp, self.aux, mesh.neutral_pack)["means3d"]
            losses["deform"] = (relative_deformation_loss(world["means3d"], neutral)
                                * opt["lambda_relative_deform"])
        if opt["lambda_relative_rot"] != 0:
            losses["rot"] = (relative_rotation_loss_pack(mesh.neutral_pack, mesh.face_pack)
                             * opt["lambda_relative_rot"])
        if opt["lambda_neck"] != 0 and not self.config.static_neck:
            losses["neck"] = safe_norm(bank_row(self.neck_weight, t)) * opt["lambda_neck"]
        return losses, out

    def _gradients(self, cam, sched, width: int, height: int, budget: Optional[int] = None):
        names = [k for k, _ in self.deform_net.named_parameters()]
        dparams = [p for _, p in self.deform_net.named_parameters()]
        for f in G.FIELDS:
            self.gauss[f].requires_grad_(True)
        self.neck_weight.requires_grad_(True)
        m2d = torch.zeros((self.n_active, 2), device=self.device, requires_grad=True)
        try:
            losses, out = self.losses(cam, sched, m2d, width, height, budget)
            total = sum(losses.values())
            leaves = [self.gauss[f] for f in G.FIELDS] + dparams + [self.neck_weight, m2d]
            g = torch.autograd.grad(total, leaves, allow_unused=True)
        finally:
            for f in G.FIELDS:
                self.gauss[f].requires_grad_(False)
            self.neck_weight.requires_grad_(False)
        g = [torch.zeros_like(p) if gi is None else gi for gi, p in zip(g, leaves)]
        nf, nd = len(G.FIELDS), len(dparams)
        grads = {"gauss": dict(zip(G.FIELDS, g[:nf])), "deform": dict(zip(names, g[nf:nf + nd])),
                 "neck": g[-2], "m2d": g[-1]}
        losses = {k: v.detach() for k, v in losses.items()}
        losses["total"] = total.detach()
        return losses, out, grads

    def host_camera(self, cam) -> Dict[str, Any]:
        """A camera's step inputs chosen on the host (:meth:`camera_tensors`
        and its timestep as an int)."""
        return dict(self.camera_tensors(cam), t=int(cam.timestep))

    def gradients(self, cam, iteration: int):
        """Losses, render output and gradients of one iteration, before any
        update: grads["gauss"][field], grads["deform"][name], grads["neck"],
        grads["m2d"]."""
        return self._gradients(self.host_camera(cam), self.schedule(iteration, 1),
                               cam.width, cam.height)

    @torch.no_grad()
    def _adam(self, grads, sched: Dict[str, torch.Tensor]) -> None:
        """Per-group Adam (cap4d_gaussian_model.py:381-416), written into the
        parameters' and moments' own storage."""
        opt, mo = self.opt, self.moments
        bias = (sched["bias1"], sched["bias2"])
        g_lr = {"xyz": sched["lr_xyz"], "features_dc": opt["feature_lr"],
                "features_rest": opt["feature_lr"] / 20.0, "opacity": opt["opacity_lr"],
                "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"]}
        for f in G.FIELDS:
            new = adam_terms(self.gauss[f], grads["gauss"][f], mo["gauss_m"][f],
                             mo["gauss_v"][f], g_lr[f], *bias)
            for dst, src in zip((self.gauss[f], mo["gauss_m"][f], mo["gauss_v"][f]), new):
                dst.copy_(src)
        for name, p in self.deform_net.named_parameters():
            new = adam_terms(p, grads["deform"][name], mo["deform_m"][name], mo["deform_v"][name],
                             sched["lr_deform"], *bias, wd=opt["deform_net_w_decay"])
            for dst, src in zip((p, mo["deform_m"][name], mo["deform_v"][name]), new):
                dst.copy_(src)
        if not self.config.static_neck:
            # SparseAdam: only the observed rows update (eps 1e-18)
            g = grads["neck"]
            rows = (g.abs().sum(-1, keepdim=True) > 0)
            new = adam_terms(self.neck_weight, g, mo["neck_m"], mo["neck_v"], sched["lr_neck"],
                             *bias, eps=1e-18)
            for dst, src in zip((self.neck_weight, mo["neck_m"], mo["neck_v"]), new):
                dst.copy_(torch.where(rows, src, dst))

    def apply_adam(self, grads, iteration: int, adam_step: int) -> None:
        """Per-group Adam at a host-chosen iteration and Adam step."""
        self._adam(grads, self.schedule(iteration, adam_step))

    def step(self, cam: Dict[str, Any], sched: Dict[str, torch.Tensor], width: int, height: int,
             budget: Optional[int] = None):
        """One full iteration from device inputs: gradients, densification
        statistics, Adam, all in place. Returns the detached losses (device
        tensors) and, with a pair ``budget``, the render's (1,) int32
        overflow count (else None); an iteration whose count is not 0 rendered
        incompletely, and its caller restores the state it had before."""
        losses, out, grads = self._gradients(cam, sched, width, height, budget)
        with torch.no_grad():
            G.add_densification_stats(self.aux, grads["m2d"], out["visibility"], out["radii"])
        self._adam(grads, sched)
        return losses, out.get("n_overflow")

    def train_step(self, cam, iteration: int, adam_step: int) -> Dict[str, torch.Tensor]:
        """:meth:`step` for one host-chosen camera, iteration and Adam step,
        with the exact (unbudgeted) pair build. Returns the detached losses
        (device tensors: no host sync)."""
        losses, _ = self.step(self.host_camera(cam), self.schedule(iteration, adam_step),
                              cam.width, cam.height)
        self.iteration = iteration
        return losses

    def written_state(self) -> List[torch.Tensor]:
        """Every tensor :meth:`step` writes, in a fixed order."""
        mo = self.moments
        return ([self.gauss[f] for f in G.FIELDS]
                + [mo[k][f] for k in ("gauss_m", "gauss_v") for f in G.FIELDS]
                + [self.aux[k] for k in ("max_radii2d", "xyz_gradient_accum", "denom")]
                + [p.data for p in self.deform_net.parameters()]
                + [mo[k][n] for k in ("deform_m", "deform_v")
                   for n, _ in self.deform_net.named_parameters()]
                + [self.neck_weight, mo["neck_m"], mo["neck_v"]])

    def read_state(self) -> List[torch.Tensor]:
        """The tensors :meth:`step` reads and never writes (the store's
        binding, the parameter bank, the schedule tables)."""
        return ([self.aux["binding"], self.aux["binding_counter"]]
                + list(self.flame_bank.values()) + list(self._tables or ()))

    @torch.no_grad()
    def densify(self, timestep: int, generator: torch.Generator, size_threshold) -> None:
        """densify_and_prune on the current store (train.py:229-240)."""
        mesh = self.mesh_at_timestep(timestep)
        n = self.n_active
        noise = tuple(torch.randn((n, 3), generator=generator, device=self.device)
                      for _ in range(2))
        gm = {k: self.moments[k] for k in ("gauss_m", "gauss_v")}
        self.gauss, self.aux, gm = G.densify_and_prune(
            self.gauss, self.aux, gm, mesh.face_scaling, noise,
            max_grad=self.opt["densify_grad_threshold"], min_opacity=0.005,
            extent=self.spatial_lr_scale, percent_dense=self.opt["percent_dense"],
            max_screen_size=size_threshold)
        self.moments.update(gm)

    def reset_opacity(self) -> None:
        """In place: a captured step keeps reading the same tensors."""
        G.reset_opacity(self.gauss, {k: self.moments[k] for k in ("gauss_m", "gauss_v")})

    # ------------------------------------------------------------- render

    def _render_view(self, rt, K, t, width: int, height: int, sh_degree: int,
                     compute_depth: bool, clip: bool, plain: bool = False,
                     budget: Optional[int] = None):
        """The inference render of camera (rt, K) at timestep ``t`` (an int or
        a one-element index tensor) → (render output, mesh)."""
        mesh = self.variant.mesh_props(self.deform_net, self.flame_bank, t, self._neck_offset(t))
        far = 1e3
        if clip:
            v = mesh.verts
            center = (v.max(dim=0).values + v.min(dim=0).values) / 2.0
            cam_pos = -(rt[:3, :3].T @ rt[:3, 3])
            far = torch.linalg.norm(center - cam_pos) + 0.025
        world = G.world_gaussians(self.gauss, self.aux, mesh.face_pack)
        out = rasterize_gaussians(world["means3d"], world["quats"], world["scales"],
                                  world["opacities"], world["sh"], rt, K, width, height,
                                  sh_degree=sh_degree, far=far, render_depth=compute_depth,
                                  plain=plain, budget=budget)
        return out, mesh

    @torch.no_grad()
    def render_camera(self, cam, timestep: int, sh_degree: Optional[int] = None,
                      compute_depth: bool = False, clip: bool = False,
                      plain: bool = False) -> Dict[str, torch.Tensor]:
        """Inference render of one camera (gsplat_renderer.py:20-86). With
        ``clip`` the far plane sits 2.5 cm behind the posed head's centre
        (animate.py:110-117); ``plain`` renders through the plain PyTorch
        compositor instead of K4 (an independent ground truth)."""
        ct = self.camera_tensors(cam)
        sh = self.active_sh_degree if sh_degree is None else sh_degree
        out, _ = self._render_view(ct["rt"], ct["K"], int(timestep), cam.width, cam.height, sh,
                                   compute_depth, clip, plain)
        return out

    @torch.no_grad()
    def render_frame(self, cam: Dict[str, torch.Tensor], width: int, height: int, budget: int,
                     compute_depth: bool = False, clip: bool = True) -> Dict[str, torch.Tensor]:
        """:meth:`render_camera` from device inputs (``cam``: rt, K and the
        one-element timestep t) with the static pair ``budget``, nothing read
        on the host (``avatar/render_graph.py`` captures it). Returns the
        frame quantised on the device ("image", (H, W, 3) uint8: clamped to
        [0, 1], times 255, truncated, as the host's numpy quantisation), the
        float "render", "alpha" (H, W) uint8 (alpha·255 truncated), "depth"
        with ``compute_depth``, the (1,) int32 "n_overflow" (a frame whose
        count is not 0 is incomplete) and the posed mesh's "verts"."""
        out, mesh = self._render_view(cam["rt"], cam["K"], cam["t"], width, height,
                                      self.active_sh_degree, compute_depth, clip, budget=budget)
        res = {"image": (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8),
               "render": out["render"], "alpha": (out["alpha"] * 255).to(torch.uint8),
               "n_overflow": out["n_overflow"], "verts": mesh.verts}
        if compute_depth:
            res["depth"] = out["depth"]
        return res

    @torch.no_grad()
    def candidate_count(self, cam) -> torch.Tensor:
        """The (gaussian, tile) candidates of the training step's render of
        ``cam`` (0-d device tensor; no compositing, no kernel launch)."""
        ct = self.camera_tensors(cam)
        mesh = self.mesh_at_timestep(cam.timestep)
        world = G.world_gaussians(self.gauss, self.aux, mesh.face_pack)
        return count_candidates(world["means3d"], world["quats"], world["scales"], ct["rt"],
                                ct["K"], cam.width, cam.height)

    # ------------------------------------------------------------- checkpoints

    def capture(self) -> Dict[str, Any]:
        """Checkpoint contents as numpy (cap4d_gaussian_model.py:443-456)."""
        np_ = lambda d: {k: v.detach().cpu().numpy() for k, v in d.items()}
        bank = np_(self.flame_bank)
        return {
            "shape": bank[self.shape_key], "base_rot": bank["base_rot"], "bank": bank,
            "deform_net": np_(self.deform_net.state_dict()),
            "gaussians": {
                "active_sh_degree": self.active_sh_degree,
                "params": np_(self.gauss), "aux": np_(self.aux),
                "moments": {k: np_(v) if isinstance(v, dict) else v.cpu().numpy()
                            for k, v in self.moments.items()},
            },
            "neck_weight": self.neck_weight.cpu().numpy(),
        }

    def restore(self, chkpt: Dict[str, Any]) -> None:
        """Inverse of :meth:`capture`; the trainer takes copies (it updates
        its state in place)."""
        t = lambda a: torch.tensor(np.asarray(a), device=self.device)
        g = chkpt["gaussians"]
        self.flame_bank = {k: t(v) for k, v in chkpt["bank"].items()}
        self.flame_bank[self.shape_key] = t(chkpt["shape"])
        self.flame_bank["base_rot"] = t(chkpt["base_rot"])
        self.deform_net.load_state_dict({k: torch.as_tensor(v) for k, v in chkpt["deform_net"].items()})
        self.active_sh_degree = int(g["active_sh_degree"])
        self.gauss = {k: t(v) for k, v in g["params"].items()}
        self.aux = {k: t(v) for k, v in g["aux"].items()}
        self.moments = {k: {n: t(a) for n, a in v.items()} if isinstance(v, dict) else t(v)
                        for k, v in g["moments"].items()}
        self.neck_weight = t(chkpt["neck_weight"])

    def save_checkpoint(self, model_path: Path, iteration: int) -> Path:
        """chkpnt{iter}.pth in the reference's torch.save layout (train.py:248)."""
        from cap4d_torch.avatar.convert_ref import save_reference_checkpoint

        return save_reference_checkpoint(self, Path(model_path) / f"chkpnt{iteration}.pth",
                                         iteration)


def search_max_iteration(model_path: Path) -> Tuple[Optional[int], Optional[Path]]:
    """Newest chkpnt*.pth by iteration number (utils/system_utils.py:26-37)."""
    ckpts = list(Path(model_path).glob("chkpnt*.pth"))
    if not ckpts:
        return None, None
    best = max(ckpts, key=lambda p: int(p.stem.replace("chkpnt", "")))
    return int(best.stem.replace("chkpnt", "")), best
