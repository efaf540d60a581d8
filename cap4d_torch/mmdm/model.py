"""MMDM model assembly: UNet + VAE + conditioning + schedule from a
reference-format ``config_dump.yaml`` (counterpart of
``cap4d_tpu/mmdm/model.py``).

Keeps the reference's YAML schema and checkpoint layout
(``<ckpt_dir>/checkpoints/*.ckpt``, newest by ctime, + ``config_dump.yaml``).
Without a checkpoint the weights are random, drawn as the JAX package's
random-weights mode draws them: N(0, 0.02) for every ≥2-D parameter and
zeros for every ≤1-D one — which zeros every norm scale, so on that path
every GroupNorm/LayerNorm outputs its bias.

``trainable=True`` builds the UNet for training: fp32 parameters that
require gradients, train mode, ``dtype`` as the compute dtype
(``MMDMUNet.compute_dtype``) instead of the weights' dtype; ``remat=True``
checkpoints its blocks. The VAE stays frozen in ``dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from cap4d_torch.mmdm.conditioning import (
    CAP4DConditioning,
    conditioning_forward,
    load_prop_renderer_assets,
)
from cap4d_torch.mmdm.convert import load_mmdm_checkpoint, newest_checkpoint
from cap4d_torch.mmdm.schedule import DiffusionSchedule, make_mmdm_schedule
from cap4d_torch.mmdm.unet import MMDMUNet
from cap4d_torch.mmdm.vae import SCALE_FACTOR, AutoencoderKL
from cap4d_torch.utils.config import load_yaml
from cap4d_torch.utils.device import resolve_device

DEFAULT_FLAME_ASSETS = Path("data/assets/flame")


def init_random_(module: torch.nn.Module, seed: int) -> None:
    """N(0, 0.02) for ≥2-D parameters, zeros for ≤1-D ones, from ``seed``."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim <= 1:
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)


def _u8(x: torch.Tensor) -> torch.Tensor:
    """[-1,1] image → uint8 by clip → ×255 → truncation."""
    return (torch.clamp((x + 1.0) / 2.0, 0.0, 1.0) * 255.0).to(torch.uint8)


@dataclass
class MMDM:
    """The morphable multi-view diffusion model (inference bundle)."""

    unet: MMDMUNet
    vae: AutoencoderKL
    cond_model: CAP4DConditioning
    schedule: DiffusionSchedule
    device: torch.device
    scale_factor: float = SCALE_FACTOR
    latent_size: int = 64
    n_frames: int = 8
    cfg_probability: float = 0.1

    @classmethod
    def from_config(
        cls,
        config: Dict[str, Any] | str | Path,
        ckpt_path: Optional[str | Path] = None,
        flame_asset_dir: str | Path = DEFAULT_FLAME_ASSETS,
        dtype: torch.dtype = torch.float32,
        device=None,
        remat: bool = False,
        trainable: bool = False,
    ) -> "MMDM":
        """Build from a reference config_dump.yaml dict or path.

        ckpt_path: directory holding checkpoints/*.ckpt (the newest by ctime
        is loaded); None → random weights. ``device`` None means the card.
        ``trainable``/``remat``: see the module docstring."""
        dev = resolve_device(device)
        if not isinstance(config, dict):
            config = load_yaml(config)
        mp = config["model"]["params"]
        up = mp["unet_config"]["params"]
        cp = mp["cond_stage_config"]["params"]
        fp = mp["first_stage_config"]["params"]
        dd = fp["ddconfig"]

        with torch.device("meta"):
            unet = MMDMUNet(
                in_channels=up["in_channels"],
                out_channels=up["out_channels"],
                model_channels=up["model_channels"],
                channel_mult=tuple(up["channel_mult"]),
                num_res_blocks=up["num_res_blocks"],
                attention_resolutions=tuple(up["attention_resolutions"]),
                num_head_channels=up["num_head_channels"],
                condition_channels=up["condition_channels"],
                time_steps=up["time_steps"],
                temporal_mode=up.get("temporal_mode", "3d"),
            )
            vae = AutoencoderKL(
                embed_dim=fp["embed_dim"], ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
                num_res_blocks=dd["num_res_blocks"], z_channels=dd["z_channels"],
                out_ch=dd["out_ch"], in_channels=dd["in_channels"],
            )
        unet.to_empty(device=dev)
        vae.to_empty(device=dev)
        if ckpt_path is None:
            init_random_(unet, 0)
            init_random_(vae, 1)
        else:
            latest = newest_checkpoint(ckpt_path)
            print(f"Loading MMDM weights from {latest}")
            load_mmdm_checkpoint(latest, unet, vae)
        if trainable:
            unet.train().requires_grad_(True)
            unet.compute_dtype = dtype
        else:
            unet.set_dtype(dtype).eval().requires_grad_(False)
        unet.remat = remat
        vae.set_dtype(dtype).eval().requires_grad_(False)
        if dev.type == "cuda":
            # conv weights in the activations' channels-last layout
            unet.to(memory_format=torch.channels_last)
            vae.to(memory_format=torch.channels_last)

        assets = load_prop_renderer_assets(
            Path(flame_asset_dir) / "cap4d_flame_template.obj",
            Path(flame_asset_dir) / "head_vertices.txt", device=dev)
        cond_model = CAP4DConditioning(
            assets=assets,
            image_size=cp["image_size"],
            positional_channels=cp["positional_channels"],
            positional_multiplier=cp.get("positional_multiplier", 1.0),
            super_resolution=cp.get("super_resolution", 2),
            use_ray_directions=cp.get("use_ray_directions", True),
            use_expr_deformation=cp.get("use_expr_deformation", True),
            use_crop_mask=cp.get("use_crop_mask", False),
        )
        schedule = make_mmdm_schedule(
            timesteps=mp["timesteps"],
            linear_start=mp["linear_start"],
            linear_end=mp["linear_end"],
            zero_snr_shift=mp.get("zero_snr_shift", True),
            shift=mp.get("shift_schedule", False),
            sqrt_shift=mp.get("sqrt_shift", False),
            minus_one_shift=mp.get("minus_one_shift", True),
            negative_shift=mp.get("negative_shift", False),
            n_frames=mp["n_frames"],
            image_size=mp["image_size"],
        )
        return cls(unet=unet, vae=vae, cond_model=cond_model, schedule=schedule,
                   device=dev, scale_factor=mp.get("scale_factor", SCALE_FACTOR),
                   latent_size=mp["image_size"], n_frames=mp["n_frames"],
                   cfg_probability=mp.get("cfg_probability", 0.1))

    # ---------------- first stage ----------------

    @torch.no_grad()
    def encode_images(self, images: np.ndarray, noise: Optional[np.ndarray] = None,
                      generator: Optional[torch.Generator] = None,
                      chunk: int = 8) -> torch.Tensor:
        """(N, H, W, 3) in [-1,1] → scaled posterior-sampled latents (N, h, w, 4).

        ``noise`` (N, h, w, 4) is the posterior noise; None draws it from
        ``generator`` on the model's device."""
        n, H, W, _ = images.shape
        f = 2 ** (len(self.vae.encoder.down) - 1)
        shape = (n, H // f, W // f, self.vae.quant_conv.out_channels // 2)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=self.device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        if tuple(noise.shape) != shape:
            raise ValueError(f"posterior noise must be {shape}, got {tuple(noise.shape)}")
        outs = []
        for i in range(0, n, chunk):
            x = torch.as_tensor(images[i : i + chunk], dtype=torch.float32, device=self.device)
            outs.append(self.vae.encode(x, noise[i : i + chunk]))
        return torch.cat(outs, dim=0) * self.scale_factor

    @torch.no_grad()
    def decode_latents(self, z, chunk: int = 8, as_uint8: bool = False) -> np.ndarray:
        """Scaled latents (N, h, w, 4) → images (N, H, W, 3) in [-1,1], or
        uint8 [0,255] with ``as_uint8`` (converted on the device)."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device)
        outs = []
        for i in range(0, z.shape[0], chunk):
            img = self.vae.decode(z[i : i + chunk] / self.scale_factor)
            outs.append(_u8(img) if as_uint8 else img)
        return torch.cat(outs, dim=0).cpu().numpy()

    # ---------------- conditioning ----------------

    @torch.no_grad()
    def prepare_conditioning(self, cond_batch: Dict[str, np.ndarray],
                             z: Optional[torch.Tensor] = None,
                             chunk: int = 32) -> Dict[str, torch.Tensor]:
        """Per-frame conditional bank on the device, time axis folded away.

        cond_batch arrays are (N, 1, ...) as produced by build_frame_set.
        Returns {"pos_enc": (N,H,W,50), "z_input": (N,h,w,4), "ref_mask": (N,h,w,1)}.
        The unconditional bank is all zeros and is made by the sampler."""
        n = cond_batch["verts_2d"].shape[0]
        outs = []
        for i in range(0, n, chunk):
            piece = {k: torch.as_tensor(v[i : i + chunk], dtype=torch.float32, device=self.device)
                     for k, v in cond_batch.items()}
            if z is not None:
                piece["z"] = z[i : i + chunk, None]
            outs.append(conditioning_forward(self.cond_model, piece, unconditional=False))
        merged = {}
        for key in outs[0]:
            merged[key] = None if outs[0][key] is None else torch.cat([o[key] for o in outs])[:, 0]
        if merged.get("z_input") is None:
            merged["z_input"] = torch.zeros(
                (n, self.latent_size, self.latent_size, self.unet.in_channels), device=self.device)
        if merged["ref_mask"].shape[-1] != 1:  # (N, 1, h, w) → (N, h, w, 1)
            merged["ref_mask"] = merged["ref_mask"].movedim(1, -1)
        return merged
