"""CAP4D conditioning encoder: FLAME-rendered 50-channel condition maps
(counterpart of ``cap4d_tpu/mmdm/conditioning.py``).

Channel layout (NHWC, last axis), 50 channels with the shipped config:
  42  sinusoidal-encoded canonical-position map (14 per xyz dim, the
      ``(c f)`` interleave: per input dim [sin(x·2^0..2^6), cos(x·2^0..2^6)])
   3  expression-offset map (normalised by std 0.0104)
   3  camera ray map (rotated into the reference camera frame)
   1  reference mask
   1  out-of-crop mask

The rasterization (kernel K3 on the card) runs at 2× super-resolution and is
area-pooled to the latent grid. It runs once per frame before sampling.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from cap4d_torch.ops.rasterize import interpolate_face_attributes, load_obj, rasterize_meshes


def positional_encoding(x: torch.Tensor, channels_per_dim: int) -> torch.Tensor:
    """(..., D) → (..., D·channels_per_dim): per input dim
    [sin(x·f0..fn), cos(x·f0..fn)] with freqs 2^[0..n-1]."""
    n_ch = channels_per_dim // 2
    freqs = 2.0 ** torch.arange(n_ch, dtype=x.dtype, device=x.device)
    ang = x[..., None] * freqs
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return emb.reshape(*x.shape[:-1], x.shape[-1] * channels_per_dim)


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W, C) average-pool by an integer factor."""
    if factor == 1:
        return x
    *lead, H, W, C = x.shape
    x = x.reshape(*lead, H // factor, factor, W // factor, factor, C)
    return x.mean(dim=(-4, -2))


@dataclass
class PropRendererAssets:
    """Template mesh + masks backing the conditioning rasterizer."""

    faces: torch.Tensor       # (F, 3) int64
    props: torch.Tensor       # (V, 3) normalised canonical positions
    face_mask: torch.Tensor   # (F,) bool — head + mouth faces only


def load_prop_renderer_assets(template_path: str | Path, head_vert_path: str | Path,
                              n_mouth_verts: int = 200, device="cpu") -> PropRendererAssets:
    verts, faces, _uvs, _fuv = load_obj(template_path)
    vert_mask = np.zeros(verts.shape[0], bool)
    head_verts = np.genfromtxt(head_vert_path).astype(np.int64)
    vert_mask[head_verts] = True
    vert_mask[-n_mouth_verts:] = True
    face_mask = vert_mask[faces].max(axis=-1)
    props = verts - verts.mean(axis=-2, keepdims=True)
    props = props / props.max()
    return PropRendererAssets(
        faces=torch.as_tensor(faces, dtype=torch.int64, device=device),
        props=torch.as_tensor(props, dtype=torch.float32, device=device),
        face_mask=torch.as_tensor(face_mask, device=device),
    )


def render_prop_maps(assets: PropRendererAssets, verts_ndc: torch.Tensor,
                     extra_prop: torch.Tensor, image_size: int) -> Dict[str, torch.Tensor]:
    """Rasterize canonical positions + a per-vertex property map.

    Returns {"pose_map": (N,H,W,3), "prop_map": (N,H,W,D), "mask": (N,H,W,1)}."""
    n = verts_ndc.shape[0]
    frag = rasterize_meshes(verts_ndc, assets.faces, (image_size, image_size))
    base_props = assets.props[assets.faces]                  # (F, 3, 3)
    attrs = torch.cat([base_props[None].expand(n, *base_props.shape),
                       extra_prop[:, assets.faces]], dim=-1)  # (N, F, 3, 3+D)
    maps = interpolate_face_attributes(frag.pix_to_face, frag.bary_coords, attrs)
    covered = frag.pix_to_face >= 0
    head_face = assets.face_mask[frag.pix_to_face.clamp(min=0).long()]
    return {"pose_map": maps[..., :3], "prop_map": maps[..., 3:],
            "mask": (covered & head_face)[..., None]}


@dataclass
class CAP4DConditioning:
    """Conditioning encoder (the cond_stage_model); no trainable parameters."""

    assets: PropRendererAssets
    image_size: int = 64
    positional_channels: int = 42
    positional_multiplier: float = 1.0
    super_resolution: int = 2
    use_ray_directions: bool = True
    use_expr_deformation: bool = True
    use_crop_mask: bool = True
    std_expr_deformation: float = 0.0104

    @property
    def total_channels(self) -> int:
        c = self.positional_channels + 1  # + ref mask
        if self.use_crop_mask:
            c += 1
        if self.use_ray_directions:
            c += 3
        if self.use_expr_deformation:
            c += 3
        return c

    def get_vis(self, enc: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Debug visualisations of the encoded maps."""
        vis = {}
        n_pos = self.positional_channels // 3
        for i in range(n_pos - 2, n_pos):
            vis[f"pose_map_{i}"] = enc[..., [i, i + n_pos, i + n_pos * 2]]
        c = self.positional_channels
        if self.use_expr_deformation:
            vis["expr_disp"] = enc[..., c : c + 3]
            c += 3
        if self.use_ray_directions:
            vis["ray_map"] = enc[..., c : c + 3]
            c += 3
        vis["ref_mask"] = enc[..., [c] * 3]
        c += 1
        if self.use_crop_mask:
            vis["crop_mask"] = enc[..., [c] * 3]
        return vis


def conditioning_forward(cond: CAP4DConditioning, batch: Dict[str, torch.Tensor],
                         unconditional: bool = True) -> Dict[str, torch.Tensor]:
    """Build {"pos_enc": (B,T,H,W,C), "z_input", "ref_mask"} from a frame batch.

    batch: verts_2d (B,T,V,3) NDC, offsets_3d (B,T,V,3), ray_map (B,T,3,h,w),
    reference_mask (B,T,h,w), out_crop_mask (B,T,h,w), optional z."""
    verts = batch["verts_2d"]
    B, T = verts.shape[:2]
    img_size = cond.image_size
    ref_mask = batch["reference_mask"][:, :, None]  # (B,T,1,h,w)
    z_input = batch.get("z")

    if unconditional:
        pos_enc = torch.zeros((B, T, img_size, img_size, cond.total_channels),
                              device=verts.device)
        if z_input is not None:
            z_input = z_input * 0.0
        return {"pos_enc": pos_enc, "z_input": z_input, "ref_mask": ref_mask}

    offsets = batch["offsets_3d"] / cond.std_expr_deformation
    verts_f = verts.reshape(B * T, *verts.shape[2:])
    offsets_f = offsets.reshape(B * T, *offsets.shape[2:])
    sr_size = img_size * cond.super_resolution
    maps = render_prop_maps(
        cond.assets, verts_f,
        offsets_f if cond.use_expr_deformation else offsets_f[..., :0],
        sr_size)

    enc = positional_encoding(maps["pose_map"] * cond.positional_multiplier,
                              cond.positional_channels // 3)
    if cond.use_expr_deformation:
        enc = torch.cat([enc, maps["prop_map"]], dim=-1)
    enc = enc * maps["mask"]
    enc = area_downsample(enc, cond.super_resolution)
    enc = enc.reshape(B, T, img_size, img_size, -1)
    if cond.use_ray_directions:
        enc = torch.cat([enc, batch["ray_map"].permute(0, 1, 3, 4, 2)], dim=-1)
    enc = torch.cat([enc, ref_mask.permute(0, 1, 3, 4, 2)], dim=-1)
    if cond.use_crop_mask:
        enc = torch.cat([enc, batch["out_crop_mask"][..., None]], dim=-1)
    return {"pos_enc": enc, "z_input": z_input, "ref_mask": ref_mask}
