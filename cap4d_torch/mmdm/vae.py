"""SD 2.1 KL autoencoder (AutoencoderKL) in PyTorch (counterpart of
``cap4d_tpu/mmdm/vae.py``).

Parameter names carry the reference state-dict keys (the image of
``cap4d_tpu/mmdm/convert.py:87`` ``vae_torch_key``). Activations are NHWC
like the UNet's. The VAE's GroupNorms and its single-head mid attention are
plain math in the JAX package (not its kernels), and so they are here: the
norms call the plain GroupNorm, the attention is an fp32-softmax einsum.
The stride-2 downsample pads asymmetrically (right and bottom by one), and
the posterior noise of ``encode`` is passed in by the caller.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cap4d_torch.mmdm.unet import conv_nhwc
from cap4d_torch.ops.norms import group_norm_silu_plain

SCALE_FACTOR = 0.18215


class Normalize(nn.Module):
    """GroupNorm(32, eps 1e-6) with fp32 statistics, optional SiLU."""

    def __init__(self, channels: int, silu: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.silu = silu

    def forward(self, x):
        return group_norm_silu_plain(x, self.weight, self.bias, 32, 1e-6, self.silu)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = Normalize(in_ch, silu=True)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = Normalize(out_ch, silu=True)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = conv_nhwc(self.conv1, self.norm1(x))
        h = conv_nhwc(self.conv2, self.norm2(h))
        if self.nin_shortcut is not None:
            x = conv_nhwc(self.nin_shortcut, x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head QKV attention over all pixels, 1x1 convs."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = Normalize(ch)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.norm(x)
        q = conv_nhwc(self.q, h).reshape(B, H * W, C)
        k = conv_nhwc(self.k, h).reshape(B, H * W, C)
        v = conv_nhwc(self.v, h).reshape(B, H * W, C)
        sim = torch.einsum("bic,bjc->bij", q.float(), k.float())
        attn = torch.softmax(sim * (C ** -0.5), dim=-1)
        h = torch.einsum("bij,bjc->bic", attn.to(v.dtype), v).reshape(B, H, W, C)
        return x + conv_nhwc(self.proj_out, h)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x):
        return conv_nhwc(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return conv_nhwc(self.conv, x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))


class _Level(nn.Module):
    def __init__(self, blocks, resample: Optional[nn.Module], resample_name: str):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            self.add_module(resample_name, resample)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, in_channels=3,
                 z_channels=4, double_z=True):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        cur = ch
        for i, m in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(cur, ch * m))
                cur = ch * m
            last = i == len(ch_mult) - 1
            self.down.append(_Level(blocks, None if last else Downsample(cur), "downsample"))
        self.mid = _Mid(cur)
        self.norm_out = Normalize(cur, silu=True)
        self.conv_out = nn.Conv2d(cur, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x):
        h = conv_nhwc(self.conv_in, x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return conv_nhwc(self.conv_out, self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, ch=128, out_ch=3, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels = [None] * len(ch_mult)
        cur = block_in
        for i in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(cur, ch * ch_mult[i]))
                cur = ch * ch_mult[i]
            levels[i] = _Level(blocks, Upsample(cur) if i != 0 else None, "upsample")
        self.up = nn.ModuleList(levels)
        self.norm_out = Normalize(cur, silu=True)
        self.conv_out = nn.Conv2d(cur, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.mid(conv_nhwc(self.conv_in, z))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return conv_nhwc(self.conv_out, self.norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, embed_dim=4, ch=128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks=2, z_channels=4, out_ch=3, in_channels=3):
        super().__init__()
        self.encoder = Encoder(ch, tuple(ch_mult), num_res_blocks, in_channels, z_channels)
        self.decoder = Decoder(ch, out_ch, tuple(ch_mult), num_res_blocks, z_channels)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def set_dtype(self, dtype: torch.dtype) -> "AutoencoderKL":
        """Cast convolutions to ``dtype``; norms stay fp32."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)
        return self

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,H,W,3) in [-1,1] → posterior (mean, logvar), each (B,h,w,4) fp32."""
        moments = conv_nhwc(self.quant_conv, self.encoder(x.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean.float(), logvar.clamp(-30.0, 20.0).float()

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Posterior sample mean + std·noise (noise given) or the mode;
        UNSCALED latents."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise.to(mean)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """UNSCALED latents (B,h,w,4) → image (B,H,W,3), fp32."""
        return self.decoder(conv_nhwc(self.post_quant_conv, z.to(self.dtype))).float()
