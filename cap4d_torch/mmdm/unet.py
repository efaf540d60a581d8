"""MMDM UNet in PyTorch (counterpart of ``cap4d_tpu/mmdm/unet.py``).

Topology (shipped config): model_channels 320, channel_mult (1,2,4,4),
2 res blocks, attention at ds ∈ {1,2,4}, heads of 64, "3d" joint multi-view
attention at mult ≥ 2, zero-init 50→320 ``cond_linear`` added after input
block 0, reference-slot substitution of latents and noise.

Module and parameter names carry the reference torch state-dict keys (the
image of ``cap4d_tpu/mmdm/convert.py:52`` ``unet_torch_key``), so a released
checkpoint loads with ``load_state_dict(strict=True)``: the index-named
children of the reference's ``nn.Sequential`` blocks are ``nn.ModuleDict``
entries keyed "0", "2", ...

Layout: activations are NHWC tensors throughout (latents (B, T, H, W, C) at
the boundary); convolutions see them through a channels-last NCHW view, and
the GroupNorm kernel K2 and the attention kernel K1 read them in place.
Every GroupNorm of the UNet (ResBlocks, transformer ``norm``, ``out``) goes
through K2 and every attention through K1 on the card; ``use_plain_ops``
switches both to their plain versions for comparisons. The GEGLU gate uses
the tanh-approximated GELU, as flax's ``nn.gelu`` does in the JAX package.

Two precisions, as flax separates ``dtype`` from ``param_dtype``:

- inference casts the weights themselves (``set_dtype``): convolutions and
  linears in the compute dtype, GroupNorm and LayerNorm parameters fp32;
- training keeps every parameter (and so every gradient and AdamW moment)
  fp32 and sets ``compute_dtype``: the forward then runs under
  ``torch.autocast``, which hands each convolution and linear bf16 copies of
  its weights and inputs, as flax's ``dtype=bfloat16`` does. Autocast was
  picked over explicit casts because it leaves every module's forward as
  the inference path runs it, keeps LayerNorm in fp32 by its own rules, and
  is recorded and replayed by ``torch.utils.checkpoint``. Its bf16
  activations are what K1/K6 take; fp32 activations on the card raise in
  K1, so training on the card runs bf16.

``remat=True`` wraps every ResBlock and SpatioTemporalTransformer in
``torch.utils.checkpoint`` (non-reentrant) while gradients are recorded, as
``cap4d_tpu/mmdm/unet.py`` wraps them in ``nn.remat``: their activations are
recomputed in the backward, so K1 and K2 run twice per training forward.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cap4d_torch.ops.attention import attention_mode_reshape
from cap4d_torch.ops.flash_attention import flash_attention
from cap4d_torch.ops.norms import group_norm_silu


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, [cos | sin] order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW ``nn.Conv2d`` to an NHWC tensor (channels-last view)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


class GroupNorm32(nn.Module):
    """GroupNorm with fp32 statistics over NHWC input, optional fused SiLU;
    runs kernel K2 on the card."""

    def __init__(self, channels: int, eps: float = 1e-5, fuse_silu: bool = False,
                 num_groups: int = 32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps, self.fuse_silu, self.num_groups = eps, fuse_silu, num_groups
        self.plain = False

    def forward(self, x):
        return group_norm_silu(x, self.weight, self.bias, self.num_groups, self.eps,
                               self.fuse_silu, plain=self.plain)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 regardless of the activation dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, emb_ch: int):
        super().__init__()
        self.in_layers = nn.ModuleDict({"0": GroupNorm32(in_ch, fuse_silu=True),
                                        "2": nn.Conv2d(in_ch, out_ch, 3, padding=1)})
        self.emb_layers = nn.ModuleDict({"1": nn.Linear(emb_ch, out_ch)})
        self.out_layers = nn.ModuleDict({"0": GroupNorm32(out_ch, fuse_silu=True),
                                         "3": nn.Conv2d(out_ch, out_ch, 3, padding=1)})
        self.skip_connection = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = conv_nhwc(self.in_layers["2"], self.in_layers["0"](x))
        emb_out = self.emb_layers["1"](F.silu(emb))
        h = h + emb_out[:, None, None, :].to(h.dtype)
        h = conv_nhwc(self.out_layers["3"], self.out_layers["0"](h))
        if self.skip_connection is not None:
            x = conv_nhwc(self.skip_connection, x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return conv_nhwc(self.op, x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return conv_nhwc(self.conv, x)


class AttentionModule(nn.Module):
    """q/k/v projections around mode-reshaped attention (kernel K1)."""

    def __init__(self, dim: int, heads: int, dim_head: int, mode: str, num_timesteps: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.mode, self.num_timesteps = heads, mode, num_timesteps
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleDict({"0": nn.Linear(inner, dim)})
        self.plain = False

    def forward(self, x):  # (b·t, n, c)
        qr, undo = attention_mode_reshape(self.to_q(x), self.mode, self.num_timesteps, self.heads)
        kr, _ = attention_mode_reshape(self.to_k(x), self.mode, self.num_timesteps, self.heads)
        vr, _ = attention_mode_reshape(self.to_v(x), self.mode, self.num_timesteps, self.heads)
        return self.to_out["0"](undo(flash_attention(qr, kr, vr, plain=self.plain)))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleDict({"0": GEGLU(dim, dim * mult), "2": nn.Linear(dim * mult, dim)})

    def forward(self, x):
        return self.net["2"](self.net["0"](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, connection: str, num_timesteps: int):
        super().__init__()
        mode = "3d" if connection == "3d" else "spatial"
        self.norm1 = LayerNorm32(dim)
        self.attn1 = AttentionModule(dim, heads, dim_head, mode, num_timesteps)
        self.temporal = connection == "temporal"
        if self.temporal:
            self.norm_t = LayerNorm32(dim)
            self.attn_t = AttentionModule(dim, heads, dim_head, "temporal", num_timesteps)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x):
        x = self.attn1(self.norm1(x)) + x
        if self.temporal:
            x = self.attn_t(self.norm_t(x)) + x
        return self.ff(self.norm3(x)) + x


class SpatioTemporalTransformer(nn.Module):
    """GroupNorm, linear proj in/out, one transformer block, residual."""

    def __init__(self, ch: int, heads: int, dim_head: int, connection: str, num_timesteps: int):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, dim_head, connection, num_timesteps)])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x):  # (bt, H, W, C)
        bt, H, W, C = x.shape
        h = self.proj_in(self.norm(x).reshape(bt, H * W, C))
        h = self.proj_out(self.transformer_blocks[0](h))
        return h.reshape(bt, H, W, C) + x


class MMDMUNet(nn.Module):
    """The MMDM denoiser. Latents in and out are (B, T, H, W, C)."""

    def __init__(
        self,
        in_channels: int = 4,
        out_channels: int = 4,
        model_channels: int = 320,
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        num_head_channels: int = 64,
        condition_channels: int = 50,
        time_steps: int = 8,
        temporal_mode: str = "3d",
    ):
        super().__init__()
        mc = model_channels
        self.in_channels, self.out_channels, self.model_channels = in_channels, out_channels, mc
        emb_ch = 4 * mc

        def attn_block(ch):
            if temporal_mode == "temporal":
                conn = "temporal"
            else:  # "3d" only at mult ≥ 2
                conn = "3d" if ch >= 2 * mc else "none"
            return SpatioTemporalTransformer(ch, ch // num_head_channels, num_head_channels,
                                             conn, time_steps)

        self.time_embed = nn.ModuleDict({"0": nn.Linear(mc, emb_ch), "2": nn.Linear(emb_ch, emb_ch)})
        self.cond_linear = nn.Linear(condition_channels, mc)

        self.input_blocks = nn.ModuleList([nn.ModuleList([nn.Conv2d(in_channels, mc, 3, padding=1)])])
        ch, ds, input_chs = mc, 1, [mc]
        n_levels = len(channel_mult)
        for level, m in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, m * mc, emb_ch)]
                ch = m * mc
                if ds in attention_resolutions:
                    layers.append(attn_block(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                input_chs.append(ch)
            if level != n_levels - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                input_chs.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb_ch), attn_block(ch),
                                           ResBlock(ch, ch, emb_ch)])

        self.output_blocks = nn.ModuleList()
        for level in reversed(range(n_levels)):
            m = channel_mult[level]
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + input_chs.pop(), m * mc, emb_ch)]
                ch = m * mc
                if ds in attention_resolutions:
                    layers.append(attn_block(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.ModuleDict({"0": GroupNorm32(ch, fuse_silu=True),
                                  "2": nn.Conv2d(ch, out_channels, 3, padding=1)})
        self.condition_channels = condition_channels
        self.remat = False
        self.compute_dtype = None   # None: the weights' own dtype

    def set_dtype(self, dtype: torch.dtype) -> "MMDMUNet":
        """Cast convolutions and linears to ``dtype``; norms stay fp32."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.to(dtype)
        return self

    def use_plain_ops(self, plain: bool) -> "MMDMUNet":
        """Route every GroupNorm and attention through the plain PyTorch
        versions (True) or the kernels (False) — for kernel comparisons."""
        for m in self.modules():
            if isinstance(m, (GroupNorm32, AttentionModule)):
                m.plain = plain
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.cond_linear.weight.dtype

    def _layer(self, layer: nn.Module, h: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        args = (h, emb) if isinstance(layer, ResBlock) else (h,)
        if (self.remat and torch.is_grad_enabled()
                and isinstance(layer, (ResBlock, SpatioTemporalTransformer))):
            # nothing in these layers draws random numbers (no dropout), so
            # the recompute needs no stashed RNG state; stashing it would set
            # the CUDA generator's state inside a captured training step
            # (``mmdm/step_graph.py``), which a capture refuses
            return checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False)
        return layer(*args)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: dict) -> torch.Tensor:
        """x (B,T,H,W,C) noisy latents; timesteps (B,T); cond {"pos_enc"
        (B,T,H,W,50), "z_input" (B,T,H,W,C), "ref_mask" (B,T,H,W,1)}."""
        z_input, ref = cond["z_input"], cond["ref_mask"]
        x_input = x - z_input                     # ground-truth noise at ref slots
        x = z_input * ref + x * (1.0 - ref)       # clean ref latents substituted
        if self.compute_dtype is None or self.compute_dtype == self.dtype:
            h = self._denoise(x, timesteps, cond)
        else:
            # autocast's cache of bf16 weight copies lives until this context
            # exits (the remat recompute enters its own), so a captured step
            # records the casts and every replay reads the current weights
            with torch.autocast(x.device.type, dtype=self.compute_dtype):
                h = self._denoise(x, timesteps, cond)
        h = h.to(x.dtype)
        # noise at ref slots is replaced by the true noise
        return x_input * ref + h * (1.0 - ref)

    def _denoise(self, x: torch.Tensor, timesteps: torch.Tensor, cond: dict) -> torch.Tensor:
        B, T, H, W, C = x.shape
        dt = self.dtype
        h = x.reshape(B * T, H, W, C).to(dt)
        emb = self.time_embed["0"](timestep_embedding(timesteps.reshape(B * T), self.model_channels).to(dt))
        emb = self.time_embed["2"](F.silu(emb))
        pos_embedding = self.cond_linear(cond["pos_enc"].reshape(B * T, H, W, -1).to(dt))

        hs = []
        for i, block in enumerate(self.input_blocks):
            if i == 0:
                h = conv_nhwc(block[0], h) + pos_embedding  # injected once, after block 0
            else:
                for layer in block:
                    h = self._layer(layer, h, emb)
            hs.append(h)

        for layer in self.middle_block:
            h = self._layer(layer, h, emb)

        for block in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=-1)
            for layer in block:
                h = self._layer(layer, h, emb)

        h = conv_nhwc(self.out["2"], self.out["0"](h))
        return h.reshape(B, T, H, W, self.out_channels)
