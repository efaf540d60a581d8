"""pix2pix-style UV deformation U-Net (counterpart of
``cap4d_tpu/avatar/deform_net.py``).

The modules nest as the reference's ``UnetGenerator`` /
``UnetSkipConnectionBlock`` do (gaussianavatars/scene/net/unet.py), so its
state dict has the reference's key names: the outermost level is
``model.model = [downconv, submodule, relu, upconv]``, an intermediate level
``[leaky relu, downconv, norm, submodule, relu, upconv, norm]`` and the
innermost ``[leaky relu, downconv, relu, upconv, norm]`` (4×4 stride-2
convolutions, instance norm without parameters). A reference state dict
loads with ``load_state_dict``; ``cap4d_tpu/avatar/convert_ref.py::
convert_deform_net_state_dict`` loads the same dict into the JAX package.

The forward follows the JAX package: the skip connection carries a level's
input before the leaky ReLU. The public layout is the JAX package's NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def get_pos_enc(n_dim: int, resolution: int) -> np.ndarray:
    """(H, W, 2·n_dim) sinusoidal uv-coordinate features (positional_encoding.py:5-21)."""
    coords = np.stack(np.meshgrid(np.arange(resolution), np.arange(resolution),
                                  indexing="ij"), axis=-1)
    coords = coords / resolution * 2.0 - 1.0
    freqs = 2.0 ** np.arange(n_dim // 2)
    ang = coords[..., None] * freqs                                  # (H, W, 2, n_dim/2)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return emb.reshape(resolution, resolution, 2 * n_dim).astype(np.float32)


class _Level(nn.Module):
    """One U-Net level; ``model`` indexes as the reference's Sequential."""

    def __init__(self, layers):
        super().__init__()
        self.model = nn.Sequential(*layers)


def _down(cin, cout):
    return nn.Conv2d(cin, cout, 4, stride=2, padding=1)


def _up(cin, cout):
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


class UnetGenerator(nn.Module):
    """Down channels [ngf, 2ngf, 4ngf, 8ngf, ..., 8ngf] (num_downs entries),
    mirrored on the way up with skip concatenations. The outermost up
    convolution starts at zero (zero deformation at the start of a fit)."""

    def __init__(self, in_channels: int = 27, out_channels: int = 3, ngf: int = 64,
                 num_downs: int = 6, zero_init_last: bool = True):
        super().__init__()
        self.num_downs = num_downs
        ch = [ngf, 2 * ngf, 4 * ngf] + [8 * ngf] * (num_downs - 3)
        level = _Level([nn.LeakyReLU(0.2), _down(ch[-2], ch[-1]), nn.ReLU(),
                        _up(ch[-1], ch[-2]), nn.InstanceNorm2d(ch[-2])])
        for i in range(num_downs - 2, 0, -1):
            level = _Level([nn.LeakyReLU(0.2), _down(ch[i - 1], ch[i]), nn.InstanceNorm2d(ch[i]),
                            level, nn.ReLU(), _up(2 * ch[i], ch[i - 1]),
                            nn.InstanceNorm2d(ch[i - 1])])
        last = _up(2 * ch[0], out_channels)
        if zero_init_last:
            nn.init.zeros_(last.weight)
            nn.init.zeros_(last.bias)
        self.model = _Level([_down(in_channels, ch[0]), level, nn.ReLU(), last])

    def _inner(self, level: _Level, x: torch.Tensor) -> torch.Tensor:
        m = level.model
        h = m[1](F.leaky_relu(x, 0.2))
        if len(m) == 5:                                   # innermost
            h = m[4](m[3](F.relu(h)))
        else:
            h = m[6](m[5](F.relu(self._inner(m[3], m[2](h)))))
        return torch.cat([x, h], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C_in) → (B, H, W, out_channels)."""
        m = self.model.model
        h = self._inner(m[1], m[0](x.permute(0, 3, 1, 2)))
        return m[3](F.relu(h)).permute(0, 2, 3, 1)
