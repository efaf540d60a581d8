"""LPIPS perceptual loss with a VGG16 backbone in plain ``torch.nn``
(counterpart of ``cap4d_tpu/avatar/lpips.py``).

The modules carry the reference's key names: ``features.{i}`` as in
torchvision's ``vgg16().features`` (up to relu5_3) and ``lin{k}.model.1``
as in richzhang's linear heads, so the reference state dicts load with
``load_state_dict``. ``load_lpips`` reads the JAX package's weights file
(an npz of flax arrays under ``vgg/conv{b}_{i}/kernel|bias`` and
``lin{k}/kernel``, written by its ``save_lpips_npz``). Without weights the
loss is unavailable (``available`` False) and the trainer gives it weight 0.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

# torchvision vgg16.features conv indices per LPIPS stage (split at each pool)
_VGG16_CONV_IDX = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
_VGG16_CHANNELS = [[64, 64], [128, 128], [256, 256, 256], [512, 512, 512], [512, 512, 512]]
_LIN_CHANNELS = [64, 128, 256, 512, 512]
_TAPS = [3, 8, 15, 22, 29]      # feature index after relu{1_2, 2_2, 3_3, 4_3, 5_3}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _Lin(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPSNet(nn.Module):
    """Scaling layer, VGG16 taps, unit-normalised squared differences,
    1×1 linear heads, spatial means summed over the five stages."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        conv_at = {i: c for idxs, chans in zip(_VGG16_CONV_IDX, _VGG16_CHANNELS)
                   for i, c in zip(idxs, chans)}
        for i in range(30):
            if i in conv_at:
                layers.append(nn.Conv2d(cin, conv_at[i], 3, padding=1))
                cin = conv_at[i]
            elif i in (4, 9, 16, 23):
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)
        for k, c in enumerate(_LIN_CHANNELS):
            setattr(self, f"lin{k}", _Lin(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def _feats(self, z):
        z = (z - self.shift) / self.scale
        out = []
        for i, layer in enumerate(self.features):
            z = layer(z)
            if i in _TAPS:
                # eps outside the sqrt (modules/utils.py:6-8)
                out.append(z / (torch.sqrt((z * z).sum(1, keepdim=True)) + 1e-10))
        return out

    def forward(self, x, y):
        """x, y (B, 3, H, W) in [-1, 1] → (B,)."""
        total = 0.0
        for k, (a, b) in enumerate(zip(self._feats(x), self._feats(y))):
            total = total + getattr(self, f"lin{k}").model((a - b) ** 2).mean(dim=(1, 2, 3))
        return total


class LPIPS:
    """Callable LPIPS((H, W, 3), (H, W, 3) in [0, 1]) → scalar; may be unavailable."""

    def __init__(self, net: Optional[LPIPSNet] = None):
        self.net = net
        self.available = net is not None
        if net is not None:
            net.requires_grad_(False).eval()

    def to(self, device) -> "LPIPS":
        if self.net is not None:
            self.net.to(device)
        return self

    def __call__(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        if not self.available:
            return torch.zeros((), device=img1.device)
        x = (img1 * 2.0 - 1.0).permute(2, 0, 1)[None]
        y = (img2 * 2.0 - 1.0).permute(2, 0, 1)[None]
        return self.net(x, y)[0]


def state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """Flax LPIPS params (the JAX package's tree) → this module's state dict."""
    sd = {}
    for b, idxs in enumerate(_VGG16_CONV_IDX):
        for i, li in enumerate(idxs):
            p = params["vgg"][f"conv{b}_{i}"]
            sd[f"features.{li}.weight"] = torch.as_tensor(
                np.ascontiguousarray(np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1)))
            sd[f"features.{li}.bias"] = torch.as_tensor(np.asarray(p["bias"], np.float32))
    for k in range(5):
        w = np.asarray(params[f"lin{k}"]["kernel"], np.float32).transpose(3, 2, 0, 1)
        sd[f"lin{k}.model.1.weight"] = torch.as_tensor(np.ascontiguousarray(w))
    return sd


def load_lpips(weights_path: Optional[str | Path] = None, device="cpu") -> LPIPS:
    """LPIPS from the JAX package's weights npz when it exists, else a
    disabled instance (with a warning)."""
    if weights_path is None:
        weights_path = Path("data/weights/lpips_vgg.npz")
    weights_path = Path(weights_path)
    if not weights_path.exists():
        print(f"WARNING: LPIPS weights not found at {weights_path} — "
              "perceptual loss disabled (download torchvision VGG16 + richzhang "
              "linear weights and convert them)")
        return LPIPS(None)
    raw = np.load(weights_path, allow_pickle=True)
    params: Dict = {}
    for key in raw.files:
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = raw[key]
    net = LPIPSNet()
    net.load_state_dict(state_dict_from_flax(params))
    return LPIPS(net).to(device)
