"""Convert LPIPS(VGG) torch weights to the npz the fit reads — offline
(counterpart of ``cap4d_tpu/tools/convert_lpips.py``, same flags).

The reference downloads these at runtime (torchvision's VGG16
IMAGENET1K_V1 features and richzhang's v0.1 linear heads ``vgg.pth``). Where
the two files exist, this writes the npz that ``cap4d_torch.avatar.lpips.
load_lpips`` reads, with the JAX package's flat keys
(``vgg/conv{b}_{i}/{kernel,bias}``, ``lin{k}/kernel``, flax layouts), so one
file serves both packages:

    python -m cap4d_torch.tools.convert_lpips \\
        --vgg vgg16-397923af.pth --linear vgg.pth --out data/weights/lpips_vgg.npz

    python -m cap4d_torch.avatar.train ... --lpips_weights data/weights/lpips_vgg.npz

``--vgg`` takes the torchvision vgg16 checkpoint (``features.N.{weight,bias}``);
without it the weights come from an installed torchvision (absent on the
card's machine: pass ``--vgg`` there). ``--linear`` takes the v0.1
``vgg.pth`` in its raw key layout (``lin0.model.1.weight``) or with plain
``lin0.weight`` keys, with or without a ``lins.`` prefix.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from cap4d_torch.avatar.lpips import _LIN_CHANNELS, _VGG16_CHANNELS, _VGG16_CONV_IDX


def load_torch_state(path) -> Dict[str, np.ndarray]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if "state_dict" in state:
        state = state["state_dict"]
    return {k: v.numpy() for k, v in state.items()}


def normalize_linear_keys(lin_state: dict) -> dict:
    """Raw richzhang keys (``lin{k}.model.1.weight``), or ``lin{k}.weight``,
    either with a leading ``lins.``."""
    out = {}
    for k, v in lin_state.items():
        key = k[5:] if k.startswith("lins.") else k
        if ".model.1." not in key:  # e.g. 'lin0.weight'
            head, leaf = key.split(".", 1)
            key = f"{head}.model.1.{leaf}"
        out[key] = v
    return out


def convert_torch_lpips(vgg_state: dict, lin_state: dict) -> dict:
    """torchvision VGG16 ``features.*`` + richzhang ``lin*.model.1.weight`` →
    the nested flax tree (HWIO kernels)."""
    params = {"vgg": {}}
    for b, idxs in enumerate(_VGG16_CONV_IDX):
        for i, li in enumerate(idxs):
            w = np.asarray(vgg_state[f"features.{li}.weight"], np.float32)
            bias = np.asarray(vgg_state[f"features.{li}.bias"], np.float32)
            params["vgg"][f"conv{b}_{i}"] = {"kernel": w.transpose(2, 3, 1, 0), "bias": bias}
    for k in range(5):
        w = np.asarray(lin_state[f"lin{k}.model.1.weight"], np.float32)
        params[f"lin{k}"] = {"kernel": w.transpose(2, 3, 1, 0)}
    return params


def save_lpips_npz(params: dict, path: str | Path) -> None:
    """The nested tree as one npz of ``a/b/c`` keys."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(params, "")
    np.savez(path, **flat)


def synthetic_lpips_states(seed: int = 0):
    """Randomly initialised VGG16 features and non-negative linear heads as
    state dicts in the reference layouts (for tests and the synthetic-LPIPS
    quality fit; the real weights are downloads)."""
    torch.manual_seed(seed)
    channels = {i: c for idxs, chans in zip(_VGG16_CONV_IDX, _VGG16_CHANNELS)
                for i, c in zip(idxs, chans)}
    vgg, in_ch = {}, 3
    for i, c in channels.items():
        conv = torch.nn.Conv2d(in_ch, c, 3, padding=1)
        vgg[f"features.{i}.weight"] = conv.weight.detach().numpy()
        vgg[f"features.{i}.bias"] = conv.bias.detach().numpy()
        in_ch = c
    torch.manual_seed(seed + 1)
    lin = {}
    for k, c in enumerate(_LIN_CHANNELS):
        w = torch.nn.Conv2d(c, 1, 1, bias=False).weight.detach().abs()   # real heads are >= 0
        lin[f"lin{k}.model.1.weight"] = w.numpy()
    return vgg, lin


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vgg", type=str, default=None,
                    help="torchvision vgg16 .pth (default: an installed torchvision)")
    ap.add_argument("--linear", type=str, required=True,
                    help="richzhang PerceptualSimilarity v0.1 vgg.pth")
    ap.add_argument("--out", type=str, default="data/weights/lpips_vgg.npz")
    args = ap.parse_args(argv)

    if args.vgg is not None:
        vgg_state = load_torch_state(args.vgg)
    else:
        try:
            from torchvision import models
        except ImportError as e:
            raise SystemExit("torchvision is not installed: pass --vgg with the torchvision "
                             "vgg16 checkpoint (vgg16-397923af.pth)") from e
        vgg_state = {f"features.{k}": v.numpy() for k, v in
                     models.vgg16(weights=models.VGG16_Weights.IMAGENET1K_V1)
                     .features.state_dict().items()}
    vgg_state = {k: v for k, v in vgg_state.items() if k.startswith("features.")}
    lin_state = normalize_linear_keys(load_torch_state(args.linear))

    params = convert_torch_lpips(vgg_state, lin_state)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_lpips_npz(params, out)
    n = sum(v.size for v in vgg_state.values())
    print(f"Wrote {out} ({n / 1e6:.1f}M VGG params + 5 linear heads). Pass --lpips_weights "
          f"{out} to the fit CLIs to turn on the perceptual term.")


if __name__ == "__main__":
    main()
