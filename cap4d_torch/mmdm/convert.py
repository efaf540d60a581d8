"""Weights carried across: the released checkpoint and JAX parameter trees
onto the port's modules.

The port's modules carry the reference torch state-dict keys, so a released
``.ckpt`` loads with ``load_state_dict(strict=True)`` after its prefixes are
stripped (``load_mmdm_checkpoint``). ``state_dict_from_flax`` maps a JAX
parameter tree (numpy leaves, e.g. from ``cap4d_tpu``) onto those keys: the
inverse of ``cap4d_tpu/mmdm/convert.py:97-105``, transposing conv kernels
(kh,kw,I,O)→(O,I,kh,kw) and dense kernels (I,O)→(O,I). The key functions are
the port's own copies of ``unet_torch_key`` / ``vae_torch_key``.

The way back, for the UNet: ``flax_from_state_dict`` turns named tensors of
the port's UNet (its parameters, or AdamW moments keyed like them) into the
JAX package's parameter tree (``unet_flax_path`` inverts ``unet_torch_key``),
so a training checkpoint written by the port loads into ``cap4d_tpu``.
``train_state_from_flax`` carries a JAX ``TrainState``'s parameters and
optax Adam moments into the port's UNet and a ``torch.optim.AdamW``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."


def _leaf_name(flax_leaf: str) -> str:
    return {"kernel": "weight", "scale": "weight", "bias": "bias"}[flax_leaf]


def _top_block(tok: str) -> str:
    """input_blocks_4_1 → input_blocks.4.1 ; middle_block_2 → middle_block.2"""
    for pre in ("input_blocks", "output_blocks", "middle_block", "time_embed"):
        if tok.startswith(pre + "_"):
            return f"{pre}.{tok[len(pre) + 1 :].replace('_', '.')}"
    return tok


_UNET_TOKENS = {
    "norm_in": "in_layers.0",
    "conv_in": "in_layers.2",
    "emb_proj": "emb_layers.1",
    "norm_out": "out_layers.0",
    "conv_out": "out_layers.3",
    "skip": "skip_connection",
    "block0": "transformer_blocks.0",
    "to_out": "to_out.0",
    "geglu_proj": "net.0.proj",
}


def unet_torch_key(path: Tuple[str, ...]) -> str:
    """JAX UNet param path → torch state-dict key (without UNET_PREFIX)."""
    parts = [p for p in path if p not in ("gn", "ln")]
    leaf = _leaf_name(parts[-1])
    toks = parts[:-1]
    if toks[0] == "out_norm":
        return f"out.0.{leaf}"
    if toks[0] == "out_conv":
        return f"out.2.{leaf}"
    out = [_top_block(toks[0])]
    prev = None
    for t in toks[1:]:
        if t == "proj_out" and prev == "ff":
            out.append("net.2")
        else:
            out.append(_UNET_TOKENS.get(t, t))
        prev = t
    return ".".join(out + [leaf])


def _vae_block(tok: str) -> str:
    """down_1_block_0 → down.1.block.0 ; mid_attn_1 → mid.attn_1"""
    if tok.startswith(("down_", "up_")):
        parts = tok.split("_")
        if "block" in parts:
            return f"{parts[0]}.{parts[1]}.block.{parts[3]}"
        return f"{parts[0]}.{parts[1]}.{parts[2]}"
    if tok.startswith("mid_"):
        return "mid." + tok[4:]
    return tok


def vae_torch_key(path: Tuple[str, ...]) -> str:
    """JAX VAE param path → torch state-dict key (without VAE_PREFIX)."""
    parts = [p for p in path if p not in ("gn", "ln")]
    leaf = _leaf_name(parts[-1])
    out = [parts[0]] if parts[0] in ("encoder", "decoder") else []
    for t in parts[len(out) : -1]:
        out.append(_vae_block(t))
    return ".".join(out + [leaf])


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(params_np: Mapping[str, Any],
                         key_fn: Callable[[Tuple[str, ...]], str],
                         prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of numpy arrays) → torch state dict."""
    out = {}
    for path, leaf in _flatten(params_np):
        arr = np.asarray(leaf, np.float32)
        if arr.ndim == 4:    # conv (kh,kw,I,O) → (O,I,kh,kw)
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:  # dense (I,O) → (O,I)
            arr = arr.T
        out[prefix + key_fn(path)] = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    return out


_UNET_TOKENS_INV = {tuple(v.split(".")): k for k, v in _UNET_TOKENS.items()}
_UNET_TOKENS_INV[("net", "2")] = "proj_out"


def unet_flax_path(key: str, norm: str = "") -> Tuple[str, ...]:
    """Torch UNet state-dict key (without UNET_PREFIX) → JAX param path.

    ``norm`` is "gn" or "ln" when the key belongs to a GroupNorm or LayerNorm
    (its weight is the flax ``scale`` under that sub-module)."""
    *mods, leaf = key.split(".")
    if norm:
        leaf_path = (norm, "scale" if leaf == "weight" else "bias")
    else:
        leaf_path = ("kernel" if leaf == "weight" else "bias",)
    if mods == ["out", "0"]:
        return ("out_norm",) + leaf_path
    if mods == ["out", "2"]:
        return ("out_conv",) + leaf_path
    n_top = {"input_blocks": 3, "output_blocks": 3, "middle_block": 2, "time_embed": 2}.get(mods[0], 1)
    out = ["_".join(mods[:n_top])]
    rest = mods[n_top:]
    i = 0
    while i < len(rest):
        for n in (3, 2, 1):
            tok = _UNET_TOKENS_INV.get(tuple(rest[i : i + n]))
            if tok is not None:
                out.append(tok)
                i += n
                break
        else:
            out.append(rest[i])
            i += 1
    return tuple(out) + leaf_path


def unet_norm_kinds(unet: torch.nn.Module) -> Dict[str, str]:
    """{state-dict key: "gn" | "ln"} for the parameters of the UNet's norms."""
    from cap4d_torch.mmdm.unet import GroupNorm32

    kinds = {}
    for name, m in unet.named_modules():
        kind = "gn" if isinstance(m, GroupNorm32) else "ln" if isinstance(m, torch.nn.LayerNorm) else ""
        if kind:
            for leaf in ("weight", "bias"):
                kinds[f"{name}.{leaf}"] = kind
    return kinds


def flax_from_state_dict(tensors: Mapping[str, torch.Tensor],
                         norm_kinds: Mapping[str, str]) -> Dict[str, Any]:
    """Named UNet tensors → JAX param tree (nested dicts of fp32 numpy),
    transposing (O,I,kh,kw)→(kh,kw,I,O) and (O,I)→(I,O): the inverse of
    ``state_dict_from_flax(tree, unet_torch_key)``."""
    tree: Dict[str, Any] = {}
    for key, t in tensors.items():
        arr = t.detach().float().cpu().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        elif arr.ndim == 2:
            arr = arr.T
        *path, leaf = unet_flax_path(key, norm_kinds.get(key, ""))
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def train_state_from_flax(unet: torch.nn.Module, optimizer: torch.optim.Optimizer,
                          params: Mapping[str, Any], mu: Mapping[str, Any],
                          nu: Mapping[str, Any], count: int) -> None:
    """Load a JAX ``TrainState``: ``params`` into ``unet`` and optax Adam's
    first/second moments ``mu``/``nu`` after ``count`` updates into the
    AdamW ``optimizer`` over ``unet``'s parameters."""
    unet.load_state_dict(state_dict_from_flax(params, unet_torch_key), strict=True)
    named = dict(unet.named_parameters())
    moments = [state_dict_from_flax(m, unet_torch_key) for m in (mu, nu)]
    for key, p in named.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.empty_like(p).copy_(moments[0][key]),
            "exp_avg_sq": torch.empty_like(p).copy_(moments[1][key]),
        }


def newest_checkpoint(ckpt_dir: str | Path) -> Path:
    """The newest ``checkpoints/*.ckpt`` under ``ckpt_dir`` by ctime."""
    ckpts = list((Path(ckpt_dir) / "checkpoints").glob("*.ckpt"))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints/*.ckpt under {ckpt_dir}")
    return max(ckpts, key=os.path.getctime)


def load_mmdm_checkpoint(ckpt_path: str | Path, unet: torch.nn.Module,
                         vae: torch.nn.Module) -> None:
    """Load a released MMDM ``.ckpt`` into the port's UNet and VAE (strict)."""
    state = torch.load(str(ckpt_path), map_location="cpu")
    if "state_dict" in state:
        state = state["state_dict"]
    for module, prefix in ((unet, UNET_PREFIX), (vae, VAE_PREFIX)):
        sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        module.load_state_dict(sub, strict=True)
