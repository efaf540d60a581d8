"""Attention layout modes around one attention primitive (counterpart of
``cap4d_tpu/ops/attention.py``).

  spatial : (b·t, n, h, d)  — per-frame self attention
  temporal: (b·n, t, h, d)  — per-pixel cross-frame attention
  3d      : (b, t·n, h, d)  — joint multi-view attention, t-major

The spatial and 3d layouts are views of the projection output, so kernel K1
reads them in place through its strides; the temporal layout is a copy.
"""

from __future__ import annotations

import torch


def attention_mode_reshape(x: torch.Tensor, mode: str, t: int, heads: int):
    """(b·t, n, h·d) → (B, S, h, d) for ``mode``; returns (reshaped, undo)."""
    bt, n, hd = x.shape
    d = hd // heads
    if mode == "spatial":
        return x.view(bt, n, heads, d), lambda o: o.reshape(bt, n, hd)
    if mode == "temporal":
        b = bt // t
        y = x.reshape(b, t, n, heads, d).permute(0, 2, 1, 3, 4).reshape(b * n, t, heads, d)

        def undo(o):
            return o.reshape(b, n, t, heads, d).permute(0, 2, 1, 3, 4).reshape(bt, n, hd)

        return y, undo
    if mode == "3d":
        b = bt // t
        # attention is permutation-invariant over the joint sequence, so the
        # t-major (t n) order is as good as (n t)
        return x.view(b, t * n, heads, d), lambda o: o.reshape(bt, n, hd)
    raise ValueError(f"unknown attention mode {mode}")

