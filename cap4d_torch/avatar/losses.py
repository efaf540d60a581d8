"""Image losses for avatar fitting: L1, L2, PSNR, SSIM and the error map
(counterpart of ``cap4d_tpu/avatar/losses.py``).

SSIM is the reference's (gaussianavatars/utils/loss_utils.py:33-64): an
11×11 σ=1.5 gaussian window applied per channel with zero padding. The
window is separable, so each blur is two products with banded Toeplitz
matrices, in full fp32 (a TF32 blur makes blur(x²) − μ² go negative on flat
regions). Images are (H, W, C), or (C, H, W) with ``channel_first``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = ((img1 - img2) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


@functools.lru_cache(maxsize=None)
def _banded_blur_mat(n: int, size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(n, n) banded matrix of the 1-D gaussian taps: a product along an
    axis is the zero-padded 'same' convolution along it."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    m = np.zeros((n, n), np.float32)
    half = size // 2
    for t in range(size):
        off = t - half
        idx = np.arange(max(0, -off), min(n, n - off))
        m[idx, idx + off] = g[t]
    return m


@functools.lru_cache(maxsize=None)
def _blur_mat_on(n: int, device: torch.device) -> torch.Tensor:
    """:func:`_banded_blur_mat` on ``device``, copied there once (a
    captured train step may not copy from the host)."""
    return torch.as_tensor(_banded_blur_mat(n), device=device)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable gaussian blur of (C, H, W)."""
    return _blur_mat_on(x.shape[1], x.device).T @ x @ _blur_mat_on(x.shape[2], x.device)


def ssim(img1: torch.Tensor, img2: torch.Tensor, channel_first: bool = False) -> torch.Tensor:
    """Mean SSIM of two images."""
    if not channel_first:
        img1, img2 = img1.permute(2, 0, 1), img2.permute(2, 0, 1)
    mu1, mu2 = _blur(img1), _blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img1 * img1) - mu1_sq
    s2 = _blur(img2 * img2) - mu2_sq
    s12 = _blur(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim_map.mean()


def error_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return (img1 - img2).abs().mean(-1)
