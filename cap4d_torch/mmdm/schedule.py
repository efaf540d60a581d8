"""Diffusion noise schedules for the MMDM (host-side numpy, float64): a copy
of ``cap4d_tpu/mmdm/schedule.py``, which the port may not import, held bit
for bit to it by the tests.

Reference parity: ldm ``diffusionmodules/util.py:21-75``, cap4d
``mmdm/utils.py:4-37`` and ``mmdm/mmdm.py:276-357`` (zero-terminal-SNR plus
the resolution/frame-count SNR shift, beta clamp at 0.99).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    if schedule == "linear":
        return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    if schedule == "cosine":
        t = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(t / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        return np.clip(betas, 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown")


def enforce_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so alpha_bar(T) == 0 (arXiv 2305.08891; cap4d/mmdm/utils.py:18-37)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1 - betas, axis=0))
    a0, aT = alphas_bar_sqrt[0].copy(), alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * (a0 / (a0 - aT))
    alphas_bar = alphas_bar_sqrt**2
    alphas = np.concatenate([alphas_bar[0:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1 - alphas


def shift_schedule(alpha_cumprods: np.ndarray, shift_ratio: float) -> Tuple[np.ndarray, np.ndarray]:
    """Shift log-SNR by log(shift_ratio); returns (alpha_cumprod, betas).

    shift_ratio = 512² / (resolution² · n_gen_frames) compensates the joint
    multi-view denoising SNR (cap4d/mmdm/utils.py:4-14).
    """
    snr = alpha_cumprods / (1.0 - alpha_cumprods)
    log_snr_shifted = np.log(snr) + np.log(shift_ratio)
    alpha_shifted = np.exp(log_snr_shifted) / (1 + np.exp(log_snr_shifted))
    betas_shifted = 1 - np.concatenate([[1], alpha_shifted[1:] / alpha_shifted[:-1]])
    return alpha_shifted, betas_shifted


@dataclass(frozen=True)
class DiffusionSchedule:
    """All per-timestep schedule tensors used by training + sampling."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_mmdm_schedule(
    timesteps: int = 1000,
    linear_start: float = 0.00085,
    linear_end: float = 0.0120,
    beta_schedule: str = "linear",
    cosine_s: float = 8e-3,
    zero_snr_shift: bool = True,
    shift: bool = True,
    sqrt_shift: bool = True,
    minus_one_shift: bool = True,
    negative_shift: bool = False,
    n_frames: int = 8,
    image_size: int = 64,
    v_posterior: float = 0.0,
) -> DiffusionSchedule:
    """MMLDM.register_schedule equivalent (cap4d/mmdm/mmdm.py:276-357)."""
    betas = make_beta_schedule(
        beta_schedule, timesteps, linear_start=linear_start, linear_end=linear_end, cosine_s=cosine_s
    )
    if zero_snr_shift:
        betas = enforce_zero_terminal_snr(betas)
    betas = np.where(betas > 0.99, 0.99, betas)

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)

    if shift:
        n_gen = n_frames - 1 if minus_one_shift else n_frames
        shift_ratio = (64.0**2) / (image_size**2 * n_gen)
        if negative_shift:
            shift_ratio = 1.0 / shift_ratio
        if sqrt_shift:
            shift_ratio = np.sqrt(shift_ratio)
        alphas_cumprod, betas = shift_schedule(alphas_cumprod, shift_ratio)
        alphas = 1.0 - betas

    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

    posterior_variance = (
        (1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        + v_posterior * betas
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        lvlb_weights = betas**2 / (2 * posterior_variance * alphas * (1 - alphas_cumprod))
    # t=0 divides by posterior_variance[0]==0; the reference overwrites it too
    # (cap4d/mmdm/mmdm.py:355)
    lvlb_weights[0] = lvlb_weights[1]

    return DiffusionSchedule(
        betas=betas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
        log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / alphas_cumprod - 1),
        posterior_variance=posterior_variance,
        posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
        posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        posterior_mean_coef2=(1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
        lvlb_weights=lvlb_weights,
    )


def make_ddim_timesteps(
    num_ddim_timesteps: int, num_ddpm_timesteps: int, method: str = "uniform"
) -> np.ndarray:
    """DDIM timestep subset, offset by +1 (ldm diffusionmodules/util.py:46-60)."""
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        steps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(method)
    return steps + 1


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sigmas, alphas, alphas_prev) over the DDIM subset (util.py:63-74)."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev
