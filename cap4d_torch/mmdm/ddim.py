"""Plain DDIM sampler over full V-view batches (counterpart of
``cap4d_tpu/mmdm/ddim.py``): eta=0 deterministic update with optional
classifier-free guidance, as used for training-time image logging. The
production path is the stochastic I/O sampler (``sampler.py``). The initial
noise can be passed in (``x``) or is drawn from ``generator``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cap4d_torch.mmdm.model import MMDM
from cap4d_torch.mmdm.schedule import make_ddim_sampling_parameters, make_ddim_timesteps


@torch.no_grad()
def ddim_sample(
    model: MMDM,
    cond: Dict[str, torch.Tensor],            # conditional conditioning (B,T,...)
    shape,                                    # (B, T, h, w, c)
    steps: int = 50,
    eta: float = 0.0,
    cfg_scale: float = 1.0,
    uncond: Optional[Dict[str, torch.Tensor]] = None,
    x: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    sched = model.schedule
    ts = make_ddim_timesteps(steps, sched.num_timesteps)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(sched.alphas_cumprod, ts, eta)
    if x is None:
        x = torch.randn(shape, generator=generator, device=model.device)
    x = torch.as_tensor(x, dtype=torch.float32, device=model.device)
    B, T = shape[:2]
    n_steps = len(ts)  # may differ from `steps` when it does not divide T
    for i, t_step in enumerate(np.flip(ts)):
        idx = n_steps - i - 1
        tt = torch.full((B, T), int(t_step), dtype=torch.int64, device=x.device)
        if uncond is not None and cfg_scale != 1.0:
            e_c = model.unet(x, tt, cond)
            e_u = model.unet(x, tt, uncond)
            e = e_u + cfg_scale * (e_c - e_u)
        else:
            e = model.unet(x, tt, cond)
        a_t = np.float64(alphas[idx])
        a_prev = np.float64(alphas_prev[idx])
        sig = np.float64(sigmas[idx])
        e_factor = np.float32(-np.sqrt(a_prev) * np.sqrt(1 - a_t) / np.sqrt(a_t)
                              + np.sqrt(1 - a_prev - sig ** 2))
        x_factor = np.float32(np.sqrt(a_prev) / np.sqrt(a_t))
        x = x * float(x_factor) + e * float(e_factor)
    return x
