"""MMDM training step: eps-prediction loss with reference masking
(counterpart of ``cap4d_tpu/mmdm/training.py``).

Reference parity: cap4d/mmdm/mmdm.py:105-171 (forward/p_losses): per-(batch,
view) uniform timesteps, q_sample over the frames, eps-MSE averaged over CHW,
masked to the non-reference views and averaged over them, plus an
``original_elbo_weight``·lvlb term (0 by default). The optimizer is AdamW at
lr 1e-4 with optax.adamw's defaults (betas 0.9/0.999, eps 1e-8, weight decay
1e-4, not torch's 1e-2).

PyTorch runs eagerly: a step is ``zero_grad``, one backward and
``optimizer.step()``. The module holds the parameters, so ``mmdm_loss``
takes no parameter tree. Timesteps and noise are drawn from a
``torch.Generator`` unless they are passed in, as the parity tests do.

Data parallelism (``dp``, one process a card, ``cap4d_torch.parallel``):
rank r takes the block ``shard_slice(B, r, world)`` of the batch, the one
the JAX step's ``P("dp")`` puts on device r, and the ranks average their
gradients with one bucketed all-reduce a step (``all_reduce_grads_``), as
XLA sums the sharded batch's gradients. ``DistributedDataParallel`` is not
used: its reducer hooks every backward, while the step reduces once, after
remat and the micro-batch loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from cap4d_torch.mmdm.schedule import DiffusionSchedule
from cap4d_torch.mmdm.unet import MMDMUNet
from cap4d_torch.parallel.mesh import DP, all_reduce_mean_, local_dp, shard_slice

ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4   # optax.adamw's default


@dataclass
class TrainState:
    """The UNet (holding the parameters), its optimizer and the step count."""

    unet: MMDMUNet
    optimizer: torch.optim.Optimizer
    step: int = 0
    step_graph: Optional[object] = None   # train_mmdm's MicroBatchGraph, for its counters


def q_sample(sched_consts: Dict[str, torch.Tensor], x_start, t, noise):
    """Forward diffusion q(x_t | x_0); ``t`` is an integer tensor (...,)."""
    sa = sched_consts["sqrt_alphas_cumprod"][t]
    s1m = sched_consts["sqrt_one_minus_alphas_cumprod"][t]
    while sa.ndim < x_start.ndim:
        sa, s1m = sa[..., None], s1m[..., None]
    return sa * x_start + s1m * noise


def mmdm_loss(
    unet: MMDMUNet,
    sched_consts: Dict[str, torch.Tensor],
    z: torch.Tensor,             # (B, T, h, w, 4) clean latents (scaled)
    cond: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    num_timesteps: int = 1000,
    l_simple_weight: float = 1.0,
    original_elbo_weight: float = 0.0,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, logs). ``t``/``noise`` default to fresh draws from
    ``generator`` (the training path); tests pass fixed ones."""
    B, T = z.shape[:2]
    if t is None:
        t = torch.randint(0, num_timesteps, (B, T), generator=generator, device=z.device)
    if noise is None:
        noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
    x_noisy = q_sample(sched_consts, z, t, noise)

    eps = unet(x_noisy, t, cond)

    per_view = ((eps - noise) ** 2).mean(dim=(2, 3, 4))          # (B, T)
    gen_mask = 1.0 - cond["ref_mask"][:, :, 0, 0, 0]             # (B, T): 1 on gen views
    denom = gen_mask.sum(-1)
    loss_simple = (per_view * gen_mask).sum(-1) / denom          # (B,)

    # the logvar buffer is zeros (learn_logvar False), so loss == loss_simple
    loss = l_simple_weight * loss_simple.mean()
    logs = {"loss_simple": loss_simple.mean()}
    if original_elbo_weight > 0:
        lvlb_w = sched_consts["lvlb_weights"][t]
        loss_vlb = ((lvlb_w * per_view * gen_mask).sum(-1) / denom).mean()
        loss = loss + original_elbo_weight * loss_vlb
        logs["loss_vlb"] = loss_vlb
    logs["loss"] = loss
    return loss, logs


def schedule_consts(sched: DiffusionSchedule, device=None) -> Dict[str, torch.Tensor]:
    return {
        name: torch.as_tensor(getattr(sched, name), dtype=torch.float32, device=device)
        for name in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "lvlb_weights")
    }


def make_adamw(unet: torch.nn.Module, lr: float = 1e-4) -> torch.optim.AdamW:
    """optax.adamw(lr) as torch.optim.AdamW."""
    return torch.optim.AdamW(unet.parameters(), lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                             weight_decay=ADAMW_WEIGHT_DECAY)


def all_reduce_grads_(params, dp: DP, extra=()) -> int:
    """Average the gradients of ``params`` (and the tensors ``extra``) over
    the ranks in one bucketed all-reduce; a no-op without a process group.
    A rank without a gradient for a parameter adds zeros; a parameter no
    rank has a gradient for keeps none, so AdamW skips it as it does on one
    rank. A gradient keeps its tensor (the reduce copies back in place), so
    a captured step's static ``.grad`` stays where its graph writes. Returns
    the bytes reduced."""
    if dp.group is None:
        return 0
    params = [p for p in params if p.requires_grad]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    has = torch.tensor([float(p.grad is not None) for p in params], device=grads[0].device)
    moved = all_reduce_mean_([*grads, has, *extra], dp)
    for p, g, h in zip(params, grads, has.cpu().tolist()):
        p.grad = g if h > 0 else None
    return moved


def make_train_step(unet: MMDMUNet, sched: DiffusionSchedule, optimizer: torch.optim.Optimizer,
                    dp: Optional[DP] = None):
    """Returns step(state, z, cond, generator, t=None, noise=None) → logs:
    one loss, its backward and one optimizer update. With ``dp`` each rank
    takes its block of the batch (and of ``t``/``noise``); the logs are the
    global batch means and every rank takes the same update."""
    device = next(unet.parameters()).device
    consts = schedule_consts(sched, device)
    dp = local_dp(dp, device)

    def step(state: TrainState, z, cond, generator=None, t=None, noise=None):
        B = z.shape[0]
        mine = shard_slice(B, dp.rank, dp.world)
        n_mine = mine.stop - mine.start
        # the global mean is Σ_r n_r·loss_r / B: each rank's loss weighs
        # n_r·world/B before the all-reduce's mean (1 for an even split)
        weight = n_mine * dp.world / B
        optimizer.zero_grad(set_to_none=True)
        if n_mine:
            loss, logs = mmdm_loss(unet, consts, z[mine], {k: v[mine] for k, v in cond.items()},
                                   generator, num_timesteps=sched.num_timesteps,
                                   t=None if t is None else t[mine],
                                   noise=None if noise is None else noise[mine])
            (loss if weight == 1.0 else loss * weight).backward()
            logs = {k: v.detach() * weight for k, v in logs.items()}
        else:
            logs = {k: torch.zeros((), device=z.device) for k in ("loss_simple", "loss")}
        all_reduce_grads_(unet.parameters(), dp, extra=list(logs.values()))
        optimizer.step()
        state.step += 1
        return logs

    return step


def init_train_state(unet: MMDMUNet, lr: float = 1e-4) -> TrainState:
    return TrainState(unet, make_adamw(unet, lr), 0)
