"""Stochastic I/O DDIM sampler (counterpart of ``cap4d_tpu/mmdm/sampler.py``).

Semantics kept: the n_gen latents are denoised jointly over S DDIM steps; at
each step the generated set is shuffled into groups of G = V − R frames and
each group co-attends with R reference frames inside one V-view UNet call;
CFG runs unconditional + conditional as one doubled batch; eps of the
generated slots accumulates per frame (``index_add_``) and ONE global DDIM
update is applied per step, with its scalars computed in float64. eta is
accepted but, as in the reference, no noise term is added. The group and
reference permutations come from a host ``np.random.RandomState(seed)``.

Each step's groups go through the UNet ``n_par`` at a time, as in the JAX
package: ``n_par = min(world · groups_per_device, n_groups)``, lowered until
it divides ``n_groups``. With a process group (``dp``, one rank a card, see
``cap4d_torch.parallel``) rank r runs slots ``shard_slice(n_par, r, world)``
of every round, the block the JAX package's ``P("dp")`` gives device r: one
UNet call of batch ``2·|slots|``, rows ``0..|slots|-1`` unconditional, the
rest conditional. Each rank adds its groups' eps into a local bank, one
``all_reduce(SUM)`` a DDIM step joins the banks, and every rank applies the
same update. Every rank draws the same permutations (no permutation is
sent); the initial latents and the conditioning banks are rank 0's,
broadcast. A frame's eps comes from one group on one rank and the other
ranks add zeros, so world N at ``groups_per_device`` g is bit-identical to
world 1 at g wherever the rounds hold the same groups. The permutations are
drawn in the same order at any ``groups_per_device``, so a run is the same
computation at any value; only rounding differs.

The latent bank, eps accumulator and conditioning banks stay on the device.
As in the JAX package, the steps run in blocks of K DDIM steps, K =
``max_group_steps_per_dispatch // n_rounds`` (at least 1), capped by
``checkpoint_every`` when checkpointing or ``progress_cb`` is on:
``progress_cb`` fires once a block and the checkpoint pickle is written at
the block boundary that crosses a ``checkpoint_every`` multiple (and at
the end). A block's permutations are drawn on the host in the order of a
step-by-step loop, so the draws do not depend on K. On the card each round
and each DDIM update is a replay of a captured CUDA graph over static slots
(``mmdm/sampler_graph.py``); ``graphs=False``, the CPU and
``detect_anomaly`` run the same bodies eagerly. The initial latent bank can
be passed in (``x_bank``), and the mid-run checkpoint/resume pickle is
kept: rank 0 writes it, and every rank resumes from it.

``detect_anomaly`` checks every round's eps and every DDIM update for
non-finite values and raises ``FloatingPointError`` naming the step and the
round (and the rank, in a process group), as ``jax_debug_nans`` raises that
type in the JAX package. Each check is a device sync, so it is off by
default.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from cap4d_torch.mmdm.model import MMDM, check_finite
from cap4d_torch.mmdm.sampler_graph import BlockGraphs
from cap4d_torch.mmdm.schedule import make_ddim_sampling_parameters, make_ddim_timesteps
from cap4d_torch.parallel.mesh import (
    DP,
    all_reduce_sum_,
    barrier,
    broadcast_,
    local_dp,
    shard_slice,
)


def parallel_groups(n_groups: int, groups: int) -> int:
    """Groups of one round over every rank: ``min(groups, n_groups)``
    (``groups`` = world · groups_per_device), lowered until it divides
    ``n_groups``."""
    n_par = min(groups, n_groups)
    while n_groups % n_par != 0:
        n_par -= 1
    return n_par


class StochasticIOSampler:
    """Multi-view stochastic I/O conditioning sampler over the ranks of
    ``dp`` (None: this process alone).

    ``max_group_steps_per_dispatch`` bounds the group-steps of a block (K
    DDIM steps × ``n_rounds`` rounds; module docstring). ``graphs`` (default:
    on the card unless ``detect_anomaly``) replays each round and update as
    a captured CUDA graph; False runs the same bodies eagerly; True raises
    on the CPU and with ``detect_anomaly``, whose checks sync."""

    def __init__(self, model: MMDM, groups_per_device: int = 1, detect_anomaly: bool = False,
                 dp: Optional[DP] = None, max_group_steps_per_dispatch: int = 200,
                 graphs: Optional[bool] = None):
        if groups_per_device < 1:
            raise ValueError(f"groups_per_device must be at least 1, got {groups_per_device}")
        if max_group_steps_per_dispatch < 1:
            raise ValueError("max_group_steps_per_dispatch must be at least 1, got "
                             f"{max_group_steps_per_dispatch}")
        self.model = model
        self.groups_per_device = groups_per_device
        self.detect_anomaly = detect_anomaly
        self.max_group_steps_per_dispatch = max_group_steps_per_dispatch
        self.dp = local_dp(dp, model.device)
        if graphs is None:
            graphs = self.dp.device.type == "cuda" and not detect_anomaly
        if graphs and detect_anomaly:
            raise ValueError("detect_anomaly's checks cannot be captured: pass graphs=False")
        if graphs and self.dp.device.type != "cuda":
            raise ValueError(f"CUDA graphs need the card, got {self.dp.device}")
        self.graphs = graphs
        self.counters: Dict[str, object] = {}

    def _round_eps(self, banks, x_bank, t, ref_idx, gen_idx, cfg_scale):
        """One round of n_par groups through the UNet with CFG.

        ref_idx (n_par, R), gen_idx (n_par, G), t the (1,) int64 timestep on
        the device; returns eps of the gen slots (n_par, G, h, w, 4)."""
        n_par, R = ref_idx.shape
        G = gen_idx.shape[1]
        pe = torch.cat([banks["ref_pos_enc"][ref_idx], banks["gen_pos_enc"][gen_idx]], dim=1)
        ref_z = banks["ref_z"][ref_idx]
        x_T = x_bank[gen_idx]
        z_in = torch.cat([ref_z, torch.zeros_like(x_T)], dim=1)
        x = torch.cat([ref_z, x_T], dim=1)              # refs get their clean latents
        h, w = x.shape[2:4]
        rmask = torch.cat([x.new_ones((n_par, R, h, w, 1)), x.new_zeros((n_par, G, h, w, 1))],
                          dim=1)
        # CFG doubled batch: rows 0..n_par-1 unconditional (zero conditioning),
        # rows n_par.. conditional
        cond2 = {
            "pos_enc": torch.cat([torch.zeros_like(pe), pe]),
            "z_input": torch.cat([torch.zeros_like(z_in), z_in]),
            "ref_mask": torch.cat([rmask, rmask]),
        }
        t2 = t.reshape(1, 1).expand(2 * n_par, R + G)
        out = self.model.unet(torch.cat([x, x]), t2, cond2)
        e_uncond, e_cond = out[:n_par], out[n_par:]
        e = e_uncond + cfg_scale * (e_cond - e_uncond)
        return e[:, R:]

    @staticmethod
    def _draw_block(host_rng, i: int, K: int, S: int, n_all_ref: int, n_gen: int, R: int,
                    G: int, n_par: int, slots, time_range, ddim_params) -> Dict[str, np.ndarray]:
        """Steps i..i+K-1 drawn on the host in the step-by-step order: their
        index tables (this rank's slots), timesteps and update factors
        (float64 → float32)."""
        sigmas, alphas, alphas_prev = ddim_params
        n_groups = n_gen // G
        n_rounds = n_groups // n_par
        ref, gen = [], []
        ts = np.empty((K,), np.int64)
        factors = np.empty((K, 2), np.float32)
        for k in range(K):
            if R == 1:
                ref_rounds = np.zeros((n_groups, R), np.int64)
            else:
                ref_rounds = np.stack([host_rng.permutation(n_all_ref)[:R] for _ in range(n_groups)])
            gen_rounds = host_rng.permutation(n_gen).reshape(n_groups, G)
            ref.append(ref_rounds.reshape(n_rounds, n_par, R)[:, slots])
            gen.append(gen_rounds.reshape(n_rounds, n_par, G)[:, slots])
            ts[k] = time_range[i + k]
            # DDIM update scalars in float64
            index = S - (i + k) - 1
            a_t = np.float64(alphas[index])
            a_prev = np.float64(alphas_prev[index])
            sig = np.float64(sigmas[index])
            factors[k, 1] = np.float32(-np.sqrt(a_prev) * np.sqrt(1.0 - a_t) / np.sqrt(a_t)
                                       + np.sqrt(1.0 - a_prev - sig ** 2))
            factors[k, 0] = np.float32(np.sqrt(a_prev) / np.sqrt(a_t))
        cat = lambda a: np.concatenate(a).astype(np.int64)
        return {"ref": cat(ref), "gen": cat(gen), "t": ts, "factors": factors}

    @torch.no_grad()
    def sample(
        self,
        S: int,
        ref_cond: Dict[str, torch.Tensor],
        gen_cond: Dict[str, torch.Tensor],
        V: int = 8,
        R_max: int = 4,
        cfg_scale: float = 1.0,
        eta: float = 0.0,
        seed: int = 124,
        x_bank=None,
        generator: Optional[torch.Generator] = None,
        verbose: bool = True,
        progress_cb=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 10,
    ) -> torch.Tensor:
        """Generate latents for every frame in gen_cond.

        ref_cond/gen_cond: {"pos_enc": (N,H,W,C), "z_input": (N,h,w,4),
        "ref_mask": (N,h,w,1)} banks from MMDM.prepare_conditioning.
        x_bank: the initial latents (n_gen, h, w, 4); None draws them from
        ``generator``. In a process group every rank conditions on rank 0's
        numbers: its initial latents and banks are broadcast, into the
        caller's tensors where the banks alias them. Returns latents
        (n_gen, h, w, 4) on the device, the same on every rank.

        checkpoint_dir: when set, the latent bank and host RNG state are
        saved at the block boundaries that cross a ``checkpoint_every``
        multiple and a run resumes from the newest compatible snapshot.
        ``progress_cb(done, S)`` is called once a block. The run's graph
        counters are left in ``self.counters``."""
        dev = self.model.device
        dp = self.dp
        sched = self.model.schedule
        n_gen = gen_cond["pos_enc"].shape[0]
        n_all_ref = ref_cond["pos_enc"].shape[0]
        R = min(n_all_ref, R_max)
        G = V - R
        if n_gen % G != 0:
            raise ValueError(f"number of generated images ({n_gen}) has to be divisible by G ({G})")
        n_groups = n_gen // G
        n_par = parallel_groups(n_groups, dp.world * self.groups_per_device)
        n_rounds = n_groups // n_par
        slots = shard_slice(n_par, dp.rank, dp.world)
        n_local = len(range(n_par)[slots])
        where = f" on rank {dp.rank}" if dp.world > 1 else ""

        ddim_ts = make_ddim_timesteps(S, sched.num_timesteps)
        ddim_params = make_ddim_sampling_parameters(sched.alphas_cumprod, ddim_ts, eta)

        banks = {
            "ref_pos_enc": torch.as_tensor(ref_cond["pos_enc"], dtype=torch.float32, device=dev),
            "ref_z": torch.as_tensor(ref_cond["z_input"], dtype=torch.float32, device=dev),
            "gen_pos_enc": torch.as_tensor(gen_cond["pos_enc"], dtype=torch.float32, device=dev),
        }
        h = w = self.model.latent_size
        shape = (n_gen, h, w, self.model.unet.in_channels)
        if x_bank is None:
            x_bank = torch.randn(shape, generator=generator, device=dev)
        x_bank = torch.as_tensor(x_bank, dtype=torch.float32, device=dev).clone()
        if tuple(x_bank.shape) != shape:
            raise ValueError(f"x_bank must be {shape}, got {tuple(x_bank.shape)}")
        broadcast_([x_bank, *banks.values()], dp)

        host_rng = np.random.RandomState(seed)
        start_step = 0
        ckpt_path = None
        if checkpoint_dir is not None:
            ckpt_path = Path(checkpoint_dir) / "sampler_checkpoint.pkl"
            if ckpt_path.exists():
                with open(ckpt_path, "rb") as fh:
                    snap = pickle.load(fh)
                if snap["n_gen"] == n_gen and snap["S"] == S and snap["seed"] == seed:
                    x_bank.copy_(torch.as_tensor(snap["x_bank"]))
                    host_rng.set_state(snap["rng_state"])
                    start_step = snap["step"]
                    print(f"Resuming stochastic I/O sampling from step {start_step}")
                else:
                    print("Ignoring incompatible sampler checkpoint")

        # K steps a block (cap4d_tpu/mmdm/sampler.py:245-249)
        k_disp = max(1, self.max_group_steps_per_dispatch // max(1, n_rounds))
        if ckpt_path is not None or progress_cb is not None:
            k_max = min(checkpoint_every, k_disp)
        else:
            k_max = min(S, k_disp)
        if verbose:
            print(f"Stochastic I/O sampling: {S} steps, {R} refs, {n_gen} gen images, "
                  f"{n_groups} groups = {n_rounds} rounds × {n_par} parallel groups "
                  f"({dp.world} devices), blocks of {k_max} steps"
                  f"{' as CUDA graph replays' if self.graphs else ''}")

        unet = self.model.unet
        blocks = BlockGraphs(
            lambda ref_idx, gen_idx, t: self._round_eps(banks, x_bank, t, ref_idx, gen_idx,
                                                        cfg_scale),
            [p for p in unet.parameters()] + [b for b in unet.buffers()], banks.values(),
            x_bank, n_rounds, n_local, R, G, k_max, self.graphs)
        rounds = n_rounds if n_local else 0
        time_range = np.flip(ddim_ts)
        draw = lambda i, K: self._draw_block(host_rng, i, K, S, n_all_ref, n_gen, R, G, n_par,
                                             slots, time_range, ddim_params)
        i = start_step
        try:
            staged = draw(i, min(k_max, S - i)) if i < S else None
            while i < S:
                K = len(staged["t"])
                blocks.stage(staged)
                rng_state = host_rng.get_state()
                blocks.check_key()
                for k in range(K):
                    for r in range(rounds):
                        e_t = blocks.run("round")
                        if self.detect_anomaly:
                            check_finite(e_t, f"in the eps of DDIM step {i + k}, round {r}{where}")
                    all_reduce_sum_(blocks.eps, dp)
                    blocks.run("update")
                    if self.detect_anomaly:
                        check_finite(x_bank, f"after the DDIM update of step {i + k}{where}")
                i += K
                if progress_cb is not None:
                    progress_cb(i, S)
                if ckpt_path is not None and (i // checkpoint_every > (i - K) // checkpoint_every
                                              or i == S):
                    if dp.rank == 0:
                        tmp = ckpt_path.with_suffix(".tmp")
                        with open(tmp, "wb") as fh:
                            pickle.dump({"x_bank": x_bank.cpu().numpy(), "step": i,
                                         "rng_state": rng_state,
                                         "n_gen": n_gen, "S": S, "seed": seed}, fh)
                        tmp.replace(ckpt_path)
                    barrier(dp)
                # the next block is drawn while the card runs this one
                staged = draw(i, min(k_max, S - i)) if i < S else None
        finally:
            self.counters = blocks.counters()
            blocks.close()
        return x_bank
