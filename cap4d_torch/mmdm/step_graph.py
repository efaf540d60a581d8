"""MMDM training's micro-batch as a captured CUDA graph (counterpart of the
body of the accumulation scan in ``cap4d_tpu/mmdm/train.py``'s
``make_accum_train_step``).

The JAX package compiles the whole optimizer step as one program: a
``lax.scan`` over the micro-batches whose body, ``value_and_grad`` of the
remat'd UNet, is compiled once whatever their number. The port's
counterpart of that body is one fixed-shape micro-batch captured once as a
``torch.cuda.CUDAGraph`` and replayed once a micro-batch: the forward under
autocast, the ``torch.utils.checkpoint`` recompute, the backward through
K1, K2's autograd Function and K6, and the accumulation of its gradients
into ``.grad`` tensors that never move. A step of 64 micro-batches is 64
replays, not one graph of them all.

The body reads only static slots: the micro-batch's latents and
conditioning (z, pos_enc, z_input, ref_mask), its timesteps, noise and
unconditional mask (t, noise, uncond); it adds its loss to a static sum.
Before each micro-batch the slots are filled eagerly: the inputs copied from
the caller's stacks, then the draws made from the step's generator straight
into the slots, in the order the eager loop drew them (mask, then
timesteps, then noise, then the next micro-batch's). Nothing in the body
draws, so with one seed the draws are the eager loop's bit for bit.
``t_stack``/``noise_stack``, when given, are copied into the same slots.

A graph is keyed by the addresses of the parameters, of their gradients and
of the slots, the slots' shapes and types, and the UNet's compute dtype and
remat: anything that replaces one of them leads to a new capture. A capture
follows PyTorch's recipe: the micro-batch runs eagerly on a side stream
first (cuBLAS, cuDNN and the kernels' one-time set-up happen there, and the
micro-batch is the real one, so no state is touched twice), then the body
is captured and the step's other micro-batches are replays. The old graph
and its memory pool are freed before a new capture.

With ``graphs=False`` (the CPU, and ``--detect_anomaly``, whose checks
cannot be captured) the same body runs eagerly on the same slots. A capture
or replay error raises; there is no eager fallback on the card. Kernel
launches inside replays are counted through ``cuda_build.replay_graph``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from cap4d_torch.mmdm.training import mmdm_loss
from cap4d_torch.ops.cuda_build import capture_graph, replay_graph, warm_up


class MicroBatchGraph:
    """One micro-batch's loss and backward over static slots, captured and
    replayed on the card (``graphs=True``) or run eagerly.

    Counters for the caller: ``captures``, ``capture_s`` (host seconds in
    ``torch.cuda.graph``), ``replays`` and ``replay_launches`` (each kernel's
    launches in one replay)."""

    def __init__(self, unet, consts: Dict[str, torch.Tensor], num_timesteps: int,
                 cfg_probability: float, graphs: bool):
        device = next(unet.parameters()).device
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need the card, got {device}")
        self.unet, self.consts = unet, consts
        self.num_timesteps, self.cfg_probability = num_timesteps, cfg_probability
        self.graphs = graphs
        self.params = [p for p in unet.parameters() if p.requires_grad]
        self.slots: Dict[str, torch.Tensor] = {}
        self.loss_sum = torch.zeros((), device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.captures, self.capture_s, self.replays = 0, 0.0, 0
        self.replay_launches: Dict[str, int] = {}

    def body(self) -> None:
        """The micro-batch in the slots: unconditional mixing (get_input,
        mmdm.py:78-85), the loss, its backward into ``.grad``, its value into
        ``loss_sum``."""
        s = self.slots

        def mix(c):
            drop = s["uncond"].reshape(-1, *([1] * (c.ndim - 1)))
            return torch.where(drop, torch.zeros_like(c), c)

        cond = {"pos_enc": mix(s["pos_enc"]), "z_input": mix(s["z_input"]),
                "ref_mask": s["ref_mask"]}
        loss, _ = mmdm_loss(self.unet, self.consts, s["z"], cond,
                            num_timesteps=self.num_timesteps, t=s["t"], noise=s["noise"])
        loss.backward()
        self.loss_sum.add_(loss.detach())

    def grads(self) -> List[torch.Tensor]:
        """The static gradients, made once (zeros) where a parameter has none."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def _fill(self, z_stack, cond_stack, i: int, generator, t_stack, noise_stack) -> None:
        """Micro-batch ``i`` of the stacks into the slots, then its draws."""
        z = z_stack[i]
        inputs = {"z": z, **{k: v[i] for k, v in cond_stack.items()}}
        B, T = z.shape[:2]
        shapes = dict({k: (v.shape, v.dtype) for k, v in inputs.items()},
                      t=((B, T), torch.int64), noise=(z.shape, z.dtype),
                      uncond=((B,), torch.bool))
        if {k: (v.shape, v.dtype) for k, v in self.slots.items()} != shapes:
            self.slots = {k: torch.empty(shape, dtype=dt, device=z.device)
                          for k, (shape, dt) in shapes.items()}
        s = self.slots
        for k, v in inputs.items():
            s[k].copy_(v)
        s["uncond"].copy_(torch.rand((B,), generator=generator, device=z.device)
                          < self.cfg_probability)
        if t_stack is None:
            torch.randint(0, self.num_timesteps, (B, T), generator=generator, out=s["t"])
        else:
            s["t"].copy_(t_stack[i])
        if noise_stack is None:
            torch.randn(z.shape, generator=generator, out=s["noise"])
        else:
            s["noise"].copy_(noise_stack[i])

    def _key(self):
        return (tuple(p.data_ptr() for p in self.params),
                tuple(p.grad.data_ptr() for p in self.params),
                tuple((k, v.data_ptr(), tuple(v.shape), v.dtype) for k, v in self.slots.items()),
                self.unet.compute_dtype, self.unet.remat)

    def _capture(self) -> None:
        """Free the old graph, run the slots' micro-batch eagerly on a side
        stream, then capture the body."""
        self.graph, self.key = None, None
        torch.cuda.empty_cache()
        warm_up(self.body)
        grads = [p.grad.data_ptr() for p in self.params]
        t0 = time.perf_counter()
        self.graph, self.replay_launches = capture_graph(self.body)
        if [p.grad.data_ptr() for p in self.params] != grads:
            raise RuntimeError("the captured backward replaced a .grad tensor: the graph "
                               "would accumulate into memory no caller reads")
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        self.key = self._key()

    def run(self, micro: range, z_stack, cond_stack, generator=None, t_stack=None,
            noise_stack=None) -> torch.Tensor:
        """Micro-batches ``micro`` of the stacks, their gradients summed into
        the zeroed static ``.grad``; returns the static sum of their losses
        (overwritten by the next call)."""
        if self.graphs and torch.is_anomaly_enabled():
            raise ValueError("anomaly detection cannot be captured: pass graphs=False")
        torch._foreach_zero_(self.grads())
        self.loss_sum.zero_()
        for i in micro:
            self._fill(z_stack, cond_stack, i, generator, t_stack, noise_stack)
            if not self.graphs:
                self.body()
            elif self._key() != self.key:
                self._capture()
            else:
                replay_graph(self.graph, self.replay_launches)
                self.replays += 1
        return self.loss_sum

    def counters(self) -> Dict[str, object]:
        """The counters as plain values, for logs and reports."""
        return {"graphed": self.graphs, "captures": self.captures,
                "capture_s": round(self.capture_s, 3), "replays": self.replays}
