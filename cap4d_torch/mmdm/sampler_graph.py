"""Stage 1's DDIM blocks as captured CUDA graphs (counterpart of the jitted
``multi_step`` of ``cap4d_tpu/mmdm/sampler.py``: a ``lax.scan`` over K
DDIM steps, each a ``lax.scan`` over the step's group-rounds with the eps
scatter-add, then the DDIM update).

The port's counterpart of that program is two captured
``torch.cuda.CUDAGraph``s over static slots, replayed ``n_rounds`` + 1
times a DDIM step:

- the **round**: one round of ``n_par`` groups through the UNet with CFG
  (``StochasticIOSampler._round_eps``) and the ``index_add_`` of its eps
  into the static accumulator. It gathers its index rows from the block's
  device tables by a device round counter that it advances itself, and its
  timestep from the block's timestep table by a device step counter, so a
  step's rounds are replays with no host work in between. A whole step is
  not one graph: the flagship's 120 rounds of ~1,500 kernels each would
  make one of ~180k nodes.
- the **update**: ``x_bank * x_factor + eps * e_factor`` written into the
  static latent bank (two products, then a sum, as the eager expression),
  the factors a float32 row of the block's factor table (computed on the
  host in float64), then ``eps`` zeroed and the step counter advanced.

A block is K DDIM steps. Its tables (the K steps' reference and group
permutations, timesteps and update factors) are drawn on the host in the
eager order and copied into the device tables from pinned host buffers
with ``non_blocking=True``: two sets of buffers in turn, a set written
again only after the CUDA event behind its last copy. The copy is ordered
on the stream after the previous block's replays, so the host draws and
stages block b+1 while the card runs block b.

The graphs are keyed by the slots' shapes and by the address of every
tensor they read or write (the UNet's parameters, the conditioning banks,
the latent bank, the accumulator, the tables and counters); a changed key
frees both graphs before the next capture. A capture follows PyTorch's
recipe: the first real round (or update) runs eagerly on a side stream,
then the body is captured once and replayed for the rest. With
``graphs=False`` (the CPU, ``detect_anomaly``, and comparisons) the same
bodies run eagerly on the same slots. A capture or replay error raises;
there is no eager fallback on the card. Kernel launches inside replays are
counted through ``cuda_build.replay_graph``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from cap4d_torch.ops.cuda_build import capture_graph, replay_graph, warm_up


class BlockGraphs:
    """The round and update bodies of one sampling run over static slots,
    captured and replayed on the card (``graphs=True``) or run eagerly.

    ``round_eps(ref_idx, gen_idx, t)`` gives one round's eps (n_par, G, h,
    w, C) of index rows (n_par, R) / (n_par, G) and a (1,) timestep.
    ``x_bank`` and ``eps`` are written in place. Counters for the caller:
    ``captures``, ``capture_s`` (host seconds in ``torch.cuda.graph``),
    ``replays`` and ``replay_launches`` (each kernel's launches in one
    replay of each graph)."""

    NAMES = ("round", "update")

    def __init__(self, round_eps: Callable, params, tensors, x_bank: torch.Tensor,
                 n_rounds: int, n_par: int, R: int, G: int, k_max: int, graphs: bool):
        dev = x_bank.device
        if graphs and dev.type != "cuda":
            raise ValueError(f"CUDA graphs need the card, got {dev}")
        self.round_eps, self.params, self.tensors = round_eps, list(params), list(tensors)
        self.x_bank = x_bank
        self.eps = torch.zeros_like(x_bank)
        self.n_rounds, self.k_max, self.graphs = n_rounds, k_max, graphs
        rows = k_max * n_rounds
        self.tables = {"ref": torch.zeros((rows, n_par, R), dtype=torch.int64, device=dev),
                       "gen": torch.zeros((rows, n_par, G), dtype=torch.int64, device=dev),
                       "t": torch.zeros((k_max,), dtype=torch.int64, device=dev),
                       "factors": torch.zeros((k_max, 2), dtype=torch.float32, device=dev)}
        self.counter = torch.zeros((2,), dtype=torch.int64, device=dev)   # [round, step]
        self.pinned = dev.type == "cuda"
        self.host: list = [None, None]
        self.copied: list = [None, None]
        self.turn = 0
        self.graph: Dict[str, Optional[torch.cuda.CUDAGraph]] = dict.fromkeys(self.NAMES)
        self.replay_launches: Dict[str, Dict[str, int]] = {}
        self.key = None
        self.captures, self.capture_s, self.replays = 0, 0.0, 0

    # ------------------------------------------------------------- bodies

    def round_body(self) -> torch.Tensor:
        """The round that the round counter names, its eps added into
        ``eps``; returns the round's eps."""
        c, k = self.counter[0:1], self.counter[1:2]
        ref_idx = self.tables["ref"].index_select(0, c)[0]
        gen_idx = self.tables["gen"].index_select(0, c)[0]
        e = self.round_eps(ref_idx, gen_idx, self.tables["t"].index_select(0, k))
        self.eps.index_add_(0, gen_idx.reshape(-1), e.reshape(-1, *e.shape[2:]).float())
        c.add_(1)
        return e

    def update_body(self) -> None:
        """The DDIM update of the step that the step counter names, in place;
        ``eps`` back to zero."""
        k = self.counter[1:2]
        f = self.tables["factors"].index_select(0, k)[0]
        torch.add(self.x_bank * f[0], self.eps * f[1], out=self.x_bank)
        self.eps.zero_()
        k.add_(1)

    # ------------------------------------------------------------- staging

    def stage(self, block: Dict[str, np.ndarray]) -> None:
        """A block's host tables (the leading K·n_rounds or K rows) into the
        device tables, and the counters to 0. On the card through the next
        set of pinned buffers, ``non_blocking``."""
        if not self.pinned:
            for n, a in block.items():
                self.tables[n][:len(a)].copy_(torch.from_numpy(a))
            self.counter.zero_()
            return
        s = self.turn
        self.turn ^= 1
        if self.copied[s] is not None:
            self.copied[s].synchronize()
        if self.host[s] is None:
            self.host[s] = {n: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                            for n, t in self.tables.items()}
        for n, a in block.items():
            self.host[s][n].numpy()[:len(a)] = a
            self.tables[n][:len(a)].copy_(self.host[s][n][:len(a)], non_blocking=True)
        self.copied[s] = torch.cuda.Event()
        self.copied[s].record()
        self.counter.zero_()

    # ------------------------------------------------------------- running

    def _key(self):
        ts = self.params + self.tensors + [self.x_bank, self.eps, self.counter,
                                           *self.tables.values()]
        return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in ts)

    def check_key(self) -> None:
        """Free both graphs when a tensor they read or write has moved."""
        if self.graphs and self._key() != self.key:
            self.close()
            self.key = self._key()

    def run(self, name: str) -> Optional[torch.Tensor]:
        """The body ``name`` ("round" or "update") once: eagerly, or a replay
        of its graph, captured after an eager warm-up on first use. Returns
        the round's eps when run eagerly, else None."""
        body = self.round_body if name == "round" else self.update_body
        if not self.graphs:
            return body()
        if self.graph[name] is None:
            # the real first round (update) is the capture's warm-up
            warm_up(body)
            t0 = time.perf_counter()
            self.graph[name], self.replay_launches[name] = capture_graph(body)
            self.capture_s += time.perf_counter() - t0
            self.captures += 1
            return None
        replay_graph(self.graph[name], self.replay_launches[name])
        self.replays += 1
        return None

    def close(self) -> None:
        """Free the graphs and their memory pools; the counters stay."""
        if any(g is not None for g in self.graph.values()):
            self.graph = dict.fromkeys(self.NAMES)
            self.key = None
            torch.cuda.empty_cache()

    def counters(self) -> Dict[str, object]:
        """The counters as plain values, for logs and reports."""
        return {"graphed": self.graphs, "steps_per_block": self.k_max,
                "captures": self.captures, "capture_s": round(self.capture_s, 3),
                "replays": self.replays}
