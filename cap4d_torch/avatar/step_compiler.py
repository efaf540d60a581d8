"""The fit's train step as a captured CUDA graph (counterpart of
``cap4d_tpu/avatar/step_compiler.py`` and of its trainer's chunked scan
program ``_build_train_chunk``).

The JAX package compiles each variant of its train step (SH degree, store
capacity, raster caps) ahead of time and dispatches ``CHUNK_LEN`` iterations
as one scan program, so the host pays one dispatch per chunk. The port's
counterpart of a compiled step is a captured ``torch.cuda.CUDAGraph`` of
:meth:`AvatarTrainer.step`: FLAME or SMPL, the deform net, world gaussians,
the 3DGS render through K4 with the static pair budget, the losses with
LPIPS, ``autograd.grad`` through K5, the densification statistics and Adam,
every update written into the trainer's own tensors. A replay reads its
inputs from the device: the dispatch's camera indices and first iteration,
uploaded once a dispatch, and a lane counter that the step itself advances,
so ``k`` replays are ``k`` graph launches and no host work in between.

A graph is keyed by (width, height, active SH degree, gaussians, pair
budget) and by the addresses of every tensor it reads or writes: the
densification, which replaces the store, and a restored checkpoint, which
replaces the tensors, both lead to a new capture. A capture follows
PyTorch's recipe: the dispatch's first iteration runs eagerly on a side
stream (cuBLAS, cuDNN and the kernels' modules initialise there, and the
iteration is the real one, so no state is touched twice), then the step is
captured once and replayed for the rest. The old graph and its memory pool
are freed before a new capture, so only one step's activations are held.

Each dispatch snapshots the written state on the device first. When a
render's candidates overflowed the pair budget in any of its iterations,
the snapshot is restored, the budget grows to 1.5× what was needed and the
dispatch runs again: no pair is ever dropped, so the trajectory does not
depend on the budget. With ``graphs=False`` (the CPU, where the tests run
it) the same lane step runs eagerly, with the same snapshots and regrowths.

Kernel launches inside a replay do not pass through ``CudaKernel.call``:
the launches counted while capturing are taken back (a capture launches
nothing) and added again at every replay (``cuda_build.capture_graph``,
``replay_graph``). A capture or replay error raises;
there is no eager fallback on the card.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cap4d_torch.avatar.trainer import AvatarTrainer, CameraBank
from cap4d_torch.ops.cuda_build import capture_graph, replay_graph, warm_up

# a pair budget is a multiple of this many candidate slots
BUDGET_QUANTUM = 65536


def next_budget(needed: int) -> int:
    """1.5× ``needed`` candidate slots, rounded up to :data:`BUDGET_QUANTUM`."""
    return max(-(-int(1.5 * needed) // BUDGET_QUANTUM), 1) * BUDGET_QUANTUM


class StepGraphs:
    """Dispatches of the trainer's step over a :class:`CameraBank`, captured
    and replayed on the card (``graphs=True``) or run eagerly.

    Counters for the caller: ``captures`` and ``capture_s`` (host seconds in
    ``torch.cuda.graph``), ``replays``, ``regrowths`` ([(old, new budget)]),
    ``rolled_back`` (iterations run and then undone by a regrowth) and
    ``replay_launches`` (each kernel's launches in one replay)."""

    def __init__(self, trainer: AvatarTrainer, bank: CameraBank, budget: int, max_len: int,
                 graphs: bool):
        if graphs and trainer.device.type != "cuda":
            raise ValueError(f"CUDA graphs need the card, got {trainer.device}")
        self.trainer, self.bank, self.budget, self.max_len = trainer, bank, budget, max_len
        self.graphs = graphs
        dev = trainer.device
        # static inputs: [iteration of lane 0, Adam step of lane 0, lane, camera per lane]
        self.meta = torch.zeros(3 + max_len, dtype=torch.int64, device=dev)
        self.keys: Optional[List[str]] = None
        self.out: Optional[torch.Tensor] = None     # (max_len, losses + overflow) float64
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.snapshot: List[torch.Tensor] = []
        self.captures, self.capture_s, self.replays = 0, 0.0, 0
        self.regrowths: List[Tuple[int, int]] = []
        self.rolled_back = 0
        self.replay_launches: Dict[str, int] = {}

    # --------------------------------------------------------------- the step

    def lane_step(self) -> None:
        """One iteration with every input read on the device: lane j's camera,
        iteration and Adam step (lane 0's plus j); its losses and overflow
        count go to row j of ``out``, and the lane advances."""
        tr, meta = self.trainer, self.meta
        lane = meta[2:3]
        cam = self.bank.camera(meta.index_select(0, lane + 3))
        sched = tr.schedule(meta[0:1] + lane, meta[1:2] + lane)
        losses, overflow = tr.step(cam, sched, self.bank.width, self.bank.height, self.budget)
        row = torch.stack([v.to(torch.float64) for v in losses.values()]
                          + [overflow[0].to(torch.float64)])
        if self.out is None:
            self.keys = list(losses)
            self.out = torch.zeros((self.max_len, row.shape[0]), dtype=torch.float64,
                                   device=tr.device)
        self.out.index_copy_(0, lane, row[None])
        lane.add_(1)

    def _key(self):
        tr = self.trainer
        ptrs = tuple(t.data_ptr() for t in tr.written_state() + tr.read_state())
        return (self.bank.width, self.bank.height, tr.active_sh_degree, tr.n_active,
                self.budget, ptrs)

    def _capture(self) -> None:
        """Capture :meth:`lane_step` after the eager first lane has run."""
        t0 = time.perf_counter()
        self.graph, self.replay_launches = capture_graph(self.lane_step)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1

    def _replay(self) -> None:
        replay_graph(self.graph, self.replay_launches)
        self.replays += 1

    # ------------------------------------------------------------- dispatches

    def _save(self) -> None:
        state = self.trainer.written_state()
        if len(self.snapshot) != len(state) or any(
                s.shape != t.shape for s, t in zip(self.snapshot, state)):
            self.snapshot = [torch.empty_like(t) for t in state]
        for s, t in zip(self.snapshot, state):
            s.copy_(t)

    def _restore(self) -> None:
        for s, t in zip(self.snapshot, self.trainer.written_state()):
            t.copy_(s)

    def _run_lanes(self, cams: List[int], iteration: int, adam_step: int) -> np.ndarray:
        k = len(cams)
        meta = np.zeros(3 + self.max_len, np.int64)
        meta[:3] = iteration, adam_step, 0
        meta[3:3 + k] = cams
        self.meta.copy_(torch.from_numpy(meta))
        if not self.graphs:
            for _ in range(k):
                self.lane_step()
            return self.out[:k].cpu().numpy()
        key = self._key()
        lanes = range(k)
        if key != self.key:
            # one graph's memory at a time: free the old one before the warm-up
            self.graph, self.key = None, None
            torch.cuda.empty_cache()
            # the real first lane is the capture's warm-up, on a side stream
            warm_up(self.lane_step)
            self._capture()
            self.key = key
            lanes = range(1, k)
        for _ in lanes:
            self._replay()
        return self.out[:k].cpu().numpy()

    def run(self, cams: List[int], iteration: int, adam_step: int
            ) -> Dict[str, np.ndarray]:
        """Iterations ``iteration``.. on bank cameras ``cams`` (at most
        ``max_len``), Adam steps from ``adam_step``; the state stays on the
        device. Returns each loss (k,) fetched in one copy. Rolls back and
        regrows the budget until no iteration overflowed."""
        if not 0 < len(cams) <= self.max_len:
            raise ValueError(f"a dispatch takes 1..{self.max_len} iterations, got {len(cams)}")
        self.trainer.schedule_tables(max(iteration, adam_step) + len(cams))
        while True:
            self._save()
            rows = self._run_lanes(cams, iteration, adam_step)
            needed = int(rows[:, -1].max())
            if needed == 0:
                return {k: rows[:, i] for i, k in enumerate(self.keys)}
            self._restore()
            self.rolled_back += len(cams)
            old = self.budget
            self.budget = next_budget(old + needed)
            self.regrowths.append((old, self.budget))

    def counters(self) -> Dict[str, object]:
        """The counters as plain values, for logs and reports."""
        return {"graphed": self.graphs, "dispatch_len": self.max_len, "captures": self.captures,
                "capture_s": round(self.capture_s, 3), "replays": self.replays,
                "budget": self.budget, "regrowths": self.regrowths,
                "rolled_back": self.rolled_back}

    def close(self) -> None:
        """Free the graph, its memory pool and the snapshot; the counters
        stay."""
        self.graph, self.key, self.snapshot = None, None, []
        if self.graphs:
            torch.cuda.empty_cache()


def probe_budget(trainer: AvatarTrainer, cams) -> int:
    """The pair budget for a fit: :func:`next_budget` of the largest
    (gaussian, tile) candidate count over every training camera, from one
    forward projection each, fetched together."""
    counts = torch.stack([trainer.candidate_count(c) for c in cams])
    return next_budget(int(counts.max()))
