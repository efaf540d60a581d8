"""Stage 3's frame render as a captured CUDA graph (counterpart of the
cached jitted frame program of ``cap4d_tpu/avatar/trainer.py``'s
``_make_render_fn`` / ``render_camera`` and of the dispatch pipeline of
``cap4d_tpu/avatar/animate.py``'s ``render_frame_loop``).

The JAX package compiles the whole frame (FLAME or SMPL, the deform net,
face frames, the splat render with the far-plane clip in the program) once
per (resolution, SH degree, depth, clip) and keeps ``PIPELINE = 8`` frames
dispatched ahead of the host, which fetches a frame only when it consumes
it. The port's counterpart of the program is
:meth:`AvatarTrainer.render_frame` captured as a ``torch.cuda.CUDAGraph``
over static slots: the driving sequence's cameras and timesteps on the
device (:class:`PoseTable`, no images), the frames to render in order, and
a lane counter that the render advances itself, so consecutive frames are
consecutive replays with no host work in between. The render has static
shapes through the pair budget (``rasterize_gaussians(budget=)``) and
returns the frame already quantised to uint8, the posed mesh's vertices
(for the PLY) and the budget's overflow count.

A graph is keyed by (width, height, SH degree, depth, clip, pair budget)
and by the address of every tensor it reads or writes; a changed key frees
the old graph and its memory pool before the next capture. A capture
follows PyTorch's recipe: the first frame after a key change renders
eagerly on a side stream (its outputs are that frame's), then the render
is captured and replayed for the frames after it. With ``graphs=False``
(the CPU, and comparisons) the same render runs eagerly on the same slots.
A capture or replay error raises; there is no eager fallback on the card.
Kernel launches inside replays are counted through
``cuda_build.replay_graph``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cap4d_torch.avatar.step_compiler import next_budget
from cap4d_torch.avatar.trainer import AvatarTrainer
from cap4d_torch.ops.cuda_build import capture_graph, replay_graph, warm_up


class PoseTable:
    """A camera path on the device without images: rt (N, 4, 4), K (N, 3,
    3) and timesteps (N,), each camera's (width, height) on the host."""

    def __init__(self, cams, device):
        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.stack(a), dtype=dtype, device=device)

        self.rt = t([c.rt for c in cams])
        self.K = t([c.intrinsics for c in cams])
        self.t = t([int(c.timestep) for c in cams], torch.int64)
        self.sizes: List[Tuple[int, int]] = [(c.width, c.height) for c in cams]

    def camera(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """rt, K and the one-element timestep of the row that the
        one-element index tensor ``idx`` names, gathered on the device."""
        i = idx.view(1)
        return {"rt": self.rt.index_select(0, i)[0], "K": self.K.index_select(0, i)[0],
                "t": self.t.index_select(0, i)}

    def tensors(self) -> List[torch.Tensor]:
        return [self.rt, self.K, self.t]


class FrameGraph:
    """The frames ``order`` (rows of ``table``) rendered one a :meth:`launch`
    by a captured and replayed :meth:`AvatarTrainer.render_frame`
    (``graphs=True``) or eagerly.

    Counters for the caller: ``captures``, ``capture_s`` (host seconds in
    ``torch.cuda.graph``), ``replays``, ``budget``, ``regrowths`` ([(old,
    new budget)]), ``rerendered`` (frames launched again after a regrowth)
    and ``replay_launches`` (each kernel's launches in one replay)."""

    def __init__(self, trainer: AvatarTrainer, table: PoseTable, order: Sequence[int],
                 budget: int, compute_depth: bool, clip: bool, graphs: bool):
        if graphs and trainer.device.type != "cuda":
            raise ValueError(f"CUDA graphs need the card, got {trainer.device}")
        self.trainer, self.table = trainer, table
        self.order_host = list(order)
        self.order = torch.as_tensor(self.order_host, dtype=torch.int64, device=trainer.device)
        self.lane = torch.zeros((1,), dtype=torch.int64, device=trainer.device)
        self.next_lane = 0
        self.budget, self.compute_depth, self.clip, self.graphs = budget, compute_depth, clip, graphs
        self.size = table.sizes[self.order_host[0]] if self.order_host else (0, 0)
        self.out: Optional[Dict[str, torch.Tensor]] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.captures, self.capture_s, self.replays, self.rerendered = 0, 0.0, 0, 0
        self.regrowths: List[Tuple[int, int]] = []
        self.replay_launches: Dict[str, int] = {}

    def body(self) -> Dict[str, torch.Tensor]:
        """The frame that the lane names, rendered from device inputs; the
        lane advances."""
        cam = self.table.camera(self.order.index_select(0, self.lane))
        out = self.trainer.render_frame(cam, *self.size, self.budget,
                                        compute_depth=self.compute_depth, clip=self.clip)
        self.lane.add_(1)
        return out

    def _key(self):
        tr = self.trainer
        ts = tr.written_state() + tr.read_state() + self.table.tensors() + [self.order, self.lane]
        return (self.size, tr.active_sh_degree, self.compute_depth, self.clip, self.budget,
                tuple(t.data_ptr() for t in ts))

    def launch(self, lane: int) -> Dict[str, torch.Tensor]:
        """Render frame ``order[lane]``; returns its outputs (on a replay the
        graph's static outputs, rewritten by the next replay)."""
        self.size = self.table.sizes[self.order_host[lane]]
        if lane != self.next_lane:
            self.lane.fill_(lane)
        self.next_lane = lane + 1
        if not self.graphs:
            return self.body()
        key = self._key()
        if key == self.key:
            replay_graph(self.graph, self.replay_launches)
            self.replays += 1
            return self.out
        # one graph's memory at a time: free the old one before the warm-up
        self.graph, self.key, self.out = None, None, None
        torch.cuda.empty_cache()
        first = {}
        warm_up(lambda: first.update(self.body()))     # the real frame, on a side stream
        for t in first.values():      # made on the side stream, read on this one
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream())
        t0 = time.perf_counter()
        captured = {}
        self.graph, self.replay_launches = capture_graph(lambda: captured.update(self.body()))
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        self.out, self.key = captured, key
        return first

    def grow(self, overflow: int) -> None:
        """A consumed frame overflowed the budget by ``overflow`` candidates:
        the budget grows to hold them with room (the next launch captures
        anew)."""
        old = self.budget
        self.budget = next_budget(old + overflow)
        self.regrowths.append((old, self.budget))

    def counters(self) -> Dict[str, object]:
        """The counters as plain values, for logs and reports."""
        return {"graphed": self.graphs, "captures": self.captures,
                "capture_s": round(self.capture_s, 3), "replays": self.replays,
                "budget": self.budget, "regrowths": self.regrowths,
                "rerendered": self.rerendered}

    def close(self) -> None:
        """Free the graph and its memory pool; the counters stay."""
        self.graph, self.key, self.out = None, None, None
        if self.graphs:
            torch.cuda.empty_cache()


def first_budget(trainer: AvatarTrainer, cam) -> int:
    """:func:`next_budget` of the first frame's candidates (the training
    render's count, which the far-plane clip only lowers)."""
    return next_budget(int(trainer.candidate_count(cam)))
