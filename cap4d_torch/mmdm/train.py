"""MMDM training CLI: multi-view diffusion training with virtual batching
(counterpart of ``cap4d_tpu/mmdm/train.py``).

    python -m cap4d_torch.mmdm.train --config_path configs/mmdm/cap4d_mmdm_final.yaml \
        --output_path out/mmdm_train
    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m cap4d_torch.mmdm.train --config_path ... --output_path ...

Reference parity: the shipped recipe (per-device batch 1, virtual batch 64,
AdamW at lr 1e-4, 100k steps, n_ref 4), the MMLDM loss path (per-view
timesteps, ref-masked eps loss, ``cfg_probability`` unconditional mixing)
and the ImageLogger's periodic sample grids.

As in the JAX package, the weights start from the random-weights mode (the
config's ``init_path`` names SD 2.1 weights that are not in the repository)
and the data from ``SyntheticMMDMDataset`` unless a dataset is passed.

Several cards: the CLI joins a ``torchrun`` process group, one process a
card (``cap4d_torch.parallel``). Each optimizer step's micro-batches split
over the ranks (``shard_slice(accum, rank, world)``), the ranks average their
gradients in one all-reduce, and every rank takes the same AdamW step: the
average of the step's micro-batch gradients is the same at any world size.
That is what the JAX CLI's docstring says of its ``dp_mesh``; its
``make_accum_train_step`` never reads the mesh, so the JAX CLI trains on one
device whatever the mesh.

Differences from ``cap4d_tpu``:

- the micro-batches of a step run in a Python loop, each with its own
  backward; on the card each is a replay of one captured CUDA graph
  (``step_graph.py``, the counterpart of the scan's body, which JAX
  compiles once). PyTorch sums their gradients in static ``.grad`` tensors
  and the step divides them by the number of micro-batches, as the JAX scan
  does; the division, the all-reduce and AdamW stay outside the graph;
- a worker thread draws the next step's batches while the card runs this
  one, and the stacks reach the card through pinned host buffers in turn
  (``BatchStager``), as JAX's asynchronous dispatch lets its host run ahead;
- training computes in bf16 by default (``dtype``), with fp32 parameters and
  AdamW state: the attention kernels take bf16 only. The JAX CLI's default
  is fp32;
- ``mmdm_step{N}.pkl`` holds ``params`` in the JAX package's flax layout
  (numpy) and ``opt_state`` as a plain dict ``{"count", "mu", "nu"}`` in the
  same layout, since optax's state classes cannot be pickled without optax.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from cap4d_torch.mmdm.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
    unet_norm_kinds,
    unet_torch_key,
)
from cap4d_torch.mmdm.ddim import ddim_sample
from cap4d_torch.mmdm.model import MMDM
from cap4d_torch.mmdm.step_graph import MicroBatchGraph
from cap4d_torch.mmdm.training import (
    TrainState,
    all_reduce_grads_,
    init_train_state,
    schedule_consts,
)
from cap4d_torch.parallel.mesh import DP, init_dp, local_dp, shard_slice
from cap4d_torch.utils.config import load_yaml
from cap4d_torch.utils.logging import save_image_grid


class SyntheticMMDMDataset:
    """Random multi-view batches with the real conditioning contract, drawn
    from ``np.random.default_rng(seed)`` in the JAX dataset's order, so the
    two packages see the same batches."""

    def __init__(self, model: MMDM, n_views: int = 8, n_ref: int = 4, seed: int = 0):
        self.model = model
        self.V = n_views
        self.R = n_ref
        self.rng = np.random.default_rng(seed)

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        lat = self.model.latent_size
        cch = self.model.unet.condition_channels
        while True:
            z = self.rng.normal(size=(batch_size, self.V, lat, lat, 4)).astype(np.float32)
            pos_enc = self.rng.normal(
                size=(batch_size, self.V, lat, lat, cch)).astype(np.float32)
            ref_mask = np.zeros((batch_size, self.V, lat, lat, 1), np.float32)
            ref_mask[:, : self.R] = 1.0
            yield {
                "z": z,
                "cond": {"pos_enc": pos_enc, "z_input": z * ref_mask, "ref_mask": ref_mask},
            }


def make_accum_train_step(model: MMDM, optimizer: torch.optim.Optimizer, accum_steps: int,
                          cfg_probability: float = 0.1, dp: Optional[DP] = None,
                          graphs: Optional[bool] = None):
    """One optimizer step over ``accum_steps`` micro-batches (virtual
    batching). Returns step(state, z_stack, cond_stack, generator,
    t_stack=None, noise_stack=None) → mean loss; the stacks are (accum, B,
    ...). Each micro-batch draws its unconditional mask, then its timesteps
    and noise, from ``generator`` unless ``t_stack``/``noise_stack`` give
    them. With ``dp`` rank r runs micro-batches ``shard_slice(accum_steps,
    r, world)`` of the stacks (``accum_steps`` must divide evenly); the loss
    is the global mean and every rank takes the same update.

    ``graphs`` (default: on the card, not on the CPU) replays each
    micro-batch as a captured CUDA graph (``step_graph.MicroBatchGraph``,
    kept as ``step.graph``); False runs the same body eagerly."""
    dp = local_dp(dp, model.device)
    if accum_steps % dp.world:
        raise ValueError(f"{accum_steps} micro-batches do not split evenly over {dp.world} ranks")
    mine = shard_slice(accum_steps, dp.rank, dp.world)
    mine = range(mine.start, mine.stop)
    n_mine = len(mine)
    unet = model.unet
    if graphs is None:
        graphs = next(unet.parameters()).device.type == "cuda"
    micro = MicroBatchGraph(unet, schedule_consts(model.schedule, model.device),
                            model.schedule.num_timesteps, cfg_probability, graphs)

    def step(state: TrainState, z_stack, cond_stack, generator=None, t_stack=None,
             noise_stack=None) -> torch.Tensor:
        loss_sum = micro.run(mine, z_stack, cond_stack, generator, t_stack, noise_stack)
        torch._foreach_div_(micro.grads(), n_mine)
        mean_loss = loss_sum / n_mine
        # the mean of the ranks' equal-sized means is the step's mean
        all_reduce_grads_(unet.parameters(), dp, extra=[mean_loss])
        optimizer.step()
        state.step += 1
        return mean_loss

    step.graph = micro
    return step


class BatchStager:
    """The next ``n_steps`` optimizer steps' micro-batches from ``batches``,
    as stacks (accum, B, ...) on ``device``, one step a ``next()``.

    A worker thread draws and stacks step n+1 while step n runs: on the card
    the host spends most of a graphed step blocked in its graph launches
    (the command buffer fills), with the GIL released, and numpy draws
    without it. The worker touches no CUDA state, so a capture may run
    meanwhile. On the card the stacks then go through two sets of pinned
    host buffers in turn (a set is written again only after the CUDA event
    behind its last copy) into the device stacks, ``non_blocking`` on the
    current stream: a copy from pageable memory would wait for the stream.
    The draws are those of the loop that drew each step in place: the same
    batches in the same order, and none past the last step."""

    def __init__(self, batches, accum: int, device, n_steps: int):
        self.batches, self.accum, self.left = batches, accum, n_steps
        self.device = torch.device(device)
        self.pool = ThreadPoolExecutor(max_workers=1)
        self.host: list = [None, None]
        self.copied: list = [None, None]
        self.stacks: Dict[str, torch.Tensor] = {}
        self.turn = 0
        self.pending = self._submit()

    def _draw(self) -> Dict[str, np.ndarray]:
        micro = [next(self.batches) for _ in range(self.accum)]
        return {"z": np.stack([m["z"] for m in micro]),
                **{k: np.stack([m["cond"][k] for m in micro]) for k in micro[0]["cond"]}}

    def _submit(self):
        if self.left == 0:
            return None
        self.left -= 1
        return self.pool.submit(self._draw)

    def next(self) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.pending is None:
            raise RuntimeError(f"all {self.accum}-micro-batch steps asked for are staged")
        arrays = self.pending.result()
        self.pending = self._submit()
        if self.device.type != "cuda":
            stacks = {n: torch.from_numpy(a) for n, a in arrays.items()}
        else:
            k = self.turn
            self.turn ^= 1
            if self.copied[k] is not None:
                self.copied[k].synchronize()
            if self.host[k] is None or any(self.host[k][n].shape != a.shape
                                           for n, a in arrays.items()):
                self.host[k] = {n: torch.empty(a.shape, dtype=torch.from_numpy(a).dtype,
                                               pin_memory=True) for n, a in arrays.items()}
            for n, a in arrays.items():
                self.host[k][n].numpy()[...] = a
                if n not in self.stacks or self.stacks[n].shape != a.shape:
                    self.stacks[n] = torch.empty(a.shape, dtype=self.host[k][n].dtype,
                                                 device=self.device)
                self.stacks[n].copy_(self.host[k][n], non_blocking=True)
            self.copied[k] = torch.cuda.Event()
            self.copied[k].record()
            stacks = self.stacks
        return stacks["z"], {n: v for n, v in stacks.items() if n != "z"}

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "BatchStager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def save_train_checkpoint(path: Path, state: TrainState, step: int) -> None:
    """``params`` and the AdamW moments (after at least one update) in the
    JAX package's flax layout."""
    named = dict(state.unet.named_parameters())
    norms = unet_norm_kinds(state.unet)
    opt = state.optimizer.state
    moments = {name: flax_from_state_dict({k: opt[p][name] for k, p in named.items()}, norms)
               for name in ("exp_avg", "exp_avg_sq")}
    count = int(opt[next(iter(named.values()))]["step"])
    with open(path, "wb") as fh:
        pickle.dump({"params": flax_from_state_dict(named, norms),
                     "opt_state": {"count": np.int32(count), "mu": moments["exp_avg"],
                                   "nu": moments["exp_avg_sq"]},
                     "step": step}, fh)


def load_train_checkpoint(path: Path, unet: torch.nn.Module) -> int:
    """Load the ``params`` of ``mmdm_step{N}.pkl`` into ``unet``; returns the
    step."""
    with open(path, "rb") as fh:
        ck = pickle.load(fh)
    unet.load_state_dict(state_dict_from_flax(ck["params"], unet_torch_key), strict=True)
    return int(ck["step"])


def train_mmdm(
    config_path: str | Path,
    output_path: str | Path,
    n_steps: Optional[int] = None,
    flame_asset_dir: str = "data/assets/flame",
    dtype: torch.dtype = torch.bfloat16,
    log_every: int = 50,
    save_every: Optional[int] = None,
    dataset=None,
    image_log_every: Optional[int] = None,
    device=None,
    dp: Optional[DP] = None,
    graphs: Optional[bool] = None,
) -> TrainState:
    """Train the MMDM UNet on the card (``device="cpu"`` for the plain
    versions) over the ranks of ``dp`` (None: this process alone); returns
    the final ``TrainState``, whose ``step_graph`` holds the micro-batch
    graph's counters. ``graphs``: see :func:`make_accum_train_step`.

    Every rank draws each step's micro-batches from the same seeded dataset
    and runs its share; its masks, timesteps and noise come from a generator
    seeded with ``rank · 2³² + 0`` (rank 0's is the one-card seed 0). Only
    rank 0 writes the metrics, the image log and the checkpoints; the
    logged loss is the global mean."""
    dp = local_dp(dp, device)
    dev = dp.device
    main = dp.rank == 0
    config = load_yaml(config_path)
    out = Path(output_path)
    if main:
        out.mkdir(parents=True, exist_ok=True)

    model = MMDM.from_config(config, flame_asset_dir=flame_asset_dir, dtype=dtype, device=dev,
                             remat=True, trainable=True)
    lr = float(config.get("learning_rate", 1e-4))
    batch = int(config.get("gpu_batch_size", 1))
    accum = int(config.get("virtual_batch_size", 64)) // batch
    total = n_steps or int(config.get("n_steps", 100_000))
    save_every = save_every or int(config.get("save_every_n_steps", 1000))

    state = init_train_state(model.unet, lr)
    step_fn = make_accum_train_step(model, state.optimizer, accum,
                                    cfg_probability=model.cfg_probability, dp=dp, graphs=graphs)
    state.step_graph = step_fn.graph
    if dataset is None:
        dataset = SyntheticMMDMDataset(model, n_views=model.n_frames,
                                       n_ref=int(config.get("n_ref", 4)))
    batches = dataset.batches(batch)
    generator = torch.Generator(device=dev).manual_seed(dp.rank << 32)

    with open(out / "train_metrics.jsonl", "a") if main else contextlib.nullcontext() as metrics, \
            BatchStager(batches, accum, dev, total) as stage:
        t0 = time.perf_counter()
        for step in range(1, total + 1):
            z_stack, cond_stack = stage.next()
            loss = step_fn(state, z_stack, cond_stack, generator)
            if main and (step % log_every == 0 or step == 1):
                l = float(loss)   # waits for the step's work on the card
                dt = (time.perf_counter() - t0) / step
                print(f"[{step}/{total}] loss={l:.5f} {1 / dt:.3f} steps/s", flush=True)
                metrics.write(json.dumps({"step": step, "loss": l, "steps_per_sec": 1 / dt}) + "\n")
                metrics.flush()
            if main and image_log_every and step % image_log_every == 0:
                # ImageLogger parity (cldm/logger.py): a decoded sample grid
                cond1 = {k: v[0][:1] for k, v in cond_stack.items()}
                shape = (1, model.n_frames, model.latent_size, model.latent_size, 4)
                z_s = ddim_sample(model, cond1, shape, steps=10,
                                  generator=torch.Generator(device=dev).manual_seed(0))
                imgs = model.decode_latents(z_s.reshape(-1, *z_s.shape[2:]))
                save_image_grid(imgs.reshape(1, *imgs.shape),
                                out / "image_log" / f"samples_{step:06d}.png")
            if main and (step % save_every == 0 or step == total):
                save_train_checkpoint(out / f"mmdm_step{step}.pkl", state, step)
    return state


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, required=True,
                        help="reference-format training config (config_dump.yaml)")
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--n_steps", type=int, default=None)
    parser.add_argument("--flame_asset_dir", type=str, default="data/assets/flame")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="torch.autograd.set_detect_anomaly (reference train.py:359,391); "
                             "runs the micro-batches eagerly, since its checks cannot be "
                             "captured in a CUDA graph")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args()
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    dp = init_dp(args.device)
    try:
        train_mmdm(args.config_path, args.output_path, n_steps=args.n_steps,
                   flame_asset_dir=args.flame_asset_dir, device=args.device, dp=dp,
                   graphs=False if args.detect_anomaly else None)
    finally:
        dp.close()


if __name__ == "__main__":
    main()
