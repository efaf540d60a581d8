"""Data parallelism over processes: ``torch.distributed``, one process per
card (counterpart of ``cap4d_tpu/parallel/mesh.py``).

The JAX package puts a 1-D ``("dp",)`` mesh over every local device and
shards a leading batch axis over it; XLA inserts the collectives. Here each
rank is a process that owns one card (``torchrun`` or :func:`spawn` starts
them) and runs the same program on its contiguous block of that axis
(:func:`shard_slice`, the block ``P("dp")`` gives device ``rank``); the
callers reduce with :func:`all_reduce_mean_`, :func:`all_reduce_sum_` and
:func:`broadcast_`.

- ``dp_mesh`` becomes the ranks taking part (:func:`dp_mesh`).
- ``dcn_dp_mesh`` (the multi-host ``(dcn, dp)`` shape) flattens to the same
  group split in the JAX sampler; a multi-node ``torchrun`` gives one flat
  process group, so it has no counterpart.
- ``batch_sharding`` and ``replicated`` name shardings, which have no
  meaning for processes that each hold whole tensors.
- ``force_cpu_devices`` is JAX platform plumbing. The CPU tests here run
  :func:`spawn` with ``device="cpu"`` over gloo instead.

Without a ``torchrun`` environment :func:`init_dp` returns world 1 with no
process group, and every collective here is then a no-op, so each entry
point runs exactly as on one card. An entry point called without a
:class:`DP` takes that world-1 one (:func:`local_dp`).

Backend: NCCL when every rank on the host has a card of its own, gloo when
ranks share a card or run on the CPU (gloo stages CUDA tensors through host
memory). An explicit NCCL request for ranks that share a card raises; there
is no silent switch.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from cap4d_torch.utils.device import resolve_device

BUCKET_BYTES = 256 * 2**20     # the most one all_reduce of all_reduce_mean_ moves
DEFAULT_TIMEOUT_S = 1800.0
# CPU threads of each rank that spawn starts: a few ranks share the host
# (pytest-xdist's workers on top), and their tensors are small
SPAWN_THREADS = 2


@dataclass(frozen=True)
class DP:
    """This process's place in the data-parallel group. ``group`` is None at
    world 1 without a launcher: then every collective is a no-op."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    group: Optional[Any] = None

    def close(self) -> None:
        """Destroy the process group (if this process created one)."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()


def rank_card(index: Optional[int], local_rank: int, local_world: int,
              n_cards: int) -> tuple[int, int]:
    """(this rank's card, how many cards the host's ``local_world`` ranks use
    between them). An explicit ``index`` (``--device cuda:0``) puts every
    local rank on that card; without one, rank ``r`` takes card
    ``r % n_cards``."""
    if n_cards < 1:
        raise ValueError("no CUDA card is visible")
    if index is not None:
        if not 0 <= index < n_cards:
            raise ValueError(f"card {index} requested, {n_cards} visible")
        return index, 1
    return local_rank % n_cards, min(local_world, n_cards)


def pick_backend(device_type: str, local_world: int, n_cards: int,
                 requested: Optional[str] = None) -> str:
    """The backend rule: NCCL when each of the host's ``local_world`` ranks
    has a card of its own, gloo when they share cards or run on the CPU.
    ``n_cards`` is the number of cards those ranks use between them
    (:func:`rank_card`), not the number visible. Raises on a request the
    rule refuses (NCCL on the CPU or on a shared card) instead of
    switching."""
    if requested not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {requested!r}")
    if device_type == "cpu":
        if requested == "nccl":
            raise ValueError("the NCCL backend needs CUDA devices; CPU ranks use gloo")
        return "gloo"
    shared = local_world > n_cards
    if requested == "nccl" and shared:
        raise ValueError(f"NCCL refuses two ranks on one device: {local_world} ranks on this "
                         f"host share {n_cards} card(s); use gloo or one rank per card")
    return requested or ("gloo" if shared else "nccl")


def local_dp(dp: Optional[DP], device=None) -> DP:
    """``dp`` itself, or world 1 on ``resolve_device(device)`` when None:
    what an entry point called without a :class:`DP` runs on."""
    if dp is None:
        return DP(device=resolve_device(device))
    if device is not None and torch.device(device).type != dp.device.type:
        raise ValueError(f"device {device} disagrees with the rank's device {dp.device}")
    return dp


def init_dp(device=None, backend: Optional[str] = None, init_method: Optional[str] = None,
            timeout_s: float = DEFAULT_TIMEOUT_S) -> DP:
    """Join the process group that ``torchrun`` (or :func:`spawn`) set up.

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    (and ``MASTER_ADDR``/``MASTER_PORT`` through the ``env://`` store unless
    ``init_method`` names another). Without them it returns world 1 on
    ``resolve_device(device)`` and creates no group. On CUDA the rank's card
    is ``cuda:{local_rank % device_count}``, or the card ``device`` names
    for every local rank (which then share it), made current before anything
    launches; ``device="cpu"`` runs the plain versions over gloo. Rank 0
    prints the backend and the device map."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return local_dp(None, device)
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = resolve_device(device)
    n_cards = 0
    if dev.type == "cuda":
        card, n_cards = rank_card(dev.index, local_rank, local_world, torch.cuda.device_count())
        dev = torch.device("cuda", card)
        torch.cuda.set_device(dev)
    chosen = pick_backend(dev.type, local_world, n_cards, backend)
    dist.init_process_group(chosen, init_method=init_method or "env://", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    dp = DP(rank, world, local_rank, dev, chosen, dist.group.WORLD)
    places = gather_object((rank, socket.gethostname(), str(dev)), dp)
    if rank == 0:
        print(f"[dp] backend {chosen}, world {world}: " + ", ".join(
            f"rank {r} -> {host}:{d}" for r, host, d in places), flush=True)
    return dp


def dp_mesh(n: Optional[int] = None, dp: Optional[DP] = None) -> range:
    """The ranks taking part: the first ``n`` (all when None); raises when
    ``n`` exceeds the world. The counterpart of the JAX package's
    ``dp_mesh(n)``, which takes the first ``n`` local devices."""
    world = dp.world if dp is not None else 1
    if n is None:
        return range(world)
    if not 1 <= n <= world:
        raise ValueError(f"{n} ranks requested, the process group has {world}")
    return range(n)


def shard_slice(n_items: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous block of ``n_items`` (``np.array_split``'s
    split: the first ``n_items % world`` blocks one longer). A block may be
    empty; its rank still joins every collective."""
    q, rem = divmod(n_items, world)
    start = rank * q + min(rank, rem)
    return slice(start, start + q + (rank < rem))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], dp: DP,
                     bucket_bytes: int = BUCKET_BYTES) -> int:
    """Average ``tensors`` over the ranks, in place: flatten them (by dtype,
    in order) into buckets of at most ``bucket_bytes`` (a larger tensor is a
    bucket of its own), one ``all_reduce(SUM)`` a bucket, divide by the
    world and copy back. Every rank gets the same bits. Returns the bytes
    reduced (0 without a group)."""
    if dp.group is None:
        return 0
    buckets: List[List[torch.Tensor]] = []
    open_bucket = {}
    for t in tensors:
        b = open_bucket.get(t.dtype)
        size = t.numel() * t.element_size()
        if b is None or b[1] + size > bucket_bytes:
            b = open_bucket[t.dtype] = [[], 0]
            buckets.append(b[0])
        b[0].append(t)
        b[1] += size
    moved = 0
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=dp.group)
        flat.div_(dp.world)
        moved += flat.numel() * flat.element_size()
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return moved


def all_reduce_sum_(tensor: torch.Tensor, dp: DP) -> None:
    """Sum ``tensor`` over the ranks, in place."""
    if dp.group is not None:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=dp.group)


def broadcast_(tensors: Sequence[torch.Tensor], dp: DP, src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, in place."""
    if dp.group is not None:
        for t in tensors:
            dist.broadcast(t, src, group=dp.group)


def barrier(dp: DP) -> None:
    """Wait until every rank arrives."""
    if dp.group is not None:
        if dp.backend == "nccl":
            dist.barrier(group=dp.group, device_ids=[dp.device.index])
        else:
            dist.barrier(group=dp.group)


def gather_object(obj, dp: DP) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if dp.group is None:
        return [obj]
    out = [None] * dp.world
    dist.all_gather_object(out, obj, group=dp.group)
    return out


# --------------------------------------------------------------- launcher ----

def _spawned_rank(rank: int, fn, world: int, device: str, tmp: str, args: tuple,
                  timeout_s: float, backend: Optional[str]) -> None:
    torch.set_num_threads(SPAWN_THREADS)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    dp = init_dp(device, backend, init_method=f"file://{tmp}/store", timeout_s=timeout_s)
    try:
        out = fn(dp, *args)
    finally:
        dp.close()
    path = Path(tmp) / f"rank{rank}.pkl"
    with open(path.with_suffix(".tmp"), "wb") as fh:
        pickle.dump(out, fh)
    path.with_suffix(".tmp").replace(path)


def spawn(fn: Callable, world: int, device, *args, timeout_s: float = 600.0,
          backend: Optional[str] = None) -> list:
    """Run ``fn(dp, *args)`` on ``world`` new processes, one rank each, and
    return each rank's (picklable) result in rank order.

    The ranks meet through a ``file://`` store in a temporary directory (no
    TCP port), use ``SPAWN_THREADS`` CPU threads each, and give every
    collective ``timeout_s``. ``fn`` must be importable (module level) from
    a module that the children can import cheaply. A child's exception or
    non-zero exit raises here with its traceback; ranks still running after
    ``timeout_s`` are killed and ``TimeoutError`` raised."""
    with tempfile.TemporaryDirectory(prefix="cap4d_dp_") as tmp:
        ctx = torch.multiprocessing.spawn(
            _spawned_rank, args=(fn, world, str(device), tmp, args, timeout_s, backend),
            nprocs=world, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        out = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as fh:
                out.append(pickle.load(fh))
        return out
