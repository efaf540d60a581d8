"""The parallelism layer (counterpart of ``cap4d_tpu/parallel``):
``torch.distributed``, one process per card. See ``mesh.py``."""

from cap4d_torch.parallel.mesh import (
    DP,
    all_reduce_mean_,
    all_reduce_sum_,
    barrier,
    broadcast_,
    dp_mesh,
    gather_object,
    init_dp,
    local_dp,
    pick_backend,
    rank_card,
    shard_slice,
    spawn,
)

__all__ = ["DP", "all_reduce_mean_", "all_reduce_sum_", "barrier", "broadcast_", "dp_mesh",
           "gather_object", "init_dp", "local_dp", "pick_backend", "rank_card",
           "shard_slice", "spawn"]
