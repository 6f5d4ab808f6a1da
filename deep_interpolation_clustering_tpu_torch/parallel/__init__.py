"""Data-parallel and multi-process runs on `torch.distributed`
(counterpart of the JAX `parallel/`): the world of ranks and its
collectives (`mesh`), process groups and their launch (`multihost`), and
row-sharded cohort storage (`cohort.ShardedCohort`, the JAX
`parallel/cohort.py`): with `shard_cohort` each rank stores its B/D columns
of every batch and the trainers re-lay the storage out once an epoch."""

from .cohort import ShardedCohort
from .mesh import (
    all_max,
    all_min,
    all_sum,
    all_sum_grad,
    all_sum_grads_,
    broadcast_,
    capturable,
    gather_blocks,
    gather_rows,
    grouped,
    local_rows,
    pad_batch_to,
    permuted_share,
    rank,
    replicated,
    segment_rows,
    shard_rows,
    take_rows,
    world_size,
)
from .multihost import (
    barrier,
    device_fetch,
    free_port,
    initialize,
    is_main_process,
    process_count,
    shutdown,
    spawn,
)

__all__ = [
    "ShardedCohort",
    "all_max",
    "all_min",
    "all_sum",
    "all_sum_grad",
    "all_sum_grads_",
    "barrier",
    "broadcast_",
    "capturable",
    "device_fetch",
    "free_port",
    "gather_blocks",
    "gather_rows",
    "grouped",
    "initialize",
    "is_main_process",
    "local_rows",
    "pad_batch_to",
    "permuted_share",
    "process_count",
    "rank",
    "replicated",
    "segment_rows",
    "shard_rows",
    "shutdown",
    "spawn",
    "take_rows",
    "world_size",
]
