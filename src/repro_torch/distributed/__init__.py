"""Multi-device simplex execution and fault tolerance.

* ``simplex_sharding`` — equal-volume fold partitions of any
  ``SimplexSchedule``, the ``shard_skew`` metric, shard schedules the
  engine's kernels launch, and the sharded CA executors (engine per-shard
  launches; SPMD slabs over ``torch.distributed``) — DESIGN.md §7.
* ``fault_tolerance`` — heartbeat files and the ``watchdog_restart``
  supervision loop.
"""

from .simplex_sharding import (  # noqa: F401
    ShardedSimplexCA,
    ShardSchedule,
    StepShard,
    fold_partition,
    shard_mesh,
    shard_schedules,
    shard_skew,
    shard_state,
    sharded_ca,
    slab_skew,
)

__all__ = [
    "StepShard",
    "ShardSchedule",
    "fold_partition",
    "shard_schedules",
    "shard_skew",
    "slab_skew",
    "shard_mesh",
    "shard_state",
    "ShardedSimplexCA",
    "sharded_ca",
]
