"""Multi-device simplex execution and fault tolerance.

* ``simplex_sharding`` — equal-volume fold partitions of any
  ``SimplexSchedule``, the ``shard_skew`` metric, shard schedules the
  engine's kernels launch, and the sharded CA executors (engine per-shard
  launches; SPMD slabs over ``torch.distributed``) — DESIGN.md §7.
* ``sharding`` — LM parameter/optimizer/batch/cache partition rules as
  specs and DTensor placements.
* ``collectives`` — mesh axes' process groups and the conjugate
  collectives of the attention and MoE mesh forms.
* ``fault_tolerance`` — heartbeat files and the ``watchdog_restart``
  supervision loop.
* ``compression`` — cross-pod gradient compression with error feedback.
"""

from .compression import (  # noqa: F401
    compress_bf16,
    compress_int8,
    decompress_int8,
    init_error_state,
)
from .sharding import (  # noqa: F401
    Spec,
    batch_specs,
    cache_specs,
    dp_axes,
    named,
    opt_state_specs,
    param_specs,
)
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
    "Spec",
    "dp_axes",
    "param_specs",
    "opt_state_specs",
    "batch_specs",
    "cache_specs",
    "named",
    "init_error_state",
    "compress_bf16",
    "compress_int8",
    "decompress_int8",
]
