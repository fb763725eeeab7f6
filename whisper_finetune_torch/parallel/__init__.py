"""Data parallelism across processes: the counterpart of
``whisper_finetune_tpu/parallel/``. See :mod:`.comm`."""

from whisper_finetune_torch.parallel.comm import (
    DATA_AXIS,
    all_gather_rows,
    all_reduce,
    counts,
    is_initialized,
    rank,
    reduce_scatter_rows,
    reset_counts,
    shard_rows,
    world,
    zero_shardable,
)

__all__ = [
    "DATA_AXIS",
    "all_gather_rows",
    "all_reduce",
    "counts",
    "is_initialized",
    "rank",
    "reduce_scatter_rows",
    "reset_counts",
    "shard_rows",
    "world",
    "zero_shardable",
]
