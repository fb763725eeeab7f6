"""The process group and the row-slice collectives of data parallelism, the
counterpart of ``whisper_finetune_tpu/parallel/`` (a 1-D ``data`` mesh
there; here one process per card in the default ``torch.distributed``
process group that ``runtime.setup_distributed`` starts).

Every collective of the port goes through the helpers below: the train
step's gradient reduction and ZeRO-1 reduce-scatter and all-gather, Muon's
sharded Newton-Schulz, the evaluator's gathered statistics and the
train-state save. A "row" is an index of a tensor's leading axis: ZeRO-1
and Muon split stacked-layer weights (and every other leaf whose leading
axis divides by the world size) into contiguous row slices, rank ``r``
holding rows ``[r * per, (r + 1) * per)``.

Each helper counts its calls and the bytes it hands to the collective (the
rank's input) as ``helper.calls`` / ``helper.bytes``, the way a kernel
wrapper counts ``.launches``; :func:`reset_counts` zeroes them and
:func:`counts` reads them. Without a process group (one process) the world
is 1 and every helper returns its input's answer without a collective and
without counting; a group of one (a named backend at world size 1) runs
the collectives.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """Processes in the data-parallel group (1 without a process group)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def zero_shardable(t: torch.Tensor, n: int) -> bool:
    """Whether a leaf's leading axis splits evenly over ``n`` ranks
    (stacked-layer weights, positional embeddings; conv kernels with their
    leading 3 stay whole): JAX's ``_zero_shardable``."""
    return t.dim() >= 1 and t.shape[0] >= n and t.shape[0] % n == 0


def shard_rows(t: torch.Tensor, n: Optional[int] = None, r: Optional[int] = None
               ) -> torch.Tensor:
    """Rank ``r``'s row slice of ``t`` out of ``n`` (default: this process
    in the group): a view, so writing it writes ``t``."""
    n = world() if n is None else n
    r = rank() if r is None else r
    per = t.shape[0] // n
    return t[r * per:(r + 1) * per]


def _count(fn, t: torch.Tensor) -> None:
    fn.calls += 1
    fn.bytes += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over the ranks in place (``sum``, ``min`` or ``max``),
    in its own dtype; returns ``t``. A non-contiguous ``t`` (autograd may
    hand back a transposed gradient) goes through a contiguous copy."""
    if not is_initialized():
        return t
    _count(all_reduce, t)
    buf = t if t.is_contiguous() else t.contiguous()
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, _OPS[op]))
    return t if buf is t else t.copy_(buf)


def reduce_scatter_rows(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of this rank's row slice of ``t`` (a new tensor
    of ``t.shape[0] // world`` rows, in ``t``'s dtype): JAX's
    ``psum_scatter(..., scatter_dimension=0, tiled=True)``."""
    n = world()
    if not is_initialized():
        return t.clone()
    _count(reduce_scatter_rows, t)
    t = t.contiguous()
    out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype, device=t.device)
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, t)
    return out


def all_gather_rows(shard: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every rank's ``shard`` stacked along rows in rank order, written into
    ``out`` when given (its rows are ``world`` times the shard's): JAX's
    ``all_gather(..., axis=0, tiled=True)``. ``shard`` may be a view of
    ``out`` (a rank's own rows): it is copied first."""
    n = world()
    if out is None:
        out = torch.empty((shard.shape[0] * n, *shard.shape[1:]), dtype=shard.dtype,
                          device=shard.device)
    if not is_initialized():
        return out.copy_(shard) if out.data_ptr() != shard.data_ptr() else out
    _count(all_gather_rows, shard)
    src = shard.clone()  # never alias the collective's input with its output
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, src)
    return out


_HELPERS = (all_reduce, reduce_scatter_rows, all_gather_rows)


def reset_counts() -> None:
    for fn in _HELPERS:
        fn.calls = 0
        fn.bytes = 0


def counts() -> Dict[str, Dict[str, int]]:
    """``{helper: {"calls": n, "bytes": b}}`` since the last reset."""
    return {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes} for fn in _HELPERS}


reset_counts()
