"""ZeRO-1: which optimizer state each rank keeps, the counterpart of
``_zero_shardable``, ``_zero_opt_partition_specs`` and
``zero_state_sharding`` in ``whisper_finetune_tpu/train/step.py``.

The port's optimizer states hold one moment entry per trainable leaf, in
the leaf order the optimizer was built with (``mu`` / ``nu`` of Adam and
8-bit Adam, ``momentum`` of Muon, both halves of Muon's partition with its
labels), so a moment's owner is its parameter by position, not by path
suffix. A leaf *shards* over ``n`` ranks when its leading axis divides by
``n`` (:func:`parallel.zero_shardable`); then its gradient is
reduce-scattered over rows, rank ``r`` updates rows ``[r * per, (r + 1) *
per)`` of the parameter, and every moment the leaf owns is rank ``r``'s
row slice of the whole leaf's moment. A :class:`QMoment` (codes and block
scales) is sliced as one unit over its blocks. Counts are host integers,
the same on every rank.

One departure from JAX, where JAX's ZeRO step departs from its own
replicated step (ROADMAP queue 3, reference faults): a leaf whose
blockwise-quantized moment would not split on a 256-element block boundary
(its shard's size is not a multiple of 256; never at large-v3's widths)
stays whole here. JAX slices its ``(NB, 256)`` blocks over the devices
anyway, and each device then requantizes its shard on blocks of its own,
so its 8-bit state no longer matches the replicated step's.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from whisper_finetune_torch import parallel
from whisper_finetune_torch.optim.muon import MuonState
from whisper_finetune_torch.optim.optimizers import AdamState, PartitionState
from whisper_finetune_torch.optim.quantized import BLOCK, Adam8bitState, Moment, QMoment


def map_moments(tx, opt_state, fn: Callable[[int, Moment], Moment]):
    """A copy of ``opt_state`` with each moment ``m`` of trainable leaf
    ``i`` replaced by ``fn(i, m)``; counts are kept."""
    if isinstance(opt_state, PartitionState):
        idx = {lab: [i for i, lab_i in enumerate(tx.labels) if lab_i == lab]
               for lab in ("muon", "adamw")}
        return PartitionState(
            map_moments(tx.muon, opt_state.muon, lambda k, m: fn(idx["muon"][k], m)),
            map_moments(tx.adamw, opt_state.adamw, lambda k, m: fn(idx["adamw"][k], m)))
    if isinstance(opt_state, MuonState):
        return MuonState(opt_state.count, [fn(i, m) for i, m in enumerate(opt_state.momentum)])
    if isinstance(opt_state, (AdamState, Adam8bitState)):
        return type(opt_state)(opt_state.count,
                               [fn(i, m) for i, m in enumerate(opt_state.mu)],
                               [fn(i, m) for i, m in enumerate(opt_state.nu)])
    raise TypeError(f"ZeRO-1 does not know the optimizer state {type(opt_state).__name__}")


def owned_moments(tx, opt_state, n_leaves: int) -> List[List[Moment]]:
    """The moments each trainable leaf owns, in leaf order."""
    owned: List[List[Moment]] = [[] for _ in range(n_leaves)]

    def collect(i, m):
        owned[i].append(m)
        return m

    map_moments(tx, opt_state, collect)
    return owned


def zero_opt_partition(tx, opt_state, params: Sequence[torch.Tensor], n: int) -> List[bool]:
    """One bool a trainable leaf: whether the leaf, its gradient and every
    moment it owns split over ``n`` ranks (the counterpart of
    ``_zero_opt_partition_specs``: a moment shards iff its parameter does;
    a quantized moment only on whole 256-element blocks, see the module
    docstring). ``opt_state`` may be whole or already sharded."""
    flags = []
    for p, moments in zip(params, owned_moments(tx, opt_state, len(params))):
        ok = n > 1 and parallel.zero_shardable(p, n)
        if ok and any(isinstance(m, QMoment) for m in moments):
            ok = (p.numel() // n) % BLOCK == 0
        flags.append(ok)
    return flags


def _rows(m: Moment, n: int, r: int) -> Moment:
    if isinstance(m, QMoment):
        return QMoment(parallel.shard_rows(m.codes, n, r).clone(),
                       parallel.shard_rows(m.scale, n, r).clone())
    return parallel.shard_rows(m, n, r).clone()


def zero_shard_state(tx, opt_state, params: Sequence[torch.Tensor]):
    """This rank's ZeRO-1 optimizer state from the whole one (fresh from
    ``tx.init`` on the whole leaves, or loaded): the moments of every leaf
    that shards replaced by this rank's row slices (copies, so the whole
    moments can be freed), the others kept whole."""
    n, r = parallel.world(), parallel.rank()
    flags = zero_opt_partition(tx, opt_state, params, n)
    return map_moments(tx, opt_state, lambda i, m: _rows(m, n, r) if flags[i] else m)


def _gather(m: Moment) -> Moment:
    if isinstance(m, QMoment):
        return QMoment(parallel.all_gather_rows(m.codes), parallel.all_gather_rows(m.scale))
    return parallel.all_gather_rows(m)


def zero_gather_state(tx, opt_state, params: Sequence[torch.Tensor],
                      to: Callable[[Moment], Moment] = lambda m: m):
    """The whole optimizer state from every rank's shards (a collective: all
    ranks call it), each moment passed through ``to`` as soon as it is whole
    (``to`` may move it to the host, so only one leaf is whole on the card
    at a time)."""
    flags = zero_opt_partition(tx, opt_state, params, parallel.world())
    return map_moments(tx, opt_state, lambda i, m: to(_gather(m)) if flags[i] else to(m))
