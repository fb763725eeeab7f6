"""Whole-train-state save and resume, the counterpart of
``whisper_finetune_tpu/train/state_io.py``.

The reference saves model weights only and cannot resume a run; the JAX
package (and this port) save the entire :class:`TrainState`: every
parameter (trainable and frozen, float32, by path), the optimizer state
(moments as tensors, blockwise-quantized ones as their int8 / uint8 codes
and float32 block scales, the update count) and the step count, so a
stopped run continues where it stopped. Enabled by the config keys

    training:
      resume_from: <path of a train_state.pt written earlier>
      save_train_state: true   # write <run dir>/train_state.pt at eval steps

The format is the port's own: one ``torch.save`` file of plain tensors,
lists and ints. It reads neither the JAX package's orbax directory nor
the other way round; the OpenAI ``.pt`` checkpoints (``models/checkpoint``)
are what the two packages share.

Under ZeRO-1 the optimizer state lives as row shards across the ranks
(``train/zero.py``): :func:`save_train_state` gathers each sharded moment
(a collective every rank joins; rank 0 writes the file) and
:func:`load_train_state` reads the whole state on every rank and keeps this
rank's shards, so a run may resume at another world size.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from whisper_finetune_torch import parallel
from whisper_finetune_torch.optim.optimizers import PartitionState
from whisper_finetune_torch.optim.quantized import QMoment
from whisper_finetune_torch.train.step import TrainState, trainable_leaves
from whisper_finetune_torch.train.zero import (
    map_moments,
    owned_moments,
    zero_gather_state,
    zero_shard_state,
)

FORMAT = "whisper_finetune_torch.train_state/1"


def _host(m):
    if isinstance(m, QMoment):
        return QMoment(m.codes.cpu(), m.scale.cpu())
    return m.cpu()


def _counts(opt_state) -> Any:
    """The update counts of ``opt_state`` (one, or one a partition half)."""
    if isinstance(opt_state, PartitionState):
        return {"muon": opt_state.muon.count, "adamw": opt_state.adamw.count}
    return opt_state.count


def save_train_state(path: str, state: TrainState, tx, zero_shard: bool = False) -> None:
    """Write ``state`` to ``path`` (``train_state.pt``; written to a
    temporary name and renamed). With ``zero_shard`` every rank must call it:
    the sharded moments are gathered, and rank 0 writes."""
    leaves = [p for _, p in trainable_leaves(state.model)]
    main = parallel.rank() == 0
    if zero_shard:
        opt_state = zero_gather_state(tx, state.opt_state, leaves,
                                      to=_host if main else (lambda m: None))
    elif main:
        opt_state = map_moments(tx, state.opt_state, lambda i, m: _host(m))
    if not main:
        return
    payload: Dict[str, Any] = {
        "format": FORMAT,
        "params": {".".join(path): p.detach().cpu() for path, p in state.model.leaves()},
        "trainable": [".".join(path) for path, _ in trainable_leaves(state.model)],
        "moments": [[tuple(m) if isinstance(m, QMoment) else m for m in ms]
                    for ms in owned_moments(tx, opt_state, len(leaves))],
        "counts": _counts(opt_state),
        "step": int(state.step),
    }
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, template: TrainState, tx, zero_shard: bool = False
                     ) -> TrainState:
    """Restore into ``template`` (built as for a fresh run: the same model,
    trainable leaves and optimizer): parameters are copied in place,
    moments replace the template's, counts and the step are restored. With
    ``zero_shard`` each rank keeps its shards of the whole saved state."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not a train state of this package "
                         f"(format {payload.get('format')!r}, want {FORMAT!r})")
    named = trainable_leaves(template.model)
    if payload["trainable"] != [".".join(path) for path, _ in named]:
        raise ValueError(f"{path}: the saved trainable leaves differ from this run's")
    with torch.no_grad():
        for path, p in template.model.leaves():
            saved = payload["params"][".".join(path)]
            if saved.shape != p.shape:
                raise ValueError(f"{path}: saved {tuple(saved.shape)}, model {tuple(p.shape)}")
            p.copy_(saved)

    moments = payload["moments"]
    cursor = [0] * len(moments)

    def restore(i, m):  # on the host, in the template moment's dtypes
        saved = moments[i][cursor[i]]
        cursor[i] += 1
        if isinstance(m, QMoment):
            return QMoment(saved[0].to(m.codes.dtype), saved[1].to(m.scale.dtype))
        return saved.to(m.dtype)

    leaves = [p for _, p in named]
    opt_state = map_moments(tx, template.opt_state, restore)
    if zero_shard:
        opt_state = zero_shard_state(tx, opt_state, leaves)
    dev = leaves[0].device if leaves else torch.device("cpu")
    opt_state = map_moments(
        tx, opt_state, lambda i, m: (QMoment(m.codes.to(dev), m.scale.to(dev))
                                     if isinstance(m, QMoment) else m.to(dev)))
    _set_counts(opt_state, payload["counts"])
    return TrainState(template.model, opt_state, int(payload["step"]))


def _set_counts(opt_state, counts) -> None:
    if isinstance(counts, dict):
        opt_state.muon.count = counts["muon"]
        opt_state.adamw.count = counts["adamw"]
    else:
        opt_state.count = counts
