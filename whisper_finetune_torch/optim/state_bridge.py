"""Optimizer state carried across from the JAX package, as numpy.

The caller walks the JAX state (``jax.tree.map(np.asarray, ...)``) and hands
the moments over leaf by leaf, in the leaf order the port's optimizer was
built with. A moment is a numpy array (float32, or bfloat16 for Muon's
half-width momentum) or a ``(codes, scale)`` pair of a blockwise-quantized
one: the port keeps the JAX package's 256-element blocks over the same
row-major leaf, so codes and scales move across unchanged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from whisper_finetune_torch._device import resolve_device
from whisper_finetune_torch.optim.muon import MuonState
from whisper_finetune_torch.optim.optimizers import AdamState
from whisper_finetune_torch.optim.quantized import Adam8bitState, Moment, QMoment


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16 of its own: move the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def moment_from_numpy(m, device="cuda") -> Moment:
    """A numpy array, or a (codes, scale) pair, as the port's moment."""
    dev = resolve_device(device)
    if isinstance(m, (tuple, list)):
        codes, scale = m
        return QMoment(_tensor(codes, dev), _tensor(scale, dev))
    return _tensor(m, dev)


def muon_state_from_numpy(count: int, momentum: Sequence, device="cuda") -> MuonState:
    return MuonState(int(count), [moment_from_numpy(m, device) for m in momentum])


def adam_state_from_numpy(count: int, mu: Sequence, nu: Sequence, device="cuda"):
    """Adam moments as :class:`AdamState` (all float32 arrays) or
    :class:`Adam8bitState` (any leaf quantized)."""
    mu = [moment_from_numpy(m, device) for m in mu]
    nu = [moment_from_numpy(m, device) for m in nu]
    if any(isinstance(m, QMoment) for m in mu + nu):
        return Adam8bitState(int(count), mu, nu)
    return AdamState(int(count), mu, nu)
