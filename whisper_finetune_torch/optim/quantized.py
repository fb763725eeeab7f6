"""Blockwise 8-bit Adam / AdamW, the port of ``whisper_finetune_tpu/optim/quantized.py``.

Both Adam moments of a leaf with at least ``MIN_QUANT_SIZE`` elements are
stored in 256-element blocks: the first moment as int8 codes with a per-block
absmax/127 scale, the second (non-negative) as uint8 codes of a per-block
log-scale codebook (254 levels over six decades below the block max, code 0 =
exact 0). Smaller leaves keep float32 moments.

A leaf is flattened in its own row-major order, so the block boundaries, and
with them every code and scale, match the JAX state of the same parameter
tree (the port keeps the JAX layout: stacked ``(L, in, out)`` block weights).

:meth:`AdamW8bit.fused_apply` is the whole update (Adam moments, decoupled
weight decay, learning rate, apply) for every leaf, IN PLACE: parameters and
state buffers are overwritten. A quantized leaf whose size divides by 256
goes to ``ops/fused_adamw8.py`` (the CUDA kernel on the card); the others take
:func:`_leaf_plain`. The step count lives on the host as a Python int, so the
bias corrections need no device sync, and a learning-rate schedule is read
there too: ``learning_rate(count)`` with the count of updates already applied.

``adam_8bit`` is the coupled-L2 variant (``torch.optim.Adam`` semantics: the
decay joins the gradient before the moments). With ``weight_decay=0`` it is
the same update as AdamW and takes the same kernel; with a decay it runs
leaf by leaf in plain PyTorch, since the kernel's decay is decoupled.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 256
MIN_QUANT_SIZE = 4096
_LOG_DECADES = 6.0
_LOG_LEVELS = 254.0


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division on every device (PyTorch's CUDA division by a
    Python scalar multiplies by the reciprocal instead)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).float()
    return F.pad(flat, (0, _pad_len(flat.numel()) - flat.numel())).view(-1, BLOCK)


def quantize_blockwise(x: torch.Tensor):
    """float array -> (int8 codes (NB, 256), float32 scales (NB, 1))."""
    blocks = _blocks(x)
    scale = _div(blocks.abs().amax(dim=1, keepdim=True), 127.0)
    safe = torch.where(scale == 0, 1.0, scale)
    codes = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return (codes.float() * scale).reshape(-1)[:n].reshape(shape)


def quantize_log_blockwise(x: torch.Tensor):
    """Non-negative float array -> (uint8 codes (NB, 256), float32 scales (NB, 1))."""
    blocks = _blocks(x)
    scale = blocks.amax(dim=1, keepdim=True)
    safe = torch.where(scale == 0, 1.0, scale)
    r = torch.clamp(blocks / safe, 0.0, 1.0)
    logr = torch.log10(torch.clamp(r, min=10.0 ** (-_LOG_DECADES)))
    codes = 1.0 + torch.round(_div(logr + _LOG_DECADES, _LOG_DECADES) * _LOG_LEVELS)
    codes = torch.where(r == 0, 0.0, codes).to(torch.uint8)
    return codes, scale


def dequantize_log_blockwise(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    q = codes.float()
    r = torch.pow(10.0, _div(q - 1.0, _LOG_LEVELS) * _LOG_DECADES - _LOG_DECADES)
    n = int(np.prod(shape))
    return (torch.where(q == 0, 0.0, r) * scale).reshape(-1)[:n].reshape(shape)


class QMoment(NamedTuple):
    codes: torch.Tensor  # (NB, 256) int8 (first moment) or uint8 (second)
    scale: torch.Tensor  # (NB, 1) float32


Moment = Union[QMoment, torch.Tensor]


@dataclasses.dataclass
class Adam8bitState:
    """``count`` is the number of updates applied; ``mu``/``nu`` hold one
    entry per parameter leaf, in the leaf order the optimizer was built with:
    a :class:`QMoment` or, below ``MIN_QUANT_SIZE``, a float32 tensor."""

    count: int
    mu: List[Moment]
    nu: List[Moment]


def _zero_moment(p: torch.Tensor, log: bool) -> Moment:
    if p.numel() < MIN_QUANT_SIZE:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    nb = _pad_len(p.numel()) // BLOCK
    codes = torch.zeros((nb, BLOCK), dtype=torch.uint8 if log else torch.int8,
                        device=p.device)
    return QMoment(codes, torch.zeros((nb, 1), dtype=torch.float32, device=p.device))


class AdamW8bit:
    """Blockwise 8-bit AdamW (decoupled weight decay) over a list of leaves;
    with ``decoupled=False`` 8-bit Adam with coupled L2."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, decoupled: bool = True):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.decoupled = decoupled

    def lr(self, count: int) -> float:
        """The learning rate of the update that follows ``count`` updates."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: Sequence[torch.Tensor]) -> Adam8bitState:
        return Adam8bitState(
            0,
            [_zero_moment(p, log=False) for p in params],
            [_zero_moment(p, log=True) for p in params],
        )

    def _leaf_plain(self, p, g, mu, nu, lr, c1, c2, g_scale):
        b1, b2 = self.b1, self.b2
        g32 = g.float() * g_scale
        coupled = not self.decoupled and self.weight_decay != 0.0
        if coupled:
            g32 = g32 + self.weight_decay * p
        mu = b1 * mu + (1.0 - b1) * g32
        nu = b2 * nu + (1.0 - b2) * g32 * g32
        upd = _div(mu, c1) / (torch.sqrt(_div(nu, c2)) + self.eps)
        if coupled:
            return p - lr * upd, mu, nu
        return p - lr * (upd + self.weight_decay * p), mu, nu

    @torch.no_grad()
    def fused_apply(self, grads: Sequence[torch.Tensor], state: Adam8bitState,
                    params: Sequence[torch.Tensor],
                    g_scale: Optional[torch.Tensor] = None) -> Adam8bitState:
        """Update ``params`` and the state buffers in place with
        ``grads * g_scale``; returns the state with its count advanced."""
        from whisper_finetune_torch.ops.fused_adamw8 import fused_adamw8_leaf

        count = state.count + 1
        f32 = np.float32
        c1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        c2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        lr = float(f32(self.lr(state.count)))
        kernel_ok = self.decoupled or self.weight_decay == 0.0
        gs = (torch.ones((), dtype=torch.float32, device=params[0].device)
              if g_scale is None else g_scale.float())
        for i, (p, g) in enumerate(zip(params, grads)):
            mu_s, nu_s = state.mu[i], state.nu[i]
            quantized = isinstance(mu_s, QMoment)
            if kernel_ok and quantized and p.numel() % BLOCK == 0:
                fused_adamw8_leaf(
                    p.view(-1, BLOCK), g.contiguous().view(-1, BLOCK),
                    mu_s.codes, mu_s.scale, nu_s.codes, nu_s.scale,
                    lr, c1, c2, gs, b1=self.b1, b2=self.b2, eps=self.eps,
                    wd=self.weight_decay,
                )
                continue
            mu0 = dequantize_blockwise(*mu_s, p.shape) if quantized else mu_s
            nu0 = dequantize_log_blockwise(*nu_s, p.shape) if quantized else nu_s
            p_new, mu, nu = self._leaf_plain(p, g, mu0, nu0, lr, c1, c2, gs)
            p.copy_(p_new)
            if quantized:
                for dst, src in zip(mu_s + nu_s,
                                    quantize_blockwise(mu) + quantize_log_blockwise(nu)):
                    dst.copy_(src)
            else:
                mu_s.copy_(mu)
                nu_s.copy_(nu)
        return Adam8bitState(count, state.mu, state.nu)


def adamw_8bit(learning_rate, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, weight_decay: float = 1e-2) -> AdamW8bit:
    return AdamW8bit(learning_rate, b1, b2, eps, weight_decay)


def adam_8bit(learning_rate, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.0) -> AdamW8bit:
    return AdamW8bit(learning_rate, b1, b2, eps, weight_decay, decoupled=False)
