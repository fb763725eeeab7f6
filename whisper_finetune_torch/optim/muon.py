"""Muon, the port of ``whisper_finetune_tpu/optim/muon.py``.

* Nesterov momentum on each hidden matrix,
* Newton-Schulz orthogonalization of the update: batched ``torch.matmul`` in
  bf16 (library matmuls, as the JAX package leaves them to XLA),
* the shape correction ``sqrt(max(1, rows/cols))``,
* optional RMS matching: effective lr scaled by ``factor * sqrt(cols)``,
* decoupled weight decay ``lr * wd * p``.

Rows and cols are ``shape[-2], shape[-1]`` of the port's (in, out) kernels,
the JAX package's layout, so both scales are the reference's numbers with
matching on and off.

Transformer blocks are stacked on a leading layer axis, so one leaf holds all
L layers' matrices and one batched Newton-Schulz serves them. Across
processes (``shard_axis_size`` ranks of the data-parallel group, without
ZeRO) each rank orthogonalises its row slice of the layer axis and one
all-gather (``parallel.all_gather_rows``) rebuilds the whole leaf's update,
as the JAX package shards it over its data axis; a leaf whose layer count
does not divide stays whole on every rank.

:meth:`Muon.fused_apply` is the whole update for every leaf, IN PLACE:
parameters and momentum buffers are overwritten leaf by leaf, so only one
leaf's (or, past ``chunk_temp_mb``, one layer-axis slice's) float32
temporaries are live. The step count lives on the host; the learning rate is
``learning_rate(count)`` where it is a schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import torch

from whisper_finetune_torch import parallel
from whisper_finetune_torch.optim.quantized import (
    BLOCK,
    MIN_QUANT_SIZE,
    Moment,
    QMoment,
    dequantize_blockwise,
    quantize_blockwise,
)

# Quintic Newton-Schulz coefficients of the public Muon recipe, repeated
# every iteration.
_NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5

# Per-iteration greedy-minimax quintic schedule ("polar express" style): the
# JAX package's table (derived there by tools/derive_ns_schedule.py).
_PE_SCHEDULE = (
    (5.3671448113, -15.2922309232, 10.9057949056),
    (4.1577402765, -7.1124594575, 3.0569510747),
    (4.1071607176, -6.8699050053, 2.9332526953),
    (3.8987663420, -5.9290606752, 2.4575469723),
    (2.8015437046, -3.0300700692, 1.1251543513),
    (1.8932735009, -1.2956875927, 0.3923299763),
    (1.8748218094, -1.2747593096, 0.3900388892),
)


def _ns_coeff_table(steps: int, coeffs: str) -> torch.Tensor:
    """(steps, 3) float32 coefficients a, b, c per iteration."""
    if coeffs == "classic":
        return torch.tensor([_NS_COEFFS] * steps, dtype=torch.float32).reshape(steps, 3)
    if coeffs == "polar_express":
        if steps > len(_PE_SCHEDULE):
            raise ValueError(
                f"polar_express schedule supports at most {len(_PE_SCHEDULE)} "
                f"iterations, got ns_steps={steps}"
            )
        return torch.tensor(_PE_SCHEDULE[:steps], dtype=torch.float32).reshape(steps, 3)
    raise ValueError(f"unknown ns_coeffs {coeffs!r} (classic | polar_express)")


def newton_schulz_orthogonalize(g: torch.Tensor, steps: int = NS_STEPS, eps: float = 1e-7,
                                coeffs: str = "classic") -> torch.Tensor:
    """Approximately orthogonalize the last two axes of ``g`` (the
    semi-orthogonal factor of its polar decomposition); leading axes are
    batched. bf16 throughout, every product and every scaled term rounded to
    bf16 as in the JAX package (the coefficients too)."""
    # bf16-rounded coefficients as Python floats: x * float runs in float32
    # and rounds once, which is the bf16 product exactly.
    table = _ns_coeff_table(steps, coeffs).to(torch.bfloat16).float().tolist()
    transpose = g.shape[-2] > g.shape[-1]
    x = g.transpose(-2, -1) if transpose else g
    x = x.to(torch.bfloat16)
    norm = torch.sqrt(torch.sum(x.float() ** 2, dim=(-2, -1), keepdim=True))
    x = (x.float() / (norm + eps)).to(torch.bfloat16)
    for a, b, c in table:
        xxt = torch.matmul(x, x.transpose(-2, -1))
        bxx = b * xxt + c * torch.matmul(xxt, xxt)
        x = a * x + torch.matmul(bxx, x)
    x = x.transpose(-2, -1) if transpose else x
    return x.to(g.dtype)


def muon_shape_scale(shape) -> float:
    """Muon's built-in update scaling ``sqrt(max(1, A/B))`` for a per-matrix
    shape (A = rows, B = cols)."""
    rows, cols = shape[-2], shape[-1]
    return max(1.0, rows / cols) ** 0.5


def rms_match_scale(shape, factor: float = 0.2) -> float:
    """The RMS-matching multiplier ``factor * sqrt(B)``: with the shape scale
    it makes the update ``factor * sqrt(max(A, B))`` when absorbed into the
    group lr."""
    if len(shape) < 2:
        raise ValueError("Muon RMS matching requires parameters with ndim >= 2.")
    return float(factor) * (float(shape[-1]) ** 0.5)


@dataclasses.dataclass
class MuonState:
    """``count`` updates applied; one momentum entry per leaf: a float32 or
    bf16 tensor, or a :class:`QMoment` (int8 codes + float32 block scales)."""

    count: int
    momentum: List[Moment]


class Muon:
    """Muon over a list of matrix leaves: each a stack of matrices (L, A, B)
    (``stacked=True``, the block layout) or a plain matrix (A, B). The update
    of a leaf is ``-lr_eff * (O * shape_scale) - lr * wd * p`` with
    ``lr_eff = lr * rms_scale`` when RMS matching is on.

    ``momentum_dtype``: None keeps float32 momentum, ``"bfloat16"`` stores it
    half-width, ``"int8"`` blockwise-quantized (256-element blocks, float32
    absmax scales; leaves below ``MIN_QUANT_SIZE`` stay float32).

    ``chunk_temp_mb`` bounds the float32 working set of one leaf's update: a
    stacked leaf whose whole-leaf float32 temporaries would exceed it is
    processed in slices of the layer axis. Numerics are unchanged: a slice is
    whole 256-element blocks, so its codes and scales are the whole leaf's.
    """

    def __init__(
        self,
        learning_rate: Union[float, Callable[[int], float]],
        momentum: float = 0.95,
        weight_decay: float = 0.0,
        nesterov: bool = True,
        ns_steps: int = NS_STEPS,
        ns_coeffs: str = "classic",
        match_adamw_update_rms: bool = True,
        match_factor: float = 0.2,
        stacked: bool = True,
        shard_axis: Optional[str] = None,
        shard_axis_size: int = 1,
        momentum_dtype: Optional[str] = None,
        chunk_temp_mb: Optional[float] = 128.0,
    ):
        _ns_coeff_table(ns_steps, ns_coeffs)  # validates both
        self.shard_n = shard_axis_size if shard_axis is not None else 1
        self.learning_rate = learning_rate
        self.momentum, self.weight_decay, self.nesterov = momentum, weight_decay, nesterov
        self.ns_steps, self.ns_coeffs = ns_steps, ns_coeffs
        self.match, self.match_factor, self.stacked = match_adamw_update_rms, match_factor, stacked
        self.use_q = momentum_dtype in ("int8", "int8_blockwise")
        self.store_dt = (getattr(torch, momentum_dtype)
                         if momentum_dtype and not self.use_q else None)
        self.chunk_temp_mb = chunk_temp_mb

    def lr(self, count: int) -> float:
        """The learning rate of the update that follows ``count`` updates."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def _matrix_shape(self, leaf: torch.Tensor):
        return tuple(leaf.shape[1:] if self.stacked and leaf.dim() >= 3 else leaf.shape)

    def init(self, params: Sequence[torch.Tensor]) -> MuonState:
        def zero(p):
            if self.use_q and p.numel() >= MIN_QUANT_SIZE:
                nb = (p.numel() + BLOCK - 1) // BLOCK
                return QMoment(torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
                               torch.zeros((nb, 1), dtype=torch.float32, device=p.device))
            return torch.zeros(p.shape, dtype=self.store_dt or p.dtype, device=p.device)

        return MuonState(0, [zero(p) for p in params])

    def _sharded(self, g: torch.Tensor) -> bool:
        """Whether this leaf's Newton-Schulz splits over the ranks."""
        return self.shard_n > 1 and g.dim() >= 3 and g.shape[0] % self.shard_n == 0

    def _layers_per_chunk(self, g: torch.Tensor, shape) -> Optional[int]:
        if self.chunk_temp_mb is None or not self.stacked or g.dim() < 3 or self._sharded(g):
            return None
        max_elems = int(self.chunk_temp_mb * 1e6 / 4)
        per_layer = 1
        for d in shape:
            per_layer *= d
        if g.shape[0] * per_layer <= max_elems or per_layer % BLOCK:
            return None
        n = max(1, min(g.shape[0], max_elems // per_layer))
        while g.shape[0] % n:
            n -= 1
        return n if n < g.shape[0] else None

    def _leaf(self, g, m_s: Moment, p, shape, lr: float, g_scale) -> None:
        """float32 momentum + Newton-Schulz + update of one leaf (or one
        layer-axis slice of it), written into ``p`` and ``m_s``."""
        g = g.float()
        if g_scale is not None:
            g = g * g_scale
        m_prev = (dequantize_blockwise(m_s.codes, m_s.scale, g.shape)
                  if isinstance(m_s, QMoment) else m_s.to(g.dtype))
        m = self.momentum * m_prev + g
        upd = g + self.momentum * m if self.nesterov else m
        if self._sharded(upd):
            local = parallel.shard_rows(upd, self.shard_n)
            o = parallel.all_gather_rows(
                newton_schulz_orthogonalize(local, steps=self.ns_steps, coeffs=self.ns_coeffs))
        else:
            o = newton_schulz_orthogonalize(upd, steps=self.ns_steps, coeffs=self.ns_coeffs)
        eff_lr = lr * (rms_match_scale(shape, self.match_factor) if self.match else 1.0)
        p.add_(-(eff_lr * muon_shape_scale(shape)) * o - (lr * self.weight_decay) * p)
        if isinstance(m_s, QMoment):
            codes, scale = quantize_blockwise(m)
            m_s.codes.copy_(codes)
            m_s.scale.copy_(scale)
        else:
            m_s.copy_(m)

    @torch.no_grad()
    def fused_apply(self, grads: Sequence[torch.Tensor], state: MuonState,
                    params: Sequence[torch.Tensor],
                    g_scale: Optional[torch.Tensor] = None) -> MuonState:
        """Update ``params`` and the momentum buffers in place with
        ``grads * g_scale`` (gradients in any float dtype; they are upcast
        per leaf or slice); returns the state with its count advanced."""
        if self.shard_n > 1 and parallel.world() != self.shard_n:
            raise RuntimeError(f"Muon is sharded over {self.shard_n} ranks but the "
                               f"process group has {parallel.world()}")
        lr = self.lr(state.count)
        for g, m_s, p in zip(grads, state.momentum, params):
            shape = self._matrix_shape(g)
            n = self._layers_per_chunk(g, shape)
            if n is None:
                self._leaf(g, m_s, p, shape, lr, g_scale)
                continue
            quantized = isinstance(m_s, QMoment)
            nb = m_s.codes.shape[0] // (g.shape[0] // n) if quantized else 0
            for c, i in enumerate(range(0, g.shape[0], n)):
                m_c = (QMoment(m_s.codes[c * nb:(c + 1) * nb], m_s.scale[c * nb:(c + 1) * nb])
                       if quantized else m_s[i:i + n])
                self._leaf(g[i:i + n], m_c, p[i:i + n], shape, lr, g_scale)
        return MuonState(state.count + 1, state.momentum)


def scale_by_muon(learning_rate, **kwargs) -> Muon:
    """The JAX package's factory name for :class:`Muon`."""
    return Muon(learning_rate, **kwargs)
