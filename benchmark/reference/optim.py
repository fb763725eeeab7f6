"""The reference's optimizer updates and learning-rate schedules, plain
PyTorch over lists of float32 leaves.

* Warm-up then linear or cosine decay, a multiplier of the base rate read
  from the count of updates already applied (0 at the first update).
* AdamW with float32 moments, decoupled weight decay.
* Muon on the hidden matrices (those of the encoder's and decoder's blocks
  with two or more dimensions a layer): Nesterov momentum, five quintic
  Newton-Schulz iterations (3.4445, -4.7750, 2.0315) on the last two axes
  of the normalised update, the shape scale sqrt(max(1, rows / cols)), the
  AdamW-RMS matching that scales the rate by 0.2 * sqrt(cols), decoupled
  weight decay ``lr * wd * p``. The iterations run in the reference's
  precision (float32 here), where the published recipe runs them in bf16.
* The blockwise 8-bit AdamW: both moments of a leaf of 4096 elements or more
  kept in 256-element blocks, the first as int8 codes over absmax / 127, the
  second as uint8 codes of a log-scale codebook (254 levels over six
  decades below the block maximum, code 0 for an exact 0), re-quantised
  after every update; a plain copy of the algorithm's arithmetic.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Sequence

import torch
import torch.nn.functional as F

from benchmark.reference.whisper import Precision

NS_COEFFS = (3.4445, -4.7750, 2.0315)
BLOCK, MIN_QUANT, DECADES, LEVELS = 256, 4096, 6.0, 254.0


def schedule(conf: Mapping, horizon: int, count: int) -> float:
    warm = int(conf.get("warmup_steps", 0))
    if count < warm:
        return count / max(1.0, float(warm))
    span = max(1.0, float(horizon - warm))
    if conf["type"] == "linear":
        return max(0.0, (horizon - count) / span)
    if conf["type"] == "cosine":
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * (count - warm) / span)))
    raise ValueError(f"schedule {conf['type']!r} is not in the reference")


def is_muon_leaf(path: Sequence[str], leaf: torch.Tensor, threshold: int = 2) -> bool:
    return "blocks" in path and leaf.dim() - 1 >= threshold


def newton_schulz(g: torch.Tensor, pr: Precision, steps: int = 5) -> torch.Tensor:
    a, b, c = NS_COEFFS
    tr = g.shape[-2] > g.shape[-1]
    x = g.transpose(-2, -1) if tr else g
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + 1e-7)
    for _ in range(steps):
        xxt = pr.mm(x, x.transpose(-2, -1))
        x = a * x + pr.mm(b * xxt + c * pr.mm(xxt, xxt), x)
    return x.transpose(-2, -1) if tr else x


class AdamW:
    def __init__(self, leaves, lr, betas, eps, wd):
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, wd
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    def apply(self, leaves, grads, factor: float) -> None:
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        lr = self.lr * factor
        for p, g, m, v in zip(leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps) + self.wd * p))


class Muon:
    def __init__(self, leaves, lr, momentum, wd, pr: Precision, factor=0.2):
        self.lr, self.mom, self.wd, self.pr, self.factor = lr, momentum, wd, pr, factor
        self.buf = [torch.zeros_like(p) for p in leaves]

    def apply(self, leaves, grads, factor: float) -> None:
        lr = self.lr * factor
        for p, g, buf in zip(leaves, grads, self.buf):
            buf.mul_(self.mom).add_(g)
            upd = g + self.mom * buf
            rows, cols = p.shape[-2], p.shape[-1]
            scale = lr * self.factor * math.sqrt(cols) * math.sqrt(max(1.0, rows / cols))
            p.sub_(scale * newton_schulz(upd, self.pr) + lr * self.wd * p)


def _blocks(x):
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % BLOCK)).view(-1, BLOCK)


def _unblock(b, like):
    return b.reshape(-1)[: like.numel()].view(like.shape)


class AdamW8bit:
    """The blockwise 8-bit AdamW; leaves under ``MIN_QUANT`` elements keep
    float32 moments."""

    def __init__(self, leaves, lr, betas, eps, wd):
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, wd
        self.count = 0
        self.state = []
        for p in leaves:
            if p.numel() >= MIN_QUANT:
                nb = -(-p.numel() // BLOCK)
                z = torch.zeros((nb, 1), dtype=torch.float32, device=p.device)
                self.state.append([torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device), z,
                                   torch.zeros((nb, BLOCK), dtype=torch.uint8, device=p.device),
                                   z.clone()])
            else:
                self.state.append([torch.zeros_like(p), torch.zeros_like(p)])

    @staticmethod
    def _decode_v(codes, scale):
        q = codes.float()
        r = torch.pow(10.0, (q - 1.0) / LEVELS * DECADES - DECADES)
        return torch.where(q == 0, 0.0, r) * scale

    @staticmethod
    def _encode(m, v):
        ms = m.abs().amax(dim=1, keepdim=True) / 127.0
        mc = torch.clamp(torch.round(m / torch.where(ms == 0, 1.0, ms)), -127, 127).to(torch.int8)
        vs = v.amax(dim=1, keepdim=True)
        r = torch.clamp(v / torch.where(vs == 0, 1.0, vs), 0.0, 1.0)
        lr_ = torch.log10(torch.clamp(r, min=10.0 ** -DECADES))
        vc = 1.0 + torch.round((lr_ + DECADES) / DECADES * LEVELS)
        return mc, ms, torch.where(r == 0, 0.0, vc).to(torch.uint8), vs

    def first_moment(self, i: int, like: torch.Tensor) -> torch.Tensor:
        st = self.state[i]
        if len(st) == 2:
            return st[0]
        return _unblock(st[0].float() * st[1], like)

    def apply(self, leaves, grads, factor: float) -> None:
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        lr = self.lr * factor
        for p, g, st in zip(leaves, grads, self.state):
            if len(st) == 2:
                m, v = st
                m.mul_(self.b1).add_(g, alpha=1 - self.b1)
                v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                p.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps) + self.wd * p))
                continue
            gb = _blocks(g)
            m = self.b1 * (st[0].float() * st[1]) + (1 - self.b1) * gb
            v = self.b2 * self._decode_v(st[2], st[3]) + (1 - self.b2) * gb * gb
            upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.sub_(lr * (_unblock(upd, p) + self.wd * p))
            for dst, src in zip(st, self._encode(m, v)):
                dst.copy_(src)


def build(recipe: Mapping, named: List, horizon: int, pr: Precision):
    """The recipe's optimizer over ``named`` (path, leaf) pairs: an object
    with ``apply(grads, count)`` updating the leaves in place."""
    opt = recipe["optimizer"]
    p = opt.get("params", {}) or {}
    betas = tuple(float(b) for b in p.get("betas", (0.9, 0.999)))
    eps = float(p.get("eps", 1e-8))
    sched = recipe["lr_scheduler"]
    leaves = [leaf for _, leaf in named]
    if opt.get("muon"):
        mp = opt.get("muon_params", {}) or {}
        is_m = [is_muon_leaf(path, leaf, int(opt.get("muon_ndim_threshold", 2)))
                for path, leaf in named]
        m_idx = [i for i, f in enumerate(is_m) if f]
        a_idx = [i for i, f in enumerate(is_m) if not f]
        muon = Muon([leaves[i] for i in m_idx], float(mp.get("lr", 0.02)),
                    float(mp.get("momentum", 0.95)),
                    float(mp.get("weight_decay", p.get("weight_decay", 0.0))), pr)
        aux = AdamW([leaves[i] for i in a_idx], float(p.get("lr", 3e-4)), betas, eps,
                    float(p.get("weight_decay", 0.0)))
        return _MuonAux(muon, aux, m_idx, a_idx, leaves, sched, horizon)
    cls = AdamW8bit if opt.get("8bit") else AdamW
    inner = cls(leaves, float(p.get("lr", 1e-3)), betas, eps, float(p.get("weight_decay", 0.01)))
    return _Single(inner, leaves, sched, horizon)


class _Single:
    def __init__(self, inner, leaves, sched, horizon):
        self.inner, self.leaves, self.sched, self.horizon = inner, leaves, sched, horizon

    def apply(self, grads, count: int) -> None:
        self.inner.apply(self.leaves, grads, schedule(self.sched, self.horizon, count))


class _MuonAux:
    def __init__(self, muon, aux, m_idx, a_idx, leaves, sched, horizon):
        self.muon, self.aux, self.m_idx, self.a_idx = muon, aux, m_idx, a_idx
        self.leaves, self.sched, self.horizon = leaves, sched, horizon

    def apply(self, grads, count: int) -> None:
        f = schedule(self.sched, self.horizon, count)
        self.muon.apply([self.leaves[i] for i in self.m_idx], [grads[i] for i in self.m_idx], f)
        self.aux.apply([self.leaves[i] for i in self.a_idx], [grads[i] for i in self.a_idx], f)
