"""Plain Uni-MoE-2.0-Omni speech-to-text (HIT-TMG, ``config.json`` at
huggingface.co/HIT-TMG/Uni-MoE-2.0-Omni) in float32, for the reference: the
whole forward over the full sequence, with no cache, no graph and no
batching of experts, one layer's weights at a time (each drawn again from
the seed by ``benchmark/omni_weights.py``, bf16-rounded and upcast). It
imports nothing of the program. Every product runs through a
:class:`~benchmark.reference.whisper.Precision` (float32 with TF32 off:
:func:`read_rows` sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False; or the fp8 control).

Equations (positions 0 .. T-1):

* audio: the clip's log-mel (``reference/audio.py``) -> the Whisper tower
  (``reference/whisper.py::encode``) -> (1500, 1280) -> adaptive average
  pool over time to (200, 1280), PyTorch's bins -> ``W_p h + b_p``;
* sequence: ``embed(pre) ++ audio ++ embed(post ++ served)``;
* block: ``h = x + Attn(RMSNorm(x))``, ``y = h + MoE(RMSNorm(h))``,
  ``RMSNorm(x) = x rsqrt(mean(x^2) + eps) g``;
* attention: ``q = W_q x + b_q`` (28 heads of 128), ``k``, ``v`` likewise
  (4 heads); rotary positions in rotate-half form, ``inv_freq_i =
  theta^(-2i/128)``; each K/V head repeated for its 7 query heads; causal
  ``softmax(q k^T / sqrt(128)) v``; ``W_o`` without bias;
* MoE: ``p = softmax(W_r x)`` over the 4 dynamic experts and the null one;
  ordered by ``p`` descending, ties to the lower index; the shortest prefix
  reaching 0.7, at most 2; ``F_1(x) + F_2(x) + sum_{e in S, e < 4} p_e
  E_e(x)``, each ``W_down(silu(W_gate x) * W_up x)``;
* head: the final RMSNorm and the untied head.

Departures from the published model, each an assumption the configuration
file lists under ``assumed``: the selected experts weighted by their
probabilities, not renormalised; the fixed experts added with weight 1;
the 1,500 frames pooled to 200 tokens by adaptive average pooling before
the linear projector; one position index on all three M-RoPE sections
(plain 1-D RoPE); the end-of-text id 151645; the prompt ids synthetic.

**Forced selections.** Where a caller gives the program's selection at
every (layer, position), the reference compares it with its own: where they
differ and the reference's margin is at most ``delta`` (a near tie), the
reference takes the program's selection and counts a near tie; where they
differ by more, it keeps its own and counts a route flip. The margin of a
selection is the least of the distances at the cut from the prefix sums to
``top_p`` (each continue-or-stop decision made) and the gap between the
last selected and the first unselected probability.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.omni_weights import ReferenceLeaves
from benchmark.reference import audio
from benchmark.reference.whisper import Precision, encode, no_tf32

AUDIO_ID = -1
MARGIN_STEPS = (0.0, 1e-4, 1e-3, 1e-2, 3e-2, 1e-1)


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, h, T, D) rotated at positions 0 .. T-1."""
    T, D = x.shape[-2], x.shape[-1]
    inv = 1.0 / (float(theta) ** (np.arange(0, D, 2, dtype=np.float64) / D))
    ang = np.arange(T, dtype=np.float64)[:, None] * inv[None, :]
    ang = torch.from_numpy(np.concatenate([ang, ang], axis=1)).float().to(x.device)
    half = D // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def select(p: torch.Tensor, top_p: float, top_k: int):
    """p (N, E) -> (selection (N, E) bool, margin (N,) float64): the top-p
    rule capped at ``top_k``, ties to the lower index."""
    sp, order = torch.sort(p.double(), dim=-1, descending=True, stable=True)
    before = torch.cumsum(sp, dim=-1) - sp
    E = p.shape[-1]
    rank = torch.arange(E, device=p.device)
    take = (before < top_p) & (rank < top_k)
    m = take.sum(-1)  # experts taken, 1 .. top_k
    margin = torch.full(m.shape, float("inf"), dtype=torch.float64, device=p.device)
    for j in range(1, min(top_k, E)):  # the decision to take rank j, where it was made
        made = m >= j
        margin = torch.where(made, torch.minimum(margin, (before[:, j] - top_p).abs()), margin)
    last = sp.gather(1, (m - 1)[:, None])[:, 0]
    nxt = sp.gather(1, m.clamp(max=E - 1)[:, None])[:, 0]
    margin = torch.where(m < E, torch.minimum(margin, last - nxt), margin)
    return torch.zeros_like(take).scatter(-1, order, take), margin


class Routes:
    """What a forward's router did at every (row, layer, position): its own
    selection, its margin, and (with forced selections) the counts."""

    def __init__(self):
        self.own: List[torch.Tensor] = []  # a layer's (B, T, E) bool
        self.margin: List[torch.Tensor] = []  # a layer's (B, T) float64
        self.flips = 0
        self.near_ties = 0
        self.max_diff_margin = 0.0  # the largest margin where the selections differ
        self.diff_above = {t: 0 for t in MARGIN_STEPS}  # differing pairs by margin


def _swiglu(x, p: Mapping, pr: Precision) -> torch.Tensor:
    return pr.mm(F.silu(pr.mm(x, p["gate"])) * pr.mm(x, p["up"]), p["down"])


def moe(x: torch.Tensor, bp: Mapping, dims: Mapping, pr: Precision, routes: Routes,
        forced: Optional[torch.Tensor], valid: Optional[torch.Tensor], delta: float,
        shape) -> torch.Tensor:
    """x (N, d) normed -> (N, d). ``forced`` (N, E) bool or None, ``valid``
    (N,) bool: the positions where the forced selection is compared."""
    E = int(dims["n_dynamic"])
    p = torch.softmax(pr.mm(x, bp["router"]), dim=-1)
    sel, margin = select(p, float(dims["top_p"]), int(dims["top_k"]))
    routes.own.append(sel.view(*shape, -1).cpu())
    routes.margin.append(margin.view(*shape).cpu())
    if forced is not None:
        diff = (sel != forced).any(-1) & valid
        near = diff & (margin <= delta)
        routes.flips += int((diff & ~near).sum())
        routes.near_ties += int(near.sum())
        if bool(diff.any()):
            routes.max_diff_margin = max(routes.max_diff_margin, float(margin[diff].max()))
            for t in MARGIN_STEPS:
                routes.diff_above[t] += int((margin[diff] > t).sum())
        sel = torch.where(near[:, None], forced, sel)
    y = torch.zeros_like(x)
    for f in range(int(dims["n_fixed"])):
        y = y + _swiglu(x, {k: v[f] for k, v in bp["fixed"].items()}, pr)
    for e in range(E):
        tok = sel[:, e].nonzero()[:, 0]
        if tok.numel():
            out = _swiglu(x[tok], {k: v[e] for k, v in bp["experts"].items()}, pr)
            y = y.index_add(0, tok, out * p[tok, e, None])
    return y


def attention(x: torch.Tensor, p: Mapping, dims: Mapping, pr: Precision) -> torch.Tensor:
    B, T, d = x.shape
    H, Hkv, D = int(dims["n_head"]), int(dims["n_kv_head"]), int(dims["head_dim"])
    q = (pr.mm(x, p["q_w"]) + p["q_b"]).view(B, T, H, D).transpose(1, 2)
    k = (pr.mm(x, p["k_w"]) + p["k_b"]).view(B, T, Hkv, D).transpose(1, 2)
    v = (pr.mm(x, p["v_w"]) + p["v_b"]).view(B, T, Hkv, D).transpose(1, 2)
    q, k = rope(q, dims["rope_theta"]), rope(k, dims["rope_theta"])
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    s = pr.mm(q, k.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
    o = pr.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, T, H * D)
    return pr.mm(o, p["o_w"])


def audio_rows(leaves: ReferenceLeaves, mel: torch.Tensor, dims: Mapping,
               pr: Precision) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> (B, audio_tokens, d)."""
    xa = encode({"encoder": leaves.tree(("encoder",))}, mel, dims["tower"], pr)
    pooled = F.adaptive_avg_pool1d(xa.transpose(1, 2), int(dims["audio_tokens"])).transpose(1, 2)
    ad = leaves.tree(("adapter",))
    return pr.mm(pooled, ad["w"]) + ad["b"]


def forward(leaves: ReferenceLeaves, clips: torch.Tensor, ids: torch.Tensor, dims: Mapping,
            pr: Precision, out_from: int, forced: Optional[torch.Tensor] = None,
            valid: Optional[torch.Tensor] = None, delta: float = 0.0):
    """clips (B, 480000), ids (B, T) with ``AUDIO_ID`` at the audio rows ->
    (float32 logits (B, T - out_from, V) of positions ``out_from`` on,
    :class:`Routes`). ``forced`` (B, L, T, E) bool and ``valid`` (B, T)
    bool: the program's selections and where to compare them."""
    B, T = ids.shape
    d, eps = int(dims["d_model"]), float(dims["rms_eps"])
    mel = audio.log_mel(clips, int(dims["tower"]["n_mels"]))
    rows = audio_rows(leaves, mel, dims, pr)
    emb = leaves.get(("lm", "embed"))
    x = emb[ids.clamp(min=0)]
    del emb
    x[ids == AUDIO_ID] = rows.reshape(-1, d)
    routes = Routes()
    for layer in range(int(dims["n_layer"])):
        bp = leaves.tree(("lm", "blocks"), layer)
        x = x + attention(rms_norm(x, bp["attn_norm"], eps), bp["attn"], dims, pr)
        h = rms_norm(x, bp["mlp_norm"], eps).reshape(B * T, d)
        f = None if forced is None else forced[:, layer].reshape(B * T, -1)
        v = None if valid is None else valid.reshape(B * T)
        x = x + moe(h, bp, dims, pr, routes, f, v, delta, (B, T)).view(B, T, d)
        del bp, h
    x = rms_norm(x[:, out_from:], leaves.get(("lm", "norm")), eps)
    return pr.mm(x, leaves.get(("lm", "head"))), routes


def read_rows(leaves: ReferenceLeaves, rows: List[Dict], dims: Mapping, delta: float,
              control: bool = False) -> Dict:
    """``rows``: dicts with ``clip`` (480000,) on the device, ``prompt`` (the
    T0 ids with the audio marked), ``served`` ids, the program's
    ``mean_logprob`` of them and its ``selection`` (L, T0 + len(served), E)
    bool. Teacher-forced over prompt and served tokens: the widest gap of a
    served token's logit under the best (``logit_gap``), the widest
    difference of the mean log-probabilities (``logprob_gap``), the route
    flips past ``delta`` (``route_flips``), the near ties taken from the
    program (``near_ties``), the largest margin where the selections
    differ (``route_diff_margin``) and the differing pairs by margin
    (``route_diffs_above``, pairs whose margin exceeds each step). With
    ``control``, the fp8 control's gap of the tokens it puts first, its
    mean log-probability of the served tokens, and its own selections'
    flips against the reference's own."""
    dev = rows[0]["clip"].device
    T0 = len(rows[0]["prompt"])
    seqs = [list(r["prompt"]) + list(r["served"][:-1]) for r in rows]
    T = max(len(s) for s in seqs)
    ids = torch.tensor([s + [0] * (T - len(s)) for s in seqs], dtype=torch.long, device=dev)
    valid = torch.tensor([[t < len(s) for t in range(T)] for s in seqs], device=dev)
    forced = torch.stack([r["selection"][:, :T].to(dev) for r in rows])
    clips = torch.stack([r["clip"] for r in rows])
    out = {"tokens": sum(len(r["served"]) for r in rows)}
    with torch.no_grad(), no_tf32():
        logits, routes = forward(leaves, clips, ids, dims, Precision("float32"), T0 - 1,
                                 forced, valid, delta)
        gaps, lp_gaps = [], []
        for i, r in enumerate(rows):
            lg = logits[i, : len(r["served"])]
            tok = torch.tensor(r["served"], dtype=torch.long, device=dev)
            gaps.append(float((lg.amax(-1) - lg.gather(1, tok[:, None])[:, 0]).max()))
            lp_ref = float(torch.log_softmax(lg, -1).gather(1, tok[:, None]).mean())
            lp_gaps.append(abs(r["mean_logprob"] - lp_ref))
        out.update(logit_gap=max(gaps), logprob_gap=max(lp_gaps), route_flips=routes.flips,
                   near_ties=routes.near_ties, route_diff_margin=routes.max_diff_margin,
                   route_diffs_above={str(t): n for t, n in routes.diff_above.items()})
        if control:
            low, low_routes = forward(leaves, clips, ids, dims, Precision("fp8"), T0 - 1)
            c_gap, c_lp = 0.0, 0.0
            for i, r in enumerate(rows):
                lg, lc = logits[i, : len(r["served"])], low[i, : len(r["served"])]
                tok = torch.tensor(r["served"], dtype=torch.long, device=dev)
                pick = lc.argmax(-1)
                c_gap = max(c_gap, float((lg.amax(-1) - lg.gather(1, pick[:, None])[:, 0]).max()))
                lp_ref = float(torch.log_softmax(lg, -1).gather(1, tok[:, None]).mean())
                lp_low = float(torch.log_softmax(lc, -1).gather(1, tok[:, None]).mean())
                c_lp = max(c_lp, abs(lp_low - lp_ref))
            flips = 0
            for own, mar, low_own in zip(routes.own, routes.margin, low_routes.own):
                diff = (own != low_own).any(-1) & valid.cpu()
                flips += int((diff & (mar > delta)).sum())
            out.update(control_logit_gap=c_gap, control_logprob_gap=c_lp,
                       control_route_flips=flips)
    return out

