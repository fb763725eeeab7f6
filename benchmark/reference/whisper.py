"""Plain Whisper (OpenAI's published architecture) over a nested dict of
weights in the benchmark's layout, for the reference.

Every product runs through a :class:`Precision`: ``float32`` (the
reference: full float32, TF32 off, which the caller makes sure of with
:func:`no_tf32`) or ``fp8`` (the control: each operand of every product
rounded to float8 e4m3 with a per-tensor scale, products in float32).
Layer norms, softmax and GELU run in float32 either way.

A training forward takes the random numbers of stochastic depth and deep
SpecAugment as arrays (one coin a layer; a gate; (width, start) draws a
layer for the time and feature masks): a layer runs where its coin is not
below the drop rate and its output is then ``x + (block(x) - x) / keep``;
deep SpecAugment multiplies an encoder layer's first layer-norm output by
its time and feature keep masks, on every layer but the last, when the gate
is below ``p``. Blocks run under ``torch.utils.checkpoint`` when asked, so
that a large batch fits in float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


class Precision:
    """How products are computed: ``float32`` or ``fp8`` operands."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x as an operand: float32, or rounded to e4m3 under a per-tensor
        scale (its gradient passes straight through the rounding)."""
        x = x.float()
        if self.name == "float32":
            return x
        with torch.no_grad():
            scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
            rounded = (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


@contextlib.contextmanager
def no_tf32():
    """Full float32 products and convolutions on the card for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32))


def _ln(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], 1e-5)


def _lin(x, w, b, pr: Precision):
    y = pr.mm(x, w)
    return y if b is None else y + b


def _mha(x, kv, p, n_head: int, pr: Precision, causal: bool = False):
    B, T, d = x.shape
    S = kv.shape[1]
    D = d // n_head
    q = _lin(x, p["q_w"], p["q_b"], pr).view(B, T, n_head, D).transpose(1, 2)
    k = _lin(kv, p["k_w"], None, pr).view(B, S, n_head, D).transpose(1, 2)
    v = _lin(kv, p["v_w"], p["v_b"], pr).view(B, S, n_head, D).transpose(1, 2)
    s = pr.mm(q, k.transpose(-1, -2)) / math.sqrt(D)
    if causal:
        s = s.masked_fill(torch.ones(T, S, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
    o = pr.mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, T, d)
    return _lin(o, p["o_w"], p["o_b"], pr)


def _mlp(x, p, pr: Precision):
    return _lin(F.gelu(_lin(x, p["fc1_w"], p["fc1_b"], pr)), p["fc2_w"], p["fc2_b"], pr)


def _enc_block(x, bp, n_head, pr, time_keep=None, feat_keep=None):
    h = _ln(x, bp["attn_ln"])
    if time_keep is not None:
        h = h * time_keep[None, :, None] * feat_keep[None, None, :]
    x = x + _mha(h, h, bp["attn"], n_head, pr)
    return x + _mlp(_ln(x, bp["mlp_ln"]), bp["mlp"], pr)


def _dec_block(x, bp, xa, n_head, pr):
    h = _ln(x, bp["attn_ln"])
    x = x + _mha(h, h, bp["attn"], n_head, pr, causal=True)
    x = x + _mha(_ln(x, bp["cross_attn_ln"]), xa, bp["cross_attn"], n_head, pr)
    return x + _mlp(_ln(x, bp["mlp_ln"]), bp["mlp"], pr)


def _layer(blocks: Mapping, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, Mapping) else v[i] for k, v in blocks.items()}


def _axis_keep(draws: np.ndarray, size: int, param: int) -> np.ndarray:
    draws = np.asarray(draws, np.float32)
    width = draws[:, :1] * np.float32(param)
    start = draws[:, 1:2] * (np.float32(size) - width)
    idx = np.arange(size, dtype=np.float32)[None, :]
    return np.where((idx >= start) & (idx < start + width), 0.0, 1.0).astype(np.float32)


class Draws:
    """A training forward's random numbers (see the module docstring); None
    fields where a feature is off."""

    def __init__(self, enc_coin, dec_coin, dsa_gate, dsa_time, dsa_feat):
        self.enc_coin, self.dec_coin = np.asarray(enc_coin), np.asarray(dec_coin)
        self.dsa_gate = float(dsa_gate)
        self.dsa_time, self.dsa_feat = np.asarray(dsa_time), np.asarray(dsa_feat)


def _run(fn, remat: bool, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(w: Mapping, mel: torch.Tensor, dims: Mapping, pr: Precision,
           draws: Optional[Draws] = None, train: Optional[Mapping] = None,
           remat: bool = False) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> (B, 1500, d). ``train``: the recipe's
    ``stochastic_depth`` and deep SpecAugment (``dsa``: apply, p,
    time_mask_param, freq_mask_param)."""
    enc = w["encoder"]
    L, H = int(dims["n_audio_layer"]), int(dims["n_audio_head"])
    x = F.gelu(F.conv1d(pr.q(mel), pr.q(enc["conv1"]["w"].permute(2, 1, 0)),
                        padding=1) + enc["conv1"]["b"][:, None])
    x = F.gelu(F.conv1d(pr.q(x), pr.q(enc["conv2"]["w"].permute(2, 1, 0)),
                        stride=2, padding=1) + enc["conv2"]["b"][:, None])
    x = x.transpose(1, 2) + sinusoids(x.shape[-1], x.shape[1]).to(x.device)
    sd = float(train["stochastic_depth"]) if train and draws is not None else 0.0
    dsa = train.get("dsa") if train and draws is not None else None
    dsa_on = bool(dsa and dsa["apply"] and draws.dsa_gate < np.float32(dsa["p"]))
    if dsa_on:
        tk = torch.from_numpy(_axis_keep(draws.dsa_time, x.shape[1], dsa["time_mask_param"]))
        fk = torch.from_numpy(_axis_keep(draws.dsa_feat, x.shape[2], dsa["freq_mask_param"]))
        tk, fk = tk.to(x.device), fk.to(x.device)
    for i in range(L):
        if sd > 0.0 and draws.enc_coin[i] < np.float32(sd):
            continue
        masks = (tk[i], fk[i]) if dsa_on and i < L - 1 else (None, None)
        y = _run(_enc_block, remat, x, _layer(enc["blocks"], i), H, pr, *masks)
        x = y if sd == 0.0 else x + (y - x) / (1.0 - sd)
    return _ln(x, enc["ln_post"])


def decode(w: Mapping, tokens: torch.Tensor, xa: torch.Tensor, dims: Mapping,
           pr: Precision, draws: Optional[Draws] = None, train: Optional[Mapping] = None,
           remat: bool = False) -> torch.Tensor:
    """tokens (B, T) -> float32 logits (B, T, n_vocab)."""
    dec = w["decoder"]
    L, H = int(dims["n_text_layer"]), int(dims["n_text_head"])
    x = dec["tok_emb"][tokens] + dec["pos_emb"][: tokens.shape[1]]
    sd = float(train["stochastic_depth"]) if train and draws is not None else 0.0
    for i in range(L):
        if sd > 0.0 and draws.dec_coin[i] < np.float32(sd):
            continue
        y = _run(_dec_block, remat, x, _layer(dec["blocks"], i), xa, H, pr)
        x = y if sd == 0.0 else x + (y - x) / (1.0 - sd)
    return pr.mm(_ln(x, dec["ln"]), dec["tok_emb"].t())


def forward(w: Mapping, mel: torch.Tensor, tokens: torch.Tensor, dims: Mapping,
            pr: Precision, draws: Optional[Draws] = None, train: Optional[Mapping] = None,
            remat: bool = False) -> torch.Tensor:
    xa = encode(w, mel, dims, pr, draws, train, remat)
    return decode(w, tokens, xa, dims, pr, draws, train, remat)
