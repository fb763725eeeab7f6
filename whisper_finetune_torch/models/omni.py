"""Uni-MoE-2.0-Omni's speech-to-text path: the Whisper large-v3 audio tower
feeding a 28-layer language model whose every MLP is a dynamic mixture of
fixed, routed and null experts (HIT-TMG, ``config.json`` at
huggingface.co/HIT-TMG/Uni-MoE-2.0-Omni). The vision tower and the speech
generator are not on this path and are not built.

Equations (positions 0 .. T-1; every norm and softmax in float32, products
in the compute dtype with float32 accumulation):

* **Audio.** mel (128 x 3000) -> ``encoder_forward`` (the Whisper tower,
  unchanged) -> (1500, 1280) -> adaptive average pool over time to
  (200, 1280) (PyTorch's bins) -> ``W_p h + b_p`` -> (200, 3584).
* **Sequence.** ``embed(pre ids) ++ audio ++ embed(post ids)``; the audio
  rows stand where the prompt holds :data:`AUDIO_ID`.
* **Block.** ``h = x + Attn(RMSNorm(x))``; ``y = h + MoE(RMSNorm(h))``, with
  ``RMSNorm(x) = x * rsqrt(mean(x^2) + 1e-6) * g``.
* **Attention.** ``q = W_q x + b_q`` (28 x 128), ``k = W_k x + b_k`` and
  ``v = W_v x + b_v`` (4 x 128); rotary positions on q and k in rotate-half
  form with ``inv_freq_i = 1e6^(-2i/128)`` (the three M-RoPE sections carry
  one index a position here, which is plain 1-D RoPE); K/V head ``j`` serves
  query heads ``7j .. 7j+6``; causal ``softmax(q k^T / sqrt(128)) v``;
  ``W_o`` without bias.
* **MoE.** ``z = W_r x`` in float32 over 5 logits (dynamic experts 0-3, the
  null expert 4), ``p = softmax(z)``. The experts ordered by ``p``,
  descending, ties to the lower index; the selection ``S`` is the shortest
  prefix whose sum reaches ``top_p`` (0.7), at most ``top_k`` (2).
  ``MoE(x) = F_1(x) + F_2(x) + sum_{e in S, e < 4} p_e E_e(x)``: the fixed
  experts with weight 1, the selected dynamic experts with their
  probabilities (not renormalised), the null expert adding 0. ``F`` and
  ``E`` are ``W_down(silu(W_gate x) * W_up x)`` without biases.
* **Head.** The final RMSNorm, then the untied head 3584 -> 152064.

Dispatch. A pass over many tokens (the prefill, a full forward) groups the
tokens by expert (one sort by ``nonzero`` over the expert-major selection)
and runs each dynamic expert over its own tokens only; the counts come to
the host once a layer. The cached token step runs at fixed shapes, inside a
CUDA graph on a card (``decoding.py``): each dynamic expert runs over every
row and the rows that did not select it are weighted 0. That costs
operations, and bytes only where no row selects an expert: a deployment's
32 rows select all four, but rows that route alike (random weights do) leave
some of the experts the step reads unselected.

Parameters are held in the compute dtype (bf16), the norm gains and the
router in float32 (a bf16 checkpoint's values, upcast). Linear kernels are
stored (in, out) and the layers' leaves stacked on a leading layer axis, as
in the Whisper tree; the tower's tree has the Whisper encoder's keys.

Counters (read by the benchmark and the tests; the decoder adds them up
once a call, after its token loop): ``moe.routes`` and ``moe.prefill_routes``
(selections by expert, the null expert last, over every position and over
the prefill's), ``moe.tokens_routed`` ((token, layer) pairs routed),
``moe.experts_touched`` and ``moe.layer_steps`` (dynamic experts selected by
any row, summed over the token steps' layers, and those layers), and
``lm_block.blocks_run``. ``moe.record``, where a list, gets each call's
selections, (rows, layers, positions, experts) bool on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from whisper_finetune_torch.models.dims import MODEL_PRESETS, ModelDimensions
from whisper_finetune_torch.models.whisper import (
    ForwardConfig,
    Params,
    _dense,
    _set,
    _Tree,
    encoder_forward,
    flatten,
)
from whisper_finetune_torch.runtime import span

NEG_INF = float("-inf")
AUDIO_ID = -1  # where a prompt holds the audio rows


@dataclasses.dataclass(frozen=True)
class OmniDimensions:
    """The speech-to-text path's sizes: the tower's Whisper dimensions (its
    encoder fields are read) and the language model's."""

    tower: ModelDimensions
    d_model: int
    n_layer: int
    n_head: int
    n_kv_head: int
    head_dim: int
    rope_theta: float
    rms_eps: float
    n_vocab: int
    n_fixed: int
    fixed_width: int
    n_dynamic: int
    dynamic_width: int
    n_null: int
    top_p: float
    top_k: int
    audio_tokens: int
    eot: int

    @property
    def n_mels(self) -> int:
        return self.tower.n_mels

    @property
    def n_route(self) -> int:
        """The router's outputs: the dynamic experts, then the null ones."""
        return self.n_dynamic + self.n_null

    def to_dict(self) -> Dict:
        out = dataclasses.asdict(self)
        out["tower"] = self.tower.to_dict()
        return out

    @classmethod
    def from_dict(cls, d: Dict) -> "OmniDimensions":
        fields = {f.name for f in dataclasses.fields(cls)} - {"tower"}
        kw = {k: v for k, v in d.items() if k in fields}
        return cls(tower=ModelDimensions.from_dict(d["tower"]), **kw)

    def replace(self, **kwargs) -> "OmniDimensions":
        return dataclasses.replace(self, **kwargs)


OMNI_PRESETS: Dict[str, OmniDimensions] = {
    "uni-moe-2.0-omni": OmniDimensions(
        tower=MODEL_PRESETS["large-v3"], d_model=3584, n_layer=28, n_head=28, n_kv_head=4,
        head_dim=128, rope_theta=1e6, rms_eps=1e-6, n_vocab=152064, n_fixed=2,
        fixed_width=2368, n_dynamic=4, dynamic_width=18944, n_null=1, top_p=0.7, top_k=2,
        audio_tokens=200, eot=151645),
}

# The prompt around the audio when the caller gives none: Qwen2's chat
# markers (``<|im_start|>user\n`` before, ``<|im_end|>\n<|im_start|>assistant``
# after). The model's own template and tokenizer are not in the repository,
# so these ids are an assumption.
DEFAULT_PROMPT: Tuple[Tuple[int, ...], Tuple[int, ...]] = ((151644, 872, 198, 151646),
                                                           (151645, 198, 151644, 77091))


def is_omni(dims) -> bool:
    return isinstance(dims, OmniDimensions)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

FLOAT32_LEAVES = ("attn_norm", "mlp_norm", "norm", "router")


def leaf_shapes(dims: OmniDimensions) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(path, shape) of every language-model and adapter leaf (the tower's
    are the Whisper encoder's), in sorted-key order."""
    L, d, D = dims.n_layer, dims.d_model, dims.head_dim
    hq, hkv = dims.n_head * D, dims.n_kv_head * D
    nf, ff, ne, fe = dims.n_fixed, dims.fixed_width, dims.n_dynamic, dims.dynamic_width
    shapes = [
        (("adapter", "b"), (d,)),
        (("adapter", "w"), (dims.tower.n_audio_state, d)),
        (("lm", "blocks", "attn", "k_b"), (L, hkv)),
        (("lm", "blocks", "attn", "k_w"), (L, d, hkv)),
        (("lm", "blocks", "attn", "o_w"), (L, hq, d)),
        (("lm", "blocks", "attn", "q_b"), (L, hq)),
        (("lm", "blocks", "attn", "q_w"), (L, d, hq)),
        (("lm", "blocks", "attn", "v_b"), (L, hkv)),
        (("lm", "blocks", "attn", "v_w"), (L, d, hkv)),
        (("lm", "blocks", "attn_norm"), (L, d)),
        (("lm", "blocks", "experts", "down"), (L, ne, fe, d)),
        (("lm", "blocks", "experts", "gate"), (L, ne, d, fe)),
        (("lm", "blocks", "experts", "up"), (L, ne, d, fe)),
        (("lm", "blocks", "fixed", "down"), (L, nf, ff, d)),
        (("lm", "blocks", "fixed", "gate"), (L, nf, d, ff)),
        (("lm", "blocks", "fixed", "up"), (L, nf, d, ff)),
        (("lm", "blocks", "mlp_norm"), (L, d)),
        (("lm", "blocks", "router"), (L, d, dims.n_route)),
        (("lm", "embed"), (dims.n_vocab, d)),
        (("lm", "head"), (d, dims.n_vocab)),
        (("lm", "norm"), (d,)),
    ]
    return sorted(shapes)


def leaf_dtype(path: Tuple[str, ...], dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf is held in: float32 for the norm gains and the
    router, ``dtype`` otherwise."""
    return torch.float32 if path[0] == "lm" and path[-1] in FLOAT32_LEAVES else dtype


def init_params(dims: OmniDimensions, device="cpu", seed: int = 0,
                dtype: torch.dtype = torch.bfloat16) -> "OmniModel":
    """Random weights (``torch.nn.Linear``'s uniform law, gains at 1, the
    embedding N(0, 0.02^2), the tower as ``whisper.init_params`` draws it),
    one layer at a time, held as :func:`leaf_dtype` says."""
    from whisper_finetune_torch.models.whisper import init_params as whisper_init

    dev = torch.device(device)
    tree: Params = {}
    tower = whisper_init(dims.tower, device=dev, seed=seed).params()["encoder"]
    for path, a in flatten(tower):
        _set(tree, ("encoder",) + path, a.detach().to(dtype))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) + 1)
    for path, shape in leaf_shapes(dims):
        out = torch.empty(shape, dtype=leaf_dtype(path, dtype), device=dev)
        for view in out.unbind(0) if path[1] == "blocks" else [out]:
            if path[-1] in ("attn_norm", "mlp_norm", "norm"):
                view.fill_(1.0)
            elif path[-1] == "embed":
                view.copy_(torch.empty(view.shape, device=dev).normal_(0.0, 0.02, generator=gen))
            else:  # kernels (in, out) and biases: U(+-1/sqrt(fan_in))
                fan_in = view.shape[-2] if view.dim() >= 2 else (
                    dims.tower.n_audio_state if path[0] == "adapter" else dims.d_model)
                bound = fan_in ** -0.5
                view.copy_(torch.empty(view.shape, device=dev).uniform_(-bound, bound,
                                                                        generator=gen))
        _set(tree, path, out)
    return OmniModel(dims, tree)


class OmniModel(nn.Module):
    """The speech-to-text path's parameter tree: ``encoder`` (the tower),
    ``adapter``, ``lm``."""

    def __init__(self, dims: OmniDimensions, params: Params):
        super().__init__()
        self.dims = dims
        self.tree = _Tree(params)

    def params(self) -> Params:
        return self.tree.as_dict()

    def leaves(self) -> List[Tuple[Tuple[str, ...], nn.Parameter]]:
        return flatten(self.params())


def save_checkpoint(path: str, model: OmniModel) -> None:
    """Write ``{"omni_dims", "params"}``: the dimensions and every leaf as
    held, under its dotted path."""
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"omni_dims": model.dims.to_dict(),
                "params": {".".join(p): a.detach().cpu() for p, a in model.leaves()}}, path)


def from_checkpoint(ckpt: Dict, device) -> Tuple[OmniModel, OmniDimensions]:
    """A loaded :func:`save_checkpoint` dict -> (model on ``device``, dims)."""
    dims = OmniDimensions.from_dict(ckpt["omni_dims"])
    want = {p for p, _ in leaf_shapes(dims)}
    tree: Params = {}
    for key, a in ckpt["params"].items():
        _set(tree, tuple(key.split(".")), a.to(device))
    got = {p for p, _ in flatten(tree) if p[0] != "encoder"}
    if got != want:
        raise ValueError(f"checkpoint leaves differ from {dims}: {sorted(got ^ want)[:4]}")
    return OmniModel(dims, tree), dims


def layer_views(blocks: Params, n_layers: int) -> List[Params]:
    """Per-layer dicts of the stacked block leaves, as they lie (no cast)."""
    layers: List[Params] = [{} for _ in range(n_layers)]
    for path, a in flatten(blocks):
        for i, view in enumerate(a.unbind(0)):
            _set(layers[i], path, view)
    return layers


# ---------------------------------------------------------------------------
# The pieces of a block
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * g`` in float32, cast back to x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps) * g.float()
    return y.to(x.dtype)


def rope_tables(dims: OmniDimensions, n_pos: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (n_pos, head_dim) float32, rotate-half layout."""
    D = dims.head_dim
    inv = 1.0 / (float(dims.rope_theta) ** (np.arange(0, D, 2, dtype=np.float64) / D))
    ang = np.arange(n_pos, dtype=np.float64)[:, None] * inv[None, :]
    ang = np.concatenate([ang, ang], axis=1)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, D) rotated at the T positions of cos / sin (T, D), in
    float32, cast back."""
    x32 = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos + rot * sin).to(x.dtype)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """q (B, H, Tq, D), k and v (B, Hkv, Tk, D) -> (B, H, Tq, D): query head
    ``h`` reads K/V head ``h // (H / Hkv)``. A K/V head's query heads ride
    the query axis (G * Tq rows), so both products are batched over
    (B, Hkv) and no K/V is repeated or broadcast. Scores in the compute
    dtype with float32 accumulation, scaled by D^-0.5 and masked (``mask``
    (Tq, Tk) or (Tk,), added) in float32, softmax in float32,
    probabilities cast back."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = H // Hkv
    s = torch.matmul(q.reshape(B, Hkv, G * Tq, D), k.transpose(-1, -2)).float()
    s = s.view(B, Hkv, G, Tq, Tk) * (D ** -0.5) + mask
    w = torch.softmax(s, dim=-1).to(v.dtype).view(B, Hkv, G * Tq, Tk)
    return torch.matmul(w, v).view(B, H, Tq, D)


def _attention(h: torch.Tensor, p: Params, dims: OmniDimensions, cos, sin,
               write: Callable, mask: torch.Tensor) -> torch.Tensor:
    """The attention of one block over h (B, T, d) at the T positions of
    cos / sin. ``write(k, v)`` stores this pass's keys and values (B, Hkv, T,
    D) and returns the ones to attend over."""
    B, T, _ = h.shape
    H, Hkv, D = dims.n_head, dims.n_kv_head, dims.head_dim
    dtype = h.dtype
    q = _dense(h, p["q_w"], p["q_b"], dtype).view(B, T, H, D).transpose(1, 2)
    k = _dense(h, p["k_w"], p["k_b"], dtype).view(B, T, Hkv, D).transpose(1, 2)
    v = _dense(h, p["v_w"], p["v_b"], dtype).view(B, T, Hkv, D).transpose(1, 2)
    k_all, v_all = write(apply_rope(k, cos, sin), v)
    o = gqa_attention(apply_rope(q, cos, sin), k_all, v_all, mask)
    return _dense(o.transpose(1, 2).reshape(B, T, H * D), p["o_w"], None, dtype)


def route(z: torch.Tensor, top_p: float, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits z (N, E) float32 -> (probabilities (N, E), selection
    (N, E) bool): the experts in order of probability, descending, ties to
    the lower index; an expert is taken while the sum of those before it is
    below ``top_p`` and fewer than ``top_k`` are taken."""
    p = torch.softmax(z, dim=-1)
    sp, order = torch.sort(p, dim=-1, descending=True, stable=True)
    before = torch.cumsum(sp, dim=-1) - sp
    rank = torch.arange(p.shape[-1], device=p.device)
    take = (before < top_p) & (rank < top_k)
    return p, torch.zeros_like(take).scatter(-1, order, take)


def _swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor) -> torch.Tensor:
    """Experts stacked on a leading axis: x (E, N, d), gate and up (E, d, f),
    down (E, f, d) -> (E, N, d)."""
    return torch.bmm(F.silu(torch.bmm(x, gate)) * torch.bmm(x, up), down)


def fixed_experts(x: torch.Tensor, p: Params) -> torch.Tensor:
    """The fixed experts' sum over x (N, d), float32 (N, d)."""
    n = p["gate"].shape[0]
    return _swiglu(x.expand(n, *x.shape), p["gate"], p["up"], p["down"]).float().sum(0)


def _dynamic_grouped(x: torch.Tensor, p: Params, sel: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Each dynamic expert over the tokens that selected it: the token ids
    sorted by expert (``nonzero`` over the expert-major selection), gathered,
    run, weighted and added back in float32. sel and w (N, E)."""
    N, d = x.shape
    counts = sel.sum(0).tolist()  # the one wait of the layer
    pairs = sel.t().nonzero()  # (P, 2): expert, token; by expert, then token
    tok = pairs[:, 1]
    xs = x.index_select(0, tok)
    ws = w[tok, pairs[:, 0]]
    out = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    start = 0
    for e, c in enumerate(counts):
        if c == 0:
            continue
        rows = slice(start, start + c)
        y = _swiglu(xs[None, rows], p["gate"][e:e + 1], p["up"][e:e + 1], p["down"][e:e + 1])[0]
        out.index_add_(0, tok[rows], y.float() * ws[rows, None])
        start += c
    return out


def _dynamic_dense(x: torch.Tensor, p: Params, w: torch.Tensor) -> torch.Tensor:
    """Every dynamic expert over every row, weighted by w (N, E), 0 where a
    row did not select it: fixed shapes, for the captured token step."""
    y = _swiglu(x.expand(w.shape[1], *x.shape), p["gate"], p["up"], p["down"])
    return (y.float() * w.t()[:, :, None]).sum(0)


def moe(x: torch.Tensor, bp: Params, dims: OmniDimensions,
        grouped: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dynamic mixture over x (N, d), normed: (output (N, d) in x's
    dtype, selection (N, n_route) bool). ``grouped`` dispatches the tokens by
    expert; otherwise every expert runs over every row, masked."""
    E = dims.n_dynamic
    with span("wft.moe"):
        with span("wft.moe.route"):
            p, sel = route(torch.mm(x.float(), bp["router"].float()), dims.top_p, dims.top_k)
            w = torch.where(sel[:, :E], p[:, :E], 0.0)
        y = fixed_experts(x, bp["fixed"])
        if grouped:
            y = y + _dynamic_grouped(x, bp["experts"], sel[:, :E], w)
        else:
            y = y + _dynamic_dense(x, bp["experts"], w)
        return y.to(x.dtype), sel


def lm_block(x: torch.Tensor, bp: Params, dims: OmniDimensions, cos, sin, write: Callable,
             mask: torch.Tensor, grouped: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over x (B, T, d): (output, selection (B * T, n_route))."""
    with span("wft.lm_block"):
        h = rms_norm(x, bp["attn_norm"], dims.rms_eps)
        with span("wft.attn"):
            x = x + _attention(h, bp["attn"], dims, cos, sin, write, mask)
        B, T, d = x.shape
        y, sel = moe(rms_norm(x, bp["mlp_norm"], dims.rms_eps).view(B * T, d), bp, dims,
                     grouped)
        return x + y.view(B, T, d), sel


def head(lm: Params, x: torch.Tensor, dims: OmniDimensions) -> torch.Tensor:
    """Final norm and the untied head: float32 logits (..., n_vocab)."""
    x = rms_norm(x, lm["norm"], dims.rms_eps)
    return torch.matmul(x, lm["head"].to(x.dtype)).float()


def _causal(T: int, device) -> torch.Tensor:
    return torch.full((T, T), NEG_INF, device=device).triu(1)


def encode_audio(params: Params, mel: torch.Tensor, dims: OmniDimensions,
                 fcfg: ForwardConfig) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> the audio rows (B, audio_tokens, d) in the
    compute dtype: the tower, the pool and the projector."""
    xa = encoder_forward(params, mel, dims.tower, fcfg)
    with span("wft.omni.adapter"):
        pooled = F.adaptive_avg_pool1d(xa.transpose(1, 2), dims.audio_tokens).transpose(1, 2)
        ad = params["adapter"]
        return _dense(pooled, ad["w"], ad["b"], fcfg.dtype)


def embed_prompt(lm: Params, ids: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """ids (B, T) with :data:`AUDIO_ID` at the audio rows -> (B, T, d): the
    embeddings, the audio rows (B, A, d) in their places, in order."""
    x = F.embedding(ids.clamp(min=0), lm["embed"]).to(audio.dtype)
    return x.masked_scatter((ids == AUDIO_ID)[..., None], audio)


@torch.no_grad()
def forward(params: Params, mel: torch.Tensor, ids: torch.Tensor, dims: OmniDimensions,
            fcfg: ForwardConfig = ForwardConfig()) -> torch.Tensor:
    """The full forward, no cache: (mel, ids with the audio rows marked) ->
    float32 logits (B, T, n_vocab)."""
    lm = params["lm"]
    x = embed_prompt(lm, ids, encode_audio(params, mel, dims, fcfg))
    T = x.shape[1]
    cos, sin = rope_tables(dims, T, x.device)
    mask = _causal(T, x.device)
    for bp in layer_views(lm["blocks"], dims.n_layer):
        x = lm_block(x, bp, dims, cos, sin, lambda k, v: (k, v), mask)[0]
        lm_block.blocks_run += 1
    return head(lm, x, dims)


lm_block.blocks_run = 0
moe.routes = []
moe.prefill_routes = []
moe.tokens_routed = 0
moe.experts_touched = 0
moe.layer_steps = 0
moe.record = None


# ---------------------------------------------------------------------------
# The cached decoder
# ---------------------------------------------------------------------------

class OmniDecoder:
    """The language model's cached decoding for ``n`` rows over the resident
    parameters: per-call state only (K/V caches (L, n, Hkv, max_len, D) in
    the compute dtype, the position, a (1,) long tensor, and the selections
    of every layer and position). :meth:`prefill` runs the prompt with its
    audio rows in one pass; :meth:`step` one position for all rows, at fixed
    shapes (:meth:`blocks` is what a graph captures). ``decoding`` drives it
    through the interface its Whisper decoder shares: :meth:`encode`,
    :meth:`graph_key`, :meth:`eager`, :data:`PROMPT_STEPS`, :meth:`finish`."""

    # The prompt runs as one prefill pass, not as token steps.
    PROMPT_STEPS = False
    encode = staticmethod(encode_audio)

    @staticmethod
    def graph_key(params: Params, dims: OmniDimensions, dtype: torch.dtype, audio: torch.Tensor,
                  max_len: int):
        """What a held graph depends on: the shapes, and the addresses of the
        parameters it reads where they lie."""
        return (dims, dtype, audio.shape[0], max_len,
                tuple(a.data_ptr() for _, a in flatten(params["lm"])))

    @classmethod
    def eager(cls, params: Params, dims: OmniDimensions, dtype: torch.dtype,
              audio: torch.Tensor, max_len: int) -> "OmniDecoder":
        return cls(params, dims, dtype, audio.shape[0], max_len, audio.device).load(params, audio)

    def __init__(self, params: Params, dims: OmniDimensions, dtype: torch.dtype, n: int,
                 max_len: int, device):
        L, Hkv, D = dims.n_layer, dims.n_kv_head, dims.head_dim
        self.dims, self.dtype, self.max_len, self.n = dims, dtype, max_len, n
        self.lm = params["lm"]
        self.layers = layer_views(self.lm["blocks"], L)
        self.cache_k = torch.zeros((L, n, Hkv, max_len, D), dtype=dtype, device=device)
        self.cache_v = torch.zeros_like(self.cache_k)
        self.window = torch.arange(max_len, device=device)
        self.pos = torch.zeros((1,), dtype=torch.long, device=device)
        self.cos, self.sin = rope_tables(dims, max_len, device)
        self.sel_log = torch.zeros((L, max_len, n, dims.n_route), dtype=torch.uint8,
                                   device=device)
        self.audio: Optional[torch.Tensor] = None
        self.t0 = 0

    def load(self, params: Params, audio: torch.Tensor) -> "OmniDecoder":
        """One call's audio rows (n, A, d); emptied caches and selections.
        ``params`` hold the tensors the decoder was made over (it reads
        them where they lie), as ``decoding``'s key of a held decoder makes
        sure."""
        self.audio = audio
        self.cache_k.zero_()
        self.cache_v.zero_()
        self.sel_log.zero_()
        return self

    def prefill(self, initial_tokens: torch.Tensor) -> torch.Tensor:
        """The prompt (n, T0), its audio rows marked, in one pass: fills the
        caches' first T0 positions; the last position's logits (n, V)."""
        n, T0 = initial_tokens.shape
        dims = self.dims
        self.t0 = T0
        x = embed_prompt(self.lm, initial_tokens, self.audio)
        cos, sin = self.cos[:T0], self.sin[:T0]
        mask = _causal(T0, x.device)
        for i, bp in enumerate(self.layers):

            def write(k, v, i=i):
                self.cache_k[i, :, :, :T0] = k
                self.cache_v[i, :, :, :T0] = v
                return k, v

            x, sel = lm_block(x, bp, dims, cos, sin, write, mask)
            self.sel_log[i, :T0] = sel.view(n, T0, -1).transpose(0, 1)
        return head(self.lm, x[:, -1], dims)

    def embed(self, token: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.embedding(token, self.lm["embed"]).to(self.dtype)
        return x if out is None else out.copy_(x)

    def blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The layers and the head over x (n, d) at the position -> float32
        logits (n, V); writes the position's keys, values and selections."""
        dims = self.dims
        n = x.shape[0]
        mask = torch.where(self.window <= self.pos, 0.0, NEG_INF).to(torch.float32)
        cos, sin = self.cos.index_select(0, self.pos), self.sin.index_select(0, self.pos)
        x = x[:, None]
        for i, bp in enumerate(self.layers):

            def write(k, v, i=i):
                self.cache_k[i].index_copy_(2, self.pos, k)
                self.cache_v[i].index_copy_(2, self.pos, v)
                return self.cache_k[i], self.cache_v[i]

            x, sel = lm_block(x, bp, dims, cos, sin, write, mask, grouped=False)
            self.sel_log[i].index_copy_(0, self.pos, sel.to(torch.uint8).view(1, n, -1))
        return head(self.lm, x[:, 0], dims)

    def step(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        self.pos.fill_(pos)
        return self.blocks(self.embed(token))

    def finish(self, steps: int) -> None:
        """Ends a call of ``steps`` token steps (replayed or not): the
        selections come to the host once and the counters add them up."""
        lm_block.blocks_run += self.dims.n_layer * (1 + steps)
        count_routes(self.sel_log[:, : self.t0 + steps].cpu().bool(), self.t0,
                     self.dims.n_dynamic)
        self.audio = None


def _add(total: List[int], counts: torch.Tensor) -> List[int]:
    counts = [int(c) for c in counts.tolist()]
    return [a + c for a, c in zip(total + [0] * (len(counts) - len(total)), counts)]


def count_routes(sel: torch.Tensor, t0: int, n_dynamic: int) -> None:
    """Adds a call's selections (L, T, n, n_route) bool, the first ``t0``
    positions the prefill's, to :func:`moe`'s counters (and record)."""
    moe.routes = _add(moe.routes, sel.sum((0, 1, 2)))
    moe.prefill_routes = _add(moe.prefill_routes, sel[:, :t0].sum((0, 1, 2)))
    moe.tokens_routed += sel.shape[0] * sel.shape[1] * sel.shape[2]
    steps = sel[:, t0:, :, :n_dynamic]
    moe.experts_touched += int(steps.any(2).sum())
    moe.layer_steps += steps.shape[0] * steps.shape[1]
    if moe.record is not None:
        moe.record.append(sel.permute(2, 0, 1, 3).contiguous())
