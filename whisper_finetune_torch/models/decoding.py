"""Autoregressive decoding with a KV cache, the port of
``whisper_finetune_tpu/models/decoding.py``: greedy, temperature sampling
and beam search, whisper's logit filters and its temperature fallback.

* The encoder runs once, under ``no_grad``, with the configuration's
  attention mix (``_eval_fcfg``): under ``attn_impl: auto`` on a card its
  self-attentions are ``attn_fwd`` launches. Every decoder layer's
  cross-attention K/V is computed once from its output.
* The token step is single-query and cached, in plain PyTorch (the JAX
  package runs it outside Pallas too). The self-attention cache holds every
  position up to ``max_len``, is written at ``pos`` and attended over the
  whole static window with the positions beyond ``pos`` masked, so every
  token step has the same shapes. JAX's cache is ``(L, N, max_len, d)``;
  here it is the same bytes head-major, ``(L, N, H, max_len, d / H)``, so
  that the single query's two products are batched matrix products that
  read the cache where it lies. Keys are stored scaled by ``d_head**-0.25``
  in the compute dtype, the value ``_single_query_attention`` scales them
  to at every use in JAX; the query is scaled the same way.
* The decoder's stacked matrices are cast to the compute dtype once a
  decode call, not once a token. The encoder pass casts each block's
  matrices at use (``precast_weights=False``), so that its transients stay
  one block's while a graphed decoder's buffers are held.
* On a card, greedy decoding replays the token step as one CUDA graph a
  position (:class:`_GraphedDecoder`): the layers and the head are captured
  once over the decoder's buffers, which each call writes its weights,
  cross K/V and emptied caches into, and which the device keeps for the
  next call of the same shape (:func:`release` lets them go). The
  embedding, the position, the filters, the choice of token and the
  bookkeeping run eagerly around each replay, and nothing in the token loop
  waits for the card. Beam search and the CPU run the same step eagerly. ``greedy_decode.graph_captures``, ``.graph_replays`` and
  ``.eager_steps`` count what ran.
* Uni-MoE-2.0-Omni's speech-to-text path (``dims`` an
  :class:`~whisper_finetune_torch.models.omni.OmniDimensions`) takes the
  same greedy loop: the tower and the adapter make the audio rows, one
  prefill pass runs the prompt with them, and :class:`omni.OmniDecoder`
  steps the language model. Its graph is captured over the resident
  parameters (52 GB would not fit twice): only the caches, the position and
  the selections are the call's. ``transcribe_batch`` gives its ids as
  text (the model's tokenizer is not in the repository).
* Finished rows freeze at ``eot``; ``avg_logprob`` counts accepted tokens.
* Beam search flattens the beams into the batch axis, reorders the caches
  with one ``index_select`` a step into a second preallocated buffer, and
  ranks by summed log-prob over the length penalty, returning
  ``sum / (len + 1)``.
* :func:`transcribe_batch` retries only the rows that fail whisper's
  thresholds, at the next temperature, in power-of-two buckets padded with
  the first failing row.

Temperature sampling draws Gumbel noise from an explicit
``torch.Generator`` (seeded with the rung's index by
:func:`transcribe_batch`, as JAX seeds ``PRNGKey(t_idx)``): reproducible for
a seed, not bit-equal to JAX's sampler. Temperature 0, greedy and beam, is
deterministic and holds to JAX's tokens.

Every function runs where the parameters live.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import warnings
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from whisper_finetune_torch.models import omni
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import (
    ForwardConfig,
    Params,
    _dense,
    _layer_views,
    _set,
    encoder_forward,
    flatten,
    layer_norm,
)
from whisper_finetune_torch.runtime import span

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# Logit filters (openai-whisper's SuppressTokens, SuppressBlank,
# ApplyTimestampRules)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeFilters:
    """The openai-whisper filter stack as constants.

    ``suppress``: ids at -inf at every step (non-speech symbols and the
    task / special tokens). ``blank``: ids at -inf at the first sampled
    position only (" " and eot). ``timestamp_rules``: ApplyTimestampRules
    (pairing, monotonicity, the initial window, the timestamp-probability
    override)."""

    suppress: Tuple[int, ...] = ()
    blank: Tuple[int, ...] = ()
    timestamp_rules: bool = False
    timestamp_begin: int = 0
    eot: int = 0
    max_initial_timestamp_index: Optional[int] = None

    def apply(self, logits: torch.Tensor, prev1: torch.Tensor, prev2: torch.Tensor,
              max_ts: torch.Tensor, n_sampled: int) -> torch.Tensor:
        """Filtered float32 logits (N, V). ``prev1`` / ``prev2`` (N,) are the
        last two sampled ids (meaningless until ``n_sampled``, the number of
        tokens sampled so far, reaches 1 / 2); ``max_ts`` (N,) the largest
        timestamp sampled so far (below ``timestamp_begin``: none)."""
        if self.suppress:
            logits = logits.index_fill(1, _ids(self.suppress, logits.device), NEG_INF)
        if self.blank and n_sampled == 0:
            logits = logits.index_fill(1, _ids(self.blank, logits.device), NEG_INF)
        if self.timestamp_rules:
            logits = self._timestamp_rules(logits, prev1, prev2, max_ts, n_sampled)
        return logits

    def _timestamp_rules(self, logits, prev1, prev2, max_ts, n_sampled: int):
        """ApplyTimestampRules as masks: timestamps pair up except right
        before eot (after a lone timestamp only a timestamp or eot, after a
        pair no timestamp); they do not decrease (below the last one masked,
        which under the pairing rules is the largest); the first sampled
        token is a timestamp within ``max_initial_timestamp_index`` of
        <|0.00|>; where the timestamps' total probability beats the best
        text token's, only timestamps remain."""
        tsb = self.timestamp_begin
        V = logits.shape[-1]
        ids = torch.arange(V, device=logits.device)
        is_ts = ids >= tsb
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        neg = torch.full((), NEG_INF, dtype=torch.float32, device=logits.device)

        last_was = (prev1 >= tsb) & (n_sampled >= 1)
        penult_was = (prev2 >= tsb) | (n_sampled < 2)
        sup_ts = last_was & penult_was  # a pair is complete: text next
        sup_text = last_was & ~penult_was  # a lone timestamp: timestamp or eot
        mask = torch.where(sup_ts[:, None] & is_ts[None, :], neg, zero)
        mask = mask + torch.where(sup_text[:, None] & (ids < self.eot)[None, :], neg, zero)

        have_ts = max_ts >= tsb
        ts_last = torch.where(sup_text, max_ts, max_ts + 1)
        mono = have_ts[:, None] & is_ts[None, :] & (ids[None, :] < ts_last[:, None])
        mask = mask + torch.where(mono, neg, zero)

        init_blocked = ~is_ts
        if self.max_initial_timestamp_index is not None:
            init_blocked = init_blocked | (ids > tsb + self.max_initial_timestamp_index)
        if n_sampled == 0:
            mask = mask + torch.where(init_blocked[None, :], neg, zero)
        logits = logits + mask

        logprobs = torch.log_softmax(logits.float(), dim=-1)
        ts_lp = torch.logsumexp(torch.where(is_ts[None, :], logprobs, neg), dim=-1)
        max_text_lp = torch.where(is_ts[None, :], neg, logprobs).amax(dim=-1)
        force_ts = ts_lp > max_text_lp
        return torch.where(force_ts[:, None] & ~is_ts[None, :], neg, logits)


@functools.lru_cache(maxsize=64)
def _ids(ids: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``ids`` as a long tensor on ``device``, made once for each tuple and
    device: the copy from the host waits for the card, which once a token
    step would make the host and the card take turns. Callers only read it."""
    return torch.tensor(ids, dtype=torch.long, device=device)


def default_filters(tokenizer, without_timestamps: bool = True, suppress_blank: bool = True,
                    suppress_tokens: bool = True,
                    max_initial_timestamp: Optional[float] = 1.0) -> DecodeFilters:
    """whisper's DecodingTask filter stack for ``tokenizer``
    (``_get_suppress_tokens`` and the initial-token defaults): non-speech
    symbols and task / special tokens always suppressed, blank at the first
    position, the timestamp rules unless ``without_timestamps``."""
    suppress: Tuple[int, ...] = ()
    if suppress_tokens:
        ids = set(tokenizer.non_speech_tokens)
        ids.update((tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
                    tokenizer.sot_prev, tokenizer.sot_lm))
        try:
            ids.add(tokenizer.no_speech)
        except KeyError:
            pass
        if not without_timestamps:
            ids.add(tokenizer.no_timestamps)  # ApplyTimestampRules pins it to -inf
        suppress = tuple(sorted(ids))
    blank: Tuple[int, ...] = ()
    if suppress_blank:
        blank = tuple(tokenizer.encode(" ")) + (tokenizer.eot,)
    max_init_idx = None
    if not without_timestamps and max_initial_timestamp is not None:
        max_init_idx = round(max_initial_timestamp / 0.02)
    return DecodeFilters(suppress=suppress, blank=blank,
                         timestamp_rules=not without_timestamps,
                         timestamp_begin=tokenizer.timestamp_begin, eot=tokenizer.eot,
                         max_initial_timestamp_index=max_init_idx)


# ---------------------------------------------------------------------------
# The cached decoder
# ---------------------------------------------------------------------------

def _eval_fcfg(fcfg: ForwardConfig) -> ForwardConfig:
    """The encoder pass's configuration: the compute dtype, LoRA's scale and
    the attention mix of ``fcfg``, no remat and no training features; each
    block casts its own matrices at use."""
    return ForwardConfig(
        compute_dtype=fcfg.compute_dtype, remat_encoder=False, remat_decoder=False,
        lora_scale=fcfg.lora_scale, attn_impl=fcfg.attn_impl,
        attn_impl_encoder=fcfg.attn_impl_encoder, attn_impl_decoder=fcfg.attn_impl_decoder,
        attn_impl_cross=fcfg.attn_impl_cross, precast_weights=False,
    )


def _qk_scale(dims: ModelDimensions) -> float:
    return float(dims.n_text_state // dims.n_text_head) ** -0.25


def _single_query_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
                            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (N, d), already scaled; k (N, H, S, D), already scaled, and v
    (N, H, S, D) -> (N, d). Scores in the compute dtype with float32
    accumulation, as ``xla_mha``; ``mask`` (S,) added in float32, softmax in
    float32, probabilities cast back."""
    N, d = q.shape
    qh = q.view(N, n_head, 1, d // n_head)
    scores = torch.matmul(qh, k.transpose(-1, -2)).float()  # (N, H, 1, S)
    if mask is not None:
        scores = scores + mask
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(w, v).view(N, d)


# The decoder block's leaves that the token step reads (the cross-attention's
# K/V projections only make the cross K/V, once a call).
_STEP_LEAVES = tuple(
    [(ln, k) for ln in ("attn_ln", "cross_attn_ln", "mlp_ln") for k in ("bias", "scale")]
    + [("attn", k) for k in ("k_w", "o_b", "o_w", "q_b", "q_w", "v_b", "v_w")]
    + [("cross_attn", k) for k in ("o_b", "o_w", "q_b", "q_w")]
    + [("mlp", k) for k in ("fc1_b", "fc1_w", "fc2_b", "fc2_w")])


class _Decoder:
    """The token step's state for ``n`` rows, in buffers of its own: every
    tensor :meth:`blocks` reads (the step's leaves, the stacked matrices in
    the compute dtype, the float32 tied head), the cross K/V of every layer,
    the self-attention caches and the position, a (1,) long tensor.
    :meth:`load` writes one call's values into them in place, so that a
    graph captured over :meth:`blocks` reads every later call's;
    :meth:`step` runs one position for all rows. The embeddings are the
    parameters' own, held from :meth:`load` on: only :meth:`embed` reads
    them."""

    # The prompt's positions are token steps (graph replays on a card).
    PROMPT_STEPS = True

    @staticmethod
    def encode(params: Params, mel: torch.Tensor, dims: ModelDimensions,
               fcfg: ForwardConfig) -> torch.Tensor:
        """The encoder's output (B, n_audio_ctx, d) in the compute dtype."""
        return encoder_forward(params, mel, dims, fcfg, train=False).to(fcfg.dtype)

    @staticmethod
    def graph_key(params: Params, dims: ModelDimensions, dtype: torch.dtype, xa: torch.Tensor,
                  max_len: int):
        """What a held graph's buffers depend on (each call copies its
        weights into them)."""
        return (dims, dtype, xa.shape[0], xa.shape[1], max_len)

    @classmethod
    def eager(cls, params: Params, dims: ModelDimensions, dtype: torch.dtype,
              xa: torch.Tensor, max_len: int) -> "_Decoder":
        return cls(dims, dtype, xa.shape[0], xa.shape[1], max_len, xa.device).load(params, xa)

    def __init__(self, dims: ModelDimensions, dtype: torch.dtype, n: int, n_ctx: int,
                 max_len: int, device):
        L, H = dims.n_text_layer, dims.n_text_head
        D = dims.n_text_state // H
        self.dims, self.dtype, self.max_len = dims, dtype, max_len
        self.scale = _qk_scale(dims)
        self.own: Optional[Dict[Tuple[str, ...], torch.Tensor]] = None  # at the first load
        self.tok_emb: Optional[torch.Tensor] = None
        self.pos_emb: Optional[torch.Tensor] = None
        self.cross_k = torch.empty((L, n, H, n_ctx, D), dtype=dtype, device=device)
        self.cross_v = torch.empty_like(self.cross_k)
        self.cache_k = torch.empty((L, n, H, max_len, D), dtype=dtype, device=device)
        self.cache_v = torch.empty_like(self.cache_k)
        self.window = torch.arange(max_len, device=device)
        self.pos = torch.zeros((1,), dtype=torch.long, device=device)

    def load(self, params: Params, xa: torch.Tensor) -> "_Decoder":
        """One call's weights from ``params`` (the matrices cast by
        ``copy_``), its cross K/V from the encoder's output ``xa`` (N, S, d),
        and empty caches."""
        dec, dtype = params["decoder"], self.dtype
        L, H = self.dims.n_text_layer, self.dims.n_text_head
        self.tok_emb, self.pos_emb = dec["tok_emb"].detach(), dec["pos_emb"].detach()
        weights: Params = {"ln": {k: v.detach() for k, v in dec["ln"].items()}}
        for path in _STEP_LEAVES:
            leaf = dec["blocks"]
            for k in path:
                leaf = leaf[k]
            _set(weights, ("blocks",) + path, leaf.detach())
        if self.own is None:
            self.own = {path: torch.empty_like(a, dtype=dtype if a.dim() >= 3 else a.dtype)
                        for path, a in flatten(weights)}
            # The tied head with bf16 weights and float32 products and sums:
            # (V, d) in the compute dtype, held upcast.
            self.own[("head",)] = torch.empty_like(self.tok_emb)
            tree: Params = {}
            for path, buf in self.own.items():
                _set(tree, path, buf)
            self.ln = tree["ln"]
            self.layers = _layer_views(tree["blocks"], L, dtype, precast=False)
            self.head_w = tree["head"].t()
        for path, a in flatten(weights):
            self.own[path].copy_(a)
        self.own[("head",)].copy_(self.tok_emb.to(dtype))
        N, S = xa.shape[0], xa.shape[1]
        D = self.dims.n_text_state // H
        ca = dec["blocks"]["cross_attn"]
        for i, (k_w, v_w, v_b) in enumerate(zip(ca["k_w"].unbind(0), ca["v_w"].unbind(0),
                                                 ca["v_b"].unbind(0))):
            k = torch.matmul(xa, k_w.to(dtype))
            self.cross_k[i] = (k * self.scale).view(N, S, H, D).transpose(1, 2)
            v = torch.matmul(xa, v_w.to(dtype)) + v_b.to(dtype)
            self.cross_v[i] = v.view(N, S, H, D).transpose(1, 2)
        self.cache_k.zero_()
        self.cache_v.zero_()
        return self

    def tile(self, k: int) -> None:
        """Each row repeated ``k`` times, contiguous per row (beams)."""
        self.cross_k = self.cross_k.repeat_interleave(k, dim=1)
        self.cross_v = self.cross_v.repeat_interleave(k, dim=1)
        self.cache_k = self.cache_k.repeat_interleave(k, dim=1)
        self.cache_v = self.cache_v.repeat_interleave(k, dim=1)
        self._spare = (torch.empty_like(self.cache_k), torch.empty_like(self.cache_v))

    def reorder(self, rows: torch.Tensor) -> None:
        """Self-attention caches gathered by ``rows`` (one ``index_select``
        each into the spare buffers, which then swap)."""
        sk, sv = self._spare
        torch.index_select(self.cache_k, 1, rows, out=sk)
        torch.index_select(self.cache_v, 1, rows, out=sv)
        self._spare = (self.cache_k, self.cache_v)
        self.cache_k, self.cache_v = sk, sv

    def embed(self, token: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The step's input: the embeddings of token (N,) and of the
        position, summed in float32 and cast to the compute dtype (into
        ``out``)."""
        x = self.tok_emb[token] + self.pos_emb[self.pos]
        return x.to(self.dtype) if out is None else out.copy_(x)

    def blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The layers and the tied head over x (N, d) at the position ->
        float32 logits (N, V); writes the position's keys and values into
        the caches."""
        dims, dtype = self.dims, self.dtype
        H = dims.n_text_head
        N = x.shape[0]
        D = dims.n_text_state // H
        mask = torch.where(self.window <= self.pos, 0.0, NEG_INF).to(torch.float32)
        for i, bp in enumerate(self.layers):
            sa = bp["attn"]
            x_ln = layer_norm(x, bp["attn_ln"])
            q = _dense(x_ln, sa["q_w"], sa["q_b"], dtype) * self.scale
            k = _dense(x_ln, sa["k_w"], None, dtype) * self.scale
            v = _dense(x_ln, sa["v_w"], sa["v_b"], dtype)
            self.cache_k[i].index_copy_(2, self.pos, k.view(N, H, 1, D))
            self.cache_v[i].index_copy_(2, self.pos, v.view(N, H, 1, D))
            a = _single_query_attention(q, self.cache_k[i], self.cache_v[i], H, mask)
            x = x + _dense(a, sa["o_w"], sa["o_b"], dtype)

            ca = bp["cross_attn"]
            xc = layer_norm(x, bp["cross_attn_ln"])
            qc = _dense(xc, ca["q_w"], ca["q_b"], dtype) * self.scale
            a = _single_query_attention(qc, self.cross_k[i], self.cross_v[i], H)
            x = x + _dense(a, ca["o_w"], ca["o_b"], dtype)

            h = F.gelu(_dense(layer_norm(x, bp["mlp_ln"]), bp["mlp"]["fc1_w"],
                              bp["mlp"]["fc1_b"], dtype))
            x = x + _dense(h, bp["mlp"]["fc2_w"], bp["mlp"]["fc2_b"], dtype)
        x = layer_norm(x, self.ln)
        return torch.matmul(x.float(), self.head_w)

    def step(self, token: torch.Tensor, pos) -> torch.Tensor:
        """token (N,) at position ``pos`` (an int, or a (1,) long tensor)
        -> float32 logits (N, V); writes the position's keys and values into
        the caches."""
        if isinstance(pos, int):
            self.pos.fill_(pos)
        else:
            self.pos.copy_(pos)
        return self.blocks(self.embed(token))

    def prefill(self, initial_tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forces the prompt; the last position's logits."""
        logits = None
        for i in range(initial_tokens.shape[1]):
            logits = self.step(initial_tokens[:, i], i)
        return logits

    def finish(self, steps: int) -> None:
        """Ends a call of ``steps`` generated positions: nothing to count."""


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device):
    """The side stream of every capture on ``device``: cuBLAS keeps a
    workspace for each stream it has run on until the process ends, so a
    new stream a capture would hold another 33 MiB at every recapture."""
    return torch.cuda.Stream(device=device)


def _cuda_graph(fn: Callable[[], None], device: torch.device) -> Callable[[], None]:
    """``fn`` run once on a side stream of ``device`` (the warm-up), then
    captured on that stream as a CUDA graph; returns what replays it there.
    Raises where the graph came out empty (``fn``'s work went to another
    device's stream)."""
    with torch.cuda.device(device):
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                fn()
    empty = [str(w.message) for w in caught if "graph is empty" in str(w.message).lower()]
    if empty:
        raise RuntimeError(f"the token step's CUDA graph on {device} is empty: {empty[0]}")

    def replay() -> None:
        with torch.cuda.device(device):
            graph.replay()

    return replay


class _GraphStep:
    """A decoder's token step as one captured graph a position (a decoder
    class of :data:`_DECODERS` with this mixed in first):
    ``blocks`` captured once over a static input ``x`` (N, d) and the
    position buffer, and replayed at every position (the Whisper prompt's
    included). Each position writes its position and embedding into them
    eagerly before the replay, and reads the logits the graph leaves in its
    output. ``capture(fn, device)`` records ``fn`` and returns what replays
    it (:func:`_cuda_graph` on a card).

    ``key`` is what the buffers' shapes (and, for a graph over the
    parameters themselves, their addresses) depend on. ``busy`` is set from
    :func:`_graphed_decoder` to :meth:`unload`; a call that finds it set
    runs eagerly."""

    def _graph_init(self, key, capture: Callable, n: int, d: int, dtype: torch.dtype,
                    device) -> None:
        self.key, self.capture, self.busy = key, capture, False
        self.x = torch.empty((n, d), dtype=dtype, device=device)
        self.replay: Optional[Callable[[], None]] = None
        self.logits: Optional[torch.Tensor] = None

    def _blocks(self) -> None:
        self.logits = self.blocks(self.x)

    def step(self, token: torch.Tensor, pos: int) -> torch.Tensor:
        """As the eager step; the logits are the graph's output,
        overwritten by the next step."""
        self.pos.fill_(pos)
        self.embed(token, out=self.x)
        if self.replay is None:
            self.replay = self.capture(self._blocks, self.x.device)
            _greedy.graph_captures += 1
        self.replay()
        _greedy.graph_replays += 1
        return self.logits


class _GraphedDecoder(_GraphStep, _Decoder):
    """Whisper's token step graphed over the decoder's own buffers, which
    each call writes its weights, cross K/V and emptied caches into."""

    def __init__(self, key, capture: Callable, params: Params, dims: ModelDimensions,
                 dtype: torch.dtype, xa: torch.Tensor, max_len: int):
        _Decoder.__init__(self, dims, dtype, xa.shape[0], xa.shape[1], max_len, xa.device)
        self._graph_init(key, capture, xa.shape[0], dims.n_text_state, dtype, xa.device)

    def unload(self) -> None:
        """Ends a call: the parameters' embeddings are let go, and the
        buffers are free for the next call."""
        self.tok_emb = self.pos_emb = None
        self.busy = False


class _GraphedOmniDecoder(_GraphStep, omni.OmniDecoder):
    """The speech LLM's token step graphed over the resident parameters and
    the decoder's caches."""

    def __init__(self, key, capture: Callable, params: Params, dims: "omni.OmniDimensions",
                 dtype: torch.dtype, xa: torch.Tensor, max_len: int):
        omni.OmniDecoder.__init__(self, params, dims, dtype, xa.shape[0], max_len, xa.device)
        self._graph_init(key, capture, xa.shape[0], dims.d_model, dtype, xa.device)

    def unload(self) -> None:
        self.audio = None
        self.busy = False


# Each model's decoder, eager and graphed, by the type of its dimensions. A
# decoder class gives ``encode``, ``graph_key``, ``eager``, ``PROMPT_STEPS``,
# ``load``, ``prefill``, ``step``, ``blocks``, ``embed`` and ``finish``.
_DECODERS: Dict[type, Tuple[type, type]] = {
    ModelDimensions: (_Decoder, _GraphedDecoder),
    omni.OmniDimensions: (omni.OmniDecoder, _GraphedOmniDecoder),
}
# Device type -> how a graph is captured there; elsewhere the step runs eagerly.
_CAPTURE: Dict[str, Callable] = {"cuda": _cuda_graph}
# Each device's graphed decoder, kept for the next call of the same key: the
# decode functions take no state from their callers, and a capture costs a
# warm-up step and the host time of a step's launches. One holds its bf16
# matrices, float32 head, cross K/V, caches and the graph's pool between
# calls: 3.72 GiB for large-v3 at 8 rows and 224 positions in bf16 (PERF.md
# §6). :func:`release` lets them go.
_GRAPHED: Dict[torch.device, _GraphedDecoder] = {}
_GRAPHED_LOCK = threading.Lock()


def release() -> None:
    """Lets go of every device's held graphed decoder, its graph and its
    buffers, and returns the freed blocks to the devices. A call in flight
    keeps its own until it ends; the next call captures anew."""
    with _GRAPHED_LOCK:
        _GRAPHED.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _graphed_decoder(params: Params, dims, dtype: torch.dtype, xa: torch.Tensor,
                     max_len: int) -> Optional[_GraphStep]:
    """The device's graphed decoder for this call, loaded and marked busy;
    None where the device type has no capture or another call holds it. A
    call of another key (the device type and the decoder class's
    ``graph_key``) frees the held one first and captures anew. ``xa`` is
    what the decoder class's ``encode`` gave."""
    capture = _CAPTURE.get(xa.device.type)
    if capture is None:
        return None
    graphed_cls = _DECODERS[type(dims)][1]
    key = graphed_cls.graph_key(params, dims, dtype, xa, max_len)
    with _GRAPHED_LOCK:
        graphed = _GRAPHED.get(xa.device)
        if graphed is not None and graphed.busy:
            return None
        if graphed is None or graphed.key != key:
            _GRAPHED.pop(xa.device, None)
            graphed = None  # the old buffers go before the new are allocated
            graphed = graphed_cls(key, capture, params, dims, dtype, xa, max_len)
            _GRAPHED[xa.device] = graphed
        graphed.busy = True
    try:
        graphed.load(params, xa)
    except BaseException:
        graphed.unload()
        raise
    return graphed


def _encode(params: Params, mel: torch.Tensor, dims, fcfg: ForwardConfig,
            max_len: int, graphed: bool = False):
    """The encoder pass and a loaded decoder: the device's graphed one where
    ``graphed`` and one is free there, else an eager one."""
    with span("wft.decode.encode"):
        eval_fcfg = _eval_fcfg(fcfg)
        eager_cls = _DECODERS[type(dims)][0]
        xa = eager_cls.encode(params, mel, dims, eval_fcfg)
        dec = _graphed_decoder(params, dims, eval_fcfg.dtype, xa, max_len) if graphed else None
        if dec is None:
            dec = eager_cls.eager(params, dims, eval_fcfg.dtype, xa, max_len)
        return dec


def _filter(filters: Optional[DecodeFilters], logits, prev1, prev2, max_ts, n_sampled: int):
    if filters is None:
        return logits
    return filters.apply(logits, prev1, prev2, max_ts, n_sampled)


def _update_max_ts(filters: Optional[DecodeFilters], max_ts, tok):
    if filters is None or not filters.timestamp_rules:
        return max_ts
    return torch.maximum(max_ts, torch.where(tok >= filters.timestamp_begin, tok, 0))


@torch.no_grad()
def greedy_decode(params: Params, mel: torch.Tensor, initial_tokens: torch.Tensor, eot: int,
                  dims: ModelDimensions, fcfg: ForwardConfig, max_len: int = 224,
                  temperature: float = 0.0, generator: Optional[torch.Generator] = None,
                  filters: Optional[DecodeFilters] = None):
    """mel (B, n_mels, 3000), initial_tokens (B, T0) -> (token ids
    (B, max_len - T0) with everything after ``eot`` frozen to ``eot``,
    average log-prob per accepted token (B,)).

    ``temperature > 0`` samples (Gumbel noise from ``generator``, on the
    parameters' device); 0 is argmax. ``filters`` applies whisper's logit
    filters to every step's logits before the choice.

    On a card the decoder step replays the device's graph
    (:class:`_GraphStep`), captured at the first call of this shape. For the
    speech LLM, ``initial_tokens`` hold :data:`omni.AUDIO_ID` where the
    audio rows go."""
    dec = _encode(params, mel, dims, fcfg, max_len, graphed=True)
    graphed = isinstance(dec, _GraphStep)
    try:
        out, lp_sum, count = _greedy_loop(dec, initial_tokens, eot, max_len, temperature,
                                          generator, filters)
        dec.finish(out.shape[1])
    finally:
        if graphed:
            dec.unload()
    if not graphed:
        _greedy.eager_steps += out.shape[1] + (initial_tokens.shape[1] if dec.PROMPT_STEPS else 0)
    return out, lp_sum / count.clamp(min=1)


def _greedy_loop(dec, initial_tokens: torch.Tensor, eot: int, max_len: int,
                 temperature: float, generator: Optional[torch.Generator],
                 filters: Optional[DecodeFilters]):
    """:func:`greedy_decode`'s prefill and token loop over a loaded decoder:
    (tokens, summed log-probs, accepted counts). Once the prompt's logits
    are filtered (which puts the filters' ids on the device), nothing here
    waits for the card."""
    B, T0 = initial_tokens.shape

    def select(lg):
        if temperature > 0:
            u = torch.rand(lg.shape, generator=generator, device=dev)
            tok = torch.argmax(lg / temperature - torch.log(-torch.log(u)), dim=-1)
        else:
            tok = torch.argmax(lg, dim=-1)
        lp = torch.log_softmax(lg, dim=-1).gather(-1, tok[:, None])[:, 0]
        return tok, lp

    with span("wft.decode.prefill"):
        logits = dec.prefill(initial_tokens)
        dev = logits.device
        zeros = torch.zeros((B,), dtype=torch.long, device=dev)
        token, tok_lp = select(_filter(filters, logits, zeros, zeros, zeros, 0))
    prev_tok, max_ts = zeros, zeros
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    lp_sum = torch.zeros((B,), dtype=torch.float32, device=dev)
    count = torch.zeros((B,), dtype=torch.long, device=dev)
    n_gen = max_len - T0
    out = torch.full((B, n_gen), eot, dtype=torch.long, device=dev)
    for i in range(n_gen):
        with span("wft.decode.token_step"):
            token = torch.where(finished, eot, token)
            out[:, i] = token
            lp_sum = lp_sum + torch.where(finished, 0.0, tok_lp)
            count = count + (~finished).long()
            logits = dec.step(token, T0 + i)
            max_ts = _update_max_ts(filters, max_ts, token)
            logits = _filter(filters, logits, token, prev_tok, max_ts, i + 1)
            nxt, nxt_lp = select(logits)
            finished = finished | (token == eot)
            prev_tok, token, tok_lp = token, nxt, nxt_lp
    return out, lp_sum, count


# greedy decoding's counters: decoder steps replayed as a graph, graphs
# captured, and steps run eagerly (CPU, or the device's graph in use). They
# are the function object's, counted through ``_greedy``, which wrappers set
# in ``greedy_decode``'s place do not replace.
greedy_decode.graph_captures = 0
greedy_decode.graph_replays = 0
greedy_decode.eager_steps = 0
_greedy = greedy_decode


@torch.no_grad()
def beam_decode(params: Params, mel: torch.Tensor, initial_tokens: torch.Tensor, eot: int,
                dims: ModelDimensions, fcfg: ForwardConfig, max_len: int = 224,
                beam_size: int = 5, length_penalty: Optional[float] = None,
                filters: Optional[DecodeFilters] = None):
    """Beam search over the cached decoder: beams ride the batch axis
    (B * K rows, one decoder step a position); each step reorders the caches
    and the token history by the surviving beams. A finished beam's only
    continuation is ``eot`` at no cost. Ranked as whisper's
    MaximumLikelihoodRanker: summed log-prob over the GNMT length penalty
    ``((5 + len) / 6) ** p`` of the non-eot tokens, or over the length when
    ``length_penalty`` is None; the returned average keeps whisper's
    ``sum / (len + 1)``. Returns (tokens (B, max_len - T0), average
    log-prob of the winning beam (B,))."""
    if not isinstance(dims, ModelDimensions):
        raise NotImplementedError("beam search runs Whisper's decoder only")
    B, T0 = initial_tokens.shape
    K, V = beam_size, dims.n_vocab
    n_gen = max_len - T0
    dec = _encode(params, mel, dims, fcfg, max_len)
    with span("wft.decode.prefill"):
        logits = dec.prefill(initial_tokens)
        dec.tile(K)
        dev = logits.device
        zeros_b = torch.zeros((B,), dtype=torch.long, device=dev)
        logp0 = torch.log_softmax(_filter(filters, logits, zeros_b, zeros_b, zeros_b, 0),
                                  dim=-1)
        scores, cur_tok = torch.topk(logp0, K, dim=-1)  # (B, K)
    eot_only = torch.full((V,), NEG_INF, dtype=torch.float32, device=dev)
    eot_only[eot] = 0.0
    hist = torch.full((B, K, n_gen), eot, dtype=torch.long, device=dev)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    prev_tok = torch.zeros((B, K), dtype=torch.long, device=dev)
    max_ts = torch.zeros((B, K), dtype=torch.long, device=dev)
    base = (torch.arange(B, device=dev) * K)[:, None]
    for i in range(n_gen):
        with span("wft.decode.token_step"):
            tok_in = torch.where(finished, eot, cur_tok)
            hist[:, :, i] = tok_in
            logits = dec.step(tok_in.reshape(B * K), T0 + i)
            max_ts = _update_max_ts(filters, max_ts, tok_in)
            logits = _filter(filters, logits, tok_in.reshape(B * K), prev_tok.reshape(B * K),
                             max_ts.reshape(B * K), i + 1)
            logp = torch.log_softmax(logits, dim=-1).view(B, K, V)
            cand = scores[:, :, None] + torch.where(finished[:, :, None], eot_only, logp)
            scores, flat = torch.topk(cand.view(B, K * V), K, dim=-1)
            src = flat // V
            new_tok = flat % V
            hist = hist.gather(1, src[:, :, None].expand(B, K, n_gen))
            finished = finished.gather(1, src)
            prev_tok = tok_in.gather(1, src)
            max_ts = max_ts.gather(1, src)
            dec.reorder((base + src).reshape(B * K))
            finished = finished | (new_tok == eot)
            cur_tok = new_tok

    gen_len = (hist != eot).sum(dim=2)  # (B, K): non-eot tokens
    if length_penalty is None:
        norm = gen_len.clamp(min=1).float()
    else:
        norm = ((5.0 + gen_len.float()) / 6.0) ** length_penalty
    best = torch.argmax(scores / norm, dim=1)
    tokens = hist.gather(1, best[:, None, None].expand(B, 1, n_gen))[:, 0]
    best_scores = scores.gather(1, best[:, None])[:, 0]
    best_len = (gen_len + 1).gather(1, best[:, None])[:, 0]
    return tokens, best_scores / best_len.clamp(min=1).float()


# ---------------------------------------------------------------------------
# whisper's decode fallback
# ---------------------------------------------------------------------------

def _compression_ratio(text: str) -> float:
    """zlib compression ratio, whisper's repetition detector."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def transcribe_batch(params: Params, dims, audio_batch: np.ndarray, tokenizer,
                     fcfg: Optional[ForwardConfig] = None, language: Optional[str] = None,
                     max_len: int = 224, beam_size: Optional[int] = None,
                     temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                     compression_ratio_threshold: Optional[float] = 2.4,
                     logprob_threshold: Optional[float] = -1.0,
                     length_penalty: Optional[float] = None, without_timestamps: bool = True,
                     filters: Optional[DecodeFilters] = None,
                     prompt: Optional[Tuple[Sequence[int], Sequence[int]]] = None) -> List[str]:
    """Raw 30 s audio (B, 480000) -> transcripts, with whisper's fallback:
    temperature 0 decodes by beam search (``beam_size``) or greedily, and a
    row whose zlib compression ratio exceeds ``compression_ratio_threshold``
    or whose average log-prob falls below ``logprob_threshold`` is decoded
    again at the next temperature, by sampling (generator seeded with the
    rung's index). Retry rungs take only the failing rows, gathered into a
    power-of-two bucket padded with the first failing row. The filters are
    :func:`default_filters` unless ``filters`` is given. Runs on the
    parameters' device.

    For the speech LLM (``dims`` an ``OmniDimensions``) ``max_len`` counts
    the positions after the prompt, which is ``prompt`` (the ids before and
    after the audio rows; :data:`omni.DEFAULT_PROMPT` by default); there
    are no filters unless given, and where ``tokenizer`` is None a
    transcript is its ids, space-separated."""
    from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig, featurize_impl

    fcfg = fcfg or ForwardConfig()
    dev = flatten(params)[0][1].device
    B = audio_batch.shape[0]
    with torch.no_grad(), span("wft.decode.featurize"):
        mel = featurize_impl(torch.as_tensor(audio_batch, dtype=torch.float32, device=dev),
                             torch.full((B,), 3000, dtype=torch.int32, device=dev), None,
                             FeaturizeConfig(n_mels=dims.n_mels), train=False)
    if omni.is_omni(dims):
        pre, post = prompt or omni.DEFAULT_PROMPT
        sot_seq = list(pre) + [omni.AUDIO_ID] * dims.audio_tokens + list(post)
        eot = dims.eot
        max_len = len(sot_seq) + max_len
    else:
        if filters is None:
            filters = default_filters(tokenizer, without_timestamps=without_timestamps)
        sot_seq = list(tokenizer.sot_sequence)
        if language is not None:
            sot_seq[1] = tokenizer.special_tokens[f"<|{language}|>"]
        if without_timestamps:
            sot_seq.append(tokenizer.no_timestamps)
        eot = tokenizer.eot
    init = torch.tensor([sot_seq] * B, dtype=torch.long, device=dev)

    def decode_text(row) -> str:
        ids = []
        for t in row.tolist():
            if t == eot:
                break
            ids.append(int(t))
        if tokenizer is None:
            return " ".join(str(i) for i in ids)
        return tokenizer.decode(ids)

    texts: List[Optional[str]] = [None] * B
    needs = np.ones((B,), bool)
    for t_idx, temp in enumerate(temperatures):
        idx = np.nonzero(needs)[0]
        if t_idx == 0 or len(idx) == B:
            sel = np.arange(B)
        else:
            bucket = min(B, 1 << max(0, int(len(idx) - 1).bit_length()))
            sel = np.concatenate([idx, np.repeat(idx[:1], bucket - len(idx))])
        rows = torch.from_numpy(sel).to(dev)
        mel_r, init_r = mel[rows], init[rows]
        if temp == 0.0 and beam_size is not None:
            tokens, avg_lp = beam_decode(params, mel_r, init_r, eot, dims, fcfg,
                                         max_len=max_len, beam_size=beam_size,
                                         length_penalty=length_penalty, filters=filters)
        else:
            gen = torch.Generator(device=dev).manual_seed(t_idx)
            tokens, avg_lp = greedy_decode(params, mel_r, init_r, eot, dims, fcfg,
                                           max_len=max_len, temperature=float(temp),
                                           generator=gen, filters=filters)
        with span("wft.decode.to_host"):
            tokens, avg_lp = tokens.cpu().numpy(), avg_lp.cpu().numpy()
        last = temp == temperatures[-1]
        for j, i in enumerate(sel[: len(idx)]):  # the rest of sel is padding
            text = decode_text(tokens[j])
            ok = True
            if (compression_ratio_threshold is not None
                    and _compression_ratio(text) > compression_ratio_threshold):
                ok = False
            if logprob_threshold is not None and float(avg_lp[j]) < logprob_threshold:
                ok = False
            if ok or last:
                texts[i] = text
                needs[i] = False
        if not needs.any():
            break
    return texts
