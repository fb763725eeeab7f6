"""Operations and bytes of Uni-MoE-2.0-Omni's speech-to-text call, counted
from the shapes and the routes the program counted (2 * M * N * K a
product; each weight byte read once where the work needs it; bf16 weights,
float32 norm gains and router):

* the tower pass on ``rows`` clips: the Whisper stem and encoder blocks
  (``yardstick/flops.py``), the pool, the projector; bytes the tower's
  weights and the float32 mel;
* the prefill of ``T0`` positions on ``rows`` rows: the projections, the
  causal attention at half, the router, the fixed experts over every token,
  each dynamic expert over the tokens routed to it (the counted routes), the
  head at the last position only; bytes every language-model weight once
  and the K/V written;
* the token steps: a step reads the attention's, the fixed experts', the
  router's and every dynamic expert's weights (the captured step runs each
  expert over every row, masked, and a deployment's 32 rows touch all four),
  the K/V window up to the position, the head; its operations are every
  row's projections, its attention over the window, its selected experts
  only (not the masked ones the graph also computes) and the head.

A bound is the larger of operations at 989 TFLOP/s and bytes at 3.35 TB/s
(``yardstick/roofline.py``); the token steps', over a window of steps that
are all bound by their bytes, is taken over the window's totals.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from benchmark.yardstick.flops import encoder_block_flops, stem_flops
from benchmark.yardstick.roofline import bound_s


def _i(dims: Mapping, key: str) -> int:
    return int(dims[key])


def _sizes(dims: Mapping):
    d, D = _i(dims, "d_model"), _i(dims, "head_dim")
    hq, hkv = _i(dims, "n_head") * D, _i(dims, "n_kv_head") * D
    attn_w = d * hq + 2 * d * hkv + hq * d  # q, k, v, o
    attn_b = hq + 2 * hkv
    fixed = _i(dims, "n_fixed") * 3 * d * _i(dims, "fixed_width")
    expert = 3 * d * _i(dims, "dynamic_width")
    router = d * (_i(dims, "n_dynamic") + _i(dims, "n_null"))
    return d, D, hq, hkv, attn_w, attn_b, fixed, expert, router


def tower_bound_s(dims: Mapping, rows: int) -> float:
    """One call's tower pass, pool and projector on ``rows`` clips."""
    tw = dims["tower"]
    da, La, S = _i(tw, "n_audio_state"), _i(tw, "n_audio_layer"), _i(tw, "n_audio_ctx")
    A, d = _i(dims, "audio_tokens"), _i(dims, "d_model")
    flops = stem_flops(tw, rows) + La * encoder_block_flops(tw, rows) + 2 * rows * A * da * d
    n_bytes = (La * 12 * da * da * 2 + 3 * _i(tw, "n_mels") * da * 2 + 3 * da * da * 2
               + da * d * 2 + rows * _i(tw, "n_mels") * 2 * S * 4)
    return bound_s(n_bytes, flops)[0]


def moe_work(dims: Mapping, tokens: int, dynamic_routes: int):
    """(bytes, FLOPs) of one pass of the MoE layers over ``tokens`` tokens
    (a prefill's, or a token step's rows) with ``dynamic_routes`` (token,
    layer) routes to dynamic experts: the router, fixed and every dynamic
    expert's weights read once a layer, each token's input read and output
    written once, each routed token's copy in and out; the router, the fixed
    experts over every token, each dynamic expert over its routed tokens."""
    L = _i(dims, "n_layer")
    d, _, _, _, _, _, fixed, expert, router = _sizes(dims)
    E = _i(dims, "n_dynamic")
    n_bytes = L * (router * 4 + fixed * 2 + E * expert * 2 + 2 * tokens * d * 2)
    n_bytes += 2 * dynamic_routes * d * 2
    flops = L * tokens * 2 * (router + fixed) + 2 * expert * dynamic_routes
    return float(n_bytes), float(flops)


def prefill_bound_s(dims: Mapping, rows: int, t0: int, dynamic_routes: int) -> float:
    """One call's prefill of ``t0`` positions on ``rows`` rows."""
    L, V = _i(dims, "n_layer"), _i(dims, "n_vocab")
    d, D, hq, hkv, attn_w, attn_b, fixed, expert, router = _sizes(dims)
    N = rows * t0
    moe_bytes, moe_flops = moe_work(dims, N, dynamic_routes)
    attn = 2 * N * attn_w + 2 * 2 * rows * _i(dims, "n_head") * t0 * t0 * D / 2
    flops = L * attn + moe_flops + 2 * rows * d * V
    n_bytes = (L * (attn_w * 2 + attn_b * 2 + 2 * d * 4 + 2 * rows * hkv * t0 * 2)
               + moe_bytes + d * V * 2 + d * 4)
    return bound_s(n_bytes, flops)[0]


def token_steps_bound_s(dims: Mapping, rows: int, t0: int, steps: int, calls: int,
                        dynamic_routes: int) -> float:
    """``calls`` calls of ``steps`` token steps each after a ``t0``-position
    prompt, ``dynamic_routes`` (row, layer) routes to dynamic experts in
    all."""
    L, V = _i(dims, "n_layer"), _i(dims, "n_vocab")
    d, D, hq, hkv, attn_w, attn_b, fixed, expert, router = _sizes(dims)
    n = calls * steps
    windows = calls * sum(t0 + i + 1 for i in range(steps))  # positions attended
    per_step = (L * (attn_w * 2 + attn_b * 2 + 2 * d * 4 + router * 4 + fixed * 2
                     + _i(dims, "n_dynamic") * expert * 2) + d * V * 2)
    n_bytes = n * per_step + L * windows * rows * 2 * hkv * 2
    flops = (n * rows * 2 * (L * (attn_w + router + fixed) + d * V)
             + L * windows * rows * 2 * 2 * _i(dims, "n_head") * D + 2 * expert * dynamic_routes)
    return bound_s(n_bytes, flops)[0]


def dynamic(routes: Sequence[int], dims: Mapping) -> int:
    """Routes to the dynamic experts (the null expert's left out)."""
    return int(sum(routes[: _i(dims, "n_dynamic")]))


def call_bound_s(record: Mapping) -> float:
    """The least time of a window's calls: tower passes, prefills, token
    steps, from the record's counters."""
    dims, c = record["dims"], record["counters"]
    rows, t0, calls = record["rows"], record["prompt_len"], record["calls"]
    pre = dynamic(c["prefill_routes"], dims)
    step_routes = dynamic(c["routes"], dims) - pre
    return (calls * tower_bound_s(dims, rows)
            + calls * prefill_bound_s(dims, rows, t0, pre // max(calls, 1))
            + token_steps_bound_s(dims, rows, t0, record["new_tokens"], calls, step_routes))
