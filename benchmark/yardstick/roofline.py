"""Peaks of one NVIDIA H100 SXM and the least times the chip needs for the
port's work: a kernel's or a step's time against these bounds is its roofline
share.

Peaks are NVIDIA's data sheet for the SXM part at its 700 W limit, dense
rates: 989 TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM3. A bound is the larger of operations over the FLOP rate
and bytes over the byte rate; each input byte is counted read once and each
output byte written once.
"""

from __future__ import annotations

from typing import Mapping, Tuple

BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

HEAD_DIM = 64


def bound_s(n_bytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S
            ) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time for the work."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / flop_rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(n_bytes: float, flops: float) -> Tuple[float, str]:
    s, by = bound_s(n_bytes, flops)
    return s * 1e3, by


def _attn_f(b: int, h: int, tq: int, tk: int, causal: bool) -> float:
    """B*H*Tq*Tk*D over the key tiles a causal mask keeps (64 x 64 tiles at
    or below the diagonal)."""
    if not causal:
        return float(b * h * tq * tk * HEAD_DIM)
    nq, nk = -(-tq // 64), -(-tk // 64)
    kept = sum(min(nk, i + 1) for i in range(nq))
    return float(b * h * HEAD_DIM * kept * 64 * 64)


def attn_fwd_bound_s(b: int, h: int, tq: int, tk: int, causal: bool = False) -> float:
    """One ``attn_fwd`` launch: 4F FLOP (QK^T and PV); bytes q, k, v, o in
    bf16 and the float32 log-sum-exp."""
    flops = 4 * _attn_f(b, h, tq, tk, causal)
    n_bytes = 2 * b * h * HEAD_DIM * (2 * tq + 2 * tk) + 4 * b * h * tq
    return bound_s(n_bytes, flops)[0]


def attn_bwd_bound_s(b: int, h: int, tq: int, tk: int, causal: bool = False) -> float:
    """One ``attn_bwd`` call (dq, dk, dv): 10F FLOP (S and dP again, dV, dQ,
    dK); bytes q, k, v, o, do and dq, dk, dv in bf16, the log-sum-exp."""
    flops = 10 * _attn_f(b, h, tq, tk, causal)
    n_bytes = 2 * b * h * HEAD_DIM * (4 * tq + 4 * tk) + 4 * b * h * tq
    return bound_s(n_bytes, flops)[0]


def attention_sites(dims: Mapping, rows: int) -> dict:
    """The two sites ``attn_impl: auto`` sends to the kernels: the encoder's
    self-attention (Tq = Tk = 1500) and the decoder's cross-attention
    (448 x 1500), each as (fwd bound s, bwd bound s) of one launch."""
    h_a, t_a = int(dims["n_audio_head"]), int(dims["n_audio_ctx"])
    h_t, t_t = int(dims["n_text_head"]), int(dims["n_text_ctx"])
    return {
        "encoder": (attn_fwd_bound_s(rows, h_a, t_a, t_a), attn_bwd_bound_s(rows, h_a, t_a, t_a)),
        "cross": (attn_fwd_bound_s(rows, h_t, t_t, t_a), attn_bwd_bound_s(rows, h_t, t_t, t_a)),
    }


def adamw8_bytes(elements: int, grad_bytes: int) -> float:
    """Bytes one 8-bit AdamW update moves over ``elements`` elements of
    quantized leaves: the float32 parameter read and written, the gradient
    read (``grad_bytes`` an element: 4 for a float32 accumulator, 2 for
    bf16), both code arrays read and written, both float32 block scales (one
    a 256-element block) read and written."""
    return float(elements) * (8 + grad_bytes + 4 + 16 / 256)


def decode_token_bound_s(dims: Mapping, rows: int, max_len: int) -> float:
    """One cached greedy token step at ``rows`` rows: the decoder's block
    matrices in bf16 and its vectors in float32, the float32 tied head,
    every layer's cross K/V and the whole self-attention window read once;
    2 operations a weight element a row, and the two products of each
    single-query attention over the window and the audio frames."""
    L, d = int(dims["n_text_layer"]), int(dims["n_text_state"])
    S, V = int(dims["n_audio_ctx"]), int(dims["n_vocab"])
    mats = L * 16 * d * d  # q, k, v, o twice; fc1, fc2
    vecs = L * (13 * d + 4 * d)  # biases and layer-norm gains
    cross = 2 * L * rows * S * d * 2
    window = 2 * L * rows * max_len * d * 2
    n_bytes = mats * 2 + vecs * 4 + V * d * 4 + cross + window
    flops = 2 * rows * (mats + V * d) + 2 * 2 * rows * L * (S + max_len) * d
    return bound_s(n_bytes, flops)[0]


def encode_bound_s(dims: Mapping, rows: int) -> float:
    """A decode call's encoder pass on ``rows`` clips and the cross K/V of
    every decoder layer: operations of the stem, the encoder blocks and the
    cross projections; bytes the encoder's weights in bf16 and the mel in
    float32, read once."""
    from benchmark.yardstick.flops import encoder_block_flops, stem_flops

    d, L = int(dims["n_audio_state"]), int(dims["n_audio_layer"])
    Ld, S = int(dims["n_text_layer"]), int(dims["n_audio_ctx"])
    flops = (stem_flops(dims, rows) + L * encoder_block_flops(dims, rows)
             + Ld * 2 * 2 * rows * S * d * d)
    n_bytes = L * 12 * d * d * 2 + rows * int(dims["n_mels"]) * 2 * S * 4
    return bound_s(n_bytes, flops)[0]
