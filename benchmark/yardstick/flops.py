"""Model FLOPs of Whisper, counted from the shapes (2 * M * N * K a product).

The count the benchmark holds the port's step against:

* the cross-attention's K and V projections run over the audio frames
  (``n_audio_ctx``, 1500), not over the text positions;
* the decoder's causal self-attention counts half of its score and value
  products (the positions above the diagonal are never needed);
* no recompute: a rematerialised forward is work the program chose to redo,
  not work the model needs;
* only the blocks that ran: a block dropped by stochastic depth costs
  nothing, so the caller passes the counts of blocks run.

A training step executes three times the forward (forward, and the backward's
two products per forward product).
"""

from __future__ import annotations

from typing import Mapping


def _d(dims: Mapping, key: str) -> int:
    return int(dims[key])


def encoder_block_flops(dims: Mapping, rows: int = 1) -> float:
    """One encoder block's forward on ``rows`` clips: q, k, v, o projections,
    scores and values (1500 x 1500), the MLP (d -> 4d -> d)."""
    d, t = _d(dims, "n_audio_state"), _d(dims, "n_audio_ctx")
    proj = 4 * 2 * t * d * d
    attn = 2 * 2 * t * t * d
    mlp = 2 * 2 * t * d * 4 * d
    return float(rows * (proj + attn + mlp))


def decoder_block_flops(dims: Mapping, rows: int = 1, text_len: int = None) -> float:
    """One decoder block's forward on ``rows`` sequences of ``text_len``
    positions (``n_text_ctx`` by default): causal self-attention at half,
    cross-attention with q and o over the text and k and v over the audio
    frames, the MLP."""
    d, t_a = _d(dims, "n_text_state"), _d(dims, "n_audio_ctx")
    t = _d(dims, "n_text_ctx") if text_len is None else int(text_len)
    self_proj = 4 * 2 * t * d * d
    self_attn = 2 * 2 * t * t * d / 2
    cross_proj = 2 * 2 * t * d * d + 2 * 2 * t_a * d * d
    cross_attn = 2 * 2 * t * t_a * d
    mlp = 2 * 2 * t * d * 4 * d
    return float(rows * (self_proj + self_attn + cross_proj + cross_attn + mlp))


def stem_flops(dims: Mapping, rows: int = 1) -> float:
    """The two convolutions of the encoder's stem (3000 -> 1500 frames)."""
    d, t, m = _d(dims, "n_audio_state"), _d(dims, "n_audio_ctx"), _d(dims, "n_mels")
    return float(rows * (2 * (2 * t) * 3 * m * d + 2 * t * 3 * d * d))


def logits_flops(dims: Mapping, rows: int = 1, text_len: int = None) -> float:
    """The tied output projection over the vocabulary."""
    d, v = _d(dims, "n_text_state"), _d(dims, "n_vocab")
    t = _d(dims, "n_text_ctx") if text_len is None else int(text_len)
    return float(rows * 2 * t * d * v)


def forward_flops(dims: Mapping, rows: int = 1, enc_blocks: int = None,
                  dec_blocks: int = None) -> float:
    """A teacher-forced forward of ``rows`` samples with ``enc_blocks`` and
    ``dec_blocks`` blocks run on each (all of them by default)."""
    le = _d(dims, "n_audio_layer") if enc_blocks is None else enc_blocks
    ld = _d(dims, "n_text_layer") if dec_blocks is None else dec_blocks
    return (stem_flops(dims, rows) + le * encoder_block_flops(dims, rows)
            + ld * decoder_block_flops(dims, rows) + logits_flops(dims, rows))


def train_flops(dims: Mapping, rows: int, forwards: int, enc_blocks_run: int,
                dec_blocks_run: int) -> float:
    """Executed model FLOPs of ``forwards`` training forwards of ``rows``
    samples each (the microbatches of a window), whose layer loops ran
    ``enc_blocks_run`` and ``dec_blocks_run`` blocks in all (the program's
    ``blocks_run`` counters: one a block a forward, recompute not counted):
    three times the forward."""
    per_forward = stem_flops(dims, rows) + logits_flops(dims, rows)
    blocks = (enc_blocks_run * encoder_block_flops(dims, rows)
              + dec_blocks_run * decoder_block_flops(dims, rows))
    return 3.0 * (forwards * per_forward + blocks)
