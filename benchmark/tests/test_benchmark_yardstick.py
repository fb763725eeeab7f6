"""The yardstick's arithmetic against counts worked by hand."""

from __future__ import annotations

import pytest

from benchmark.yardstick import flops, grouping, roofline

LARGE_V3 = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
                n_audio_layer=32, n_vocab=51866, n_text_ctx=448, n_text_state=1280,
                n_text_head=20, n_text_layer=32)
TURBO = dict(LARGE_V3, n_text_layer=4)


def _old_count(d):
    """The earlier accounting (cross K/V over the text, causal in full)."""
    da, T, Tt, V = d["n_audio_state"], d["n_audio_ctx"], d["n_text_ctx"], d["n_vocab"]
    enc = 4 * 2 * T * da * da + 2 * 2 * T * T * da + 2 * 2 * T * da * 4 * da
    dec = (4 * 2 * Tt * da * da + 2 * 2 * Tt * Tt * da + 4 * 2 * Tt * da * da
           + 2 * 2 * Tt * T * da + 2 * 2 * Tt * da * 4 * da)
    convs = 2 * (2 * T) * 3 * d["n_mels"] * da + 2 * T * 3 * da * da
    return (d["n_audio_layer"] * enc + d["n_text_layer"] * dec + convs + 2 * Tt * da * V)


def test_large_v3_forward_by_hand():
    d = 1280
    enc_block = 8 * 1500 * d * d + 4 * 1500 * 1500 * d + 4 * 1500 * d * 4 * d
    dec_block = (8 * 448 * d * d + 2 * 448 * 448 * d            # causal at half
                 + 4 * 448 * d * d + 4 * 1500 * d * d            # cross q, o | k, v
                 + 4 * 448 * 1500 * d + 4 * 448 * d * 4 * d)
    stem = 2 * 3000 * 3 * 128 * d + 2 * 1500 * 3 * d * d
    head = 2 * 448 * d * 51866
    hand = 32 * enc_block + 32 * dec_block + stem + head
    assert flops.forward_flops(LARGE_V3) == pytest.approx(hand, rel=1e-12)
    assert flops.forward_flops(LARGE_V3) / 1e12 == pytest.approx(3.43, abs=0.005)
    assert _old_count(LARGE_V3) / 1e12 == pytest.approx(3.23, abs=0.005)


def test_turbo_forward_against_the_old_count():
    assert flops.forward_flops(TURBO) / 1e12 == pytest.approx(2.47, abs=0.005)
    assert _old_count(TURBO) / 1e12 == pytest.approx(2.45, abs=0.005)


def test_train_flops_count_blocks_run_and_no_recompute():
    full = flops.train_flops(LARGE_V3, rows=32, forwards=8, enc_blocks_run=8 * 32,
                             dec_blocks_run=8 * 32)
    assert full == pytest.approx(3 * 8 * flops.forward_flops(LARGE_V3, rows=32), rel=1e-12)
    dropped = flops.train_flops(LARGE_V3, 32, 8, 8 * 32 - 3, 8 * 32)
    assert full - dropped == pytest.approx(3 * 3 * flops.encoder_block_flops(LARGE_V3, 32))


def test_attention_bounds_at_batch_8():
    # The kernel table's bounds: enc fwd 0.093 ms and bwd 0.233 ms by
    # operations, the decoder's causal 448 x 448 0.011 / 0.022 ms by bytes.
    assert roofline.attn_fwd_bound_s(8, 20, 1500, 1500) * 1e3 == pytest.approx(0.0932, abs=5e-4)
    assert roofline.attn_bwd_bound_s(8, 20, 1500, 1500) * 1e3 == pytest.approx(0.233, abs=1e-3)
    assert roofline.attn_fwd_bound_s(8, 20, 448, 448, True) * 1e3 == pytest.approx(0.011, abs=5e-4)
    assert roofline.attn_bwd_bound_s(8, 20, 448, 448, True) * 1e3 == pytest.approx(0.022, abs=5e-4)
    ms, by = roofline.bound_ms(1.0, 989e9)
    assert (ms, by) == (pytest.approx(1.0), "operations")


def test_decode_token_bound_and_adamw8_bytes():
    assert roofline.decode_token_bound_s(LARGE_V3, 8, 224) * 1e3 == pytest.approx(1.255, abs=0.005)
    # large-v3's 43 quantized leaves, 1.54 G elements with bf16 gradients:
    # 21.7 GB, about 14 bytes an element.
    assert roofline.adamw8_bytes(1_543_000_000, 2) / 1e9 == pytest.approx(21.7, abs=0.05)
    assert roofline.adamw8_bytes(1, 4) == pytest.approx(16.0625)


@pytest.mark.parametrize("name,group", [
    ("(anonymous namespace)::attn_bwd_kernel(...)", "attention"),
    ("void (anonymous namespace)::attn_fwd_kernel<true>(...)", "attention"),
    ("fused_adamw8_kernel", "fused_adamw8"),
    ("nvjet_tst_128x192_64x5_2x1_v_bz_coopB_bias_NNN", "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("void cudnn::engines_precompiled::conv2d", "convolution"),
    ("void at::native::vectorized_elementwise_kernel<8, CUDAFunctor_add>", "other"),
])
def test_grouping(name, group):
    assert grouping.group_of(name) == group
