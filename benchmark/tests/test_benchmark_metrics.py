"""The per-layer readers and the trace reduction on synthetic events."""

from __future__ import annotations

import pytest

from benchmark import spec
from benchmark.trace import reduce_events
from benchmark.yardstick import flops, roofline
from benchmark.yardstick.grouping import OTHER

LARGE_V3 = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=20,
                n_audio_layer=32, n_vocab=51866, n_text_ctx=448, n_text_state=1280,
                n_text_head=20, n_text_layer=32)


def _events():
    """A 10 ms window: two kernels, a copy, a user annotation shadowing a
    host range on the device, and host ranges over the gaps (microseconds)."""
    host = [("bench.window", 0.0, 10000.0), ("bench.step", 0.0, 6000.0),
            ("aten::mm", 100.0, 400.0), ("bench.host_batch", 6000.0, 9000.0)]
    dev = [("bench.step", 0.0, 6000.0),  # annotation, not device work
           ("nvjet_tst_gemm", 1000.0, 3000.0), ("attn_fwd_kernel", 2500.0, 4000.0),
           ("Memcpy HtoD (Pinned -> Device)", 9000.0, 9500.0),
           ("vectorized_elementwise_kernel", 9500.0, 10000.0)]
    return dev, host


def test_reduce_events_busy_gaps_and_groups():
    r = reduce_events(*_events())
    assert r["window_s"] == pytest.approx(0.010)
    assert r["busy_s"] == pytest.approx(0.004)  # 1000-4000 and 9000-10000
    assert r["group_s"]["matmul"] == pytest.approx(0.002)
    assert r["group_s"]["attention"] == pytest.approx(0.0015)
    assert r["group_s"][OTHER] == pytest.approx(0.0005)  # the copy is not a kernel
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["bench.host_batch"] == pytest.approx(0.005)  # 4000-9000, named at its middle
    assert gaps["bench.step"] == pytest.approx(0.001)  # 0-1000
    assert "bench.step" not in dict(r["breakdown"]["device_ops"])


def _train_record(**over):
    trace = {"window_s": 12.0, "busy_s": 11.0,
             "kernel_s": {"attn_fwd_kernel<true>": 0.5, "attn_bwd_kernel": 0.8,
                          "fused_adamw8_kernel": 0.012},
             "group_s": {OTHER: 5.5}}
    rec = {"kind": "train", "dims": LARGE_V3, "rows": 32, "accum": 8, "steps": 1,
           "trace": trace, "update_ms": [220.0, 230.0], "adamw8_elements": 1_000_000_000,
           "grad_bytes": 4,
           "counters": {"enc_blocks_run": 230, "dec_blocks_run": 230, "attn_fwd": 920,
                        "attn_bwd": 460, "fused_adamw8": 43}}
    rec.update(over)
    return rec


def _read(name, rec):
    return spec.metric_reader(name).read(rec)


def test_train_readers():
    rec = _train_record()
    f = flops.train_flops(LARGE_V3, 32, 8, 230, 230)
    assert _read("train.mfu", rec) == pytest.approx(100 * f / (12.0 * 989e12))
    assert _read("train.device_idle_pct", rec) == pytest.approx(100 / 12)
    assert _read("train.elementwise_ms", rec) == pytest.approx(5500.0)
    assert _read("train.update_ms", rec) == pytest.approx(225.0)
    sites = roofline.attention_sites(LARGE_V3, 32)
    bound = 920 * (sites["encoder"][0] + sites["cross"][0]) / 2 + 460 * (
        sites["encoder"][1] + sites["cross"][1]) / 2
    assert _read("train.attn_roofline", rec) == pytest.approx(100 * bound / 1.3)
    assert _read("train.adamw8_roofline", rec) == pytest.approx(
        100 * roofline.adamw8_bytes(1_000_000_000, 4) / 3.35e12 / 0.012)


def test_readers_find_nothing_where_nothing_ran():
    rec = _train_record(counters={"enc_blocks_run": 0, "dec_blocks_run": 0, "attn_fwd": 0,
                                  "attn_bwd": 0, "fused_adamw8": 0})
    rec["trace"]["kernel_s"] = {}
    assert _read("train.attn_roofline", rec) is None
    assert _read("train.adamw8_roofline", rec) is None
    assert _read("train.mfu", _train_record(trace=None)) is None
    assert _read("decode.mfu", _train_record()) is None


def test_decode_readers():
    rec = {"kind": "decode", "dims": LARGE_V3, "rows": 8, "max_len": 224, "calls": 2,
           "token_steps": 448, "trace": {"window_s": 14.0, "busy_s": 1.4}}
    least = 2 * roofline.encode_bound_s(LARGE_V3, 8) + 448 * roofline.decode_token_bound_s(
        LARGE_V3, 8, 224)
    assert _read("decode.mfu", rec) == pytest.approx(100 * least / 14.0)
    assert _read("decode.device_idle_pct", rec) == pytest.approx(90.0)
