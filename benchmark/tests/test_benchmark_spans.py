"""The spans' reduction (``benchmark/spans.py``) on hand-built profiler
events: each owner rule, the annotation filter, idle time by range, and the
six readings on hand-built records."""

from __future__ import annotations

import pytest

from benchmark import spans
from benchmark.spans import Ev
from benchmark.trace import reduce_events

MAIN, ENGINE = 1, 2


def _launch(t, corr, thread=MAIN, link=0):
    return Ev("cudaLaunchKernel", t, t + 2, thread, corr, link)


def _events():
    """A forward on the main thread; a backward on the engine's thread with
    a backward node, a remat replay and the loss's backward; a host batch."""
    host = [
        Ev("bench.window", 0, 1000, MAIN, 1, annotation=True),
        Ev("bench.step", 0, 800, MAIN, 2, annotation=True),
        Ev("wft.encoder", 10, 200, MAIN, 3, annotation=True),
        Ev("wft.enc_block", 20, 150, MAIN, 4, annotation=True),
        Ev("aten::mm", 30, 40, MAIN, 7, seq=5),
        _launch(32, 101, link=7),
        Ev("wft.attn", 50, 100, MAIN, 8, annotation=True),
        _launch(60, 102, link=8),
        Ev("wft.backward", 300, 600, MAIN, 9, annotation=True),
        Ev("autograd::engine::evaluate_function: MmBackward0", 310, 350, ENGINE, 20, seq=5,
           fwd_thread=MAIN),
        Ev("MmBackward0", 311, 349, ENGINE, 21, seq=5, fwd_thread=MAIN),
        _launch(320, 103, ENGINE, link=21),
        Ev("wft.enc_block", 360, 400, ENGINE, 22, annotation=True),
        Ev("wft.attn", 370, 390, ENGINE, 23, annotation=True),
        _launch(375, 104, ENGINE, link=23),
        _launch(395, 105, ENGINE, link=22),
        Ev("wft.loss", 410, 430, ENGINE, 24, annotation=True),
        _launch(415, 106, ENGINE, link=24),
        _launch(450, 107, ENGINE),
        Ev("bench.host_batch", 800, 950, MAIN, 30, annotation=True),
        Ev("wft.collate", 810, 850, MAIN, 31, annotation=True),
        Ev("wft.to_device", 860, 900, MAIN, 32, annotation=True),
        Ev("cudaMemcpyAsync", 870, 872, MAIN, 108, link=32),
        _launch(960, 109),
        _launch(-50, 110),
    ]
    dev = [
        Ev("gemm", 36, 45, corr=101, link=7),
        Ev("gemm_split", 46, 50, corr=999, link=7),  # no launching call: its operator's
        Ev("attn_fwd_kernel", 63, 80, corr=102, link=8),
        Ev("wft.enc_block", 36, 80, corr=4, annotation=True),  # the range's device row
        Ev("bench.window", 36, 970, corr=1, annotation=True),
        Ev("gemm_dgrad", 323, 330, corr=103, link=21),
        Ev("attn_fwd_kernel", 378, 385, corr=104, link=23),
        Ev("elementwise", 397, 399, corr=105, link=22),
        Ev("softmax_bwd", 417, 420, corr=106, link=24),
        Ev("reduce", 452, 455, corr=107),
        Ev("Memcpy HtoD (Pinned -> Device)", 874, 882, corr=108, link=32),
        Ev("fill", 962, 970, corr=109),
        Ev("queued", 0, 6, corr=110),  # launched before the window opened
    ]
    return dev, host


def test_owner_rules_and_phases():
    out = spans.own_events(*_events())
    us = 1e-6
    expect = {
        "wft.enc_block": {"fwd": 13 * us, "bwd": 7 * us, "replay": 2 * us},  # (a), (b)
        "wft.attn": {"fwd": 17 * us, "replay": 7 * us},  # (a), nested in a replay
        "wft.loss": {"bwd": 3 * us},  # (a) on the engine's thread
        "wft.backward": {"bwd": 3 * us},  # (c): the main thread waits in the backward
        "wft.to_device": {"fwd": 8 * us},
        "bench.window": {"fwd": 8 * us},  # (c): no inner range open
        "(none)": {"fwd": 6 * us},  # (d)
    }
    assert set(out["span_device_s"]) == set(expect)
    for name, by_phase in expect.items():
        assert out["span_device_s"][name] == pytest.approx(by_phase), name
    assert out["span_kernels"] == {"wft.enc_block": 4, "wft.attn": 2, "wft.loss": 1,
                                   "wft.backward": 1, "bench.window": 1, "(none)": 1}
    assert out["span_count"] == {"wft.encoder": 1, "wft.enc_block": 2, "wft.attn": 2,
                                 "wft.backward": 1, "wft.loss": 1, "wft.collate": 1,
                                 "wft.to_device": 1}
    assert out["owned_share"] == pytest.approx(60 / 74)
    assert out["span_group_s"]["wft.enc_block"] == pytest.approx(
        {"matmul": 20e-6, "other": 2e-6})
    assert out["span_group_s"]["wft.to_device"] == pytest.approx({"copy": 8e-6})


def test_annotations_are_no_work_and_busy_matches_the_trace():
    dev, host = _events()
    out = spans.own_events(dev, host)
    busy = 13 + 17 + 7 + 7 + 2 + 3 + 3 + 8 + 8 + 6
    assert out["ops_busy_s"] == pytest.approx(busy * 1e-6)
    trace = reduce_events([(e.name, e.start, e.end) for e in dev],
                          [(e.name, e.start, e.end) for e in host])
    assert trace["busy_s"] == pytest.approx(out["ops_busy_s"])
    # the same annotations without their host ranges' names are still dropped
    unnamed = [e._replace(name="annotation") if e.annotation else e for e in dev]
    assert spans.own_events(unnamed, host)["ops_busy_s"] == pytest.approx(busy * 1e-6)


def test_idle_goes_to_the_innermost_range_on_the_main_thread():
    out = spans.own_events(*_events())
    idle = out["span_idle_s"]
    assert idle["wft.collate"] == pytest.approx(40e-6)
    assert idle["wft.to_device"] == pytest.approx(32e-6)  # 40 less the copy's 8
    assert idle["bench.host_batch"] == pytest.approx(70e-6)
    assert sum(idle.values()) == pytest.approx(1000e-6 - out["ops_busy_s"])


def test_no_window_no_reduction():
    dev, host = _events()
    with pytest.raises(RuntimeError, match="bench.window"):
        spans.own_events(dev, [h for h in host if h.name != "bench.window"])


def _train_record(**trace):
    tr = {"window_s": 12.0, "busy_s": 11.0,
          "span_device_s": {"wft.loss": {"fwd": 0.5, "bwd": 0.3},
                            "wft.attn": {"fwd": 0.4, "bwd": 0.8, "replay": 0.2},
                            "wft.enc_block": {"fwd": 2.0, "replay": 1.0},
                            "wft.dec_block": {"replay": 0.6}},
          "span_kernels": {}, "span_count": {"wft.collate": 8, "wft.stack": 1},
          "span_idle_s": {"wft.collate": 0.1, "wft.stack": 0.02, "bench.host_batch": 0.3}}
    tr.update(trace)
    return {"kind": "train", "steps": 2, "trace": tr}


def test_train_readings():
    r = spans.readings(_train_record())
    assert r == pytest.approx({"train.loss_ms": 400.0, "train.recompute_ms": 900.0,
                               "train.attn_ms": 700.0, "train.batch_idle_ms": 60.0})


def test_decode_readings():
    rec = {"kind": "decode", "calls": 1,
           "trace": {"window_s": 8.0, "busy_s": 1.0, "span_device_s": {},
                     "span_kernels": {"wft.decode.token_step": 220 * 1180},
                     "span_count": {"wft.decode.token_step": 220}, "span_idle_s": {}},
           "span_clock": {"wft.decode.token_step": [220, 4.4]}}
    assert spans.readings(rec) == pytest.approx({"decode.token_step_ms": 20.0,
                                                 "decode.kernels_per_token": 1180.0})


@pytest.mark.parametrize("name", sorted(spans.READINGS))
def test_readings_find_nothing_where_nothing_ran(name):
    read = spans.READINGS[name]
    assert read({}) is None
    # a trace without spans: the parent of the spans reads nothing, never 0
    bare = {"window_s": 1.0, "busy_s": 0.5, "kernel_s": {}, "group_s": {}}
    assert read({"kind": "train", "steps": 1, "trace": bare}) is None
    assert read({"kind": "decode", "calls": 1, "trace": bare}) is None
    # off its kind
    other = "decode" if name.startswith("train.") else "train"
    rec = _train_record() if other == "train" else {
        "kind": "decode", "trace": {"span_device_s": {}, "span_kernels": {},
                                    "span_count": {}, "span_idle_s": {}},
        "span_clock": {}}
    assert read(rec) is None


def test_spans_run_reads_the_tiny_decode_cell_on_the_cpu():
    from benchmark.tests.tiny import DECODE_CELL, TINY_DIMS, tiny_cell

    record = spans.traced_run(tiny_cell(DECODE_CELL), 2**31 + 11, device="cpu",
                              dims_override=TINY_DIMS)
    assert record["kind"] == "decode" and record["trace"] is None
    line = spans.summary(record)
    assert line["readings"] == {} and line["window_s"] is None
