"""BENCHMARK.json and the files it names: the contract's shapes, names and
limits, and every cell, configuration, traffic mix and metric found by name."""

from __future__ import annotations

import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.cell(cell)
    assert c["traffic_spec"]["kind"] in ("train", "decode")
    assert (spec.HERE / "kinds" / f"{c['traffic_spec']['kind']}.py").exists()
    assert "limits" in c and all(v > 0 for v in c["limits"].values())
    e2e = [m["name"] for m in spec.metrics_for(cell, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_for(cell, trace=True)


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_files_hold_the_published_widths(cfg):
    from whisper_finetune_torch.models.dims import MODEL_PRESETS

    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    assert entry["file"] == f"benchmark/configs/{cfg}.json"
    data = spec.config(cfg)
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"] == []
    preset = MODEL_PRESETS[data["preset"]].to_dict()
    assert {k: data[k] for k in preset} == preset
    assert any(w["config"] == cfg for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_declares_its_metric(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    mod = spec.metric_reader(metric)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
    assert m["moves"] in E2E
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        assert m["moves"] in [e["name"] for e in spec.metrics_for(cell, trace=False)]
    assert mod.read({}) is None  # nothing to read: no value, never 0


def test_one_layer_name_a_layer():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
