"""The benchmark's files, found by name.

* ``BENCHMARK.json`` at the root of the checkout: the cells, the metrics.
* ``benchmark/configs/<config>.json``: one model configuration.
* ``benchmark/traffic/<traffic>.json``: one traffic mix (the job's recipe and
  its data parameters), read by the kind's general generator.
* ``benchmark/workloads/<cell>.json``: one cell's own settings, with the
  limits of its correctness check.
* ``benchmark/metrics/<metric>.py``: one per-layer metric's reader.

Adding any of them adds a file; none of these functions needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def config(name: str) -> Dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def cell(name: str) -> Dict:
    """The cell's entry of ``BENCHMARK.json`` merged with its own file, its
    configuration and its traffic (under ``config_spec`` and
    ``traffic_spec``)."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    out = dict(entry)
    out.update(_json(HERE / "workloads" / f"{name}.json"))
    out["config_spec"] = config(entry["config"])
    out["traffic_spec"] = traffic(entry["traffic"])
    return out


def metrics_for(name: str, trace: bool) -> List[Dict]:
    """The metrics a run of cell ``name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones (each where its ``workloads``
    names the cell, or everywhere when it has none)."""
    bench = benchmark()
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def metric_reader(name: str):
    """The module of ``benchmark/metrics/<name>.py`` (its ``read(record)``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
