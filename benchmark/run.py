"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` a short traced window gives its per-layer metrics, read
by ``benchmark/metrics/<name>.py``. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, then ``check``: each number compared with
its limit, also the last lines of standard error). Without a card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_finetune_tpu")


def _cache_dirs() -> None:
    """Every compile cache inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"  # transformers, where anything loads it, leaves JAX alone


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_ok(chips: int) -> str:
    """'' when the machine has the cards, else why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: no card"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} cards, the cell asks for {chips}"
    return ""


def per_layer(cell_name: str, record: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds something to
    read for."""
    from benchmark import spec

    out = {}
    for m in spec.metrics_for(cell_name, trace=True):
        value = spec.metric_reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell_name: str, res: dict, trace: bool, device: dict) -> dict:
    from benchmark import spec

    if trace:
        metrics = per_layer(cell_name, res["record"])
    else:
        metrics = {m["name"]: {"value": float(res["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in spec.metrics_for(cell_name, trace=False)}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace and res["record"].get("trace"):
        line["breakdown"] = res["record"]["trace"]["breakdown"]
    line["check"] = res["check"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from benchmark import spec

    cell = spec.cell(args.workload)
    why_not = device_ok(int(cell["chips"]))
    if why_not:
        print(f"benchmark: {why_not}", file=sys.stderr)
        return 2
    import torch

    kind = importlib.import_module(f"benchmark.kinds.{cell['traffic_spec']['kind']}")
    res = kind.run(cell, args.seed, args.seconds, bool(args.trace), T_START, device="cuda")
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]), "memory_peak_bytes": int(res["peak_bytes"])}
    if args.trace:
        tr = res["record"]["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        res["readings"]["device_s_by_group"] = tr["group_s"]
    line = result_line(args.workload, res, bool(args.trace), device)
    print(json.dumps({"readings": res["readings"]}), file=sys.stderr)
    for name, c in res["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
