"""The run's gates: no card, no result; nothing of JAX or the JAX package
imported; none of the older measuring scripts read."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from benchmark import run, spec

HARNESS = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN_READS = ("chip_smoke", "bench.py", "BENCH_", "MULTICHIP_", "BASELINE")


def test_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "large-v3.greedy-b8", "--seed", str(2**31 + 7),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no card" in out.err


def test_refuses_with_fewer_cards(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert "the cell asks for 1" in run.device_ok(1)


def test_forbidden_top_level_names_are_whole():
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "whisper_finetune_tpu")
    fake = {"whisper_finetune_torch.models", "jaxtyping", "jax.numpy"}
    found = sorted({m.split(".")[0] for m in fake} & set(run.FORBIDDEN))
    assert found == ["jax"]


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_harness_imports_and_reads_nothing_forbidden(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in run.FORBIDDEN, n
            assert not n.startswith("tools"), n
    text = path.read_text()
    assert not any(word in text for word in FORBIDDEN_READS)


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        assert "whisper_finetune_torch" not in path.read_text(), path


def test_loading_the_harness_loads_no_jax():
    code = ("import sys, json; import benchmark.run, benchmark.control, benchmark.kinds.train, "
            "benchmark.kinds.decode, benchmark.reference.train, benchmark.reference.decode; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    assert not loaded & set(run.FORBIDDEN)


def test_result_line_puts_the_check_last():
    res = {"correct": True, "attempted": 8, "failed": 0, "record": {},
           "e2e": {"decode_tokens_per_s": 230.0, "peak_mem_gib": 9.8, "setup_s": 17.0},
           "check": {"logprob_gap": {"value": 0.001, "limit": 0.01}}}
    line = run.result_line("large-v3.greedy-b8", res, False, {"platform": "gpu"})
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert set(line["metrics"]) == {"decode_tokens_per_s", "peak_mem_gib", "setup_s"}
