"""Runs with the timed path broken underneath, at tiny widths on the CPU:
each fault a cell can have makes ``correct`` come out false. And the
control at that size reads above the sound program on some number.

The faults: a step that returns its state unchanged; half of every
microbatch left out, the mean taken over the rest; a served token altered
where it is produced. (The exchange between chips does not exist in these
one-chip cells.)"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control
from benchmark.kinds import decode, train
from benchmark.tests.tiny import DECODE_CELL, TINY_DIMS, TRAIN_CELLS, tiny_cell

SEED = 2**31 + 101


class _Frozen:
    """An optimizer whose update returns its state and leaves the
    parameters as they are."""

    def __init__(self, tx):
        self.tx = tx

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def init(self, params):
        return self.tx.init(params)

    def fused_apply(self, grads, state, params, g_scale=None):
        return state


def _frozen(monkeypatch):
    import whisper_finetune_torch.optim as optim_mod

    real = optim_mod.get_optimizer
    monkeypatch.setattr(optim_mod, "get_optimizer",
                        lambda *a, **k: (_Frozen(real(*a, **k)[0]), []))


def _half_batch(monkeypatch):
    import whisper_finetune_torch.train.step as step_mod

    real = step_mod.make_train_step
    monkeypatch.setattr(step_mod, "make_train_step",
                        lambda *a, **k: control.half_batch(real(*a, **k), None))


def _run_train(name):
    torch.manual_seed(0)
    return train.run(tiny_cell(name), SEED, 0.1, False, time.monotonic(), device="cpu",
                     dims_override=TINY_DIMS)


@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [_frozen, _half_batch], ids=["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run_train(name)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["check"].values())


def test_decode_altered_token_is_not_correct(monkeypatch):
    from whisper_finetune_torch.models import decoding

    monkeypatch.setattr(decoding, "greedy_decode", control.altered_token(decoding))
    res = decode.run(tiny_cell(DECODE_CELL), SEED, 0.1, False, time.monotonic(), device="cpu",
                     dims_override=TINY_DIMS)
    assert res["correct"] is False


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_control_reads_above_the_program(name):
    r = control.train_readings(tiny_cell(name), SEED, "cpu", TINY_DIMS)
    nums = ("loss_gap", "grad_gap", "change_gap")
    assert any(r["control"][n] > 3 * r["program"][n] for n in nums)
    assert all(r["half_batch"][n] > r["program"][n] for n in ("loss_gap", "grad_gap"))


def test_decode_control_reads_above_the_program():
    r = control.decode_readings(tiny_cell(DECODE_CELL), SEED, "cpu", TINY_DIMS, seconds=0.1)
    assert any(r["control"][n] > 3 * r["program"][n] for n in ("logit_gap", "logprob_gap"))
    assert r["altered_token"]["logit_gap"] > 10 * max(r["program"]["logit_gap"], 1e-3)


@pytest.mark.cuda
def test_decode_cell_runs_on_the_card(capsys):
    """On a machine with a card: one short run of the decode cell prints a
    result line with ``correct`` true."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json

    from benchmark import run

    assert run.main(["--workload", DECODE_CELL, "--seed", str(SEED), "--seconds", "1",
                     "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
