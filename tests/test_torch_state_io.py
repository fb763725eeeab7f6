"""Whole-train-state save and resume (``train/state_io.py``): two steps,
save, a fresh state loaded from the file, two more steps equal four
straight steps, bit for bit: in one process (8-bit AdamW; Muon with int8
momentum and an 8-bit auxiliary AdamW, both halves of the partition state)
and under ZeRO-1 across two ``gloo`` ranks (``torch_dist_worker``), whose
file a one-process run reads to continue at world size 1."""

import numpy as np
import pytest
import torch

from torch_dist_worker import one_process, run_ranks, split_rows
from whisper_finetune_torch.models import init_params
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.optim import get_optimizer
from whisper_finetune_torch.train import TrainState
from whisper_finetune_torch.train.state_io import FORMAT, load_train_state, save_train_state

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_head=2, n_audio_layer=2,
    n_vocab=128, n_text_ctx=16, n_text_head=2, n_text_state=32, n_text_layer=2,
)
ADAMW8 = {"type": "adamw", "8bit": True, "params": {"lr": 1e-3}}
MUON8 = {"type": "adamw", "muon": True, "8bit": True, "muon_momentum_dtype": "int8",
         "muon_aux_8bit": True, "muon_params": {"lr": 1e-2, "momentum": 0.95},
         "params": {"lr": 1e-3}}


def _tree(d):
    return {k: _tree(v) if isinstance(v, dict) else v.detach().numpy() for k, v in d.items()}


def _spec(conf, rows=4, **kw):
    rng = np.random.default_rng(7)
    batches = [{
        "mel": rng.standard_normal((1, rows, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32),
        "dec_input": rng.integers(0, DIMS.n_vocab, (1, rows, DIMS.n_text_ctx)).astype(np.int32),
        "dec_output": rng.integers(0, DIMS.n_vocab, (1, rows, DIMS.n_text_ctx)).astype(np.int32),
    } for _ in range(4)]
    params = _tree(init_params(DIMS, device="cpu", seed=3).params())
    return dict(params=params, dims=DIMS.to_dict(), fcfg={"compute_dtype": "float32"},
                opt=conf, batches=batches, accum_dtype="bfloat16", max_grad_norm=1.0, **kw)


def _assert_same_run(a, b, skip=0, moments=True):
    assert a["losses"][skip:] == b["losses"], (a["losses"], b["losses"])
    for pa, pb in zip(a["params"][skip:], b["params"]):
        assert all(np.array_equal(pa[k], pb[k]) for k in pa)
    for ma, mb in zip(a["moments"][-1], b["moments"][-1] if moments else []):
        for x, y in zip(ma, mb):
            assert all(np.array_equal(u, v) for u, v in zip(x, y)) if isinstance(x, tuple) \
                else np.array_equal(x, y)
    assert a["step"] == b["step"] and a["count"] == b["count"]


@pytest.mark.parametrize("conf", [ADAMW8, MUON8], ids=["adamw8", "muon_int8_aux8"])
def test_resume_equals_straight_run(conf, tmp_path):
    straight = one_process("steps", _spec(conf))
    resumed = one_process("steps", _spec(conf, save_after=2,
                                         state_path=str(tmp_path / "train_state.pt")))
    _assert_same_run(straight, resumed)
    assert straight["step"] == 4


def test_zero_resume_equals_straight_run_and_reads_at_world_1(tmp_path):
    """Under ZeRO-1 at world 2 the save gathers every sharded moment (rank 0
    writes whole leaves) and the load keeps each rank's shard; the same
    file continues the run in one process, bit-equal to the ranks' run."""
    path = str(tmp_path / "train_state.pt")
    straight = run_ranks("steps", _spec(ADAMW8, zero=True), 2, tmp_path / "a")
    resumed = run_ranks("steps", _spec(ADAMW8, zero=True, save_after=2, state_path=path), 2,
                        tmp_path / "b")
    for a, b in zip(straight, resumed):
        _assert_same_run(a, b)
    assert any(straight[0]["flags"])
    payload = torch.load(path, weights_only=True)
    assert payload["format"] == FORMAT and payload["step"] == 2 and payload["counts"] == 2
    for moments, (key, p) in zip(payload["moments"], payload["params"].items()):
        for m in moments:  # whole leaves: 8-bit blocks of the whole parameter
            n = m[0].numel() if isinstance(m, tuple) else m.numel()
            assert n >= p.numel(), key
    spec = _spec(ADAMW8, resume_from=path)
    spec["batches"] = split_rows(spec["batches"][2:], 2)
    single = one_process("steps", spec)
    _assert_same_run(straight[0], single, skip=2, moments=False)  # shards vs whole


def test_load_refuses_a_file_of_another_kind_or_run(tmp_path):
    model = init_params(DIMS, device="cpu", seed=0)
    tx, _ = get_optimizer(model.leaves(), ADAMW8)
    state = TrainState(model, tx.init([p for _, p in model.leaves()]), 0)
    other = tmp_path / "model.pt"
    torch.save({"dims": {}, "model_state_dict": {}}, other)
    with pytest.raises(ValueError, match="not a train state"):
        load_train_state(str(other), state, tx)
    path = str(tmp_path / "train_state.pt")
    save_train_state(path, state, tx)
    dict(model.leaves())[("decoder", "tok_emb")].requires_grad_(False)  # another partition
    frozen_tx, _ = get_optimizer([(k, p) for k, p in model.leaves() if p.requires_grad], ADAMW8)
    with pytest.raises(ValueError, match="trainable leaves differ"):
        load_train_state(path, state, frozen_tx)
