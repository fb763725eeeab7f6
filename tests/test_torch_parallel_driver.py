"""Evaluation and the training driver across processes: two ``gloo``
ranks on the CPU (``torch_dist_worker``) against one process.

* ``evaluate_multiple_datasets`` at world 2 (each rank scores its rows of
  the row-padded batch and gathers the rest) gives world 1's ``val/*``.
* ``scripts/finetune.main`` in two ranks, on a config derived from
  ``configs/DEBUG_DDP.yaml`` trimmed to three steps (batch 1 a rank, global
  ``accum_grad_steps`` 4, every microbatch one sample; no SpecAugment, no
  prompts and no timestamp coin, so no per-rank random draw enters: a
  sample's coins are seeded by its position in its rank's stream), gives the
  one-process loss curve of
  the same global config, with and without ZeRO-1; rank 0 alone writes the
  run's files, ``train_state.pt`` included when it is asked for.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from torch_dist_worker import one_process, run_ranks
from whisper_finetune_torch.models import init_params, save_checkpoint
from whisper_finetune_torch.models.dims import ModelDimensions

ROOT = Path(__file__).resolve().parent.parent
EVAL_DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_head=2, n_audio_layer=2,
    n_vocab=300, n_text_ctx=16, n_text_head=2, n_text_state=32, n_text_layer=2,
)


def _tree(d):
    return {k: _tree(v) if isinstance(v, dict) else v.detach().numpy() for k, v in d.items()}


def _eval_batch(rng, rows):
    out = rng.integers(0, 300, (rows, 16)).astype(np.int32)
    out[0, -4:] = -100
    return {"mel": rng.standard_normal((rows, 16, 64)).astype(np.float32),
            "dec_input": rng.integers(0, 300, (rows, 16)).astype(np.int32), "dec_output": out}


def test_eval_across_ranks_matches_one_process(tmp_path):
    """Batches of 3, 4 and 1 rows (padded to 4, 4 and 2 at world 2):
    counts, WER and CER equal; the token statistics to 1e-5 relative."""
    rng = np.random.default_rng(0)
    spec = dict(params=_tree(init_params(EVAL_DIMS, device="cpu", seed=1).params()),
                dims=EVAL_DIMS.to_dict(), fcfg={"compute_dtype": "float32"},
                loaders={"a": [_eval_batch(rng, 3), _eval_batch(rng, 4)],
                         "b": [_eval_batch(rng, 1)]})
    ranks = run_ranks("eval", spec, 2, tmp_path)
    single = one_process("eval", spec)
    assert ranks[0] == ranks[1]
    for got, want in zip(ranks[0]["datasets"], single["datasets"]):
        assert got["num_samples"] == want["num_samples"] > 0
        assert (got["wer"], got["cer"]) == (want["wer"], want["cer"])
        for k in ("mean_token_nll", "avg_log_prob", "mean_token_entropy", "ece"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    for k, v in single["macro"].items():
        np.testing.assert_allclose(ranks[0]["macro"][k], v, rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    from tools.make_debug_dataset import main as make_dataset

    tmp = tmp_path_factory.mktemp("ddp")
    make_dataset(str(tmp / "ds"), n=16)
    dims = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=32, n_audio_head=2,
                           n_audio_layer=1, n_vocab=51865, n_text_ctx=448, n_text_head=2,
                           n_text_state=32, n_text_layer=1)
    ckpt = str(tmp / "mini.pt")
    model = init_params(dims, device="cpu", seed=0)
    save_checkpoint(ckpt, model.params(), dims, dtype=torch.float32)
    config = yaml.safe_load((ROOT / "configs" / "DEBUG_DDP.yaml").read_text())
    config["model"]["init_name"] = ckpt
    config["dataset"].update(train_datasets=[str(tmp / "ds")], val_datasets=[str(tmp / "ds")],
                             batch_size=1, select_n_per_v_ds=[4], train_num_workers=0,
                             prompt_use_rate=0.0, no_timestamp_training=True)
    config["training"].update(accum_grad_steps=4, epochs=0.75, eval_steps=1.0,
                              gradient_checkpointing_encoder=False,
                              gradient_checkpointing_decoder=False)
    config["augmentation"]["spec_augment"]["apply"] = False
    config["save_dir"] = str(tmp / "one")
    one = one_process("driver", {"config": copy.deepcopy(config)})
    return {"config": config, "one": one, "tmp": tmp}


def _train_losses(records):
    return [r["Train loss"] for r in records if "Train loss" in r]


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero1"])
def test_driver_two_ranks_match_one_process(tiny_run, zero):
    """Three steps of 4 samples: the loss curve to 1e-5 relative (the same
    samples, their gradient sums added in another order), the final
    ``val/*`` to 1e-4; the same metric keys and files."""
    config = copy.deepcopy(tiny_run["config"])
    tag = "zero" if zero else "rep"
    config["save_dir"] = str(tiny_run["tmp"] / tag)
    config["training"].update(zero_shard_optimizer=zero, save_train_state=zero)
    ranks = run_ranks("driver", {"config": config}, 2, tiny_run["tmp"] / f"{tag}_spec")
    one = tiny_run["one"]
    assert ranks[0]["step"] == ranks[1]["step"] == one["step"] == 3
    want = _train_losses(one["records"])
    assert len(want) == 3
    np.testing.assert_allclose(_train_losses(ranks[0]["records"]), want, rtol=1e-5)
    # one record a step: rank 0 alone logs
    assert [r["_step"] for r in ranks[0]["records"]] == [r["_step"] for r in one["records"]]
    got_val = {k: v for r in ranks[0]["records"] for k, v in r.items() if k.startswith("val/")
               and r["_step"] == 3}
    want_val = {k: v for r in one["records"] for k, v in r.items() if k.startswith("val/")
                and r["_step"] == 3}
    assert got_val.keys() == want_val.keys() and got_val
    for k, v in want_val.items():
        np.testing.assert_allclose(got_val[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert sorted(set().union(*ranks[0]["records"])) == sorted(set().union(*one["records"]))
    files = set(ranks[0]["files"])
    assert {"last_model.pt", "metrics.jsonl"} <= files
    assert ("train_state.pt" in files) == zero
