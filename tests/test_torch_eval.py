"""The port's evaluation against the JAX package's: the numpy metrics (WER,
CER, Levenshtein, text normalisation, token metrics, ECE, aggregation, the
macro average) exactly; the eval step's per-token statistics with the same
weights and batch (float32 to 1e-4, predictions equal except at ties; bf16
to 3%); a whole dataset's metrics through the real tokenizer; and the
``val/*`` namespace."""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_finetune_tpu.eval as JE
import whisper_finetune_tpu.runtime as jrt
from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_torch import eval as TE
from whisper_finetune_torch import runtime as trt
from whisper_finetune_torch.models import params_from_jax
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import ForwardConfig as TFC
from whisper_finetune_torch.tokenizer import get_tokenizer

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=150, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_vocab=300, n_text_ctx=24, n_text_state=64, n_text_head=2, n_text_layer=2,
)
# 30 s audio through the real tokenizer: a 1500-frame encoder, one layer, narrow.
AUDIO_DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
    n_vocab=51865, n_text_ctx=448, n_text_state=32, n_text_head=2, n_text_layer=1,
)
WORDS = ["das", "ist", "ein", "test", "zürich", "straße", "café", "-", "über", "42"]


def _sentence(rng):
    return " ".join(rng.choice(WORDS) for _ in range(rng.randint(0, 6)))


def test_wer_cer_and_normalisation_match_jax():
    rng = random.Random(0)
    for _ in range(200):
        ref, hyp = _sentence(rng), _sentence(rng)
        assert TE.word_error_rate(ref, hyp) == JE.word_error_rate(ref, hyp)
        assert TE.char_error_rate(ref, hyp) == JE.char_error_rate(ref, hyp)
        assert TE.levenshtein(ref.split(), hyp.split()) == JE.levenshtein(ref.split(), hyp.split())
        for spec in ("v0", "v1", "v2", "v3"):
            text = ref.upper() + " Ş–ß/ÄÖ ,.:?!"
            assert (TE.normalize_text(text, **TE.VOCAB_SPECS[spec])
                    == JE.normalize_text(text, **JE.VOCAB_SPECS[spec]))
    preds = [_sentence(rng) for _ in range(30)]
    refs = [_sentence(rng) for _ in range(30)]
    assert TE.compute_wer(preds, refs) == JE.compute_wer(preds, refs)
    assert TE.compute_cer_batch(preds, refs) == JE.compute_cer_batch(preds, refs)


def test_token_metrics_ece_and_aggregation_match_jax():
    rng = np.random.default_rng(0)
    per = {"t": [], "j": []}
    for _ in range(12):
        logits = rng.standard_normal((9, 40))
        targets = rng.integers(0, 40, 9)
        targets[rng.random(9) < 0.3] = -100
        pred = logits.argmax(-1)
        got = TE.compute_token_metrics(logits, targets, pred)
        assert got == JE.compute_token_metrics(logits, targets, pred)
        wer, cer = rng.random(), rng.random()
        for key, M in (("t", TE), ("j", JE)):
            per[key].append(M.PerUtteranceMetrics("a", "b", wer, cer, *got))
    conf, corr = rng.random(500), rng.random(500) < 0.5
    assert TE.compute_ece(conf, corr) == JE.compute_ece(conf, corr)
    t = [TE.aggregate_dataset_metrics(per["t"][:6], "x"),
         TE.aggregate_dataset_metrics(per["t"][6:], "y")]
    j = [JE.aggregate_dataset_metrics(per["j"][:6], "x"),
         JE.aggregate_dataset_metrics(per["j"][6:], "y")]
    for a, b in zip(t, j):
        assert (a.num_samples, a.wer, a.cer, a.mean_token_nll, a.avg_log_prob,
                a.mean_token_entropy, a.ece) == (b.num_samples, b.wer, b.cer, b.mean_token_nll,
                                                 b.avg_log_prob, b.mean_token_entropy, b.ece)
    assert TE.compute_macro_average(t) == JE.compute_macro_average(j)


def test_eval_forward_config_matches_jax():
    kw = dict(compute_dtype="bfloat16", remat_policy="full", stochastic_depth=0.1,
              dsa_apply=True, lora_scale=2.0, lora_dropout=0.1, attn_impl="xla",
              attn_impl_encoder="splash", attn_impl_cross="flash")
    t = TE.eval_forward_config(TFC(**kw))
    j = JE.evaluator.eval_forward_config(JFC(**kw))
    for field in ("compute_dtype", "remat_encoder", "remat_encoder_last_only", "remat_decoder",
                  "stochastic_depth", "dsa_apply", "lora_scale", "lora_dropout", "attn_impl",
                  "attn_impl_encoder", "attn_impl_decoder", "attn_impl_cross"):
        assert getattr(t, field) == getattr(j, field), field


def _models(dims, seed=0):
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed), dims))
    return params, params_from_jax(params, TDims(**dims.to_dict()), device="cpu")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.03)])
def test_eval_step_statistics_match_jax(dtype, tol):
    params, model = _models(DIMS)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((3, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    dec_in = rng.integers(0, DIMS.n_vocab, (3, DIMS.n_text_ctx)).astype(np.int32)
    dec_out = rng.integers(0, DIMS.n_vocab, (3, DIMS.n_text_ctx)).astype(np.int32)
    dec_out[:, -5:] = -100
    want = JE.make_eval_step(DIMS, JFC(compute_dtype=dtype))(
        params, {"mel": jnp.asarray(mel), "dec_input": jnp.asarray(dec_in),
                 "dec_output": jnp.asarray(dec_out)})
    got = TE.make_eval_step(TDims(**DIMS.to_dict()), TFC(compute_dtype=dtype))(
        model, {"mel": torch.from_numpy(mel), "dec_input": torch.from_numpy(dec_in).long(),
                "dec_output": torch.from_numpy(dec_out).long()})
    pred_t, pred_j = got[0].numpy(), np.asarray(want[0])
    stats_t = [x.numpy() for x in got[1:]]
    stats_j = [np.asarray(x) for x in want[1:]]
    if dtype == "float32":
        for a, b in zip(stats_t, stats_j):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)
        # A differing prediction is a tie: both picks carry the top log-prob.
        differ = pred_t != pred_j
        assert differ.mean() < 0.01
        np.testing.assert_allclose(stats_t[1][differ], stats_j[1][differ], atol=tol)
    else:
        for a, b in zip(stats_t, stats_j):
            assert np.abs(a - b).max() <= tol * np.abs(b).max()
        assert (pred_t == pred_j).mean() > 0.9


def _audio_batches(tok, n=5, batch=2, seed=0):
    """Eval batches as the driver's loader makes them: 30 s audio, no
    prompts or timestamps."""
    rng = np.random.default_rng(seed)
    texts = ["das ist ein test", "guten morgen zürich", "", "es regnet schon den ganzen tag",
             "die katze sitzt auf dem dach"]
    samples = []
    for i in range(n):
        toks = [tok.sot, tok.special_tokens["<|de|>"], tok.transcribe, tok.no_timestamps]
        text = tok.encode(texts[i % len(texts)])
        samples.append({"audio": (0.05 * rng.standard_normal(480000)).astype(np.float32),
                        "crop_frames": 3000 - 700 * i,
                        "dec_input": toks + text, "dec_output": toks[1:] + text + [tok.eot]})
    from whisper_finetune_torch.data import collate

    return [collate(samples[i:i + batch]) for i in range(0, n, batch)]


def test_evaluate_dataset_matches_jax():
    params, model = _models(AUDIO_DIMS, seed=3)
    tok = get_tokenizer()
    from whisper_finetune_tpu.tokenizer import get_tokenizer as j_get_tokenizer

    batches = _audio_batches(tok)
    j = JE.evaluate_single_dataset(
        JE.make_eval_step(AUDIO_DIMS, JFC(compute_dtype="float32")), params,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches], "d", j_get_tokenizer())
    t = TE.evaluate_single_dataset(
        TE.make_eval_step(TDims(**AUDIO_DIMS.to_dict()), TFC(compute_dtype="float32")), model,
        batches, "d", tok, device="cpu")
    assert t.num_samples == j.num_samples == 4  # the empty reference is skipped
    assert [u.prediction for u in t.per_utterance] == [u.prediction for u in j.per_utterance]
    assert (t.wer, t.cer) == (j.wer, j.cer)
    for field in ("mean_token_nll", "avg_log_prob", "mean_token_entropy", "ece"):
        assert abs(getattr(t, field) - getattr(j, field)) < 1e-4, field


def test_val_namespace_matches_jax(tmp_path):
    dm = JE.aggregate_dataset_metrics([], "debug")
    macro = JE.compute_macro_average([dm])
    keys = {}
    for name, rt, ev in (("t", trt, TE), ("j", jrt, JE)):
        rt.setup_wandb(metrics_dir=str(tmp_path / name), mode="disabled")
        try:
            ev.log_metrics_to_wandb([dm], macro, step=3)
        finally:
            rt.finish_wandb()
        rec = json.loads((tmp_path / name / "metrics.jsonl").read_text())
        assert rec["_step"] == 3
        keys[name] = sorted(rec)
    assert keys["t"] == keys["j"]
    assert "val/debug_loss" in keys["t"] and "val/macro_wer" in keys["t"]


def test_eval_refuses_more_than_one_process(monkeypatch):
    """Evaluation across processes is served now (two ranks against one:
    tests/test_torch_parallel_driver.py). The process group decides, not the
    environment: with ``WORLD_SIZE`` 2 and no group a batch is scored whole,
    as in one process; the row padding a group uses is JAX's ``_pad_rows``
    (all -100 targets, valid crops)."""
    from whisper_finetune_tpu.eval.evaluator import _pad_rows as j_pad_rows
    from whisper_finetune_torch.eval.evaluator import _pad_rows

    params, model = _models(DIMS, seed=2)
    rng = np.random.default_rng(3)
    batch = {"mel": rng.standard_normal((3, 16, 300)).astype(np.float32),
             "dec_input": rng.integers(0, 300, (3, 24)).astype(np.int32),
             "dec_output": rng.integers(0, 300, (3, 24)).astype(np.int32)}
    step = TE.make_eval_step(TDims(**DIMS.to_dict()), TFC(compute_dtype="float32"))
    want = TE.evaluate_single_dataset(step, model, [batch], "d", get_tokenizer(), device="cpu")
    monkeypatch.setattr(trt, "WORLD_SIZE", 2)
    got = TE.evaluate_single_dataset(step, model, [batch], "d", get_tokenizer(), device="cpu")
    assert got == want and got.num_samples == 3
    for multiple in (2, 3, 4):
        padded = _pad_rows({**batch, "crop_frames": np.full((3,), 1200, np.int32)}, multiple)
        j_padded = j_pad_rows({**batch, "crop_frames": np.full((3,), 1200, np.int32)}, multiple)
        assert padded.keys() == j_padded.keys()
        assert all(np.array_equal(padded[k], j_padded[k]) for k in padded)


def test_evaluate_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """``scripts/evaluate.py`` (on the CPU here; the card by default) against
    the JAX package's on the same ``.pt`` and debug dataset: the same
    ``val/*`` keys, WER and CER equal, token statistics to 1e-4."""
    import argparse

    from test_torch_config import stubbed_inverse_mel
    from tools.make_debug_dataset import main as make_dataset
    from whisper_finetune_tpu.models import save_checkpoint
    from whisper_finetune_torch.scripts import evaluate

    make_dataset(str(tmp_path / "ds"), n=8)
    ckpt = str(tmp_path / "mini.pt")
    save_checkpoint(ckpt, jax_init_params(jax.random.PRNGKey(4), AUDIO_DIMS), AUDIO_DIMS)
    args = dict(checkpoint=ckpt, datasets=[str(tmp_path / "ds")], names=None,
                split="validation", batch_size=4, select_n=5, language="de", dtype="float32")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate.cli(["--checkpoint", ckpt, "--datasets", str(tmp_path / "ds")])
    got = evaluate.main(argparse.Namespace(**args, attn_impl="auto", device="cpu"))
    with stubbed_inverse_mel():
        from whisper_finetune_tpu.scripts import evaluate as j_evaluate

        capsys.readouterr()
        j_evaluate.main(argparse.Namespace(**args, attn_impl="xla"))
        out = capsys.readouterr().out
    want = json.loads(out[out.rindex("\n{") + 1:])
    assert got.keys() == want.keys() and "val/ds_wer" in got
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
