"""The port's layer surgery (``models/surgery.py``) and the model section of
its config (``config.build_model``) against the JAX package's: the resample
indices over a grid of depths, resized trees value for value, the resized
forward, the architecture resolution (presets, base names, the
``deocer_layer`` key), and the alignment heads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_tpu.models import surgery as JS
from whisper_finetune_tpu.models.whisper import forward_impl as j_forward
from whisper_finetune_torch import config as C
from whisper_finetune_torch.models import params_from_jax
from whisper_finetune_torch.models import surgery as TS
from whisper_finetune_torch.models.checkpoint import save_checkpoint
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import ForwardConfig as TFC
from whisper_finetune_torch.models.whisper import Whisper, flatten, init_params

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_head=2, n_audio_layer=4,
    n_vocab=64, n_text_ctx=16, n_text_head=2, n_text_state=32, n_text_layer=2,
)
TD = TDims(**DIMS.to_dict())


@pytest.mark.parametrize("current", [1, 2, 3, 4, 7, 32])
def test_resample_indices_match_jax(current):
    for target in (1, 2, 3, 5, 6, 8, 31, 32, 48):
        got = TS.resample_indices(current, target)
        np.testing.assert_array_equal(got, JS.resample_indices(current, target))
        assert len(got) == target and np.all(np.diff(got) >= 0)


def test_resample_indices_semantics():
    np.testing.assert_array_equal(TS.resample_indices(4, 2), [1, 3])
    np.testing.assert_array_equal(TS.resample_indices(4, 6), [0, 1, 1, 2, 3, 3])
    for bad in ((4, 0), (0, 3)):
        with pytest.raises(ValueError):
            TS.resample_indices(*bad)


@pytest.mark.parametrize("enc,dec", [(6, None), (None, 3), (2, 5), (4, 2)])
def test_resize_matches_jax(enc, dec):
    jparams = jax_init_params(jax.random.PRNGKey(0), DIMS)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), TD, device="cpu")
    before = [p.detach().clone() for _, p in model.leaves()]
    jp, jdims, jchanged = JS.resize_whisper_layers(jparams, DIMS, enc, dec)
    tp, tdims, tchanged = TS.resize_whisper_layers(model.params(), TD, enc, dec)
    assert tchanged == jchanged and tdims.to_dict() == jdims.to_dict()
    want = flatten(jax.tree.map(np.asarray, jp))
    assert [p for p, _ in flatten(tp)] == [p for p, _ in want]
    for (path, a), (_, b) in zip(flatten(tp), want):
        np.testing.assert_array_equal(a.detach().numpy(), b, err_msg=str(path))
    assert all(torch.equal(a, p) for a, (_, p) in zip(before, model.leaves()))  # input untouched
    if tchanged:
        rng = np.random.default_rng(0)
        mel = rng.standard_normal((1, 16, 64)).astype(np.float32)
        tok = rng.integers(0, 64, (1, 8)).astype(np.int32)
        ref = np.asarray(j_forward(jp, jnp.asarray(mel), jnp.asarray(tok), jdims,
                                   JFC(compute_dtype="float32")))
        with torch.no_grad():
            out = Whisper(tdims, tp)(torch.from_numpy(mel), torch.from_numpy(tok).long(),
                                     TFC(compute_dtype="float32")).numpy()
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("model_cfg", [
    {"init_name": "whisper-4832"},
    {"init_name": "whisper-3248"},
    {"init_name": "small"},
    {"init_name": "my-large", "base_init_name": "large-v3", "encoder_layers": 24},
    {"init_name": "tiny", "encoder_layer": 2, "decoder_layer": 6},
    {"init_name": "tiny", "deocer_layer": 3},
])
def test_resolve_model_architecture_matches_jax(model_cfg):
    assert TS.resolve_model_architecture(model_cfg) == JS.resolve_model_architecture(model_cfg)


def test_presets_and_alignment_heads_match_jax():
    assert TS.MODEL_LAYER_PRESETS == JS.MODEL_LAYER_PRESETS
    for L, H in ((32, 20), (5, 6), (1, 2)):
        np.testing.assert_array_equal(TS.default_alignment_heads(L, H),
                                      JS.default_alignment_heads(L, H))


@pytest.mark.parametrize("lora,only", [(False, None), (True, None), (True, "train_only_encoder"),
                                       (False, "train_only_decoder")])
def test_build_model_from_config(tmp_path, monkeypatch, lora, only):
    """``config.build_model``: the base from $WHISPER_CHECKPOINT_DIR through
    an alias resolved to it with layer targets, LoRA from the config's seed,
    and the frozen leaves of LoRA and train_only_*."""
    base = init_params(TD, device="cpu", seed=3)
    save_checkpoint(str(tmp_path / "tiny.pt"), base, TD)
    monkeypatch.setenv("WHISPER_CHECKPOINT_DIR", str(tmp_path))
    cfg = C.with_defaults({
        "model": {"init_name": "my-tiny", "base_init_name": "tiny", "encoder_layers": 6,
                  "lora": lora, "lora_config": {"rank": 4, "lora_alpha": 8}},
        "training": {"train_only_encoder": only == "train_only_encoder",
                     "train_only_decoder": only == "train_only_decoder"},
        "seed": 5,
    })
    model, dims = C.build_model(cfg, device="cpu")
    assert (dims.n_audio_layer, dims.n_text_layer) == (6, 2)
    for path, p in model.leaves():
        is_lora = any(k.endswith("_lora") for k in path)
        if lora:
            want = is_lora
        else:
            want = path[0] != {"train_only_encoder": "decoder",
                               "train_only_decoder": "encoder"}.get(only)
        assert p.requires_grad == want, path
    adapted = {path[0] for path, _ in model.leaves() if any(k.endswith("_lora") for k in path)}
    sides = {"encoder"} if only == "train_only_encoder" else {"encoder", "decoder"}
    assert adapted == (sides if lora else set())
    again, _ = C.build_model(cfg, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(model.leaves(), again.leaves()))
