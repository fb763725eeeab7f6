"""The port's config defaults and constructors against the JAX package's: the
normalized sections equal ``validate_config``'s for every shipped YAML, and
``build_forward_config`` / ``build_featurize_config`` give the same fields as
the same functions of ``scripts/finetune.py``.

That JAX script imports ``whisper_finetune_tpu.data``, whose
``inverse_mel`` module is missing from the repository; the fixture below
stands a stub in for it while the script is imported, and removes every
module it caused to load afterwards."""

import contextlib
import dataclasses
import sys
import types
from pathlib import Path

import pytest
import yaml

from whisper_finetune_tpu.config import validate_config
from whisper_finetune_torch import config as tc

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))
SECTIONS = ("training", "augmentation", "optimizer", "lr_scheduler", "model")


@contextlib.contextmanager
def stubbed_inverse_mel():
    """Imports of ``whisper_finetune_tpu.data`` succeed inside; every JAX
    package module they loaded is dropped on the way out."""
    before = set(sys.modules)
    stub = types.ModuleType("whisper_finetune_tpu.data.inverse_mel")
    stub.inverse_mel_to_audio = lambda *a, **k: None
    sys.modules[stub.__name__] = stub
    try:
        yield
    finally:
        for name in set(sys.modules) - before:
            if name.startswith("whisper_finetune_tpu"):
                del sys.modules[name]
        import whisper_finetune_tpu

        for attr in ("data", "scripts"):
            if f"whisper_finetune_tpu.{attr}" not in sys.modules:
                whisper_finetune_tpu.__dict__.pop(attr, None)


@pytest.fixture
def jax_finetune():
    with stubbed_inverse_mel():
        from whisper_finetune_tpu.scripts import finetune

        yield finetune


@pytest.fixture(scope="module")
def jax_data():
    """The JAX package's ``data`` package, for a whole test module."""
    with stubbed_inverse_mel():
        import whisper_finetune_tpu.data as data
        import whisper_finetune_tpu.data.augment  # noqa: F401

        yield data


def _raw(name):
    return yaml.safe_load((ROOT / "configs" / name).read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_defaults_match_validate_config(name):
    raw = _raw(name)
    want = validate_config(raw)
    got = tc.with_defaults(raw)
    for section in SECTIONS:
        assert got[section] == want[section], section
    assert tc.load_config(ROOT / "configs" / name) == got


@pytest.mark.parametrize("name", CONFIGS)
def test_config_constructors_match_jax(name, jax_finetune):
    raw = _raw(name)
    raw.setdefault("training", {})["attn_impl"] = "flash_fwd"
    jcfg = validate_config(raw)
    tcfg = tc.with_defaults(raw)
    lora = bool(raw["model"].get("lora", False))
    jf = jax_finetune.build_forward_config(jcfg, is_lora_run=lora)
    tf = tc.build_forward_config(tcfg, is_lora_run=lora, device="cpu")
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    assert dataclasses.asdict(tc.build_featurize_config(tcfg, 128)) == dataclasses.asdict(
        jax_finetune.build_featurize_config(jcfg, 128))


def test_flagship_forward_config():
    cfg = tc.load_config(ROOT / "configs" / "config_large_v3_best_muon.yaml")
    f = tc.build_forward_config(cfg, False, device="cpu")
    assert (f.compute_dtype, f.stochastic_depth, f.sd_encoder, f.sd_decoder) == (
        "bfloat16", 0.1, 0.1, 0.1)
    assert (f.dsa_apply, f.dsa_time_mask_param, f.dsa_freq_mask_param) == (True, 100, 43)
    assert f.remat_encoder and f.remat_decoder and f.attn_impl == "xla"  # auto on the CPU
    gpu = tc.build_forward_config(cfg, False, device="cuda")
    assert (gpu.enc_attn, gpu.dec_attn, gpu.cross_attn) == ("splash", "splash", "splash")
    feat = tc.build_featurize_config(cfg, 128)
    assert (feat.spec_augment, feat.time_mask_param, feat.freq_mask_param, feat.p) == (
        True, 100, 43, 1.0)
    cfg["training"]["train_only_decoder"] = True
    assert tc.build_forward_config(cfg, False, device="cpu").sd_encoder == 0.0


def test_lora_run_raises_and_bad_values():
    """A LoRA run no longer raises: the flagship config's lora_config (rank
    16, alpha 32, dropout 0.1) gives scale 2.0 and dropout 0.1."""
    cfg = tc.load_config(ROOT / "configs" / "config_large_v3_best_muon.yaml")
    f = tc.build_forward_config(cfg, is_lora_run=True, device="cpu")
    assert (f.lora_scale, f.lora_dropout) == (2.0, 0.1)
    assert tc.build_forward_config(cfg, is_lora_run=False, device="cpu").lora_scale == 0.0
    for section, key, value, match in (
        ("training", "stochastic_depth", 1.0, "stochastic_depth"),
        ("training", "accum_grad_steps", 0, "accum_grad_steps"),
        ("training", "mp_dtype", "fp8", "mp_dtype"),
        ("optimizer", "muon_ns_coeffs", "nope", "muon_ns_coeffs"),
        ("optimizer", "muon_ns_steps", 0, "muon_ns_steps"),
    ):
        bad = {"model": {"init_name": "tiny"}, section: {key: value}}
        with pytest.raises(ValueError, match=match):
            tc.with_defaults(bad)
        with pytest.raises(ValueError, match=match):
            validate_config(bad)
    with pytest.raises(TypeError):
        tc.with_defaults([])
