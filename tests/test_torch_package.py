"""The PyTorch port as a package: it imports no JAX, runs on the card unless
the caller asks for the CPU, and its weight bridge and initializer keep the
JAX package's parameter tree exactly."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_torch.models import get_preset_dims, init_params, params_from_jax
from whisper_finetune_torch.models.checkpoint import params_to_numpy
from whisper_finetune_torch.models.whisper import ForwardConfig, flatten

ROOT = Path(__file__).resolve().parent.parent

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=150, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_vocab=300, n_text_ctx=24, n_text_state=64, n_text_head=2, n_text_layer=2,
)


def _torch_dims(d):
    from whisper_finetune_torch.models.dims import ModelDimensions as TD

    return TD(**d.to_dict())


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import whisper_finetune_torch, whisper_finetune_torch.models, "
        "whisper_finetune_torch.ops, whisper_finetune_torch.optim, "
        "whisper_finetune_torch.train, whisper_finetune_torch.ops.fused_adamw8, "
        "whisper_finetune_torch._build, whisper_finetune_torch.config, "
        "whisper_finetune_torch.optim.muon, whisper_finetune_torch.optim.optimizers, "
        "whisper_finetune_torch.optim.schedulers, whisper_finetune_torch.optim.state_bridge, "
        "whisper_finetune_torch.models.lora, whisper_finetune_torch.models.surgery, "
        "whisper_finetune_torch.ops.remat, whisper_finetune_torch.scripts.merge_lora_weights, "
        "whisper_finetune_torch.tools.first_slice, whisper_finetune_torch.tools.remat_policies, "
        "whisper_finetune_torch.utils, whisper_finetune_torch.runtime, "
        "whisper_finetune_torch.tokenizer, whisper_finetune_torch.tokenizer.bpe, "
        "whisper_finetune_torch.native, whisper_finetune_torch.data, "
        "whisper_finetune_torch.data.augment, whisper_finetune_torch.data.inverse_mel, "
        "whisper_finetune_torch.data.hf_utils, whisper_finetune_torch.eval, "
        "whisper_finetune_torch.eval.evaluator, whisper_finetune_torch.scripts.finetune, "
        "whisper_finetune_torch.parallel, whisper_finetune_torch.train.zero, "
        "whisper_finetune_torch.train.state_io, whisper_finetune_torch.scripts.evaluate, "
        "whisper_finetune_torch.train.manual_grad, whisper_finetune_torch.models.decoding, "
        "whisper_finetune_torch.scripts.transcribe\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'whisper_finetune_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_import_no_jax():
    # Lazy imports inside functions count too: every import statement.
    for path in list((ROOT / "whisper_finetune_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "optax",
                                                  "whisper_finetune_tpu"), f"{path}: {name}"


def test_cuda_default_raises_without_card(monkeypatch):
    # Entry points default to the card and never fall back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dims = _torch_dims(DIMS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(dims)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({}, dims)
    from whisper_finetune_torch.train import make_train_step
    from whisper_finetune_torch.optim import adamw_8bit

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(dims, ForwardConfig(), adamw_8bit(1e-3))


@pytest.mark.parametrize("what", ["attention", "adamw8"])
def test_kernel_wrappers_refuse_other_devices(what):
    # A wrapper takes its plain twin only for CPU tensors: anything else
    # that is not CUDA raises instead of computing somewhere else.
    if what == "attention":
        from whisper_finetune_torch.ops.attention import splash_mha

        q = torch.empty((1, 1, 4, 64), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            splash_mha(q, q, q)
    else:
        from whisper_finetune_torch.ops.fused_adamw8 import fused_adamw8_leaf

        p = torch.empty((1, 256), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            fused_adamw8_leaf(p, p, p, p, p, p, 1e-3, 0.1, 0.001, p,
                              b1=0.9, b2=0.999, eps=1e-8, wd=0.0)


def test_bridge_roundtrip_is_exact():
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), DIMS))
    model = params_from_jax(params, _torch_dims(DIMS), device="cpu")
    back = params_to_numpy(model)
    flat_a, flat_b = flatten(params), flatten(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_bridge_rejects_wrong_dims():
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), DIMS))
    with pytest.raises(ValueError, match="tok_emb"):
        params_from_jax(params, _torch_dims(DIMS.replace(n_vocab=301)), device="cpu")


@pytest.mark.parametrize("preset", ["tiny", None])
def test_init_matches_jax_tree(preset):
    """Same leaves, shapes and flatten order as the JAX initializer."""
    from whisper_finetune_tpu.models import get_preset_dims as jax_preset

    jdims = jax_preset(preset) if preset else DIMS
    ref = jax.eval_shape(lambda k: jax_init_params(k, jdims), jax.random.PRNGKey(0))
    model = init_params(_torch_dims(jdims), device="cpu", seed=0)
    got = [(p, tuple(t.shape)) for p, t in model.leaves()]
    want = [(p, tuple(a.shape)) for p, a in flatten(ref)]
    assert got == want


def test_presets_match_jax():
    from whisper_finetune_tpu.models import MODEL_PRESETS as JAX_PRESETS
    from whisper_finetune_torch.models import MODEL_PRESETS

    assert {k: v.to_dict() for k, v in MODEL_PRESETS.items()} == {
        k: v.to_dict() for k, v in JAX_PRESETS.items()}
    assert get_preset_dims("large-v3").n_vocab == 51866


def test_init_distributions():
    dims = _torch_dims(DIMS)
    model = init_params(dims, device="cpu", seed=3)
    p = model.params()
    w = p["encoder"]["blocks"]["mlp"]["fc2_w"].detach()
    bound = 1.0 / np.sqrt(4 * dims.n_audio_state)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert abs(float(p["decoder"]["tok_emb"].detach().std()) - 0.02) < 0.002
    assert float(p["decoder"]["blocks"]["attn"]["q_b"].detach().abs().max()) == 0.0
    same = init_params(dims, device="cpu", seed=3)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(model.leaves(), same.leaves()))


@pytest.mark.parametrize("field,value", [
    ("remat_policy", "dots"), ("remat_policy", "save:attn_probs"), ("lora_scale", 2.0),
    ("lora_dropout", 0.1),
])
def test_unported_forward_options_raise(field, value):
    """Once refused, these options now run: a remat policy gives full
    remat's logits and gradients bit for bit, and LoRA switches on a model
    without adapters give the plain forward's (tests/test_torch_remat.py and
    test_torch_lora.py hold them against JAX)."""
    ForwardConfig(**{field: value}).check_supported()
    dims = _torch_dims(DIMS)
    model = init_params(dims, device="cpu", seed=1)
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((1, 16, 300)).astype(np.float32))
    tok = torch.from_numpy(rng.integers(0, 300, (1, 24)))
    outs = []
    for cfg in (ForwardConfig(compute_dtype="float32"),
                ForwardConfig(compute_dtype="float32", **{field: value})):
        out = model(mel, tok, cfg, train=True, generator=torch.Generator().manual_seed(0))
        grads = torch.autograd.grad(out.square().sum(), [p for _, p in model.leaves()])
        outs.append((out.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("field,value", [
    ("stochastic_depth", 0.1), ("dsa_apply", True), ("precast_weights", False),
    ("remat_encoder_last_only", True), ("attn_impl", "flash"), ("attn_impl", "flash_fwd"),
])
def test_ported_forward_options_are_supported(field, value):
    ForwardConfig(**{field: value}).check_supported()
