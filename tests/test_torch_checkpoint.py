"""The port's checkpoint I/O (``models/checkpoint.py``) and merge CLI
(``scripts/merge_lora_weights.py``) against the JAX package's: ``.pt``
files written by either load in the other key for key and value for value
(fp16 storage, so values are compared after the same fp16 rounding, exactly);
the state dicts of the same parameters are equal; LoRA checkpoints use the
torch-parametrize names; ``load_model`` resolves a path, then
``$WHISPER_CHECKPOINT_DIR``, then ``WFT_ALLOW_DOWNLOAD``, then
``WFT_ALLOW_RANDOM_INIT``, and raises JAX's error otherwise;
``fetch_checkpoint`` checks SHA256 over a ``file://`` base URL."""

import hashlib
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import checkpoint as JC
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_tpu.models import lora as JL
from whisper_finetune_torch.models import checkpoint as TC
from whisper_finetune_torch.models import lora as TL
from whisper_finetune_torch.models.dims import MODEL_PRESETS
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import Whisper, flatten, init_params

DIMS = ModelDimensions(
    n_mels=8, n_audio_ctx=16, n_audio_state=16, n_audio_head=2, n_audio_layer=2,
    n_vocab=64, n_text_ctx=8, n_text_head=2, n_text_state=16, n_text_layer=1,
)
TD = TDims(**DIMS.to_dict())


@pytest.fixture()
def lora_params():
    params = jax_init_params(jax.random.PRNGKey(0), DIMS)
    params, _ = JL.apply_lora(params, rank=2, alpha=4, key=jax.random.PRNGKey(1))
    b = params["decoder"]["blocks"]["attn"]["q_w_lora"]["b"]
    params["decoder"]["blocks"]["attn"]["q_w_lora"]["b"] = b + 0.05
    return params


def _np(tree):
    return dict(flatten(jax.tree.map(np.asarray, tree)))


def _fp16(a):
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def _same_tree(port_model, jax_tree, rounded=True):
    got = dict(flatten(TC.params_to_numpy(port_model)))
    want = _np(jax_tree)
    assert list(got) == list(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], _fp16(a) if rounded else a, err_msg=str(path))


@pytest.mark.parametrize("lora", [False, True])
def test_state_dicts_equal_key_for_key(lora, lora_params):
    params = lora_params if lora else jax_init_params(jax.random.PRNGKey(3), DIMS)
    want = JC.params_to_state_dict(params, DIMS)
    got = TC.params_to_state_dict(TC.params_from_jax(jax.tree.map(np.asarray, params), TD,
                                                     device="cpu").params(), TD)
    assert list(got) == list(want)
    for key, a in want.items():
        t = got[key]
        assert t.dtype == torch.float16 and t.is_contiguous(), key
        assert t.untyped_storage().nbytes() == t.numel() * 2, key  # its own storage
        np.testing.assert_array_equal(t.numpy(), a, err_msg=key)


@pytest.mark.parametrize("lora", [False, True])
def test_jax_pt_loads_in_port_and_back(lora, lora_params, tmp_path):
    params = lora_params if lora else jax_init_params(jax.random.PRNGKey(4), DIMS)
    jpath, tpath = str(tmp_path / "jax.pt"), str(tmp_path / "port.pt")
    JC.save_checkpoint(jpath, params, DIMS)
    model, dims = TC.load_checkpoint(jpath, device="cpu")
    assert dims == TD and TL.has_lora(model.params()) == lora
    _same_tree(model, params)
    TC.save_checkpoint(tpath, model, dims)
    back, jdims = JC.load_checkpoint(tpath)
    assert jdims == DIMS
    assert list(_np(back)) == list(_np(params))
    for path, a in _np(params).items():
        np.testing.assert_array_equal(_np(back)[path], _fp16(a), err_msg=str(path))


def test_lora_state_dict_uses_parametrize_names(lora_params):
    model = TC.params_from_jax(jax.tree.map(np.asarray, lora_params), TD, device="cpu")
    sd = TC.params_to_state_dict(model.params(), TD)
    base = "decoder.blocks.0.attn.query.parametrizations.weight"
    assert {f"{base}.original", f"{base}.0.lora_A", f"{base}.0.lora_B"} <= set(sd)
    assert "decoder.blocks.0.attn.query.weight" not in sd
    assert "decoder.blocks.0.attn_ln.weight" in sd
    assert sd[f"{base}.0.lora_A"].shape == (2, 16) and sd[f"{base}.0.lora_B"].shape == (16, 2)


def test_state_dict_contains_openai_keys():
    sd = TC.params_to_state_dict(init_params(TD, device="cpu").params(), TD)
    for key in ("encoder.conv1.weight", "encoder.positional_embedding",
                "encoder.blocks.0.attn.query.weight", "encoder.blocks.1.mlp.2.bias",
                "decoder.token_embedding.weight", "decoder.blocks.0.cross_attn.key.weight",
                "decoder.ln.weight"):
        assert key in sd, key
    assert sd["encoder.conv1.weight"].shape == (TD.n_audio_state, TD.n_mels, 3)
    assert "decoder.blocks.0.cross_attn.key.bias" not in sd


def test_partial_lora_and_bad_files_raise(lora_params, tmp_path):
    sd = JC.params_to_state_dict(lora_params, DIMS)
    sd.pop("encoder.blocks.1.attn.query.parametrizations.weight.0.lora_A")
    with pytest.raises(ValueError, match="Partial LoRA adapters"):
        TC.state_dict_to_params(sd, TD, device="cpu")
    bad = tmp_path / "bad.pt"
    torch.save({"weights": {}}, bad)
    with pytest.raises(ValueError, match="not an OpenAI-whisper checkpoint"):
        TC.load_checkpoint(str(bad), device="cpu")


def test_merge_cli(lora_params, tmp_path):
    """The port's CLI on a LoRA checkpoint: adapters gone, merged kernels
    equal to the JAX CLI's output (both fp16; at most one fp16 step apart
    where float32 products in another order round differently), and equal to
    the in-memory merge."""
    from whisper_finetune_torch.scripts.merge_lora_weights import main as t_merge
    from whisper_finetune_tpu.scripts.merge_lora_weights import main as j_merge

    src = str(tmp_path / "lora.pt")
    JC.save_checkpoint(src, lora_params, DIMS)
    t_merge(src, str(tmp_path / "port.pt"), test_merge=True, rank=2, alpha=4, device="cpu")
    j_merge(src, str(tmp_path / "jax.pt"), rank=2, alpha=4)
    port = torch.load(tmp_path / "port.pt", weights_only=True)
    jaxd = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert port["dims"] == jaxd["dims"] == DIMS.to_dict()
    assert list(port["model_state_dict"]) == list(jaxd["model_state_dict"])
    for key, a in jaxd["model_state_dict"].items():
        b = port["model_state_dict"][key]
        assert b.dtype == torch.float16
        assert (b.float() - a.float()).abs().max() <= 2e-3 * max(a.float().abs().max(), 1), key
    merged, _ = TC.load_checkpoint(str(tmp_path / "port.pt"), device="cpu")
    assert not TL.has_lora(merged.params())
    lora_model, _ = TC.load_checkpoint(src, device="cpu")
    expect = TL.merge_lora(lora_model.params(), rank=2, alpha=4)
    for (path, a), (_, b) in zip(flatten(merged.params()), flatten(expect)):
        assert torch.equal(a, b.half().float()), path


def test_merge_cli_rejects_plain_checkpoint(tmp_path):
    from whisper_finetune_torch.scripts.merge_lora_weights import main as t_merge

    src = str(tmp_path / "plain.pt")
    TC.save_checkpoint(src, init_params(TD, device="cpu"), TD)
    with pytest.raises(ValueError, match="no LoRA adapters"):
        t_merge(src, str(tmp_path / "out.pt"), device="cpu")


def test_merge_cli_help_says_cpu():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "whisper_finetune_torch.scripts.merge_lora_weights",
                          "--help"], capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0 and "CPU" in out.stdout and "--test_merge" in out.stdout
    assert "--device" in out.stdout


def test_merge_cli_defaults_to_the_card(lora_params, tmp_path, monkeypatch):
    """Without ``device``, the merge runs on the card, and raises rather
    than fall back to the CPU when there is none."""
    from whisper_finetune_torch.scripts.merge_lora_weights import main as t_merge

    src = str(tmp_path / "lora.pt")
    JC.save_checkpoint(src, lora_params, DIMS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_merge(src, str(tmp_path / "out.pt"))
    assert not os.path.exists(tmp_path / "out.pt")


def test_float32_checkpoint_round_trips_exactly(lora_params, tmp_path):
    """``save_checkpoint(..., dtype=torch.float32)`` keeps trained adapters
    bit for bit, so a merge of the file is the merge of the model."""
    model = TC.params_from_jax(jax.tree.map(np.asarray, lora_params), TD, device="cpu")
    path = str(tmp_path / "lora32.pt")
    TC.save_checkpoint(path, model, TD, dtype=torch.float32)
    back, dims = TC.load_checkpoint(path, device="cpu")
    assert dims == TD
    for (p, a), (q, b) in zip(model.leaves(), back.leaves()):
        assert p == q and torch.equal(a, b), p


def test_params_from_jax_takes_lora(lora_params):
    model = TC.params_from_jax(jax.tree.map(np.asarray, lora_params), TD, device="cpu")
    assert TL.has_lora(model.params())
    _same_tree(model, lora_params, rounded=False)


def test_fetch_checkpoint_sha256_contract(tmp_path, monkeypatch):
    """Over a file:// base URL: a fresh download verifies, a valid cache is
    reused without a fetch, a corrupt cache warns and downloads again, a
    corrupt download raises, and unknown names are refused, as in JAX."""
    payload = b"not a real checkpoint, just bytes to hash"
    sha = hashlib.sha256(payload).hexdigest()
    serve = tmp_path / "serve" / sha
    serve.mkdir(parents=True)
    (serve / "tiny.pt").write_bytes(payload)
    monkeypatch.setitem(TC._OFFICIAL_SHA256, "tiny", sha)
    monkeypatch.setenv("WFT_CHECKPOINT_BASE_URL", (tmp_path / "serve").as_uri())
    root = str(tmp_path / "cache")

    path = TC.fetch_checkpoint("tiny", root)
    assert path.endswith("tiny.pt") and open(path, "rb").read() == payload
    monkeypatch.setenv("WFT_CHECKPOINT_BASE_URL", (tmp_path / "nowhere").as_uri())
    assert TC.fetch_checkpoint("tiny", root) == path
    monkeypatch.setenv("WFT_CHECKPOINT_BASE_URL", (tmp_path / "serve").as_uri())
    with open(path, "wb") as f:
        f.write(b"corrupted")
    with pytest.warns(UserWarning, match="checksum does not match"):
        assert open(TC.fetch_checkpoint("tiny", root), "rb").read() == payload
    (serve / "tiny.pt").write_bytes(b"tampered in transit")
    os.remove(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="SHA256"):
            TC.fetch_checkpoint("tiny", root)
    with pytest.raises(ValueError, match="No official checkpoint digest"):
        TC.fetch_checkpoint("large-v3-turbo", root)
    assert TC._OFFICIAL_SHA256.keys() == JC._OFFICIAL_SHA256.keys()


def test_load_model_resolution_order(tmp_path, monkeypatch):
    """Path, then $WHISPER_CHECKPOINT_DIR/<name>.pt, then the opt-in
    download, then the opt-in random init; otherwise JAX's error, word for
    word."""
    dims = MODEL_PRESETS["tiny"]
    for var in ("WFT_ALLOW_RANDOM_INIT", "WFT_ALLOW_DOWNLOAD", "WHISPER_CHECKPOINT_DIR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(FileNotFoundError) as tinfo:
        TC.load_model("tiny", device="cpu")
    with pytest.raises(FileNotFoundError) as jinfo:
        JC.load_model("tiny")
    assert str(tinfo.value) == str(jinfo.value)
    with pytest.raises(ValueError, match="Unknown model name"):
        TC.load_model("no-such-model", device="cpu")

    a = init_params(dims, device="cpu", seed=1)
    path = str(tmp_path / "a.pt")
    TC.save_checkpoint(path, a, dims)
    by_path, d = TC.load_model(path, device="cpu")  # 1. a file path
    assert d == dims

    ckdir = tmp_path / "ckpts"
    b = init_params(dims, device="cpu", seed=2)
    TC.save_checkpoint(str(ckdir / "tiny.pt"), b, dims)
    monkeypatch.setenv("WHISPER_CHECKPOINT_DIR", str(ckdir))
    monkeypatch.setenv("WFT_ALLOW_RANDOM_INIT", "1")
    from_dir, _ = TC.load_model("tiny", device="cpu")  # 2. the directory, before random
    leaf = ("decoder", "tok_emb")
    assert torch.equal(dict(from_dir.leaves())[leaf], dict(b.leaves())[leaf].half().float())

    os.remove(ckdir / "tiny.pt")  # 3. the download, before random
    payload = open(path, "rb").read()
    sha = hashlib.sha256(payload).hexdigest()
    (tmp_path / "serve" / sha).mkdir(parents=True)
    (tmp_path / "serve" / sha / "tiny.pt").write_bytes(payload)
    monkeypatch.setitem(TC._OFFICIAL_SHA256, "tiny", sha)
    monkeypatch.setenv("WFT_CHECKPOINT_BASE_URL", (tmp_path / "serve").as_uri())
    monkeypatch.setenv("WFT_ALLOW_DOWNLOAD", "1")
    fetched, _ = TC.load_model("tiny", device="cpu")
    assert os.path.isfile(ckdir / "tiny.pt")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(fetched.leaves(), by_path.leaves()))

    os.remove(ckdir / "tiny.pt")  # 4. random init
    monkeypatch.delenv("WFT_ALLOW_DOWNLOAD")
    rand, d = TC.load_model("tiny", device="cpu")
    assert d == dims and isinstance(rand, Whisper)
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(rand.leaves(), init_params(dims, device="cpu", seed=0).leaves()))
