"""The port's packaging CLIs (``scripts/convert_openai_to_hf.py``,
``upload_model_to_hub.py``, ``wandb_to_ct2_upload.py``) against the JAX
package's, on the CPU, on the same tiny ``.pt`` (written by the port's
``save_checkpoint`` from seeded numpy weights):

* the HF state dict (keys, bit-equal tensors), the ``WhisperConfig`` and
  multilinguality of every Whisper vocabulary and a miniature one, and the
  offline generation config equal JAX's;
* the converted folders hold equal configs and bit-equal safetensors; the
  returned models give equal logits, and those match the port's float32
  ``forward_impl`` within 1e-4 of the largest logit;
* ``--local-only`` publishes the same snapshot files with the same bytes
  (the README up to the package's name), at the revision JAX's formula
  gives over the port's files;
* CTranslate2, W&B and the Hub go through stand-in modules (no network):
  the same calls and arguments as JAX's, and JAX's ``ImportError`` text
  where the module is missing;
* the batch CLI: the length check, one quantization broadcast, ``--pairs``
  parsing, and the flags of all three CLIs.
"""

import ast
import json
import os
import runpy
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.scripts import convert_openai_to_hf as JConv
from whisper_finetune_tpu.scripts import upload_model_to_hub as JUp
from whisper_finetune_tpu.scripts import wandb_to_ct2_upload as JBatch
from whisper_finetune_torch.models import ForwardConfig, forward_impl, load_checkpoint
from whisper_finetune_torch.models import init_params, params_from_jax, save_checkpoint
from whisper_finetune_torch.models.checkpoint import params_to_numpy
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.scripts import convert_openai_to_hf as TConv
from whisper_finetune_torch.scripts import upload_model_to_hub as TUp
from whisper_finetune_torch.scripts import wandb_to_ct2_upload as TBatch

ROOT = Path(__file__).resolve().parent.parent
MINI_VOCAB, V3_VOCAB = 300, 51866
LOGIT_RTOL = 1e-4  # HF against the port's float32 forward, of the largest |logit|


def _dims(vocab: int) -> ModelDimensions:
    return ModelDimensions(
        n_mels=80, n_audio_ctx=50, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
        n_vocab=vocab, n_text_ctx=32, n_text_state=64, n_text_head=4, n_text_layer=2)


@pytest.fixture(scope="module", params=[MINI_VOCAB, V3_VOCAB], ids=["mini", "v3"])
def ckpt(request, tmp_path_factory):
    """(path, dims): an fp16 OpenAI-format ``.pt`` of seeded numpy weights."""
    dims = _dims(request.param)
    rng = np.random.default_rng(0)
    shapes = params_to_numpy(init_params(dims, device="cpu"))
    tree = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
                        shapes)
    path = tmp_path_factory.mktemp(f"ckpt{request.param}") / "best_model.pt"
    save_checkpoint(str(path), params_from_jax(tree, dims, device="cpu"), dims)
    return str(path), dims


@pytest.fixture(scope="module")
def converted(ckpt, tmp_path_factory):
    """Both converters on the same ``.pt``: {"jax"|"port": (model, folder)}."""
    path, _ = ckpt
    out = tmp_path_factory.mktemp("hf")
    jm = JConv.convert_openai_whisper_to_tfms(path, str(out / "jax"))
    tm = TConv.convert_openai_whisper_to_tfms(path, str(out / "port"), device="cpu")
    assert jm[1:] == tm[1:]
    return {"jax": (jm[0].eval(), out / "jax"), "port": (tm[0].eval(), out / "port")}


def _inputs(dims, rows=2, tokens=10):
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((rows, dims.n_mels, 2 * dims.n_audio_ctx)).astype(np.float32)
    return torch.from_numpy(mel), torch.from_numpy(rng.integers(0, dims.n_vocab, (rows, tokens)))


def _hf_logits(model, mel, tok):
    with torch.no_grad():
        return model(input_features=mel, decoder_input_ids=tok).logits


# ---------------------------------------------------------------------------
# convert_openai_to_hf
# ---------------------------------------------------------------------------

def test_state_dict_renames_match_jax(ckpt):
    path, _ = ckpt
    sd = torch.load(path, map_location="cpu", weights_only=True)["model_state_dict"]
    got, want = TConv.openai_to_hf_state_dict(sd), JConv.openai_to_hf_state_dict(sd)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    for conv in (TConv, JConv):
        with pytest.raises(KeyError, match="decoder.blocks.0.extra.weight"):
            conv.openai_to_hf_state_dict({"decoder.blocks.0.extra.weight": torch.zeros(1)})


@pytest.mark.parametrize("vocab", [51864, 51865, 51866, MINI_VOCAB])
def test_dims_to_config_and_multilinguality_match_jax(vocab):
    dims = _dims(vocab).to_dict()
    assert TConv.dims_to_config(dims).to_dict() == JConv.dims_to_config(dims).to_dict()
    assert TConv.infer_multilinguality(vocab) == JConv.infer_multilinguality(vocab)


@pytest.mark.parametrize("multilingual,languages", [(True, 100), (True, 99), (False, 0)])
def test_offline_generation_config_matches_jax(multilingual, languages):
    got = TConv.build_generation_config(multilingual, languages).to_dict()
    assert got == JConv.build_generation_config(multilingual, languages).to_dict()
    if multilingual:
        assert got["decoder_start_token_id"] == 50258 and len(got["lang_to_id"]) == languages


def test_converted_folders_match_jax(converted):
    from safetensors.torch import load_file

    jdir, tdir = converted["jax"][1], converted["port"][1]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in ("config.json", "generation_config.json"):
        assert json.loads((tdir / name).read_text()) == json.loads((jdir / name).read_text())
    shards = sorted(p.name for p in jdir.glob("*.safetensors"))
    assert shards
    for shard in shards:
        got, want = load_file(str(tdir / shard)), load_file(str(jdir / shard))
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_converted_model_matches_jax_and_the_port_forward(ckpt, converted):
    path, dims = ckpt
    mel, tok = _inputs(dims)
    port_hf = _hf_logits(converted["port"][0], mel, tok)
    assert torch.equal(port_hf, _hf_logits(converted["jax"][0], mel, tok))
    model = converted["port"][0]
    assert model.proj_out.weight is model.model.decoder.embed_tokens.weight
    ours, _ = load_checkpoint(path, device="cpu")
    with torch.no_grad():
        want = forward_impl(ours.params(), mel, tok, dims, ForwardConfig(compute_dtype="float32"))
    err = (port_hf - want).abs().max().item()
    assert err <= LOGIT_RTOL * want.abs().max().item(), err


def test_converter_cli_and_device(ckpt, tmp_path, monkeypatch):
    path, _ = ckpt
    TConv.cli(["--checkpoint", path, "--pytorch_dump_folder_path", str(tmp_path / "hf"),
               "--device", "cpu"])
    assert (tmp_path / "hf" / "config.json").is_file()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TConv.convert_openai_whisper_to_tfms(path, None)


# ---------------------------------------------------------------------------
# upload_model_to_hub
# ---------------------------------------------------------------------------

def _publish(module, ckpt_path, root: Path):
    argv = ["--checkpoint", ckpt_path, "--repo-id", "org/whisper-test", "--workdir",
            str(root / "work"), "--convert-hf", "--local-only", "--cache-dir",
            str(root / "cache"), "--device", "cpu"]
    module.main(TUp.build_parser().parse_args(argv))  # JAX's main ignores --device
    repo = root / "cache" / "models--org--whisper-test"
    revision = (repo / "refs" / "main").read_text()
    return repo / "snapshots" / revision, revision


def _files(snapshot: Path):
    return sorted(str(p.relative_to(snapshot)) for p in snapshot.rglob("*") if p.is_file())


def test_local_only_publish_matches_jax(ckpt, tmp_path):
    from huggingface_hub import try_to_load_from_cache

    path, dims = ckpt
    jsnap, _ = _publish(JUp, path, tmp_path / "jax")
    tsnap, revision = _publish(TUp, path, tmp_path / "port")
    files = _files(tsnap)
    assert files == _files(jsnap)
    want = {"README.md", "best_model.pt", "config.json", "preprocessor_config.json"}
    if dims.n_vocab == V3_VOCAB:
        want.add("tokenizer.json")
    assert set(files) == want
    for name in files:
        if name != "README.md":
            assert (tsnap / name).read_bytes() == (jsnap / name).read_bytes(), name
    readme = (tsnap / "README.md").read_text()
    assert "library_name: whisper_finetune_torch" in readme
    assert readme == (jsnap / "README.md").read_text().replace(
        "whisper_finetune_tpu", "whisper_finetune_torch")
    assert (tsnap / "best_model.pt").read_bytes() == Path(path).read_bytes()
    if dims.n_vocab == V3_VOCAB:
        for name in TUp.DEPLOYMENT_ASSET_FILES:
            assert (tsnap / name).read_bytes() == (ROOT / "whisper_v3_utils" / name).read_bytes()
    manifest = [(n, str(tsnap / n)) for n in files if n != "README.md"]
    assert revision == JUp.snapshot_revision("org/whisper-test", manifest, readme)
    assert tsnap.name == revision
    resolved = try_to_load_from_cache("org/whisper-test", "best_model.pt",
                                      cache_dir=str(tmp_path / "port" / "cache"))
    assert resolved == str(tsnap / "best_model.pt")


def test_tokenizer_dir_resolution_matches_jax(tmp_path):
    for vocab, layers in ((51866, 32), (51866, 4), (51865, 32), (MINI_VOCAB, 2)):
        pt = tmp_path / f"{vocab}_{layers}.pt"
        torch.save({"dims": {"n_mels": 128, "n_vocab": vocab, "n_text_layer": layers},
                    "model_state_dict": {}}, str(pt))
        got = TUp.resolve_tokenizer_dir(str(pt))
        assert got == JUp.resolve_tokenizer_dir(str(pt))
        assert TUp.resolve_tokenizer_dir(str(pt), str(tmp_path)) == str(tmp_path)
    assert TUp.resolve_tokenizer_dir(str(tmp_path / "51866_4.pt")).endswith("whisper_v3_turbo_utils")
    partial = tmp_path / "assets"
    partial.mkdir()
    (partial / "tokenizer.json").write_text("{}")
    for module in (TUp, JUp):
        with pytest.raises(FileNotFoundError, match="config.json"):
            module._copy_deployment_assets("unused.pt", str(tmp_path), str(partial))


def test_hf_cache_keeps_ct2_config_and_readme_overrides(tmp_path):
    ct2 = tmp_path / "ct2"
    ct2.mkdir()
    (ct2 / "model.bin").write_bytes(b"w")
    (ct2 / "config.json").write_text('{"ct2": true}')
    hf_cfg = tmp_path / "config.json"
    hf_cfg.write_text('{"transformers": true}')
    snaps = [module.write_to_hf_cache("org/ct2", ct2_folder=str(ct2), readme_text="r",
                                      cache_dir=str(tmp_path / name), extra_files=[str(hf_cfg)])
             for name, module in (("port", TUp), ("jax", JUp))]
    assert Path(snaps[0]).name == Path(snaps[1]).name
    assert json.loads((Path(snaps[0]) / "config.json").read_text()) == {"ct2": True}
    readme = tmp_path / "readme.md"
    readme.write_text("# custom")
    for arg in (str(readme), "literal text"):
        assert TUp.build_readme("o/r", "x.pt", readme_arg=arg) == JUp.build_readme(
            "o/r", "x.pt", readme_arg=arg)
    kw = dict(has_ct2=True, quantization="int8", wandb_run_url="https://wandb.ai/o/p/runs/a")
    assert TUp.build_readme("o/r", "x.pt", **kw) == JUp.build_readme("o/r", "x.pt", **kw).replace(
        "whisper_finetune_tpu", "whisper_finetune_torch")


class _Recorder:
    """Records every call made through it, by attribute path."""

    def __init__(self, calls, name="", ret=None):
        self._calls, self._name, self._ret = calls, name, ret

    def __getattr__(self, attr):
        return _Recorder(self._calls, f"{self._name}.{attr}".lstrip("."), self._ret)

    def __call__(self, *args, **kwargs):
        self._calls.append((self._name, args, kwargs))
        return self if self._ret is None else self._ret


def _stand_in(monkeypatch, name, **attrs):
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    monkeypatch.setitem(sys.modules, name, mod)
    return mod


def test_convert_to_ct2_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "ctranslate2", None)
    errors = []
    for module in (TUp, JUp):
        with pytest.raises(ImportError) as info:
            module.convert_to_ct2(str(tmp_path / "hf"), str(tmp_path), "int8")
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "ctranslate2" in errors[0]

    calls = {}
    for name, module in (("port", TUp), ("jax", JUp)):
        calls[name] = []
        converters = _stand_in(monkeypatch, "ctranslate2.converters",
                               TransformersConverter=_Recorder(calls[name], "TransformersConverter"))
        _stand_in(monkeypatch, "ctranslate2", converters=converters)
        out = module.convert_to_ct2("hf_dir", "out", "int8_float16")
        assert out == os.path.join("out", "ct2-int8_float16")
    assert calls["port"] == calls["jax"] == [
        ("TransformersConverter", ("hf_dir",), {}),
        ("TransformersConverter.convert", (os.path.join("out", "ct2-int8_float16"),),
         {"quantization": "int8_float16", "force": True})]


def _args(**kw):
    base = dict(checkpoint=None, wandb_run=None, wandb_file=None, workdir="w")
    return types.SimpleNamespace(**{**base, **kw})


def test_fetch_checkpoint_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    for kw, exc in ((dict(wandb_run="e/p/r"), ImportError), (dict(), ValueError),
                    (dict(checkpoint=str(tmp_path / "none.pt")), FileNotFoundError)):
        msgs = []
        for module in (TUp, JUp):
            with pytest.raises(exc) as info:
                module.fetch_checkpoint(_args(**kw))
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]
    pt = tmp_path / "a.pt"
    pt.write_bytes(b"x")
    assert TUp.fetch_checkpoint(_args(checkpoint=str(pt))) == str(pt)

    calls, paths = {}, {}
    for name, module in (("port", TUp), ("jax", JUp)):
        calls[name] = []
        _stand_in(monkeypatch, "wandb", Api=_Recorder(calls[name], "Api"))
        for wandb_file in (None, "last_model.pt"):
            paths[name, wandb_file] = module.fetch_checkpoint(_args(
                wandb_run="ent/proj/run1", wandb_file=wandb_file, workdir=str(tmp_path / "w")))
    assert calls["port"] == calls["jax"]
    assert ("Api.run.file.download", (), {"root": str(tmp_path / "w"), "replace": True}) \
        in calls["port"]
    assert paths["port", None] == paths["jax", None] == str(tmp_path / "w" / "best_model.pt")
    assert paths["port", "last_model.pt"] == paths["jax", "last_model.pt"]


def test_upload_to_hub_matches_jax(tmp_path, monkeypatch):
    import huggingface_hub

    folder = tmp_path / "ct2-int8"
    folder.mkdir()
    (tmp_path / "best_model.pt").write_bytes(b"x")
    paths = [str(tmp_path / "best_model.pt"), str(folder)]
    calls = {}
    for name, module in (("port", TUp), ("jax", JUp)):
        calls[name] = []
        monkeypatch.setattr(huggingface_hub, "HfApi", _Recorder(calls[name], "HfApi"))
        module.upload_to_hub("org/repo", paths, token="tok")
    assert calls["port"] == calls["jax"] == [
        ("HfApi", (), {"token": "tok"}),
        ("HfApi.create_repo", ("org/repo",), {"exist_ok": True}),
        ("HfApi.upload_file", (), {"path_or_fileobj": paths[0], "repo_id": "org/repo",
                                   "path_in_repo": "best_model.pt"}),
        ("HfApi.upload_folder", (), {"folder_path": paths[1], "repo_id": "org/repo",
                                     "path_in_repo": "ct2-int8"})]
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    msgs = []
    for module in (TUp, JUp):
        with pytest.raises(ImportError) as info:
            module.upload_to_hub("org/repo", paths)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and "--local-only" in msgs[0]


def test_main_uploads_what_jax_uploads(ckpt, tmp_path, monkeypatch):
    import huggingface_hub

    path, _ = ckpt
    calls = {}
    for name, module in (("port", TUp), ("jax", JUp)):
        calls[name] = []
        monkeypatch.setattr(huggingface_hub, "HfApi", _Recorder(calls[name], "HfApi"))
        argv = ["--checkpoint", path, "--repo-id", "org/r", "--workdir", str(tmp_path / name)]
        module.main(TUp.build_parser().parse_args(argv))
    relative = [[(n, {k: os.path.relpath(v, tmp_path / side) if k in (
        "path_or_fileobj", "folder_path") else v for k, v in kw.items()}) for n, _, kw in c]
        for side, c in calls.items()]
    assert relative[0] == relative[1]
    assert [kw.get("path_in_repo") for _, _, kw in calls["port"][2:]] == [
        "best_model.pt", "README.md"]


# ---------------------------------------------------------------------------
# wandb_to_ct2_upload and the CLIs' flags
# ---------------------------------------------------------------------------

def _recording_main(calls):
    def main(args):
        calls.append(vars(args).copy())
    return main


def test_run_batch_broadcasts_and_checks_lengths(tmp_path, monkeypatch):
    pt = tmp_path / "a.pt"
    pt.write_bytes(b"x")
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(TBatch, "upload_main", _recording_main(calls["port"]))
    monkeypatch.setattr(JBatch, "upload_main", _recording_main(calls["jax"]))
    monkeypatch.setenv("HF_TOKEN", "tok")
    for name, module in (("port", TBatch), ("jax", JBatch)):
        module.run_batch([str(pt), "ent/proj/run"], ["o/a", "o/b"], ["int8"], "w", True, False)
    assert len(calls["port"]) == len(calls["jax"]) == 2
    for got, want in zip(calls["port"], calls["jax"]):
        assert {k: got[k] for k in want} == want
        assert got["quantization"] == "int8" and got["token"] == "tok"
        assert (got["tokenizer_dir"], got["readme"], got["cache_dir"], got["device"]) == (
            "auto", None, None, "cuda")
    assert calls["port"][0]["checkpoint"] == str(pt) and calls["port"][0]["wandb_run"] is None
    assert calls["port"][1]["checkpoint"] is None and calls["port"][1]["wandb_run"] == "ent/proj/run"
    msgs = []
    for module in (TBatch, JBatch):
        with pytest.raises(ValueError) as info:
            module.run_batch(["a", "b"], ["o/a"], ["int8"], "w", True, False)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == "List lengths differ: 2 sources, 1 repos, 2 quantizations"


def test_run_batch_publishes_where_jax_lacks_arguments(ckpt, tmp_path):
    # JAX's run_batch builds its namespace without tokenizer_dir, readme and
    # cache_dir, which its main reads: an AttributeError (reference fault).
    path, _ = ckpt
    with pytest.raises(AttributeError, match="tokenizer_dir"):
        JBatch.run_batch([path], ["org/a"], ["float16"], str(tmp_path / "jw"), True, False)
    TBatch.run_batch([path], ["org/a"], ["float16"], str(tmp_path / "w"), True, False,
                     cache_dir=str(tmp_path / "cache"), device="cpu")
    repo = tmp_path / "cache" / "models--org--a"
    snapshot = repo / "snapshots" / (repo / "refs" / "main").read_text()
    assert (snapshot / "best_model.pt").read_bytes() == Path(path).read_bytes()


def test_pairs_file_parses_as_jax(tmp_path, monkeypatch):
    import whisper_finetune_tpu.scripts.upload_model_to_hub as jax_up

    pt = tmp_path / "a.pt"
    pt.write_bytes(b"x")
    pairs = tmp_path / "pairs.tsv"
    pairs.write_text(f"# source\trepo\n\n{pt}\torg/a\nent/proj/run\torg/b\n")
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(jax_up, "main", _recording_main(calls["jax"]))
    monkeypatch.setattr(TBatch, "upload_main", _recording_main(calls["port"]))
    monkeypatch.setattr(sys, "argv", ["wandb_to_ct2_upload", "--pairs", str(pairs),
                                      "--workdir", "w", "--local-only", "--no-ct2"])
    monkeypatch.delitem(sys.modules, "whisper_finetune_tpu.scripts.wandb_to_ct2_upload")
    runpy.run_module("whisper_finetune_tpu.scripts.wandb_to_ct2_upload", run_name="__main__")
    TBatch.cli(sys.argv[1:])
    assert TBatch.read_pairs(str(pairs)) == ([str(pt), "ent/proj/run"], ["org/a", "org/b"])
    assert len(calls["jax"]) == 2
    for got, want in zip(calls["port"], calls["jax"]):
        assert {k: got[k] for k in want} == want
    with pytest.raises(SystemExit, match="No sources"):
        TBatch.cli([])


def _jax_flags(module) -> dict:
    """{option: default} of the ``add_argument`` calls in a JAX script."""
    flags = {}
    for node in ast.walk(ast.parse(Path(module.__file__).read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "required", "choices")}
            flags[node.args[0].value] = kw
    return flags


@pytest.mark.parametrize("jax_module,port_module", [
    (JConv, TConv), (JUp, TUp), (JBatch, TBatch)], ids=["convert", "upload", "batch"])
def test_clis_keep_jax_flags(jax_module, port_module):
    port_flags = {a.option_strings[0]: a for a in port_module.build_parser()._actions
                  if a.option_strings and a.dest != "help"}
    want = _jax_flags(jax_module)
    assert set(port_flags) == set(want) | {"--device"}
    for flag, kw in want.items():
        for key, value in kw.items():
            assert getattr(port_flags[flag], key) == value, (flag, key)
    assert port_flags["--device"].default == "cuda"
