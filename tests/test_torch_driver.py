"""The port's training driver (``whisper_finetune_torch/scripts/finetune.py``)
and what it stands on against the JAX package's: ``validate_config`` on
every shipped YAML, the resolution of the split-step training keys, the
step math and seeding, the runtime facade, the LR telemetry, and a
``main()`` run of a trimmed ``configs/DEBUG.yaml`` on the CPU beside the JAX
driver's run on the same data and ``.pt``: the same ``metrics.jsonl`` keys
(pinned in ``tests/driver_metrics_keys.json``, which ``chip_smoke.py`` holds
the card's run to), the same checkpoint layout, and the step-0 ``val/loss``
within 1e-2 relative.

The JAX driver runs in this process on the test session's 8 CPU devices, so
its host batch and local accumulation differ from the port's one card: the
two runs are compared by keys and layout, not step for step (its step math
gives the same 2 steps here). Its data package needs the ``inverse_mel``
stub (``test_torch_config.stubbed_inverse_mel``)."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from test_torch_config import stubbed_inverse_mel
from whisper_finetune_tpu import utils as ju
from whisper_finetune_tpu.config import validate_config as j_validate_config
from whisper_finetune_torch import config as tc
from whisper_finetune_torch import runtime as rt
from whisper_finetune_torch import utils as tu

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))
KEYS = json.loads((ROOT / "tests" / "driver_metrics_keys.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_validate_config_matches_jax(name):
    raw = yaml.safe_load((ROOT / "configs" / name).read_text())
    assert tc.validate_config(raw) == j_validate_config(raw)


@pytest.mark.parametrize("raw", [
    {"model": {}}, {"model": {"init_name": "tiny"}, "dataset": {"prompt_use_rate": 1.5}},
    {"model": {"init_name": "tiny"}, "dataset": {"batch_size": 0}},
    {"model": {"init_name": "tiny"}, "training": {"split_optimizer_step": "yes"}},
    {"model": {"init_name": "tiny"}, "training": {"compiler_options": [1]}},
    {"model": {"init_name": "tiny"}, "augmentation": {"bpe_dropout": 1.0}},
])
def test_validate_config_rejects_as_jax(raw):
    with pytest.raises(ValueError) as want:
        j_validate_config(raw)
    with pytest.raises(ValueError) as got:
        tc.validate_config(raw)
    assert str(got.value) == str(want.value)


def test_validate_config_warns_on_unknown_keys():
    with pytest.warns(UserWarning, match="sections ignored"):
        tc.validate_config({"model": {"init_name": "tiny"}, "trainig": {}})
    with pytest.warns(UserWarning, match="model config keys"):
        tc.validate_config({"model": {"init_name": "tiny", "lorra": 1}})


# (training keys, optimizer.muon, full tree, ZeRO at a world above 1) ->
# (split_update, manual_backward, manual_precast), or JAX's ValueError.
_MANUAL_ERR = "manual_backward=true requires split_optimizer_step"
STEP_KEY_CASES = [
    ({}, False, True, False, (False, False, False)),
    ({}, True, True, False, (True, True, False)),  # auto: split where Muon is on
    ({}, True, False, False, (True, False, False)),  # LoRA / train_only_*: automatic
    ({"split_optimizer_step": True}, False, True, True, (False, False, False)),  # ZeRO: inert
    ({"split_optimizer_step": True, "manual_backward": False,
      "manual_precast_weights": "auto"}, False, True, False, (True, False, True)),
    ({"manual_backward": True}, False, True, False, _MANUAL_ERR),  # no split
    ({"manual_backward": True, "split_optimizer_step": True}, True, False, False, _MANUAL_ERR),
    ({"manual_backward": True}, True, True, True, _MANUAL_ERR),  # ZeRO turned the split off
]


@pytest.mark.parametrize("training,muon,full_tree,zero,want", STEP_KEY_CASES)
def test_step_keys_resolve_as_the_jax_driver(training, muon, full_tree, zero, want):
    """``split_optimizer_step`` / ``manual_backward`` / ``manual_precast_weights``
    resolve as ``whisper_finetune_tpu/scripts/finetune.py`` resolves them:
    ``auto`` splits exactly when Muon is on, ZeRO at a world above 1 turns
    the split off with JAX's note, ``manual_backward: auto`` is split on the
    full tree, an explicit ``true`` that cannot be honoured raises JAX's
    ``ValueError``."""
    cfg = tc.validate_config({"model": {"init_name": "tiny"}, "training": training,
                              "optimizer": {"muon": muon}})
    assert tc.check_training_keys(cfg) == []  # nothing is refused any more
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tc.resolve_step_keys(cfg, full_tree, zero)
        return
    got, notes = tc.resolve_step_keys(cfg, full_tree, zero)
    assert (got["split_update"], got["manual_backward"], got["manual_precast"]) == want
    assert bool(notes) == (zero and training.get("split_optimizer_step") is True)
    if notes:
        assert "inert under zero_shard_optimizer" in notes[0]


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_configs_pass_and_resolve(name):
    """No shipped config is refused; the one-chip flagship resolves to the
    split step, the manual backward and precast weights, as in JAX; the
    flagship (auto) to split and manual; only XLA's compiler options are
    noted."""
    cfg = tc.load_config(ROOT / "configs" / name)
    notes = tc.check_training_keys(cfg)
    assert all("compiler_options" in n for n in notes)
    lora = bool(cfg["model"].get("lora"))
    full = not (lora or cfg["training"]["train_only_encoder"]
                or cfg["training"]["train_only_decoder"])
    got, notes = tc.resolve_step_keys(cfg, full,
                                      bool(cfg["training"].get("zero_shard_optimizer")))
    if name == "config_large_v3_best_muon_1chip.yaml":
        assert got == {"split_update": True, "manual_backward": True, "manual_precast": True}
        assert notes == []
    if name == "config_large_v3_best_muon.yaml":
        assert got["split_update"] and got["manual_backward"] and not got["manual_precast"]
    xla = tc.validate_config({"model": {"init_name": "tiny"}, "training": {
        "compiler_options": {"xla_tpu_scoped_vmem_limit_kib": 32768}}})
    assert "ignored" in tc.check_training_keys(xla)[0]


def test_step_math_and_seeding_match_jax():
    for n, bs, epochs, accum, world, drop in ((100, 4, 1, 2, 1, True), (101, 3, 2.5, 4, 1, False),
                                              (7, 8, 1, 1, 1, True), (64, 8, 1, 8, 4, True)):
        cfg = {"training": {"epochs": epochs, "accum_grad_steps": accum},
               "dataset": {"batch_size": bs}}
        assert tu.calculate_training_steps(cfg, n, world, drop) == ju.calculate_training_steps(
            cfg, n, world, drop)
        cfg["training"].update(train_steps=n, eval_steps=0.3)
        assert tu.calculate_val_steps(cfg) == ju.calculate_val_steps(cfg)
    assert tu.resolve_local_accum_grad_steps(8, 4) == ju.resolve_local_accum_grad_steps(8, 4)
    for bad in ((6, 4), (0, 1)):
        with pytest.raises(ValueError):
            tu.resolve_local_accum_grad_steps(*bad)
    g = torch.Generator()
    a, b = tu.set_seed(5, g), ju.set_seed(5)
    assert a.random() == b.random()
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=torch.Generator().manual_seed(5)))


def test_runtime_facade(tmp_path, monkeypatch, capsys):
    """At ``WORLD_SIZE=2`` the process group must start: with no second rank
    it times out and raises (never carries on alone); at 1 there is none.
    Two ranks that do start it: tests/test_torch_parallel*.py."""
    from torch_dist_worker import _free_port

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(RuntimeError, match="could not start the gloo process group"):
        rt.setup_distributed("cpu", timeout_s=1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert rt.setup_distributed("cpu") == torch.device("cpu")
    assert (rt.RANK, rt.WORLD_SIZE, rt.IS_MAIN) == (0, 1, True)
    assert not torch.distributed.is_initialized()
    rt.barrier()
    rt.print_once("hello")
    assert "hello" in capsys.readouterr().out
    rt.setup_wandb(config={"save_dir": str(tmp_path)}, mode="disabled")
    hist = {"_type": "histogram", "counts": [1, 2], "edges": [0.0, 0.5, 1.0]}
    try:
        rt.log({"Train loss": 1.5, "h": hist, "t": torch.tensor(2.0)}, step=3)
    finally:
        rt.finish_wandb()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["_step"] == 3 and rec["Train loss"] == 1.5 and rec["h"] == hist
    assert rec["t"] == 2.0


def test_lr_log_dict_matches_jax():
    from whisper_finetune_torch.scripts.finetune import _build_lr_log_dict

    with stubbed_inverse_mel():
        from whisper_finetune_tpu.scripts.finetune import _build_lr_log_dict as j_build

        for meta in ([{"lr_log_label": "adamw", "base_lr": 1e-3, "base_lr_unscaled": 1e-3}],
                     [{"lr_log_label": "muon", "base_lr": 0.064, "base_lr_unscaled": 0.02},
                      {"lr_log_label": "muon", "base_lr": 0.144, "base_lr_unscaled": 0.02},
                      {"lr_log_label": "aux_adamw", "base_lr": 3e-4, "base_lr_unscaled": 3e-4}]):
            assert _build_lr_log_dict(meta, 0.5, 1.5) == j_build(meta, 0.5, 1.5)


def test_driver_defaults_to_the_card(monkeypatch):
    from whisper_finetune_torch.scripts import finetune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune.main({"model": {"init_name": "tiny"}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune.cli(["--config", str(ROOT / "configs" / "DEBUG.yaml")])


# ---------------------------------------------------------------------------
# main() on the CPU beside the JAX driver
# ---------------------------------------------------------------------------

def _config(ds, ckpt, save_dir):
    config = yaml.safe_load((ROOT / "configs" / "DEBUG.yaml").read_text())
    config["model"]["init_name"] = ckpt
    config["dataset"].update(train_datasets=[ds], val_datasets=[ds], batch_size=1,
                             batch_size_eval=2, select_n_per_v_ds=[4], train_num_workers=0)
    # accum_grad_steps 8 is the global window: 16 samples make 2 optimizer
    # steps on one card and on the JAX session's 8 CPU devices alike.
    config["training"].update(epochs=1, eval_steps=1.0, gradient_checkpointing_encoder=False,
                              gradient_checkpointing_decoder=False)
    config["save_dir"] = save_dir
    return config


def _records(run_dir):
    return [json.loads(line) for line in open(Path(run_dir) / "metrics.jsonl")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from tools.make_debug_dataset import main as make_dataset
    from whisper_finetune_tpu.models import ModelDimensions, init_params, save_checkpoint
    from whisper_finetune_torch.scripts import finetune

    tmp = tmp_path_factory.mktemp("driver")
    ds = str(tmp / "ds")
    make_dataset(ds, n=16)
    dims = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=32, n_audio_head=2,
                           n_audio_layer=1, n_vocab=51865, n_text_ctx=448, n_text_head=2,
                           n_text_state=32, n_text_layer=1)
    ckpt = str(tmp / "mini.pt")
    save_checkpoint(ckpt, init_params(jax.random.PRNGKey(0), dims), dims)

    state, run_dir = finetune.main(_config(ds, ckpt, str(tmp / "torch")), device="cpu")
    with stubbed_inverse_mel():
        from whisper_finetune_tpu.scripts.finetune import main as j_main

        j_main(_config(ds, ckpt, str(tmp / "jax")))
    (j_run,) = [tmp / "jax" / d for d in os.listdir(tmp / "jax")]
    return {"torch": Path(run_dir), "jax": j_run, "state": state, "ckpt": ckpt, "ds": ds,
            "tmp": tmp}


def test_driver_metrics_keys_match_jax(runs):
    got, want = _records(runs["torch"]), _records(runs["jax"])
    assert sorted(set().union(*got)) == sorted(set().union(*want)) == KEYS
    assert [r["_step"] for r in got] == [r["_step"] for r in want] == [0, 1, 2, 2]
    train = [r for r in got if "Train loss" in r]
    assert len(train) == 2 and all(np.isfinite(r["Train loss"]) for r in train)
    hist = train[-1]["grads_hist/decoder.tok_emb"]
    assert hist["_type"] == "histogram" and len(hist["counts"]) == 64
    assert len(hist["edges"]) == 65 and sum(hist["counts"]) == 51865 * 32
    assert train[-1]["perf/samples_per_sec"] == pytest.approx(
        8 / train[-1]["perf/step_time_s"])


def test_driver_checkpoint_layout_matches_jax(runs):
    files = {side: sorted(os.listdir(runs[side])) for side in ("torch", "jax")}
    assert files["torch"] == files["jax"]
    for name in files["torch"]:
        if not name.endswith(".pt"):
            continue
        got = torch.load(runs["torch"] / name, weights_only=True)
        want = torch.load(runs["jax"] / name, weights_only=True)
        assert got["dims"] == want["dims"]
        assert list(got["model_state_dict"]) == list(want["model_state_dict"])
        for k, v in got["model_state_dict"].items():
            w = want["model_state_dict"][k]
            assert (v.shape, v.dtype) == (w.shape, w.dtype), k
    # last_model.pt is the fp16 cast of the final parameters
    from whisper_finetune_torch.models import load_model

    back, _ = load_model(str(runs["torch"] / "last_model.pt"), device="cpu")
    assert all(torch.equal(b, a.detach().half().float())
               for (_, a), (_, b) in zip(runs["state"].model.leaves(), back.leaves()))


def test_driver_step0_val_loss_matches_jax(runs):
    (got,) = [r["val/debug_loss"] for r in _records(runs["torch"]) if r["_step"] == 0]
    (want,) = [r["val/debug_loss"] for r in _records(runs["jax"]) if r["_step"] == 0]
    assert abs(got - want) <= 1e-2 * abs(want)


def test_driver_profile_trace(runs, monkeypatch):
    """``WFT_PROFILE_DIR``: a torch.profiler Chrome trace of steps 3-8, cut at
    the last step of a shorter run (3 here)."""
    from whisper_finetune_torch.scripts import finetune

    config = _config(runs["ds"], runs["ckpt"], str(runs["tmp"] / "profiled"))
    config["dataset"]["train_datasets"] = [runs["ds"]] * 2  # 32 samples: 4 steps
    config["training"]["epochs"] = 0.75  # 3 steps
    monkeypatch.setenv("WFT_PROFILE_DIR", str(runs["tmp"] / "trace"))
    state, _ = finetune.main(config, device="cpu")
    assert state.step == 3
    trace = json.loads((runs["tmp"] / "trace" / "trace.json").read_text())
    assert any("attn" in e.get("name", "") or "aten::" in e.get("name", "")
               for e in trace["traceEvents"])


@pytest.mark.parametrize("key", ["zero_shard_optimizer", "ddp_find_unused_parameters",
                                 "resume_from", "save_train_state"])
def test_parallel_and_resume_training_keys_run(runs, key):
    """The keys the port once refused (ROADMAP items 12 and 15) run: in one
    process ZeRO-1 has no other rank to shard over and the DDP key is
    ignored as in JAX, so the first step's loss is the plain run's;
    ``save_train_state`` writes ``train_state.pt`` at the eval step;
    ``resume_from`` continues from it on the same step clock (one step
    saved, the second run trains step 2 alone)."""
    from whisper_finetune_torch.optim.optimizers import AdamState
    from whisper_finetune_torch.scripts import finetune
    from whisper_finetune_torch.train.state_io import load_train_state

    def config(tag, epochs=0.5, **training):
        c = _config(runs["ds"], runs["ckpt"], str(runs["tmp"] / key / tag))
        c["dataset"]["val_datasets"] = []  # no eval: only the keys' own work
        c["training"].update(epochs=epochs, **training)
        return c

    base = [r["Train loss"] for r in _records(runs["torch"]) if "Train loss" in r][0]
    if key in ("zero_shard_optimizer", "ddp_find_unused_parameters"):
        state, run_dir = finetune.main(config("run", **{key: True}), device="cpu")
        (loss,) = [r["Train loss"] for r in _records(run_dir) if "Train loss" in r]
        assert loss == base and state.step == 1
        assert isinstance(state.opt_state, AdamState)
        assert all(m.shape == p.shape for m, (_, p) in zip(state.opt_state.mu,
                                                           state.model.leaves()))
        return
    state, run_dir = finetune.main(config("saved", save_train_state=True), device="cpu")
    path = Path(run_dir) / "train_state.pt"
    assert path.is_file()
    assert load_train_state(str(path), state, _optimizer(state), zero_shard=False).step == 1
    if key == "save_train_state":
        return
    resumed, run_dir = finetune.main(config("resumed", epochs=1.0, resume_from=str(path)),
                                     device="cpu")
    assert resumed.step == resumed.opt_state.count == 2
    assert [r["_step"] for r in _records(run_dir) if "Train loss" in r] == [2]


def _optimizer(state):
    from whisper_finetune_torch.optim import get_optimizer

    return get_optimizer(state.model.leaves(), {"type": "adamw", "params": {"lr": 1e-4}})[0]


def test_one_chip_flagship_keys_train(runs, monkeypatch):
    """``config_large_v3_best_muon_1chip.yaml``'s optimizer and training keys
    (split step, manual backward, precast weights, bf16 accumulator, int8
    Muon momentum, 8-bit auxiliary AdamW, stochastic depth, deep
    SpecAugment) through ``main()`` on the CPU on the tests' small
    checkpoint: two optimizer steps through the split step and the manual
    backward, of 2 microbatches each (the YAML's 8 would only repeat them)."""
    from whisper_finetune_torch.scripts import finetune

    flagship = tc.load_config(ROOT / "configs" / "config_large_v3_best_muon_1chip.yaml")
    config = _config(runs["ds"], runs["ckpt"], str(runs["tmp"] / "one_chip"))
    config["dataset"]["val_datasets"] = []
    config["optimizer"] = flagship["optimizer"]
    for key in ("split_optimizer_step", "manual_backward", "manual_precast_weights",
                "grad_accum_dtype", "stochastic_depth", "label_smoothing", "max_grad_norm"):
        config["training"][key] = flagship["training"][key]
    config["augmentation"] = {"deep_spec_augment": flagship["augmentation"]["deep_spec_augment"]}
    config["training"].update(accum_grad_steps=2, epochs=0.25)  # 4 of the 16 samples
    built = []
    make = finetune.make_train_step

    def recording(*args, **kwargs):
        built.append((kwargs, make(*args, **kwargs)))
        return built[-1][1]

    monkeypatch.setattr(finetune, "make_train_step", recording)
    state, run_dir = finetune.main(config, device="cpu")
    ((kwargs, step),) = built
    assert kwargs["split_update"] and kwargs["manual_backward"] and kwargs["manual_precast"]
    assert step.last_timing is not None and step._grad_buf is not None
    assert state.step == state.opt_state.count == 2
    losses = [r["Train loss"] for r in _records(run_dir) if "Train loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
