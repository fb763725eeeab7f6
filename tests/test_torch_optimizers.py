"""The port's optimizer factory against the JAX package's ``get_optimizer``:
labels, LR metadata, the adam / adamw / 8-bit switches, warnings and errors,
and the Muon + auxiliary-AdamW partition, each over a few updates against
JAX's ``tx.update`` + ``optax.apply_updates`` on a tiny parameter tree with a
learning-rate schedule read from the optimizer's count.

Tolerances: float32 Adam moments and parameters agree to float32 rounding
(1e-6 absolute on O(1) values at lr 1e-2). 8-bit state as in
test_torch_optim.py (codes one level, a flipped code moves p by a fraction
of lr). Muon leaves as in test_torch_muon.py: 5% relative Frobenius error of
the update."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from whisper_finetune_tpu.optim import optimizers as jo
from whisper_finetune_tpu.optim.schedulers import get_schedule as j_schedule
from whisper_finetune_torch.models.whisper import flatten
from whisper_finetune_torch.optim import optimizers as to
from whisper_finetune_torch.optim.quantized import AdamW8bit, QMoment
from whisper_finetune_torch.optim.schedulers import get_schedule as t_schedule

SCHED = {"type": "cosine", "warmup_steps": 2}
TRAIN_STEPS = 10


def _tree(rng):
    def a(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    return {
        "encoder": {
            "conv1": {"w": a(3, 8, 64), "b": a(64)},
            "blocks": {"attn": {"q_w": a(2, 64, 64), "q_b": a(2, 64)},
                       "mlp": {"fc1_w": a(2, 64, 128), "fc2_w": a(2, 128, 64)}},
        },
        "decoder": {"tok_emb": a(100, 64),
                    "blocks": {"attn_ln": {"scale": a(2, 64)}, "attn": {"o_w": a(2, 64, 64)}}},
    }


def _t_leaves(tree):
    return [(path, torch.from_numpy(np.array(a))) for path, a in flatten(tree)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_labels_match_jax(threshold):
    tree = _tree(np.random.default_rng(0))
    want = [lab for _, lab in flatten(jo.muon_param_labels(jax.tree.map(jnp.asarray, tree), threshold))]
    assert to.muon_param_labels(tree, threshold) == want
    assert to.muon_param_labels(_t_leaves(tree), threshold) == want
    if threshold == 2:
        assert want.count("muon") == 4 and "adamw" in want


@pytest.mark.parametrize("match", [True, False])
def test_metadata_matches_jax(match, capsys):
    tree = _tree(np.random.default_rng(0))
    conf = {"muon": True, "muon_params": {"lr": 0.02}, "params": {"lr": 3e-4},
            "muon_match_adamw_update_rms": match, "muon_match_factor": 0.3}
    _, jmeta = jo.get_optimizer(jax.tree.map(jnp.asarray, tree), conf)
    jout = capsys.readouterr().out
    _, tmeta = to.get_optimizer(_t_leaves(tree), conf)
    assert capsys.readouterr().out == jout  # the same notices
    assert tmeta == jmeta
    assert {m.get("bucket") for m in tmeta} == {(2, 64), (2, 128), None}


def _run_jax(tree, conf, grads):
    params = jax.tree.map(jnp.asarray, tree)
    tx, _ = jo.get_optimizer(params, conf, j_schedule(SCHED, TRAIN_STEPS))
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, params), state


def _run_torch(tree, conf, grads, g_scale=None):
    leaves = _t_leaves(tree)
    tx, _ = to.get_optimizer(leaves, conf, t_schedule(SCHED, TRAIN_STEPS))
    params = [p for _, p in leaves]
    state = tx.init(params)
    for g in grads:
        gl = [torch.from_numpy(a) for _, a in flatten(g)]
        state = tx.fused_apply(gl, state, params, g_scale=g_scale)
    return dict(leaves), tx, state


def _grads(tree, n, seed=1):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
            for _ in range(n)]


@pytest.mark.parametrize("otype", ["adam", "adamw"])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adam_and_adamw_match_jax(otype, wd, capsys):
    tree = _tree(np.random.default_rng(2))
    conf = {"type": otype, "params": {"lr": 1e-2, "betas": [0.9, 0.98], "eps": 1e-6,
                                      "weight_decay": wd}}
    grads = _grads(tree, 3)
    jp, _ = _run_jax(tree, conf, grads)
    tp, tx, state = _run_torch(tree, conf, grads)
    assert isinstance(tx, to.Adam) and tx.decoupled == (otype == "adamw")
    assert state.count == 3
    for path, a in flatten(jp):
        np.testing.assert_allclose(tp[path].numpy(), a, atol=1e-6, rtol=0, err_msg=str(path))
    # the schedule is read at the count before each update
    sched = t_schedule(SCHED, TRAIN_STEPS)
    assert [tx.lr(c) for c in range(3)] == [1e-2 * sched(c) for c in range(3)]
    assert tx.lr(0) == 0.0 and tx.lr(2) == pytest.approx(1e-2)


def test_adam_defaults_match_torch_optim():
    # unspecified hyperparameters are torch's: Adam wd 0, AdamW wd 0.01
    tx_a, meta = to.get_optimizer([], {"type": "adam"})
    tx_w, _ = to.get_optimizer([], {"type": "adamw", "params": {}})
    assert (tx_a.weight_decay, tx_w.weight_decay) == (0.0, 0.01)
    assert (tx_a.b1, tx_a.b2, tx_a.eps, tx_a.lr(0)) == (0.9, 0.999, 1e-8, 1e-3)
    assert meta == [{"lr_log_label": "adam", "base_lr_unscaled": 1e-3, "base_lr": 1e-3}]


@pytest.mark.parametrize("otype,wd", [("adamw", 0.01), ("adam", 0.0), ("adam", 0.05)])
def test_8bit_switch_matches_jax(otype, wd):
    tree = _tree(np.random.default_rng(3))
    conf = {"type": otype, "8bit": True, "params": {"lr": 1e-2, "weight_decay": wd}}
    grads = _grads(tree, 2)
    jp, _ = _run_jax(tree, conf, grads)
    tp, tx, state = _run_torch(tree, conf, grads)
    assert isinstance(tx, AdamW8bit) and tx.decoupled == (otype == "adamw")
    quantized = [isinstance(m, QMoment) for m in state.mu]
    assert quantized == [a.size >= 4096 for _, a in flatten(tree)] and any(quantized)
    lr = 1e-2
    n_all = n_off = 0
    for path, a in flatten(jp):
        dp = np.abs(tp[path].numpy() - a)
        assert dp.max() <= 0.15 * lr, path
        n_all, n_off = n_all + dp.size, n_off + int((dp > 1e-6).sum())
    assert n_off <= 2e-3 * n_all


@pytest.mark.parametrize("aux_8bit", [False, True])
@pytest.mark.parametrize("momentum_dtype", [None, "int8"])
def test_muon_partition_matches_jax(momentum_dtype, aux_8bit, capsys):
    tree = _tree(np.random.default_rng(4))
    conf = {"type": "adamw", "muon": True, "8bit": aux_8bit, "muon_aux_8bit": aux_8bit,
            "muon_params": {"lr": 1e-2, "momentum": 0.95, "weight_decay": 0.01},
            "params": {"lr": 1e-2, "weight_decay": 0.01, "betas": [0.9, 0.98], "eps": 1e-6},
            "muon_momentum_dtype": momentum_dtype}
    grads = _grads(tree, 3)  # three updates: warm-up lr 0, then two that move
    jp, _ = _run_jax(tree, conf, grads)
    tp, tx, state = _run_torch(tree, conf, grads)
    assert isinstance(tx, to.MuonWithAuxAdam) and state.count == 3
    assert state.muon.count == state.adamw.count == 3
    start = dict(flatten(tree))
    for (path, a), lab in zip(flatten(jp), tx.labels):
        got = tp[path].numpy()
        if lab == "muon":
            assert _rel(got - start[path], a - start[path]) <= 5e-2, path
        elif aux_8bit:
            assert np.abs(got - a).max() <= 0.15 * 1e-2, path
        else:
            np.testing.assert_allclose(got, a, atol=1e-6, rtol=0, err_msg=str(path))


def test_partition_g_scale_and_bf16_grads():
    """The step's contract: bf16 gradient sums and one float32 scalar."""
    tree = _tree(np.random.default_rng(5))
    conf = {"muon": True, "muon_params": {"lr": 1e-2}, "params": {"lr": 1e-2}}
    g = _grads(tree, 1)[0]
    leaves = _t_leaves(tree)
    tx, _ = to.get_optimizer(leaves, conf)
    half = jax.tree.map(lambda a: (a * 2).astype(np.float32), g)
    p1 = [p.clone() for _, p in leaves]
    p2 = [p.clone() for _, p in leaves]
    tx.fused_apply([torch.from_numpy(a).bfloat16() for _, a in flatten(half)], tx.init(p1), p1,
                   g_scale=torch.tensor(0.5))
    tx.fused_apply([torch.from_numpy(a).bfloat16().float() / 2 for _, a in flatten(half)],
                   tx.init(p2), p2)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="leaves for"):
        tx.fused_apply([], tx.init(p1), p1)


@pytest.mark.parametrize("conf,is_lora", [
    ({"type": "adamw", "8bit": True}, True),
    ({"type": "adam", "muon": True}, False),
    ({"type": "adamw", "muon": True, "8bit": True}, False),
    ({"muon": True, "params": {"amsgrad": False}}, False),
    ({"type": "muon"}, False),
])
def test_warnings_match_jax(conf, is_lora, capsys):
    tree = _tree(np.random.default_rng(6))
    jo.get_optimizer(jax.tree.map(jnp.asarray, tree), conf, is_lora_run=is_lora)
    want = capsys.readouterr().out
    to.get_optimizer(_t_leaves(tree), conf, is_lora_run=is_lora)
    assert capsys.readouterr().out == want
    if conf != {"type": "muon"}:
        assert "WARNING" in want


@pytest.mark.parametrize("conf,match", [
    ({"type": "sgd"}, "Unknown optimizer type: sgd"),
    ({"type": None}, "Unknown optimizer type"),
    ({"muon": True, "muon_ndim_threshold": 0}, "muon_ndim_threshold must be >= 1"),
    ({"muon": True, "muon_match_factor": 0.0}, "muon_match_factor must be > 0"),
    ({"muon": True, "muon_ns_coeffs": "nope"}, "unknown ns_coeffs"),
    ({"muon": True, "muon_ns_coeffs": "polar_express", "muon_ns_steps": 9}, "at most 7"),
])
def test_errors_match_jax(conf, match):
    tree = _tree(np.random.default_rng(6))
    with pytest.raises(ValueError, match=match):
        to.get_optimizer(_t_leaves(tree), conf)
    if "ns_" not in match and "at most" not in match:  # JAX raises these at first update
        with pytest.raises(ValueError, match=match):
            jo.get_optimizer(jax.tree.map(jnp.asarray, tree), conf)


def test_data_parallel_muon_raises():
    """``get_optimizer`` hands the data axis to Muon as JAX's does (the
    driver passes it without ZeRO): the Muon half shards over 2 ranks, the
    auxiliary AdamW is untouched, and an update outside a 2-rank process
    group raises."""
    leaves = _t_leaves(_tree(np.random.default_rng(0)))
    tx, _ = to.get_optimizer(leaves, {"muon": True}, data_shard_axis="data", data_axis_size=2)
    assert tx.muon.shard_n == 2
    params = [p for _, p in leaves]
    with pytest.raises(RuntimeError, match="sharded over 2 ranks"):
        tx.fused_apply([torch.zeros_like(p) for p in params], tx.init(params), params)
    plain, _ = to.get_optimizer(leaves, {"muon": True})
    assert plain.muon.shard_n == 1
