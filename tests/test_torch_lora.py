"""The port's LoRA (``models/lora.py``, the hook in ``models/whisper.py``,
frozen partitions in ``train/step.py``) against the JAX package's, case for
case with ``tests/test_lora.py``: shapes and mask, scoping, a fresh adapter
is the identity, merge equals the runtime forward, removal, parameter
counts, training moves only the adapters, debug statistics. Adapters are
carried across from JAX by ``params_from_jax``, so both packages run on the
same values; dropout is held given JAX's own draws.

Tolerances: float32 logits within 1e-5 of the largest logit and gradients
within 1e-4 of a leaf's largest gradient (``test_torch_model.py``); merged
kernels within 1e-6 (a float32 product in another order); losses of two
training steps within 2e-6 relative (``test_torch_train_step.py``); after a
step, trained parameters within 15% of lr, with few elements beyond 1e-6
(``test_torch_train_step.py``: Adam's normalised step amplifies a float32
difference in a near-zero gradient). Inside the port, a merged model's logits equal
the runtime-LoRA logits bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_config import jax_finetune  # noqa: F401  (fixture)
from test_torch_model import jax_draws

from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_tpu.models import lora as JL
from whisper_finetune_tpu.models.whisper import forward_impl as j_forward
from whisper_finetune_tpu.train.step import TrainState as JState
from whisper_finetune_tpu.train.step import combine_params as j_combine
from whisper_finetune_tpu.train.step import make_train_step as j_make_step
from whisper_finetune_tpu.train.step import partition_params as j_partition
from whisper_finetune_tpu.train.step import shard_batch
from whisper_finetune_torch.models import init_params, params_from_jax
from whisper_finetune_torch.models import lora as TL
from whisper_finetune_torch.models.checkpoint import params_to_numpy
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import ForwardConfig as TFC
from whisper_finetune_torch.models.whisper import Whisper, flatten, lora_draw_width
from whisper_finetune_torch.optim import get_optimizer
from whisper_finetune_torch.train import (TrainState, build_trainable_mask, make_train_step,
                                          mark_trainable, trainable_leaves)

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_head=2, n_audio_layer=2,
    n_vocab=64, n_text_ctx=16, n_text_head=2, n_text_state=32, n_text_layer=2,
)
TD = TDims(**DIMS.to_dict())
F32 = dict(compute_dtype="float32")


@pytest.fixture()
def base_params():
    return jax_init_params(jax.random.PRNGKey(0), DIMS)


def _inputs(seed=0, B=1):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, DIMS.n_mels, DIMS.n_audio_ctx * 2)).astype(np.float32)
    toks = rng.integers(0, DIMS.n_vocab, (B, 8)).astype(np.int32)
    return mel, toks


def _tfwd(model, cfg, train=False, draws=None, seed=0):
    mel, toks = _inputs(seed)
    return model(torch.from_numpy(mel), torch.from_numpy(toks).long(), cfg, train=train,
                 draws=draws)


def _jfwd(params, cfg, seed=0):
    mel, toks = _inputs(seed)
    return np.asarray(j_forward(params, jnp.asarray(mel), jnp.asarray(toks), DIMS, cfg))


def _to_torch(params) -> Whisper:
    return params_from_jax(jax.tree.map(np.asarray, params), TD, device="cpu")


def _with_b(params, seed=8, group="attn", side="decoder", name="q_w_lora"):
    """JAX LoRA params with a non-zero B on one adapter."""
    params = jax.tree_util.tree_map(lambda x: x, params)
    b = params[side]["blocks"][group][name]["b"]
    params[side]["blocks"][group][name]["b"] = (
        b + 0.1 * jax.random.normal(jax.random.PRNGKey(seed), b.shape))
    return params


def _torch_base():
    return init_params(TD, device="cpu", seed=0).params()


def test_apply_lora_shapes_and_mask(base_params):
    jp, jmask = JL.apply_lora(base_params, rank=4, alpha=8)
    tp, tmask = TL.apply_lora(_torch_base(), rank=4, alpha=8)
    assert TL.has_lora(tp)
    got = [(path, tuple(a.shape)) for path, a in flatten(tp)]
    assert got == [(path, tuple(a.shape)) for path, a in flatten(jp)]
    assert [m for _, m in flatten(tmask)] == [bool(m) for _, m in flatten(jmask)]
    assert "cross_attn" not in tp["encoder"]["blocks"]
    fc1 = tp["decoder"]["blocks"]["mlp"]["fc1_w_lora"]
    assert fc1["a"].shape == (2, 32, 4) and fc1["b"].shape == (2, 4, 128)
    a = tp["encoder"]["blocks"]["mlp"]["fc2_w_lora"]["a"]  # minLoRA bound 1/sqrt(in)
    assert 0.9 / np.sqrt(128) < float(a.abs().max()) <= 1 / np.sqrt(128)
    assert float(fc1["b"].abs().max()) == 0.0


def test_lora_scoping(base_params):
    for kw in ({"encoder_only": True}, {"decoder_only": True}):
        jp, _ = JL.apply_lora(base_params, rank=2, alpha=4, **kw)
        tp, _ = TL.apply_lora(_torch_base(), rank=2, alpha=4, **kw)
        assert [p for p, _ in flatten(tp)] == [p for p, _ in flatten(jp)]
    with pytest.raises(ValueError, match="mutually exclusive"):
        TL.apply_lora(_torch_base(), encoder_only=True, decoder_only=True)


def test_fresh_lora_is_identity(base_params):
    """B = 0: the LoRA forward is the base forward, bit for bit (float32)."""
    model = Whisper(TD, _torch_base())
    tp, _ = TL.apply_lora(model.params(), rank=4, alpha=8)
    with torch.no_grad():
        base = _tfwd(model, TFC(**F32))
        lora = _tfwd(Whisper(TD, tp), TFC(lora_scale=TL.lora_scale(4, 8), **F32))
    assert torch.equal(base, lora)


def test_merge_matches_runtime_lora(base_params):
    """Runtime LoRA against JAX's; the port's merge against its runtime
    forward (bit-equal) and against JAX's merge."""
    jp, _ = JL.apply_lora(base_params, rank=4, alpha=8, key=jax.random.PRNGKey(7))
    jp = _with_b(jp)
    cfg = dict(lora_scale=JL.lora_scale(4, 8), **F32)
    ref = _jfwd(jp, JFC(**cfg))
    model = _to_torch(jp)
    with torch.no_grad():
        runtime = _tfwd(model, TFC(**cfg))
        merged = TL.merge_lora(model.params(), rank=4, alpha=8)
        merged_out = _tfwd(Whisper(TD, merged), TFC(**F32))
        base_out = _tfwd(Whisper(TD, TL.remove_lora(model.params())), TFC(**F32))
    assert np.abs(runtime.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert not torch.allclose(runtime, base_out, atol=1e-4)
    assert not TL.has_lora(merged)
    assert torch.equal(merged_out, runtime)
    jm = dict(flatten(jax.tree.map(np.asarray, JL.merge_lora(jp, rank=4, alpha=8))))
    tm = dict(flatten({k: v for k, v in params_to_numpy(Whisper(TD, merged)).items()}))
    assert tm.keys() == jm.keys()
    for path, want in jm.items():
        np.testing.assert_allclose(tm[path], want, atol=1e-6, rtol=0, err_msg=str(path))
    assert not np.allclose(tm[("decoder", "blocks", "attn", "q_w")],
                           np.asarray(base_params["decoder"]["blocks"]["attn"]["q_w"]))


def test_merge_bit_equal_in_bf16(base_params):
    """bf16 compute (the card's): the merged model, precast, gives the
    runtime-LoRA forward's logits bit for bit."""
    jp, _ = JL.apply_lora(base_params, rank=4, alpha=8, key=jax.random.PRNGKey(3))
    model = _to_torch(_with_b(_with_b(jp), seed=9, group="mlp", side="encoder", name="fc2_w_lora"))
    with torch.no_grad():
        runtime = _tfwd(model, TFC(compute_dtype="bfloat16", lora_scale=2.0))
        merged = Whisper(TD, TL.merge_lora(model.params(), rank=4, alpha=8))
        assert torch.equal(_tfwd(merged, TFC(compute_dtype="bfloat16")), runtime)


def test_remove_lora_restores_base(base_params):
    jp, _ = JL.apply_lora(base_params, rank=4, alpha=8)
    restored = TL.remove_lora(_to_torch(jp).params())
    assert not TL.has_lora(restored)
    want = flatten(jax.tree.map(np.asarray, JL.remove_lora(jp)))
    got = flatten(restored)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.detach().numpy(), b)


def test_lora_param_count_scales_with_rank(base_params):
    def count(rank):
        p, mask = TL.apply_lora(_torch_base(), rank=rank, alpha=2 * rank)
        return sum(leaf.numel() for (_, leaf), (_, m) in zip(flatten(p), flatten(mask)) if m)

    def jcount(rank):
        p, mask = JL.apply_lora(base_params, rank=rank, alpha=2 * rank)
        return sum(int(np.prod(leaf.shape)) for leaf, m in
                   zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(mask)) if m)

    assert count(8) == 2 * count(4) == jcount(8)


def _jax_lora_draws(rng, p_drop, lora_params):
    """The LoRA dropout uniforms JAX's forward draws (encoder layer key [2],
    decoder layer key [1], ``key, sub = split(key)`` per adapted kernel in
    sorted order, a (fan_in, 1) uniform each) on top of ``jax_draws``.
    Checks that ``u < 1 - p`` is JAX's Bernoulli mask."""
    base = jax_draws(rng, DIMS)
    enc_rng, dec_rng = jax.random.split(rng)
    _, layers_key = jax.random.split(enc_rng)
    keys = {"encoder": jax.random.split(layers_key, DIMS.n_audio_layer * 3).reshape(-1, 3, 2)[:, 2],
            "decoder": jax.random.split(dec_rng, DIMS.n_text_layer * 2).reshape(-1, 2, 2)[:, 1]}
    out = {}
    for side, cross in (("encoder", False), ("decoder", True)):
        blocks = lora_params[side]["blocks"]
        rows = []
        for key in keys[side]:
            us = []
            for group in sorted(blocks):
                for name in sorted(blocks[group]):
                    if name + "_lora" not in blocks[group]:
                        continue
                    key, sub = jax.random.split(key)
                    shape = (blocks[group][name + "_lora"]["a"].shape[1], 1)
                    u = np.asarray(jax.random.uniform(sub, shape))[:, 0]
                    np.testing.assert_array_equal(
                        u < np.float32(1.0 - p_drop),
                        np.asarray(jax.random.bernoulli(sub, 1.0 - p_drop, shape))[:, 0])
                    us.append(u)
            width = lora_draw_width(DIMS.n_text_state if cross else DIMS.n_audio_state, cross)
            row = np.concatenate(us) if us else np.zeros((0,), np.float32)
            rows.append(np.pad(row, (0, width - row.size), constant_values=0.5))
        out["enc_lora" if side == "encoder" else "dec_lora"] = np.stack(rows)
    return dataclasses.replace(base, **out)


@pytest.mark.parametrize("scope", [{}, {"encoder_only": True}])
def test_lora_dropout_matches_jax_draws(base_params, scope):
    """LoRA dropout 0.3 in a training forward, given JAX's draws: logits
    and the adapters' gradients."""
    jp, _ = JL.apply_lora(base_params, rank=4, alpha=8, key=jax.random.PRNGKey(2), **scope)
    jp = jax.tree_util.tree_map(lambda x: x, jp)
    for side in ("encoder", "decoder"):  # non-zero B everywhere
        for path, leaf in flatten(jp[side]["blocks"]):
            if path[-1] == "b":
                node = jp[side]["blocks"]
                for k in path[:-1]:
                    node = node[k]
                node["b"] = 0.05 * jax.random.normal(jax.random.PRNGKey(len(path)), leaf.shape)
    rng = jax.random.PRNGKey(11)
    kw = dict(lora_scale=2.0, lora_dropout=0.3, **F32)
    mel, toks = _inputs(1)
    cot = np.random.default_rng(2).standard_normal((1, 8, DIMS.n_vocab)).astype(np.float32)

    def jloss(p):
        logits = j_forward(p, jnp.asarray(mel), jnp.asarray(toks), DIMS, JFC(**kw), rng=rng,
                           train=True)
        return jnp.sum(logits * cot), logits

    (_, ref), ref_g = jax.value_and_grad(jloss, has_aux=True)(jp)
    model = _to_torch(jp)
    draws = _jax_lora_draws(rng, 0.3, jp)
    out = _tfwd(model, TFC(**kw), train=True, draws=draws, seed=1)
    ref = np.asarray(ref)
    assert np.abs(out.detach().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    plain = _tfwd(model, TFC(**{**kw, "lora_dropout": 0.0}), train=True, seed=1)
    assert float((plain - out).detach().abs().max()) > 1e-4  # the masks act
    leaves = [p for _, p in model.leaves()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    got = {path: g for (path, _), g in zip(model.leaves(), grads)}
    for path, g in flatten(jax.tree.map(np.asarray, ref_g)):
        if "_lora" in "".join(path):
            scale = max(np.abs(g).max(), 1e-3)
            np.testing.assert_allclose(got[path].numpy(), g, atol=1e-4 * scale, rtol=0,
                                       err_msg=str(path))


def _batch(accum=1, B=4, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "mel": rng.standard_normal((accum, B, DIMS.n_mels, DIMS.n_audio_ctx * 2)).astype(np.float32),
        "dec_input": rng.integers(0, DIMS.n_vocab, (accum, B, 8)).astype(np.int32),
        "dec_output": rng.integers(0, DIMS.n_vocab, (accum, B, 8)).astype(np.int32),
    }


def _two_steps(jp, jmask, t_config_mask, fcfg_kw, conf, accum=2):
    """Two steps of JAX's and the port's make_train_step from the same
    params and mask; returns (JAX final tree, port model, losses each)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    from whisper_finetune_tpu.optim.optimizers import get_optimizer as j_get_optimizer

    model = _to_torch(jp)
    jp = jax.tree.map(jnp.copy, jp)  # the JAX step donates its state
    trainable, frozen = j_partition(jp, jmask)
    jtx, _ = j_get_optimizer(trainable, conf)
    jstate = JState(trainable, frozen, jtx.init(trainable), jnp.zeros((), jnp.int32))
    jstep = j_make_step(mesh, DIMS, JFC(**fcfg_kw), jtx, 0.1, max_grad_norm=1.0)
    mark_trainable(model.params(), t_config_mask)
    j_paths = [tuple(k.key for k in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(trainable)[0]]
    assert [path for path, _ in trainable_leaves(model)] == j_paths
    ttx, _ = get_optimizer(trainable_leaves(model), conf)
    tstate = TrainState(model, ttx.init([p for _, p in trainable_leaves(model)]), 0)
    tstep = make_train_step(TD, TFC(**fcfg_kw), ttx, 0.1, max_grad_norm=1.0, device="cpu")
    jl, tl = [], []
    for i in range(2):
        b = _batch(accum, seed=i)
        jstate, loss = jstep(jstate, shard_batch(mesh, jax.tree.map(jnp.asarray, b)),
                             jax.random.PRNGKey(0))
        jl.append(float(loss))
        tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in b.items()}
        tstate, loss = tstep(tstate, tb)
        tl.append(float(loss))
    return j_combine(jstate.trainable, jstate.frozen), model, jl, tl


ADAMW = {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.0}}
LR = ADAMW["params"]["lr"]


def _moved_off(got, want, path):
    """(elements beyond 1e-6, elements) of a trained leaf against JAX's.
    Float32 gradients in another order flip the sign of a near-zero element
    now and then, and Adam's normalised step moves it by a fraction of lr:
    at most 15% of lr, as in test_torch_train_step.py."""
    d = np.abs(got - want)
    assert d.max() <= 0.15 * LR, path
    return int((d > 1e-6).sum()), d.size


def _assert_few_off(off):
    """Measured: 0.06-0.16% of the trained elements beyond 1e-6."""
    assert sum(n for n, _ in off) <= 5e-3 * sum(m for _, m in off)


def test_lora_training_only_moves_adapters(base_params):
    """Two LoRA steps (accumulation 2, clip 1.0, float32 AdamW) against
    JAX's: losses, the moved adapters, and base weights bit-equal to where
    they started."""
    jp, jmask = JL.apply_lora(base_params, rank=4, alpha=8)
    base = dict(flatten(jax.tree.map(np.asarray, JL.remove_lora(jp))))
    tmask = jax.tree.map(bool, jmask)
    jfinal, model, jl, tl = _two_steps(jp, jmask, tmask, dict(lora_scale=2.0, **F32), ADAMW)
    np.testing.assert_allclose(tl, jl, rtol=2e-6)
    want = dict(flatten(jax.tree.map(np.asarray, jfinal)))
    n_lora, off = 0, []
    for path, p in model.leaves():
        got = p.detach().numpy()
        if "_lora" in "".join(path):
            n_lora += 1
            off.append(_moved_off(got, want[path], path))
        else:
            assert not p.requires_grad
            np.testing.assert_array_equal(got, base[path])
    assert n_lora == 2 * (6 + 10)
    _assert_few_off(off)
    b = model.params()["decoder"]["blocks"]["attn"]["q_w_lora"]["b"]
    assert float(b.detach().abs().max()) > 0


@pytest.mark.parametrize("side", ["train_only_encoder", "train_only_decoder"])
def test_train_only_side_steps_match_jax(base_params, side, jax_finetune):  # noqa: F811
    """A whole side frozen (no LoRA): the mask is JAX's
    ``build_trainable_mask``; two steps against JAX's, the frozen side
    bit-equal to where it started."""
    t_config = {"train_only_encoder": side == "train_only_encoder",
                "train_only_decoder": side == "train_only_decoder"}
    start = dict(flatten(jax.tree.map(np.asarray, base_params)))
    jmask = jax_finetune.build_trainable_mask(base_params, t_config)
    model0 = _to_torch(base_params)
    tmask = build_trainable_mask(model0.params(), t_config)
    assert [(p, m) for p, m in flatten(tmask)] == [(p, bool(m)) for p, m in flatten(jmask)]
    frozen_side = "decoder" if side == "train_only_encoder" else "encoder"
    jfinal, model, jl, tl = _two_steps(base_params, jmask, tmask, F32, ADAMW)
    np.testing.assert_allclose(tl, jl, rtol=2e-6)
    want = dict(flatten(jax.tree.map(np.asarray, jfinal)))
    off = []
    for path, p in model.leaves():
        got = p.detach().numpy()
        if path[0] == frozen_side:
            np.testing.assert_array_equal(got, start[path])
        else:
            off.append(_moved_off(got, want[path], path))
    _assert_few_off(off)


def test_lora_debug_stats(base_params):
    jp, _ = JL.apply_lora(base_params, rank=4, alpha=8, key=jax.random.PRNGKey(1))
    jp = _with_b(jp)
    model = _to_torch(jp)
    tp = model.params()
    stats, want = TL.get_lora_param_stats(tp), JL.get_lora_param_stats(jp)
    assert stats.keys() == want.keys()
    for k in want:
        assert stats[k] == pytest.approx(want[k], rel=1e-6), k
    assert stats["lora_debug/num_adapters"] == 2 * 6 + 2 * 10
    fresh = TL.get_lora_param_stats(TL.apply_lora(_torch_base(), rank=4, alpha=8)[0])
    assert fresh["lora_debug/B_norm"] == 0 and fresh["lora_debug/A_norm"] > 0

    grads = {path: torch.ones_like(p) * 0.5 for path, p in model.leaves()}
    gstats = TL.get_lora_grad_stats(list(grads.items()))
    jg = JL.get_lora_grad_stats(jax.tree.map(lambda x: jnp.ones_like(x) * 0.5, jp))
    for k in jg:
        assert gstats[k] == pytest.approx(jg[k], rel=1e-6), k

    tracker, jtracker = TL.LoRAUpdateTracker(tp), JL.LoRAUpdateTracker(jp)
    assert tracker.update_and_stats(tp)["lora_debug/A_update_norm"] == 0
    jtracker.update_and_stats(jp)
    moved = jax.tree.map(lambda x: x + 0.01, jp)
    delta = tracker.update_and_stats(_to_torch(moved).params())
    jdelta = jtracker.update_and_stats(moved)
    for k in jdelta:
        assert delta[k] == pytest.approx(jdelta[k], rel=1e-5), k
    assert delta["lora_debug/B_update_norm"] > 0


def test_materialize_block_lora_matches_jax(base_params):
    """One layer's fold, with and without a dropout mask, against JAX's."""
    jp, _ = JL.apply_lora(base_params, rank=4, alpha=8, key=jax.random.PRNGKey(5))
    jp = _with_b(jp, group="attn", side="encoder")
    layer = jax.tree.map(lambda a: a[1], jp["encoder"]["blocks"])
    want = JL.materialize_block_lora(layer, 2.0)
    tl = {k: {n: torch.from_numpy(np.array(v)) if not isinstance(v, dict)
              else {m: torch.from_numpy(np.array(w)) for m, w in v.items()}
              for n, v in g.items()} for k, g in jax.tree.map(np.asarray, layer).items()}
    got = TL.materialize_block_lora(tl, 2.0)
    assert [p for p, _ in flatten(got)] == [p for p, _ in flatten(want)]
    for (path, a), (_, b) in zip(flatten(got), flatten(jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=0, err_msg=str(path))
    keep = torch.zeros(9 * DIMS.n_audio_state)  # every row dropped: the plain kernels
    dropped = TL.materialize_block_lora(tl, 2.0, 0.5, keep)
    assert torch.equal(dropped["attn"]["q_w"], tl["attn"]["q_w"])
