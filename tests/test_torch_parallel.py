"""Data parallelism across processes (``parallel/``, the DP and ZeRO-1
branches of ``train/step.py``, ``train/zero.py``, Muon's sharded
Newton-Schulz) against the JAX package's data-mesh step.

The port's ranks are two ``gloo`` processes on the CPU
(``torch_dist_worker.run_ranks``: they import no JAX); the JAX step runs in
this process on a 2-device sub-mesh of the 8 CPU devices ``conftest.py``
forces, on the same weights (``params_from_jax``) and the same global
batches, whose rows JAX splits over its data axis as each port rank takes
its own rows. Mel inputs and no stochastic depth, so no per-rank random
draw enters. The port's one-process step over the same microbatches
(``accum`` x 2 of half the rows) is the second reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from torch_dist_worker import one_process, run_ranks, split_rows
from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions, init_params
from whisper_finetune_tpu.optim import get_optimizer as j_get_optimizer
from whisper_finetune_tpu.optim.quantized import _QMoment
from whisper_finetune_tpu.train.step import (
    TrainState,
    _zero_opt_partition_specs,
    make_train_step,
    partition_params,
    shard_batch,
    zero_state_sharding,
)
from whisper_finetune_torch import parallel
from whisper_finetune_torch.models import params_from_jax
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import flatten
from whisper_finetune_torch.optim import get_optimizer as t_get_optimizer
from whisper_finetune_torch.train.zero import zero_opt_partition

N = 2
DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_head=2, n_audio_layer=N,
    n_vocab=128, n_text_ctx=16, n_text_head=2, n_text_state=32, n_text_layer=N,
)
FCFG = dict(compute_dtype="float32")
ADAMW8 = {"type": "adamw", "8bit": True, "params": {"lr": 1e-3, "weight_decay": 0.0}}
ADAMW = {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.01}}
MUON = {"type": "adamw", "muon": True, "8bit": False,
        "muon_params": {"lr": 0.01, "momentum": 0.95}, "params": {"lr": 1e-3}}


def _mesh():
    return Mesh(np.array(jax.devices()[:N]), ("data",))


def _batches(dims, steps, accum=1, rows=8, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        out.append({
            "mel": rng.standard_normal((accum, rows, dims.n_mels, dims.n_audio_ctx * 2)
                                       ).astype(np.float32),
            "dec_input": rng.integers(0, dims.n_vocab, (accum, rows, dims.n_text_ctx)
                                      ).astype(np.int32),
            "dec_output": rng.integers(0, dims.n_vocab, (accum, rows, dims.n_text_ctx)
                                       ).astype(np.int32),
        })
    return out


def _params(seed, dims):
    """JAX's random weights as numpy (each run builds its own arrays: the
    JAX step donates its state)."""
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed), dims))


def _spec(params, dims, conf, batches, **kw):
    return dict(params=params, dims=dims.to_dict(), fcfg=FCFG, opt=conf, batches=batches, **kw)


def _jax_run(params, dims, conf, batches, zero=False, accum_dtype=None, max_grad_norm=1.0,
             hist_every=None):
    mesh = _mesh()
    trainable, frozen = partition_params(jax.tree.map(jnp.asarray, params), None)
    tx, _ = j_get_optimizer(trainable, conf, data_shard_axis=None if zero else "data",
                            data_axis_size=1 if zero else N)
    state = TrainState(trainable, frozen, tx.init(trainable), jnp.zeros((), jnp.int32))
    kw = {}
    if zero:
        state = jax.device_put(state, zero_state_sharding(mesh, state))
        kw = dict(zero_shard=True, zero_opt_state=state.opt_state, zero_params=state.trainable)
    step = make_train_step(mesh, dims, JFC(**FCFG), tx, max_grad_norm=max_grad_norm,
                           accum_dtype=accum_dtype, grad_hist_every=hist_every, **kw)
    losses, states = [], []
    for b in batches:
        out = step(state, shard_batch(mesh, jax.tree.map(jnp.asarray, b)), jax.random.PRNGKey(0))
        state = out[0]
        losses.append(float(out[1]))
        states.append(jax.tree.map(np.array, state))  # copies: the next step donates state
    return losses, states


def _jax_moments(jstate, tparams_paths):
    """JAX's moments by parameter path: [mu, nu] (8-bit or float32 Adam)."""
    adam = jstate.opt_state[0]
    mu = dict(flatten(adam.mu)) if isinstance(adam.mu, dict) else None
    nu = dict(flatten(adam.nu))
    return {path: [mu[path], nu[path]] for path in tparams_paths}


def _assert_ranks_equal(res):
    for step_params in zip(*(r["params"] for r in res)):
        for k in step_params[0]:
            for other in step_params[1:]:
                assert np.array_equal(step_params[0][k], other[k]), k


def _close_to_jax(got_params, want, lr, frac=2e-3):
    """The tolerance of test_torch_train_step: parameters within 15% of lr,
    at most ``frac`` of the elements beyond 0.1% of lr (1e-6 at its lr 1e-3;
    bf16 accumulator ulps and 8-bit codes a level apart move an element by a
    fraction of lr).
    ``want``: a JAX parameter tree, or a rank's result's parameters."""
    jp = {tuple(k.split(".")): v for k, v in want.items()} if "." in next(iter(want)) \
        else dict(flatten(want))
    n_all = n_off = 0
    for key, got in got_params.items():
        dp = np.abs(got - jp[tuple(key.split("."))])
        assert dp.max() <= 0.15 * lr, key
        n_all, n_off = n_all + dp.size, n_off + int((dp > 1e-3 * lr).sum())
    assert n_off <= frac * n_all


def _codes_close(got, want, levels):
    codes, scale = got
    assert np.abs(codes.astype(int) - np.asarray(want.codes).astype(int)).max() <= levels
    np.testing.assert_allclose(scale, np.asarray(want.scale), rtol=levels / 127, atol=1e-12)


@pytest.mark.parametrize("conf,accum", [(ADAMW8, 1), (ADAMW, 1), (ADAMW8, 2)],
                         ids=["adamw8", "adamw", "adamw8_accum2"])
def test_data_parallel_step_matches_jax_and_one_process(conf, accum, tmp_path):
    """World 2, bf16 accumulator, clip 1.0, two steps (as in
    test_torch_train_step's step test): every rank holds the
    same parameters after every step; losses and parameters match JAX's
    2-device step (losses to 2e-6 relative, parameters to 15% of lr). With
    one microbatch a rank they are bit-equal to the port's one process with
    accum 2 of half the rows: the same microbatches and the same bf16 sums.
    With two a rank the one process adds its four microbatches in another
    order, so Adam's normalised update moves elements whose gradient is near
    zero by up to 2 lr (measured), and only its first loss, before any
    update, is held (to 1e-6)."""
    lr = conf["params"]["lr"]
    params = _params(0, DIMS)
    batches = _batches(DIMS, 2, accum=accum)
    kw = dict(accum_dtype="bfloat16", max_grad_norm=1.0)
    res = run_ranks("steps", _spec(params, DIMS, conf, batches, **kw), N, tmp_path)
    _assert_ranks_equal(res)
    jlosses, jstates = _jax_run(params, DIMS, conf, batches, **kw)
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=2e-6)
    _close_to_jax(res[0]["params"][-1], jstates[-1].trainable, lr)
    ref = one_process("steps", _spec(params, DIMS, conf, split_rows(batches, N), **kw))
    np.testing.assert_allclose(res[0]["losses"][0], ref["losses"][0], rtol=1e-6)
    if accum == 1:
        assert res[0]["losses"] == ref["losses"]
        for k, v in ref["params"][-1].items():
            assert np.array_equal(res[0]["params"][-1][k], v), k
    # one reduction of the gradient sums a step (one all_reduce a leaf), plus
    # the loss's: no reduce-scatter, no gather
    n_leaves = len(ref["flags"])
    assert res[0]["comm"]["all_reduce"]["calls"] == 2 * (n_leaves + 1)
    assert res[0]["comm"]["reduce_scatter_rows"]["calls"] == 0


@pytest.mark.parametrize("conf,lr", [(ADAMW, 1e-2), (ADAMW8, 1e-3)], ids=["adamw", "adamw8"])
def test_zero_step_matches_jax(conf, lr, tmp_path):
    """ZeRO-1 at world 2, the setups of tests/test_train_step.py (float32
    AdamW lr 1e-2 wd 0.01; 8-bit AdamW lr 1e-3), clip 1.0, bf16 accumulator,
    three steps, gradient histograms every step, against JAX's
    ``zero_shard=True`` step: losses to 2e-6 relative, parameters to 15% of
    lr; 8-bit codes at most 1 level from JAX's after one update (ROADMAP
    queue 3 f). Against the port's own replicated step (one process over the
    same microbatches, on one thread as each rank runs) everything is
    bit-equal: each rank's moments after one update are row slices of its
    state, the parameters after every step are its parameters, and the
    histograms' counts are its counts."""
    params = _params(2 if conf is ADAMW else 3, DIMS)
    batches = _batches(DIMS, 3, seed=5)
    kw = dict(accum_dtype="bfloat16", max_grad_norm=1.0)
    res = run_ranks("steps", _spec(params, DIMS, conf, batches, zero=True, hist_every=1, **kw),
                    N, tmp_path)
    _assert_ranks_equal(res)
    jlosses, jstates = _jax_run(params, DIMS, conf, batches, zero=True, **kw)
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=2e-6)
    _close_to_jax(res[0]["params"][-1], jstates[-1].trainable, lr)

    ref = one_process("steps", _spec(params, DIMS, conf, split_rows(batches, N), hist_every=1,
                                     **kw))
    flags = res[0]["flags"]
    assert sum(flags) > 0 and not all(flags)  # conv kernels (3, ...) stay whole
    paths = [".".join(p) for p, _ in flatten(params)]
    jm = _jax_moments(jstates[0], [tuple(p.split(".")) for p in paths])
    for r, rank_res in enumerate(res):
        for i, (path, f) in enumerate(zip(paths, flags)):
            for got, whole, want in zip(rank_res["moments"][0][i], ref["moments"][0][i],
                                        jm[tuple(path.split("."))]):
                rows = (tuple(parallel.shard_rows(x, N, r) for x in whole)
                        if isinstance(whole, tuple) else parallel.shard_rows(whole, N, r)) \
                    if f else whole
                if isinstance(got, tuple):  # 8-bit: (codes, scale)
                    assert all(np.array_equal(a, b) for a, b in zip(got, rows)), path
                    want = _QMoment(*(parallel.shard_rows(np.asarray(x), N, r) if f
                                      else np.asarray(x) for x in want))
                    _codes_close(got, want, 1)
                else:
                    assert np.array_equal(got, rows), path
    for a, b in zip(res[0]["params"], ref["params"]):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    for got, want in zip(res[0]["hists"], ref["hists"]):
        assert got.keys() == want.keys()
        for name in got:
            assert np.array_equal(got[name][0], want[name][0]), name
    # ZeRO's collectives: a reduce-scatter and a gather a shard, an
    # all-reduce a whole leaf
    comm = res[0]["comm"]
    assert (comm["reduce_scatter_rows"]["calls"] == comm["all_gather_rows"]["calls"]
            == 3 * sum(flags))


def _partition_case(dims, conf, n):
    params = _params(0, dims)
    trainable, _ = partition_params(jax.tree.map(jnp.asarray, params), None)
    jtx, _ = j_get_optimizer(trainable, conf)
    specs = _zero_opt_partition_specs(jax.eval_shape(jtx.init, trainable), trainable, n)
    model = params_from_jax(params, TDims(**dims.to_dict()), device="cpu")
    ttx, _ = t_get_optimizer(model.leaves(), conf)
    leaves = [p for _, p in model.leaves()]
    flags = zero_opt_partition(ttx, ttx.init(leaves), leaves, n)
    got = {path: f for (path, _), f in zip(model.leaves(), flags)}
    # JAX's specs of the moments each parameter owns (path suffix = param path)
    want = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, _QMoment))
    for kpath, spec in flat:
        keys = tuple(getattr(k, "key", getattr(k, "name", k)) for k in kpath)
        owner = next((keys[i:] for i in range(len(keys)) if keys[i:] in got), None)
        if owner is None:
            assert spec == jax.sharding.PartitionSpec(), keys  # counts replicate
            continue
        spec = spec.codes if isinstance(spec, _QMoment) else spec
        want.setdefault(owner, set()).add(spec == jax.sharding.PartitionSpec("data"))
    return got, want


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("conf", [
    ADAMW8,
    {"type": "adamw", "muon": True, "8bit": True, "muon_params": {"lr": 1e-4, "momentum": 0.95},
     "params": {"lr": 1e-4}, "muon_momentum_dtype": "int8", "muon_aux_8bit": True},
], ids=["adamw8", "muon_int8_aux8"])
def test_zero_partition_matches_jax_specs(conf, n):
    """``zero_opt_partition`` against ``_zero_opt_partition_specs``: a
    parameter's moments shard iff it does (the Muon + auxiliary partition
    of test_zero_opt_specs_param_associated_for_muon_partition included);
    conv kernels (leading axis 3) stay whole, stacked block state shards,
    counts replicate."""
    dims = DIMS.replace(n_audio_state=64, n_text_state=64, n_audio_layer=n, n_text_layer=n)
    got, want = _partition_case(dims, conf, n)
    for path, flag in got.items():
        assert want[path] == {flag}, path
    assert got[("encoder", "conv2", "w")] is False
    assert any(f for path, f in got.items() if "blocks" in path)


# Widths at which tok_emb (200 x 48) is quantized and its half (4800
# elements) is not a multiple of 256: JAX still slices its 38 blocks in two.
MISALIGNED = DIMS.replace(n_vocab=200, n_audio_state=48, n_text_state=48)


def test_zero_partition_keeps_a_misaligned_quantized_leaf_whole():
    """The one departure from ``_zero_opt_partition_specs``: 8-bit state
    whose shard would not end on a 256-element block boundary."""
    got, want = _partition_case(MISALIGNED, ADAMW8, N)
    diff = [path for path, flag in got.items() if want[path] != {flag}]
    assert diff == [("decoder", "tok_emb")]
    assert want[("decoder", "tok_emb")] == {True} and got[("decoder", "tok_emb")] is False


def test_zero_8bit_misaligned_leaf_departs_in_jax_not_in_port(tmp_path):
    """ROADMAP queue 3, reference fault: JAX's ZeRO step slices the (38, 256)
    8-bit blocks of tok_emb (200 x 48) over 2 devices although each half of
    the leaf holds 4800 elements, then requantizes each half on blocks of
    its own, so after one update its codes no longer are the replicated
    step's (the second half sits 64 elements off). The port keeps that leaf
    whole: its codes stay within 1 level of JAX's replicated step, as every
    other leaf's do."""
    params = _params(1, MISALIGNED)
    batches = _batches(MISALIGNED, 1, seed=6)
    kw = dict(accum_dtype="bfloat16", max_grad_norm=1.0)
    _, rep = _jax_run(params, MISALIGNED, ADAMW8, batches, **kw)
    _, zero = _jax_run(params, MISALIGNED, ADAMW8, batches, zero=True, **kw)
    res = run_ranks("steps", _spec(params, MISALIGNED, ADAMW8, batches, zero=True, **kw), N,
                    tmp_path)
    key = ("decoder", "tok_emb")
    rep_mu = dict(flatten(rep[0].opt_state[0].mu))[key]
    zero_mu = dict(flatten(zero[0].opt_state[0].mu))[key]
    gap = np.abs(np.asarray(zero_mu.codes).astype(int) - np.asarray(rep_mu.codes).astype(int))
    assert gap.max() > 2  # JAX against itself
    paths = [p for p, _ in flatten(params)]
    i = paths.index(key)
    assert res[0]["flags"][i] is False
    _codes_close(res[0]["moments"][0][i][0], rep_mu, 1)  # the port against JAX replicated


def test_sharded_muon_matches_jax_and_unsharded(tmp_path):
    """Muon's Newton-Schulz split over the layer axis of 2 ranks (the setup
    of test_train_step_with_sharded_muon: Muon lr 0.01, auxiliary AdamW
    lr 1e-3, clip 1.0, float32 gradients), three steps. After the first
    step, against JAX's sharded step, the Muon leaves sit within 10%
    relative Frobenius error of their movement (test_torch_train_step's
    flagship tolerance; measured 2.0%) and the AdamW leaves within 15% of
    lr; later steps hold the losses to 1e-3: at this lr, ten times the
    flagship test's, the bf16 iteration amplifies XLA's other float32
    rounding to 12-16% of a leaf's movement by step 3. Against the port's
    unsharded Muon (one process, one thread as each rank) every step is
    bit-equal. Each rank gathers one orthogonalised half a Muon leaf a
    step."""
    params = _params(0, DIMS)
    batches = _batches(DIMS, 3, seed=0)
    res = run_ranks("steps", _spec(params, DIMS, MUON, batches, shard_muon=True,
                                   max_grad_norm=1.0), N, tmp_path)
    _assert_ranks_equal(res)
    jlosses, jstates = _jax_run(params, DIMS, MUON, batches, max_grad_norm=1.0)
    ref = one_process("steps", _spec(params, DIMS, MUON, split_rows(batches, N), max_grad_norm=1.0))
    assert res[0]["losses"] == ref["losses"]
    for a, b in zip(res[0]["params"], ref["params"]):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    labels = res[0]["labels"]
    np.testing.assert_allclose(res[0]["losses"][:2], jlosses[:2], rtol=2e-6)
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=1e-3)
    jp = dict(flatten(jstates[0].trainable))
    for (path, start), lab in zip(flatten(params), labels):
        got = res[0]["params"][0][".".join(path)]
        if lab == "muon":
            moved = np.linalg.norm(jp[path] - start)
            assert np.linalg.norm(got - jp[path]) <= 1e-1 * moved, path
        else:
            assert np.abs(got - jp[path]).max() <= 0.15 * 1e-3, path
    n_muon = sum(lab == "muon" for lab in labels)
    assert res[0]["comm"]["all_gather_rows"]["calls"] == 3 * n_muon


def test_helpers_without_a_group_are_the_identity():
    """One process: no collective runs and nothing is counted; the row
    helpers slice as the ranks would."""
    import torch

    parallel.reset_counts()
    t = torch.arange(12.0).reshape(6, 2)
    assert parallel.world() == 1 and parallel.rank() == 0
    assert parallel.all_reduce(t) is t
    assert torch.equal(parallel.reduce_scatter_rows(t), t)
    assert torch.equal(parallel.all_gather_rows(t[:3], out=torch.empty(3, 2)), t[:3])
    assert torch.equal(parallel.shard_rows(t, 3, 1), t[2:4])
    assert parallel.zero_shardable(t, 3) and not parallel.zero_shardable(t, 4)
    assert not parallel.zero_shardable(torch.zeros(()), 1)
    assert all(c == {"calls": 0, "bytes": 0} for c in parallel.counts().values())
