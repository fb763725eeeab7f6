"""The split step of ``whisper_finetune_torch/train/step.py`` (accumulation
into a persistent buffer, one reduction, the loss read, then the update;
``split_update``) against the port's one-pass step and the JAX package's
split step: bit-equal to the one-pass step after two steps (the same sums,
the same update), within ``test_torch_train_step.py``'s tolerances of JAX's
split step with the manual backward on the Muon flagship's optimizer, the
gradient histograms on the steps the state's own count says after a resume
from a saved train state, and inert under ZeRO at world 2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_model import jax_draws
from torch_dist_worker import one_process, run_ranks
from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_tpu.train.step import TrainState as JState
from whisper_finetune_tpu.train.step import make_train_step as j_make_step
from whisper_finetune_tpu.train.step import partition_params, shard_batch
from whisper_finetune_torch.models import params_from_jax
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import ForwardConfig as TFC
from whisper_finetune_torch.models.whisper import flatten
from whisper_finetune_torch.optim import get_optimizer
from whisper_finetune_torch.train import TrainState, make_train_step

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=40, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_vocab=300, n_text_ctx=24, n_text_state=64, n_text_head=2, n_text_layer=2,
)
TD = TDims(**DIMS.to_dict())
# The flagship's optimizer as bench.py runs it: int8 Muon momentum, 8-bit
# auxiliary AdamW; warm-up 1 of a cosine schedule.
MUON8 = {"type": "adamw", "muon": True, "8bit": True, "muon_ndim_threshold": 2,
         "muon_momentum_dtype": "int8", "muon_aux_8bit": True,
         "muon_params": {"lr": 1e-3, "momentum": 0.95, "weight_decay": 0.01},
         "params": {"lr": 1e-3, "weight_decay": 0.01, "betas": [0.9, 0.98], "eps": 1e-6,
                    "amsgrad": False}}
SD = dict(stochastic_depth=0.3, dsa_apply=True, dsa_time_mask_param=20,
          dsa_freq_mask_param=20)


def _batch(rng, accum, B=2):
    return {
        "mel": rng.standard_normal((accum, B, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32),
        "dec_input": rng.integers(0, DIMS.n_vocab, (accum, B, DIMS.n_text_ctx)).astype(np.int32),
        "dec_output": rng.integers(0, DIMS.n_vocab, (accum, B, DIMS.n_text_ctx)).astype(np.int32),
    }


def _torch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


def _tensors(obj):
    """Every tensor of an optimizer state, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    return []


def _run(split, manual, steps, accum, seed=0, hist_every=None, dtype="bfloat16"):
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed), DIMS))
    model = params_from_jax(params, TD, device="cpu")
    from whisper_finetune_torch.optim import get_schedule

    tx, _ = get_optimizer(model.leaves(), MUON8, get_schedule({"type": "cosine",
                                                              "warmup_steps": 1}, 8))
    state = TrainState(model, tx.init([p for _, p in model.leaves()]), 0)
    step = make_train_step(TD, TFC(compute_dtype=dtype, **SD), tx, 0.1, max_grad_norm=1.0,
                           accum_dtype="bfloat16", grad_hist_every=hist_every,
                           split_update=split, manual_backward=manual, manual_precast=manual,
                           device="cpu")
    rng = np.random.default_rng(7)
    gen = torch.Generator().manual_seed(11)
    losses, hists = [], []
    for _ in range(steps):
        out = step(state, _torch(_batch(rng, accum)), gen)
        state = out[0]
        losses.append(out[1].item())
        if hist_every:
            hists.append(out[2])
    return state, tx, step, losses, hists


@pytest.mark.parametrize("accum", [1, 2])
def test_split_step_bit_equal_to_fused(accum):
    fused, _, fstep, flosses, fh = _run(False, False, 2, accum, hist_every=2)
    split, _, sstep, slosses, sh = _run(True, False, 2, accum, hist_every=2)
    assert not hasattr(fstep, "last_timing")
    assert set(sstep.last_timing) == {"accum_s", "update_s"}
    assert min(sstep.last_timing.values()) > 0
    assert slosses == flosses
    assert split.step == fused.step == 2 and split.opt_state.count == fused.opt_state.count == 2
    for (path, a), (_, b) in zip(split.model.leaves(), fused.model.leaves()):
        assert torch.equal(a, b), path
    sa, fa = _tensors(split.opt_state), _tensors(fused.opt_state)
    assert len(sa) == len(fa) > 0
    assert all(torch.equal(a, b) for a, b in zip(sa, fa))
    for a, b in zip(sh, fh):  # step 1 zeros, step 2 the histograms
        assert a.keys() == b.keys()
        for k in a:
            assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k
    assert int(sh[1]["decoder.blocks"][0].sum()) > 0 and int(sh[0]["decoder.blocks"][0].sum()) == 0
    # the buffer persists across steps, zeroed after each update
    buf = sstep._grad_buf
    assert buf is not None and all(int(b.count_nonzero()) == 0 for b in buf)
    assert all(b.dtype == torch.bfloat16 for b in buf)


def test_split_manual_step_matches_jax_split_manual_step():
    """Three optimizer steps of JAX's split step with its manual backward and
    precast against the port's, float32 compute, accumulation 2, given JAX's
    draws. Tolerances of test_torch_train_step's flagship test (int8_aux8):
    losses 2e-6 while the parameters are the same, 1e-3 after; Muon leaves
    within 10% (Frobenius) of their total movement; AdamW leaves within 15%
    of lr per element, at most 3% of elements beyond 1e-6."""
    from whisper_finetune_tpu.optim.optimizers import get_optimizer as j_get_optimizer
    from whisper_finetune_tpu.optim.schedulers import get_schedule as j_get_schedule
    from whisper_finetune_torch.optim import get_schedule

    lr, accum, steps = 1e-3, 2, 3
    sched = {"type": "cosine", "warmup_steps": 1}
    kw = dict(compute_dtype="float32", **SD)
    params = jax_init_params(jax.random.PRNGKey(1), DIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), TD, device="cpu")
    start = {path: p.detach().clone().numpy() for path, p in model.leaves()}
    rng = np.random.default_rng(5)
    batches = [_batch(rng, accum) for _ in range(steps)]

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    trainable, frozen = partition_params(params, None)
    jtx, _ = j_get_optimizer(trainable, MUON8, j_get_schedule(sched, 8))
    jstate = JState(trainable, frozen, jtx.init(trainable), jnp.zeros((), jnp.int32))
    jstep = j_make_step(mesh, DIMS, JFC(**kw), jtx, 0.1, max_grad_norm=1.0,
                        accum_dtype="bfloat16", split_update=True, manual_backward=True,
                        manual_precast=True)
    key = jax.random.PRNGKey(0)
    jlosses, all_draws = [], []
    for i, b in enumerate(batches):
        dev_rng = jax.random.fold_in(jax.random.fold_in(key, 0), i)  # device 0, step i
        all_draws.append([jax_draws(r, DIMS) for r in jax.random.split(dev_rng, accum)])
        jstate, loss = jstep(jstate, shard_batch(mesh, jax.tree.map(jnp.asarray, b)), key)
        jlosses.append(float(loss))
        jp = jax.tree.map(np.array, jstate.trainable)  # the next step donates the state

    ttx, _ = get_optimizer(model.leaves(), MUON8, get_schedule(sched, 8))
    tstate = TrainState(model, ttx.init([p for _, p in model.leaves()]), 0)
    tstep = make_train_step(TD, TFC(**kw), ttx, 0.1, max_grad_norm=1.0, accum_dtype="bfloat16",
                            split_update=True, manual_backward=True, manual_precast=True,
                            device="cpu")
    tlosses = []
    for b, draws in zip(batches, all_draws):
        tstate, loss = tstep(tstate, _torch(b), draws=draws)
        tlosses.append(loss.item())

    assert tstate.step == tstate.opt_state.count == steps
    np.testing.assert_allclose(tlosses[:2], jlosses[:2], rtol=2e-6)
    np.testing.assert_allclose(tlosses[2], jlosses[2], rtol=1e-3)
    jp = dict(flatten(jp))
    n_all = n_off = 0
    for (path, p), lab in zip(model.leaves(), ttx.labels):
        got = p.detach().numpy()
        moved = np.linalg.norm(jp[path] - start[path])
        assert moved > 0, path
        if lab == "muon":
            assert np.linalg.norm(got - jp[path]) <= 1e-1 * moved, path
        else:
            dp = np.abs(got - jp[path])
            assert dp.max() <= 0.15 * lr, path
            n_all, n_off = n_all + dp.size, n_off + int((dp > 1e-6).sum())
    assert n_off <= 3e-2 * n_all


def test_split_histograms_follow_the_state_step_after_resume(tmp_path):
    """Histograms every 3 steps fire where ``(state.step + 1) % 3 == 0``:
    the one-pass step's run of 6 steps against a split run saved after 4
    steps (not a multiple of 3) and resumed by a fresh step (whose first
    call knows nothing of the run before), 2 more steps. Same steps, and the
    same histograms, bit for bit."""
    from whisper_finetune_torch.optim import adamw_8bit
    from whisper_finetune_torch.train.state_io import load_train_state, save_train_state

    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(2), DIMS))
    rng = np.random.default_rng(3)
    batches = [_torch(_batch(rng, 1)) for _ in range(6)]
    fcfg = TFC(compute_dtype="float32")

    def build(split):
        model = params_from_jax(params, TD, device="cpu")
        tx = adamw_8bit(1e-3)
        state = TrainState(model, tx.init([p for _, p in model.leaves()]), 0)
        step = make_train_step(TD, fcfg, tx, max_grad_norm=1.0, accum_dtype="bfloat16",
                               grad_hist_every=3, split_update=split, device="cpu")
        return state, tx, step

    def fired(h):
        return int(h["decoder.blocks"][0].sum()) > 0

    state, _, step = build(False)
    fused = []
    for b in batches:
        state, _, h = step(state, b)
        fused.append(h)

    state, tx, step = build(True)
    split = []
    for b in batches[:4]:
        state, _, h = step(state, b)
        split.append(h)
    path = str(tmp_path / "train_state.pt")
    save_train_state(path, state, tx)
    state, tx, step = build(True)
    state = load_train_state(path, state, tx)
    assert state.step == 4
    for b in batches[4:]:
        state, _, h = step(state, b)
        split.append(h)
    assert [fired(h) for h in split] == [fired(h) for h in fused] == [
        False, False, True, False, False, True]
    for a, b in zip(split, fused):
        for k in a:
            assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), k


def test_split_is_inert_under_zero_at_world_2(tmp_path):
    """``split_update`` with ZeRO-1 at world 2 builds the one-pass ZeRO step
    (reduce-scatter, shard update, all-gather), as JAX's does; in one process
    (world 1) the same spec runs the split step, and the first losses agree."""
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), DIMS))
    rng = np.random.default_rng(4)
    batches = [_batch(rng, 1, B=4) for _ in range(2)]
    spec = dict(params=params, dims=DIMS.to_dict(), fcfg={"compute_dtype": "float32"},
                opt={"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.01}},
                batches=batches, accum_dtype="bfloat16", max_grad_norm=1.0, zero=True,
                split=True)
    res = run_ranks("steps", spec, 2, tmp_path)
    assert [r["split_step"] for r in res] == [False, False]
    assert res[0]["comm"]["reduce_scatter_rows"]["calls"] > 0
    assert res[0]["comm"]["all_gather_rows"]["calls"] > 0
    for k, v in res[0]["params"][-1].items():
        assert np.array_equal(v, res[1]["params"][-1][k]), k
    ref = one_process("steps", dict(spec, batches=[
        {k: v.reshape(2, 2, *v.shape[2:]) for k, v in b.items()} for b in batches]))
    assert ref["split_step"]
    np.testing.assert_allclose(res[0]["losses"][0], ref["losses"][0], rtol=1e-6)
