"""The port's loss and train step against the JAX package's: the reduction-form
cross entropy (value and gradient, -100 positions, label smoothing), and whole
steps of ``make_train_step`` (mel input, bf16 gradient accumulator, clip on,
fused 8-bit AdamW) against JAX ``make_train_step`` on a 1-device mesh, on
identical weights and batches; and the Muon flagship recipe (cosine schedule,
Muon + auxiliary AdamW, stochastic depth, deep SpecAugment) the same way,
given JAX's draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_tpu.optim.quantized import adamw_8bit as j_adamw_8bit
from whisper_finetune_tpu.train.step import TrainState as JState
from whisper_finetune_tpu.train.step import cross_entropy_loss as j_ce
from whisper_finetune_tpu.train.step import make_train_step as j_make_step
from whisper_finetune_tpu.train.step import partition_params, shard_batch
from whisper_finetune_torch.models import params_from_jax
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import ForwardConfig as TFC
from whisper_finetune_torch.models.whisper import flatten
from whisper_finetune_torch.optim import adamw_8bit as t_adamw_8bit
from whisper_finetune_torch.optim.quantized import QMoment
from whisper_finetune_torch.train import TrainState as TState
from whisper_finetune_torch.train import cross_entropy_loss as t_ce
from whisper_finetune_torch.train import make_train_step as t_make_step

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=150, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_vocab=300, n_text_ctx=24, n_text_state=64, n_text_head=2, n_text_layer=2,
)
SITES = dict(attn_impl_encoder="splash", attn_impl_cross="splash")


def _targets(rng, B, T, V):
    t = rng.integers(0, V, (B, T)).astype(np.int32)
    t[0, -5:] = -100  # padding tail
    t[1, 3] = -100
    return t


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_jax(smoothing, dtype):
    rng = np.random.default_rng(0)
    B, T, V = 3, 11, 97
    logits = (rng.standard_normal((B, T, V)) * 3).astype(np.float32)
    targets = _targets(rng, B, T, V)
    jl = jnp.asarray(logits, jnp.dtype(dtype))
    ref, ref_g = jax.value_and_grad(lambda x: j_ce(x, jnp.asarray(targets), smoothing))(jl)
    x = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(getattr(torch, dtype))
    x.requires_grad_(True)
    loss = t_ce(x, torch.from_numpy(targets).long(), smoothing)
    loss.backward()
    assert x.grad.dtype == x.dtype
    # float32 reductions in other orders; bf16 gradients round once at the end.
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    tol = 1e-7 if dtype == "float32" else 2e-3 * float(jnp.abs(ref_g.astype(jnp.float32)).max())
    np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(ref_g.astype(jnp.float32)),
                               atol=max(tol, 1e-7), rtol=0)
    # ignored positions get no gradient
    assert float(x.grad[0, -5:].abs().max()) == 0.0


def test_cross_entropy_matches_torch_reference():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy((rng.standard_normal((2, 7, 50)) * 2).astype(np.float32))
    targets = torch.from_numpy(_targets(rng, 2, 7, 50)).long()
    ref = torch.nn.functional.cross_entropy(logits.reshape(-1, 50), targets.reshape(-1),
                                            ignore_index=-100, label_smoothing=0.1)
    torch.testing.assert_close(t_ce(logits, targets, 0.1), ref)


def _batch(rng, accum, B):
    return {
        "mel": rng.standard_normal((accum, B, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32),
        "dec_input": rng.integers(0, DIMS.n_vocab, (accum, B, DIMS.n_text_ctx)).astype(np.int32),
        "dec_output": np.stack([_targets(rng, B, DIMS.n_text_ctx, DIMS.n_vocab)
                                for _ in range(accum)]),
    }


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    lr, B, steps = 1e-3, 2, 2
    params = jax_init_params(jax.random.PRNGKey(0), DIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), TDims(**DIMS.to_dict()),
                            device="cpu")
    rng = np.random.default_rng(accum)
    batches = [_batch(rng, accum, B) for _ in range(steps)]

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jtx = j_adamw_8bit(lr, weight_decay=0.01)
    trainable, frozen = partition_params(params, None)
    jstate = JState(trainable, frozen, jtx.init(trainable), jnp.zeros((), jnp.int32))
    jstep = j_make_step(mesh, DIMS, JFC(compute_dtype="float32", **SITES), jtx, 0.1,
                        max_grad_norm=1.0, accum_dtype="bfloat16")
    jlosses = []
    for b in batches:
        jstate, loss = jstep(jstate, shard_batch(mesh, jax.tree.map(jnp.asarray, b)),
                             jax.random.PRNGKey(0))
        jlosses.append(float(loss))

    ttx = t_adamw_8bit(lr, weight_decay=0.01)
    tstate = TState(model, ttx.init([p for _, p in model.leaves()]), 0)
    tstep = t_make_step(TDims(**DIMS.to_dict()), TFC(compute_dtype="float32", **SITES), ttx,
                        0.1, max_grad_norm=1.0, accum_dtype="bfloat16", device="cpu")
    tlosses = []
    for b in batches:
        tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in b.items()}
        tstate, loss = tstep(tstate, tb)
        tlosses.append(float(loss))

    assert tstate.step == int(jstate.step) == steps
    assert tstate.opt_state.count == int(jstate.opt_state[0].count) == steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-6)

    # The losses agree to float32 rounding (measured: 2e-7 relative). The
    # gradients do too, but the bf16 accumulator can round an element one
    # bf16 ulp apart, and its 8-bit moments then sit a code (rarely two,
    # after a second step) apart; Adam's normalised update moves such an
    # element by a fraction of lr. Measured after 2 steps: <0.1% of elements
    # beyond 1e-6, at most 8% of lr; codes at most 2 levels; a block scale
    # at most 2 levels of its block max (2/127).
    jp = dict(flatten(jax.tree.map(np.asarray, jstate.trainable)))
    jmu = dict(flatten(jstate.opt_state[0].mu))  # leaves: _QMoment or arrays
    jnu = dict(flatten(jstate.opt_state[0].nu))
    n_all = n_off = 0
    for (path, p), mu, nu in zip(model.leaves(), tstate.opt_state.mu, tstate.opt_state.nu):
        dp = np.abs(p.detach().numpy() - jp[path])
        assert dp.max() <= 0.15 * lr, path
        n_all, n_off = n_all + dp.size, n_off + int((dp > 1e-6).sum())
        if isinstance(mu, QMoment):
            for got, want in ((mu, jmu[path]), (nu, jnu[path])):
                want_codes, want_scale = np.asarray(want[0]), np.asarray(want[1])
                assert np.abs(got.codes.numpy().astype(int) - want_codes.astype(int)).max() <= 2
                np.testing.assert_allclose(got.scale.numpy(), want_scale, rtol=2.0 / 127,
                                           atol=1e-12, err_msg=str(path))
        else:
            np.testing.assert_allclose(mu.numpy(), np.asarray(jmu[path]), rtol=2e-2, atol=1e-7)
            np.testing.assert_allclose(nu.numpy(), np.asarray(jnu[path]), rtol=2e-2, atol=1e-9)
    assert n_off <= 2e-3 * n_all


def test_train_step_loss_decreases_with_features():
    """The main-path configuration (log-mel + SpecAugment inside the step,
    bf16 compute) at toy size on the CPU: runs, and the loss goes down."""
    from whisper_finetune_torch.models import init_params
    from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig

    dims = TDims(**DIMS.to_dict())
    model = init_params(dims, device="cpu", seed=0)
    tx = t_adamw_8bit(3e-3)
    state = TState(model, tx.init([p for _, p in model.leaves()]), 0)
    step = t_make_step(dims, TFC(compute_dtype="bfloat16", **SITES), tx, 0.1,
                       feat_cfg=FeaturizeConfig(n_mels=16, spec_augment=True, p=1.0,
                                                time_warp_w=20),
                       max_grad_norm=1.0, accum_dtype="bfloat16", device="cpu")
    rng = np.random.default_rng(0)
    batch = {
        "audio": torch.from_numpy((rng.standard_normal((1, 2, 300 * 160)) * 0.05).astype(np.float32)),
        "crop_frames": torch.tensor([[300, 250]]),
        "dec_input": torch.from_numpy(rng.integers(0, 300, (1, 2, 24))),
        "dec_output": torch.from_numpy(rng.integers(0, 300, (1, 2, 24))),
    }
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(4):
        state, loss = step(state, batch, gen)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


MUON_CONF = {
    "type": "adamw", "muon": True, "8bit": False, "muon_ndim_threshold": 2,
    "muon_params": {"lr": 1e-3, "momentum": 0.95, "weight_decay": 0.01},
    "params": {"lr": 1e-3, "weight_decay": 0.01, "betas": [0.9, 0.98], "eps": 1e-6,
               "amsgrad": False},
}


@pytest.mark.parametrize("variant", ["flagship", "int8_aux8"])
def test_muon_flagship_steps_match_jax(variant):
    """Three optimizer steps of the flagship recipe at toy size (the first at
    the warm-up's lr 0, two that move), accumulation 2, against JAX's
    non-split ``make_train_step``: ``flagship`` is the shipped config's
    optimizer (float32 momentum and moments), ``int8_aux8`` the bench's
    (int8 Muon momentum, 8-bit auxiliary AdamW). Float32 compute, so losses
    agree to float32 rounding until the parameters differ, then to the
    parameters' tolerance. Muon leaves: 10% relative Frobenius error of the
    total movement. Newton-Schulz in bf16 alone gives up to 2.4% on equal
    inputs (test_torch_muon.py); here its inputs differ too (bf16 accumulator
    roundings, int8 momentum codes a level apart) and the iteration amplifies
    that on the ill-conditioned square 64 x 64 leaves: measured up to 4.6%
    (``flagship``) and 6.8% (``int8_aux8``). AdamW leaves: at most 15% of lr
    per element, as in test_train_step_matches_jax, with at most 2% (3% with
    8-bit state) of elements beyond 1e-6 (measured 0.9% and 1.4%)."""
    from test_torch_model import jax_draws
    from whisper_finetune_tpu.optim.optimizers import get_optimizer as j_get_optimizer
    from whisper_finetune_tpu.optim.schedulers import get_schedule as j_get_schedule
    from whisper_finetune_torch.optim import get_optimizer, get_schedule

    lr, B, accum, steps = 1e-3, 2, 2, 3
    conf = dict(MUON_CONF)
    if variant == "int8_aux8":
        conf.update({"8bit": True, "muon_momentum_dtype": "int8", "muon_aux_8bit": True})
    sched = {"type": "cosine", "warmup_steps": 1}
    kw = dict(compute_dtype="float32", stochastic_depth=0.3, dsa_apply=True,
              dsa_time_mask_param=40, dsa_freq_mask_param=20, **SITES)
    params = jax_init_params(jax.random.PRNGKey(1), DIMS)
    tdims = TDims(**DIMS.to_dict())
    model = params_from_jax(jax.tree.map(np.asarray, params), tdims, device="cpu")
    start = {path: p.detach().clone().numpy() for path, p in model.leaves()}
    rng = np.random.default_rng(5)
    batches = [_batch(rng, accum, B) for _ in range(steps)]

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    trainable, frozen = partition_params(params, None)
    jtx, jmeta = j_get_optimizer(trainable, conf, j_get_schedule(sched, 8))
    jstate = JState(trainable, frozen, jtx.init(trainable), jnp.zeros((), jnp.int32))
    jstep = j_make_step(mesh, DIMS, JFC(**kw), jtx, 0.1, max_grad_norm=1.0,
                        accum_dtype="bfloat16")
    key = jax.random.PRNGKey(0)
    jlosses, all_draws = [], []
    for i, b in enumerate(batches):
        dev_rng = jax.random.fold_in(jax.random.fold_in(key, 0), i)  # device 0, step i
        all_draws.append([jax_draws(r, DIMS) for r in jax.random.split(dev_rng, accum)])
        jstate, loss = jstep(jstate, shard_batch(mesh, jax.tree.map(jnp.asarray, b)), key)
        jlosses.append(float(loss))

    ttx, tmeta = get_optimizer(model.leaves(), conf, get_schedule(sched, 8))
    assert tmeta == jmeta
    tstate = TState(model, ttx.init([p for _, p in model.leaves()]), 0)
    tstep = t_make_step(tdims, TFC(**kw), ttx, 0.1, max_grad_norm=1.0, accum_dtype="bfloat16",
                        device="cpu")
    tlosses = []
    for b, draws in zip(batches, all_draws):
        tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in b.items()}
        tstate, loss = tstep(tstate, tb, draws=draws)
        tlosses.append(float(loss))

    assert tstate.step == int(jstate.step) == tstate.opt_state.count == steps
    assert [ttx.muon.lr(c) for c in range(3)] == [0.0, lr, pytest.approx(lr * 0.5 * (1 + np.cos(np.pi / 7)))]
    np.testing.assert_allclose(tlosses[:2], jlosses[:2], rtol=2e-6)  # same parameters so far
    np.testing.assert_allclose(tlosses[2], jlosses[2], rtol=1e-3)
    jp = dict(flatten(jax.tree.map(np.asarray, jstate.trainable)))
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
    assert n_off <= (3e-2 if variant == "int8_aux8" else 2e-2) * n_all


def test_step_draws_and_optimizer_protocol():
    """The step draws for all its microbatches at once from the generator
    when it is given no draws, refuses a wrong number of them, and takes any
    optimizer with ``fused_apply``."""
    from whisper_finetune_torch.models import init_params
    from whisper_finetune_torch.optim import get_optimizer

    dims = TDims(**DIMS.to_dict())
    model = init_params(dims, device="cpu", seed=0)
    tx, _ = get_optimizer(model.leaves(), {"type": "adam", "params": {"lr": 1e-3}})
    state = TState(model, tx.init([p for _, p in model.leaves()]), 0)
    fcfg = TFC(compute_dtype="float32", stochastic_depth=0.5, dsa_apply=True)
    step = t_make_step(dims, fcfg, tx, device="cpu")
    rng = np.random.default_rng(0)
    b = _batch(rng, 2, 2)
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for k, v in b.items()}
    losses = []
    for seed in (0, 0, 1):
        m = init_params(dims, device="cpu", seed=0)
        st = TState(m, tx.init([p for _, p in m.leaves()]), 0)
        _, loss = step(st, tb, torch.Generator().manual_seed(seed))
        losses.append(float(loss))
    assert losses[0] == losses[1] != losses[2]  # the draws come from the generator
    with pytest.raises(ValueError, match="draws for 2 microbatches"):
        step(state, tb, draws=[None])
    with pytest.raises(TypeError, match="fused_apply"):
        t_make_step(dims, fcfg, object(), device="cpu")
