"""The port's hand-written accumulating backward
(``whisper_finetune_torch/train/manual_grad.py``) against the JAX package's
``make_manual_accumulator`` and against the port's own automatic backward, on
identical weights and batches, with stochastic depth and deep SpecAugment
given JAX's draws (``test_torch_model.jax_draws``), the feature path, precast
on and off, accumulation 1 and 2. Tolerances as ``tests/test_manual_grad.py``
sets them (float32: gradients 1e-5, loss 1e-6 relative; bf16: 0.08 and
1e-2), against the largest gradient of the leaf. Against the port's
automatic path the losses are bit-equal (the forward is the same ops on the
same values) and the gradients within the same tolerances: the cross
attention's cotangent is summed layer by layer, as JAX's manual backward
sums it, where autograd sums its four uses a layer pair in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import jax_draws
from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_tpu.train.manual_grad import make_manual_accumulator as j_make_acc
from whisper_finetune_tpu.train.step import cross_entropy_loss as j_ce
from whisper_finetune_torch.models import params_from_jax
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import ForwardConfig as TFC
from whisper_finetune_torch.models.whisper import _set, flatten, forward_impl
from whisper_finetune_torch.train import cross_entropy_loss as t_ce
from whisper_finetune_torch.train.manual_grad import make_manual_accumulator

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=32, n_audio_state=32, n_audio_head=4, n_audio_layer=3,
    n_vocab=120, n_text_ctx=16, n_text_state=32, n_text_head=4, n_text_layer=2,
)
TD = TDims(**DIMS.to_dict())
SMOOTH = 0.1
TOLS = {"float32": (1e-5, 1e-6), "bfloat16": (0.08, 1e-2)}  # (gradients, loss)
SD = dict(stochastic_depth=0.3, dsa_apply=True, dsa_p=0.7, dsa_time_mask_param=8,
          dsa_freq_mask_param=4)


def _batch(accum, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "mel": rng.standard_normal((accum, B, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32),
        "dec_input": rng.integers(0, DIMS.n_vocab, (accum, B, DIMS.n_text_ctx)).astype(np.int32),
        "dec_output": rng.integers(0, DIMS.n_vocab, (accum, B, DIMS.n_text_ctx)).astype(np.int32),
    }


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()}


def _micro_rngs(accum):
    """A key whose microbatches drop an encoder and a decoder layer somewhere
    and turn deep SpecAugment on somewhere, so every path of the backward
    runs."""
    for seed in range(200):
        rngs = jax.random.split(jax.random.PRNGKey(seed), accum)
        d = [jax_draws(r, DIMS) for r in rngs]
        if (any((x.enc_coin < 0.3).any() for x in d) and any((x.dec_coin < 0.3).any() for x in d)
                and any(x.dsa_gate < 0.7 for x in d)
                and all((x.enc_coin >= 0.3).any() for x in d)):
            return rngs, d
    raise AssertionError("no key gives the wanted draws")


def _buf(params, dtype):
    out = {}
    for path, p in flatten(params):
        _set(out, path, torch.zeros(p.shape, dtype=dtype))
    return out


def _auto(model, batch, fcfg, draws, acc_dt):
    """The port's automatic path: per-microbatch autograd of forward_impl,
    cast to the accumulator dtype, summed (``train/step.py``)."""
    params = model.params()
    leaves = [p for _, p in flatten(params)]
    sums = [torch.zeros(p.shape, dtype=acc_dt) for p in leaves]
    loss_sum = torch.zeros(())
    for i in range(batch["mel"].shape[0]):
        logits = forward_impl(params, batch["mel"][i], batch["dec_input"][i], TD, fcfg, True,
                              draws[i])
        loss = t_ce(logits, batch["dec_output"][i], SMOOTH)
        for a, g in zip(sums, torch.autograd.grad(loss, leaves, allow_unused=True)):
            if g is not None:
                a.add_(g.to(acc_dt))
        loss_sum = loss_sum + loss.detach()
    return sums, loss_sum


def _close(got_tree, want_leaves, gtol):
    for (path, g), w in zip(flatten(got_tree), want_leaves):
        g32, w32 = g.float().numpy(), np.asarray(w, np.float32)
        scale = max(np.abs(w32).max(), 1e-3)
        np.testing.assert_allclose(g32, w32, atol=gtol * scale, rtol=0, err_msg=str(path))


@pytest.mark.parametrize("dtype,precast,accum", [
    ("float32", False, 1), ("float32", False, 2), ("bfloat16", False, 2),
    ("bfloat16", True, 2), ("bfloat16", True, 1),
])
def test_manual_matches_jax_and_automatic(dtype, precast, accum):
    gtol, ltol = TOLS[dtype]
    acc_dt = getattr(torch, dtype)
    params = jax_init_params(jax.random.PRNGKey(0), DIMS)
    model = params_from_jax(jax.tree.map(np.asarray, params), TD, device="cpu")
    batch = _batch(accum)
    rngs, draws = _micro_rngs(accum)

    jacc = j_make_acc(DIMS, JFC(compute_dtype=dtype, **SD), lambda lg, tg: j_ce(lg, tg, SMOOTH),
                      precast=precast)
    jbuf = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.dtype(dtype)), params)
    jg, jloss = jax.jit(jacc)(params, jax.tree.map(jnp.asarray, batch), rngs, jbuf)

    fcfg = TFC(compute_dtype=dtype, **SD)
    acc = make_manual_accumulator(TD, fcfg, lambda lg, tg: t_ce(lg, tg, SMOOTH), precast=precast)
    buf = _buf(model.params(), acc_dt)
    tb = _torch_batch(batch)
    out, loss = acc(model.params(), tb, None, buf, draws)
    assert out is buf and loss.dtype == torch.float32

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=ltol)
    _close(buf, [np.asarray(x.astype(jnp.float32)) for _, x in flatten(jg)], gtol)
    ref, ref_loss = _auto(model, tb, fcfg, draws, acc_dt)
    assert loss.item() == ref_loss.item()
    assert all(g.dtype == acc_dt for _, g in flatten(buf))
    _close(buf, [r.float().numpy() for r in ref], gtol)


def test_manual_with_features_matches_jax_and_automatic():
    """The feature path: log-mel inside the accumulation. Against JAX with
    SpecAugment off (JAX draws it from its own key); against the port's
    automatic path with SpecAugment on, both drawing from one generator."""
    from whisper_finetune_tpu.ops.spec_augment import FeaturizeConfig as JFeat
    from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig, featurize_impl

    dims = DIMS.replace(n_mels=80)
    tdims = TDims(**dims.to_dict())
    params = jax_init_params(jax.random.PRNGKey(3), dims)
    model = params_from_jax(jax.tree.map(np.asarray, params), tdims, device="cpu")
    rng = np.random.default_rng(13)
    n = dims.n_audio_ctx * 2 * 160
    batch = {"audio": (rng.standard_normal((2, 2, n)) * 0.1).astype(np.float32),
             "crop_frames": np.full((2, 2), n // 160, np.int32),
             "dec_input": rng.integers(0, dims.n_vocab, (2, 2, dims.n_text_ctx)).astype(np.int32),
             "dec_output": rng.integers(0, dims.n_vocab, (2, 2, dims.n_text_ctx)).astype(np.int32)}
    tb = _torch_batch(batch)
    tb["crop_frames"] = tb["crop_frames"].int()
    loss_fn = lambda lg, tg: t_ce(lg, tg, SMOOTH)  # noqa: E731

    # against JAX, SpecAugment off: JAX splits the feature key off first
    rngs = jax.random.split(jax.random.PRNGKey(9), 2)
    draws = [jax_draws(jax.random.split(r)[1], dims) for r in rngs]
    jacc = j_make_acc(dims, JFC(compute_dtype="float32", **SD),
                      lambda lg, tg: j_ce(lg, tg, SMOOTH), feat_cfg=JFeat(n_mels=80))
    jbuf = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    jg, jloss = jax.jit(jacc)(params, jax.tree.map(jnp.asarray, batch), rngs, jbuf)
    acc = make_manual_accumulator(tdims, TFC(compute_dtype="float32", **SD), loss_fn,
                                  feat_cfg=FeaturizeConfig(n_mels=80))
    buf = _buf(model.params(), torch.float32)
    _, loss = acc(model.params(), tb, None, buf, draws)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)  # the log-mel's rounding
    _close(buf, [np.asarray(x) for _, x in flatten(jg)], 1e-4)

    # against the automatic path, SpecAugment on, one generator each
    feat = FeaturizeConfig(n_mels=80, spec_augment=True, p=1.0, time_warp_w=20)
    fcfg = TFC(compute_dtype="bfloat16", **SD)
    acc = make_manual_accumulator(tdims, fcfg, loss_fn, feat_cfg=feat, precast=True)
    buf = _buf(model.params(), torch.bfloat16)
    _, loss = acc(model.params(), tb, torch.Generator().manual_seed(5), buf)

    from whisper_finetune_torch.models.whisper import draw_forward

    gen = torch.Generator().manual_seed(5)
    draws = draw_forward(gen, tdims, "cpu", 2)
    mels = [featurize_impl(tb["audio"][i], tb["crop_frames"][i], gen, feat, train=True)
            for i in range(2)]
    tb_mel = {"mel": torch.stack(mels), "dec_input": tb["dec_input"],
              "dec_output": tb["dec_output"]}
    ref, ref_loss = _auto(model, tb_mel, fcfg, draws, torch.bfloat16)
    assert loss.item() == ref_loss.item()
    _close(buf, [r.float().numpy() for r in ref], TOLS["bfloat16"][0])


@pytest.mark.parametrize("case", ["lora", "frozen", "without_split", "remat_policy"])
def test_manual_backward_refusals(case):
    """LoRA, a frozen leaf, the manual backward without the split step, and
    a remat policy other than full each raise."""
    from whisper_finetune_torch.models import init_params
    from whisper_finetune_torch.optim import adamw_8bit
    from whisper_finetune_torch.train import make_train_step

    loss_fn = lambda lg, tg: t_ce(lg, tg, SMOOTH)  # noqa: E731
    if case == "lora":
        with pytest.raises(ValueError, match="LoRA"):
            make_manual_accumulator(TD, TFC(lora_scale=2.0), loss_fn)
    elif case == "frozen":
        model = init_params(TD, device="cpu", seed=0)
        model.params()["encoder"]["conv1"]["w"].requires_grad_(False)
        acc = make_manual_accumulator(TD, TFC(compute_dtype="float32"), loss_fn)
        with pytest.raises(ValueError, match="frozen"):
            acc(model.params(), _torch_batch(_batch(1)), None,
                _buf(model.params(), torch.float32))
    elif case == "without_split":
        with pytest.raises(ValueError, match="manual_backward requires split_update=True"):
            make_train_step(TD, TFC(), adamw_8bit(1e-3), manual_backward=True, device="cpu")
    else:
        with pytest.raises(ValueError, match="remat_policy"):
            make_manual_accumulator(TD, TFC(remat_policy="dots"), loss_fn)
