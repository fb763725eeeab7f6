"""The port's model forward against the JAX package's ``forward_impl`` on
identical weights (carried across by ``params_from_jax``), with splash
attention on the encoder and cross-attention sites in both (Pallas interpret
mode in JAX, the kernels' plain twins in the port). Stochastic depth and
deep SpecAugment are held given JAX's own draws: ``jax_draws`` replays the
JAX forward's key layout and hands the uniforms to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_tpu.models.whisper import encoder_forward as j_encoder
from whisper_finetune_tpu.models.whisper import forward_impl as j_forward
from whisper_finetune_torch.models import params_from_jax
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import ForwardConfig as TFC
from whisper_finetune_torch.models.whisper import ForwardDraws, axis_keep_masks, draw_forward
from whisper_finetune_torch.models.whisper import dsa_layer_flags as t_dsa_flags
from whisper_finetune_torch.models.whisper import encoder_forward as t_encoder
from whisper_finetune_torch.models.whisper import flatten

# Deliberately not multiples of 128: 150 audio frames, 24 tokens.
DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=150, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_vocab=300, n_text_ctx=24, n_text_state=64, n_text_head=2, n_text_layer=2,
)
TD = TDims(**DIMS.to_dict())
SITES = dict(attn_impl_encoder="splash", attn_impl_cross="splash")


def _setup(seed=0, B=2):
    params = jax_init_params(jax.random.PRNGKey(seed), DIMS)
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    tok = rng.integers(0, DIMS.n_vocab, (B, DIMS.n_text_ctx)).astype(np.int32)
    model = params_from_jax(jax.tree.map(np.asarray, params), TD, device="cpu")
    return params, model, mel, tok


# (compute dtype, max |err| allowed relative to max |logit|): float32 is
# float32 math in another order; bf16 rounds every matmul output.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_forward_logits_match_jax(dtype, tol):
    params, model, mel, tok = _setup()
    ref = np.asarray(j_forward(params, jnp.asarray(mel), jnp.asarray(tok), DIMS,
                               JFC(compute_dtype=dtype, **SITES)))
    with torch.no_grad():
        out = model(torch.from_numpy(mel), torch.from_numpy(tok).long(),
                    TFC(compute_dtype=dtype, **SITES)).numpy()
    assert out.shape == ref.shape == (2, DIMS.n_text_ctx, DIMS.n_vocab)
    assert out.dtype == np.float32
    err = np.abs(out - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def test_encoder_output_matches_jax():
    params, model, mel, _ = _setup(seed=1)
    ref = np.asarray(j_encoder(params, jnp.asarray(mel), DIMS, JFC(compute_dtype="float32", **SITES)))
    with torch.no_grad():
        out = t_encoder(model.params(), torch.from_numpy(mel), TD,
                        TFC(compute_dtype="float32", **SITES)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("remat", [True, False])
def test_param_grads_match_jax(remat):
    """Gradients of a fixed linear functional of the logits, float32: the
    stacked leaves' gradients flow back through one ``unbind`` each (and
    through ``torch.utils.checkpoint`` with remat on)."""
    params, model, mel, tok = _setup(seed=2)
    cot = np.random.default_rng(3).standard_normal((2, DIMS.n_text_ctx, DIMS.n_vocab)).astype(np.float32)
    jcfg = JFC(compute_dtype="float32", remat_encoder=remat, remat_decoder=remat, **SITES)
    ref = jax.grad(lambda p: jnp.sum(j_forward(p, jnp.asarray(mel), jnp.asarray(tok), DIMS, jcfg)
                                     * cot))(params)
    tcfg = TFC(compute_dtype="float32", remat_encoder=remat, remat_decoder=remat, **SITES)
    out = model(torch.from_numpy(mel), torch.from_numpy(tok).long(), tcfg, train=True)
    (out * torch.from_numpy(cot)).sum().backward()
    got = {path: p.grad for path, p in model.leaves()}
    for path, g in flatten(jax.tree.map(np.asarray, ref)):
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(got[path].numpy(), g, atol=1e-4 * scale, rtol=0,
                                   err_msg=str(path))


def test_bf16_forward_precasts_once():
    """One bf16 cast of each stacked matrix, unbound once: the per-layer
    weights are views of that cast, not per-layer copies."""
    from whisper_finetune_torch.models.whisper import _layer_views

    _, model, _, _ = _setup()
    blocks = model.params()["encoder"]["blocks"]
    layers = _layer_views(blocks, TD.n_audio_layer, torch.bfloat16)
    w0, w1 = layers[0]["attn"]["q_w"], layers[1]["attn"]["q_w"]
    assert w0.dtype == torch.bfloat16 and w0.untyped_storage().data_ptr() == w1.untyped_storage().data_ptr()
    assert layers[0]["attn"]["q_b"].dtype == torch.float32  # 1-D per layer: cast at use


def jax_draws(rng, dims) -> ForwardDraws:
    """The uniforms ``forward_impl(..., rng=rng, train=True)`` of the JAX
    package draws, in its key layout (``encoder_step_rng``,
    ``decoder_step_rng``, ``_stochastic_wrap``, ``_axis_mask``)."""
    u = lambda key: np.float32(jax.random.uniform(key))  # noqa: E731
    Le, Ld = dims.n_audio_layer, dims.n_text_layer
    enc_rng, dec_rng = jax.random.split(rng)
    gate_key, layers_key = jax.random.split(enc_rng)
    enc_keys = jax.random.split(layers_key, Le * 3).reshape(Le, 3, 2)
    dec_keys = jax.random.split(dec_rng, Ld * 2).reshape(Ld, 2, 2)
    t_draws, f_draws = [], []
    for i in range(Le):
        kt, kf = jax.random.split(enc_keys[i, 1])
        t_draws.append([u(k) for k in jax.random.split(kt)])
        f_draws.append([u(k) for k in jax.random.split(kf)])
    return ForwardDraws(
        enc_coin=np.array([u(enc_keys[i, 0]) for i in range(Le)], np.float32),
        dec_coin=np.array([u(dec_keys[i, 0]) for i in range(Ld)], np.float32),
        dsa_gate=float(u(gate_key)),
        dsa_time=np.array(t_draws, np.float32), dsa_feat=np.array(f_draws, np.float32))


def _rng_with(dims, p, want_enc, want_dec):
    """A JAX key whose coins at rate ``p`` give these keep patterns."""
    for seed in range(200):
        rng = jax.random.PRNGKey(seed)
        d = jax_draws(rng, dims)
        if ([bool(c >= p) for c in d.enc_coin] == want_enc
                and [bool(c >= p) for c in d.dec_coin] == want_dec):
            return rng, d
    raise AssertionError("no seed gives the wanted pattern")


def _grads(model, out, cot):
    for _, p in model.leaves():
        p.grad = None
    (out * torch.from_numpy(cot)).sum().backward()
    return {path: p.grad.clone() for path, p in model.leaves()}


# (stochastic depth, deep SpecAugment, encoder keep pattern, decoder keep pattern)
TRAIN_CASES = [
    (0.5, False, [True, False], [False, True]),
    (0.5, True, [True, True], [True, False]),
    (0.5, True, [False, True], [True, True]),
    (0.0, True, [True, True], [True, True]),
]


@pytest.mark.parametrize("sd,dsa,enc_keep,dec_keep", TRAIN_CASES)
def test_stochastic_depth_and_dsa_match_jax(sd, dsa, enc_keep, dec_keep):
    """Logits and parameter gradients of a training forward, float32, with
    JAX's draws: skipped layers, the 1/keep rescale, batch-shared deep
    SpecAugment masks on every encoder block but the last. Tolerances as in
    the tests above (float32 in another order)."""
    params, model, mel, tok = _setup(seed=4)
    rng, draws = _rng_with(DIMS, sd, enc_keep, dec_keep) if sd else (jax.random.PRNGKey(5), None)
    draws = draws or jax_draws(rng, DIMS)
    kw = dict(compute_dtype="float32", stochastic_depth=sd, dsa_apply=dsa,
              dsa_time_mask_param=40, dsa_freq_mask_param=20, **SITES)
    cot = np.random.default_rng(5).standard_normal((2, DIMS.n_text_ctx, DIMS.n_vocab)).astype(np.float32)

    def jloss(p):
        logits = j_forward(p, jnp.asarray(mel), jnp.asarray(tok), DIMS, JFC(**kw), rng=rng,
                           train=True)
        return jnp.sum(logits * cot), logits

    (_, ref), ref_g = jax.value_and_grad(jloss, has_aux=True)(params)
    out = model(torch.from_numpy(mel), torch.from_numpy(tok).long(), TFC(**kw), train=True,
                draws=draws)
    ref = np.asarray(ref)
    assert np.abs(out.detach().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    got = _grads(model, out, cot)
    for path, g in flatten(jax.tree.map(np.asarray, ref_g)):
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(got[path].numpy(), g, atol=1e-4 * scale, rtol=0,
                                   err_msg=str(path))
    if dsa:
        # the masks act on block 0 where it runs, and never on the last block
        plain = model(torch.from_numpy(mel), torch.from_numpy(tok).long(),
                      TFC(**{**kw, "dsa_apply": False}), train=True, draws=draws)
        changed = float((plain - out).detach().abs().max())
        assert changed > 1e-4 if enc_keep[0] else changed == 0.0
    if sd:
        # a dropped layer's weights get exactly zero gradient
        dropped = enc_keep.index(False) if False in enc_keep else None
        if dropped is not None:
            assert float(got[("encoder", "blocks", "mlp", "fc1_w")][dropped].abs().max()) == 0.0


def test_eval_forward_ignores_training_switches():
    _, model, mel, tok = _setup()
    args = (torch.from_numpy(mel), torch.from_numpy(tok).long())
    with torch.no_grad():
        a = model(*args, TFC(compute_dtype="float32", stochastic_depth=0.9, dsa_apply=True))
        b = model(*args, TFC(compute_dtype="float32"))
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_on_equals_remat_off_with_draws(dtype):
    """Every random value is drawn outside the checkpointed blocks, so the
    recompute sees the forward's values: same logits and gradients."""
    _, model, mel, tok = _setup(seed=6)
    draws = draw_forward(torch.Generator().manual_seed(3), TD, "cpu")[0]
    draws = ForwardDraws(np.array([0.9, 0.9], np.float32), np.array([0.1, 0.9], np.float32),
                         draws.dsa_gate * 0.5, draws.dsa_time, draws.dsa_feat)
    cot = np.random.default_rng(7).standard_normal((2, DIMS.n_text_ctx, DIMS.n_vocab)).astype(np.float32)
    outs = []
    for remat in (True, False):
        cfg = TFC(compute_dtype=dtype, remat_encoder=remat, remat_decoder=remat,
                  stochastic_depth=0.5, dsa_apply=True, dsa_p=0.5, dsa_time_mask_param=40, **SITES)
        out = model(torch.from_numpy(mel), torch.from_numpy(tok).long(), cfg, train=True,
                    draws=draws)
        outs.append((out.detach().clone(), _grads(model, out, cot)))
    assert torch.equal(outs[0][0], outs[1][0])
    for path in outs[0][1]:
        assert torch.equal(outs[0][1][path], outs[1][1][path]), path


@pytest.mark.parametrize("remat", [True, False])
def test_precast_weights_off_matches_jax(remat):
    """``precast_weights=False``: each block casts its own weight slices at
    use. The same cast, placed elsewhere: identical to precast in the port,
    and within the bf16 tolerance of JAX's barriered slice cast."""
    params, model, mel, tok = _setup(seed=8)
    args = (torch.from_numpy(mel), torch.from_numpy(tok).long())
    cot = np.random.default_rng(9).standard_normal((2, DIMS.n_text_ctx, DIMS.n_vocab)).astype(np.float32)
    kw = dict(compute_dtype="bfloat16", remat_encoder=remat, remat_decoder=remat, **SITES)
    jcfg = JFC(precast_weights=False, **kw)
    ref, ref_g = jax.value_and_grad(
        lambda p: (lambda l: (jnp.sum(l * cot), l))(
            j_forward(p, jnp.asarray(mel), jnp.asarray(tok), DIMS, jcfg, train=True)),
        has_aux=True)(params)
    ref = np.asarray(ref[1])
    off = model(*args, TFC(precast_weights=False, **kw), train=True)
    g_off = _grads(model, off, cot)
    on = model(*args, TFC(precast_weights=True, **kw), train=True)
    g_on = _grads(model, on, cot)
    assert torch.equal(off, on)
    assert np.abs(off.detach().numpy() - ref).max() <= 3e-2 * np.abs(ref).max()
    for path, g in flatten(jax.tree.map(np.asarray, ref_g)):
        # bf16 matmuls in the backward too: 5% of the leaf's largest gradient
        assert torch.equal(g_off[path], g_on[path]), path
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(g_off[path].numpy(), g, atol=5e-2 * scale, rtol=0,
                                   err_msg=str(path))


def test_precast_off_keeps_float32_views():
    from whisper_finetune_torch.models.whisper import _layer_views

    _, model, _, _ = _setup()
    layers = _layer_views(model.params()["encoder"]["blocks"], TD.n_audio_layer,
                          torch.bfloat16, precast=False)
    assert layers[0]["attn"]["q_w"].dtype == torch.float32


def test_remat_encoder_last_only_matches_jax(monkeypatch):
    """Only the last encoder block is checkpointed; gradients as JAX's."""
    import whisper_finetune_torch.models.whisper as W

    params, model, mel, tok = _setup(seed=10)
    cot = np.random.default_rng(11).standard_normal((2, DIMS.n_text_ctx, DIMS.n_vocab)).astype(np.float32)
    kw = dict(compute_dtype="float32", remat_encoder=False, remat_encoder_last_only=True,
              remat_decoder=False, **SITES)
    ref = jax.grad(lambda p: jnp.sum(j_forward(p, jnp.asarray(mel), jnp.asarray(tok), DIMS,
                                               JFC(**kw), train=True) * cot))(params)
    calls = []
    real = W.checkpoint
    monkeypatch.setattr(W, "checkpoint", lambda fn, *a, **k: calls.append(a[1]) or real(fn, *a, **k))
    out = model(torch.from_numpy(mel), torch.from_numpy(tok).long(), TFC(**kw), train=True)
    got = _grads(model, out, cot)
    assert len(calls) == 1  # one checkpointed block: the last encoder layer
    last = W._layer_views(model.params()["encoder"]["blocks"], 2, torch.float32)[-1]
    assert calls[0]["attn"]["q_w"].data_ptr() == last["attn"]["q_w"].data_ptr()
    for path, g in flatten(jax.tree.map(np.asarray, ref)):
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(got[path].numpy(), g, atol=1e-4 * scale, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("indices,n", [(None, 4), ((0, 2), 4), ((3,), 4), ((0, 1), 2), (None, 1)])
def test_dsa_layer_flags_match_jax(indices, n):
    from whisper_finetune_tpu.models.whisper import dsa_layer_flags as j_flags

    kw = dict(dsa_apply=True, dsa_layer_indices=indices)
    np.testing.assert_array_equal(t_dsa_flags(TFC(**kw), n), j_flags(JFC(**kw), n))
    assert not t_dsa_flags(TFC(dsa_apply=False), n).any()
    with pytest.raises(ValueError, match="out of range"):
        t_dsa_flags(TFC(dsa_apply=True, dsa_layer_indices=(n,)), n)


def test_axis_keep_masks_match_jax():
    from whisper_finetune_tpu.models.whisper import _axis_mask

    for seed, (size, param) in enumerate([(150, 40), (64, 20), (1500, 100), (1280, 43)]):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        draws = np.array([[jax.random.uniform(k1), jax.random.uniform(k2)]], np.float32)
        np.testing.assert_array_equal(axis_keep_masks(draws, size, param)[0],
                                      np.asarray(_axis_mask(key, size, param)))


def test_draw_forward_layout_and_blocks_run():
    import whisper_finetune_torch.models.whisper as W

    a = draw_forward(torch.Generator().manual_seed(1), TD, "cpu", n=3)
    b = draw_forward(torch.Generator().manual_seed(1), TD, "cpu", n=3)
    assert len(a) == 3 and a[0].enc_coin.shape == (2,) and a[0].dsa_time.shape == (2, 2)
    assert all(np.array_equal(x.dec_coin, y.dec_coin) and x.dsa_gate == y.dsa_gate
               for x, y in zip(a, b))
    assert not np.array_equal(a[0].enc_coin, a[1].enc_coin)
    big = draw_forward(torch.Generator().manual_seed(2), TD, "cpu", n=2000)
    coins = np.concatenate([d.enc_coin for d in big])
    assert 0.0 <= coins.min() and coins.max() < 1.0 and abs((coins < 0.1).mean() - 0.1) < 0.02

    # the layer loops count the blocks they ran; a forward that needs draws
    # and is given none makes them from the generator
    _, model, mel, tok = _setup()
    W.encoder_forward.blocks_run = W.decoder_forward.blocks_run = 0
    draws = ForwardDraws(np.array([0.9, 0.1], np.float32), np.array([0.9, 0.9], np.float32), 0.0,
                         a[0].dsa_time, a[0].dsa_feat)
    cfg = TFC(compute_dtype="float32", stochastic_depth=0.5)
    model(torch.from_numpy(mel), torch.from_numpy(tok).long(), cfg, train=True, draws=draws)
    assert (W.encoder_forward.blocks_run, W.decoder_forward.blocks_run) == (1, 2)
    out = model(torch.from_numpy(mel), torch.from_numpy(tok).long(), cfg, train=True,
                generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
