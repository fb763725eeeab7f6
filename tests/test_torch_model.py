"""The port's model forward against the JAX package's ``forward_impl`` on
identical weights (carried across by ``params_from_jax``), with splash
attention on the encoder and cross-attention sites in both (Pallas interpret
mode in JAX, the kernels' plain twins in the port)."""

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
