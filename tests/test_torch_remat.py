"""The remat grammar of the port (``ops/remat.py``, the named sites of
``models/whisper.py`` and ``ops/attention.py::xla_mha``) against the port's
own ``full`` remat and against JAX's ``forward_impl`` under the same policy.

A policy changes what a checkpointed block keeps, never its numbers: on the
CPU the port's logits are bit-equal to ``full``'s and its gradients within
1e-6 (they come out bit-equal). Against JAX: logits within 1e-5 of the
largest logit and gradients within 1e-4 of each leaf's largest gradient,
float32 in another order, the tolerances of ``test_torch_model.py``. A
dispatch mode that counts the matrix products of the backward shows what the
recompute skips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_tpu.models.whisper import forward_impl as j_forward
from whisper_finetune_torch.models import params_from_jax
from whisper_finetune_torch.models import whisper as W
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import ForwardConfig as TFC
from whisper_finetune_torch.models.whisper import ForwardDraws, flatten
from whisper_finetune_torch.ops.remat import offload_to_host, parse_remat_policy

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=150, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_vocab=300, n_text_ctx=24, n_text_state=64, n_text_head=2, n_text_layer=2,
)
TD = TDims(**DIMS.to_dict())
SITES = dict(attn_impl_encoder="splash", attn_impl_cross="splash")
NAMES = ("enc_qkv", "dec_qkv", "cross_q", "cross_kv", "enc_mlp_h", "dec_mlp_h", "enc_ln1",
         "enc_ln2", "dec_ln1", "dec_ln_cross", "dec_ln2", "attn_probs", "cross_attn_probs")
FORMS = ["dots", "attn", *[f"save:{n}" for n in NAMES], "offload:enc_mlp_h,dec_qkv",
         "save:enc_mlp_h,dec_ln2+offload:enc_qkv,cross_attn_probs"]


@pytest.fixture(scope="module")
def setup():
    params = jax_init_params(jax.random.PRNGKey(0), DIMS)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((2, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    tok = rng.integers(0, DIMS.n_vocab, (2, DIMS.n_text_ctx)).astype(np.int32)
    cot = rng.standard_normal((2, DIMS.n_text_ctx, DIMS.n_vocab)).astype(np.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), TD, device="cpu")
    return params, model, mel, tok, cot


def _port(model, mel, tok, cot, cfg, draws=None):
    """Logits and parameter gradients of sum(logits * cot), a training forward."""
    out = model(torch.from_numpy(mel), torch.from_numpy(tok).long(), cfg, train=True,
                draws=draws)
    leaves = [p for _, p in model.leaves()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    return out.detach(), {path: g for (path, _), g in zip(model.leaves(), grads)}


def _assert_same_as_full(full, got):
    assert torch.equal(full[0], got[0])
    for path, g in full[1].items():
        assert (got[1][path] - g).abs().max() <= 1e-6, path


@pytest.mark.parametrize("policy", FORMS)
def test_remat_form_matches_full_and_jax(setup, policy):
    """Plain attention at every site, so both probability sites exist."""
    params, model, mel, tok, cot = setup
    kw = dict(compute_dtype="float32")
    full = _port(model, mel, tok, cot, TFC(**kw))
    got = _port(model, mel, tok, cot, TFC(remat_policy=policy, **kw))
    _assert_same_as_full(full, got)

    def jloss(p):
        logits = j_forward(p, jnp.asarray(mel), jnp.asarray(tok), DIMS,
                           JFC(remat_policy=policy, **kw), train=True)
        return jnp.sum(logits * cot), logits

    (_, ref), ref_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    ref = np.asarray(ref)
    assert np.abs(got[0].numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    for path, g in flatten(jax.tree.map(np.asarray, ref_g)):
        scale = max(np.abs(g).max(), 1e-3)
        np.testing.assert_allclose(got[1][path].numpy(), g, atol=1e-4 * scale, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("policy", ["dots", "save:enc_mlp_h,enc_qkv+offload:dec_mlp_h"])
def test_remat_forms_bf16_kernel_sites(setup, policy):
    """bf16 compute with the kernels' plain twins at the encoder and cross
    sites (the card's configuration): still bit-equal to full."""
    _, model, mel, tok, cot = setup
    kw = dict(compute_dtype="bfloat16", **SITES)
    _assert_same_as_full(_port(model, mel, tok, cot, TFC(**kw)),
                         _port(model, mel, tok, cot, TFC(remat_policy=policy, **kw)))


@pytest.mark.parametrize("policy", ["dots", "attn", "save:enc_ln1,dec_ln1", "offload:enc_mlp_h"])
def test_remat_forms_under_stochastic_depth_and_dsa(setup, policy):
    """Given draws that drop a layer on each side and mask with deep
    SpecAugment: every policy runs the same blocks as full (a dropped layer
    runs nothing) and gives its numbers."""
    _, model, mel, tok, cot = setup
    base = W.draw_forward(torch.Generator().manual_seed(3), TD, "cpu")[0]
    draws = ForwardDraws(np.array([0.9, 0.1], np.float32), np.array([0.1, 0.9], np.float32),
                         0.0, base.dsa_time, base.dsa_feat)
    kw = dict(compute_dtype="float32", stochastic_depth=0.5, dsa_apply=True,
              dsa_time_mask_param=40, dsa_freq_mask_param=20)
    runs = []
    for pol in ("full", policy):
        W.encoder_forward.blocks_run = W.decoder_forward.blocks_run = 0
        res = _port(model, mel, tok, cot, TFC(remat_policy=pol, **kw), draws=draws)
        runs.append((res, W.encoder_forward.blocks_run, W.decoder_forward.blocks_run))
    assert runs[0][1:] == runs[1][1:] == (1, 1)
    _assert_same_as_full(runs[0][0], runs[1][0])


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products without batch dimensions that run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_products(model, mel, tok, cfg) -> int:
    out = model(torch.from_numpy(mel), torch.from_numpy(tok).long(), cfg, train=True)
    loss = out.square().sum()
    with _CountProducts() as count:
        torch.autograd.grad(loss, [p for _, p in model.leaves()])
    return count.n


def test_dots_and_save_skip_their_recompute(setup):
    """The backward's products: under full the recompute redoes every
    projection before the last one a block saves for (fc2's input ends the
    recompute: q, k, v, out, fc1 in an encoder block, and the cross
    projections too in a decoder block); ``dots`` redoes none of them,
    ``save:enc_mlp_h`` skips fc1 of each encoder layer only."""
    _, model, mel, tok, _ = setup
    count = {pol: _backward_products(model, mel, tok, TFC(compute_dtype="float32",
                                                          remat_policy=pol))
             for pol in ("full", "dots", "save:enc_mlp_h", "save:enc_ln2")}
    Le, Ld = DIMS.n_audio_layer, DIMS.n_text_layer
    assert count["full"] - count["dots"] == 5 * Le + 9 * Ld
    assert count["full"] - count["save:enc_mlp_h"] == Le
    assert count["save:enc_ln2"] == count["full"]  # a kept layer norm saves no product
    no_remat = _backward_products(model, mel, tok, TFC(compute_dtype="float32",
                                                       remat_encoder=False, remat_decoder=False))
    assert no_remat == count["dots"]


def test_offload_stages_exactly_the_named_sites(setup):
    """Bytes staged to the host per forward: fc1's output per encoder layer
    (B, T, 4d) float32; under splash sites only the decoder's
    self-attention probabilities exist, so ``cross_attn_probs`` stages
    nothing there."""
    _, model, mel, tok, cot = setup
    B, T, d = 2, DIMS.n_audio_ctx, DIMS.n_audio_state
    offload_to_host.bytes = 0
    _port(model, mel, tok, cot, TFC(compute_dtype="float32", remat_policy="offload:enc_mlp_h"))
    assert offload_to_host.bytes == DIMS.n_audio_layer * B * T * 4 * d * 4
    offload_to_host.bytes = 0
    _port(model, mel, tok, cot, TFC(compute_dtype="bfloat16", remat_policy="offload:attn_probs,"
                                    "cross_attn_probs", **SITES))
    Tt, H = DIMS.n_text_ctx, DIMS.n_text_head
    assert offload_to_host.bytes == DIMS.n_text_layer * B * H * Tt * Tt * 2


def test_grad_norms_catch_a_lost_offloaded_site(setup, monkeypatch):
    """The card's remat check (``chip_smoke.py``) holds a policy's first-step
    gradients against full's by their per-layer norms: a policy equal to
    full passes far inside the limit, and an offloaded site handed back as
    zeros in one layer (a planted fault) moves that layer's norms by O(1)."""
    from whisper_finetune_torch.ops import remat as R
    from whisper_finetune_torch.tools import first_slice as fs

    _, model, mel, tok, cot = setup
    paths = [path for path, _ in model.leaves()]

    def norms(policy):
        _, g = _port(model, mel, tok, cot, TFC(compute_dtype="float32", remat_policy=policy))
        return fs.layer_grad_norms(paths, [g[path] for path in paths])

    full = norms("full")
    assert len(full) > len(paths)  # one norm per layer of a stacked leaf
    assert fs.norms_rel_diff(norms("offload:enc_mlp_h"), full) <= 1e-5
    real, restored = R._unstage, []

    def lost(entry):
        restored.append(entry)
        out = real(entry)
        return torch.zeros_like(out) if len(restored) == 1 else out

    monkeypatch.setattr(R, "_unstage", lost)
    assert fs.norms_rel_diff(norms("offload:enc_mlp_h"), full) > 0.5
    assert len(restored) == DIMS.n_audio_layer


def test_record_grad_norms_keeps_the_first_update():
    from whisper_finetune_torch.tools import first_slice as fs

    class Tx:
        def fused_apply(self, grads, state, params, g_scale=None):
            return state + 1

    tx = Tx()
    paths = [("encoder", "blocks", "mlp", "w"), ("decoder", "ln", "g")]
    seen = fs.record_grad_norms(tx, paths)
    g = [torch.tensor([[3.0, 4.0], [0.0, 1.0]]), torch.tensor([1.0, 2.0, 2.0])]
    assert tx.fused_apply(g, 0, None, g_scale=1.0) == 1
    assert tx.fused_apply([x * 2 for x in g], 1, None) == 2
    assert len(seen) == 1 and torch.equal(seen[0], torch.tensor([5.0, 1.0, 3.0]))
    assert fs.norms_rel_diff(seen[0] * 1.5, seen[0]) == pytest.approx(0.5)
    assert fs.norms_rel_diff(seen[0] * float("nan"), seen[0]) == float("inf")


@pytest.mark.parametrize("bad,match", [
    ("save:", "needs at least one name"),
    ("offload:+save:", "needs at least one name"),
    ("save:enc_qkv+dots", "segment 'dots': expected 'save:...' or 'offload:...'"),
    ("everything", "Unknown remat_policy: everything"),
])
def test_bad_policies_raise_jax_errors(setup, bad, match):
    params, model, mel, tok, _ = setup
    with pytest.raises(ValueError, match=match):
        parse_remat_policy(bad)
    with pytest.raises(ValueError, match=match):
        model(torch.from_numpy(mel), torch.from_numpy(tok).long(),
              TFC(compute_dtype="float32", remat_policy=bad), train=True)
    with pytest.raises(ValueError, match=match):
        j_forward(params, jnp.asarray(mel), jnp.asarray(tok), DIMS,
                  JFC(compute_dtype="float32", remat_policy=bad), train=True)


@pytest.mark.parametrize("enc,last_only,dec,raises", [
    (False, False, False, False), (True, False, False, True), (False, False, True, True),
    (False, True, False, True),
])
def test_bad_policy_raises_only_where_a_block_is_rematted(setup, enc, last_only, dec, raises):
    """A ``remat_policy`` outside the grammar raises JAX's error only when a
    block is rematted (JAX raises when it traces one): with remat off both
    forwards run, and their logits agree."""
    params, model, mel, tok, _ = setup
    kw = dict(compute_dtype="float32", remat_policy="everything", remat_encoder=enc,
              remat_encoder_last_only=last_only, remat_decoder=dec)
    def port():
        return model(torch.from_numpy(mel), torch.from_numpy(tok).long(), TFC(**kw), train=True)

    def jax_fwd():
        return j_forward(params, jnp.asarray(mel), jnp.asarray(tok), DIMS, JFC(**kw), train=True)

    if raises:
        for fwd in (port, jax_fwd):
            with pytest.raises(ValueError, match="Unknown remat_policy: everything"):
                fwd()
        with pytest.raises(ValueError, match="Unknown remat_policy"):
            TFC(**kw).check_supported(DIMS.n_audio_layer)
        return
    np.testing.assert_allclose(port().detach().numpy(), np.asarray(jax_fwd()), atol=1e-4, rtol=0)
    TFC(**kw).check_supported(DIMS.n_audio_layer)


def test_policy_grammar():
    p = parse_remat_policy("save:enc_qkv, dec_qkv+offload:enc_mlp_h+save:enc_qkv")
    assert p.saved == {"enc_qkv", "dec_qkv"} and p.offloaded == {"enc_mlp_h"}
    assert p.action("enc_qkv", dot=True) == "save" and p.action(None, dot=True) is None
    assert parse_remat_policy("dots").action(None, dot=True) == "save"
    assert parse_remat_policy("attn").saved == {"attn_probs", "cross_attn_probs"}
    assert parse_remat_policy("full").is_full
    both = parse_remat_policy("save:enc_qkv+offload:enc_qkv")  # JAX: saving wins
    assert both.action("enc_qkv", dot=False) == "save"
