"""``wft::layer_norm`` (``ops/layer_norm.py``) on the CPU, where it takes its
plain version: the model's composite (x cast to float32, ``F.layer_norm``,
one cast back, the deep SpecAugment keep-vectors multiplied in x's dtype)
and autograd through it, bit for bit; the model with the op against the
model with the composite, bit for bit; remat sites on the op; the launch
counts a step makes; the kernels' names in the benchmark's ``other`` group.
The kernels themselves run in ``tests/test_torch_cuda.py``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.yardstick.grouping import OTHER, group_of
from whisper_finetune_torch.models import init_params
from whisper_finetune_torch.models import whisper as W
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import ForwardConfig, ForwardDraws, axis_keep_masks
from whisper_finetune_torch.ops import layer_norm as LN
from whisper_finetune_torch.ops.remat import offload_to_host

ROOT = Path(__file__).resolve().parent.parent
DIMS = ModelDimensions(n_mels=16, n_audio_ctx=150, n_audio_state=64, n_audio_head=2,
                       n_audio_layer=3, n_vocab=300, n_text_ctx=24, n_text_state=64,
                       n_text_head=2, n_text_layer=2)


def composite(x, w, b, eps=1e-5, time_keep=None, feat_keep=None):
    """The model's layer norm before the op, keep-vectors as its encoder
    block applied them."""
    y = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)
    if x.dtype != torch.float32:
        y = y.to(x.dtype)
    if time_keep is not None:
        y = y * time_keep[None, :, None]
        y = y * feat_keep[None, None, :]
    return y


def _inputs(dtype, masks, B=3, T=50, d=64, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((B, T, d)) * 3 + 0.5).astype(np.float32)).to(dtype)
    w = torch.from_numpy((1 + 0.2 * rng.standard_normal(d)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32))
    tk = fk = None
    if masks:
        draws = rng.random((1, 2)).astype(np.float32), rng.random((1, 2)).astype(np.float32)
        tk = torch.from_numpy(axis_keep_masks(draws[0], T, 20)[0]).to(dtype)
        fk = torch.from_numpy(axis_keep_masks(draws[1], d, 27)[0]).to(dtype)
        assert 0 < tk.sum() < T and 0 < fk.sum() < d
    dy = torch.from_numpy(rng.standard_normal((B, T, d)).astype(np.float32)).to(dtype)
    return x, w, b, tk, fk, dy


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_op_is_the_composite_on_cpu(dtype, masks):
    """Forward, mean and rstd, and the registered backward against autograd
    through the composite: the same bits."""
    x, w, b, tk, fk, dy = _inputs(dtype, masks)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    y, mean, rstd = LN.layer_norm_op(xr, wr, br, 1e-5, tk, fk)
    got = torch.autograd.grad(y, (xr, wr, br), dy)
    xc, wc, bc = (t.clone().requires_grad_() for t in (x, w, b))
    ref = composite(xc, wc, bc, 1e-5, tk, fk)
    want = torch.autograd.grad(ref, (xc, wc, bc), dy)
    assert y.dtype == dtype and torch.equal(y, ref)
    _, m_ref, r_ref = torch.native_layer_norm(x.float(), (x.shape[-1],), w, b, 1e-5)
    assert mean.shape == rstd.shape == (x.numel() // x.shape[-1],)
    assert torch.equal(mean, m_ref.view(-1)) and torch.equal(rstd, r_ref.view(-1))
    assert not mean.requires_grad and not rstd.requires_grad
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)
    if masks:  # a masked time row gives no gradient to x; a masked column does
        assert (got[0][:, tk == 0] == 0).all() and (got[0][:, tk == 1] != 0).any()


def test_model_layer_norm_routes_bf16_through_the_op(monkeypatch):
    """bf16 and float16 go through ``wft::layer_norm``; float32 keeps
    ``F.layer_norm``, and takes the op only with keep-vectors: the composite's
    numbers every time."""
    calls = []
    real = LN.layer_norm_fwd
    monkeypatch.setattr(LN, "layer_norm_fwd", lambda *a: calls.append(a[0].dtype) or real(*a))
    p = {"scale": 1 + 0.1 * torch.randn(64), "bias": 0.1 * torch.randn(64)}
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        x = torch.randn(2, 5, 64).to(dtype)
        assert torch.equal(W.layer_norm(x, p), composite(x, p["scale"], p["bias"]))
    assert calls == [torch.bfloat16, torch.float16]
    x, w, b, tk, fk, _ = _inputs(torch.float32, True)
    got = W.layer_norm(x, {"scale": w, "bias": b}, time_keep=tk, feat_keep=fk)
    assert torch.equal(got, composite(x, w, b, 1e-5, tk, fk))
    assert calls == [torch.bfloat16, torch.float16, torch.float32]


def _model_run(model, mel, tok, cfg, draws):
    out = model(mel, tok, cfg, train=True, draws=draws)
    leaves = [p for _, p in model.leaves()]
    grads = torch.autograd.grad(out.float().square().mean(), leaves)
    return out.detach(), grads


def _draws():
    """Layer 1 of each side dropped, deep SpecAugment on."""
    base = W.draw_forward(torch.Generator().manual_seed(3), DIMS, "cpu")[0]
    return ForwardDraws(np.array([0.9, 0.05, 0.8], np.float32), np.array([0.9, 0.05], np.float32),
                        0.0, base.dsa_time, base.dsa_feat)


def _model_inputs():
    model = init_params(DIMS, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    mel = torch.randn((2, DIMS.n_mels, 2 * DIMS.n_audio_ctx), generator=gen)
    tok = torch.randint(0, DIMS.n_vocab, (2, DIMS.n_text_ctx), generator=gen)
    return model, mel, tok


TRAIN_KW = dict(compute_dtype="bfloat16", stochastic_depth=0.1, dsa_apply=True,
                dsa_time_mask_param=40, dsa_freq_mask_param=20)


@pytest.mark.parametrize("remat", [True, False])
def test_model_with_the_op_is_the_model_with_the_composite(monkeypatch, remat):
    """A bf16 training forward with stochastic depth and deep SpecAugment:
    logits and every gradient the same bits as with the composite."""
    model, mel, tok = _model_inputs()
    cfg = ForwardConfig(remat_encoder=remat, remat_decoder=remat, **TRAIN_KW)
    got = _model_run(model, mel, tok, cfg, _draws())

    def old(x, p, eps=1e-5, name=None, time_keep=None, feat_keep=None):
        return composite(x, p["scale"], p["bias"], eps, time_keep, feat_keep)

    monkeypatch.setattr(W, "layer_norm", old)
    want = _model_run(model, mel, tok, cfg, _draws())
    assert torch.equal(got[0], want[0])
    for g, r in zip(got[1], want[1]):
        assert torch.equal(g, r)


@pytest.mark.parametrize("policy", ["save:enc_ln1,enc_ln2,dec_ln2", "offload:enc_ln1,dec_ln1",
                                    "dots"])
def test_norm_sites_on_the_op(policy):
    """Remat sites on ``wft::layer_norm`` (bf16, deep SpecAugment on the
    kept ``enc_ln1``): full's numbers bit for bit; an offloaded norm stages
    y and its float32 mean and rstd."""
    model, mel, tok = _model_inputs()
    runs = []
    for pol in ("full", policy):
        offload_to_host.bytes = 0
        runs.append(_model_run(model, mel, tok, ForwardConfig(remat_policy=pol, **TRAIN_KW),
                               _draws()))
    assert torch.equal(runs[0][0], runs[1][0])
    for g, r in zip(runs[0][1], runs[1][1]):
        assert torch.equal(g, r)
    B, Ta, Tt, d = 2, DIMS.n_audio_ctx, DIMS.n_text_ctx, DIMS.n_audio_state
    staged = (2 * B * Ta * (d * 2 + 8) + 1 * B * Tt * (d * 2 + 8)) if policy.startswith(
        "offload") else 0  # two kept encoder blocks, one kept decoder block
    assert offload_to_host.bytes == staged


def _counting(monkeypatch):
    counts = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "layer_norm_fwd"), ("bwd", "layer_norm_bwd")):
        real = getattr(LN, name)

        def counted(*a, _real=real, _key=key):
            counts[_key] += 1
            return _real(*a)

        monkeypatch.setattr(LN, name, counted)
    return counts


@pytest.mark.parametrize("manual", [False, True])
def test_norm_calls_a_step(monkeypatch, manual):
    """The norms a training step runs, as the card's ``.launches`` count
    them: each kept block's norms (two an encoder block, three a decoder
    block) and the two final norms of each microbatch, forward once and
    backward once; the blocks' norms forward again in the remat recompute
    or the manual backward's replay, which replays ``ln_post`` too. The seed keeps a
    decoder block in each microbatch (else the encoder has no gradient and
    runs no backward)."""
    from whisper_finetune_torch.optim import adamw_8bit
    from whisper_finetune_torch.train import TrainState, make_train_step

    counts = _counting(monkeypatch)
    model, mel, tok = _model_inputs()
    tx = adamw_8bit(1e-3)
    state = TrainState(model, tx.init([p for _, p in model.leaves()]), 0)
    cfg = ForwardConfig(**{**TRAIN_KW, "stochastic_depth": 0.5})
    accum = 2
    step = make_train_step(DIMS, cfg, tx, 0.1, max_grad_norm=1.0, accum_dtype="float32",
                           split_update=manual, manual_backward=manual, device="cpu")
    batch = {"mel": mel[None].repeat(accum, 1, 1, 1), "dec_input": tok[None].repeat(accum, 1, 1),
             "dec_output": tok[None].repeat(accum, 1, 1)}
    W.encoder_forward.blocks_run = W.decoder_forward.blocks_run = 0
    step(state, batch, torch.Generator().manual_seed(7))
    E, D = W.encoder_forward.blocks_run, W.decoder_forward.blocks_run
    assert 0 < E < accum * DIMS.n_audio_layer and 0 < D < accum * DIMS.n_text_layer
    blocks, final = 2 * E + 3 * D, 2 * accum
    replayed = blocks + accum if manual else blocks
    assert counts == {"fwd": blocks + final + replayed, "bwd": blocks + final}


def test_kernel_names_fall_in_the_other_group():
    """``train.elementwise_ms`` counts the kernels: their names are the
    source's ``__global__`` functions and match no other group."""
    src = (ROOT / "whisper_finetune_torch" / "csrc" / "layer_norm.cu").read_text()
    found = re.findall(r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\(", src)
    assert sorted(found) == sorted(LN.KERNEL_NAMES)
    for name in LN.KERNEL_NAMES:
        assert group_of(f"void (anonymous namespace)::{name}<5>(__nv_bfloat16 const*, "
                        "float const*, long long, int)") == OTHER
