"""The card's attention mix (``resolve_auto_impls("cuda")``) on the CPU, where
the kernel wrappers run their plain twins. Every call a wrapper gets is
recorded with its ``causal`` flag and whether a ``wft.attn`` span is open, so
the decoder's causal self-attention is seen reaching ``attn_fwd`` /
``attn_bwd`` in the one-pass step under full remat (forward and recompute)
and in the split step's manual replay, never for a block that stochastic
depth dropped, and always inside ``wft.attn``. The step's loss and
gradients stay those of the plain causal site within float32 rounding."""

import contextlib

import numpy as np
import pytest
import torch

from whisper_finetune_torch.models import init_params
from whisper_finetune_torch.models import whisper as W
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import ForwardConfig
from whisper_finetune_torch.ops import attention as A
from whisper_finetune_torch.optim import get_optimizer
from whisper_finetune_torch.train import TrainState, make_train_step, trainable_leaves

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=12, n_audio_state=32, n_audio_head=2, n_audio_layer=2,
    n_vocab=64, n_text_ctx=10, n_text_state=32, n_text_head=2, n_text_layer=3,
)
ADAMW = {"type": "adamw", "8bit": False,
         "params": {"lr": 1e-3, "weight_decay": 0.01, "betas": [0.9, 0.98], "eps": 1e-6,
                    "amsgrad": False}}
ACCUM = 2
SD = 0.5  # stochastic depth: seed 2 drops blocks of both stacks
SEED = 2


def _batch(B=2):
    rng = np.random.default_rng(0)
    return {"mel": torch.from_numpy(rng.standard_normal(
                (ACCUM, B, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)),
            "dec_input": torch.from_numpy(rng.integers(0, DIMS.n_vocab, (ACCUM, B, DIMS.n_text_ctx))),
            "dec_output": torch.from_numpy(rng.integers(0, DIMS.n_vocab, (ACCUM, B, DIMS.n_text_ctx)))}


def _step(split: bool, card_mix: bool):
    model = init_params(DIMS, device="cpu", seed=1)
    tx, _ = get_optimizer(trainable_leaves(model), ADAMW)
    state = TrainState(model, tx.init([p for _, p in trainable_leaves(model)]), 0)
    mix = (A.resolve_auto_impls("cuda") if card_mix
           else dict(attn_impl_encoder="splash", attn_impl_cross="splash"))
    fcfg = ForwardConfig(compute_dtype="float32", stochastic_depth=SD, **mix)
    step = make_train_step(DIMS, fcfg, tx, label_smoothing=0.1, max_grad_norm=1.0,
                           split_update=split, manual_backward=split, device="cpu")
    return step, state


def _record(monkeypatch) -> list:
    """Patches the kernel wrappers and ``wft.attn``: each wrapper call
    appends (name, causal, inside wft.attn)."""
    calls, depth = [], [0]
    real_span, real_fwd, real_bwd = A.span, A.attn_fwd, A.attn_bwd

    @contextlib.contextmanager
    def span(name):
        with real_span(name):
            depth[0] += name == "wft.attn"
            try:
                yield
            finally:
                depth[0] -= name == "wft.attn"

    def fwd(q, k, v, causal, sm_scale, with_lse=True):
        calls.append(("attn_fwd", causal, depth[0] > 0))
        return real_fwd(q, k, v, causal, sm_scale, with_lse)

    def bwd(q, k, v, o, do, lse, causal, sm_scale):
        calls.append(("attn_bwd", causal, depth[0] > 0))
        return real_bwd(q, k, v, o, do, lse, causal, sm_scale)

    monkeypatch.setattr(A, "span", span)
    monkeypatch.setattr(A, "attn_fwd", fwd)
    monkeypatch.setattr(A, "attn_bwd", bwd)
    return calls


def _run(split: bool, card_mix: bool):
    """One accumulation (the split step) or one step (the one-pass step):
    (loss, the split step's gradient sums or None, blocks run)."""
    step, state = _step(split, card_mix)
    W.encoder_forward.blocks_run = W.decoder_forward.blocks_run = 0
    gen = torch.Generator().manual_seed(SEED)
    if split:
        buf, loss = step.accumulate(state, _batch(), gen)
    else:
        buf, (_, loss) = None, step(state, _batch(), gen)
    return loss.item(), buf, (W.encoder_forward.blocks_run, W.decoder_forward.blocks_run)


@pytest.mark.parametrize("split", [False, True], ids=["one_pass", "split_manual"])
def test_card_mix_runs_the_causal_site_on_the_kernels(monkeypatch, split):
    calls = _record(monkeypatch)
    loss, buf, (enc, dec) = _run(split, card_mix=True)
    # stochastic depth dropped blocks of both stacks, and they launch nothing
    assert 0 < enc < ACCUM * DIMS.n_audio_layer and 0 < dec < ACCUM * DIMS.n_text_layer
    count = {(name, causal): 0 for name in ("attn_fwd", "attn_bwd") for causal in (False, True)}
    for name, causal, _ in calls:
        count[name, causal] += 1
    assert count == {("attn_fwd", True): 2 * dec,   # forward and recompute / replay
                     ("attn_bwd", True): dec,
                     ("attn_fwd", False): 2 * (enc + dec),  # encoder self and cross
                     ("attn_bwd", False): enc + dec}
    assert all(inside for _, _, inside in calls)  # wft.attn owns every launch

    monkeypatch.undo()
    want_loss, want_buf, blocks = _run(split, card_mix=False)
    assert blocks == (enc, dec)
    # float32: the twins' softmax against the plain path's, in another order
    assert loss == pytest.approx(want_loss, rel=1e-6)
    if split:
        for a, b in zip(buf, want_buf):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
