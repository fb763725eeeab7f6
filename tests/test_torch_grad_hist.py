"""Gradient histograms (the ``wandb.watch(log="all")`` telemetry): the port's
``grad_histograms`` against the JAX package's on the same trees, and the
fused train step's third output against JAX's ``grad_histograms`` of that
step's own gradient sums, with JAX's range scaling. Counts, ranges: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.train.step import grad_histograms as j_grad_histograms
from whisper_finetune_torch.models import init_params
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import ForwardConfig
from whisper_finetune_torch.optim import get_optimizer
from whisper_finetune_torch.train import TrainState, grad_histograms, make_train_step
from whisper_finetune_torch.train import trainable_leaves

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=150, n_audio_state=64, n_audio_head=2, n_audio_layer=2,
    n_vocab=300, n_text_ctx=24, n_text_state=64, n_text_head=2, n_text_layer=2,
)


def _nested(named):
    """(path, tensor) pairs -> the nested dict of JAX arrays JAX's function takes."""
    tree = {}
    for path, t in named:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        a = jnp.asarray(t.detach().float().numpy())
        node[path[-1]] = a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a
    return tree


def _assert_hists_equal(got, want, scale=None):
    assert list(got) == list(want)
    for name, (c, lo, hi) in got.items():
        wc, wlo, whi = want[name]
        if scale is not None:
            wlo, whi = wlo * scale, whi * scale
        np.testing.assert_array_equal(c.numpy(), np.asarray(wc), err_msg=name)
        assert lo.dtype == hi.dtype == torch.float32
        assert (lo.item(), hi.item()) == (float(wlo), float(whi)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bins", [64, 7])
def test_grad_histograms_match_jax(dtype, bins):
    gen = torch.Generator().manual_seed(0)
    named = [(("encoder", "blocks", "w"), torch.randn((3, 40, 50), generator=gen)),
             (("encoder", "blocks", "b"), 3 * torch.randn((3, 50), generator=gen)),
             (("encoder", "conv1", "w"), torch.randn((20, 9), generator=gen) ** 3),
             (("decoder", "tok_emb"), torch.full((5, 7), 0.25))]  # zero span
    named = sorted((p, t.to(dtype)) for p, t in named)  # the flatten order of a tree
    got = grad_histograms(named, bins)
    _assert_hists_equal(got, j_grad_histograms(_nested(named), bins))
    assert int(got["encoder.blocks"][0].sum()) == 3 * 40 * 50 + 3 * 50


def test_fused_step_histograms_match_jax():
    """Every second step: zeros on the first, on the second the histograms
    of the step's bf16 gradient sums with ranges times 1 / accum."""
    model = init_params(DIMS, device="cpu", seed=0)
    named = trainable_leaves(model)
    tx, _ = get_optimizer(named, {"type": "adamw", "8bit": False, "params": {"lr": 1e-3}})
    sums = []
    apply = tx.fused_apply

    def capture(grads, *args, **kwargs):
        sums.append([g.clone() for g in grads])
        return apply(grads, *args, **kwargs)

    tx.fused_apply = capture
    step = make_train_step(DIMS, ForwardConfig(compute_dtype="float32"), tx, 0.1,
                           max_grad_norm=1.0, accum_dtype="bfloat16", grad_hist_every=2,
                           device="cpu")
    rng = np.random.default_rng(0)
    accum, B = 2, 2
    batch = {"mel": torch.from_numpy(rng.standard_normal(
                 (accum, B, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)),
             "dec_input": torch.from_numpy(rng.integers(0, DIMS.n_vocab,
                                                        (accum, B, DIMS.n_text_ctx))),
             "dec_output": torch.from_numpy(rng.integers(0, DIMS.n_vocab,
                                                         (accum, B, DIMS.n_text_ctx)))}
    state = TrainState(model, tx.init([p for _, p in named]), 0)
    state, loss, first = step(state, batch)
    assert all(int(c.abs().sum()) == 0 and lo.item() == hi.item() == 0.0
               for c, lo, hi in first.values())
    state, loss, second = step(state, batch)
    assert list(second) == list(first)
    paths = [path for path, _ in named]
    want = j_grad_histograms(_nested(list(zip(paths, sums[1]))), 64)
    _assert_hists_equal(second, want, scale=jnp.float32(1.0) / accum)
    n = sum(p.numel() for _, p in named)
    assert sum(int(c.sum()) for c, _, _ in second.values()) == n
