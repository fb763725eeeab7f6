"""The port's spans (``runtime.span``): off, they enter no profiler range;
under a CPU ``torch.profiler`` the one-pass step, the split step with the
manual backward and the decoders open the ``wft.*`` spans with the right
nesting; full remat opens the block spans again in the backward; the span
clock (``runtime.timed``) counts what the profiler sees."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from whisper_finetune_torch import runtime
from whisper_finetune_torch.models import init_params
from whisper_finetune_torch.models.decoding import beam_decode, greedy_decode
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import ForwardConfig
from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig
from whisper_finetune_torch.optim import get_optimizer
from whisper_finetune_torch.train import TrainState, make_train_step, trainable_leaves

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=16, n_audio_state=32, n_audio_head=2, n_audio_layer=2,
    n_vocab=64, n_text_ctx=12, n_text_state=32, n_text_head=2, n_text_layer=3,
)
ADAMW = {"type": "adamw", "8bit": False,
         "params": {"lr": 1e-3, "weight_decay": 0.01, "betas": [0.9, 0.98], "eps": 1e-6,
                    "amsgrad": False}}
ACCUM = 2


def _batch(seed=0, B=2):
    rng = np.random.default_rng(seed)
    n = DIMS.n_audio_ctx * 2 * 160
    return {"audio": torch.from_numpy((rng.standard_normal((ACCUM, B, n)) * 0.1)
                                      .astype(np.float32)),
            "crop_frames": torch.full((ACCUM, B), n // 160, dtype=torch.int32),
            "dec_input": torch.from_numpy(rng.integers(0, DIMS.n_vocab,
                                                       (ACCUM, B, DIMS.n_text_ctx))),
            "dec_output": torch.from_numpy(rng.integers(0, DIMS.n_vocab,
                                                        (ACCUM, B, DIMS.n_text_ctx)))}


def _step(split=False, manual=False, remat=True):
    model = init_params(DIMS, device="cpu", seed=1)
    tx, _ = get_optimizer(trainable_leaves(model), ADAMW)
    state = TrainState(model, tx.init([p for _, p in trainable_leaves(model)]), 0)
    fcfg = ForwardConfig(compute_dtype="float32", remat_encoder=remat, remat_decoder=remat)
    step = make_train_step(DIMS, fcfg, tx, label_smoothing=0.1,
                           feat_cfg=FeaturizeConfig(n_mels=80), max_grad_norm=1.0,
                           split_update=split, manual_backward=manual, device="cpu")
    return step, state


def _profiled(fn):
    """The ``wft.*`` spans ``fn()`` opens under a CPU profiler: (name,
    start, end, thread), sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("wft.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """Each span's innermost enclosing span's name on its thread (None at
    the top)."""
    out = []
    for i, (name, a, b, th) in enumerate(spans):
        enclosing = [s for s in spans[:i] if s[3] == th and s[1] <= a and b <= s[2]]
        out.append(enclosing[-1][0] if enclosing else None)
    return out


def _count(spans, name, parent="*"):
    return sum(1 for s, p in zip(spans, _parents(spans))
               if s[0] == name and (parent == "*" or p == parent))


def _inside(spans, name, outer):
    """How many ``name`` spans lie anywhere inside an ``outer`` span."""
    outers = [s for s in spans if s[0] == outer]
    return sum(1 for s in spans if s[0] == name
               and any(o[3] == s[3] and o[1] <= s[1] and s[2] <= o[2] for o in outers))


def test_span_off_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with tracing off")

    monkeypatch.setattr(runtime, "record_function", refuse)
    assert not torch.autograd._profiler_enabled() and runtime._clock is None
    assert runtime.span("wft.x") is runtime.span("wft.y")  # one shared no-op
    step, state = _step()
    state, loss = step(state, _batch())
    assert torch.isfinite(loss)
    with runtime.timed() as clock:  # the clock alone enters no range either
        state, loss = step(state, _batch(1))
    assert clock["wft.update"][0] == 1


@pytest.mark.parametrize("remat", [True, False])
def test_one_pass_step_spans(remat):
    step, state = _step(remat=remat)
    batch = _batch()
    spans = _profiled(lambda: step(state, batch))
    Le, Ld = DIMS.n_audio_layer, DIMS.n_text_layer
    assert _count(spans, "wft.features", None) == ACCUM
    assert _count(spans, "wft.encoder", None) == ACCUM
    assert _count(spans, "wft.decoder", None) == ACCUM
    assert _count(spans, "wft.enc_block", "wft.encoder") == ACCUM * Le
    assert _count(spans, "wft.dec_block", "wft.decoder") == ACCUM * Ld
    # one self- and one cross-attention a decoder block, one an encoder block
    assert _count(spans, "wft.attn", "wft.enc_block") == ACCUM * Le * (1 + remat)
    assert _count(spans, "wft.attn", "wft.dec_block") == 2 * ACCUM * Ld * (1 + remat)
    # the head and the loss forward, the loss backward inside the backward
    assert _count(spans, "wft.loss", None) == 2 * ACCUM
    assert _count(spans, "wft.loss", "wft.backward") == ACCUM
    assert _count(spans, "wft.backward", None) == ACCUM
    # full remat replays every block in the backward; without it none
    assert _inside(spans, "wft.enc_block", "wft.backward") == ACCUM * Le * remat
    assert _inside(spans, "wft.dec_block", "wft.backward") == ACCUM * Ld * remat
    assert _count(spans, "wft.grad_reduce", None) == ACCUM + 1  # the adds, the clip
    assert _count(spans, "wft.update", None) == 1
    assert _count(spans, "wft.sync") == 0


def test_split_step_manual_backward_spans():
    step, state = _step(split=True, manual=True)
    batch = _batch()
    spans = _profiled(lambda: step(state, batch))
    Le, Ld = DIMS.n_audio_layer, DIMS.n_text_layer
    assert _count(spans, "wft.features", None) == ACCUM
    assert _count(spans, "wft.enc_block", "wft.encoder") == ACCUM * Le
    assert _count(spans, "wft.dec_block", "wft.decoder") == ACCUM * Ld
    assert _count(spans, "wft.backward", None) == ACCUM
    # the head and its loss inside the backward, the loss's own backward in it
    assert _count(spans, "wft.loss", "wft.backward") == ACCUM
    assert _count(spans, "wft.loss", "wft.loss") == ACCUM
    # every kept layer replayed from its input, its gradients added
    assert _count(spans, "wft.enc_block", "wft.backward") == ACCUM * Le
    assert _count(spans, "wft.dec_block", "wft.backward") == ACCUM * Ld
    # a layer's adds, and those of the head's norm, the embeddings, the
    # encoder's last norm and the stem
    assert _inside(spans, "wft.grad_reduce", "wft.backward") == ACCUM * (Le + Ld + 4)
    assert _count(spans, "wft.sync", None) == 1  # the loss read (no card to synchronise)
    assert _count(spans, "wft.update", None) == 1
    assert _count(spans, "wft.grad_reduce", None) == 2  # the clip scale, the zeroing


@pytest.mark.parametrize("beam", [None, 2])
def test_decode_opens_one_token_step_a_position(beam):
    model = init_params(DIMS, device="cpu", seed=2)
    mel = torch.randn(2, DIMS.n_mels, 2 * DIMS.n_audio_ctx)
    init = torch.tensor([[1, 2, 3]] * 2)
    fcfg = ForwardConfig(compute_dtype="float32")
    max_len = 9
    if beam is None:
        run = lambda: greedy_decode(model.params(), mel, init, 0, DIMS, fcfg,  # noqa: E731
                                    max_len=max_len)
    else:
        run = lambda: beam_decode(model.params(), mel, init, 0, DIMS, fcfg,  # noqa: E731
                                  max_len=max_len, beam_size=beam)
    spans = _profiled(run)
    assert _count(spans, "wft.decode.token_step", None) == max_len - init.shape[1]
    assert _count(spans, "wft.decode.encode", None) == 1
    assert _count(spans, "wft.encoder", "wft.decode.encode") == 1
    assert _count(spans, "wft.decode.prefill", None) == 1
    assert _count(spans, "wft.dec_block") == 0  # the cached step runs its own loop


def test_transcribe_batch_spans():
    from whisper_finetune_torch.models.decoding import transcribe_batch
    from whisper_finetune_torch.tokenizer import get_tokenizer

    dims = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=32, n_audio_head=2,
                           n_audio_layer=1, n_vocab=51866, n_text_ctx=16, n_text_state=32,
                           n_text_head=2, n_text_layer=1)
    model = init_params(dims, device="cpu", seed=3)
    tok = get_tokenizer(multilingual=True, language="de", task="transcribe")
    audio = (np.random.default_rng(0).standard_normal((2, 480000)) * 0.05).astype(np.float32)
    spans = _profiled(lambda: transcribe_batch(
        model.params(), dims, audio, tok, fcfg=ForwardConfig(compute_dtype="float32"),
        language="de", max_len=8, temperatures=(0.0,), compression_ratio_threshold=None,
        logprob_threshold=None))
    for name in ("wft.decode.featurize", "wft.decode.encode", "wft.decode.prefill",
                 "wft.decode.to_host"):
        assert _count(spans, name, None) == 1, name
    assert _count(spans, "wft.decode.token_step", None) == 8 - 4


def test_span_clock_counts_what_the_profiler_sees():
    step, state = _step(split=True, manual=True)
    batch = _batch()
    with runtime.timed() as clock:
        spans = _profiled(lambda: step(state, batch))
    seen = {}
    for name, *_ in spans:
        seen[name] = seen.get(name, 0) + 1
    assert {k: v[0] for k, v in clock.items()} == seen
    assert all(v[1] > 0 for v in clock.values())
    # a span's wall time holds its children's: the encoder's against the
    # blocks that nest in it (the manual backward replays the blocks under
    # wft.backward, outside the encoder)
    nested = [b - a for (name, a, b, _), parent in zip(spans, _parents(spans))
              if name == "wft.enc_block" and parent == "wft.encoder"]
    assert 0 < len(nested) < _count(spans, "wft.enc_block")
    assert clock["wft.encoder"][1] >= sum(nested) * 1e-9 * 0.99 - 1e-3
    with runtime.timed() as outer:
        with runtime.timed() as inner:
            with runtime.span("wft.x"):
                pass
        with runtime.span("wft.y"):
            pass
    assert set(inner) == {"wft.x"} and set(outer) == {"wft.y"}
    assert runtime._clock is None
