"""The port's CUDA kernels against their plain twins on the card, at small
shapes and at the main path's. Marked ``cuda``: they skip where
``torch.cuda.is_available()`` is false. On a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from whisper_finetune_torch.tools import kernel_checks as KC

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _assert_auto_launches():
    """Since ``first_slice.reset_counts``, under ``attn_impl: auto`` with
    full remat: two kernel sites a decoder block run (its causal
    self-attention and the cross-attention) and one an encoder block, each
    launched forward twice (the forward and the recompute or replay) and
    backward once; the causal launches are the decoder blocks run, twice
    and once."""
    from whisper_finetune_torch.models import whisper as W
    from whisper_finetune_torch.ops import attention as A

    enc, dec = W.encoder_forward.blocks_run, W.decoder_forward.blocks_run
    assert enc > 0 and dec > 0
    assert [fn.launches for fn in A.KERNELS] == [2 * (enc + 2 * dec), enc + 2 * dec]
    assert [fn.causal_launches for fn in A.KERNELS] == [2 * dec, dec]


@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("B,H,Tq,Tk,causal", [
    (2, 3, 77, 131, False), (2, 3, 150, 150, False), (2, 3, 77, 77, True),
    (2, 3, 24, 150, False),   # fewer queries than one query tile
    (2, 3, 200, 200, True),
    (2, 3, 130, 40, False),   # fewer keys than one 64-key tile
    (2, 3, 70, 100, False),   # fewer keys than the forward's 128-key tile
    (2, 3, 300, 300, True),   # causal, three key tiles, Tq no multiple of a tile
    (2, 3, 129, 257, False),  # one query and one key past a whole tile
    (2, 3, 257, 257, True),   # the same, causal: a last query tile of one row
    *KC.ATTN_MAIN_SHAPES])
def test_attention_kernels_match_plain(card, B, H, Tq, Tk, causal, with_lse):
    """The forward instance (with or without its log-sum-exp write) and, with
    it, the fused backward and ``splash_mha``'s autograd against their float32
    twins, each run twice (``kernel_checks.check_attention``)."""
    KC.check_attention(B, H, Tq, Tk, causal, with_lse, card)


@pytest.mark.parametrize("Tq,Tk,causal", [(77, 131, False), (200, 200, True)])
def test_flash_routes_on_card(card, Tq, Tk, causal):
    """``flash`` launches the forward and ``attn_bwd``; ``flash_fwd`` the
    forward instance without the log-sum-exp and no backward kernel, its
    gradients being those of the plain path."""
    from whisper_finetune_torch.ops import attention as A

    def heads(T):
        return torch.randn((2, T, 3, 64), generator=card, device="cuda").to(torch.bfloat16).transpose(1, 2)

    q, k, v, do = heads(Tq), heads(Tk), heads(Tk), heads(Tq)
    grads = {}
    for impl, want in (("flash", [1, 1]), ("flash_fwd", [1, 0]), ("xla", [0, 0])):
        counts = [fn.launches for fn in A.KERNELS]
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        o = A.attention(qr, kr, vr, causal=causal, sm_scale=0.125, impl=impl)
        o.backward(do)
        assert [fn.launches - c for fn, c in zip(A.KERNELS, counts)] == want
        grads[impl] = (o.detach(), qr.grad, kr.grad, vr.grad)
    ref = A.attn_fwd_nolse_plain(q.float(), k.float(), v.float(), causal, 0.125)
    for impl in ("flash", "flash_fwd"):
        err = (grads[impl][0].float() - ref).abs().max().item()
        assert err <= 0.02 * ref.abs().max().item() + 1e-3
    assert torch.equal(grads["flash"][0], grads["flash_fwd"][0])  # one forward, lse or not
    for a, b in zip(grads["flash_fwd"][1:], grads["xla"][1:]):
        assert torch.equal(a, b)  # the plain backward on the same q, k, v


def test_muon_flagship_step_on_card(card):
    """Two flagship steps at toy size with ``attn_impl: flash``: launches
    equal the blocks the forward ran, and the parameters move."""
    from whisper_finetune_torch.models import ModelDimensions, init_params
    from whisper_finetune_torch.models import whisper as W
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.ops import attention as A
    from whisper_finetune_torch.optim import get_optimizer, get_schedule
    from whisper_finetune_torch.train import TrainState, make_train_step

    dims = ModelDimensions(n_mels=80, n_audio_ctx=150, n_audio_state=128, n_audio_head=2,
                           n_audio_layer=4, n_vocab=500, n_text_ctx=24, n_text_state=128,
                           n_text_head=2, n_text_layer=4)
    model = init_params(dims, seed=0)
    conf = {"muon": True, "muon_params": {"lr": 1e-3, "weight_decay": 0.01},
            "params": {"lr": 1e-3}, "muon_momentum_dtype": "int8", "muon_aux_8bit": True}
    tx, _ = get_optimizer(model.leaves(), conf, get_schedule({"type": "cosine", "warmup_steps": 1}, 10))
    leaves = [p for _, p in model.leaves()]
    state = TrainState(model, tx.init(leaves), 0)
    fcfg = ForwardConfig(attn_impl="flash", stochastic_depth=0.3, dsa_apply=True,
                         dsa_time_mask_param=40)
    step = make_train_step(dims, fcfg, tx, 0.1, max_grad_norm=1.0, accum_dtype="bfloat16")
    rng = np.random.default_rng(0)
    batch = {"mel": torch.from_numpy(rng.standard_normal((2, 2, 80, 300)).astype(np.float32)),
             "dec_input": torch.from_numpy(rng.integers(0, 500, (2, 2, 24))),
             "dec_output": torch.from_numpy(rng.integers(0, 500, (2, 2, 24)))}
    batch = {k: v.cuda() for k, v in batch.items()}
    before = [p.detach().clone() for p in leaves]
    for fn in A.KERNELS:
        fn.launches = 0
    W.encoder_forward.blocks_run = W.decoder_forward.blocks_run = 0
    for _ in range(2):
        state, loss = step(state, batch, card)
        assert np.isfinite(loss.item())
    sites = W.encoder_forward.blocks_run + 2 * W.decoder_forward.blocks_run
    assert 0 < sites < 2 * 2 * (4 + 8)
    assert [fn.launches for fn in A.KERNELS] == [2 * sites, sites]
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves))


@pytest.mark.parametrize("nb", [256, 100, 259330])  # 259330: large-v3's tok_emb, not a multiple of 128
def test_fused_adamw8_kernel_matches_plain(card, nb):
    """Three steps from zero moments, bit-equal to the twin."""
    p = torch.randn((nb, 256), generator=card, device="cuda")
    KC.check_adamw8(p, torch.zeros((nb, 256), dtype=torch.int8, device="cuda"),
                    torch.zeros((nb, 1), device="cuda"),
                    torch.zeros((nb, 256), dtype=torch.uint8, device="cuda"),
                    torch.zeros((nb, 1), device="cuda"), card)


def test_fused_adamw8_kernel_on_trained_state(card):
    """Three steps of the kernel and its twin from a model's own leaves and
    8-bit moments after four train steps (non-zero codes and scales), every
    quantized leaf: bit-equal."""
    from whisper_finetune_torch.models import ModelDimensions, init_params
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.ops.attention import resolve_auto_impls
    from whisper_finetune_torch.optim import adamw_8bit
    from whisper_finetune_torch.optim.quantized import BLOCK, QMoment
    from whisper_finetune_torch.tools.first_slice import reset_counts
    from whisper_finetune_torch.train import TrainState, make_train_step

    dims = ModelDimensions(n_mels=80, n_audio_ctx=150, n_audio_state=128, n_audio_head=2,
                           n_audio_layer=2, n_vocab=500, n_text_ctx=24, n_text_state=128,
                           n_text_head=2, n_text_layer=2)
    model = init_params(dims, seed=0)
    tx = adamw_8bit(3e-3)
    state = TrainState(model, tx.init([p for _, p in model.leaves()]), 0)
    step = make_train_step(dims, ForwardConfig(**resolve_auto_impls("cuda")), tx, 0.1,
                           max_grad_norm=1.0, accum_dtype="bfloat16")
    rng = np.random.default_rng(0)
    batch = {"mel": torch.from_numpy(rng.standard_normal((1, 2, 80, 300)).astype(np.float32)),
             "dec_input": torch.from_numpy(rng.integers(0, 500, (1, 2, 24))),
             "dec_output": torch.from_numpy(rng.integers(0, 500, (1, 2, 24)))}
    batch = {k: v.cuda() for k, v in batch.items()}
    reset_counts()
    for _ in range(4):
        state, loss = step(state, batch)
    assert np.isfinite(loss.item())
    _assert_auto_launches()
    checked = [KC.check_adamw8_leaf(p, mu, nu, card)
               for (_, p), mu, nu in zip(state.model.leaves(), state.opt_state.mu, state.opt_state.nu)
               if isinstance(mu, QMoment) and p.numel() % BLOCK == 0]
    assert len(checked) > 4 and all(r["m_codes_nonzero"] > 0 for r in checked)


def test_train_step_on_card(card):
    from whisper_finetune_torch.models import ModelDimensions, init_params
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.ops.attention import resolve_auto_impls
    from whisper_finetune_torch.optim import adamw_8bit
    from whisper_finetune_torch.tools.first_slice import reset_counts
    from whisper_finetune_torch.train import TrainState, make_train_step

    dims = ModelDimensions(n_mels=80, n_audio_ctx=150, n_audio_state=128, n_audio_head=2,
                           n_audio_layer=2, n_vocab=500, n_text_ctx=24, n_text_state=128,
                           n_text_head=2, n_text_layer=2)
    model = init_params(dims, seed=0)  # the default device is the card
    assert next(model.parameters()).is_cuda
    tx = adamw_8bit(3e-3)
    state = TrainState(model, tx.init([p for _, p in model.leaves()]), 0)
    step = make_train_step(dims, ForwardConfig(**resolve_auto_impls("cuda")), tx, 0.1,
                           max_grad_norm=1.0, accum_dtype="bfloat16")
    rng = np.random.default_rng(0)
    batch = {"mel": torch.from_numpy(rng.standard_normal((1, 2, 80, 300)).astype(np.float32)),
             "dec_input": torch.from_numpy(rng.integers(0, 500, (1, 2, 24))),
             "dec_output": torch.from_numpy(rng.integers(0, 500, (1, 2, 24)))}
    batch = {k: v.cuda() for k, v in batch.items()}
    reset_counts()
    losses = []
    for _ in range(4):
        state, loss = step(state, batch)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    _assert_auto_launches()


def test_split_step_launches_on_card(card):
    """The split step with the manual backward under ``attn_impl: auto`` and
    stochastic depth: the replay runs the decoder's causal self-attention
    through ``attn_fwd`` and ``attn_bwd`` (``_assert_auto_launches``), and a
    dropped block launches nothing."""
    from whisper_finetune_torch.models import ModelDimensions, init_params
    from whisper_finetune_torch.models import whisper as W
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.ops.attention import resolve_auto_impls
    from whisper_finetune_torch.optim import adamw_8bit
    from whisper_finetune_torch.tools.first_slice import reset_counts
    from whisper_finetune_torch.train import TrainState, make_train_step

    dims = ModelDimensions(n_mels=80, n_audio_ctx=150, n_audio_state=128, n_audio_head=2,
                           n_audio_layer=4, n_vocab=500, n_text_ctx=24, n_text_state=128,
                           n_text_head=2, n_text_layer=4)
    model = init_params(dims, seed=0)
    tx = adamw_8bit(1e-3)
    state = TrainState(model, tx.init([p for _, p in model.leaves()]), 0)
    fcfg = ForwardConfig(stochastic_depth=0.3, **resolve_auto_impls("cuda"))
    step = make_train_step(dims, fcfg, tx, 0.1, max_grad_norm=1.0, accum_dtype="bfloat16",
                           split_update=True, manual_backward=True)
    rng = np.random.default_rng(0)
    batch = {"mel": torch.from_numpy(rng.standard_normal((2, 2, 80, 300)).astype(np.float32)),
             "dec_input": torch.from_numpy(rng.integers(0, 500, (2, 2, 24))),
             "dec_output": torch.from_numpy(rng.integers(0, 500, (2, 2, 24)))}
    batch = {k: v.cuda() for k, v in batch.items()}
    reset_counts()
    for _ in range(2):
        state, loss = step(state, batch, card)
        assert np.isfinite(loss.item())
    assert W.encoder_forward.blocks_run + W.decoder_forward.blocks_run < 2 * 2 * (4 + 4)
    _assert_auto_launches()


@pytest.mark.parametrize("policy", ["dots", "save:enc_mlp_h,dec_ln2", "offload:enc_mlp_h,cross_kv"])
def test_remat_policies_on_card(card, policy):
    """A tiny model (width 128, two heads) on the card, bf16, the kernels at
    the encoder and cross sites: a remat policy gives full's logits bit for
    bit (its gradients within dq's run-to-run bits), and ``offload:`` stages
    its sites through pinned host memory."""
    from whisper_finetune_torch.models import ForwardConfig, init_params
    from whisper_finetune_torch.models.dims import ModelDimensions
    from whisper_finetune_torch.ops.remat import offload_to_host

    dims = ModelDimensions(n_mels=16, n_audio_ctx=150, n_audio_state=128, n_audio_head=2,
                           n_audio_layer=2, n_vocab=300, n_text_ctx=24, n_text_state=128,
                           n_text_head=2, n_text_layer=2)
    model = init_params(dims, device="cuda", seed=0)
    mel = torch.randn((2, 16, 300), generator=card, device="cuda")
    tok = torch.randint(0, 300, (2, 24), generator=card, device="cuda")
    leaves = [p for _, p in model.leaves()]
    outs = []
    offload_to_host.bytes = 0
    for pol in ("full", policy):
        cfg = ForwardConfig(remat_policy=pol, attn_impl_encoder="splash", attn_impl_cross="splash")
        out = model(mel, tok, cfg, train=True)
        outs.append((out.detach(), torch.autograd.grad(out.float().square().mean(), leaves)))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert (a.float() - b.float()).abs().max().item() <= 1e-2 * a.abs().max().item() + 1e-6
    staged = 2 * 150 * 4 * 128 * 2 * 2 + 2 * 2 * 150 * 128 * 2 * 2  # fc1 per enc layer; k, v per dec layer
    assert offload_to_host.bytes == (staged if policy.startswith("offload") else 0)


def test_driver_on_card(card, tmp_path, monkeypatch):
    """``scripts/finetune.py``'s ``main`` on the tiny preset (4 + 4 layers,
    random weights) over the debug dataset: 2 optimizer steps of 4
    microbatches of 2, eval at step 0 and 2 on 4 rows in batches of 2. Each
    microbatch launches the forward twice a site (forward and remat
    recompute) and the backward once; each eval batch the forward once a
    site. The ``metrics.jsonl`` keys are the JAX driver's."""
    import json
    from pathlib import Path

    import yaml

    from tools.make_debug_dataset import main as make_dataset
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.ops.attention import resolve_auto_impls
    from whisper_finetune_torch.scripts import finetune
    from whisper_finetune_torch.tools.first_slice import attn_sites, reset_counts

    root = Path(__file__).resolve().parent.parent
    monkeypatch.setenv("WFT_ALLOW_RANDOM_INIT", "1")
    make_dataset(str(tmp_path / "ds"), n=16)
    config = yaml.safe_load((root / "configs" / "DEBUG.yaml").read_text())
    config["dataset"].update(train_datasets=[str(tmp_path / "ds")],
                             val_datasets=[str(tmp_path / "ds")], select_n_per_v_ds=[4],
                             batch_size=2, batch_size_eval=2)
    config["training"].update(epochs=1, eval_steps=1.0, accum_grad_steps=4)
    config["save_dir"] = str(tmp_path / "out")
    kernels = reset_counts()
    state, run_dir = finetune.main(config, device="cuda")
    launches = {fn.__name__: fn.launches for fn in kernels}
    sites = attn_sites(ForwardConfig(**resolve_auto_impls("cuda")),
                       state.model.dims.n_audio_layer, state.model.dims.n_text_layer)["fwd"]
    micro, eval_batches = 2 * 4, 2 * 2
    assert launches == {"attn_fwd": 2 * sites * micro + sites * eval_batches,
                        "attn_bwd": sites * micro, "fused_adamw8_leaf": 0}
    records = [json.loads(line) for line in open(Path(run_dir) / "metrics.jsonl")]
    keys = sorted(set().union(*records))
    assert keys == json.loads((root / "tests" / "driver_metrics_keys.json").read_text())
    assert (Path(run_dir) / "last_model.pt").exists()


@pytest.mark.parametrize("widths", ["tiny", "large-v3"])
def test_graphed_greedy_on_card(card, monkeypatch, widths):
    """Greedy decoding with the token step replayed as a CUDA graph against
    the eager step, bf16, the default filters, on a device named explicitly
    (the last card: another than the current one where there are two):
    8 rows, 8 again with new audio (no capture; prompt and token loop under
    ``set_sync_debug_mode("error")``), 2 rows (a recapture at the new row
    count), 8 again (another): the same tokens and average log-probs within
    1e-6 each time. ``release`` then gives the held bytes back, and another
    capture and release leave nothing behind.
    ``large-v3``: its widths and vocabulary with 2 + 2 layers, 224
    positions."""
    from whisper_finetune_torch.models import decoding as D
    from whisper_finetune_torch.models import init_params
    from whisper_finetune_torch.models.dims import MODEL_PRESETS, ModelDimensions
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.tokenizer import get_tokenizer

    if widths == "tiny":
        dims = ModelDimensions(n_mels=80, n_audio_ctx=40, n_audio_state=64, n_audio_head=2,
                               n_audio_layer=2, n_vocab=51866, n_text_ctx=32, n_text_state=64,
                               n_text_head=2, n_text_layer=2)
        max_len = 24
    else:
        dims = MODEL_PRESETS["large-v3"].replace(n_audio_layer=2, n_text_layer=2)
        max_len = 224
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    N = 8
    tok = get_tokenizer(multilingual=True, language="de", task="transcribe")
    filters = D.default_filters(tok)
    init = torch.tensor([list(tok.sot_sequence) + [tok.no_timestamps]] * N, device=dev)
    params = init_params(dims, device=dev, seed=1).params()
    fcfg = ForwardConfig(compute_dtype="bfloat16")
    mels = [torch.randn((N, dims.n_mels, 2 * dims.n_audio_ctx), generator=card,
                        device="cuda").to(dev) for _ in range(3)]
    calls = [(mels[0], N), (mels[1], N), (mels[2], 2), (mels[2], N)]

    def decode(mel, rows):
        return D.greedy_decode(params, mel[:rows], init[:rows], tok.eot, dims, fcfg,
                               max_len=max_len, filters=filters)

    monkeypatch.setattr(D, "_CAPTURE", {})
    eager = [decode(mel, rows) for mel, rows in calls]
    monkeypatch.undo()
    monkeypatch.setattr(D, "_GRAPHED", {})
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    real_loop = D._greedy_loop

    def loop_without_sync(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_loop(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    g = D.greedy_decode
    for c, ((mel, rows), (tokens, avg_lp)) in enumerate(zip(calls, eager)):
        monkeypatch.setattr(D, "_greedy_loop", loop_without_sync if c == 1 else real_loop)
        before = (g.graph_captures, g.graph_replays, g.eager_steps)
        got_tokens, got_lp = decode(mel, rows)
        after = (g.graph_captures, g.graph_replays, g.eager_steps)
        assert after == (before[0] + (c != 1), before[1] + max_len, before[2]), c
        assert torch.equal(got_tokens, tokens), c
        assert (got_lp - avg_lp).abs().max().item() <= 1e-6, c
    assert not torch.equal(eager[0][1], eager[1][1])  # the audio mattered
    held = torch.cuda.memory_allocated(dev) - base
    assert held > dims.n_vocab * dims.n_text_state * 4  # the float32 head at least
    del got_tokens, got_lp
    D.release()
    released = torch.cuda.memory_allocated(dev)
    # what stays is the capture stream's cuBLAS workspaces (the first test's)
    assert not D._GRAPHED and released - base < min(held, 2**26)
    decode(*calls[2])  # a capture and a release again hold nothing more
    D.release()
    assert torch.cuda.memory_allocated(dev) - released < 2**20


def test_empty_cuda_graph_raises(card):
    """A capture that records nothing (the failure of a step whose work goes
    to another device's stream) raises instead of replaying nothing."""
    from whisper_finetune_torch.models import decoding as D

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    x = torch.zeros(4, device=dev)
    D._cuda_graph(lambda: x.add_(1), dev)()  # warm-up, capture, one replay
    torch.cuda.synchronize(dev)
    assert x.tolist() == [2.0] * 4
    with pytest.raises(RuntimeError, match="is empty"):
        D._cuda_graph(lambda: None, dev)


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("n,d", [(48000, 1280), (96000, 1280), (8, 1280), (3000, 384),
                                 (300, 128)])
def test_layer_norm_kernel_matches_plain(card, n, d, masks):
    """``wft::layer_norm`` on the card against its plain version (the
    composite, float32 on the card), forward and backward, and the backward
    twice (``kernel_checks.check_layer_norm``)."""
    KC.check_layer_norm(n, d, masks, card)


def test_layer_norm_kernel_in_a_cuda_graph(card):
    """The op and its backward captured in a CUDA graph and replayed, and run
    eagerly, under ``set_sync_debug_mode("error")``: no host sync, the
    eager results' bits."""
    from whisper_finetune_torch.ops import layer_norm as LN

    x, w, b, dy, tk, fk = KC.layer_norm_inputs(card, 3000, 1280, True)

    def run():
        y, mean, rstd = LN.layer_norm_op(x, w, b, 1e-5, tk, fk)
        return (y, mean, rstd) + LN.layer_norm_bwd(dy, x, mean, rstd, w, b, tk, fk)

    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        torch.cuda.set_sync_debug_mode("error")
        try:
            captured = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for out in captured:
        out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)


def test_layer_norm_launches_a_step_on_card(card):
    """A tiny model's one-pass train step on the card, bf16, deep SpecAugment
    and stochastic depth on: ``.launches`` equal the norms the step ran
    (``tests/test_torch_layer_norm.py::test_norm_calls_a_step`` derives the
    count on the CPU): forward ``2 * blocks + 2 * accum``, backward
    ``blocks + 2 * accum`` with ``blocks`` two a kept encoder block and
    three a kept decoder block."""
    from whisper_finetune_torch.models import ModelDimensions, init_params
    from whisper_finetune_torch.models import whisper as W
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.ops import layer_norm as LN
    from whisper_finetune_torch.optim import adamw_8bit
    from whisper_finetune_torch.train import TrainState, make_train_step

    dims = ModelDimensions(n_mels=80, n_audio_ctx=150, n_audio_state=128, n_audio_head=2,
                           n_audio_layer=4, n_vocab=500, n_text_ctx=24, n_text_state=128,
                           n_text_head=2, n_text_layer=4)
    model = init_params(dims, seed=0)
    tx = adamw_8bit(1e-3)
    state = TrainState(model, tx.init([p for _, p in model.leaves()]), 0)
    fcfg = ForwardConfig(attn_impl="flash", stochastic_depth=0.2, dsa_apply=True,
                         dsa_time_mask_param=40)
    step = make_train_step(dims, fcfg, tx, 0.1, max_grad_norm=1.0, accum_dtype="bfloat16")
    rng = np.random.default_rng(0)
    accum = 2
    batch = {"mel": torch.from_numpy(rng.standard_normal((accum, 2, 80, 300)).astype(np.float32)),
             "dec_input": torch.from_numpy(rng.integers(0, 500, (accum, 2, 24))),
             "dec_output": torch.from_numpy(rng.integers(0, 500, (accum, 2, 24)))}
    batch = {k: v.cuda() for k, v in batch.items()}
    for fn in LN.KERNELS:
        fn.launches = 0
    W.encoder_forward.blocks_run = W.decoder_forward.blocks_run = 0
    state, loss = step(state, batch, card)
    assert np.isfinite(loss.item())
    blocks = 2 * W.encoder_forward.blocks_run + 3 * W.decoder_forward.blocks_run
    assert [fn.launches for fn in LN.KERNELS] == [2 * blocks + 2 * accum, blocks + 2 * accum]
