"""Uni-MoE-2.0-Omni's speech-to-text path (``models/omni.py``) against the
benchmark's plain float32 reference (``benchmark/reference/omni.py``, which
imports nothing of the port) on the same seeded weights, at a tiny size on
the CPU: the routing rule, the MoE layer, the full forward's logits, the
cached decoder against the full forward, the tower against
``encoder_forward``, ``transcribe_batch`` and the CLI end to end, the
graph-shaped token step and its counters. The card test (marked ``cuda``)
holds the captured token step to the eager one at the preset's widths."""

import numpy as np
import pytest
import torch

from benchmark.omni_weights import ReferenceLeaves, program_weights
from benchmark.reference import omni as R
from benchmark.reference.whisper import Precision
from whisper_finetune_torch.models import decoding as D
from whisper_finetune_torch.models import omni
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import ForwardConfig, Whisper, encoder_forward

TOWER = ModelDimensions(n_mels=128, n_audio_ctx=1500, n_audio_state=32, n_audio_head=1,
                        n_audio_layer=1, n_vocab=64, n_text_ctx=8, n_text_state=32,
                        n_text_head=1, n_text_layer=1)
DIMS = omni.OMNI_PRESETS["uni-moe-2.0-omni"].replace(
    tower=TOWER, d_model=64, n_layer=2, n_head=4, n_kv_head=2, head_dim=16, n_vocab=512,
    fixed_width=24, dynamic_width=40, audio_tokens=8, eot=511)
SEED = 2**31 + 9
F32 = ForwardConfig(compute_dtype="float32")
PROMPT = ([5, 6, 7, 8], [9, 10, 11, 12])


@pytest.fixture(scope="module")
def model():
    return omni.OmniModel(DIMS, program_weights(DIMS.to_dict(), SEED, "cpu", torch.float32))


@pytest.fixture(scope="module")
def clips():
    return torch.randn((3, 480000), generator=torch.Generator().manual_seed(3)) * 0.05


def _mel(clips):
    from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig, featurize_impl

    return featurize_impl(clips, torch.full((clips.shape[0],), 3000, dtype=torch.int32), None,
                          FeaturizeConfig(n_mels=128), train=False)


def _ids(rows: int, served=()):
    seq = PROMPT[0] + [omni.AUDIO_ID] * DIMS.audio_tokens + PROMPT[1] + list(served)
    return torch.tensor([seq] * rows)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probs,want", [
    ([0.75, 0.1, 0.05, 0.05, 0.05], [1, 0, 0, 0, 0]),  # top-1 reaches 0.7: the cut at 1
    ([0.3, 0.35, 0.2, 0.1, 0.05], [1, 1, 0, 0, 0]),  # 0.65 < 0.7: the cap at 2
    ([0.1, 0.5, 0.05, 0.05, 0.3], [0, 1, 0, 0, 1]),  # the null expert selected
    ([0.05, 0.05, 0.05, 0.05, 0.8], [0, 0, 0, 0, 1]),  # only the null expert
    ([0.3, 0.3, 0.3, 0.05, 0.05], [1, 1, 0, 0, 0]),  # ties to the lower index
    ([0.6, 0.1, 0.1, 0.1, 0.1], [1, 1, 0, 0, 0]),  # ties below the first, lower index
])
def test_route_rule(probs, want):
    z = torch.log(torch.tensor([probs], dtype=torch.float32))
    p, sel = omni.route(z, 0.7, 2)
    assert sel.int().tolist() == [want]
    ref_sel, margin = R.select(p, 0.7, 2)
    assert torch.equal(sel, ref_sel) and float(margin) >= 0


@pytest.mark.parametrize("grouped", [True, False])
def test_moe_matches_reference(model, grouped):
    """The layer over 40 tokens, grouped by expert and dense-masked, against
    the reference's: fixed experts always on, the null expert adding 0."""
    bp = omni.layer_views(model.params()["lm"]["blocks"], DIMS.n_layer)[1]
    x = torch.randn((40, DIMS.d_model), generator=torch.Generator().manual_seed(1))
    y, sel = omni.moe(x, bp, DIMS, grouped=grouped)
    leaves = ReferenceLeaves(DIMS.to_dict(), SEED, "cpu")
    routes = R.Routes()
    want = R.moe(x, leaves.tree(("lm", "blocks"), 1), DIMS.to_dict(), Precision("float32"),
                 routes, None, None, 0.0, (1, 40))
    assert torch.equal(sel, routes.own[0].view(40, -1))
    assert (y - want).abs().max() < 1e-5
    assert sel[:, -1].any() and (sel[:, :-1].sum(1) == 1).any() and (sel.sum(1) == 2).any()
    # the null expert adds nothing: tokens whose only choice besides it is
    # dropped give the fixed experts and that one expert alone
    fixed = omni.fixed_experts(x, bp["fixed"])
    only_null = sel[:, -1] & (sel[:, :-1].sum(1) == 0)
    if only_null.any():
        assert (y[only_null] - fixed[only_null]).abs().max() < 1e-6


def test_forward_logits_match_reference(model, clips):
    ids = _ids(2, [3, 4, 5])
    got = omni.forward(model.params(), _mel(clips[:2]), ids, DIMS, F32)
    leaves = ReferenceLeaves(DIMS.to_dict(), SEED, "cpu")
    want, routes = R.forward(leaves, clips[:2], ids, DIMS.to_dict(), Precision("float32"), 0)
    assert routes.flips == 0
    assert (got - want).abs().max() < 2e-4 * want.abs().max()


def test_tower_is_encoder_forward(model, clips):
    """The tower runs Whisper's ``encoder_forward`` on the Whisper encoder's
    leaves: a Whisper model holding the same encoder gives the same audio
    rows through the pool and the projector."""
    from whisper_finetune_torch.models.whisper import init_params

    p = model.params()
    whisper = init_params(TOWER, device="cpu", seed=0).params()
    whisper["encoder"] = p["encoder"]
    mel = _mel(clips)
    xa = encoder_forward(Whisper(TOWER, whisper).params(), mel, TOWER, F32)
    pooled = torch.nn.functional.adaptive_avg_pool1d(xa.transpose(1, 2), DIMS.audio_tokens)
    want = pooled.transpose(1, 2) @ p["adapter"]["w"] + p["adapter"]["b"]
    assert torch.allclose(omni.encode_audio(p, mel, DIMS, F32), want, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_cached_steps_match_full_forward(model, clips, dtype):
    """Greedy decoding's prefill and cached token steps give the logits the
    full forward gives at the same positions over the served tokens."""
    fcfg = ForwardConfig(compute_dtype=dtype)
    params = model.params()
    if dtype == "bfloat16":
        params = _cast(params, torch.bfloat16)
    mel = _mel(clips)
    init = _ids(3)
    steps = 6
    dec = omni.OmniDecoder(params, DIMS, fcfg.dtype, 3, init.shape[1] + steps, "cpu")
    dec.load(params, omni.encode_audio(params, mel, DIMS, fcfg))
    logits = [dec.prefill(init)]
    tokens = []
    for i in range(steps):
        tok = logits[-1].argmax(-1)
        tokens.append(tok)
        logits.append(dec.step(tok, init.shape[1] + i))
    seq = torch.cat([init, torch.stack(tokens, 1)], 1)
    full = omni.forward(params, mel, seq, DIMS, fcfg)[:, init.shape[1] - 1:]
    got = torch.stack(logits, 1)
    tol = 1e-4 if dtype == "float32" else 0.05
    assert (got - full).abs().max() <= tol * full.abs().max()


def _cast(tree, dtype):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _cast(v, dtype)
        else:
            out[k] = v if v.dtype == torch.float32 and k in omni.FLOAT32_LEAVES else v.to(dtype)
    return out


def test_transcribe_batch_runs_end_to_end(model, clips):
    """``transcribe_batch`` on the speech LLM: the prompt around the audio
    rows, greedy, ids as text where there is no tokenizer; the same ids
    as ``greedy_decode`` returns."""
    calls = []
    real = D.greedy_decode

    def spy(*a, **k):
        calls.append(real(*a, **k))
        return calls[-1]

    D.greedy_decode = spy
    try:
        texts = D.transcribe_batch(model.params(), DIMS, clips.numpy(), None, fcfg=F32,
                                   max_len=7, temperatures=(0.0,), prompt=PROMPT,
                                   compression_ratio_threshold=None, logprob_threshold=None)
    finally:
        D.greedy_decode = real
    tokens = calls[0][0]
    assert tokens.shape == (3, 7)
    for row, text in zip(tokens.tolist(), texts):
        cut = row.index(DIMS.eot) if DIMS.eot in row else len(row)
        assert text == " ".join(str(t) for t in row[:cut])
    with pytest.raises(NotImplementedError):
        D.transcribe_batch(model.params(), DIMS, clips.numpy(), None, fcfg=F32, max_len=3,
                           beam_size=2)


def test_transcribe_cli_prints_ids(model, tmp_path, monkeypatch, capsys):
    from whisper_finetune_torch.scripts import transcribe

    path = tmp_path / "omni.pt"
    omni.save_checkpoint(str(path), model)
    monkeypatch.setattr(omni, "DEFAULT_PROMPT", PROMPT)  # Qwen2's ids lie past the tiny vocabulary
    audio = tmp_path / "a.npy"
    np.save(audio, np.random.RandomState(0).randn(480000).astype(np.float32) * 0.05)
    transcribe.cli([str(audio), "--checkpoint", str(path), "--device", "cpu", "--dtype",
                    "float32", "--max-len", "5", "--temperatures", "0"])
    out = capsys.readouterr().out.strip().split("\t")
    assert out[0] == str(audio) and all(t.isdigit() for t in out[1].split())
    monkeypatch.setitem(omni.OMNI_PRESETS, "uni-moe-2.0-omni", DIMS)
    monkeypatch.setenv("WFT_ALLOW_RANDOM_INIT", "1")
    monkeypatch.delenv("WHISPER_CHECKPOINT_DIR", raising=False)
    from whisper_finetune_torch.models import load_model

    m, dims = load_model("uni-moe-2.0-omni", "cpu")
    assert dims == DIMS and isinstance(m, omni.OmniModel)
    assert {p: a.dtype for p, a in m.leaves()}[("lm", "blocks", "router")] == torch.float32


def _graph_on_cpu(monkeypatch):
    monkeypatch.setattr(D, "_CAPTURE", {"cpu": lambda fn, device: fn})
    monkeypatch.setattr(D, "_GRAPHED", {})


def test_graphed_step_matches_eager_and_counts(model, clips, monkeypatch):
    """The static-buffer path (the capture stood in by a direct call) gives
    the eager path's tokens; one capture, then a replay a token step; the
    counters add up the call's routes."""
    params, mel, init = model.params(), _mel(clips), _ids(3)
    max_len = init.shape[1] + 8
    monkeypatch.setattr(D, "_CAPTURE", {})
    eager = D.greedy_decode(params, mel, init, DIMS.eot, DIMS, F32, max_len=max_len)
    _graph_on_cpu(monkeypatch)
    g = D.greedy_decode
    m = omni.moe
    before = (g.graph_captures, g.graph_replays, g.eager_steps, m.tokens_routed,
              m.layer_steps, omni.lm_block.blocks_run, sum(m.routes))
    monkeypatch.setattr(m, "record", [])
    for n in range(2):
        got = D.greedy_decode(params, mel, init, DIMS.eot, DIMS, F32, max_len=max_len)
        assert torch.equal(got[0], eager[0]) and torch.allclose(got[1], eager[1], atol=1e-6)
    after = (g.graph_captures, g.graph_replays, g.eager_steps, m.tokens_routed,
             m.layer_steps, omni.lm_block.blocks_run, sum(m.routes))
    L, T = DIMS.n_layer, max_len
    assert [a - b for a, b in zip(after, before)][:6] == [1, 16, 0, 2 * L * T * 3, 2 * L * 8,
                                                        2 * L * 9]
    sel = m.record[0]
    assert sel.shape == (3, L, T, DIMS.n_route) and len(m.record) == 2
    assert after[6] - before[6] == int(sel.sum()) * 2
    assert (sel.sum(-1) >= 1).all() and (sel.sum(-1) <= DIMS.top_k).all()
    assert isinstance(D._GRAPHED[torch.device("cpu")], D._GraphedOmniDecoder)
    D.release()
    assert not D._GRAPHED


def test_new_parameters_recapture(model, clips, monkeypatch):
    """The graph reads the parameters where they lie: another tree (other
    addresses) frees the held decoder and captures anew."""
    _graph_on_cpu(monkeypatch)
    params, mel, init = model.params(), _mel(clips), _ids(3)
    D.greedy_decode(params, mel, init, DIMS.eot, DIMS, F32, max_len=init.shape[1] + 2)
    held = D._GRAPHED[torch.device("cpu")]
    other = _cast(params, torch.float32)
    other["lm"] = {**other["lm"], "head": other["lm"]["head"].clone()}
    c = D.greedy_decode.graph_captures
    D.greedy_decode(other, mel, init, DIMS.eot, DIMS, F32, max_len=init.shape[1] + 2)
    assert D.greedy_decode.graph_captures == c + 1
    assert D._GRAPHED[torch.device("cpu")] is not held


@pytest.mark.cuda
def test_omni_graph_on_card(monkeypatch):
    """On a card, at the preset's widths with 2 + 2 layers: the token step
    replayed as a CUDA graph over the resident bf16 parameters gives the
    eager step's tokens and average log-probs; 1 capture and a replay a
    token step, then 0 captures; the token loop makes no host wait;
    ``release`` lets the caches go."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph capture has no CPU mode")
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    base = omni.OMNI_PRESETS["uni-moe-2.0-omni"]
    dims = base.replace(tower=base.tower.replace(n_audio_layer=2), n_layer=2)
    params = omni.init_params(dims, device=dev, seed=1).params()
    fcfg = ForwardConfig(compute_dtype="bfloat16", attn_impl="xla",
                         attn_impl_encoder="splash")
    n, new = 8, 24
    gen = torch.Generator(device=dev).manual_seed(0)
    mel = torch.randn((n, 128, 3000), generator=gen, device=dev)
    seq = PROMPT[0] + [omni.AUDIO_ID] * dims.audio_tokens + PROMPT[1]
    init = torch.tensor([seq] * n, device=dev)
    max_len = len(seq) + new
    monkeypatch.setattr(D, "_CAPTURE", {})
    eager = D.greedy_decode(params, mel, init, dims.eot, dims, fcfg, max_len=max_len)
    monkeypatch.undo()
    monkeypatch.setattr(D, "_GRAPHED", {})
    real_loop = D._greedy_loop

    def loop_without_sync(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_loop(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    real_prefill = omni.OmniDecoder.prefill

    def prefill_may_wait(self, ids):  # its dispatch brings each layer's counts to the host
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real_prefill(self, ids)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    monkeypatch.setattr(omni.OmniDecoder, "prefill", prefill_may_wait)
    g = D.greedy_decode
    torch.cuda.synchronize(dev)
    free0 = torch.cuda.memory_allocated(dev)
    for c in range(2):
        monkeypatch.setattr(D, "_greedy_loop", loop_without_sync if c else real_loop)
        before = (g.graph_captures, g.graph_replays)
        tokens, lp = D.greedy_decode(params, mel, init, dims.eot, dims, fcfg, max_len=max_len)
        assert (g.graph_captures - before[0], g.graph_replays - before[1]) == (int(c == 0), new)
        assert torch.equal(tokens, eager[0]) and (lp - eager[1]).abs().max().item() <= 1e-6
    del tokens, lp
    D.release()
    assert not D._GRAPHED
    assert torch.cuda.memory_allocated(dev) - free0 < 2**26
