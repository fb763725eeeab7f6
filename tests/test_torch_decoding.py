"""The port's KV-cached decoding (``whisper_finetune_torch/models/decoding.py``)
against the JAX package's (``whisper_finetune_tpu/models/decoding.py``) on
identical weights, float32, at tiny width with the real 51866-token
vocabulary (so the tokenizer's special ids and filters are the real ones):
greedy and beam tokens exactly, average log-probs within 1e-5, the logit
filters, eot freezing, ``transcribe_batch``'s texts and its retry rows and
buckets; and the cached decoder against a teacher-forced full forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.models import ForwardConfig as JFC
from whisper_finetune_tpu.models import ModelDimensions
from whisper_finetune_tpu.models import decoding as jdec
from whisper_finetune_tpu.models import init_params as jax_init_params
from whisper_finetune_tpu.tokenizer import get_tokenizer as j_get_tokenizer
from whisper_finetune_torch.models import decoding as tdec
from whisper_finetune_torch.models import params_from_jax
from whisper_finetune_torch.models.dims import ModelDimensions as TDims
from whisper_finetune_torch.models.whisper import ForwardConfig as TFC
from whisper_finetune_torch.models.whisper import forward_impl
from whisper_finetune_torch.tokenizer import get_tokenizer

DIMS = ModelDimensions(
    n_mels=16, n_audio_ctx=40, n_audio_state=32, n_audio_head=2, n_audio_layer=2,
    n_vocab=51866, n_text_ctx=20, n_text_state=32, n_text_head=2, n_text_layer=2,
)
TD = TDims(**DIMS.to_dict())
MAX_LEN = 16
LP_TOL = 1e-5


def _setup(seed=0, B=3, scale_emb=None):
    params = jax.tree.map(np.array, jax_init_params(jax.random.PRNGKey(seed), DIMS))
    if scale_emb is not None:  # sharper logits: fewer near-ties between tokens
        params["decoder"]["tok_emb"] = params["decoder"]["tok_emb"] * scale_emb
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, DIMS.n_mels, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    model = params_from_jax(params, TD, device="cpu")
    return params, model, mel


def _prompt(B):
    tok = get_tokenizer(language="de", task="transcribe")
    return tok, np.array([list(tok.sot_sequence) + [tok.no_timestamps]] * B, np.int64)


def _filters():
    tok = get_tokenizer(language="de", task="transcribe")
    jtok = j_get_tokenizer(language="de", task="transcribe")
    tf, jf = tdec.default_filters(tok), jdec.default_filters(jtok)
    assert dataclass_fields(tf) == dataclass_fields(jf)
    return tf, jf


def dataclass_fields(f):
    return tuple(getattr(f, k) for k in ("suppress", "blank", "timestamp_rules",
                                         "timestamp_begin", "eot",
                                         "max_initial_timestamp_index"))


def _greedy_both(params, model, mel, init, filters=True, **kw):
    tf, jf = _filters() if filters else (None, None)
    eot = get_tokenizer().eot
    jt, jl = jdec.greedy_decode(params, jnp.asarray(mel), jnp.asarray(init, jnp.int32), eot,
                                DIMS, JFC(compute_dtype="float32"), max_len=MAX_LEN,
                                filters=jf, **kw)
    tt, tl = tdec.greedy_decode(model.params(), torch.from_numpy(mel), torch.from_numpy(init),
                                eot, TD, TFC(compute_dtype="float32"), max_len=MAX_LEN,
                                filters=tf)
    return (np.asarray(jt), np.asarray(jl)), (tt.numpy(), tl.numpy())


@pytest.mark.parametrize("filters", [True, False])
def test_greedy_matches_jax(filters):
    params, model, mel = _setup(scale_emb=20.0)
    _, init = _prompt(3)
    (jt, jl), (tt, tl) = _greedy_both(params, model, mel, init, filters)
    assert tt.shape == (3, MAX_LEN - init.shape[1])
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, atol=LP_TOL, rtol=0)


def test_eot_freezes_rows_and_counts_accepted_tokens():
    """A decoder whose final layer norm is a constant vector b, with eot's
    embedding along b: eot is every step's argmax but the first (blank
    suppression), so each row writes one token, then eot, then eot frozen;
    the average counts the two accepted tokens."""
    params, _, mel = _setup(seed=1)
    eot = get_tokenizer().eot
    b = np.random.default_rng(3).standard_normal(DIMS.n_text_state).astype(np.float32)
    params["decoder"]["ln"]["scale"][:] = 0.0
    params["decoder"]["ln"]["bias"][:] = b
    params["decoder"]["tok_emb"][eot] = 0.5 * b
    model = params_from_jax(params, TD, device="cpu")
    _, init = _prompt(3)
    (jt, jl), (tt, tl) = _greedy_both(params, model, mel, init)
    np.testing.assert_array_equal(tt, jt)
    assert (tt[:, 0] != eot).all() and (tt[:, 1:] == eot).all()
    np.testing.assert_allclose(tl, jl, atol=LP_TOL, rtol=0)
    # the average over the two accepted tokens, from the step's own logits
    with torch.no_grad():
        logits = forward_impl(model.params(), torch.from_numpy(mel),
                              torch.from_numpy(np.concatenate([init, tt[:, :1]], 1)), TD,
                              TFC(compute_dtype="float32"))
    lp = torch.log_softmax(logits[:, -2:], -1)  # positions predicting tok 0 and eot
    tf, _ = _filters()
    z = torch.zeros(3, dtype=torch.long)
    first = torch.log_softmax(tf.apply(logits[:, -2], z, z, z, 0), -1)
    want = (first.gather(1, torch.from_numpy(tt[:, :1]))[:, 0] + lp[:, 1, eot]) / 2
    np.testing.assert_allclose(tl, want.numpy(), atol=LP_TOL, rtol=0)


def _step_logits(model, mel, init, tokens):
    """The cached decoder's float32 logits at every position of init +
    tokens, fed one token at a time."""
    with torch.no_grad():
        dec = tdec._encode(model.params(), torch.from_numpy(mel), TD,
                           TFC(compute_dtype="float32"), MAX_LEN)
        seq = torch.from_numpy(np.concatenate([init, tokens], 1))
        return torch.stack([dec.step(seq[:, i], i) for i in range(MAX_LEN)], 1)


def test_cached_decoder_matches_teacher_forced_forward():
    params, model, mel = _setup(scale_emb=20.0)
    _, init = _prompt(3)
    _, (tt, _) = _greedy_both(params, model, mel, init)
    cached = _step_logits(model, mel, init, tt)
    seq = torch.from_numpy(np.concatenate([init, tt], 1))
    fcfg = TFC(compute_dtype="float32")
    with torch.no_grad():
        full = forward_impl(model.params(), torch.from_numpy(mel), seq, TD, fcfg)
        # brute force: the full forward over each prefix alone, its last logits
        brute = torch.stack([forward_impl(model.params(), torch.from_numpy(mel), seq[:, :i + 1],
                                          TD, fcfg)[:, -1] for i in range(MAX_LEN)], 1)
    scale = full.abs().max().item()
    assert (cached - full).abs().max().item() <= 1e-5 * scale
    assert (brute - full).abs().max().item() <= 1e-5 * scale
    # the greedy tokens are the argmax of the teacher-forced logits (no
    # filter fires after the first position on these weights)
    T0 = init.shape[1]
    assert torch.equal(full[:, T0:-1].argmax(-1), torch.from_numpy(tt[:, 1:]))


def _beam_both(params, model, mel, init, K, penalty=None):
    tf, jf = _filters()
    eot = get_tokenizer().eot
    jt, jl = jdec.beam_decode(params, jnp.asarray(mel), jnp.asarray(init, jnp.int32), eot, DIMS,
                              JFC(compute_dtype="float32"), max_len=MAX_LEN, beam_size=K,
                              length_penalty=penalty, filters=jf)
    tt, tl = tdec.beam_decode(model.params(), torch.from_numpy(mel), torch.from_numpy(init),
                              eot, TD, TFC(compute_dtype="float32"), max_len=MAX_LEN,
                              beam_size=K, length_penalty=penalty, filters=tf)
    return (np.asarray(jt), np.asarray(jl)), (tt.numpy(), tl.numpy())


@pytest.mark.parametrize("penalty", [None, 1.0])
def test_beam_matches_jax_and_beats_greedy(penalty):
    params, model, mel = _setup(scale_emb=20.0)
    _, init = _prompt(3)
    (jt, jl), (tt, tl) = _beam_both(params, model, mel, init, 5, penalty)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, atol=LP_TOL, rtol=0)
    # No row ends (no eot), so both averages run over every step's chosen
    # token (the beam's over one more: its last step's best continuation)
    # and the winning beam's is at least greedy's.
    _, (gt, gl) = _greedy_both(params, model, mel, init)
    eot = get_tokenizer().eot
    assert (tt != eot).all() and (gt != eot).all()
    assert (tl >= gl - 1e-6).all() and (tl > gl).any()


def test_beam_of_one_is_greedy():
    params, model, mel = _setup(scale_emb=20.0)
    _, init = _prompt(3)
    (_, (gt, gl)) = _greedy_both(params, model, mel, init)
    (_, (bt, bl)) = _beam_both(params, model, mel, init, 1)
    np.testing.assert_array_equal(bt, gt)
    # No eot: greedy averages its n tokens; the beam sums n + 1 (its last
    # step's argmax too) over n + 1.
    assert (bt != get_tokenizer().eot).all()
    last = _step_logits(model, mel, init, gt)[:, -1]
    tf, _ = _filters()
    z = torch.zeros(3, dtype=torch.long)
    extra = torch.log_softmax(tf.apply(last, z, z, z, MAX_LEN), -1).max(-1).values.numpy()
    n = gt.shape[1]
    np.testing.assert_allclose(bl * (n + 1), gl * n + extra, rtol=1e-5)


def test_sampling_is_reproducible_for_a_seed():
    _, model, mel = _setup(scale_emb=20.0)
    _, init = _prompt(3)
    tf, _ = _filters()

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return tdec.greedy_decode(model.params(), torch.from_numpy(mel), torch.from_numpy(init),
                                  get_tokenizer().eot, TD, TFC(compute_dtype="float32"),
                                  max_len=MAX_LEN, temperature=1.0, generator=gen,
                                  filters=tf)[0]

    a, b, c = sample(0), sample(0), sample(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    greedy = tdec.greedy_decode(model.params(), torch.from_numpy(mel), torch.from_numpy(init),
                                get_tokenizer().eot, TD, TFC(compute_dtype="float32"),
                                max_len=MAX_LEN, filters=tf)[0]
    assert not torch.equal(a, greedy)


@pytest.mark.parametrize("timestamps", [False, True])
def test_filters_match_jax(timestamps):
    tok = get_tokenizer(language="de", task="transcribe")
    jtok = j_get_tokenizer(language="de", task="transcribe")
    tf = tdec.default_filters(tok, without_timestamps=not timestamps)
    jf = jdec.default_filters(jtok, without_timestamps=not timestamps)
    assert dataclass_fields(tf) == dataclass_fields(jf)
    assert tf.timestamp_rules == timestamps
    rng = np.random.default_rng(0)
    N, V, tsb = 8, DIMS.n_vocab, tok.timestamp_begin
    for n_sampled in (0, 1, 2, 5):
        logits = (rng.standard_normal((N, V)) * 3).astype(np.float32)
        logits[:4, tsb:] += 6.0  # rows where the timestamps' mass wins
        # previous tokens: text and timestamps, pairs and lone ones
        prev1 = np.array([5, tsb + 3, tsb + 7, 11, tsb, 300, tsb + 40, 7])
        prev2 = np.array([tsb + 2, tsb + 1, 9, tsb + 5, tsb, tsb + 9, 12, 8])
        max_ts = np.array([0, tsb + 3, tsb + 7, tsb + 5, tsb, tsb + 9, tsb + 40, 0])
        want = np.asarray(jf.apply(jnp.asarray(logits), jnp.asarray(prev1, jnp.int32),
                                   jnp.asarray(prev2, jnp.int32), jnp.asarray(max_ts, jnp.int32),
                                   n_sampled))
        got = tf.apply(torch.from_numpy(logits), torch.from_numpy(prev1),
                       torch.from_numpy(prev2), torch.from_numpy(max_ts), n_sampled).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=1e-6)
        if timestamps and n_sampled == 0:
            assert np.isneginf(got[:, :tsb]).all()  # the first token is a timestamp


def test_compression_ratio_matches_jax():
    for text in ("", "abc", "la " * 40, "Das ist ein Test."):
        assert tdec._compression_ratio(text) == jdec._compression_ratio(text)


@pytest.mark.parametrize("beam", [None, 2])
def test_transcribe_batch_matches_jax(monkeypatch, beam):
    """Six rows, a log-prob threshold at the median of the first rung's
    averages: three rows pass at temperature 0 (greedy, or beam search with
    ``beam``), and their texts must be JAX's; the other three are decoded
    again at 0.5 in a bucket of 4 (padded with the first failing row), the
    last rung, which accepts them. Both packages' decoder calls are
    recorded: the same rows, in the same order, at the same temperatures."""
    audio = (np.random.default_rng(4).standard_normal((6, 480000)) * 0.05).astype(np.float32)
    tok = get_tokenizer(language="de", task="transcribe")
    jtok = j_get_tokenizer(language="de", task="transcribe")
    dims = DIMS.replace(n_mels=80, n_audio_ctx=1500)
    tdims = TDims(**dims.to_dict())
    params = jax.tree.map(np.array, jax_init_params(jax.random.PRNGKey(2), dims))
    params["decoder"]["tok_emb"] = params["decoder"]["tok_emb"] * 20.0
    model = params_from_jax(params, tdims, device="cpu")
    calls = {"jax": [], "torch": []}

    def record(name, mod, fn_name):
        fn = getattr(mod, fn_name)

        def wrapped(p, mel_r, init_r, *a, **kw):
            out = fn(p, mel_r, init_r, *a, **kw)
            calls[name].append((fn_name, int(mel_r.shape[0]), float(kw.get("temperature", 0.0)),
                                np.asarray(mel_r)[:, 0, :4], np.asarray(out[1])))
            return out

        monkeypatch.setattr(mod, fn_name, wrapped)

    for name, mod in (("jax", jdec), ("torch", tdec)):
        record(name, mod, "greedy_decode")
        record(name, mod, "beam_decode")
    kw = dict(max_len=MAX_LEN, beam_size=beam, compression_ratio_threshold=None)
    first = tdec.transcribe_batch(model.params(), tdims, audio, tok,
                                  fcfg=TFC(compute_dtype="float32"), temperatures=(0.0,),
                                  logprob_threshold=None, **kw)
    lps = calls["torch"].pop()[4]
    threshold = float(np.median(lps))
    passing = lps >= threshold
    assert passing.sum() == 3

    kw.update(temperatures=(0.0, 0.5), logprob_threshold=threshold)
    jtexts = jdec.transcribe_batch(params, dims, audio, jtok, fcfg=JFC(compute_dtype="float32"),
                                   **kw)
    ttexts = tdec.transcribe_batch(model.params(), tdims, audio, tok,
                                   fcfg=TFC(compute_dtype="float32"), **kw)
    rung0 = "beam_decode" if beam else "greedy_decode"
    want = [(rung0, 6, 0.0), ("greedy_decode", 4, 0.5)]
    assert [c[:3] for c in calls["torch"]] == [c[:3] for c in calls["jax"]] == want
    for got, ref in zip(calls["torch"], calls["jax"]):
        np.testing.assert_allclose(got[3], ref[3], atol=1e-4)  # the same rows, in order
    np.testing.assert_allclose(calls["torch"][0][4], calls["jax"][0][4], atol=LP_TOL, rtol=0)
    failing = np.nonzero(~passing)[0]
    np.testing.assert_array_equal(calls["torch"][1][3],
                                  calls["torch"][0][3][np.r_[failing, failing[:1]]])
    for i in np.nonzero(passing)[0]:
        assert ttexts[i] == jtexts[i] == first[i]
    assert all(isinstance(t, str) for t in ttexts)


# ---------------------------------------------------------------------------
# The graph-ready step and the static-buffer path of greedy decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_with_tensor_position_matches_int_position(dtype):
    """The step with the position as a (1,) tensor (index, ``index_copy_``,
    a tensor mask: the graph's form) against the int path (a view, a slice
    write, a scalar mask): logits at every position and the caches after
    the whole sequence, bit for bit."""
    _, model, mel = _setup(scale_emb=20.0)
    _, init = _prompt(3)
    rng = np.random.default_rng(5)
    seq = torch.from_numpy(np.concatenate(
        [init, rng.integers(0, DIMS.n_vocab, (3, MAX_LEN - init.shape[1]))], 1))
    fcfg = TFC(compute_dtype=dtype)
    with torch.no_grad():
        by_int, by_tensor = (tdec._encode(model.params(), torch.from_numpy(mel), TD, fcfg,
                                          MAX_LEN) for _ in range(2))
        for i in range(MAX_LEN):
            a = by_int.step(seq[:, i], i)
            b = by_tensor.step(seq[:, i], torch.tensor([i]))
            assert torch.equal(a, b), i
    assert torch.equal(by_int.cache_k, by_tensor.cache_k)
    assert torch.equal(by_int.cache_v, by_tensor.cache_v)


def _graph_on_cpu(monkeypatch):
    """From here on, the static-buffer path on the CPU: "capturing" keeps
    the function, and a "replay" calls it. The device's decoders start
    empty."""
    monkeypatch.setattr(tdec, "_CAPTURE", {"cpu": lambda fn, device: fn})
    monkeypatch.setattr(tdec, "_GRAPHED", {})


def _counts():
    g = tdec.greedy_decode
    return g.graph_captures, g.graph_replays, g.eager_steps


def _greedy(model, mel, init, filters, temperature=0.0, seed=None):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    tokens, avg_lp = tdec.greedy_decode(
        model.params(), torch.from_numpy(mel), torch.from_numpy(init), get_tokenizer().eot, TD,
        TFC(compute_dtype="float32"), max_len=MAX_LEN, temperature=temperature, generator=gen,
        filters=filters)
    return tokens.numpy(), avg_lp.numpy()


@pytest.mark.parametrize("case", ["filters", "no_filters", "timestamps", "sampled"])
def test_graphed_greedy_matches_eager(monkeypatch, case):
    """The static-buffer path (the capture stood in by a direct call) gives
    the eager path's tokens and average log-probs, with filters on and off,
    with the timestamp rules, and sampling at temperature 1 from a seeded
    generator; its first call captures once and replays every position."""
    _, model, mel = _setup(scale_emb=20.0)
    tok, init = _prompt(3)
    filters = None if case == "no_filters" else tdec.default_filters(tok)
    if case == "timestamps":
        filters = tdec.default_filters(tok, without_timestamps=False)
        init = init[:, :-1]  # no <|notimestamps|>
    temperature, seed = (1.0, 7) if case == "sampled" else (0.0, None)
    c0 = _counts()
    want = _greedy(model, mel, init, filters, temperature, seed)
    c1 = _counts()
    assert c1 == (c0[0], c0[1], c0[2] + MAX_LEN)
    _graph_on_cpu(monkeypatch)
    got = _greedy(model, mel, init, filters, temperature, seed)
    assert _counts() == (c1[0] + 1, c1[1] + MAX_LEN, c1[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if case == "timestamps":
        assert (got[0][:, 0] >= tok.timestamp_begin).all()  # the rules fired


def test_graphed_greedy_reads_each_calls_inputs(monkeypatch):
    """Successive calls through one device's static buffers, each with other
    audio and other weights: each gives its own eager tokens, and only the
    first captures. A call with another row count captures anew."""
    tok, init = _prompt(3)
    filters = tdec.default_filters(tok)
    cases = [_setup(seed=s, scale_emb=20.0)[1:] for s in (0, 1, 2)]
    want = [_greedy(model, mel, init, filters) for model, mel in cases]
    assert not all(np.array_equal(want[0][0], w[0]) for w in want[1:])
    _graph_on_cpu(monkeypatch)
    c0 = _counts()
    for (model, mel), (tokens, avg_lp) in zip(cases, want):
        got = _greedy(model, mel, init, filters)
        np.testing.assert_array_equal(got[0], tokens)
        np.testing.assert_array_equal(got[1], avg_lp)
    assert _counts()[:2] == (c0[0] + 1, c0[1] + 3 * MAX_LEN)
    held = tdec._GRAPHED[torch.device("cpu")]
    model, mel = cases[0]
    got = _greedy(model, mel[:2], init[:2], filters)
    np.testing.assert_array_equal(got[0], want[0][0][:2])
    assert _counts()[0] == c0[0] + 2
    assert tdec._GRAPHED[torch.device("cpu")] is not held and not held.busy


def test_graphed_decoder_in_use_runs_eagerly(monkeypatch):
    """A call that finds the device's buffers held by another call runs the
    eager step, and leaves the holder's buffers alone."""
    _graph_on_cpu(monkeypatch)
    tok, init = _prompt(3)
    filters = tdec.default_filters(tok)
    _, model, mel = _setup(scale_emb=20.0)
    want = _greedy(model, mel, init, filters)
    held = tdec._GRAPHED[torch.device("cpu")]
    held.busy = True
    c0 = _counts()
    got = _greedy(model, mel, init, filters)
    assert _counts() == (c0[0], c0[1], c0[2] + MAX_LEN)
    np.testing.assert_array_equal(got[0], want[0])
    assert tdec._GRAPHED[torch.device("cpu")] is held and held.busy


def test_release_lets_go_of_held_decoders(monkeypatch):
    """A call's end drops the parameters' embeddings from the held decoder;
    :func:`release` empties the device's slot, and the next call captures
    anew with the same tokens."""
    _graph_on_cpu(monkeypatch)
    tok, init = _prompt(3)
    filters = tdec.default_filters(tok)
    _, model, mel = _setup(scale_emb=20.0)
    want = _greedy(model, mel, init, filters)
    held = tdec._GRAPHED[torch.device("cpu")]
    assert held.tok_emb is None and held.pos_emb is None and not held.busy
    tdec.release()
    assert not tdec._GRAPHED
    c0 = _counts()
    got = _greedy(model, mel, init, filters)
    assert _counts()[:2] == (c0[0] + 1, c0[1] + MAX_LEN)
    assert tdec._GRAPHED[torch.device("cpu")] is not held
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_beam_leaves_graph_counters(monkeypatch):
    _graph_on_cpu(monkeypatch)
    _, model, mel = _setup(scale_emb=20.0)
    _, init = _prompt(3)
    c0 = _counts()
    tdec.beam_decode(model.params(), torch.from_numpy(mel), torch.from_numpy(init),
                     get_tokenizer().eot, TD, TFC(compute_dtype="float32"), max_len=MAX_LEN,
                     beam_size=2, filters=_filters()[0])
    assert _counts() == c0 and not tdec._GRAPHED


def test_filter_ids_are_made_once_a_device():
    tf, _ = _filters()
    logits = torch.zeros((2, DIMS.n_vocab))
    z = torch.zeros(2, dtype=torch.long)
    tf.apply(logits, z, z, z, 0)
    a = tdec._ids(tf.suppress, logits.device)
    tf.apply(logits, z, z, z, 0)
    assert tdec._ids(tf.suppress, logits.device) is a
    assert a.tolist() == list(tf.suppress)
