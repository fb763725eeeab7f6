"""The port's tokenizer and native core against the JAX package's: the same
special-token layout, the same ids for every text (the C++ merge loop and
the pure-Python one), the same BPE-dropout segmentations under one seed, and
the same edit distances. All exact.

The JAX package's loader builds its library into a temporary name shared by
every process (``<so>.build``), so two test workers building at once can
break each other's build, after which that worker's JAX native path stays
off. The tests that need JAX's native path take :func:`jax_native`, which
builds the library once under a file lock into ``build/native/`` and points
the JAX loader at it."""

import fcntl
import hashlib
import os
import random
import subprocess
from pathlib import Path

import numpy as np
import pytest

import whisper_finetune_tpu.native as jax_native_module
from whisper_finetune_tpu.native import NativeBPE as JNativeBPE
from whisper_finetune_tpu.native import levenshtein_ids as j_levenshtein_ids
from whisper_finetune_tpu.tokenizer import get_tokenizer as j_get_tokenizer
from whisper_finetune_tpu.tokenizer.tokenizer import WhisperTokenizer as JWhisperTokenizer
from whisper_finetune_torch import native
from whisper_finetune_torch.tokenizer import LANGUAGES, TO_LANGUAGE_CODE, get_tokenizer
from whisper_finetune_torch.tokenizer.tokenizer import WhisperTokenizer

ROOT = Path(__file__).resolve().parent.parent

TEXTS = [
    "Hello, world!",
    " Das ist ein Test mit Umlauten: äöü ÄÖÜ ß.",
    "Zürich—Basel / 12'345.67 CHF",
    "   multiple   spaces\tand\nnewlines ",
    "emoji 🤗 and 中文 mixed",
    "",
    "a",
    "Grüezi mitenand, wie gaht's?",
    # tools/make_debug_dataset.py's texts and prompt
    "das ist ein test", "guten morgen zürich", "wir fahren mit dem zug nach bern",
    " heute scheint die sonne ", "die katze sitzt auf dem dach", " erster teil ",
    "es regnet schon den ganzen tag", "vorheriger satz",
]


@pytest.fixture(scope="module")
def jax_native():
    """JAX's native library, built once (under a lock, into a name of this
    process, then renamed into place) as ``build/native/jax_wf_native_<hash>.so``
    and loaded through JAX's own ``get_lib`` with its state reset."""
    src = Path(jax_native_module._SRC)
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out_dir = ROOT / "build" / "native"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"jax_wf_native_{digest}.so"
    with open(out_dir / "jax_wf_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = f"{so}.{os.getpid()}.build"
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src), "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_module, "_so_path", lambda: str(so))
        mp.setattr(jax_native_module, "_lib", None)
        mp.setattr(jax_native_module, "_build_failed", False)
        lib = jax_native_module.get_lib()
        assert lib is not None
        yield lib


@pytest.fixture(scope="module")
def toks(jax_native):
    # Past get_tokenizer's cache: a JAX tokenizer built earlier in this
    # process may have been built without the native path.
    return j_get_tokenizer.__wrapped__(language="de", task="transcribe"), get_tokenizer(
        language="de", task="transcribe")


def test_languages_match_jax():
    from whisper_finetune_tpu.tokenizer import LANGUAGES as JL
    from whisper_finetune_tpu.tokenizer import TO_LANGUAGE_CODE as JT

    assert LANGUAGES == JL and TO_LANGUAGE_CODE == JT


@pytest.mark.parametrize("language,task", [("de", "transcribe"), ("en", "translate"),
                                           ("fr", None), (None, "transcribe")])
def test_special_tokens_match_jax(language, task):
    j = JWhisperTokenizer(language=language, task=task)
    t = WhisperTokenizer(language=language, task=task)
    assert t.special_tokens == j.special_tokens
    assert (t.n_vocab, t.n_base_vocab) == (j.n_vocab, j.n_base_vocab)
    for attr in ("eot", "sot", "sot_prev", "sot_lm", "translate", "transcribe", "no_speech",
                 "no_timestamps", "timestamp_begin", "sot_sequence", "non_speech_tokens"):
        assert getattr(t, attr) == getattr(j, attr), attr
    if language:
        assert t.language_token() == j.language_token()
    assert [t.timestamp_token(x) for x in (0.0, 1.5, 30.0)] == [
        j.timestamp_token(x) for x in (0.0, 1.5, 30.0)]


def test_encode_decode_match_jax(toks):
    j, t = toks
    assert t._bpe._native is not None and j._bpe._native is not None
    for text in TEXTS:
        ids = t.encode(text)
        assert ids == j.encode(text), text
        assert t.decode(ids) == j.decode(ids) == text
    mixed = [t.sot, t.special_tokens["<|de|>"], t.timestamp_begin + 5] + t.encode("hallo") + [
        t.timestamp_begin + 50, t.eot]
    assert t.decode(mixed) == j.decode(mixed)
    assert t.decode_with_timestamps(mixed) == j.decode_with_timestamps(mixed)


@pytest.mark.parametrize("native_path", [True, False])
def test_bpe_dropout_matches_jax_under_one_seed(native_path, jax_native):
    j = JWhisperTokenizer(language="de")
    t = WhisperTokenizer(language="de")
    if not native_path:
        j._bpe._native = t._bpe._native = None
    for seed in range(3):
        rj, rt_ = random.Random(seed), random.Random(seed)
        for text in TEXTS:
            got = t.encode(text, dropout_prob=0.3, rng=rt_)
            assert got == j.encode(text, dropout_prob=0.3, rng=rj), text
            assert t.decode(got) == text
    # dropout really changes segmentations
    plain = t.encode(TEXTS[1])
    assert any(t.encode(TEXTS[1], dropout_prob=0.5, rng=random.Random(s)) != plain
               for s in range(5))


def test_native_matches_jax_native(jax_native):
    rng = np.random.default_rng(0)
    for _ in range(40):
        a = rng.integers(0, 6, rng.integers(0, 30)).tolist()
        b = rng.integers(0, 6, rng.integers(0, 30)).tolist()
        assert native.levenshtein_ids(a, b) == j_levenshtein_ids(a, b)
    triples = [(1, 2, 10), (10, 3, 11), (2, 3, 12), (11, 4, 13)]
    ours, theirs = native.NativeBPE(triples), JNativeBPE(triples)
    for seed in range(20):
        piece = rng.integers(1, 5, 12).tolist()
        for p in (0.0, 0.4):
            assert ours.encode_piece(piece, p, seed) == theirs.encode_piece(piece, p, seed)


def test_native_builds_into_the_build_tree():
    assert native.get_lib() is not None
    so = Path(native._so_path())
    assert so.parent == ROOT / "build" / "native" and so.exists()
    assert not list((ROOT / "whisper_finetune_torch" / "native").glob("*.so"))
