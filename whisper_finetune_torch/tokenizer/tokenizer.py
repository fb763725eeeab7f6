"""Whisper tokenizer: byte-level BPE plus the special-token layout.

Replaces the reference's dependency on ``whisper.tokenizer.get_tokenizer``
(openai-whisper + forked tiktoken; see reference
src/whisper_finetune/scripts/finetune.py:16,591). The vocabulary ships as a
compact derived asset (assets/multilingual.json.gz, built by
tools/build_tokenizer_asset.py); specials, language tokens and timestamp
tokens follow the multilingual large-v3 layout (sot=50258,
timestamp_begin=50365, n_vocab=51866).

API surface used by the training stack (matching the whisper Tokenizer
attributes the reference calls):
``encode(text, dropout_prob=...)``, ``decode(ids)``, ``special_tokens``,
``sot``, ``eot``, ``sot_prev``, ``no_speech``, ``no_timestamps``,
``timestamp_begin``, ``language_token(lang)``, ``sot_sequence``.
"""

from __future__ import annotations

import gzip
import json
import os
import random
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from whisper_finetune_torch.tokenizer.bpe import ByteLevelBPE
from whisper_finetune_torch.tokenizer.languages import LANGUAGES, TO_LANGUAGE_CODE

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")


@lru_cache(maxsize=2)
def _load_asset(name: str) -> dict:
    path = os.path.join(_ASSET_DIR, name + ".json.gz")
    with gzip.open(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def _build_vocab(asset: dict) -> Tuple[Dict[str, int], List[str]]:
    vocab: Dict[str, int] = {}
    for i, ch in enumerate(asset["byte_alphabet"]):
        vocab[ch] = i
    merges: List[str] = asset["merges"]
    for k, merge in enumerate(merges):
        left, right = merge.split(" ")
        vocab[left + right] = 256 + k
    for token, idx in asset.get("extra_vocab", {}).items():
        vocab[token] = idx
    return vocab, merges


@dataclass
class WhisperTokenizer:
    """Multilingual Whisper tokenizer with BPE-dropout support."""

    language: str = "de"
    task: str = "transcribe"
    asset_name: str = "multilingual"
    _bpe: ByteLevelBPE = field(init=False, repr=False)
    special_tokens: Dict[str, int] = field(init=False, repr=False)
    _special_strings: Dict[int, str] = field(init=False, repr=False)

    def __post_init__(self):
        asset = _load_asset(self.asset_name)
        vocab, merges = _build_vocab(asset)
        self._bpe = ByteLevelBPE(vocab, merges)
        self.special_tokens = {content: idx for idx, content in asset["specials"]}
        self._special_strings = {idx: content for idx, content in asset["specials"]}
        self.n_base_vocab = asset["n_base_vocab"]
        self.n_vocab = self.n_base_vocab + len(asset["specials"])

        language = self.language.lower() if self.language else None
        if language is not None:
            if language in TO_LANGUAGE_CODE:
                language = TO_LANGUAGE_CODE[language]
            if language not in LANGUAGES:
                raise ValueError(f"Unsupported language: {self.language}")
        self.language = language

    # -- special token ids -------------------------------------------------

    @property
    def eot(self) -> int:
        return self.special_tokens["<|endoftext|>"]

    @property
    def sot(self) -> int:
        return self.special_tokens["<|startoftranscript|>"]

    @property
    def sot_prev(self) -> int:
        return self.special_tokens["<|startofprev|>"]

    @property
    def sot_lm(self) -> int:
        return self.special_tokens["<|startoflm|>"]

    @property
    def translate(self) -> int:
        return self.special_tokens["<|translate|>"]

    @property
    def transcribe(self) -> int:
        return self.special_tokens["<|transcribe|>"]

    @property
    def no_speech(self) -> int:
        return self.special_tokens["<|nospeech|>"]

    @property
    def no_timestamps(self) -> int:
        return self.special_tokens["<|notimestamps|>"]

    @property
    def timestamp_begin(self) -> int:
        return self.special_tokens["<|0.00|>"]

    def language_token(self, language: Optional[str] = None) -> int:
        language = language or self.language
        if language is None:
            raise ValueError("No language specified")
        code = TO_LANGUAGE_CODE.get(language.lower(), language.lower())
        token = self.special_tokens.get(f"<|{code}|>")
        if token is None:
            raise ValueError(f"No token for language: {language}")
        return token

    @property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids to suppress during generation: single-token symbols and
        music/annotation glyphs that never occur in real speech transcripts
        (openai-whisper ``Tokenizer.non_speech_tokens`` semantics — the list
        the reference's deployment path ships via the HF generation config).
        """
        if getattr(self, "_non_speech_cache", None) is not None:
            return self._non_speech_cache
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪"
        ).split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = {self.encode(" -")[0], self.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for tokens in [self.encode(symbol), self.encode(" " + symbol)]:
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])
        object.__setattr__(self, "_non_speech_cache", tuple(sorted(result)))
        return self._non_speech_cache

    @property
    def sot_sequence(self) -> Tuple[int, ...]:
        seq = [self.sot]
        if self.language is not None:
            seq.append(self.language_token())
        if self.task is not None:
            seq.append(self.translate if self.task == "translate" else self.transcribe)
        return tuple(seq)

    # -- encode / decode ---------------------------------------------------

    def encode(
        self,
        text: str,
        dropout_prob: float = 0.0,
        rng: Optional[random.Random] = None,
    ) -> List[int]:
        """BPE-encode plain text (no special-token parsing), optionally with
        BPE-dropout. Mirrors the forked-tiktoken call signature the reference
        data pipeline uses (data_loader.py:230)."""
        return self._bpe.encode(text, dropout=dropout_prob, rng=rng)

    def decode(self, ids: Sequence[int]) -> str:
        """Decode, filtering out timestamp tokens (whisper semantics)."""
        out: List[str] = []
        pending: List[int] = []
        for i in ids:
            i = int(i)
            if i >= self.timestamp_begin:
                continue
            if i >= self.n_base_vocab:
                if pending:
                    out.append(self._bpe.decode(pending))
                    pending = []
                out.append(self._special_strings.get(i, ""))
            else:
                pending.append(i)
        if pending:
            out.append(self._bpe.decode(pending))
        return "".join(out)

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        pending: List[int] = []
        for i in ids:
            i = int(i)
            if i >= self.n_base_vocab:
                if pending:
                    out.append(self._bpe.decode(pending))
                    pending = []
                out.append(self._special_strings.get(i, ""))
            else:
                pending.append(i)
        if pending:
            out.append(self._bpe.decode(pending))
        return "".join(out)

    def timestamp_token(self, seconds: float) -> int:
        if seconds < 0 or seconds > 30 or round(seconds * 100) % 2 != 0:
            raise ValueError(f"Invalid timestamp: {seconds}")
        return self.timestamp_begin + round(seconds * 100) // 2


@lru_cache(maxsize=8)
def get_tokenizer(
    multilingual: bool = True,
    language: Optional[str] = "de",
    task: Optional[str] = "transcribe",
) -> WhisperTokenizer:
    """Factory mirroring ``whisper.tokenizer.get_tokenizer``.

    Only the multilingual vocabulary ships as an asset (the reference always
    builds the multilingual tokenizer, finetune.py:591).
    """
    if not multilingual:
        raise NotImplementedError(
            "Only the multilingual Whisper vocabulary is bundled; the training "
            "stack always uses multilingual=True."
        )
    return WhisperTokenizer(language=language, task=task)
