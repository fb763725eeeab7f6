"""Byte-level BPE with merge dropout.

The reference depends on a forked tiktoken whose ``encode`` accepts a
``dropout_prob`` argument (BPE-dropout, Provilkov et al. 2020; used at
reference src/whisper_finetune/data/data_loader.py:230,249). tiktoken's Rust
core is not available here, so we implement the byte-level BPE algorithm
directly:

* text is split by the GPT-2 pre-tokenization regex,
* each piece is mapped through the GPT-2 byte->unicode table,
* merges are applied lowest-rank-first; with dropout, every candidate pair
  occurrence is independently skipped with probability ``p`` at each
  iteration, producing the stochastic segmentations BPE-dropout trains on.

``dropout=0`` reproduces the canonical deterministic encoding. The merge
loop runs in C++ (``whisper_finetune_torch/native``) when g++ can build it,
else in Python with the same results; tokenization runs in the loader's
threads, off the device.
"""

from __future__ import annotations

import random
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import regex as re

# GPT-2 pre-tokenization pattern (public; also used by tiktoken's gpt2 spec).
_PRETOKENIZE_PATTERN = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The reversible GPT-2 byte -> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@lru_cache(maxsize=1)
def unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


class ByteLevelBPE:
    """Encoder/decoder over a rank-ordered merge list.

    Args:
        vocab: token string (byte-level unicode form) -> id.
        merges: ordered list of "left right" merge strings; index == rank.
    """

    def __init__(self, vocab: Dict[str, int], merges: List[str]):
        self.vocab = vocab
        self.inv_vocab = {i: s for s, i in vocab.items()}
        self.merge_ranks: Dict[Tuple[str, str], int] = {}
        for rank, merge in enumerate(merges):
            left, right = merge.split(" ")
            self.merge_ranks[(left, right)] = rank
        self._byte_encoder = bytes_to_unicode()
        self._byte_decoder = unicode_to_bytes()
        self._cache: Dict[str, List[str]] = {}
        # Optional C++ fast path for the merge loop (the compute-heavy part
        # of tokenization; see whisper_finetune_torch/native). Falls back to
        # the pure-Python loop when the toolchain is unavailable.
        self._native = None
        try:
            from whisper_finetune_torch.native import NativeBPE, get_lib

            if get_lib() is not None:
                triples = []
                for rank, merge in enumerate(merges):
                    left, right = merge.split(" ")
                    triples.append(
                        (vocab[left], vocab[right], vocab[left + right])
                    )
                self._native = NativeBPE(triples)
        except Exception:
            self._native = None

    # -- core BPE ----------------------------------------------------------

    def _bpe(self, piece: str, dropout: float, rng: Optional[random.Random]) -> List[str]:
        if dropout <= 0.0 and piece in self._cache:
            return self._cache[piece]

        word: List[str] = list(piece)
        if len(word) < 2:
            return word

        use_dropout = dropout > 0.0 and rng is not None
        while len(word) >= 2:
            # Find the lowest-rank adjacent pair that survives dropout this
            # iteration; each occurrence is dropped independently.
            best_rank = None
            best_idx = -1
            for i in range(len(word) - 1):
                rank = self.merge_ranks.get((word[i], word[i + 1]))
                if rank is None:
                    continue
                if use_dropout and rng.random() < dropout:
                    continue
                if best_rank is None or rank < best_rank:
                    best_rank = rank
                    best_idx = i
            if best_rank is None:
                break
            merged = word[best_idx] + word[best_idx + 1]
            word[best_idx : best_idx + 2] = [merged]

        if dropout <= 0.0 and len(self._cache) < 65536:
            self._cache[piece] = word
        return word

    # -- public API --------------------------------------------------------

    def encode(
        self,
        text: str,
        dropout: float = 0.0,
        rng: Optional[random.Random] = None,
    ) -> List[int]:
        if dropout > 0.0 and rng is None:
            rng = random

        ids: List[int] = []
        for match in _PRETOKENIZE_PATTERN.finditer(text):
            piece = "".join(
                self._byte_encoder[b] for b in match.group(0).encode("utf-8")
            )
            if self._native is not None:
                seed = rng.getrandbits(63) if (dropout > 0.0 and rng is not None) else 0
                ids.extend(
                    self._native.encode_piece(
                        [self.vocab[c] for c in piece], dropout, seed
                    )
                )
            else:
                for token in self._bpe(piece, dropout, rng):
                    ids.append(self.vocab[token])
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.inv_vocab[i] for i in ids if i in self.inv_vocab)
        raw = bytes(self._byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace")
