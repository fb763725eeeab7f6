"""Word/character error rates via Levenshtein distance.

The reference computes WER/CER with jiwer (RapidFuzz C++ backend;
reference src/whisper_finetune/eval/metrics.py:12,45-82). jiwer is not part
of this stack, so the edit distance is implemented here directly with a
vectorized numpy two-row dynamic program (eval runs host-side on process 0,
off the device hot path). Conventions match jiwer's defaults:

* WER: whitespace-collapsed, stripped word sequences,
* CER: stripped character sequences (spaces count as characters),
* plus the reference's empty-reference convention (metrics.py:45-82):
  empty ref -> 0.0 if the prediction is empty too, else 1.0.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two token sequences (numpy two-row DP)."""
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    # Map tokens to ids for fast vector compares.
    vocab = {}
    ai = np.fromiter((vocab.setdefault(t, len(vocab)) for t in a), np.int32, len(a))
    bi = np.fromiter((vocab.setdefault(t, len(vocab)) for t in b), np.int32, len(b))

    try:  # C++ fast path (whisper_finetune_torch/native)
        from whisper_finetune_torch.native import levenshtein_ids

        native = levenshtein_ids(ai.tolist(), bi.tolist())
        if native is not None:
            return native
    except Exception:
        pass

    prev = np.arange(len(bi) + 1, dtype=np.int32)
    cur = np.empty_like(prev)
    for i, av in enumerate(ai, start=1):
        cur[0] = i
        # substitution / deletion are elementwise over the previous row
        np.minimum(prev[:-1] + (bi != av), prev[1:] + 1, out=cur[1:])
        # insertion chains depend left-to-right within the current row
        running = cur[0]
        for j in range(1, len(cur)):
            if running + 1 < cur[j]:
                cur[j] = running + 1
            running = cur[j]
        prev, cur = cur, prev
    return int(prev[-1])


def word_error_rate(reference: str, hypothesis: str) -> float:
    ref_words = reference.split()
    hyp_words = hypothesis.split()
    if not ref_words:
        return 0.0 if not hyp_words else 1.0
    return levenshtein(ref_words, hyp_words) / len(ref_words)


def char_error_rate(reference: str, hypothesis: str) -> float:
    ref_chars = list(reference.strip())
    hyp_chars = list(hypothesis.strip())
    if not ref_chars:
        return 0.0 if not hyp_chars else 1.0
    return levenshtein(ref_chars, hyp_chars) / len(ref_chars)


def compute_wer(predictions: List[str], references: List[str]) -> List[float]:
    """Per-utterance WER with the reference's empty-ref convention
    (metrics.py:45-60)."""
    return [
        0.0
        if ref.strip() == "" and pred.strip() == ""
        else (1.0 if ref.strip() == "" else word_error_rate(ref, pred))
        for pred, ref in zip(predictions, references)
    ]


def compute_cer_batch(predictions: List[str], references: List[str]) -> List[float]:
    """Per-utterance CER with the reference's empty-ref convention
    (metrics.py:63-82)."""
    return [
        0.0
        if ref.strip() == "" and pred.strip() == ""
        else (1.0 if ref.strip() == "" else char_error_rate(ref, pred))
        for pred, ref in zip(predictions, references)
    ]
