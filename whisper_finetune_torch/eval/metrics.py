"""Evaluation metrics: WER/CER, token-level NLL / log-prob / entropy /
confidence, expected calibration error, dataset aggregation, macro averaging.

Numerical parity with the reference's metrics module
(src/whisper_finetune/eval/metrics.py): same dataclass fields, same -100
masking, same 20-bin (lower, upper]-binned ECE, same unweighted macro
average. The token statistics themselves are computed on the device inside the
eval step (see eval/evaluator.py) — this module aggregates the small
per-token arrays host-side.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from whisper_finetune_torch.eval.wer import compute_cer_batch, compute_wer  # noqa: F401


@dataclass
class PerUtteranceMetrics:
    prediction: str
    reference: str
    wer: float
    cer: float
    token_nll: float
    avg_log_prob: float
    token_entropy: float
    token_confidences: List[float]
    token_correct: List[bool]


@dataclass
class DatasetMetrics:
    dataset_name: str
    num_samples: int
    wer: float
    cer: float
    mean_token_nll: float
    avg_log_prob: float
    mean_token_entropy: float
    ece: float
    per_utterance: List[PerUtteranceMetrics]


def compute_token_metrics(
    logits: np.ndarray,
    target_ids: np.ndarray,
    predicted_ids: np.ndarray,
) -> Tuple[float, float, float, List[float], List[bool]]:
    """Host-side token metrics from raw logits (one utterance): mean NLL over
    non-(-100) positions, mean log-prob of the *predicted* tokens, mean
    softmax entropy, per-token max-prob confidence and correctness
    (reference metrics.py:85-137). The evaluator normally uses the fused
    on-device variant; this is the reference-shaped API for tests and
    external callers."""
    target_ids = np.asarray(target_ids)
    mask = target_ids != -100
    if mask.sum() == 0:
        return 0.0, 0.0, 0.0, [], []
    lg = np.asarray(logits, dtype=np.float64)[mask]
    tg = target_ids[mask]
    pr = np.asarray(predicted_ids)[mask]

    lg = lg - lg.max(axis=-1, keepdims=True)
    logz = np.log(np.exp(lg).sum(axis=-1, keepdims=True))
    logp = lg - logz
    probs = np.exp(logp)

    nll = -logp[np.arange(len(tg)), tg]
    pred_lp = logp[np.arange(len(pr)), pr]
    entropy = -(probs * logp).sum(axis=-1)
    confidences = probs.max(axis=-1)
    correct = pr == tg

    return (
        float(nll.mean()),
        float(pred_lp.mean()),
        float(entropy.mean()),
        confidences.tolist(),
        correct.tolist(),
    )


def compute_ece(
    all_confidences: Sequence[float], all_correct: Sequence[bool], n_bins: int = 20
) -> float:
    """Expected Calibration Error with (lower, upper]-binned confidences
    (reference metrics.py:140-178)."""
    if len(all_confidences) == 0:
        return 0.0
    conf = np.asarray(all_confidences, dtype=np.float64)
    corr = np.asarray(all_correct, dtype=np.float64)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    ece = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        frac = in_bin.mean()
        if frac > 0:
            ece += frac * abs(conf[in_bin].mean() - corr[in_bin].mean())
    return float(ece)


def aggregate_dataset_metrics(
    per_utterance_metrics: List[PerUtteranceMetrics], dataset_name: str
) -> DatasetMetrics:
    """Unweighted per-utterance means + pooled-token ECE
    (reference metrics.py:181-231)."""
    if not per_utterance_metrics:
        return DatasetMetrics(dataset_name, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, [])

    def mean(attr):
        return float(np.mean([getattr(m, attr) for m in per_utterance_metrics]))

    all_conf: List[float] = []
    all_corr: List[bool] = []
    for m in per_utterance_metrics:
        all_conf.extend(m.token_confidences)
        all_corr.extend(m.token_correct)

    return DatasetMetrics(
        dataset_name=dataset_name,
        num_samples=len(per_utterance_metrics),
        wer=mean("wer"),
        cer=mean("cer"),
        mean_token_nll=mean("token_nll"),
        avg_log_prob=mean("avg_log_prob"),
        mean_token_entropy=mean("token_entropy"),
        ece=compute_ece(all_conf, all_corr),
        per_utterance=per_utterance_metrics,
    )


_MACRO_FIELDS = {
    "macro_wer": "wer",
    "macro_cer": "cer",
    "macro_mean_token_nll": "mean_token_nll",
    "macro_avg_log_prob": "avg_log_prob",
    "macro_mean_token_entropy": "mean_token_entropy",
    "macro_ece": "ece",
}


def compute_macro_average(dataset_metrics: List[DatasetMetrics]) -> Dict[str, float]:
    """Unweighted mean across datasets (reference metrics.py:234-264)."""
    if not dataset_metrics:
        return {k: 0.0 for k in _MACRO_FIELDS}
    return {
        k: float(np.mean([getattr(m, attr) for m in dataset_metrics]))
        for k, attr in _MACRO_FIELDS.items()
    }
