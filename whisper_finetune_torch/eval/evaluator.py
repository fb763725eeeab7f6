"""Multi-dataset teacher-forced evaluator, the port of
``whisper_finetune_tpu/eval/evaluator.py``.

Teacher-forced forward (no autoregressive decode), argmax predictions,
special/-100 token stripping, v0 text normalisation, per-utterance WER/CER
and token metrics, per-dataset aggregation, the unweighted macro average and
the ``val/{name}_{metric}`` logging namespace.

One eval step computes the logits AND every per-token statistic (NLL,
predicted log-prob, entropy, confidence) on the device under
``torch.no_grad``: only (B, T) tensors come to the host, never the
(B, T, vocab) logits. Its forward goes through the attention kernels of the
run's ``attn_impl`` (forward only). Text handling and aggregation run on the
host.

Across processes (the JAX evaluator's SPMD mesh branch) every rank builds
the same host batch, pads its rows to a multiple of the world size
(:func:`_pad_rows`: padding rows are all ``-100`` and skipped), runs the
eval step on its own row slice and all-gathers the per-row statistics
(``parallel.all_gather_rows``), so every rank computes the same ``val/*``
in lockstep.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

import whisper_finetune_torch.runtime as rt
from whisper_finetune_torch import parallel
from whisper_finetune_torch.data.loader import to_device
from whisper_finetune_torch.eval.metrics import (
    DatasetMetrics,
    PerUtteranceMetrics,
    aggregate_dataset_metrics,
    compute_macro_average,
)
from whisper_finetune_torch.eval.text_norm import VOCAB_SPECS, normalize_text
from whisper_finetune_torch.eval.wer import char_error_rate, word_error_rate
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import ForwardConfig, Whisper, forward_impl
from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig, featurize_impl


def eval_forward_config(fcfg: ForwardConfig) -> ForwardConfig:
    """The teacher-forced eval ForwardConfig from the train one: keep what
    changes the math at inference (compute dtype, LoRA scale, the attention
    mix with its per-site choices) and drop the train-only features (remat,
    stochastic depth, deep SpecAugment, LoRA dropout)."""
    return ForwardConfig(
        compute_dtype=fcfg.compute_dtype,
        remat_encoder=False,
        remat_encoder_last_only=False,
        remat_decoder=False,
        stochastic_depth=0.0,
        dsa_apply=False,
        lora_scale=fcfg.lora_scale,
        attn_impl=fcfg.attn_impl,
        attn_impl_encoder=fcfg.attn_impl_encoder,
        attn_impl_decoder=fcfg.attn_impl_decoder,
        attn_impl_cross=fcfg.attn_impl_cross,
    )


def make_eval_step(dims: ModelDimensions, fcfg: ForwardConfig,
                   n_mels: Optional[int] = None) -> Callable:
    """``step(params, batch) -> (pred, nll, pred_lp, entropy, conf)``, each
    (B, T) on the batch's device: predicted ids, NLL of the targets, log-prob
    of the predictions, entropy, max-prob confidence. ``params`` is a
    :class:`Whisper` or its tree; ``batch`` holds ``mel`` or ``audio`` +
    ``crop_frames`` (featurized without augmentation), and ``dec_input``,
    ``dec_output``. Masking by -100 happens on the host."""
    eval_fcfg = eval_forward_config(fcfg)
    feat_cfg = FeaturizeConfig(n_mels=n_mels or dims.n_mels)

    @torch.no_grad()
    def step(params, batch):
        if isinstance(params, Whisper):
            params = params.params()
        if "mel" in batch:
            mel = batch["mel"]
        else:
            mel = featurize_impl(batch["audio"], batch["crop_frames"], None, feat_cfg,
                                 train=False)
        dec_in, dec_out = batch["dec_input"], batch["dec_output"]
        logits = forward_impl(params, mel, dec_in, dims, eval_fcfg, train=False)
        logp = torch.log_softmax(logits, dim=-1)
        pred = torch.argmax(logits, dim=-1)
        safe_t = torch.where(dec_out == -100, 0, dec_out).long()
        nll = -torch.gather(logp, -1, safe_t[..., None])[..., 0]
        pred_lp = torch.gather(logp, -1, pred[..., None])[..., 0]
        entropy = -torch.sum(torch.exp(logp) * logp, dim=-1)
        conf = torch.exp(torch.amax(logp, dim=-1))
        return pred, nll, pred_lp, entropy, conf

    return step


def _pad_rows(batch: Dict, multiple: int) -> Dict:
    """Pad the batch dimension to a multiple so it splits evenly over the
    ranks. Padding rows carry all -100 targets, so the per-utterance loop
    skips them (empty reference)."""
    n = next(iter(batch.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        if k == "dec_output":
            fill = -100
        elif k == "crop_frames":
            fill = 3000  # keep the featurize crop valid for padding rows
        else:
            fill = 0
        widths = [(0, pad)] + [(0, 0)] * (np.ndim(v) - 1)
        out[k] = np.pad(np.asarray(v), widths, constant_values=fill)
    return out


def _run_eval_step(eval_step: Callable, params, batch: Dict, device) -> Tuple:
    """The eval step's five (B, T) statistics for the whole host ``batch``,
    as numpy: on this rank's row slice and all-gathered in a process group,
    else on the whole batch."""
    if not parallel.is_initialized():
        return tuple(x.cpu().numpy() for x in eval_step(params, to_device(batch, device)))
    rows = {k: np.asarray(parallel.shard_rows(np.asarray(v))) for k, v in batch.items()}
    stats = eval_step(params, to_device(rows, device))
    return tuple(parallel.all_gather_rows(x.contiguous()).cpu().numpy() for x in stats)


def evaluate_single_dataset(eval_step: Callable, params, batches: Iterable, dataset_name: str,
                            tokenizer, device="cuda") -> DatasetMetrics:
    """Evaluate one dataset. ``batches`` yields numpy dicts with ``mel`` or
    ``audio`` + ``crop_frames``, and ``dec_input``, ``dec_output`` (the
    train pipeline's contract without prompts or timestamps); each goes to
    ``device`` for the eval step; in a process group each rank evaluates
    its row slice and every rank gets every row's statistics."""
    special_ids = set(tokenizer.special_tokens.values())
    per_utterance: List[PerUtteranceMetrics] = []
    spec = VOCAB_SPECS["v0"]

    for batch in batches:
        keys = ("mel",) if "mel" in batch else ("audio", "crop_frames")
        host = {k: batch[k] for k in keys + ("dec_input", "dec_output")}
        if parallel.is_initialized():
            host = _pad_rows(host, parallel.world())
        pred, nll, pred_lp, entropy, conf = _run_eval_step(eval_step, params, host, device)
        # the (possibly row-padded) batch, so indices align; padded rows are
        # all -100 and fall through the empty-reference skip
        targets = np.asarray(host["dec_output"])

        for i in range(pred.shape[0]):
            t_ids = targets[i]
            mask = t_ids != -100

            pred_tokens = [int(t) for t in pred[i].tolist()
                           if t not in special_ids and t != -100]
            true_tokens = [int(t) for t in t_ids.tolist()
                           if t not in special_ids and t != -100]
            true_text = tokenizer.decode(true_tokens)
            if true_text.strip() == "":
                continue  # the reference skips empty references
            pred_text = tokenizer.decode(pred_tokens)

            pred_norm = normalize_text(pred_text, **spec)
            true_norm = normalize_text(true_text, **spec)

            if mask.sum() == 0:
                tok_stats = (0.0, 0.0, 0.0, [], [])
            else:
                tok_stats = (
                    float(nll[i][mask].mean()),
                    float(pred_lp[i][mask].mean()),
                    float(entropy[i][mask].mean()),
                    conf[i][mask].tolist(),
                    (pred[i][mask] == t_ids[mask]).tolist(),
                )

            per_utterance.append(
                PerUtteranceMetrics(
                    prediction=pred_norm,
                    reference=true_norm,
                    wer=word_error_rate(true_norm, pred_norm)
                    if true_norm else (0.0 if not pred_norm else 1.0),
                    cer=char_error_rate(true_norm, pred_norm)
                    if true_norm else (0.0 if not pred_norm else 1.0),
                    token_nll=tok_stats[0],
                    avg_log_prob=tok_stats[1],
                    token_entropy=tok_stats[2],
                    token_confidences=tok_stats[3],
                    token_correct=tok_stats[4],
                )
            )

    return aggregate_dataset_metrics(per_utterance, dataset_name)


def evaluate_multiple_datasets(eval_step: Callable, params,
                               dataloaders: Dict[str, Callable[[], Iterable]], tokenizer,
                               device="cuda") -> Tuple[List[DatasetMetrics], Dict[str, float]]:
    """Evaluate every validation dataset and macro-average. ``dataloaders``
    maps name -> a callable returning a fresh batch iterator."""
    all_metrics: List[DatasetMetrics] = []
    for name, make_batches in dataloaders.items():
        rt.print_once(f"\n{'=' * 60}\nEvaluating dataset: {name}\n{'=' * 60}")
        dm = evaluate_single_dataset(eval_step, params, make_batches(), name, tokenizer,
                                     device=device)
        all_metrics.append(dm)
        rt.print_once(
            f"\nResults for {name}:\n"
            f"  Samples: {dm.num_samples}\n"
            f"  WER: {dm.wer:.4f}\n  CER: {dm.cer:.4f}\n"
            f"  Mean Token NLL: {dm.mean_token_nll:.4f}\n"
            f"  Avg Log Prob: {dm.avg_log_prob:.4f}\n"
            f"  Mean Token Entropy: {dm.mean_token_entropy:.4f}\n"
            f"  ECE: {dm.ece:.4f}"
        )
    macro = compute_macro_average(all_metrics)
    rt.print_once(f"\n{'=' * 60}\nMACRO AVERAGES (unweighted across datasets)\n{'=' * 60}")
    for k, v in macro.items():
        rt.print_once(f"  {k}: {v:.4f}")
    return all_metrics, macro


def log_metrics_to_wandb(dataset_metrics: List[DatasetMetrics], macro_metrics: Dict[str, float],
                         step: int, prefix: str = "val") -> None:
    """Flatten into the reference's metric namespace; ``rt.log`` fans out to
    W&B (if enabled) and the local metrics JSONL."""
    log_dict: Dict[str, float] = {}
    for dm in dataset_metrics:
        base = f"{prefix}/{dm.dataset_name}"
        log_dict[f"{base}_wer"] = dm.wer
        log_dict[f"{base}_cer"] = dm.cer
        log_dict[f"{base}_loss"] = dm.mean_token_nll
        log_dict[f"{base}_mean_token_nll"] = dm.mean_token_nll
        log_dict[f"{base}_avg_log_prob"] = dm.avg_log_prob
        log_dict[f"{base}_mean_token_entropy"] = dm.mean_token_entropy
        log_dict[f"{base}_ece"] = dm.ece
        log_dict[f"{base}_num_samples"] = dm.num_samples
    for k, v in macro_metrics.items():
        log_dict[f"{prefix}/{k}"] = v
    rt.log(log_dict, step=step)
