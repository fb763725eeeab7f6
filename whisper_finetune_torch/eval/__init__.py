from whisper_finetune_torch.eval.evaluator import (
    eval_forward_config,
    evaluate_multiple_datasets,
    evaluate_single_dataset,
    log_metrics_to_wandb,
    make_eval_step,
)
from whisper_finetune_torch.eval.metrics import (
    DatasetMetrics,
    PerUtteranceMetrics,
    aggregate_dataset_metrics,
    compute_ece,
    compute_macro_average,
    compute_token_metrics,
)
from whisper_finetune_torch.eval.text_norm import VOCAB_SPECS, normalize_text
from whisper_finetune_torch.eval.wer import (
    char_error_rate,
    compute_cer_batch,
    compute_wer,
    levenshtein,
    word_error_rate,
)

__all__ = [
    "DatasetMetrics",
    "PerUtteranceMetrics",
    "VOCAB_SPECS",
    "aggregate_dataset_metrics",
    "char_error_rate",
    "compute_cer_batch",
    "compute_ece",
    "compute_macro_average",
    "compute_token_metrics",
    "compute_wer",
    "eval_forward_config",
    "evaluate_multiple_datasets",
    "evaluate_single_dataset",
    "levenshtein",
    "log_metrics_to_wandb",
    "make_eval_step",
    "normalize_text",
    "word_error_rate",
]
