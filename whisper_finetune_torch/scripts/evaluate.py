"""Standalone evaluation CLI: score a checkpoint on validation datasets
without training, the port of ``whisper_finetune_tpu/scripts/evaluate.py``.

The same multi-dataset evaluator as the training driver (teacher-forced
WER / CER / NLL / entropy / ECE with macro averaging, ``eval/evaluator.py``)
behind its own command: point it at an OpenAI-format ``.pt`` and the
datasets to validate on, and it prints the ``val/*`` numbers as JSON.

Usage:
    python -m whisper_finetune_torch.scripts.evaluate \\
        --checkpoint best_model.pt \\
        --datasets data/debug_dataset [more ...] \\
        [--names name1 ...] [--split validation] [--batch-size 16] [--select-n 100] \\
        [--device cuda | cpu]

It runs on the card by default (``--device cpu`` for the CPU) and, under
``torchrun`` (``launchers/torchrun_evaluate.sh``), across ranks: every rank
reads the same batches, evaluates its row slice and gathers the rest, and
rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional


def main(args) -> Dict[str, float]:
    """Evaluate as ``args`` say; returns the ``val/*`` numbers (printed by
    rank 0)."""
    import whisper_finetune_torch.runtime as rt
    from whisper_finetune_torch._device import resolve_device
    from whisper_finetune_torch.data import (BatchLoader, SampleBuilder, SampleDataset,
                                             process_dataset)
    from whisper_finetune_torch.eval import evaluate_multiple_datasets, make_eval_step
    from whisper_finetune_torch.models import load_model
    from whisper_finetune_torch.models.whisper import ForwardConfig
    from whisper_finetune_torch.ops.attention import resolve_auto_impls
    from whisper_finetune_torch.tokenizer import get_tokenizer

    resolve_device(args.device)
    dev = rt.setup_distributed(args.device)
    model, dims = load_model(args.checkpoint, device=dev)
    tokenizer = get_tokenizer(multilingual=True, language=args.language, task="transcribe")
    # The training driver's attention resolution: ``auto`` is the kernels at
    # all three attention sites on a card, plain elsewhere.
    attn_kwargs = (resolve_auto_impls(dev) if args.attn_impl == "auto"
                   else {"attn_impl": args.attn_impl})
    fcfg = ForwardConfig(compute_dtype=args.dtype, **attn_kwargs)
    eval_step = make_eval_step(dims, fcfg, n_mels=dims.n_mels)

    names = args.names or [d.split("/")[-1] for d in args.datasets]
    builder = SampleBuilder(tokenizer, no_timestamp_training=True, prompt_use_rate=0.0,
                            no_timestamps_rate=0.0)
    loaders = {}
    for name, path in zip(names, args.datasets):
        hf = process_dataset([path], [args.select_n], args.split, [None])
        loader = BatchLoader(SampleDataset(hf, builder), batch_size=args.batch_size,
                             shuffle=False)
        loaders[name] = loader.__iter__

    metrics, macro = evaluate_multiple_datasets(eval_step, model, loaders, tokenizer,
                                                device=dev)
    result = {f"val/{m.dataset_name}_wer": m.wer for m in metrics}
    result.update({f"val/{k}": v for k, v in macro.items()})
    rt.print_once(json.dumps(result, indent=2))
    return result


def cli(argv: Optional[list] = None) -> None:
    import whisper_finetune_torch.runtime as rt

    parser = argparse.ArgumentParser(description="Evaluate a checkpoint")
    parser.add_argument("--checkpoint", required=True,
                        help="OpenAI-format .pt path or preset name")
    parser.add_argument("--datasets", nargs="+", required=True)
    parser.add_argument("--names", nargs="*", default=None)
    parser.add_argument("--split", default="validation")
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--select-n", type=int, default=None)
    parser.add_argument("--language", default="de")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--attn-impl", default="auto",
                        help="xla | flash | splash | flash_fwd | auto (the kernels at "
                             "every attention site on a card)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: this rank's card; raises without one) or cpu")
    args = parser.parse_args(argv)
    try:
        main(args)
    finally:
        rt.cleanup()


if __name__ == "__main__":
    cli()
