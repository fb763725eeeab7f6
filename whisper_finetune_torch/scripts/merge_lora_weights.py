"""Merge LoRA adapters into their base weights: the offline deployment step,
the port of ``whisper_finetune_tpu/scripts/merge_lora_weights.py``.

    python -m whisper_finetune_torch.scripts.merge_lora_weights \\
        --input lora.pt --output merged.pt [--test_merge] [--rank 16] [--alpha 32] \\
        [--device cuda]

Reads an unmerged LoRA checkpoint (torch-parametrize key layout: the base
weights are in its ``parametrizations.weight.original`` entries, so no base
model is needed), folds ``W += (alpha/rank) * A @ B`` layer by layer on the
card (``--device cpu`` on the CPU), the float32 fold of the runtime-LoRA
forward, and writes an fp16 OpenAI-format checkpoint.
"""

from __future__ import annotations

import argparse

import torch

from whisper_finetune_torch.models.checkpoint import load_checkpoint, save_checkpoint
from whisper_finetune_torch.models.lora import has_lora, merge_lora, remove_lora
from whisper_finetune_torch.models.whisper import flatten


def main(input_path: str, output_path: str, test_merge: bool = False,
         rank: int = 16, alpha: float = 32.0, device="cuda") -> None:
    model, dims = load_checkpoint(input_path, device=device)
    params = model.params()
    if not has_lora(params):
        raise ValueError(f"{input_path} contains no LoRA adapters (nothing to merge)")
    print(f"Loaded LoRA checkpoint {input_path} (dims: {dims.to_dict()})")

    merged = merge_lora(params, rank=rank, alpha=alpha)
    save_checkpoint(output_path, merged, dims)
    print(f"Merged model written to {output_path}")

    if test_merge:
        reloaded, dims2 = load_checkpoint(output_path, device=device)
        if dims2 != dims:
            raise AssertionError(f"merged dims {dims2} != {dims}")
        if has_lora(reloaded.params()):
            raise AssertionError("merged checkpoint still has LoRA keys")
        base = flatten(remove_lora(params))
        changed = sum(not torch.allclose(a, b, atol=1e-6, rtol=0)
                      for (_, a), (_, b) in zip(flatten(reloaded.params()), base))
        if changed == 0:
            raise AssertionError("merged weights identical to base: adapters were all zero?")
        print(f"Merge verified: {changed} parameter groups changed vs base.")


def cli() -> None:
    parser = argparse.ArgumentParser(
        description="Merge LoRA weights into an fp16 OpenAI-format checkpoint")
    parser.add_argument("--input", required=True, help="Unmerged LoRA checkpoint (.pt)")
    parser.add_argument("--output", required=True, help="Output merged checkpoint (.pt)")
    parser.add_argument("--test_merge", action="store_true",
                        help="Verify the merge changed weights and stripped adapters")
    parser.add_argument("--rank", type=int, default=16)
    parser.add_argument("--alpha", type=float, default=32.0)
    parser.add_argument("--device", default="cuda",
                        help="Device of the merge: cuda (default) or cpu to run on the CPU")
    args = parser.parse_args()
    main(args.input, args.output, args.test_merge, args.rank, args.alpha, args.device)


if __name__ == "__main__":
    cli()
