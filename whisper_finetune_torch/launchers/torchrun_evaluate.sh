#!/bin/bash
# Evaluate a checkpoint across N cards of one host: every rank reads the same
# batches and scores its row slice; rank 0 prints the val/* numbers as JSON.
#
# Usage: whisper_finetune_torch/launchers/torchrun_evaluate.sh N --checkpoint best_model.pt \
#            --datasets data/debug_dataset [more evaluate args]
set -euo pipefail

NPROC="${1:?usage: $0 <nproc> --checkpoint <ckpt.pt> --datasets <dir> [...]}"
shift

exec torchrun --standalone --nproc_per_node="$NPROC" \
  -m whisper_finetune_torch.scripts.evaluate "$@"
