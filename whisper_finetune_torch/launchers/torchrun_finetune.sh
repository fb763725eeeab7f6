#!/bin/bash
# Data-parallel fine-tuning on N cards of one host: one process per card
# (cuda:LOCAL_RANK), gradients reduced once an optimizer step over NCCL.
# Set training.zero_shard_optimizer: true in the YAML to shard the
# optimizer state over the ranks (ZeRO-1).
#
# Usage: whisper_finetune_torch/launchers/torchrun_finetune.sh <config.yaml> [N] [extra args]
#   N defaults to the number of visible cards; extra args go to the driver.
set -euo pipefail

CONFIG="${1:?usage: $0 <config.yaml> [nproc] [extra args]}"
NPROC="${2:-$(python -c 'import torch; print(max(torch.cuda.device_count(), 1))')}"
shift $(( $# >= 2 ? 2 : 1 ))

exec torchrun --standalone --nproc_per_node="$NPROC" \
  -m whisper_finetune_torch.scripts.finetune --config "$CONFIG" "$@"
