"""Shared utilities: config IO, step math, seeding, parameter counts; the
port of ``whisper_finetune_tpu/utils.py``.

The step math is the JAX package's (the reference's ``utils.py:14-53``),
with the world size the number of data-parallel processes: one card here.
Seeding covers python, numpy and torch, and the ``torch.Generator`` on the
card that the training step draws its own random numbers from (SpecAugment,
stochastic depth).
"""

from __future__ import annotations

import math
import os
import random
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np
import torch
import yaml


def calculate_training_steps(config: Dict[str, Any], num_samples: int, world_size: int = 1,
                             drop_last: bool = True) -> int:
    """Optimizer steps of a run. With ``drop_last`` each rank sees
    ``samples // world_size`` samples, full microbatches only, and the
    optimizer steps once per ``accum_grad_steps`` microbatches (floor,
    minimum 1); without it, a global ceiling division. ``accum_grad_steps``
    is the local count (:func:`resolve_local_accum_grad_steps`)."""
    epochs = config["training"]["epochs"]
    batch_size = config["dataset"]["batch_size"]
    accum_grad_steps = config["training"]["accum_grad_steps"]
    world_size = max(int(world_size), 1)

    if drop_last:
        samples_per_rank = num_samples // world_size
        microbatches_per_epoch = samples_per_rank // batch_size
        steps = math.floor((microbatches_per_epoch * epochs) / accum_grad_steps)
        return max(steps, 1)

    return math.ceil(num_samples * epochs / (batch_size * world_size * accum_grad_steps))


def resolve_local_accum_grad_steps(accum_grad_steps: int, world_size: int = 1) -> int:
    """The configured *global* accumulation window as per-process local
    accumulation: it must divide evenly by the world size."""
    accum_grad_steps = int(accum_grad_steps)
    world_size = max(int(world_size), 1)

    if accum_grad_steps < 1:
        raise ValueError(f"accum_grad_steps must be >= 1, got {accum_grad_steps}.")

    if accum_grad_steps % world_size != 0:
        raise ValueError(
            "training.accum_grad_steps is interpreted as the global accumulation "
            "window and must be divisible by the data-parallel world size. Got "
            f"accum_grad_steps={accum_grad_steps} and world_size={world_size}."
        )

    return accum_grad_steps // world_size


def calculate_val_steps(config: Dict[str, Any]) -> int:
    """Steps between validation runs."""
    val_steps = (
        config["training"]["train_steps"] / config["training"]["epochs"]
    ) * config["training"]["eval_steps"]
    return max(int(val_steps), 1)


def read_config(yaml_file_path: str) -> Dict[str, Any]:
    """Load a YAML run config (the JAX package's schema)."""
    print(f"Reading config {yaml_file_path}")
    with open(yaml_file_path, "r") as file:
        return yaml.safe_load(file)


def set_seed(seed: int, generator: Optional[torch.Generator] = None) -> np.random.Generator:
    """Seed python's, numpy's and torch's global generators (the data
    pipeline's host draws) and ``generator`` (the one the training step
    draws from), and return a numpy Generator for callers that prefer an
    explicit one."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if generator is not None:
        generator.manual_seed(seed)
    return np.random.default_rng(seed)


def get_unique_base_path() -> str:
    """Run directory leaf name: scheduler job id if present, else timestamp."""
    return os.getenv("SLURM_JOB_ID", datetime.now().strftime("%Y%m%d_%H%M%S"))


def print_trainable_parameters(model) -> None:
    """Trainable (``requires_grad``) against total parameter counts of a
    :class:`~whisper_finetune_torch.models.whisper.Whisper`."""
    leaves = [p for _, p in model.leaves()]
    total = sum(p.numel() for p in leaves)
    trainable = sum(p.numel() for p in leaves if p.requires_grad)
    print(f"Number of trainable parameters: {trainable:,} out of total {total:,}.")
