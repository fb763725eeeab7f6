"""Index samplers: warmup curriculum, per-process data sharding, epoch math.

* ``WarmupDatasetSampler`` — curriculum sampler that yields only the warmup
  dataset's indices for the first ``warmup_steps * batch_size`` samples, then
  all indices, as an infinite stream (reference
  src/whisper_finetune/data/data_loader.py:370-448). Like the reference, it
  is single-process only (finetune.py:597-598 raises under DDP).
* ``ShardedSampler`` — the DistributedSampler replacement (reference
  finetune.py:619-629): every process permutes the full index set with the
  same (seed, epoch) key and takes its ``rank``-strided slice, so global
  coverage is disjoint and epoch-reshuffled. ``drop_last`` trims to equal
  shard sizes.
* ``get_dataset_boundary_indices`` — start/end ranges of concatenated
  datasets (data_loader.py:451-466).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def get_dataset_boundary_indices(dataset_sizes: List[int]) -> List[Tuple[int, int]]:
    boundaries = []
    start = 0
    for size in dataset_sizes:
        boundaries.append((start, start + size))
        start += size
    return boundaries


class WarmupDatasetSampler:
    """Infinite curriculum stream: warmup indices first, then everything."""

    def __init__(
        self,
        warmup_indices: List[int],
        all_indices: List[int],
        warmup_steps: int,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.warmup_indices = list(warmup_indices)
        self.all_indices = list(all_indices)
        if warmup_steps < 0:
            raise ValueError(f"warmup_steps must be >= 0, got {warmup_steps}")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be > 0, got {batch_size}")
        if not self.all_indices:
            raise ValueError("all_indices must be non-empty")
        if not self.warmup_indices and warmup_steps > 0:
            raise ValueError("warmup_indices must be non-empty when warmup_steps > 0")
        self.warmup_samples = int(warmup_steps) * int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        print(
            "WarmupDatasetSampler initialized:\n"
            f"  - Warmup indices: {len(self.warmup_indices)}\n"
            f"  - All indices: {len(self.all_indices)}\n"
            f"  - Warmup steps: {warmup_steps} ({self.warmup_samples} samples)"
        )

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng((self.seed, self._epoch))
        emitted = 0
        announced = False
        while True:
            in_warmup = emitted < self.warmup_samples
            indices = np.asarray(
                self.warmup_indices if in_warmup else self.all_indices
            )
            if self.shuffle:
                indices = rng.permutation(indices)
            for idx in indices:
                if not announced and emitted >= self.warmup_samples:
                    print(
                        f"\n>>> Warmup complete after {self.warmup_samples} "
                        "samples. Now sampling from all datasets.\n"
                    )
                    announced = True
                yield int(idx)
                emitted += 1

    def __len__(self) -> int:
        return len(self.all_indices)


class ShardedSampler:
    """Per-process disjoint shard of a shared (seed, epoch) permutation."""

    def __init__(
        self,
        num_samples: int,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world_size {world_size}")
        self.num_samples = int(num_samples)
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            order = np.random.default_rng((self.seed, self._epoch)).permutation(
                self.num_samples
            )
        else:
            order = np.arange(self.num_samples)
        if self.drop_last:
            usable = (self.num_samples // self.world_size) * self.world_size
            order = order[:usable]
        shard = order[self.rank :: self.world_size]
        return iter(int(i) for i in shard)

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_samples // self.world_size
        return (self.num_samples + self.world_size - 1) // self.world_size


class SequentialSampler:
    def __init__(self, num_samples: int):
        self.num_samples = int(num_samples)

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.num_samples))

    def __len__(self) -> int:
        return self.num_samples
