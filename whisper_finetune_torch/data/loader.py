"""Batch loader: sampler-driven batching with worker parallelism and
background prefetch.

Replaces the reference's torch ``DataLoader(pin_memory=True, num_workers=N)``
(src/whisper_finetune/data/data_loader.py:469-529) with a thread-pool sample
builder plus a bounded prefetch queue: workers build numeric samples
(tokenization, audio augmentation — numpy code that releases the GIL for its
heavy parts), the collator packs fixed-shape arrays, and the training loop
overlaps host building with device compute. Device placement happens in the
train loop (:func:`to_device`: pinned host memory, ``non_blocking`` copies)
so the loader itself stays numpy.

``infinite_batches`` reproduces the reference's ``infinite_iter``
(model_utils.py:209-217): epoch-looping with ``sampler.set_epoch`` so
shuffles differ per epoch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from whisper_finetune_torch.data.dataset import MODEL_N_TEXT_CTX, SampleDataset, collate
from whisper_finetune_torch.runtime import span


class BatchLoader:
    """Iterable over collated batches for one pass of the sampler."""

    def __init__(
        self,
        dataset: SampleDataset,
        batch_size: int,
        sampler=None,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 0,
        drop_last: bool = False,
        pad_to: Optional[int] = MODEL_N_TEXT_CTX,
        prefetch: int = 2,
    ):
        from whisper_finetune_torch.data.sampler import SequentialSampler, ShardedSampler

        self.dataset = dataset
        self.batch_size = int(batch_size)
        if sampler is None:
            sampler = (
                ShardedSampler(len(dataset), shuffle=True, seed=seed)
                if shuffle
                else SequentialSampler(len(dataset))
            )
        self.sampler = sampler
        self.num_workers = int(num_workers or 0)
        self.drop_last = drop_last
        self.pad_to = pad_to
        self.prefetch = max(prefetch, 1)
        self._epoch_offset = 0  # stream-position salt for per-sample RNG

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> Iterator[List[tuple]]:
        it = iter(self.sampler)
        position = self._epoch_offset
        while True:
            batch = list(islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield [(idx, position + i) for i, idx in enumerate(batch)]
            position += len(batch)

    def _build(self, idx_salt: tuple) -> Dict:
        idx, salt = idx_salt
        return self.dataset.get(idx, salt=salt)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            for index_batch in self._index_batches():
                yield collate([self._build(t) for t in index_batch], self.pad_to)
            return

        # Worker pool + bounded prefetch: build ahead of consumption.
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    pending = []
                    for index_batch in self._index_batches():
                        pending.append(
                            [pool.submit(self._build, t) for t in index_batch]
                        )
                        while len(pending) > self.prefetch:
                            ready = pending.pop(0)
                            out_q.put(
                                collate([f.result() for f in ready], self.pad_to)
                            )
                    for ready in pending:
                        out_q.put(collate([f.result() for f in ready], self.pad_to))
            except Exception as e:  # surface worker errors to the consumer
                out_q.put(e)
            finally:
                out_q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = out_q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item
        thread.join()


def infinite_batches(loader: BatchLoader) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch-looping infinite stream with per-epoch reshuffle
    (reference infinite_iter, model_utils.py:209-217)."""
    epoch = 0
    while True:
        if hasattr(loader.sampler, "set_epoch"):
            loader.sampler.set_epoch(epoch)
        loader._epoch_offset = epoch * max(len(loader.sampler), 1)
        yield from loader
        epoch += 1


def stack_microbatches(
    batches: List[Dict[str, np.ndarray]]
) -> Dict[str, np.ndarray]:
    """Stack ``accum_local`` collated microbatches into the
    (accum, batch, ...) arrays the train step scans over. With decoder
    length bucketing, microbatches in one optimizer step may land in
    different buckets — re-pad token arrays to the largest before stacking
    (0 for inputs, -100 for targets)."""
    with span("wft.stack"):
        out = {}
        for k in batches[0]:
            arrays = [b[k] for b in batches]
            if k in ("dec_input", "dec_output") and len(
                {a.shape[-1] for a in arrays}
            ) > 1:
                target = max(a.shape[-1] for a in arrays)
                fill = -100 if k == "dec_output" else 0
                arrays = [
                    np.pad(a, ((0, 0), (0, target - a.shape[-1])), constant_values=fill)
                    for a in arrays
                ]
            out[k] = np.stack(arrays)
        return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A collated (or stacked) numpy batch as tensors on ``device``: token
    arrays as int64, the rest as they are. For a CUDA device each array is
    copied into pinned host memory and sent with a ``non_blocking`` copy on
    the current stream, so the transfer overlaps the host's next work (the
    reference's ``pin_memory=True`` loader with ``non_blocking`` copies)."""
    with span("wft.to_device"):
        dev = torch.device(device)
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k in ("dec_input", "dec_output"):
                t = t.long()
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            elif dev.type != "cpu":
                t = t.to(dev)
            out[k] = t
        return out
