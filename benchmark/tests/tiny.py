"""Cells of the benchmark cut to a size a CPU test holds: the widths and
depths below, few rows, short decodes. Only tests use them."""

from __future__ import annotations

import copy

from benchmark import spec

TINY_DIMS = dict(n_audio_state=64, n_audio_head=1, n_audio_layer=2,
                 n_text_state=64, n_text_head=1, n_text_layer=2)
TRAIN_CELLS = ("large-v3.muon-b32a8", "large-v3-turbo.adamw8-b64a4")
DECODE_CELL = "large-v3.greedy-b8"


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(spec.cell(name))
    tr = cell["traffic_spec"]
    if tr["kind"] == "train":
        tr.update(distinct_rows=8, reference_slice_rows=1)
        cell["overrides"] = {"dataset.batch_size": 2, "training.accum_grad_steps": 2}
    else:
        tr.update(distinct_rows=8, rows=4, max_len=24, check_rows=4)
    return cell
