"""The weight bridge between the JAX package's parameter pytree and the port.

Both packages keep one layout (linear kernels (in, out), conv kernels
(width, in, out), block leaves stacked on a leading layer axis), so the
bridge moves arrays across unchanged: :func:`params_from_jax` takes the JAX
tree as nested dicts of numpy arrays (the caller runs
``jax.tree.map(np.asarray, params)``) and :func:`params_to_numpy` gives it
back. The port lays the conv kernels out for ``conv1d`` at use
(``models/whisper.py::conv_stem``). OpenAI ``.pt`` checkpoint I/O and LoRA
keys come later (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from whisper_finetune_torch._device import resolve_device
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import Whisper, flatten

NumpyTree = Dict[str, Any]


def _expected_shapes(dims: ModelDimensions) -> Dict[tuple, tuple]:
    d_a, d_t = dims.n_audio_state, dims.n_text_state
    return {
        ("encoder", "conv1", "w"): (3, dims.n_mels, d_a),
        ("encoder", "conv2", "w"): (3, d_a, d_a),
        ("encoder", "blocks", "attn", "q_w"): (dims.n_audio_layer, d_a, d_a),
        ("decoder", "tok_emb"): (dims.n_vocab, d_t),
        ("decoder", "pos_emb"): (dims.n_text_ctx, d_t),
        ("decoder", "blocks", "attn", "q_w"): (dims.n_text_layer, d_t, d_t),
    }


def params_from_jax(tree: NumpyTree, dims: ModelDimensions, device="cuda") -> Whisper:
    """JAX parameter tree (nested dicts of numpy arrays) -> :class:`Whisper`
    on ``device``, holding float32 copies of the same values."""
    dev = resolve_device(device)
    leaves = flatten(tree)
    lora = [p for p, _ in leaves if any(k.endswith("_lora") for k in p)]
    if lora:
        raise NotImplementedError(
            f"LoRA leaves {lora[0]} are not ported yet: ROADMAP queue 1, item 8"
        )
    shapes = {path: np.shape(a) for path, a in leaves}
    for path, want in _expected_shapes(dims).items():
        if shapes.get(path) != want:
            raise ValueError(f"{'.'.join(path)}: shape {shapes.get(path)}, "
                             f"dims say {want}")

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)

    return Whisper(dims, convert(tree))


def params_to_numpy(model: Whisper) -> NumpyTree:
    """:class:`Whisper` -> the JAX parameter tree as nested dicts of float32
    numpy arrays (the inverse of :func:`params_from_jax`)."""

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return node.detach().to("cpu", torch.float32).numpy()

    return convert(model.params())
