"""Model surgery: encoder/decoder depth resizing, the port of
``whisper_finetune_tpu/models/surgery.py``.

A deterministic proportional keep/duplicate of the layers to reach a target
depth, used by the ``whisper-4832`` / ``whisper-3248`` presets. Layers are
stacked on a leading axis, so a resize is one ``index_select`` per stacked
leaf.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.models.whisper import Params

MODEL_LAYER_PRESETS = {
    "whisper-4832": {"base_init_name": "large-v3", "encoder_layers": 48, "decoder_layers": 32},
    "whisper-3248": {"base_init_name": "large-v3", "encoder_layers": 32, "decoder_layers": 48},
}


def resample_indices(current_layers: int, target_layers: int) -> np.ndarray:
    """Source layer of each target layer under proportional keep/duplicate:
    layer i repeats floor((i+1)*T/C) - floor(i*T/C) times."""
    if target_layers < 1:
        raise ValueError(f"target_layers must be >= 1, got {target_layers}")
    if current_layers < 1:
        raise ValueError("Cannot resize an empty block list")
    indices = []
    for i in range(current_layers):
        repeat = ((i + 1) * target_layers) // current_layers - (i * target_layers) // current_layers
        indices.extend([i] * repeat)
    if len(indices) != target_layers:
        raise AssertionError(f"{len(indices)} layers resampled for {target_layers}")
    return np.asarray(indices, dtype=np.int32)


@torch.no_grad()
def _select(tree: Params, idx: np.ndarray) -> Params:
    return {k: _select(v, idx) if isinstance(v, dict)
            else v.index_select(0, torch.as_tensor(idx, dtype=torch.long, device=v.device))
            for k, v in tree.items()}


def resize_whisper_layers(
    params: Params,
    dims: ModelDimensions,
    target_encoder_layers: Optional[int] = None,
    target_decoder_layers: Optional[int] = None,
) -> Tuple[Params, ModelDimensions, bool]:
    """Resize depth before training: (params, dims, changed). The input tree
    is not modified; resized blocks are new tensors."""
    changed = False
    for side, target, attr in (("encoder", target_encoder_layers, "n_audio_layer"),
                               ("decoder", target_decoder_layers, "n_text_layer")):
        current = getattr(dims, attr)
        if target is None or target == current:
            continue
        params = dict(params)
        params[side] = dict(params[side])
        params[side]["blocks"] = _select(params[side]["blocks"], resample_indices(current, target))
        print(f"Resized {side} layers: {current} -> {target}")
        dims = dims.replace(**{attr: target})
        changed = True
    return params, dims, changed


def default_alignment_heads(n_text_layer: int, n_text_head: int) -> np.ndarray:
    """Default word-alignment head mask after a decoder resize: every head of
    the upper half of the decoder (an inference-time artifact, not stored in
    checkpoints)."""
    heads = np.zeros((n_text_layer, n_text_head), dtype=bool)
    heads[n_text_layer // 2:] = True
    return heads


def resolve_model_architecture(model_config: dict) -> dict:
    """Init/base names and layer targets from the ``model`` config section:
    a preset of :data:`MODEL_LAYER_PRESETS`, or ``base_init_name`` and
    ``encoder_layers`` / ``decoder_layers`` (also the singular keys and the
    ``deocer_layer`` misspelling that configs in the wild carry)."""
    init_name = model_config["init_name"]
    preset = MODEL_LAYER_PRESETS.get(init_name)
    if preset is not None:
        base_init_name = preset["base_init_name"]
        encoder_layers = preset["encoder_layers"]
        decoder_layers = preset["decoder_layers"]
    else:
        base_init_name = model_config.get("base_init_name", init_name)
        encoder_layers = model_config.get("encoder_layers", model_config.get("encoder_layer"))
        decoder_layers = model_config.get(
            "decoder_layers", model_config.get("decoder_layer", model_config.get("deocer_layer")))
    return {
        "init_name": init_name,
        "base_init_name": base_init_name,
        "encoder_layers": encoder_layers,
        "decoder_layers": decoder_layers,
    }
