"""Model dimension records and the official Whisper size presets.

The port's own copy of ``whisper_finetune_tpu/models/dims.py`` (the port
imports nothing of the JAX package). Mirrors the ``dims`` dict stored in
OpenAI checkpoints; the preset table builds any official architecture by
name without network access.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "ModelDimensions":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in fields})

    def replace(self, **kwargs) -> "ModelDimensions":
        return dataclasses.replace(self, **kwargs)


def _dims(n_mels, d_audio, h_audio, l_audio, d_text, h_text, l_text,
          n_vocab=51865) -> ModelDimensions:
    return ModelDimensions(
        n_mels=n_mels,
        n_audio_ctx=1500,
        n_audio_state=d_audio,
        n_audio_head=h_audio,
        n_audio_layer=l_audio,
        n_vocab=n_vocab,
        n_text_ctx=448,
        n_text_state=d_text,
        n_text_head=h_text,
        n_text_layer=l_text,
    )


# Official architecture table (multilingual vocab 51865; large-v3 family
# 51866 with 128 mel bins).
MODEL_PRESETS: Dict[str, ModelDimensions] = {
    "tiny": _dims(80, 384, 6, 4, 384, 6, 4),
    "base": _dims(80, 512, 8, 6, 512, 8, 6),
    "small": _dims(80, 768, 12, 12, 768, 12, 12),
    "medium": _dims(80, 1024, 16, 24, 1024, 16, 24),
    "large": _dims(80, 1280, 20, 32, 1280, 20, 32),
    "large-v1": _dims(80, 1280, 20, 32, 1280, 20, 32),
    "large-v2": _dims(80, 1280, 20, 32, 1280, 20, 32),
    "large-v3": _dims(128, 1280, 20, 32, 1280, 20, 32, n_vocab=51866),
    "large-v3-turbo": _dims(128, 1280, 20, 32, 1280, 20, 4, n_vocab=51866),
    "turbo": _dims(128, 1280, 20, 32, 1280, 20, 4, n_vocab=51866),
}


def get_preset_dims(name: str) -> Optional[ModelDimensions]:
    return MODEL_PRESETS.get(name)
