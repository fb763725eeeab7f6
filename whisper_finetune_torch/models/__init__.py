from whisper_finetune_torch.models.dims import (
    MODEL_PRESETS,
    ModelDimensions,
    get_preset_dims,
)
from whisper_finetune_torch.models.whisper import (
    ForwardConfig,
    Whisper,
    decoder_forward,
    encoder_forward,
    forward_impl,
    init_params,
    sinusoids,
)
from whisper_finetune_torch.models.checkpoint import params_from_jax, params_to_numpy

__all__ = [
    "MODEL_PRESETS",
    "ModelDimensions",
    "ForwardConfig",
    "Whisper",
    "get_preset_dims",
    "decoder_forward",
    "encoder_forward",
    "forward_impl",
    "init_params",
    "sinusoids",
    "params_from_jax",
    "params_to_numpy",
]
