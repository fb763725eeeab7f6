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
from whisper_finetune_torch.models.decoding import (
    DecodeFilters,
    beam_decode,
    default_filters,
    greedy_decode,
    transcribe_batch,
)
from whisper_finetune_torch.models.checkpoint import (
    fetch_checkpoint,
    load_checkpoint,
    load_model,
    params_from_jax,
    params_to_numpy,
    params_to_state_dict,
    save_checkpoint,
    state_dict_to_params,
)
from whisper_finetune_torch.models.lora import (
    apply_lora,
    has_lora,
    lora_scale,
    merge_lora,
    remove_lora,
)
from whisper_finetune_torch.models.surgery import (
    MODEL_LAYER_PRESETS,
    resize_whisper_layers,
    resolve_model_architecture,
)

__all__ = [
    "MODEL_LAYER_PRESETS",
    "MODEL_PRESETS",
    "ModelDimensions",
    "DecodeFilters",
    "ForwardConfig",
    "Whisper",
    "apply_lora",
    "beam_decode",
    "default_filters",
    "get_preset_dims",
    "decoder_forward",
    "encoder_forward",
    "fetch_checkpoint",
    "forward_impl",
    "greedy_decode",
    "has_lora",
    "init_params",
    "load_checkpoint",
    "load_model",
    "lora_scale",
    "merge_lora",
    "params_from_jax",
    "params_to_numpy",
    "params_to_state_dict",
    "remove_lora",
    "resize_whisper_layers",
    "resolve_model_architecture",
    "save_checkpoint",
    "sinusoids",
    "state_dict_to_params",
    "transcribe_batch",
]
