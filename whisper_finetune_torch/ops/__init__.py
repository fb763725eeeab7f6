# ``attention`` (the dispatcher) stays in its module: exporting it here would
# shadow the submodule ``whisper_finetune_torch.ops.attention``.
from whisper_finetune_torch.ops.attention import (
    flash_fwd_xla_bwd,
    flash_mha,
    splash_mha,
    xla_mha,
)
from whisper_finetune_torch.ops.mel import (
    CHUNK_LENGTH,
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
    mel_filterbank,
)
from whisper_finetune_torch.ops.spec_augment import (
    FeaturizeConfig,
    crop_and_min_pad,
    extremes_freq_mask,
    featurize_impl,
    time_and_freq_mask,
    time_warp,
)

__all__ = [
    "CHUNK_LENGTH",
    "FRAMES_PER_SECOND",
    "FeaturizeConfig",
    "HOP_LENGTH",
    "N_FFT",
    "N_FRAMES",
    "N_SAMPLES",
    "SAMPLE_RATE",
    "crop_and_min_pad",
    "extremes_freq_mask",
    "featurize_impl",
    "flash_fwd_xla_bwd",
    "flash_mha",
    "log_mel_spectrogram",
    "mel_filterbank",
    "splash_mha",
    "time_and_freq_mask",
    "time_warp",
    "xla_mha",
]
