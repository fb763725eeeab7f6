from whisper_finetune_torch.optim.muon import (
    Muon,
    muon_shape_scale,
    newton_schulz_orthogonalize,
    rms_match_scale,
    scale_by_muon,
)
from whisper_finetune_torch.optim.optimizers import (
    Adam,
    MuonWithAuxAdam,
    get_optimizer,
    muon_param_labels,
)
from whisper_finetune_torch.optim.quantized import AdamW8bit, adam_8bit, adamw_8bit
from whisper_finetune_torch.optim.schedulers import get_schedule

__all__ = [
    "Adam",
    "AdamW8bit",
    "Muon",
    "MuonWithAuxAdam",
    "adam_8bit",
    "adamw_8bit",
    "get_optimizer",
    "get_schedule",
    "muon_param_labels",
    "muon_shape_scale",
    "newton_schulz_orthogonalize",
    "rms_match_scale",
    "scale_by_muon",
]
