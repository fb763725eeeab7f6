from whisper_finetune_torch.data.dataset import (
    MODEL_N_TEXT_CTX,
    SampleBuilder,
    SampleDataset,
    collate,
)
from whisper_finetune_torch.data.hf_utils import (
    load_hf_dataset,
    normalize_language,
    process_dataset,
)
from whisper_finetune_torch.data.inverse_mel import inverse_mel_to_audio
from whisper_finetune_torch.data.loader import (
    BatchLoader,
    infinite_batches,
    stack_microbatches,
    to_device,
)
from whisper_finetune_torch.data.sampler import (
    SequentialSampler,
    ShardedSampler,
    WarmupDatasetSampler,
    get_dataset_boundary_indices,
)

__all__ = [
    "MODEL_N_TEXT_CTX",
    "BatchLoader",
    "SampleBuilder",
    "SampleDataset",
    "SequentialSampler",
    "ShardedSampler",
    "WarmupDatasetSampler",
    "collate",
    "get_dataset_boundary_indices",
    "infinite_batches",
    "inverse_mel_to_audio",
    "load_hf_dataset",
    "normalize_language",
    "process_dataset",
    "stack_microbatches",
    "to_device",
]
