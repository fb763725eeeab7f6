from whisper_finetune_torch.train.step import (
    TrainState,
    build_trainable_mask,
    cross_entropy_loss,
    grad_histograms,
    make_train_step,
    mark_trainable,
    trainable_leaves,
)

__all__ = [
    "TrainState",
    "build_trainable_mask",
    "cross_entropy_loss",
    "grad_histograms",
    "make_train_step",
    "mark_trainable",
    "trainable_leaves",
]
