from whisper_finetune_torch.train.step import (
    TrainState,
    cross_entropy_loss,
    make_train_step,
)

__all__ = [
    "TrainState",
    "cross_entropy_loss",
    "make_train_step",
]
