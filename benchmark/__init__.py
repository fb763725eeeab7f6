"""The benchmark of the PyTorch and CUDA port (``whisper_finetune_torch``); see README.md."""
