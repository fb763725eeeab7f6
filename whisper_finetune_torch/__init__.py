"""whisper_finetune_torch: the PyTorch / NVIDIA H100 port of whisper_finetune_tpu.

The JAX package beside it is the reference. This package imports ``torch``
and numpy, never JAX or the JAX package; it keeps its own copies of what it
needs. Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, and raise when a card is asked for and absent. Every TPU
kernel on the ported path is a hand-written CUDA kernel under ``csrc/``,
built at first use (``_build.py``) and held against its plain PyTorch twin.
"""

__version__ = "0.1.0"
