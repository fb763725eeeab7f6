"""Kernel groups of a device trace, by name.

The groups of the port's first profile of the training step: its own
attention kernels (``attn_``), its fused 8-bit AdamW (``fused_adamw8``), the
library's matrix products (cuBLAS / CUTLASS kernel families), convolutions
(cuDNN), and everything else, which in an eager PyTorch step is the
elementwise tails, copies, casts, norms and reductions.
"""

from __future__ import annotations

GROUPS = (
    ("attention", ("attn_",)),
    ("fused_adamw8", ("fused_adamw8",)),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "nvjet", "cublas")),
    ("convolution", ("conv", "cudnn", "implicit")),
)
OTHER = "other"


def group_of(kernel_name: str) -> str:
    """The group a device kernel's name falls in (the first that matches)."""
    name = kernel_name.lower()
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return OTHER
