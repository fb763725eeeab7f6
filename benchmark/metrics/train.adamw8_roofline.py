"""``train.adamw8_roofline``: the least time of the 8-bit AdamW update (the
bytes of ``yardstick/roofline.py::adamw8_bytes`` over the leaves the kernel
serves: 4096 elements or more, a multiple of 256; at 3.35 TB/s) over the
device time of the ``fused_adamw8`` kernels, in %."""

LAYER = "fused AdamW8 kernel: ops/fused_adamw8.py -> csrc/fused_adamw8.cu"
UNIT = "%"
MOVES = "train_audio_h_per_s"

from benchmark.metrics._common import kernel_s, trace  # noqa: E402
from benchmark.yardstick.roofline import HBM_BYTES_PER_S, adamw8_bytes  # noqa: E402


def read(record):
    tr = trace(record)
    kern = kernel_s(record, "fused_adamw8")
    if record.get("kind") != "train" or tr is None or kern <= 0:
        return None
    if record["counters"].get("fused_adamw8", 0) <= 0:
        return None
    n_bytes = record["steps"] * adamw8_bytes(record["adamw8_elements"], record["grad_bytes"])
    return 100.0 * n_bytes / HBM_BYTES_PER_S / kern
