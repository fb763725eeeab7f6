"""``ddp.nccl_ms``: device milliseconds a traced optimizer step in NCCL's
kernels (the gradient reduction and Muon's gathers across the cards), on
rank 0's card (profiler kernels)."""

LAYER = "data parallelism: parallel/"
UNIT = "ms/step"
MOVES = "train_audio_h_per_s"

from benchmark.metrics._common import kernel_s, trace  # noqa: E402


def read(record):
    if record.get("kind") != "train" or trace(record) is None or record.get("world", 1) < 2:
        return None
    return 1e3 * kernel_s(record, "nccl") / record["steps"]
