"""``train.mfu``: executed model FLOPs of the traced optimizer steps over
their wall time at the bf16 peak (989 TFLOP/s), in %. Executed FLOPs: three
times the forward of the blocks that ran (the program's ``blocks_run``
counters, so stochastic depth counts), cross K/V over the audio frames, the
causal self-attention at half, no recompute (``yardstick/flops.py``)."""

LAYER = "step: train/step.py"
UNIT = "%"
MOVES = "train_audio_h_per_s"

from benchmark.metrics._common import trace  # noqa: E402
from benchmark.yardstick.flops import train_flops  # noqa: E402
from benchmark.yardstick.roofline import BF16_FLOP_PER_S  # noqa: E402


def read(record):
    tr = trace(record)
    if record.get("kind") != "train" or tr is None:
        return None
    c = record["counters"]
    flops = train_flops(record["dims"], record["rows"], record["steps"] * record["accum"],
                        c["enc_blocks_run"], c["dec_blocks_run"])
    return 100.0 * flops / (tr["window_s"] * BF16_FLOP_PER_S)
