"""``train.elementwise_ms``: device ms an optimizer step in kernels that the
grouping (``yardstick/grouping.py``) classes as none of matmul, attention,
the fused 8-bit AdamW or convolution: the elementwise tails, copies, casts,
norms and reductions of the model, the features and the loss."""

LAYER = "model: models/whisper.py, ops/mel.py, ops/spec_augment.py"
UNIT = "ms/step"
MOVES = "train_audio_h_per_s"

from benchmark.metrics._common import trace  # noqa: E402
from benchmark.yardstick.grouping import OTHER  # noqa: E402


def read(record):
    tr = trace(record)
    if record.get("kind") != "train" or tr is None or record["steps"] <= 0:
        return None
    return 1e3 * tr["group_s"].get(OTHER, 0.0) / record["steps"]
