"""``omni.mfu``: the least time the chip needs for the traced speech-LLM
calls, over their wall time, in %: each call's tower pass, pool and
projector, its prefill (the dynamic experts by the routes counted), and its
token steps (every dynamic expert's weights read), each the larger of its
FLOPs at 989 TFLOP/s and its bytes at 3.35 TB/s (``yardstick/omni.py``).
The share of the whole call."""

LAYER = "speech LLM: models/omni.py"
UNIT = "%"
MOVES = "decode_tokens_per_s"

from benchmark.metrics._common import trace  # noqa: E402
from benchmark.yardstick.omni import call_bound_s  # noqa: E402


def read(record):
    tr = trace(record)
    if record.get("kind") != "omni_decode" or tr is None:
        return None
    return 100.0 * call_bound_s(record) / tr["window_s"]
