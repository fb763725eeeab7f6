"""``decode.mfu``: the least time the chip needs for the traced decode
calls, over their wall time, in %: each call's encoder pass with the cross
K/V of every layer, and every cached token step, each the larger of its
FLOPs at 989 TFLOP/s and its bytes at 3.35 TB/s (``yardstick/roofline.py``)."""

LAYER = "decode: models/decoding.py"
UNIT = "%"
MOVES = "decode_tokens_per_s"

from benchmark.metrics._common import trace  # noqa: E402
from benchmark.yardstick.roofline import decode_token_bound_s, encode_bound_s  # noqa: E402


def read(record):
    tr = trace(record)
    if record.get("kind") != "decode" or tr is None:
        return None
    dims, rows = record["dims"], record["rows"]
    least = (record["calls"] * encode_bound_s(dims, rows)
             + record["token_steps"] * decode_token_bound_s(dims, rows, record["max_len"]))
    return 100.0 * least / tr["window_s"]
