"""``omni.token_step_roofline``: the speech LLM's token steps' least time
(``yardstick/omni.py::token_steps_bound_s``: every step reads the
attention's, fixed experts', router's and head's weights, every dynamic
expert's and the K/V window; bound by those bytes at 3.35 TB/s) over the
device time that ``wft.decode.token_step`` owns in the traced calls (the
graph replays and the eager work around them), in %."""

LAYER = "decode: models/decoding.py"
UNIT = "%"
MOVES = "decode_tokens_per_s"

from benchmark.metrics._common import trace  # noqa: E402
from benchmark.yardstick.omni import dynamic, token_steps_bound_s  # noqa: E402


def read(record):
    tr = trace(record)
    if record.get("kind") != "omni_decode" or tr is None or "spans" not in tr:
        return None
    step_s = sum(tr["spans"]["span_device_s"].get("wft.decode.token_step", {}).values())
    if step_s <= 0:
        return None
    dims, c = record["dims"], record["counters"]
    routes = dynamic(c["routes"], dims) - dynamic(c["prefill_routes"], dims)
    least = token_steps_bound_s(dims, record["rows"], record["prompt_len"], record["new_tokens"],
                                record["calls"], routes)
    return 100.0 * least / step_s
