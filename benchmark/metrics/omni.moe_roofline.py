"""``omni.moe_roofline``: the MoE layers' least time over their device time
in the traced calls, in %: the prefills' and the token steps' together.
The bound of a pass is the larger of its FLOPs at 989 TFLOP/s and its bytes
(the router's, fixed and every dynamic expert's weights and the
activations) at 3.35 TB/s (``yardstick/omni.py::moe_work``, by the routes
counted). The prefills' device time is what ``wft.moe`` (with
``wft.moe.route`` inside it) owns in the traced calls. The token steps'
MoE runs inside their CUDA graph, whose kernels ``wft.decode.token_step``
owns, so the kind also runs the same step eagerly a few times under the
profiler after the window (``moe_step``): what ``wft.moe`` owns there, a
step, stands for each of the calls' token steps."""

LAYER = "speech LLM MoE: models/omni.py::moe"
UNIT = "%"
MOVES = "decode_tokens_per_s"

from benchmark.metrics._common import trace  # noqa: E402
from benchmark.yardstick.omni import dynamic, moe_work  # noqa: E402
from benchmark.yardstick.roofline import bound_s  # noqa: E402

MOE_SPANS = ("wft.moe", "wft.moe.route")


def moe_s(span_device_s) -> float:
    return sum(sum(span_device_s.get(name, {}).values()) for name in MOE_SPANS)


def read(record):
    tr = trace(record)
    step = record.get("moe_step")
    if record.get("kind") != "omni_decode" or tr is None or "spans" not in tr or not step:
        return None
    prefill_s = moe_s(tr["spans"]["span_device_s"])
    step_s = moe_s(step["span_device_s"]) / step["steps"]
    if prefill_s <= 0 or step_s <= 0:
        return None
    dims, c, calls = record["dims"], record["counters"], record["calls"]
    rows, steps = record["rows"], calls * record["new_tokens"]
    pre = dynamic(c["prefill_routes"], dims)
    prefill = bound_s(*moe_work(dims, rows * record["prompt_len"], pre // calls))[0]
    token = bound_s(*moe_work(dims, rows, (dynamic(c["routes"], dims) - pre) // steps))[0]
    return 100.0 * (calls * prefill + steps * token) / (prefill_s + steps * step_s)
