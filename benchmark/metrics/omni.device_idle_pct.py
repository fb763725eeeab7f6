"""``omni.device_idle_pct``: the share of the traced speech-LLM calls' wall
time in which no kernel, copy or fill ran on the card (profiler
timeline)."""

LAYER = "device"
UNIT = "%"
MOVES = "decode_tokens_per_s"

from benchmark.metrics._common import idle_pct  # noqa: E402


def read(record):
    return idle_pct(record) if record.get("kind") == "omni_decode" else None
