"""``train.device_idle_pct``: the share of the traced optimizer steps' wall
time in which no kernel, copy or fill ran on the card (profiler timeline)."""

LAYER = "device"
UNIT = "%"
MOVES = "train_audio_h_per_s"

from benchmark.metrics._common import idle_pct  # noqa: E402


def read(record):
    return idle_pct(record) if record.get("kind") == "train" else None
