"""``train.update_ms``: device ms an optimizer step between CUDA events the
benchmark records around the optimizer's ``fused_apply`` (the update of
every leaf: Muon with its Newton-Schulz, the auxiliary AdamW, or the 8-bit
AdamW)."""

LAYER = "optimizer: optim/"
UNIT = "ms/step"
MOVES = "train_audio_h_per_s"


def read(record):
    ms = record.get("update_ms") or []
    if record.get("kind") != "train" or not ms:
        return None
    return sum(ms) / len(ms)
