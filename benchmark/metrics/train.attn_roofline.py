"""``train.attn_roofline``: the least time of the attention work that the
cell's forward sends to the port's kernels, over the device time of the
``attn_`` kernels, in %. The work is read from the launch counters
(``attn_fwd``, ``attn_bwd``) split over the two kernel sites of
``attn_impl: auto`` (encoder self-attention 1500 x 1500, decoder
cross-attention 448 x 1500) in the ratio of the blocks run; each launch's
bound is ``yardstick/roofline.py``'s at the cell's microbatch."""

LAYER = "attention: ops/attention.py -> csrc/attention.cu"
UNIT = "%"
MOVES = "train_audio_h_per_s"

from benchmark.metrics._common import kernel_s, trace  # noqa: E402
from benchmark.yardstick.roofline import attention_sites  # noqa: E402


def read(record):
    tr = trace(record)
    if record.get("kind") != "train" or tr is None:
        return None
    c = record["counters"]
    kern = kernel_s(record, "attn_")
    blocks = c["enc_blocks_run"] + c["dec_blocks_run"]
    if kern <= 0 or blocks <= 0:
        return None
    sites = attention_sites(record["dims"], record["rows"])
    share = {"encoder": c["enc_blocks_run"] / blocks, "cross": c["dec_blocks_run"] / blocks}
    fwd = sum(share[s] * sites[s][0] for s in sites)
    bwd = sum(share[s] * sites[s][1] for s in sites)
    return 100.0 * (c["attn_fwd"] * fwd + c["attn_bwd"] * bwd) / kern
