"""Readings that set a cell's correctness limits, on the card at the cell's
own size (the benchmark's own runs never run this).

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--out f.json]

For each seed, next to the sound program's reading against the float32
reference:

* ``train`` cells: the control (the reference with fp8 operands in every
  product, the step below the recipe's bf16) against the float32 reference,
  and the program with half of every microbatch's rows left out (its mean
  taken over the rest). A step that returns its state unchanged reads 1 on
  ``grad_gap`` and ``change_gap`` by their definition and needs no run.
* ``decode`` cells, over a short window of two or three calls: the fp8
  control's readings on the sampled rows (the gap, under the float32
  reference, of the token it puts first at every served position, and its
  mean log-probability of the served tokens against the reference's), and
  the program's with one token of every row altered where it produces it.

One JSON line a seed and reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import spec


def half_batch(step, tx):
    """The step fed the first half of each microbatch's rows."""

    def run(state, batch, generator=None, draws=None):
        rows = batch["audio"].shape[1]
        return step(state, {k: v[:, : rows // 2] for k, v in batch.items()}, generator, draws)

    return run


def train_readings(cell, seed: int, device="cuda", dims_override=None) -> dict:
    from benchmark.kinds import train as T
    from whisper_finetune_torch.models.dims import MODEL_PRESETS

    dims_obj = MODEL_PRESETS[cell["config_spec"]["preset"]]
    if dims_override:
        dims_obj = dims_obj.replace(**dims_override)
    dims = dims_obj.to_dict()
    recipe = T.load_recipe(cell)
    horizon = int(cell["traffic_spec"]["schedule_steps"])
    feed = T.Feed(cell["traffic_spec"], recipe, dims, seed, device)
    out = {}
    gen_states = None
    for name, wrap in (("program", None), ("half_batch", half_batch)):
        res = T.program_first_steps(recipe, dims_obj, seed, device, feed, horizon, wrap)
        out[name] = res[4]
        gen_states = gen_states or res[6]
        del res
        T._free()
    ref = T.reference_readings(cell, recipe, dims, seed, device, feed, gen_states)
    T._free()
    out["control"] = T.reference_readings(cell, recipe, dims, seed, device, feed, gen_states,
                                          precision="fp8")
    T._free()
    return {name: T.compare(r, ref) for name, r in out.items()}


def altered_token(decoding):
    """``greedy_decode`` with the fifth generated token of every row moved
    to the next id."""
    real = decoding.greedy_decode

    def run(*args, **kwargs):
        tokens, lp = real(*args, **kwargs)
        tokens = tokens.clone()
        eot = args[3]
        tokens[:, 4] = torch.where(tokens[:, 4] == eot, tokens[:, 4], (tokens[:, 4] + 1) % eot)
        return tokens, lp

    return run


def decode_readings(cell, seed: int, device="cuda", dims_override=None,
                    seconds: float = 12.0) -> dict:
    from benchmark.kinds import decode as D
    from whisper_finetune_torch.models import decoding

    t = time.monotonic()
    sound = D.run(cell, seed, seconds, False, t, device, dims_override, control=True)
    real = decoding.greedy_decode
    decoding.greedy_decode = altered_token(decoding)
    try:
        fault = D.run(cell, seed, seconds, False, time.monotonic(), device, dims_override)
    finally:
        decoding.greedy_decode = real
    r, f = sound["readings"], fault["readings"]
    return {"program": {"logit_gap": r["logit_gap"], "logprob_gap": r["logprob_gap"]},
            "control": {"logit_gap": r["control_logit_gap"],
                        "logprob_gap": r["control_logprob_gap"]},
            "altered_token": {"logit_gap": f["logit_gap"], "logprob_gap": f["logprob_gap"]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    kind = cell["traffic_spec"]["kind"]
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        r = (train_readings if kind == "train" else decode_readings)(cell, seed)
        line = {"workload": args.workload, "seed": seed, "seconds": time.monotonic() - t0, **r}
        rows.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
