"""Readings that set the speech-LLM cell's correctness limits, on the card at
the cell's own size (the benchmark's own runs never run this;
``benchmark/control.py`` knows the ``train`` and ``decode`` kinds).

    python3 -m benchmark.control_omni --workload uni-moe-2.0-omni.greedy-b32 \\
        --seeds 11,12,13 [--faults] [--out f.json]

For each seed the program is built once and stays on the card; each reading
serves one call of the cell's rows and runs the cell's check on it (the
float32 reference teacher-forced over ``check_rows`` served rows):

* ``program``: the sound program, with the fp8 control's readings
  (``control_*``: the reference with e4m3 operands in every product);
* with ``--faults``, the program with one fault planted at a time (its
  graph captured anew): ``renormalised`` routing weights; ``no_fixed``
  experts; ``top1`` in place of top-p; ``null_real`` (the null expert's
  share routed to expert 0); ``rope_1e4`` (RoPE theta 1e4); ``kv_group``
  (each query group reading the next K/V head).

One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import spec


@contextlib.contextmanager
def planted(name: str, prog):
    """The program with fault ``name`` planted for the block."""
    from whisper_finetune_torch.models import decoding, omni

    real = {k: getattr(omni, k) for k in ("route", "fixed_experts", "gqa_attention")}
    dims = prog.dims_obj
    if name == "renormalised":
        def route(z, top_p, top_k):
            p, sel = real["route"](z, top_p, top_k)
            return p / (p * sel).sum(-1, keepdim=True), sel
        omni.route = route
    elif name == "no_fixed":
        omni.fixed_experts = lambda x, p: torch.zeros(x.shape, dtype=torch.float32,
                                                      device=x.device)
    elif name == "top1":
        prog.dims_obj = dims.replace(top_k=1)
    elif name == "null_real":
        def route(z, top_p, top_k):
            p, sel = real["route"](z, top_p, top_k)
            null = sel[:, -1]
            p = p.clone()
            p[:, 0] = torch.where(null, p[:, 0] * sel[:, 0] + p[:, -1], p[:, 0])
            sel = sel.clone()
            sel[:, 0] |= null
            return p, sel
        omni.route = route
    elif name == "rope_1e4":
        prog.dims_obj = dims.replace(rope_theta=1e4)
    elif name == "kv_group":
        omni.gqa_attention = lambda q, k, v, mask: real["gqa_attention"](
            q, k.roll(1, 1), v.roll(1, 1), mask)
    elif name != "program":
        raise ValueError(f"no fault {name!r}")
    decoding.release()  # a graph captured before holds the sound code
    try:
        yield
    finally:
        for k, v in real.items():
            setattr(omni, k, v)
        prog.dims_obj = dims
        decoding.release()


FAULTS = ("renormalised", "no_fixed", "top1", "null_real", "rope_1e4", "kv_group")


def reading(prog, cell, name: str, control: bool = False) -> dict:
    from benchmark.kinds import omni_decode as K
    from benchmark.kinds.decode import GreedyRecorder
    from whisper_finetune_torch.models import omni

    recorder = GreedyRecorder()
    omni.moe.record = records = []
    try:
        with planted(name, prog), recorder:
            prog.call(1)
    finally:
        omni.moe.record = None
    served, mean_lp = prog.served(recorder)
    r = K.check(prog, served, mean_lp, records, [prog.call_rows(1)], cell, control)
    keep = ("logit_gap", "logprob_gap", "route_flips", "near_ties", "route_diff_margin",
            "route_diffs_above", "control_logit_gap", "control_logprob_gap",
            "control_route_flips")
    return {k: r[k] for k in keep if k in r}


def main(argv=None) -> int:
    from benchmark.kinds import omni_decode as K

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        prog = K.OmniProgram(cell, seed, "cuda")
        line = {"workload": args.workload, "seed": seed,
                "program": reading(prog, cell, "program", control=True)}
        for name in FAULTS if args.faults else ():
            line[name] = reading(prog, cell, name)
        prog.release()
        line["seconds"] = time.monotonic() - t0
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
