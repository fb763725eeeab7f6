"""Step time, peak memory and first-step gradients of the first slice under
each remat policy, in turns, on one CUDA card.

    python -m whisper_finetune_torch.tools.remat_policies [--rounds 3] [--steps 4]

The first slice is :mod:`whisper_finetune_torch.tools.first_slice`'s
(large-v3 from seed 0, batch 8 of synthetic 30 s audio, splash attention,
8-bit AdamW). Each round builds every policy's model afresh and runs 1
warm-up and ``--steps`` timed steps (host clock around a synchronised step);
odd rounds take the policies in reverse order, so that no policy always runs
first. Prints, per policy, every timed step, the median and quartiles, the
peak after the warm-up, the bytes staged to the host a step, and the largest
relative difference of its first step's per-layer gradient norms from the
first round's ``full`` (``full`` against itself in later rounds: the spread
that dQ's summation order leaves); then one JSON line with all of it and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

POLICIES = ("full", "dots", "attn", "save:enc_mlp_h", "offload:enc_mlp_h")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--steps", type=int, default=4)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("remat_policies: needs a CUDA card", file=sys.stderr)
        return 2
    from whisper_finetune_torch.models import get_preset_dims
    from whisper_finetune_torch.ops.remat import offload_to_host
    from whisper_finetune_torch.tools import first_slice as fs

    dims = get_preset_dims("large-v3")
    batch = fs.synthetic_batch(dims)
    rec = {p: {"step_ms": [], "peak_bytes": [], "offloaded_bytes_per_step": [],
               "grad_norm_rel_diff": []} for p in POLICIES}
    ref = None
    for r in range(args.rounds):
        for policy in (POLICIES if r % 2 == 0 else POLICIES[::-1]):
            state, step, tx, _ = fs.build(dims, policy)
            norms = fs.record_grad_norms(tx, [path for path, _ in state.model.leaves()])
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            offload_to_host.bytes = 0
            state, out = fs.run_steps(f"round {r} {policy}", step, state, batch, gen, 1,
                                      args.steps)
            if ref is None and policy == "full":
                ref = norms[0]
            else:
                rec[policy]["grad_norm_rel_diff"].append(fs.norms_rel_diff(norms[0], ref))
            rec[policy]["step_ms"] += [t * 1e3 for t in out["step_s_all"]]
            rec[policy]["peak_bytes"].append(out["peak_mem_bytes"])
            rec[policy]["offloaded_bytes_per_step"].append(
                offload_to_host.bytes / (args.steps + 1))
            del state, step, tx
            torch.cuda.empty_cache()
    for policy, r in rec.items():
        q1, med, q3 = statistics.quantiles(r["step_ms"], n=4)
        r.update(median_ms=med, q1_ms=q1, q3_ms=q3)
        print(f"{policy}: median {med:.1f} ms (quartiles {q1:.1f}-{q3:.1f}, "
              f"{len(r['step_ms'])} steps), peak {max(r['peak_bytes']) / 2**30:.2f} GiB, "
              f"staged {max(r['offloaded_bytes_per_step']) / 1e9:.3f} GB a step, first-step "
              f"gradient norms vs full {', '.join(f'{d:.3e}' for d in r['grad_norm_rel_diff'])}"
              "; steps " + ", ".join(f"{t:.1f}" for t in r["step_ms"]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"card": card, "rounds": args.rounds, "steps": args.steps,
                      "policies": rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
