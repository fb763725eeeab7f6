"""What the dQ reductions cost ``attn_bwd``: times the backward as built, and
two deliberately wrong variants of it, on one CUDA card.

    python -m whisper_finetune_torch.tools.attn_bwd_variants

The variants are made by editing a copy of ``csrc/attention.cu`` in a
temporary directory (each edit must find its statement exactly once, or the
script fails; a CPU test holds the edits against the source):

* ``no_reduce``: the fused kernel never adds its dQ tiles to the accumulator
  in device memory (dq comes out zero). The difference to ``as_built`` is
  what the reductions cost on top of the products.
* ``half_reduce``: every reduction adds half of its tile (dq comes out
  wrong). Says whether that cost follows the bytes or the count of
  reductions.

Timed at the main path's three attention shapes (batch 8, 20 heads): all
three launches of ``wft_attn_bwd`` together, CUDA events around 10 calls,
median of 3, each variant twice in turns. Prints one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

# Each edit replaces one statement of ``csrc/attention.cu``, given without its
# indentation or comment; ``variant_sources`` fails unless it occurs once.
REDUCE_CALL = "if (it > 0 && tid == 0) reduce_dq(it - 1);"
REDUCE_SIZE = "min(BWD_BM, d.Tq - q0) * D * 4);"
VARIANTS = {
    "as_built": [],
    "no_reduce": [(REDUCE_CALL, "")],
    "half_reduce": [(REDUCE_SIZE, "min(BWD_BM, d.Tq - q0) * D * 2);")],
}
SHAPES = {"encoder": (8, 20, 1500, 1500, 0), "cross": (8, 20, 448, 1500, 0),
          "decoder_self": (8, 20, 448, 448, 1)}


def variant_sources(source: str, variants: dict = VARIANTS) -> dict:
    """The text of ``csrc/attention.cu`` under each variant's edits."""
    texts = {}
    for name, edits in variants.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} occurs {text.count(old)} times "
                                   "in attention.cu, not once")
            text = text.replace(old, new)
        texts[name] = text
    return texts


def build(tmp: Path, variants: dict = VARIANTS) -> dict:
    """Each variant of ``csrc/attention.cu`` compiled (all ``nvcc`` runs
    started together) and loaded, by name."""
    from whisper_finetune_torch import _build
    from whisper_finetune_torch.ops.attention import bind

    procs = {}
    for name, text in variant_sources((_build.CSRC / "attention.cu").read_text(),
                                      variants).items():
        src, out = tmp / f"{name}.cu", tmp / f"{name}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen(_build.nvcc_command(src, out), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{text}")
        libs[name] = bind(ctypes.CDLL(str(out)))
    return libs


def time_ms(run) -> float:
    """CUDA events around 10 calls of ``run``, median of 3, after one
    warm-up call."""
    import torch

    run()
    torch.cuda.synchronize()
    reps = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            run()
        end.record()
        torch.cuda.synchronize()
        reps.append(start.elapsed_time(end) / 10)
    return statistics.median(reps)


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attn_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from whisper_finetune_torch.ops import attention as A

    smi = smi_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def heads(B, T, H):  # the model's layout
        return torch.randn((B, T, H, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)

    result = {"card": smi, "ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for site, (B, H, Tq, Tk, causal) in SHAPES.items():
            q, k, v, do = heads(B, Tq, H), heads(B, Tk, H), heads(B, Tk, H), heads(B, Tq, H)
            o, lse = A.attn_fwd(q, k, v, bool(causal), 0.125)
            stats = torch.empty((2, B, H, Tq), device="cuda")
            acc = torch.empty((B, H, Tq, 64), device="cuda")
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(k)
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            times = {name: [] for name in libs}
            for _ in range(2):
                for name, lib in libs.items():
                    def run(lib=lib):
                        rc = lib.wft_attn_bwd(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                            lse.data_ptr(), stats.data_ptr(), acc.data_ptr(), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), B, H, Tq, Tk, *q.stride()[:3],
                            *k.stride()[:3], 0.125, causal, stream)
                        if rc != 0:
                            raise RuntimeError(f"wft_attn_bwd ({name}): CUDA error {rc}")

                    times[name].append(time_ms(run))
            result["ms"][site] = times
            print(f"{site} {B}x{H}x{Tq}x{Tk} causal={causal}: "
                  + ", ".join(f"{n} {t[0]:.3f}/{t[1]:.3f} ms" for n, t in times.items()), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
