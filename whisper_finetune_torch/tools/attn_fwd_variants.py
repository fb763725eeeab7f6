"""What holds ``attn_fwd``: times the forward as built and deliberately wrong
variants of it, on one CUDA card.

    python -m whisper_finetune_torch.tools.attn_fwd_variants

The variants are edits of a copy of ``csrc/attention.cu``, made and built as
in :mod:`whisper_finetune_torch.tools.attn_bwd_variants` (each edit must find
its statement exactly once; a CPU test holds them against the source):

* ``no_exp``: the probabilities are exp2's arguments, with no exp2 (the
  output is wrong): what the special-function unit costs on top of the rest.
* ``no_pv``: no O += PV product (O comes out zero): what the second product
  costs on top of the rest.
* ``no_kv_loads``: only the first K and V tile is loaded; the products read
  it again at every tile (wrong output): what bringing K and V from L2 costs.

Timed at the main path's three attention shapes (batch 8, 20 heads), the
instance that writes the log-sum-exp, CUDA events around 10 calls, median of
3, each variant twice in turns. Prints one JSON line with the card's name
and power limit.
"""

from __future__ import annotations

import ctypes
import json
import sys
import tempfile
from pathlib import Path

from whisper_finetune_torch.tools.attn_bwd_variants import SHAPES, build, smi_line, time_ms

EXP = ("const float p0 = fast_exp2(fmaf(s[nt][2 * r], sl2, -m_use));",
       "const float p1 = fast_exp2(fmaf(s[nt][2 * r + 1], sl2, -m_use));")
PV = "wgmma_rs_n64<1>(acc, pa[kk], dV + kk * WG_MN_STEP);"
LOADS = "if (tid == 0) load_kv(j + FWD_STAGES - 1);"
LANDED = "mbar_wait(slot_bar(j), (j / FWD_STAGES) & 1);  // tile j has landed"
VARIANTS = {
    "as_built": [],
    "no_exp": [(e, e.replace("fast_exp2(", "(")) for e in EXP],
    "no_pv": [(PV, ";")],
    "no_kv_loads": [(LOADS, ""), (LANDED, "if (j == 0) mbar_wait(slot_bar(j), 0);")],
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attn_fwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    smi = smi_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def heads(B, T, H):  # the model's layout
        return torch.randn((B, T, H, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)

    result = {"card": smi, "ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), VARIANTS)
        for site, (B, H, Tq, Tk, causal) in SHAPES.items():
            q, k, v = heads(B, Tq, H), heads(B, Tk, H), heads(B, Tk, H)
            o = torch.empty_like(q)
            lse = torch.empty((B, H, Tq), device="cuda")
            stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
            times = {name: [] for name in libs}
            for _ in range(2):
                for name, lib in libs.items():
                    def run(lib=lib, name=name):
                        rc = lib.wft_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                              lse.data_ptr(), B, H, Tq, Tk, *q.stride()[:3],
                                              *k.stride()[:3], 0.125, causal, stream)
                        if rc != 0:
                            raise RuntimeError(f"wft_attn_fwd ({name}): CUDA error {rc}")

                    times[name].append(time_ms(run))
            result["ms"][site] = times
            print(f"{site} {B}x{H}x{Tq}x{Tk} causal={causal}: "
                  + ", ".join(f"{n} {t[0]:.3f}/{t[1]:.3f} ms" for n, t in times.items()), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
