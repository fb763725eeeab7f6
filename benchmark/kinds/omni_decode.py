"""The ``omni_decode`` kind: Uni-MoE-2.0-Omni's speech-to-text path through
the program's ``transcribe_batch`` on the card, closed loop: the next call
starts when the previous one returns.

Set-up draws the seed's weights on the card a unit at a time, each rounded
to bf16 before the next is drawn (``benchmark/omni_weights.py``), makes
``distinct_rows`` 30 s clips of N(0, ``audio_std``^2) noise from the seed,
cycled ``rows`` a call in a seeded order, and the prompt (``prompt_ids``
ids before the audio rows and as many after, drawn from the seed below the
end-of-text id), and runs one call, which warms up every shape the window
uses (the token step's capture included).

Served tokens are read where the program produces them: what its
``greedy_decode`` returns to ``transcribe_batch`` (the ids and each row's
mean log-probability of them). A row's served tokens run up to and including
its end-of-text, or all ``new_tokens``. The routes are read from the MoE
layer's counters and, for the check, from its record of every call's
selections (``omni.moe.record``).

The check (``benchmark/reference/omni.py``): ``check_rows`` served rows
(the longest and others drawn from the seed) teacher-forced through the
float32 reference, which takes the program's selection at near ties within
the cell's ``delta`` and counts the rest of the differing (layer, position)
pairs as route flips. ``logit_gap`` is read and reported but is no limit
of the cell: random weights make the served tokens the reference's first
choice by a wide margin, so faults and the fp8 control read 0 on some seeds
(PERF.md).

With ``--trace 1`` the token step also runs eagerly a few times under the
profiler after the window (:func:`moe_step_reading`), since inside the calls
its MoE kernels belong to the graph replay's span.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from benchmark import spans
from benchmark.kinds.decode import GreedyRecorder
from benchmark.omni_weights import ReferenceLeaves, lm_specs, program_weights
from benchmark.reference.omni import read_rows
from benchmark.reference.whisper import no_tf32
from benchmark.trace import Profiled, reduce
from benchmark.weights import leaf_specs

GIB = float(1 << 30)
N_SAMPLES = 480000


class OwnedProfile(Profiled):
    """:class:`Profiled` whose result also holds each device operation's
    owning span (``benchmark/spans.py::own``) under ``spans``."""

    def __exit__(self, *exc):
        if self.prof is not None:
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.result = reduce(self.prof)
                own = spans.own(self.prof)
                self.result["spans"] = {k: own[k] for k in ("span_device_s", "span_kernels",
                                                            "span_idle_s", "owned_share")}
            self.prof = None
        return False


def omni_dims(cell: Mapping, dims_override: Optional[Mapping] = None):
    """The program's dimensions of the cell, with ``dims_override`` (a
    ``tower`` entry replaces tower fields)."""
    from whisper_finetune_torch.models.omni import OMNI_PRESETS

    dims = OMNI_PRESETS[cell["config_spec"]["preset"]]
    over = dict(dims_override or {})
    if "tower" in over:
        over["tower"] = dims.tower.replace(**over["tower"])
    return dims.replace(**over) if over else dims


def counters() -> Dict:
    from whisper_finetune_torch.models import decoding, omni
    from whisper_finetune_torch.models.whisper import encoder_forward
    from whisper_finetune_torch.ops.attention import attn_fwd

    g = decoding.greedy_decode
    return {"routes": list(omni.moe.routes), "prefill_routes": list(omni.moe.prefill_routes),
            "tokens_routed": omni.moe.tokens_routed,
            "experts_touched": omni.moe.experts_touched, "layer_steps": omni.moe.layer_steps,
            "lm_blocks_run": omni.lm_block.blocks_run,
            "enc_blocks_run": encoder_forward.blocks_run, "attn_fwd": attn_fwd.launches,
            "graph_captures": g.graph_captures, "graph_replays": g.graph_replays,
            "eager_steps": g.eager_steps}


def counter_delta(c0: Mapping, c1: Mapping) -> Dict:
    return {k: ([b - a for a, b in zip(c0[k], c1[k])] if isinstance(c0[k], list)
                else c1[k] - c0[k]) for k in c0}


class OmniProgram:
    """The program built for a cell and seed: weights, clips, prompt, and
    :meth:`call`, one ``transcribe_batch`` call of ``rows`` clips.
    ``dims_override`` resizes program and reference alike (tests);
    ``program_override`` changes the program's dimensions alone (a planted
    fault)."""

    def __init__(self, cell: Mapping, seed: int, device="cuda",
                 dims_override: Optional[Mapping] = None,
                 program_override: Optional[Mapping] = None):
        from whisper_finetune_torch.config import build_forward_config, with_defaults
        from whisper_finetune_torch.models.omni import AUDIO_ID, OmniModel

        self.dev = torch.device(device)
        self.seed = int(seed)
        tr = self.tr = cell["traffic_spec"]
        ref_obj = omni_dims(cell, dims_override)
        dims = self.dims = ref_obj.to_dict()  # the reference's (and the weights')
        self.dims_obj = ref_obj.replace(**program_override) if program_override else ref_obj
        self.rows, self.new_tokens = int(tr["rows"]), int(tr["new_tokens"])
        self.model = OmniModel(self.dims_obj, program_weights(dims, self.seed, self.dev))
        for _, p in self.model.leaves():
            p.requires_grad_(False)
        want = ([(s[0], s[1]) for s in leaf_specs(dims["tower"]) if s[0][0] == "encoder"]
                + [(s[0], s[1]) for s in lm_specs(dims)])
        got = [(path, tuple(p.shape)) for path, p in self.model.leaves()]
        if sorted(got) != sorted((p, tuple(s)) for p, s in want):
            raise RuntimeError("the program's leaves are not the benchmark's weights' leaves")
        self.params = self.model.params()
        config = with_defaults({"model": {"init_name": tr["tower_preset"]},
                                "training": {"mixed_precision_training": True,
                                             "mp_dtype": tr["dtype"],
                                             "attn_impl": tr["attn_impl"]}})
        self.fcfg = build_forward_config(config, False, self.dev)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed((self.seed * 11 + 3) % (1 << 63))
        R = int(tr["distinct_rows"])
        self.clips = (torch.randn((R, N_SAMPLES), generator=gen, device=self.dev)
                      * float(tr["audio_std"])).cpu().numpy()
        rng = np.random.default_rng([self.seed, 3])
        self.order = rng.permutation(R)
        n = int(tr["prompt_ids"])
        ids = rng.integers(0, int(tr["text_ids_below"]), size=2 * n).tolist()
        self.pre, self.post = ids[:n], ids[n:]
        self.prompt = self.pre + [AUDIO_ID] * self.dims_obj.audio_tokens + self.post

    def call_rows(self, c: int) -> np.ndarray:
        R = len(self.order)
        return np.asarray([int(self.order[(c * self.rows + j) % R]) for j in range(self.rows)])

    def call(self, c: int):
        from whisper_finetune_torch.models.decoding import transcribe_batch

        return transcribe_batch(self.params, self.dims_obj, self.clips[self.call_rows(c)], None,
                                fcfg=self.fcfg, max_len=self.new_tokens, beam_size=None,
                                temperatures=(0.0,), compression_ratio_threshold=None,
                                logprob_threshold=None, prompt=(self.pre, self.post))

    def served(self, recorder: GreedyRecorder):
        """(served id lists, mean log-probabilities), a row each, of the
        recorded calls."""
        eot = self.dims_obj.eot
        served, mean_lp = [], []
        for tokens, avg_lp in recorder.calls:
            for row, lp in zip(tokens.tolist(), avg_lp.tolist()):
                end = row.index(eot) + 1 if eot in row else len(row)
                served.append(row[:end])
                mean_lp.append(lp)
        return served, mean_lp

    def release(self) -> None:
        """Lets go of the program: its held graph, its weights."""
        from whisper_finetune_torch.models import decoding

        decoding.release()
        self.model = self.params = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


@torch.no_grad()
def moe_step_reading(prog: OmniProgram, last: torch.Tensor, steps: int = 4) -> Dict:
    """The token step of the calls run eagerly, at their last position on
    the tokens ``last`` (rows,), ``steps`` times under the profiler after
    one untimed step: the device time each span owns, a step's MoE under
    ``wft.moe`` (inside the calls the graph replay's span owns it). The
    masked step runs every expert over every row, so its time does not
    depend on the tokens."""
    import torch.autograd.profiler as tprof
    from whisper_finetune_torch.models.omni import OmniDecoder

    end = len(prog.prompt) + prog.new_tokens
    dec = OmniDecoder(prog.params, prog.dims_obj, prog.fcfg.dtype, prog.rows, end, prog.dev)
    x = dec.embed(last.to(prog.dev))
    dec.pos.fill_(end - 1)
    dec.blocks(x)
    with OwnedProfile(True) as prof:
        with tprof.record_function("bench.window"):
            for _ in range(steps):
                dec.blocks(x)
    return {"steps": steps, "span_device_s": prof.result["spans"]["span_device_s"]}


def check(prog: OmniProgram, served: List, mean_lp: List, records: List, calls_rows: List,
          cell: Mapping, control: bool = False) -> Dict:
    """The reference's readings of ``check_rows`` served rows: the longest
    and others drawn from the seed."""
    tr = cell["traffic_spec"]
    flat_rows = [int(r) for rr in calls_rows for r in rr]
    longest = int(np.argmax([len(s) for s in served]))
    rng = np.random.default_rng([prog.seed, 4])
    pick = [longest] + [int(i) for i in rng.permutation(len(served)) if i != longest]
    pick = pick[: int(tr["check_rows"])]
    rows = prog.rows
    sample = [{"clip": torch.from_numpy(prog.clips[flat_rows[i]]).to(prog.dev),
               "prompt": prog.prompt, "served": served[i], "mean_logprob": mean_lp[i],
               "selection": records[i // rows][i % rows]} for i in pick]
    leaves = ReferenceLeaves(prog.dims, prog.seed, prog.dev)
    with no_tf32():
        readings = read_rows(leaves, sample, prog.dims, float(cell["delta"]),
                             control=control)
    readings["sampled_rows"] = len(pick)
    return readings


def run(cell: Mapping, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", dims_override: Optional[Mapping] = None, control: bool = False,
        program_override: Optional[Mapping] = None) -> Dict:
    """One run of an ``omni_decode`` cell; ``control`` also reads the fp8
    control's numbers on the sampled rows (``benchmark/control_omni.py``)."""
    from whisper_finetune_torch.models import omni

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    prog = OmniProgram(cell, seed, device, dims_override, program_override)
    tr = cell["traffic_spec"]
    recorder = GreedyRecorder()
    with recorder:
        prog.call(0)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start

    import torch.autograd.profiler as tprof

    recorder.calls.clear()
    omni.moe.record = records = []
    c0 = counters()
    n_calls, calls_rows = 0, []
    trace_calls = int(tr["trace_calls"])
    try:
        with recorder, OwnedProfile(trace and cuda) as prof:
            with tprof.record_function("bench.window"):
                t0 = time.perf_counter()
                while True:
                    with tprof.record_function("bench.call"):
                        prog.call(1 + n_calls)
                    calls_rows.append(prog.call_rows(1 + n_calls))
                    n_calls += 1
                    if (n_calls >= trace_calls) if trace else (time.perf_counter() - t0 >= seconds):
                        break
                if cuda:
                    torch.cuda.synchronize()
                window_s = time.perf_counter() - t0
    finally:
        omni.moe.record = None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    t_window_end = time.monotonic()
    c = counter_delta(c0, counters())
    served, mean_lp = prog.served(recorder)
    rows = prog.rows
    if len(served) != n_calls * rows or any(len(s) > prog.new_tokens for s in served):
        raise RuntimeError(f"{len(served)} rows served for {n_calls} calls of {rows} rows")
    if len(records) != n_calls:
        raise RuntimeError(f"{len(records)} calls' selections recorded for {n_calls} calls")
    tokens = sum(len(s) for s in served)
    moe_step = moe_step_reading(prog, recorder.calls[-1][0][:, -1]) if trace and cuda else None
    prog.release()

    readings = check(prog, served, mean_lp, records, calls_rows, cell, control)
    readings["seconds"] = {"setup": setup_s, "window": window_s,
                           "reference": time.monotonic() - t_window_end}
    readings["counters"] = c
    check_ = {name: {"value": readings[name], "limit": float(limit)}
              for name, limit in cell["limits"].items()}
    correct = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in check_.values())
    record = {"kind": "omni_decode", "dims": prog.dims, "rows": rows,
              "prompt_len": len(prog.prompt), "new_tokens": prog.new_tokens,
              "calls": n_calls, "tokens": tokens, "token_steps": n_calls * prog.new_tokens,
              "window_s": window_s, "trace": prof.result, "counters": c, "moe_step": moe_step}
    return {
        "correct": bool(correct), "attempted": n_calls * rows, "failed": 0,
        "e2e": {"decode_tokens_per_s": tokens / window_s, "peak_mem_gib": peak / GIB,
                "setup_s": setup_s},
        "record": record, "peak_bytes": peak, "check": check_, "readings": readings,
    }
