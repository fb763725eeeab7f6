"""The ``decode`` kind: the transcribe CLI's path, ``transcribe_batch``, on
the card, closed loop: the next call starts when the previous one returns.

Set-up makes the model from the seed's weights, the tokenizer, the clips
(``distinct_rows`` 30 s clips of N(0, ``audio_std``^2) noise from the seed,
cycled ``rows`` a call in a seeded order) and runs one call, which warms up
every shape the window uses. The filter table of the traffic file is handed
to the program (it must equal the program's default filters for the
tokenizer, which set-up checks) and to the reference.

Served tokens are read where the program produces them: what its
``greedy_decode`` returns to ``transcribe_batch`` (the ids and each row's
mean log-probability of them). A row's served tokens run up to and including
its end-of-text, or all ``max_len`` less the prompt without one.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from benchmark.reference.decode import read_rows
from benchmark.reference.whisper import no_tf32
from benchmark.trace import Profiled
from benchmark.weights import make_weights

GIB = float(1 << 30)
N_SAMPLES = 480000


class GreedyRecorder:
    """While on (``with``), the program's ``greedy_decode`` as
    ``transcribe_batch`` calls it, keeping what each call returns: the
    tokens and each row's mean log-probability of them."""

    def __init__(self):
        from whisper_finetune_torch.models import decoding

        self.mod = decoding
        self.real = None
        self.calls = []

    def __call__(self, *args, **kwargs):
        tokens, avg_lp = self.real(*args, **kwargs)
        self.calls.append((tokens, avg_lp))
        return tokens, avg_lp

    def __enter__(self):
        self.real = self.mod.greedy_decode
        self.mod.greedy_decode = self
        return self

    def __exit__(self, *exc):
        self.mod.greedy_decode = self.real
        return False


def _filters(tr: Mapping):
    from whisper_finetune_torch.models.decoding import DecodeFilters

    return DecodeFilters(suppress=tuple(tr["filters"]["suppress"]),
                         blank=tuple(tr["filters"]["blank"]), timestamp_rules=False,
                         timestamp_begin=int(tr["timestamp_begin"]), eot=int(tr["eot"]))


def run(cell: Mapping, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", dims_override: Optional[Mapping] = None, control: bool = False) -> Dict:
    """One run of a ``decode`` cell; ``control`` also reads the fp8
    control's gap on the sampled rows (the control script's reading)."""
    from whisper_finetune_torch.config import build_forward_config, with_defaults
    from whisper_finetune_torch.models.decoding import default_filters, transcribe_batch
    from whisper_finetune_torch.models.dims import MODEL_PRESETS
    from whisper_finetune_torch.models.whisper import Whisper, encoder_forward
    from whisper_finetune_torch.ops.attention import attn_fwd
    from whisper_finetune_torch.tokenizer import get_tokenizer

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tr = cell["traffic_spec"]
    dims_obj = MODEL_PRESETS[cell["config_spec"]["preset"]]
    if dims_override:
        dims_obj = dims_obj.replace(**dims_override)
    dims = dims_obj.to_dict()
    rows, max_len = int(tr["rows"]), int(tr["max_len"])

    model = Whisper(dims_obj, make_weights(dims, seed, dev))
    params = model.params()
    for _, p in model.leaves():
        p.requires_grad_(False)
    config = with_defaults({"model": {"init_name": cell["config_spec"]["preset"]},
                            "training": {"mixed_precision_training": True,
                                         "mp_dtype": tr["dtype"],
                                         "attn_impl": tr["attn_impl"]}})
    fcfg = build_forward_config(config, False, dev)
    tok = get_tokenizer(multilingual=True, language=tr["language"], task="transcribe")
    filters = _filters(tr)
    if filters != default_filters(tok, without_timestamps=True):
        raise RuntimeError("the traffic's filter table is not the program's default filters")
    gen = torch.Generator(device=dev)
    gen.manual_seed((int(seed) * 11 + 3) % (1 << 63))
    R = int(tr["distinct_rows"])
    clips = (torch.randn((R, N_SAMPLES), generator=gen, device=dev)
             * float(tr["audio_std"])).cpu().numpy()
    order = np.random.default_rng([int(seed), 3]).permutation(R)

    def call_rows(c: int) -> np.ndarray:
        return np.asarray([int(order[(c * rows + j) % R]) for j in range(rows)])

    def call(c: int):
        return transcribe_batch(params, dims_obj, clips[call_rows(c)], tok, fcfg=fcfg,
                                language=tr["language"], max_len=max_len, beam_size=None,
                                temperatures=tuple(tr["temperatures"]),
                                compression_ratio_threshold=tr["compression_ratio_threshold"],
                                logprob_threshold=tr["logprob_threshold"],
                                without_timestamps=True, filters=filters)

    recorder = GreedyRecorder()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with recorder:
        call(0)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start

    import torch.autograd.profiler as tprof

    recorder.calls.clear()
    enc0, fwd0 = encoder_forward.blocks_run, attn_fwd.launches
    n_calls = 0
    calls_rows = []
    trace_calls = int(tr["trace_calls"])
    with recorder, Profiled(trace and cuda) as prof:
        with tprof.record_function("bench.window"):
            t0 = time.perf_counter()
            while True:
                with tprof.record_function("bench.call"):
                    call(1 + n_calls)
                calls_rows.append(call_rows(1 + n_calls))
                n_calls += 1
                if (n_calls >= trace_calls) if trace else (time.perf_counter() - t0 >= seconds):
                    break
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    t_window_end = time.monotonic()
    counters = {"enc_blocks_run": encoder_forward.blocks_run - enc0,
                "attn_fwd": attn_fwd.launches - fwd0}
    prompt = [int(t) for t in tr["prompt"]]
    n_gen = max_len - len(prompt)
    eot = int(tr["eot"])
    served, mean_lp = [], []
    for tokens, avg_lp in recorder.calls:
        for row, lp in zip(tokens.tolist(), avg_lp.tolist()):
            end = row.index(eot) + 1 if eot in row else len(row)
            served.append(row[:end])
            mean_lp.append(lp)
    if len(served) != n_calls * rows or any(len(s) > n_gen for s in served):
        raise RuntimeError(f"{len(served)} rows served for {n_calls} calls of {rows} rows")
    tokens = sum(len(s) for s in served)
    del model, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # The sample: the row with the most served tokens and others drawn from
    # the seed, up to ``check_rows`` rows.
    flat_rows = [int(r) for rr in calls_rows for r in rr]
    longest = int(np.argmax([len(s) for s in served]))
    rng = np.random.default_rng([int(seed), 4])
    pick = [longest] + [int(i) for i in rng.permutation(len(served)) if i != longest]
    pick = pick[: int(tr["check_rows"])]
    w = make_weights(dims, seed, dev)
    sample = [{"clip": torch.from_numpy(clips[flat_rows[i]]).to(dev), "prompt": prompt,
               "served": served[i], "mean_logprob": mean_lp[i]} for i in pick]
    with no_tf32():
        readings = read_rows(w, sample, dims, tr["filters"], control=control)
    readings["seconds"] = {"setup": setup_s, "window": window_s,
                           "reference": time.monotonic() - t_window_end}
    check = {name: {"value": readings[name], "limit": float(limit)}
             for name, limit in cell["limits"].items()}
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())
    record = {"kind": "decode", "dims": dims, "rows": rows, "max_len": max_len,
              "calls": n_calls, "tokens": tokens, "token_steps": n_calls * max_len,
              "prompt_len": len(prompt), "window_s": window_s, "trace": prof.result,
              "counters": counters}
    return {
        "correct": correct, "attempted": n_calls * rows, "failed": 0,
        "e2e": {"decode_tokens_per_s": tokens / window_s, "peak_mem_gib": peak / GIB,
                "setup_s": setup_s},
        "record": record, "peak_bytes": peak, "check": check,
        "readings": {"sampled_rows": len(pick), **readings},
    }
