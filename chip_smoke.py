#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: build, check, drive.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. Environment: torch / CUDA versions, the card's name and power limit, and
   the build of every ``whisper_finetune_torch/csrc/*.cu`` (all ``nvcc`` runs
   started together) with its seconds.
2. Kernels against their plain PyTorch twins on the card, bf16 in, float32
   math in the twin, at the main path's shapes: the attention forward and the
   fused backward (dq, dk, dv) at (2, 20, 1500x1500), (2, 20, 448x1500) and
   causal (2, 20, 448x448) plus ragged and small causal shapes, one with fewer
   keys than a 64-key tile, one with fewer than the forward's 128-key tile, one
   with fewer queries than a query tile, one causal over three key tiles and
   two with one query and one key past a whole tile (129x257, causal
   257x257), and the forward instance that writes no log-sum-exp at the three
   main-path shapes; the forward twice on the same inputs (both instances: o
   and lse bit-equal) and the backward twice (dk and dv bit-equal, dq's
   largest difference printed); the forward's registers and spills from
   ``ptxas -v`` and its blocks an SM from the occupancy calculator; the fused
   8-bit AdamW on (NB, 256) leaves with NB
   divisible and not divisible by 128, three steps. Then each kernel's time
   at the main path's shapes, its plain twin's time, the PyTorch library
   call's time (``scaled_dot_product_attention`` and its backward), and the
   bound (the larger of bytes over 3.35 TB/s and operations over
   989 TFLOP/s bf16, from the shapes; under a causal mask only the unmasked
   64 x 64 tiles' work counts; the backward against the 10*B*H*Tq*Tk*64 FLOP
   of splash's fused backward). The attention kernels and the library calls
   are timed as device time under a captured CUDA graph, so that both columns
   compare like with like at the small shapes too; the eager loop's time is
   kept beside it. And the decoder's causal self-attention forward + backward
   through the kernels against the plain path (``xla_mha``) at
   (8, 20, 448x448).
3. The first slice's path: full large-v3 (1.55 B parameters, random weights
   from a seed), batch 8 of synthetic 30 s audio, on-device log-mel +
   SpecAugment, full remat, bf16 compute, bf16 gradient accumulator, label
   smoothing 0.1, clip 1.0, fused 8-bit AdamW(2e-5, wd 0.01), through
   ``make_train_step``: 2 warm-up and 5 timed steps. Every launch counter is
   set to 0 just before and read just after; each kernel must have launched
   exactly its expected count. Then the fused AdamW against its twin on
   copies of the model's own ``tok_emb`` and a (32, 1280, 5120) leaf with
   their 8-bit state, and its time over all quantized leaves.
4. The Muon flagship, built from ``configs/config_large_v3_best_muon.yaml``
   through ``config.load_config`` / ``build_forward_config`` /
   ``build_featurize_config`` / ``get_schedule`` / ``get_optimizer`` /
   ``make_train_step``, three legs, counters zeroed before each and read
   after it:
   - ``flash``: ``attn_impl: flash`` at all three attention sites, full
     large-v3, microbatch 8, accumulation 8, 1 warm-up + 3 timed optimizer
     steps; launches must equal the blocks the forward ran (stochastic depth
     drops layers), the schedule's lr is checked at each count;
   - ``flash_fwd``: ``attn_impl: flash_fwd`` at full width and 4 + 4 layers,
     stochastic depth 0, int8 Muon momentum and 8-bit auxiliary AdamW,
     accumulation 2, 2 steps: 96 forward launches (the instance that writes
     no log-sum-exp), no backward kernel launch;
   - ``auto``: the config as shipped (splash at the encoder and cross sites,
     plain decoder self-attention) at 4 + 4 layers, 2 steps.
5. The model layer, three legs after those (``.pt`` files under the
   gitignored ``build/chip_smoke/``, removed after use):
   - ``remat``: the first slice under ``remat_policy`` dots, attn,
     ``save:enc_mlp_h`` and ``offload:enc_mlp_h`` in turn, each from the
     main path's weights, batch and SpecAugment draws, 1 warm-up + 2 timed
     steps, held against the main path (``full``): first loss bit-equal,
     first-step gradients' per-layer norms within 2%, parameters after one
     step within 3 lr, launches 128 / 64 / 43
     a step, the peak over full against what the policy keeps (an offload:
     within one layer of full, every site's bytes staged to pinned host
     memory);
   - ``lora``: ``configs/config_small_lora.yaml`` as shipped, base weights
     through an fp16 ``.pt`` and ``config.build_model``: launches 384 / 192 a
     step, base leaves bit-equal after the steps, every adapter B non-zero,
     merged and runtime-LoRA logits bit-equal, the merge CLI (on the card)
     from the trained model's float32 ``.pt``: its fp16 file bit-equal to
     fp16 of the merge;
   - ``surgery``: ``init_name: whisper-4832`` from a 3.1 GB large-v3 ``.pt``
     resized to 48 + 32 layers, the first slice's step: launches 160 / 80 / 43
     a step; the resized model saved and reloaded as fp16 (times of each).
6. The training driver, ``whisper_finetune_torch.scripts.finetune.main``,
   in this process on ``configs/DEBUG.yaml`` turned to ``init_name:
   large-v3`` at full width (random weights), batch 8, accumulation 1, 8-bit
   AdamW, over ``tools/make_debug_dataset.py``'s rows (64 train, 8 of the
   validation rows): YAML -> validation -> tokenizer -> HF dataset -> sample
   builder -> sampler -> loader threads -> pinned copies -> the train step,
   8 optimizer steps, eval at step 0 and 8, ``metrics.jsonl``, ``.pt``
   saves. Counters zeroed just before ``main`` and read just after: each
   train step 128 / 64 / 43 launches as the first slice's, plus one forward
   launch a site for each eval batch; the ``metrics.jsonl`` keys equal the
   JAX driver's (``tests/driver_metrics_keys.json``); ``last_model.pt`` read
   back equal to fp16 of the final parameters. Prints the median
   ``perf/step_time_s`` and ``perf/host_batch_build_s`` beside the first
   slice's step, the peak and the save times.

7. Data parallelism (``ddp``): ``finetune.main`` with ZeRO-1
   (``zero_shard_optimizer``) in two ranks on the one card, subprocesses of
   this script (``--ddp-rank``) over gloo, since NCCL refuses two ranks of a
   communicator on one GPU; the driver leg's configuration at batch 8 a
   rank, global accumulation 2 (local 1), 1 warm-up and 2 timed steps, no
   SpecAugment, prompts or warm-up, eval at step 0 and 3, the train state
   saved at step 3. Before it, in this process, the same global batch
   through one rank with accumulation 2 at world size 1 over NCCL (the
   default backend, a group of one) as the reference, and that run's first
   step once more for the card's run-to-run spread. Counters zeroed just
   before each ``main`` and read just after. Asserted: the ranks'
   parameters bit-equal after every step; the first loss within 1e-3 of the
   reference's; after step 1, on sampled elements and 8-bit blocks, the
   parameters within 3 lr and at most 1% of them beyond 15% of lr or of the
   codes more than a level apart; launches a rank 640 / 192 / 129 (the
   reference 1024 / 384 / 129); each rank's peak within 0.3 GB of the
   driver leg's peak less the 8-bit state it no longer holds; the train
   state read back into a fresh two-rank state bit-equal. Prints the
   backend, per-rank step ms, peaks, collective calls and bytes a step, and
   the save and read seconds.

8. The one-chip Muon flagship (``split``):
   ``configs/config_large_v3_best_muon_1chip.yaml`` as shipped (batch 6,
   accum 8, bf16 accumulator, int8 Muon momentum, 8-bit auxiliary AdamW,
   stochastic depth 0.1, deep SpecAugment, ``auto`` attention) at full
   large-v3, its split-step keys resolved as ``finetune.main`` resolves them
   (split, manual backward, precast). One accumulation each at accum 2 of
   the automatic backward, the manual backward and the manual backward
   with per-layer casts on the same weights, batch and draws: losses
   bit-equal, per-layer gradient norms within 2%, the peaks (the shipped
   manual path's difference asserted within 0.5 GB of PERF.md's
   reckoning); one manual accumulation at batch 32 (its peak); then 1 + 2
   optimizer steps at accum 8: ``accum_s`` and ``update_s``, the peak,
   launches against ``blocks_run``, the schedule's lr, every leaf moved.
9. Decoding (``decode``): large-v3 at random weights, 8 rows of synthetic
   30 s audio, ``transcribe_batch`` greedy with the six-rung fallback, beam
   5 (40 rows), beam 1, bf16, ``auto``: ``attn_fwd`` 32 a decode call and
   no backward launch; the cached step's logits against the teacher-forced
   ``forward_impl`` at every generated position (max |diff| <= 0.25; the
   argmax where the margin exceeds it); beam 1 equal to greedy but for
   float32 ties of the running score; the encoder's ms a pass, ms a token
   beside its bound, tokens/s, peaks, seconds a rung; then the transcribe
   CLI (``python -m whisper_finetune_torch.scripts.transcribe``) as a
   subprocess on the driver leg's fp16 ``last_model.pt`` and a wav.
10. Packaging (``package``), on the driver leg's ``last_model.pt`` (large-v3,
   32+32 at full width): the optional packages' versions; the conversion to
   a Transformers model on the card (its seconds and peak apart from
   ``save_pretrained``'s seconds; the safetensors against the float32 tree
   with the tied embedding once); ``from_pretrained`` logits bit-equal to
   the converter's; the HF float32 logits of 8 rows and 64 teacher-forced
   tokens against the port's ``forward_impl`` on the same ``.pt``, bf16 under
   ``auto`` (``attn_fwd`` once a block and a cross site; max |diff| <= 0.25)
   and float32 on the plain attention; ``upload_model_to_hub --convert-hf
   --local-only`` (the snapshot resolves through the HF cache, its ``.pt``
   and JSONs bit-equal to their sources, its revision the content hash);
   ``--convert-ct2``'s ``ImportError`` without ``ctranslate2``; the batch
   CLI's ``run_batch`` over that ``.pt`` and a whisper-tiny one.

``--profile`` adds a ``torch.profiler`` window of two main-path steps: device
time by kernel and group, and the device's busy share of the wall time.
``--kernels-only`` stops after phase 2 (build, checks and kernel times): the
same closing lines, with the attention kernels alone in ``kernels`` and their
launch counts 0, since no leg ran.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {...}}``. The full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor cores, same source
WARMUP_STEPS, TIMED_STEPS = 2, 5
A_NAMES = ("attn_fwd", "attn_bwd")  # the attention kernels


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10, repeats: int = 3) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` calls, by CUDA
    events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_time_ms(make, iters: int = 10, repeats: int = 3) -> float:
    """Device time of one ``fn()``, where ``fn = make()`` is built on the
    capture stream (autograd runs a backward on the stream of its forward):
    ``iters`` calls are captured into one CUDA graph (after a warm-up on that
    stream, as capture asks) and the graph is replayed between two events, so
    that no host time of the calls (Python, the autograd engine, a launch's
    set-up) is inside the window. Median over ``repeats`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn = make()
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flops_per_sample(dims) -> float:
    """Matmul FLOPs of one 30 s sample, forward (2*M*N*K a matmul): the
    port's copy of bench.py's accounting."""
    d_a, d_t = dims.n_audio_state, dims.n_text_state
    T_a, T_t = dims.n_audio_ctx, dims.n_text_ctx
    enc_block = (
        4 * 2 * T_a * d_a * d_a
        + 2 * 2 * T_a * T_a * d_a
        + 2 * 2 * T_a * d_a * 4 * d_a
    )
    dec_block = (
        4 * 2 * T_t * d_t * d_t
        + 2 * 2 * T_t * T_t * d_t
        + 4 * 2 * T_t * d_t * d_t
        + 2 * 2 * T_t * T_a * d_t
        + 2 * 2 * T_t * d_t * 4 * d_t
    )
    convs = 2 * (2 * T_a) * 3 * dims.n_mels * d_a + 2 * T_a * 3 * d_a * d_a
    logits = 2 * T_t * d_t * dims.n_vocab
    return dims.n_audio_layer * enc_block + dims.n_text_layer * dec_block + convs + logits


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain twins
# ---------------------------------------------------------------------------

# Limits, about 2.5x the worst error measured on the sound kernels over the
# five shapes of check_attention (H100, PERF.md): max |err| <= tol * max|ref|
# for o (worst 3.2e-3 of the peak; bf16 output, bf16 P) and dq, dk, dv (worst
# 4.5e-3; bf16 dS into the products). lse is float32 on both sides: absolute.
ATTN_TOL_O = 8e-3
ATTN_TOL_GRAD = 1.2e-2
ATTN_TOL_LSE = 1e-3


def _qkv(B, H, Tq, Tk, gen):
    """q, k, v in the model's layout: (B, T, H, 64) buffers seen as (B, H, T, 64)."""
    import torch

    def one(T):
        return torch.randn((B, T, H, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)

    return one(Tq), one(Tk), one(Tk)


CHECK_SHAPES = (
    (2, 20, 1500, 1500, False), (2, 20, 448, 1500, False), (2, 20, 448, 448, True),  # main path
    (1, 3, 77, 131, False), (1, 3, 77, 77, True), (1, 2, 200, 200, True),
    (1, 2, 130, 40, False),   # fewer keys than one key tile
    (1, 2, 70, 100, False),   # fewer keys than the forward's 128-key tile
    (1, 2, 24, 150, False),   # fewer queries than one query tile
    (2, 3, 300, 300, True),   # causal, three key tiles, Tq no multiple of a tile
    (1, 2, 129, 257, False),  # one query and one key past a whole tile
    (1, 2, 257, 257, True),   # the same, causal: a last query tile of one row
)


def check_attention(gen) -> dict:
    import torch
    from whisper_finetune_torch.ops import attention as A

    scale = 64 ** -0.5
    worst = {"attn_fwd": 0.0, "attn_bwd": 0.0}
    for B, H, Tq, Tk, causal in CHECK_SHAPES:
        q, k, v = _qkv(B, H, Tq, Tk, gen)
        do = torch.randn((B, H, Tq, 64), generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = A.attn_fwd(q, k, v, causal, scale)
        dq, dk, dv = A.attn_bwd(q, k, v, o, do, lse, causal, scale)
        torch.cuda.synchronize()
        o_r, lse_r = A.attn_fwd_plain(q.float(), k.float(), v.float(), causal, scale)
        dq_r, dk_r, dv_r = A.attn_bwd_plain(q.float(), k.float(), v.float(), o_r,
                                            do.float(), lse_r, causal, scale)
        rows = []
        for name, kern, ref, tol in (
            ("o", o, o_r, ATTN_TOL_O), ("lse", lse, lse_r, None),
            ("dq", dq, dq_r, ATTN_TOL_GRAD), ("dk", dk, dk_r, ATTN_TOL_GRAD),
            ("dv", dv, dv_r, ATTN_TOL_GRAD),
        ):
            err = (kern.float() - ref).abs().max().item()
            peak = ref.abs().max().item()
            limit = ATTN_TOL_LSE if tol is None else tol * peak
            rows.append(f"{name} {err:.3e}/{limit:.3e} ({err / peak:.2e} of peak)")
            if not err <= limit:  # also catches NaN
                raise AssertionError(
                    f"attention {B}x{H}x{Tq}x{Tk} causal={causal}: {name} max abs err "
                    f"{err} > {limit} (max|ref| {peak})")
            kernel = "attn_fwd" if name in ("o", "lse") else "attn_bwd"
            worst[kernel] = max(worst[kernel], err)
        log(f"  attention {B}x{H}x{Tq}x{Tk} causal={int(causal)}: " + ", ".join(rows))
    # The forward instance that writes no log-sum-exp against its own twin.
    worst["attn_fwd_nolse"] = 0.0
    for B, H, Tq, Tk, causal in CHECK_SHAPES[:3]:
        q, k, v = _qkv(B, H, Tq, Tk, gen)
        o, lse = A.attn_fwd(q, k, v, causal, scale, with_lse=False)
        torch.cuda.synchronize()
        ref = A.attn_fwd_nolse_plain(q.float(), k.float(), v.float(), causal, scale)
        err, peak = (o.float() - ref).abs().max().item(), ref.abs().max().item()
        if lse is not None or not err <= ATTN_TOL_O * peak:
            raise AssertionError(f"no-lse forward {B}x{H}x{Tq}x{Tk} causal={causal}: "
                                 f"max abs err {err} > {ATTN_TOL_O * peak}")
        worst["attn_fwd_nolse"] = max(worst["attn_fwd_nolse"], err)
        log(f"  no-lse forward {B}x{H}x{Tq}x{Tk} causal={int(causal)}: o {err:.3e}/"
            f"{ATTN_TOL_O * peak:.3e}")
    return worst


def check_bwd_repeatable(gen) -> dict:
    """``attn_bwd`` twice on the same inputs at the three main-path shapes:
    dk and dv are sums in a fixed order and must be bit-equal; dq is summed
    over key tiles by bulk reductions (``cp.reduce.async.bulk``) in the order
    the hardware picks, so its largest difference is reported (and held to
    the gradients' limit)."""
    import torch
    from whisper_finetune_torch.ops import attention as A

    scale = 64 ** -0.5
    worst = 0.0
    for B, H, Tq, Tk, causal in CHECK_SHAPES[:3]:
        q, k, v = _qkv(B, H, Tq, Tk, gen)
        do = _qkv(B, H, Tq, Tq, gen)[0]
        o, lse = A.attn_fwd(q, k, v, causal, scale)
        first = A.attn_bwd(q, k, v, o, do, lse, causal, scale)
        second = A.attn_bwd(q, k, v, o, do, lse, causal, scale)
        torch.cuda.synchronize()
        if not (torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])):
            raise AssertionError(f"attn_bwd {B}x{H}x{Tq}x{Tk}: dk or dv differ between two runs")
        diff = (first[0].float() - second[0].float()).abs().max().item()
        peak = first[0].float().abs().max().item()
        if not diff <= ATTN_TOL_GRAD * peak:
            raise AssertionError(f"attn_bwd {B}x{H}x{Tq}x{Tk}: dq differs by {diff} between two runs")
        worst = max(worst, diff)
        log(f"  attn_bwd twice {B}x{H}x{Tq}x{Tk} causal={int(causal)}: dk, dv bit-equal; "
            f"dq max diff {diff:.3e} (peak {peak:.3e})")
    return {"dq_max_diff": worst}


def check_fwd_repeatable(gen) -> None:
    """``attn_fwd`` twice on the same inputs at the three main-path shapes,
    both instances: the forward has no atomics, so o and lse must be
    bit-equal."""
    import torch
    from whisper_finetune_torch.ops import attention as A

    scale = 64 ** -0.5
    for B, H, Tq, Tk, causal in CHECK_SHAPES[:3]:
        q, k, v = _qkv(B, H, Tq, Tk, gen)
        for with_lse in (True, False):
            first = A.attn_fwd(q, k, v, causal, scale, with_lse=with_lse)
            second = A.attn_fwd(q, k, v, causal, scale, with_lse=with_lse)
            torch.cuda.synchronize()
            if not (torch.equal(first[0], second[0])
                    and (not with_lse or torch.equal(first[1], second[1]))):
                raise AssertionError(f"attn_fwd {B}x{H}x{Tq}x{Tk} with_lse={with_lse}: "
                                     "two runs differ")
        log(f"  attn_fwd twice {B}x{H}x{Tq}x{Tk} causal={int(causal)}: o and lse bit-equal, "
            "both instances")


def ptxas_usage(log_text: str, kernel: str) -> dict:
    """Registers and spill bytes of each instance of ``kernel`` (by mangled
    name) from the ``nvcc -Xptxas -v`` report of the build."""
    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            if cur:
                out[cur] = {}
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[cur].update(spill_store_bytes=int(m[1]), spill_load_bytes=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[cur]["registers"] = int(m[1])
    return out


def fwd_resources(ptxas_log: str) -> dict:
    """The forward's registers and spills (``ptxas -v``), and its blocks an
    SM and dynamic shared memory (the occupancy calculator), per instance."""
    from whisper_finetune_torch.ops import attention as A

    usage = ptxas_usage(ptxas_log, "attn_fwd_kernel")
    out = {}
    for inst, flag in (("with_lse", "ILb1E"), ("no_lse", "ILb0E")):
        regs = next((u for name, u in usage.items() if flag in name), {})
        out[inst] = {**regs, **A.attn_fwd_occupancy(inst == "with_lse")}
    log(f"  attn_fwd resources: {json.dumps(out)}")
    return out


def compare_adamw8(label, p, mc, ms, nc, ns, gen, out: dict) -> dict:
    """Three steps of the kernel and of its plain twin from the same
    (p, m codes/scales, nu codes/scales), each on its own copy, with fresh
    bf16 gradients; folds the differences into ``out`` and asserts them."""
    import torch
    from whisper_finetune_torch.ops.fused_adamw8 import fused_adamw8_leaf, fused_adamw8_plain

    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    kern = [x.clone() for x in (p, mc, ms, nc, ns)]
    ref = [x.clone() for x in (p, mc, ms, nc, ns)]
    gs = torch.tensor(0.7, device="cuda")
    for t in range(1, 4):
        g = (torch.randn(p.shape, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        c1, c2 = 1.0 - 0.9 ** t, 1.0 - 0.999 ** t
        fused_adamw8_leaf(kern[0], g, *kern[1:], 1e-3, c1, c2, gs, **hp)
        ref = list(fused_adamw8_plain(ref[0], g, *ref[1:], 1e-3, c1, c2, gs, **hp))
    torch.cuda.synchronize()
    dm = (kern[1].int() - ref[1].int()).abs()
    dn = (kern[3].int() - ref[3].int()).abs()
    out["p"] = max(out["p"], (kern[0] - ref[0]).abs().max().item())
    out["m_codes"] = max(out["m_codes"], dm.max().item())
    out["n_codes"] = max(out["n_codes"], dn.max().item())
    out["m_codes_off"] += int((dm > 0).sum().item())
    out["n_codes_off"] += int((dn > 0).sum().item())
    for a, b in ((kern[2], ref[2]), (kern[4], ref[4])):
        out["scale_rel"] = max(out["scale_rel"],
                               ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item())
    nb = p.shape[0]
    log(f"  fused_adamw8 {label} NB={nb} (NB % 128 = {nb % 128}), 3 steps: max|dp| "
        f"{out['p']:.3e}, m codes off {out['m_codes_off']} (max {out['m_codes']}), "
        f"nu codes off {out['n_codes_off']} (max {out['n_codes']}), scale rel "
        f"{out['scale_rel']:.3e}")
    # Tolerances: p within float32 rounding of |p| <= ~5 (1e-6 is ~2 ulp there);
    # codes at most one level apart; scales to float32 rounding.
    if not (out["p"] <= 1e-6 and out["m_codes"] <= 1 and out["n_codes"] <= 1
            and out["scale_rel"] <= 1e-6):
        raise AssertionError(f"fused_adamw8 disagrees with its plain version: {out}")
    return out


def check_adamw8(gen) -> dict:
    """Synthetic leaves from zero moments, NB divisible and not by 128."""
    import torch

    out = {"p": 0.0, "m_codes": 0, "n_codes": 0, "m_codes_off": 0, "n_codes_off": 0,
           "scale_rel": 0.0}
    for nb in (4096, 1003):
        p = torch.randn((nb, 256), generator=gen, device="cuda")
        mc = torch.zeros((nb, 256), dtype=torch.int8, device="cuda")
        nc = torch.zeros((nb, 256), dtype=torch.uint8, device="cuda")
        ms = torch.zeros((nb, 1), device="cuda")
        ns = torch.zeros((nb, 1), device="cuda")
        compare_adamw8("synthetic", p, mc, ms, nc, ns, gen, out)
    return out


def check_adamw8_leaves(model, opt_state, gen, out: dict) -> dict:
    """The kernel against its twin on copies of large-v3's own leaves and
    8-bit state after the main path's steps: ``tok_emb`` (NB 259330, not a
    multiple of 128) and the first (32, 1280, 5120) stacked matrix
    (NB 819200)."""
    from whisper_finetune_torch.optim.quantized import BLOCK

    picked = {}
    for (path, p), mu, nu in zip(model.leaves(), opt_state.mu, opt_state.nu):
        key = ("tok_emb" if path[-1] == "tok_emb"
               else "stacked" if tuple(p.shape) == (32, 1280, 5120) else None)
        if key and key not in picked:
            picked[key] = ("/".join(path), p, mu, nu)
    if set(picked) != {"tok_emb", "stacked"}:
        raise AssertionError(f"large-v3 leaves not found: {sorted(picked)}")
    for name, p, mu, nu in picked.values():
        compare_adamw8(name, p.data.view(-1, BLOCK), mu.codes, mu.scale,
                       nu.codes, nu.scale, gen, out)
    return out


def _unmasked_pairs(Tq: int, Tk: int, causal: bool, tile: int = 64) -> int:
    """(query, key) pairs in the 64 x 64 tiles a kernel cannot skip: all of
    them without a mask; under a causal mask the tiles at or below the
    diagonal (the kernels skip the rest)."""
    if not causal:
        return Tq * Tk
    return sum(min(tile, Tq - q0) * min(Tk, q0 + tile) for q0 in range(0, Tq, tile))


def time_attention(gen, site: str, B, H, Tq, Tk, causal: bool = False) -> dict:
    import torch
    import torch.nn.functional as F
    from whisper_finetune_torch.ops import attention as A

    scale = 64 ** -0.5
    q, k, v = _qkv(B, H, Tq, Tk, gen)
    do = _qkv(B, H, Tq, Tq, gen)[0]  # the gradient of o, in o's layout
    o, lse = A.attn_fwd(q, k, v, causal, scale)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    o_r, lse_r = A.attn_fwd_plain(qf, kf, vf, causal, scale)

    def sdpa(*args):
        return F.scaled_dot_product_attention(*args, scale=scale, is_causal=causal)

    def sdpa_backward():
        """The library's fused backward (one call), the backward's
        yardstick, on a forward made on the current stream."""
        qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
        out = sdpa(qr, kr, vr)
        return lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True)

    bhtd = B * H * _unmasked_pairs(Tq, Tk, causal) * 64
    row_q, row_k = B * H * Tq * 64 * 2, B * H * Tk * 64 * 2  # bf16 bytes
    vec = B * H * Tq * 4
    rec = {}
    # attn_bwd is the function splash's fused backward computes: dq, dk, dv
    # with S = QK^T, dP = dO V^T, dV, dQ, dK once each (10 BHTD); it reads q,
    # k, v, o, do, lse and writes dq, dk, dv. Timed whole: prep + main + convert.
    kernels = {
        "attn_fwd": (lambda: A.attn_fwd(q, k, v, causal, scale),
                     lambda: A.attn_fwd_plain(qf, kf, vf, causal, scale),
                     lambda: (lambda: sdpa(q, k, v)),
                     row_q + 2 * row_k + row_q + vec, 4 * bhtd),
        "attn_bwd": (lambda: A.attn_bwd(q, k, v, o, do, lse, causal, scale),
                     lambda: A.attn_bwd_plain(qf, kf, vf, o_r, dof, lse_r, causal, scale),
                     sdpa_backward,
                     3 * row_q + 2 * row_k + vec + row_q + 2 * row_k, 10 * bhtd),
    }
    for name, (kern, plain, make_lib, n_bytes, flops) in kernels.items():
        # Device time only (a captured graph): at the small shapes a call's
        # host time is longer than its kernels.
        ms = graph_time_ms(lambda: kern)
        b_ms, b_by = bound_ms(n_bytes, flops)
        rec[name] = {
            "site": site, "shape": [B, H, Tq, Tk, 64], "causal": causal, "ms": ms,
            "eager_ms": cuda_time_ms(kern),
            "plain_ms": cuda_time_ms(plain, iters=3),
            "library_ms": graph_time_ms(make_lib),
            "library_eager_ms": cuda_time_ms(make_lib()),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "flops": flops,
            "tflops": flops / ms / 1e9,
        }
    # The forward instance without the log-sum-exp write (the flash_fwd
    # route) against its own twin; same operations, (B, H, Tq) floats fewer.
    rec["attn_fwd"]["nolse_ms"] = graph_time_ms(
        lambda: (lambda: A.attn_fwd(q, k, v, causal, scale, with_lse=False)))
    rec["attn_fwd"]["nolse_plain_ms"] = cuda_time_ms(
        lambda: A.attn_fwd_nolse_plain(qf, kf, vf, causal, scale), iters=3)
    return rec


def time_decoder_self(gen) -> dict:
    """The decoder's causal self-attention, forward + backward through
    autograd, at the main path's (8, 20, 448, 448): the kernel route
    (``flash_mha``) against the plain path ``attn_impl: auto`` keeps at this
    site (``xla_mha``), and the forward alone."""
    import torch
    from whisper_finetune_torch.ops import attention as A

    scale = 64 ** -0.5
    q, k, v = (x.detach().requires_grad_() for x in _qkv(8, 20, 448, 448, gen))
    do = _qkv(8, 20, 448, 448, gen)[0]
    rec = {"shape": [8, 20, 448, 448, 64]}
    for name, fn in (("kernels", A.flash_mha), ("plain", A.xla_mha)):
        def fwd_bwd(fn=fn):
            torch.autograd.grad(fn(q, k, v, causal=True, sm_scale=scale), (q, k, v), do)

        def fwd(fn=fn):
            with torch.no_grad():
                fn(q, k, v, causal=True, sm_scale=scale)

        rec[name] = {"fwd_bwd_ms": cuda_time_ms(fwd_bwd), "fwd_ms": cuda_time_ms(fwd)}
    return rec


def time_adamw8(model, opt_state, gen) -> dict:
    """One step's fused update over every quantized leaf of the main path's
    model (all of large-v3's quantized leaves divide by 256)."""
    import torch
    from whisper_finetune_torch.ops.fused_adamw8 import fused_adamw8_leaf, fused_adamw8_plain
    from whisper_finetune_torch.optim.quantized import BLOCK, QMoment

    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    leaves = []
    for (_, p), mu, nu in zip(model.leaves(), opt_state.mu, opt_state.nu):
        if isinstance(mu, QMoment) and p.numel() % BLOCK == 0:
            g = (torch.randn(p.shape, generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
            leaves.append((p.data.view(-1, BLOCK), g.view(-1, BLOCK), mu, nu))
    gs = torch.tensor(1.0, device="cuda")
    c1, c2 = 1.0 - 0.9 ** 8, 1.0 - 0.999 ** 8

    def kern():
        for p, g, mu, nu in leaves:
            fused_adamw8_leaf(p, g, mu.codes, mu.scale, nu.codes, nu.scale,
                              2e-5, c1, c2, gs, **hp)

    def plain():
        for p, g, mu, nu in leaves:
            fused_adamw8_plain(p, g, mu.codes, mu.scale, nu.codes, nu.scale,
                               2e-5, c1, c2, gs, **hp)

    n = sum(p.numel() for p, *_ in leaves)
    nb = n // BLOCK
    n_bytes = n * (4 + 4 + 2 + 1 + 1 + 1 + 1) + nb * 4 * 4
    ms = cuda_time_ms(kern, iters=5)
    b_ms, b_by = bound_ms(n_bytes, 0.0)
    return {"site": "all quantized leaves of large-v3", "leaves": len(leaves),
            "elements": n, "ms": ms, "plain_ms": cuda_time_ms(plain, iters=1),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            "gbps": n_bytes / ms / 1e6}


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def main_path() -> dict:
    import torch
    from whisper_finetune_torch.models import get_preset_dims
    from whisper_finetune_torch.tools import first_slice as fs

    dims = get_preset_dims("large-v3")
    B = 8
    state, step, tx, fused_leaves = fs.build(dims)
    paths = [path for path, _ in state.model.leaves()]
    leaves = [p for _, p in state.model.leaves()]
    grad_norms = fs.record_grad_norms(tx, paths)  # the first step's, for the remat leg
    batch = fs.synthetic_batch(dims, batch=B)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_params = sum(p.numel() for p in leaves)
    before = [p.detach()[(0,) * (p.dim() - 1)][:8].clone() for p in leaves]
    log(f"  large-v3: {n_params} parameters in {len(leaves)} leaves, {fused_leaves} "
        f"through the fused kernel")

    kernels = fs.reset_counts()
    losses, times = [], []
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        if i == WARMUP_STEPS:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch, gen)
        loss = float(loss)  # syncs
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(loss)
        if i >= WARMUP_STEPS:
            times.append(dt)
        log(f"  step {i}: loss {loss:.4f}, {dt * 1e3:.1f} ms")
        if i == 0:  # the parameters after one step, on the host, for the remat leg
            after_one = [p.detach().cpu() for p in leaves]
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()

    n_steps = WARMUP_STEPS + TIMED_STEPS
    sites = dims.n_audio_layer + dims.n_text_layer  # encoder self + cross
    expect = {
        "attn_fwd": 2 * sites * n_steps,         # forward + remat recompute
        "attn_bwd": sites * n_steps,
        "fused_adamw8_leaf": fused_leaves * n_steps,
    }
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    # Random init with 0.02-std embeddings gives near-uniform logits.
    if abs(losses[0] - math.log(dims.n_vocab)) > 0.5:
        raise AssertionError(f"first loss {losses[0]} far from ln(V) = {math.log(dims.n_vocab)}")
    changed = sum(not torch.equal(b, p.detach()[(0,) * (p.dim() - 1)][:8])
                  for b, p in zip(before, leaves))
    if changed != len(leaves):
        raise AssertionError(f"only {changed} of {len(leaves)} leaves changed")
    if state.step != n_steps or state.opt_state.count != n_steps:
        raise AssertionError(f"step {state.step}, optimizer count {state.opt_state.count}")

    step_s = statistics.median(times)
    flops = 4 * B * _flops_per_sample(dims)  # forward + remat recompute + backward
    rec = {
        "model": "large-v3", "batch": B, "audio_s": 30, "steps_timed": TIMED_STEPS,
        "step_s_median": step_s, "step_s_all": times, "losses": losses,
        "audio_hours_per_s": B * 30 / 3600 / step_s,
        "peak_mem_bytes": peak, "achieved_tflops": flops / step_s / 1e12,
        "launches": launches, "launches_per_step": {k: v // n_steps for k, v in launches.items()},
    }
    log(f"  median step {step_s * 1e3:.1f} ms, {rec['audio_hours_per_s']:.4f} audio-h/s, "
        f"peak {peak / 2**30:.2f} GiB, {rec['achieved_tflops']:.1f} TFLOP/s "
        f"(bench.py accounting, 4x forward)")
    log(f"  launches {launches}")
    return rec, state, step, batch, gen, (grad_norms[0], after_one)


# ---------------------------------------------------------------------------
# Phase 4: the Muon flagship under attn_impl flash / flash_fwd / auto
# ---------------------------------------------------------------------------

FLAGSHIP_CONFIG = ROOT / "configs" / "config_large_v3_best_muon.yaml"
TRAIN_STEPS = 1000  # the cosine schedule's horizon (the runs stay in its warm-up)


def flagship_leg(name: str, attn_impl: str, layers, accum, steps: int, warmup: int,
                 stochastic_depth=None, optimizer_extra=None) -> dict:
    """One leg of the flagship: the shipped config with ``training.attn_impl``
    overridden (``layers``, ``accum``, ``stochastic_depth`` and
    ``optimizer_extra`` cut or vary a leg as its caller says), random weights
    from seed 0, microbatch 8 of synthetic 30 s audio, bf16 accumulator."""
    import torch
    from whisper_finetune_torch import config as C
    from whisper_finetune_torch.models import get_preset_dims, init_params
    from whisper_finetune_torch.models import whisper as W
    from whisper_finetune_torch.optim import get_optimizer, get_schedule
    from whisper_finetune_torch.optim.quantized import BLOCK, QMoment
    from whisper_finetune_torch.tools import first_slice as fs
    from whisper_finetune_torch.train import TrainState, make_train_step

    cfg = C.load_config(FLAGSHIP_CONFIG)
    cfg["training"]["attn_impl"] = attn_impl
    if stochastic_depth is not None:
        cfg["training"]["stochastic_depth"] = stochastic_depth
    if accum is not None:
        cfg["training"]["accum_grad_steps"] = accum
    cfg["optimizer"].update(optimizer_extra or {})
    accum = int(cfg["training"]["accum_grad_steps"])
    dims = get_preset_dims(cfg["model"]["init_name"])
    if layers is not None:
        dims = dims.replace(n_audio_layer=layers[0], n_text_layer=layers[1])
    B = 8

    model = init_params(dims, device="cuda", seed=0)
    leaves = [p for _, p in model.leaves()]
    fcfg = C.build_forward_config(cfg, is_lora_run=False, device="cuda")
    feat = C.build_featurize_config(cfg, dims.n_mels)
    schedule = get_schedule(cfg["lr_scheduler"], TRAIN_STEPS)
    tx, meta = get_optimizer(model.leaves(), cfg["optimizer"], schedule)
    state = TrainState(model, tx.init(leaves), 0)
    step = make_train_step(dims, fcfg, tx, float(cfg["training"]["label_smoothing"]),
                           feat_cfg=feat, max_grad_norm=cfg["training"]["max_grad_norm"],
                           accum_dtype="bfloat16", device="cuda")
    batch = fs.synthetic_batch(dims, accum, B)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    before = [p.detach()[(0,) * (p.dim() - 1)][:8].clone() for p in leaves]
    # auxiliary leaves the fused 8-bit AdamW kernel serves (none with float32 moments)
    aux_fused = sum(isinstance(mu, QMoment) and p.numel() % BLOCK == 0
                    for p, mu in zip(tx._pick("adamw", leaves), state.opt_state.adamw.mu))
    log(f"  [{name}] attn {fcfg.enc_attn}/{fcfg.dec_attn}/{fcfg.cross_attn}, "
        f"{dims.n_audio_layer}+{dims.n_text_layer} layers, accum {accum}, stochastic depth "
        f"{fcfg.sd_encoder}, deep SpecAugment {fcfg.dsa_apply}, {tx.labels.count('muon')} Muon + "
        f"{tx.labels.count('adamw')} AdamW leaves ({aux_fused} through fused_adamw8)")

    kernels = fs.reset_counts()
    losses, times, lrs = [], [], []
    n_steps = warmup + steps
    for i in range(n_steps):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        lrs.append((tx.muon.lr(state.opt_state.count), tx.adamw.lr(state.opt_state.count)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch, gen)
        loss = float(loss)  # syncs
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(loss)
        if i >= warmup:
            times.append(dt)
        log(f"  [{name}] step {i}: loss {loss:.4f}, {dt * 1e3:.1f} ms, lr {lrs[-1][0]:.3e}")
    launches = {fn.__name__: fn.launches for fn in kernels}
    enc_blocks, dec_blocks = W.encoder_forward.blocks_run, W.decoder_forward.blocks_run
    peak = torch.cuda.max_memory_allocated()

    # Attention sites the forwards ran through the kernels, by route.
    kernel_routes = ("splash", "flash", "flash_fwd")
    sites = (enc_blocks * (fcfg.enc_attn in kernel_routes)
             + dec_blocks * ((fcfg.dec_attn in kernel_routes) + (fcfg.cross_attn in kernel_routes)))
    bwd_sites = (enc_blocks * (fcfg.enc_attn in ("splash", "flash"))
                 + dec_blocks * ((fcfg.dec_attn in ("splash", "flash"))
                                 + (fcfg.cross_attn in ("splash", "flash"))))
    expect = {"attn_fwd": 2 * sites,  # forward + remat recompute of every kept block
              "attn_bwd": bwd_sites,
              "fused_adamw8_leaf": aux_fused * n_steps}
    if launches != expect:
        raise AssertionError(f"[{name}] launch counts {launches} != expected {expect} "
                             f"(blocks run: encoder {enc_blocks}, decoder {dec_blocks})")
    total_blocks = n_steps * accum * (dims.n_audio_layer + dims.n_text_layer)
    if fcfg.sd_encoder == 0.0 and enc_blocks + dec_blocks != total_blocks:
        raise AssertionError(f"[{name}] {enc_blocks + dec_blocks} blocks run, {total_blocks} expected")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[{name}] non-finite loss {losses}")
    if abs(losses[0] - math.log(dims.n_vocab)) > 0.5:
        raise AssertionError(f"[{name}] first loss {losses[0]} far from ln(V)")
    changed = sum(not torch.equal(b, p.detach()[(0,) * (p.dim() - 1)][:8])
                  for b, p in zip(before, leaves))
    if changed != len(leaves):
        raise AssertionError(f"[{name}] only {changed} of {len(leaves)} leaves changed")
    if state.step != n_steps or state.opt_state.count != n_steps:
        raise AssertionError(f"[{name}] step {state.step}, count {state.opt_state.count}")
    # Cosine schedule inside its 64-step warm-up: lr = base * count / 64,
    # from the optimizer's own count, for Muon and the auxiliary AdamW.
    warm = float(cfg["lr_scheduler"]["warmup_steps"])
    for c, (lr_m, lr_a) in enumerate(lrs):
        want_m = float(cfg["optimizer"]["muon_params"]["lr"]) * c / warm
        want_a = float(cfg["optimizer"]["params"]["lr"]) * c / warm
        if abs(lr_m - want_m) > 1e-6 * max(want_m, 1e-12) or abs(lr_a - want_a) > 1e-6 * max(want_a, 1e-12):
            raise AssertionError(f"[{name}] lr at count {c}: {lr_m}, {lr_a} != {want_m}, {want_a}")

    # The optimizer's one-pass update alone (Muon's Newton-Schulz and the
    # auxiliary AdamW over every leaf), on fresh bf16 gradient sums.
    grads = [(torch.randn(p.shape, generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
             for p in leaves]
    g_scale = torch.tensor(1.0 / accum, device="cuda")
    update_times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.fused_apply(grads, state.opt_state, leaves, g_scale=g_scale)
        torch.cuda.synchronize()
        update_times.append(time.perf_counter() - t0)
    del grads

    step_s = statistics.median(times)
    rec = {
        "leg": name, "update_s_median": statistics.median(update_times), "attn_impl": attn_impl, "layers": [dims.n_audio_layer, dims.n_text_layer],
        "microbatch": B, "accum": accum, "steps_timed": steps, "warmup_steps": warmup,
        "step_s_median": step_s, "step_s_max": max(times), "step_s_all": times,
        "losses": losses, "lr": lrs, "audio_hours_per_s": accum * B * 30 / 3600 / step_s,
        "peak_mem_bytes": peak, "launches": launches,
        "blocks_run": {"encoder": enc_blocks, "decoder": dec_blocks},
        "blocks_possible": total_blocks, "lr_metadata": meta,
    }
    log(f"  [{name}] median step {step_s * 1e3:.1f} ms (max {max(times) * 1e3:.1f}), "
        f"{rec['audio_hours_per_s']:.4f} audio-h/s, peak {peak / 2**30:.2f} GiB, blocks run "
        f"{enc_blocks}+{dec_blocks} of {total_blocks}, optimizer update alone "
        f"{rec['update_s_median'] * 1e3:.1f} ms, launches {launches}")
    del state, step, model, leaves, batch, before, tx
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Phase 5: the model layer: remat policies, LoRA, layer surgery
# ---------------------------------------------------------------------------

SCRATCH = ROOT / "build" / "chip_smoke"  # .pt files of the legs (gitignored)
REMAT_POLICIES = ("dots", "attn", "save:enc_mlp_h", "offload:enc_mlp_h")  # against full
GB = 1e9
# Device bytes a policy keeps over full: bf16, B=8, T=1500/448, D=1280,
# F=5120, 32+32 layers (PERF.md §6, the predictions).
REMAT_KEEPS = {"dots": 32 * 276.5e6 + 32 * 162.4e6, "attn": 32 * 64.2e6,
               "save:enc_mlp_h": 32 * 122.9e6, "offload:enc_mlp_h": 0.0}
LAYER_MLP_H = 8 * 1500 * 5120 * 2  # one encoder layer's fc1 output, bf16
# First-step gradient norms, one per layer of a stacked leaf, against the
# first slice's: the largest relative difference. dQ's summation order alone
# moves them by up to 3.2e-3 (full against full) and every policy by up to
# 3.5e-3 (PERF.md §6); a site lost in one layer moves that layer's norms
# by O(1) (fc2's weight gradient is fc1's output through the GELU;
# tests/test_torch_remat.py plants such a fault: > 0.5).
GRAD_NORM_TOL = 2e-2
# Parameters after one step against the first slice's: the first 8-bit
# AdamW update is about lr·sign(g) per element, so two updates differ by up
# to 2 lr whatever the gradients (measured, PERF.md §6: 3.986e-5 for full
# against full and every policy alike). This bounds the update; the
# gradients are held by GRAD_NORM_TOL.
REMAT_PARAM_TOL = 3 * 2e-5


def _param_diff(model, reference) -> dict:
    """Largest |p - ref| over all leaves and the count of elements that
    differ (the reference on the host, one leaf at a time to the card)."""
    worst, n_diff, n = 0.0, 0, 0
    for (_, p), ref in zip(model.leaves(), reference):
        d = (p.detach() - ref.to(p.device)).abs()
        worst = max(worst, d.max().item())
        n_diff += int((d > 0).sum().item())
        n += d.numel()
    return {"max_abs": worst, "n_diff": n_diff, "n": n}


def remat_leg(main_rec: dict, full_first_step, batch) -> dict:
    """The first slice (large-v3, batch 8, splash, 8-bit AdamW) under each
    remat policy in turn, from the main path's weights, batch and SpecAugment
    draws: 1 warm-up + 2 timed steps each. Held against the main path's
    ``full`` run: the first loss bit-equal, the first step's gradients
    (per-layer norms within GRAD_NORM_TOL) and parameters (within
    REMAT_PARAM_TOL), the launches a step
    (128 / 64 / 43), and the peak moving by what the policy keeps (an offload
    stays within one layer's fc1 output of full on the device and stages it
    all to the host)."""
    import torch
    from whisper_finetune_torch.models import get_preset_dims
    from whisper_finetune_torch.ops.remat import offload_to_host
    from whisper_finetune_torch.tools import first_slice as fs

    dims = get_preset_dims("large-v3")
    full_peak = main_rec["peak_mem_bytes"]
    full_norms, after_one = full_first_step
    out = {}
    for policy in REMAT_POLICIES:
        state, step, tx, fused = fs.build(dims, policy)
        norms = fs.record_grad_norms(tx, [path for path, _ in state.model.leaves()])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        offload_to_host.bytes = 0
        params = {}
        state, rec = fs.run_steps(f"remat {policy}", step, state, batch, gen, 1, 2, log=log,
                                  after_first=lambda st: params.update(
                                      _param_diff(st.model, after_one)))
        grad_diff = fs.norms_rel_diff(norms[0], full_norms)
        rec.update(policy=policy, grad_norm_rel_diff=grad_diff, param_diff_after_one=params,
                   offloaded_bytes_per_step=offload_to_host.bytes / 3,
                   peak_over_full_bytes=rec["peak_mem_bytes"] - full_peak)
        out[policy] = rec
        del state, step, tx
        torch.cuda.empty_cache()
        sites = dims.n_audio_layer + dims.n_text_layer
        expect = {"attn_fwd": 2 * sites * 3, "attn_bwd": sites * 3, "fused_adamw8_leaf": fused * 3}
        if rec["launches"] != expect:
            raise AssertionError(f"[remat {policy}] launches {rec['launches']} != {expect}")
        if rec["losses"][0] != main_rec["losses"][0]:
            raise AssertionError(f"[remat {policy}] first loss {rec['losses'][0]!r} != the first "
                                 f"slice's {main_rec['losses'][0]!r}")
        if not (grad_diff <= GRAD_NORM_TOL and params["max_abs"] <= REMAT_PARAM_TOL
                and all(math.isfinite(x) for x in rec["losses"])):
            raise AssertionError(f"[remat {policy}] first-step gradient norms differ from full's "
                                 f"by {grad_diff} (limit {GRAD_NORM_TOL}), parameters after one "
                                 f"step by {params} (limit {REMAT_PARAM_TOL}) or losses "
                                 f"{rec['losses']}")
        delta, keeps = rec["peak_over_full_bytes"], REMAT_KEEPS[policy]
        log(f"  [remat {policy}] median {rec['step_s_median'] * 1e3:.1f} ms vs full "
            f"{main_rec['step_s_median'] * 1e3:.1f} ms, peak {rec['peak_mem_bytes'] / 2**30:.2f} "
            f"GiB, over full {delta / GB:+.3f} GB (predicted {keeps / GB:+.3f}), offloaded "
            f"{rec['offloaded_bytes_per_step'] / GB:.3f} GB a step, first-step gradient norms "
            f"vs full: max rel diff {grad_diff:.3e}; params after one step: max |d| "
            f"{params['max_abs']:.3e} in {params['n_diff']} of {params['n']}")
        # Measured (PERF.md §6): each kept policy 0.13-0.15 GB under its
        # reckoning (full's own peak holds one layer's recompute), offload
        # 2 MB under full; the limit is two layers' fc1 output either way.
        ok = abs(delta - keeps) <= 2 * LAYER_MLP_H
        if policy.startswith("offload:"):
            ok = (abs(delta) <= LAYER_MLP_H
                  and rec["offloaded_bytes_per_step"] >= 32 * LAYER_MLP_H)
        if not ok:
            raise AssertionError(f"[remat {policy}] peak over full {delta / GB:.3f} GB, "
                                 f"offloaded {rec['offloaded_bytes_per_step'] / GB:.3f} GB a "
                                 f"step: not what the policy keeps ({keeps / GB:.3f} GB)")
    return out


LORA_CONFIG = ROOT / "configs" / "config_small_lora.yaml"


def lora_leg() -> dict:
    """``configs/config_small_lora.yaml`` as shipped (whisper-small, rank 16,
    alpha 32, dropout 0, batch 2 x accumulation 8, float32 AdamW lr 1e-3,
    cosine, ``attn_impl: auto``), random base weights written as an fp16
    ``.pt`` and read back through ``config.build_model`` (``load_model`` of
    the path); 1 warm-up + 2 timed steps. Asserted: launches 384 / 192 / 0 a
    step, base leaves bit-equal after the steps, every adapter B non-zero,
    merged and runtime-LoRA logits bit-equal in one eval forward, and the
    merge CLI's fp16 file (the trained model saved in float32, merged on the
    card) equal to fp16 of that forward's merge, bit for bit."""
    import torch
    from whisper_finetune_torch import config as C
    from whisper_finetune_torch.models import (forward_impl, get_preset_dims, init_params,
                                               load_checkpoint, save_checkpoint)
    from whisper_finetune_torch.models.lora import merge_lora
    from whisper_finetune_torch.models.whisper import flatten
    from whisper_finetune_torch.ops.spec_augment import featurize_impl
    from whisper_finetune_torch.optim import get_optimizer, get_schedule
    from whisper_finetune_torch.scripts.merge_lora_weights import main as merge_cli
    from whisper_finetune_torch.tools import first_slice as fs
    from whisper_finetune_torch.train import TrainState, make_train_step, trainable_leaves

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: a@b would not be float32")
    cfg = C.load_config(LORA_CONFIG)
    base_dims = get_preset_dims(cfg["model"]["init_name"])
    base_path = SCRATCH / "small.pt"
    save_checkpoint(str(base_path), init_params(base_dims, device="cuda", seed=0), base_dims)
    cfg["model"]["init_name"] = str(base_path)
    model, dims = C.build_model(cfg, device="cuda")
    lcfg = C._lora_hparams(cfg["model"]["lora_config"])
    fcfg = C.build_forward_config(cfg, is_lora_run=True, device="cuda")
    feat = C.build_featurize_config(cfg, dims.n_mels)
    t = cfg["training"]
    accum, B = int(t["accum_grad_steps"]), int(cfg["dataset"]["batch_size"])
    schedule = get_schedule(cfg["lr_scheduler"], TRAIN_STEPS)
    tx, _ = get_optimizer(trainable_leaves(model), cfg["optimizer"], schedule, is_lora_run=True)
    state = TrainState(model, tx.init([p for _, p in trainable_leaves(model)]), 0)
    step = make_train_step(dims, fcfg, tx, float(t["label_smoothing"]), feat_cfg=feat,
                           max_grad_norm=t["max_grad_norm"], accum_dtype=t["grad_accum_dtype"],
                           device="cuda")
    batch = fs.synthetic_batch(dims, accum, B, seed=1)
    base = {path: p.detach().clone() for path, p in model.leaves() if not p.requires_grad}
    n_lora = len(trainable_leaves(model))
    log(f"  [lora] small {dims.n_audio_layer}+{dims.n_text_layer} layers, rank {lcfg['rank']}, "
        f"alpha {lcfg['alpha']}, scale {fcfg.lora_scale}, {n_lora} adapter leaves "
        f"({sum(p.numel() for _, p in trainable_leaves(model))} parameters) of "
        f"{len(model.leaves())}, attn {fcfg.enc_attn}/{fcfg.dec_attn}/{fcfg.cross_attn}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state, rec = fs.run_steps("lora", step, state, batch, gen, 1, 2, log=log)

    sites = dims.n_audio_layer + dims.n_text_layer
    expect = {"attn_fwd": 2 * sites * accum * 3, "attn_bwd": sites * accum * 3,
              "fused_adamw8_leaf": 0}
    if rec["launches"] != expect:
        raise AssertionError(f"[lora] launches {rec['launches']} != {expect}")
    if abs(rec["losses"][0] - math.log(dims.n_vocab)) > 0.5:
        raise AssertionError(f"[lora] first loss {rec['losses'][0]} far from ln(V)")
    params = dict(model.leaves())
    if not all(torch.equal(params[path], b) for path, b in base.items()):
        raise AssertionError("[lora] a frozen base leaf moved")
    zero_b = [path for path, p in trainable_leaves(model) if path[-1] == "b"
              and not bool((p.detach() != 0).any())]
    if zero_b:
        raise AssertionError(f"[lora] adapters B still zero: {zero_b[:3]}")

    # One eval forward: runtime LoRA against the merged model.
    with torch.no_grad():
        mel = featurize_impl(batch["audio"][0], batch["crop_frames"][0], None, feat)
        tok = batch["dec_input"][0]
        runtime = forward_impl(model.params(), mel, tok, dims, fcfg)
        merged = merge_lora(model.params(), lcfg["rank"], lcfg["alpha"])
        plain = dataclasses.replace(fcfg, lora_scale=0.0, lora_dropout=0.0)
        merged_logits = forward_impl(merged, mel, tok, dims, plain)
    if not torch.equal(runtime, merged_logits):
        raise AssertionError(f"[lora] merged logits differ from runtime LoRA by "
                             f"{(runtime - merged_logits).abs().max().item()}")

    # The merge CLI, on the card, from the trained model saved in float32.
    lora_path, merged_path = SCRATCH / "small_lora.pt", SCRATCH / "small_merged.pt"
    save_checkpoint(str(lora_path), model, dims, dtype=torch.float32)
    t0 = time.perf_counter()
    merge_cli(str(lora_path), str(merged_path), test_merge=True, rank=lcfg["rank"],
              alpha=lcfg["alpha"])
    cli_s = time.perf_counter() - t0
    raw = torch.load(merged_path, weights_only=True)
    reloaded, rdims = load_checkpoint(str(merged_path), device="cuda")
    if rdims != dims or any(v.dtype != torch.float16 for v in raw["model_state_dict"].values()):
        raise AssertionError(f"[lora] merged file dims {rdims} or dtypes wrong")
    mism = [path for (path, a), (_, b) in zip(reloaded.leaves(), flatten(merged))
            if not torch.equal(a, b.half().float())]
    if mism:
        raise AssertionError(f"[lora] merged file differs from fp16 of the card's merge at "
                             f"{mism[:3]}")
    for f in (base_path, lora_path, merged_path):
        f.unlink()
    rec.update(merge_cli_s=cli_s, merged_file_bit_equal=True, adapter_leaves=n_lora,
               layers=[dims.n_audio_layer, dims.n_text_layer], microbatch=B, accum=accum,
               logits_bit_equal=True)
    log(f"  [lora] median {rec['step_s_median'] * 1e3:.1f} ms, peak "
        f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB, launches {rec['launches']}; merged logits "
        f"bit-equal; merge CLI {cli_s:.1f} s, its fp16 file bit-equal to fp16(merge)")
    del state, step, model, batch
    torch.cuda.empty_cache()
    return rec


def surgery_leg(batch) -> dict:
    """``init_name: whisper-4832``: a random large-v3 written as an fp16
    ``.pt`` (3.1 GB) into ``$WHISPER_CHECKPOINT_DIR``, read through
    ``config.build_model`` (``load_model`` of the base, then resized to 48
    encoder and 32 decoder layers), then the first slice's step (batch 8,
    splash, 8-bit AdamW): 1 warm-up + 2 timed steps. Asserted: launches
    160 / 80 / 43 a step; the resized model saves and reloads as an fp16
    ``.pt`` with 48 encoder layers, equal to its fp16 rounding."""
    import os

    import torch
    from whisper_finetune_torch import config as C
    from whisper_finetune_torch.models import (get_preset_dims, init_params, load_checkpoint,
                                               save_checkpoint)
    from whisper_finetune_torch.tools import first_slice as fs

    base_dims = get_preset_dims("large-v3")
    base_path = SCRATCH / "large-v3.pt"
    model = init_params(base_dims, device="cuda", seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(base_path), model, base_dims)
    write_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    os.environ["WHISPER_CHECKPOINT_DIR"] = str(SCRATCH)
    try:
        t0 = time.perf_counter()
        model, dims = C.build_model(C.with_defaults({"model": {"init_name": "whisper-4832"}}),
                                    device="cuda")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    finally:
        del os.environ["WHISPER_CHECKPOINT_DIR"]
    file_gb = base_path.stat().st_size / GB
    base_path.unlink()
    if (dims.n_audio_layer, dims.n_text_layer) != (48, 32):
        raise AssertionError(f"[surgery] resized to {dims}")
    state, step, _, fused = fs.build(dims, model=model)
    log(f"  [surgery] whisper-4832: {sum(p.numel() for _, p in model.leaves())} parameters, "
        f"{dims.n_audio_layer}+{dims.n_text_layer} layers; large-v3 .pt {file_gb:.2f} GB "
        f"written in {write_s:.1f} s, read and resized in {read_s:.1f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state, rec = fs.run_steps("surgery", step, state, batch, gen, 1, 2, log=log)
    sites = dims.n_audio_layer + dims.n_text_layer
    expect = {"attn_fwd": 2 * sites * 3, "attn_bwd": sites * 3, "fused_adamw8_leaf": fused * 3}
    if rec["launches"] != expect or fused != 43:
        raise AssertionError(f"[surgery] launches {rec['launches']} != {expect}")
    if not all(math.isfinite(x) for x in rec["losses"]) or abs(
            rec["losses"][0] - math.log(dims.n_vocab)) > 0.5:
        raise AssertionError(f"[surgery] losses {rec['losses']}")

    resized_path = SCRATCH / "whisper-4832.pt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(str(resized_path), model, dims)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, bdims = load_checkpoint(str(resized_path), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resized_gb = resized_path.stat().st_size / GB
    resized_path.unlink()
    if bdims != dims or bdims.n_audio_layer != 48:
        raise AssertionError(f"[surgery] reloaded dims {bdims}")
    if not all(torch.equal(b, a.detach().half().float())
               for (_, a), (_, b) in zip(model.leaves(), back.leaves())):
        raise AssertionError("[surgery] reloaded weights differ from fp16(weights)")
    rec.update(layers=[48, 32], base_pt_gb=file_gb, base_write_s=write_s,
               base_read_resize_s=read_s, resized_pt_gb=resized_gb, resized_write_s=save_s,
               resized_read_s=load_s)
    log(f"  [surgery] median {rec['step_s_median'] * 1e3:.1f} ms, peak "
        f"{rec['peak_mem_bytes'] / 2**30:.2f} GiB, launches {rec['launches']}; resized .pt "
        f"{resized_gb:.2f} GB written in {save_s:.1f} s, read in {load_s:.1f} s")
    del state, step, model, back
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Phase 6: the training driver end to end
# ---------------------------------------------------------------------------

DRIVER_CONFIG = ROOT / "configs" / "DEBUG.yaml"
DEBUG_DS = SCRATCH / "debug_ds"  # make_debug_dataset.py --n 64: the driver and ddp legs
DRIVER_KEYS = ROOT / "tests" / "driver_metrics_keys.json"  # pinned from the JAX driver
DRIVER_LOSS_TOL = 0.25  # first train loss against the step-0 validation NLL (0.018 on an H100: PERF.md)


def driver_leg(first_slice_step_s: float) -> dict:
    """``whisper_finetune_torch.scripts.finetune.main`` in this process on a
    config derived from ``configs/DEBUG.yaml``: ``init_name: large-v3`` at
    full width (32 + 32 layers, random weights), batch 8, accumulation 1,
    8-bit AdamW, ``attn_impl: auto``, full remat, bf16; the dataset of
    ``tools/make_debug_dataset.py --n 64`` (64 train / 16 validation rows)
    written under ``build/chip_smoke/``, so 8 optimizer steps; eval at step
    0 and step 8 on 8 validation rows (batches of 4). Asserted: the launch
    counts (each train step 128 / 64 / 43 as the first slice's, each eval
    batch one forward a site), finite losses with the first within 0.25 of
    the step-0 validation NLL and within 1 of ln V, the ``metrics.jsonl``
    keys equal to those the CPU test pins from the JAX driver, ``val/*`` at
    step 0 and 8, and ``last_model.pt`` read back by ``load_model`` equal to
    fp16 of the final parameters."""
    import os
    import shutil
    import tempfile

    import torch
    import yaml

    from tools.make_debug_dataset import main as make_dataset  # ROOT is on sys.path (main)
    from whisper_finetune_torch.models import load_model
    from whisper_finetune_torch.optim.quantized import BLOCK, QMoment
    from whisper_finetune_torch.scripts import finetune
    from whisper_finetune_torch.tools import first_slice as fs

    tmp = Path(tempfile.mkdtemp(prefix="driver_", dir=SCRATCH))
    make_dataset(str(DEBUG_DS), n=64)  # kept for the ddp leg, which removes it
    config = yaml.safe_load(DRIVER_CONFIG.read_text())
    config["model"]["init_name"] = "large-v3"
    config["dataset"].update(train_datasets=[str(DEBUG_DS)], val_datasets=[str(DEBUG_DS)],
                             batch_size=8, batch_size_eval=4, select_n_per_v_ds=[8])
    config["training"].update(accum_grad_steps=1, epochs=1, eval_steps=1.0)
    config["optimizer"]["8bit"] = True
    config["save_dir"] = str(tmp / "out")

    saves = []
    save_checkpoint = finetune.save_checkpoint

    def timed_save(path, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, *args, **kwargs)
        saves.append({"file": Path(path).name, "s": time.perf_counter() - t0,
                      "gb": Path(path).stat().st_size / GB})

    random_init = os.environ.get("WFT_ALLOW_RANDOM_INIT")
    os.environ["WFT_ALLOW_RANDOM_INIT"] = "1"
    finetune.save_checkpoint = timed_save
    kernels = fs.reset_counts()
    t0 = time.perf_counter()
    try:
        state, run_dir = finetune.main(config, device="cuda")
    finally:
        finetune.save_checkpoint = save_checkpoint
        if random_init is None:
            del os.environ["WFT_ALLOW_RANDOM_INIT"]
        else:
            os.environ["WFT_ALLOW_RANDOM_INIT"] = random_init
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated()

    model, dims = state.model, state.model.dims
    records = [json.loads(line) for line in open(Path(run_dir) / "metrics.jsonl")]
    train = [r for r in records if "Train loss" in r]
    n_steps = len(train)
    leaves = [p for _, p in model.leaves()]
    fused = sum(isinstance(mu, QMoment) and p.numel() % BLOCK == 0
                for p, mu in zip(leaves, state.opt_state.mu))
    sites = dims.n_audio_layer + dims.n_text_layer  # encoder self + cross
    eval_batches = 2 * 2  # evals at step 0 and 8, each 8 rows in batches of 4
    expect = {"attn_fwd": 2 * sites * n_steps + sites * eval_batches,
              "attn_bwd": sites * n_steps, "fused_adamw8_leaf": fused * n_steps}
    if n_steps != 8 or fused != 43 or launches != expect:
        raise AssertionError(f"[driver] {n_steps} steps, launches {launches} != {expect}")
    losses = [r["Train loss"] for r in train]
    (val0,) = [r["val/debug_loss"] for r in records if r["_step"] == 0 and "val/debug_loss" in r]
    # At random init the debug texts' few, repeated targets sit ln V + 0.6
    # (not the ln V +- 0.5 of uniform random targets): the first loss is held
    # to the eval step's own mean target NLL on the validation rows before
    # training (a separate path, no smoothing or SpecAugment), and to ln V
    # within 1.
    if (not all(math.isfinite(x) for x in losses) or abs(losses[0] - val0) > DRIVER_LOSS_TOL
            or abs(losses[0] - math.log(dims.n_vocab)) > 1.0):
        raise AssertionError(f"[driver] losses {losses}, step-0 validation NLL {val0}")
    keys = sorted(set().union(*records))
    want = json.loads(DRIVER_KEYS.read_text())
    if keys != want:
        raise AssertionError(f"[driver] metrics.jsonl keys differ from the JAX driver's: "
                             f"extra {sorted(set(keys) - set(want))}, "
                             f"missing {sorted(set(want) - set(keys))}")
    val_steps = [r["_step"] for r in records if "val/macro_wer" in r]
    if val_steps != [0, n_steps]:
        raise AssertionError(f"[driver] val/* at steps {val_steps}")
    t0 = time.perf_counter()
    back, _ = load_model(str(Path(run_dir) / "last_model.pt"), device="cuda")
    read_s = time.perf_counter() - t0
    if not all(torch.equal(b, a.detach().half().float())
               for (_, a), (_, b) in zip(model.leaves(), back.leaves())):
        raise AssertionError("[driver] last_model.pt differs from fp16(final parameters)")

    step_times = [r["perf/step_time_s"] for r in train if "perf/step_time_s" in r]
    # the last step builds no next batch
    builds = [r["perf/host_batch_build_s"] for r in train[1:-1]]
    rec = {
        "model": "large-v3", "batch": 8, "steps": n_steps, "losses": losses,
        "step_s_all": step_times, "step_s_median": statistics.median(step_times),
        "host_batch_build_s_all": builds,
        "host_batch_build_s_median": statistics.median(builds),
        "first_slice_step_s_median": first_slice_step_s, "peak_mem_bytes": peak,
        "saves": saves, "last_model_read_s": read_s, "wall_s": wall_s,
        "val_loss": [r["val/debug_loss"] for r in records if "val/debug_loss" in r],
        "launches": launches,
    }
    log(f"  [driver] {n_steps} steps in {wall_s:.1f} s (eval, saves and set-up included); "
        f"losses {losses[0]:.4f} .. {losses[-1]:.4f}; launches {launches}")
    log(f"  [driver] median perf/step_time_s {rec['step_s_median'] * 1e3:.1f} ms, "
        f"perf/host_batch_build_s {rec['host_batch_build_s_median'] * 1e3:.1f} ms; "
        f"first slice {first_slice_step_s * 1e3:.1f} ms; peak {peak / 2**30:.2f} GiB; saves "
        + ", ".join(f"{x['file']} {x['gb']:.2f} GB in {x['s']:.1f} s" for x in saves)
        + f"; last_model.pt read in {read_s:.1f} s ({smi_line()})")
    del state, model, back
    shutil.move(str(Path(run_dir) / "last_model.pt"), str(DRIVER_PT))  # the decode leg's CLI
    shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Phase 7: data parallelism: ZeRO-1 across two ranks on the one card
# ---------------------------------------------------------------------------

DDP_WORLD = 2
DDP_LR = 1e-4  # configs/DEBUG.yaml's AdamW lr; the schedule's factor is 1 at the first update
DDP_SAMPLE = 65536  # parameter elements compared a leaf (all of a smaller leaf)
DDP_SAMPLE_BLOCKS = 256  # 8-bit blocks compared a moment
# Parameters after one step against the one-rank reference: the first 8-bit
# AdamW update is about lr·sign(g) an element, so where the two runs'
# gradients differ in sign (near-zero gradients; dQ's summation order makes
# the backward non-deterministic) an element moves by up to 2 lr: the remat
# leg's bound, REMAT_PARAM_TOL's 3 lr, holds here too.
DDP_PARAM_TOL = 3 * DDP_LR
DDP_PEAK_TOL = 0.3e9  # each rank's peak against the reckoning (PERF.md §6, PR 7)
DDP_NU_FLOOR = 1 + 4 * 254 // 6  # the log code of 1% of a block's max second moment
# After step 1, against the reference: the share of sampled parameters
# beyond 15% of lr and of codes more than 1 level apart (PERF.md §6, PR 7:
# about 0.1% and 0.06% measured on the card).
DDP_OFF_SHARE = 0.01


def ddp_config(accum: int, zero: bool, save_dir: str) -> dict:
    """``configs/DEBUG.yaml`` as the driver leg turns it (large-v3 at full
    width, batch 8 a rank, 8-bit AdamW, ``attn_impl: auto``, full remat,
    bf16, the 64 debug rows, eval on 8 validation rows in batches of 4),
    trimmed to 3 optimizer steps of 16 samples (epochs 0.75) with global
    ``accum_grad_steps`` ``accum``. No per-rank random draw enters (no
    SpecAugment, no prompts, no timestamp coin: a sample's coins are seeded
    by its position in its rank's stream), and no warm-up, so the first
    update moves the parameters."""
    import yaml

    config = yaml.safe_load(DRIVER_CONFIG.read_text())
    config["model"]["init_name"] = "large-v3"
    config["dataset"].update(train_datasets=[str(DEBUG_DS)], val_datasets=[str(DEBUG_DS)],
                             batch_size=8, batch_size_eval=4, select_n_per_v_ds=[8],
                             prompt_use_rate=0.0, no_timestamp_training=True)
    config["training"].update(accum_grad_steps=accum, epochs=0.75, eval_steps=1.0,
                              zero_shard_optimizer=zero, save_train_state=zero)
    config["augmentation"]["spec_augment"]["apply"] = False
    config["lr_scheduler"]["warmup_steps"] = 0
    config["optimizer"]["8bit"] = True
    config["save_dir"] = save_dir
    return config


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _bit_checksums(model) -> list:
    """Two integer sums a leaf over its float32 bits (plain, and weighted by
    position): equal on two ranks where the leaves are bit-equal."""
    import torch

    out = []
    for _, p in model.leaves():
        bits = p.detach().reshape(-1).view(torch.int32)
        s1 = s2 = 0
        for i, chunk in enumerate(bits.split(1 << 24)):
            c = chunk.long()
            w = torch.arange(c.numel(), device=c.device).remainder_(65521).add_(1 + i)
            s1 += int(c.sum())
            s2 += int((c * w).sum())
        out.append((s1, s2))
    return out


def _samples(model, tx, opt_state, flags) -> dict:
    """The parameters at fixed sampled positions of every leaf, and the
    8-bit codes of fixed sampled blocks of every quantized moment that this
    rank holds (its ZeRO rows of blocks where ``flags`` says, else all)."""
    import torch

    from whisper_finetune_torch import parallel
    from whisper_finetune_torch.optim.quantized import QMoment
    from whisper_finetune_torch.train.step import trainable_leaves
    from whisper_finetune_torch.train.zero import owned_moments

    leaves = [p for _, p in trainable_leaves(model)]
    n, r = parallel.world(), parallel.rank()
    params, codes = [], []
    for i, p in enumerate(leaves):
        pos = torch.randint(p.numel(), (min(p.numel(), DDP_SAMPLE),),
                            generator=torch.Generator().manual_seed(i))
        params.append(p.detach().reshape(-1)[pos.to(p.device)].cpu())
    for i, moments in enumerate(owned_moments(tx, opt_state, len(leaves))):
        for j, m in enumerate(moments):
            if not isinstance(m, QMoment):
                continue
            nb, first = m.codes.shape[0], 0
            if flags[i]:
                nb, first = nb * n, r * nb
            blocks = torch.randint(nb, (DDP_SAMPLE_BLOCKS,),
                                   generator=torch.Generator().manual_seed(1000 + i)).unique()
            mine = blocks[(blocks >= first) & (blocks < first + m.codes.shape[0])]
            codes.append({"leaf": i, "moment": j, "blocks": mine,
                          "codes": m.codes[(mine - first).to(m.codes.device)].cpu()})
    return {"params": params, "codes": codes}


def ddp_run(config: dict, device: str, backend: str) -> dict:
    """``finetune.main(config, device, backend)`` in this process, recording
    each step (entry time, collective calls and bytes, bit checksums of the
    parameters) and the sampled parameters and codes after step 1; kernel
    counters zeroed just before ``main`` and read just after; the save of
    the train state timed. Returns the record and the final state."""
    import torch

    from whisper_finetune_torch import parallel
    from whisper_finetune_torch.optim.quantized import BLOCK, QMoment
    from whisper_finetune_torch.scripts import finetune
    from whisper_finetune_torch.tools import first_slice as fs
    from whisper_finetune_torch.train.step import trainable_leaves
    from whisper_finetune_torch.train.zero import owned_moments, zero_opt_partition

    steps, saves, ctx = [], [], {}
    make_train_step, get_optimizer = finetune.make_train_step, finetune.get_optimizer
    save_train_state = finetune.save_train_state

    def recording_optimizer(*args, **kwargs):
        ctx["tx"], meta = get_optimizer(*args, **kwargs)
        return ctx["tx"], meta

    def recording_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)
        zero = kwargs.get("zero_shard", False)

        def run(state, batch, generator=None):
            parallel.reset_counts()
            t0 = time.perf_counter()
            out = step(state, batch, generator)
            new = out[0]
            _sync()
            rec = {"t0": t0, "s": time.perf_counter() - t0, "comm": parallel.counts(),
                   "checksums": _bit_checksums(new.model)}
            if not steps:
                leaves = [p for _, p in trainable_leaves(new.model)]
                flags = (zero_opt_partition(ctx["tx"], new.opt_state, leaves, parallel.world())
                         if zero and parallel.world() > 1 else [False] * len(leaves))
                rec["samples"] = _samples(new.model, ctx["tx"], new.opt_state, flags)
            steps.append(rec)
            return out

        return run

    def timed_save(path, state, tx, zero_shard=False):
        _sync()
        t0 = time.perf_counter()
        save_train_state(path, state, tx, zero_shard)
        saves.append({"path": str(path), "s": time.perf_counter() - t0})

    finetune.make_train_step, finetune.get_optimizer = recording_step, recording_optimizer
    finetune.save_train_state = timed_save
    kernels = fs.reset_counts()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    try:
        state, run_dir = finetune.main(config, device=device, backend=backend)
    finally:
        finetune.make_train_step, finetune.get_optimizer = make_train_step, get_optimizer
        finetune.save_train_state = save_train_state
    launches = {fn.__name__: fn.launches for fn in kernels}
    leaves = [p for _, p in trainable_leaves(state.model)]
    flags = (zero_opt_partition(ctx["tx"], state.opt_state, leaves, parallel.world())
             if config["training"]["zero_shard_optimizer"] and parallel.world() > 1
             else [False] * len(leaves))
    moments = owned_moments(ctx["tx"], state.opt_state, len(leaves))
    fused = sum(isinstance(ms[0], QMoment) and (p.numel() // (parallel.world() if f else 1))
                % BLOCK == 0 for p, ms, f in zip(leaves, moments, flags))
    state_bytes = sum(x.numel() * x.element_size() for ms in moments for m in ms
                      for x in (m if isinstance(m, QMoment) else (m,)))
    records = ([json.loads(line) for line in open(Path(run_dir) / "metrics.jsonl")]
               if (Path(run_dir) / "metrics.jsonl").exists() else [])
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    return {"steps": steps, "saves": saves, "launches": launches, "fused_per_step": fused,
            "peak_mem_bytes": peak, "state_bytes": state_bytes,
            "n_sharded": sum(flags), "records": records, "run_dir": run_dir,
            "rank": parallel.rank(), "world": parallel.world()}, state, ctx["tx"]


def ddp_rank(spec_path: str) -> int:
    """One rank of the two-rank run (``chip_smoke.py --ddp-rank spec.json``,
    started by :func:`ddp_leg` with torchrun's environment): the run, then
    the train state rank 0 wrote read back into a fresh state (timed) and
    held bit-equal to this rank's final state."""
    import torch

    sys.path.insert(0, str(ROOT))
    spec = json.loads(Path(spec_path).read_text())
    import whisper_finetune_torch.runtime as rt
    from whisper_finetune_torch.models import init_params
    from whisper_finetune_torch.optim import get_optimizer
    from whisper_finetune_torch.optim.quantized import QMoment
    from whisper_finetune_torch.train.state_io import load_train_state
    from whisper_finetune_torch.train.step import TrainState
    from whisper_finetune_torch.train.zero import owned_moments, zero_shard_state

    rec, state, tx = ddp_run(spec["config"], spec["device"], spec["backend"])
    rt.barrier()
    (path,) = {x["path"] for x in rec["saves"]}
    leaves = [p for _, p in state.model.leaves()]
    fresh = init_params(state.model.dims, device=spec["device"], seed=1)
    fresh_tx, _ = get_optimizer(fresh.leaves(), spec["config"]["optimizer"])
    fresh_leaves = [p for _, p in fresh.leaves()]
    template = TrainState(fresh, zero_shard_state(fresh_tx, fresh_tx.init(fresh_leaves),
                                                  fresh_leaves), 0)
    _sync()
    t0 = time.perf_counter()
    back = load_train_state(path, template, fresh_tx, zero_shard=True)
    _sync()
    rec["read_s"] = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(leaves, fresh_leaves))
    for ma, mb in zip(owned_moments(tx, state.opt_state, len(leaves)),
                      owned_moments(fresh_tx, back.opt_state, len(leaves))):
        for a, b in zip(ma, mb):
            pairs = zip(a, b) if isinstance(a, QMoment) else [(a, b)]
            same = same and all(torch.equal(x, y) for x, y in pairs)
    rec["read_back_equal"] = same and back.step == state.step \
        and back.opt_state.count == state.opt_state.count
    rec["file_gb"] = Path(path).stat().st_size / GB
    rt.barrier()
    rt.cleanup()
    torch.save(rec, spec["out"])
    return 0


class _TwoRankOrder:
    """The one-rank reference's sampler: each optimizer step's two
    microbatches are the two ranks' batches of that step, in rank order."""

    def __init__(self, sampler_cls, batch: int):
        self.cls, self.batch = sampler_cls, batch

    def __call__(self, num_samples, rank=0, world_size=1, **kw):
        ranks = [self.cls(num_samples, rank=r, world_size=DDP_WORLD, **kw)
                 for r in range(DDP_WORLD)]
        batch = self.batch

        class Interleaved:
            def set_epoch(self, epoch):
                for s in ranks:
                    s.set_epoch(epoch)

            def __iter__(self):
                orders = [list(s) for s in ranks]
                return iter(i for k in range(0, len(orders[0]), batch)
                            for o in orders for i in o[k:k + batch])

            def __len__(self):
                return sum(len(s) for s in ranks)

        return Interleaved()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_runs(device: str = "cuda:0", reference_backend: str = "nccl"):
    """The reference in this process (and its first step once more), then
    the two ranks; returns (the reference's record, the repeat's, the ranks'
    records, the reference's backend, the ranks' wall seconds)."""
    import os

    import torch

    import whisper_finetune_torch.runtime as rt
    from whisper_finetune_torch.scripts import finetune

    out = SCRATCH / "ddp"
    out.mkdir(parents=True, exist_ok=True)
    env_keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "WFT_ALLOW_RANDOM_INIT")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()), WFT_ALLOW_RANDOM_INIT="1")
    sampler = finetune.ShardedSampler
    finetune.ShardedSampler = _TwoRankOrder(sampler, 8)
    t0 = time.perf_counter()
    try:
        ref, state, _ = ddp_run(ddp_config(2, False, str(out / "reference")), device,
                                reference_backend)
        ref["wall_s"] = time.perf_counter() - t0
        del state
        # the reference's first step again: the card's run-to-run spread
        config = ddp_config(2, False, str(out / "again"))
        config["training"]["epochs"] = 0.25
        config["dataset"]["val_datasets"] = []
        again, state, _ = ddp_run(config, device, reference_backend)
        backend = torch.distributed.get_backend()
    finally:
        finetune.ShardedSampler = sampler
        rt.cleanup()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del state
    torch.cuda.empty_cache()

    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(DDP_WORLD):
            spec = {"config": ddp_config(2, True, str(out / "ranks")), "device": device,
                    "backend": "gloo", "out": str(out / f"rank{r}.pt")}
            (out / f"rank{r}.json").write_text(json.dumps(spec))
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DDP_WORLD), LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WFT_ALLOW_RANDOM_INIT="1")
            log_file = open(out / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--ddp-rank",
                 str(out / f"rank{r}.json")], env=env, stdout=log_file,
                stderr=subprocess.STDOUT), log_file))
        for p, _ in procs:
            p.wait(timeout=600)
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    wall_s = time.perf_counter() - t0
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            tail = (out / f"rank{r}.log").read_text()[-3000:]
            raise AssertionError(f"[ddp] rank {r} exited {p.returncode}:\n{tail}")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(DDP_WORLD)]
    return ref, again, ranks, backend, wall_s


def _compare_after_step1(runs: list, ref: dict) -> dict:
    """Sampled parameters and 8-bit codes after step 1 of each of ``runs``
    against ``ref``'s: the largest parameter difference, and the share of
    parameters beyond 15% of lr and of codes more than 1 level apart. Codes:
    the first moment (int8, linear in the block's absmax) and the second
    (uint8, log-scale over six decades of the block max) where the
    reference's value is at least 1% of its block max (code >=
    DDP_NU_FLOOR). On the CPU data-parallel runs are bit-equal to one
    process (tests/test_torch_parallel.py); on the card no two runs are,
    ZeRO or not: attn_bwd adds dQ in a varying order and the bf16 backward
    carries those last bits into every earlier layer's gradient, so the
    leg holds shares, not maxima, and measures the same shares between two
    runs of the reference (PERF.md §6, PR 7)."""
    worst, beyond, n = 0.0, 0, 0
    codes = {"mu": [0, 0, 0], "nu": [0, 0, 0]}  # compared, beyond 1 level, largest
    ref_codes = {(c["leaf"], c["moment"]): c for c in ref["codes"]}
    for run in runs:
        for a, b in zip(run["params"], ref["params"]):
            d = (a - b).abs()
            worst = max(worst, d.max().item())
            beyond, n = beyond + int((d > 0.15 * DDP_LR).sum()), n + d.numel()
        for c in run["codes"]:
            want = ref_codes[(c["leaf"], c["moment"])]
            index = {int(b): i for i, b in enumerate(want["blocks"])}
            rows = want["codes"][[index[int(b)] for b in c["blocks"]]]
            d = (c["codes"].int() - rows.int()).abs()
            if c["moment"] == 1:
                d = d[rows.int() >= DDP_NU_FLOOR]
            if d.numel():
                st = codes["mu" if c["moment"] == 0 else "nu"]
                st[0], st[1] = st[0] + d.numel(), st[1] + int((d > 1).sum())
                st[2] = max(st[2], int(d.max()))
    share = {"params": beyond / max(n, 1), **{k: v[1] / max(v[0], 1) for k, v in codes.items()}}
    return {"param_max": worst, "params_compared": n, "codes": codes, "share": share}


def ddp_leg(driver: dict) -> dict:
    """``finetune.main`` with ZeRO-1 in two ranks on the one card over gloo
    (NCCL refuses two ranks of one communicator on one GPU), each passed
    ``device="cuda:0"``: large-v3, batch 8 a rank, global accum 2 (local 1),
    8-bit AdamW, 1 warm-up and 2 timed steps, the train state saved at the
    last. Before it, the reference in this process: one rank at world size
    1 over NCCL (the default backend's path, a group of one) with accum 2
    over the same global batch. Asserted: the ranks' parameters bit-equal
    after every step; the first loss within 1e-3 relative of the
    reference's; after step 1, on sampled elements and blocks, the
    parameters within DDP_PARAM_TOL of the reference's and at most
    DDP_OFF_SHARE of them beyond 15% of lr or of the 8-bit codes more than
    1 level apart (the reference's first step run again gives the card's own
    spread, printed beside); exact launches; each rank's peak within DDP_PEAK_TOL of the
    driver leg's peak less the state it no longer holds; the train state
    read back bit-equal into a fresh two-rank state."""
    import shutil

    ref, again, ranks, backend, wall_s = ddp_runs()
    out = SCRATCH / "ddp"

    # the ranks hold the same parameters after every step
    for k, steps in enumerate(zip(*(rk["steps"] for rk in ranks))):
        if len({repr(s["checksums"]) for s in steps}) != 1:
            raise AssertionError(f"[ddp] the ranks' parameters differ after step {k + 1}")
    # against the one-rank reference
    losses = [[x["Train loss"] for x in rec["records"] if "Train loss" in x]
              for rec in (ranks[0], ref)]
    if len(losses[0]) != 3 or abs(losses[0][0] - losses[1][0]) > 1e-3 * abs(losses[1][0]):
        raise AssertionError(f"[ddp] losses {losses[0]} against the reference's {losses[1]}")
    cmp = _compare_after_step1([rk["steps"][0]["samples"] for rk in ranks],
                               ref["steps"][0]["samples"])
    spread = _compare_after_step1([again["steps"][0]["samples"]], ref["steps"][0]["samples"])
    if (cmp["param_max"] > DDP_PARAM_TOL or max(cmp["share"].values()) > DDP_OFF_SHARE
            or min(v[0] for v in cmp["codes"].values()) == 0):
        raise AssertionError(f"[ddp] after step 1 against the reference: {cmp} (the "
                             f"reference against itself: {spread})")
    # launches: a step 128 / 64 as the first slice's, 43 fused updates of the
    # rank's quantized shards and whole leaves; an eval batch (2 of 4 rows a
    # rank) one forward a site; the reference runs two microbatches a step
    sites = 64
    for name, rec, micro, steps, evals in [(f"rank {r}", rk, 1, 3, 4)
                                           for r, rk in enumerate(ranks)] + \
            [("reference", ref, 2, 3, 4), ("reference again", again, 2, 1, 0)]:
        expect = {"attn_fwd": steps * micro * 2 * sites + evals * sites,
                  "attn_bwd": steps * micro * sites, "fused_adamw8_leaf": steps * 43}
        if rec["fused_per_step"] != 43 or rec["launches"] != expect:
            raise AssertionError(f"[ddp] {name}: launches {rec['launches']} != {expect} "
                                 f"({rec['fused_per_step']} fused updates a step)")
    # memory: the driver leg's peak (the same run at world 1) less the 8-bit
    # state the rank no longer holds
    whole_state = ref["state_bytes"]
    for r, rk in enumerate(ranks):
        want = driver["peak_mem_bytes"] - (whole_state - rk["state_bytes"])
        rk["peak_reckoned_bytes"] = want
        if abs(rk["peak_mem_bytes"] - want) > DDP_PEAK_TOL:
            raise AssertionError(f"[ddp] rank {r} peak {rk['peak_mem_bytes'] / GB:.3f} GB, "
                                 f"reckoned {want / GB:.3f} GB")
    if not all(rk["read_back_equal"] for rk in ranks):
        raise AssertionError("[ddp] the train state read back differs from the final state")

    step_ms = [[s["s"] * 1e3 for s in rk["steps"]] for rk in ranks]
    timed_ms = [[(b["t0"] - a["t0"]) * 1e3 for a, b in zip(rk["steps"][1:], rk["steps"][2:])]
                + [rk["steps"][-1]["s"] * 1e3] for rk in ranks]
    comm = ranks[0]["steps"][1]["comm"]
    rec = {
        "backend": "gloo", "reference_backend": backend, "world": DDP_WORLD,
        "losses": losses[0], "reference_losses": losses[1],
        "step_ms": step_ms, "timed_step_ms": timed_ms, "reference_step_ms":
        [s["s"] * 1e3 for s in ref["steps"]],
        "comm_per_step": comm, "reference_comm_per_step": ref["steps"][1]["comm"],
        "peak_bytes": [rk["peak_mem_bytes"] for rk in ranks],
        "peak_reckoned_bytes": [rk["peak_reckoned_bytes"] for rk in ranks],
        "reference_peak_bytes": ref["peak_mem_bytes"],
        "state_bytes": [rk["state_bytes"] for rk in ranks], "whole_state_bytes": whole_state,
        "n_sharded_leaves": ranks[0]["n_sharded"],
        "after_step1": cmp, "reference_against_itself": spread,
        "save_s": ranks[0]["saves"][0]["s"], "read_s": [rk["read_s"] for rk in ranks],
        "file_gb": ranks[0]["file_gb"], "wall_s": wall_s, "reference_wall_s": ref["wall_s"],
        "launches": {f"ddp rank{r}": rk["launches"] for r, rk in enumerate(ranks)}
        | {"ddp reference": ref["launches"], "ddp reference again": again["launches"]},
    }
    log(f"  [ddp] backend gloo, world {DDP_WORLD} on one card; reference: world 1 over "
        f"{backend}, accum 2")
    log(f"  [ddp] losses {[round(x, 4) for x in losses[0]]}, reference "
        f"{[round(x, 4) for x in losses[1]]}")
    for name, c in (("two ranks", cmp), ("the reference once more", spread)):
        shares = {k: round(v, 6) for k, v in c["share"].items()}
        log(f"  [ddp] after step 1, {name} against the reference: parameters within "
            f"{c['param_max']:.3e}; shares beyond 15% of lr / codes beyond 1 level {shares}; "
            f"codes (compared, beyond 1 level, largest) {c['codes']}")
    for r, rk in enumerate(ranks):
        log(f"  [ddp] rank {r}: step ms {[round(x, 1) for x in step_ms[r]]}, peak "
            f"{rk['peak_mem_bytes'] / GB:.3f} GB (reckoned {rk['peak_reckoned_bytes'] / GB:.3f}), "
            f"8-bit state {rk['state_bytes'] / GB:.3f} GB of {whole_state / GB:.3f}, launches "
            f"{rk['launches']}")
    log(f"  [ddp] collectives a step (rank 0): {comm}; reference over {backend}: "
        f"{ref['steps'][1]['comm']}")
    log(f"  [ddp] train state {rec['file_gb']:.2f} GB saved in {rec['save_s']:.1f} s, read "
        f"back bit-equal in {max(rec['read_s']):.1f} s; reference peak "
        f"{ref['peak_mem_bytes'] / GB:.3f} GB; two ranks {wall_s:.1f} s, reference "
        f"{ref['wall_s']:.1f} s ({smi_line()})")
    shutil.rmtree(out)
    shutil.rmtree(DEBUG_DS, ignore_errors=True)
    return rec


# ---------------------------------------------------------------------------
# Phase 8: the split step with the manual backward (the one-chip flagship)
# ---------------------------------------------------------------------------

SPLIT_CONFIG = ROOT / "configs" / "config_large_v3_best_muon_1chip.yaml"
# Peak of one accumulation (accum 2, batch 6) with the manual backward and
# precast weights less the automatic backward's, and the manual backward with
# per-layer casts less the automatic's (PERF.md §6, PR 8: the reckoning).
SPLIT_PEAK_DIFF = {"manual": -0.90 * GB, "manual_per_layer": -3.90 * GB}
SPLIT_PEAK_TOL = 0.5 * GB  # asserted for the shipped (precast) path
SPLIT_BIG_BATCH = 32  # one accumulation at the flagship's batch 32 (ROADMAP item 13)


def split_leg(dims=None, device="cuda") -> dict:
    """``configs/config_large_v3_best_muon_1chip.yaml`` as shipped: batch 6,
    bf16 accumulator, int8 Muon momentum, 8-bit auxiliary AdamW, stochastic
    depth 0.1, deep SpecAugment, ``auto`` attention, with the training keys
    resolved as ``finetune.main`` resolves them (``check_training_keys``,
    ``resolve_step_keys``: split, manual backward, precast), random weights
    from seed 0, synthetic audio and tokens.

    (1) One accumulation each at accum 2 through the split step's
    ``accumulate``, on the same weights, batch, draws and generator seed: the
    automatic backward, the manual backward (precast, as shipped) and the
    manual backward with per-layer casts. Asserted: losses bit-equal, every
    layer's gradient norm within GRAD_NORM_TOL of the automatic path's, the
    shipped manual path's peak below the automatic path's and the difference
    within SPLIT_PEAK_TOL of the reckoning. (2) One accumulation at batch
    SPLIT_BIG_BATCH, accum 1, manual: its peak. (3) Three optimizer steps (1
    warm-up + 2 timed) at the shipped accum 8: ``accum_s`` / ``update_s``,
    the peak, finite losses, every leaf moved, the schedule's lr at each
    count, launches exact against ``blocks_run``."""
    import torch
    from whisper_finetune_torch import config as C
    from whisper_finetune_torch.models import get_preset_dims, init_params
    from whisper_finetune_torch.models import whisper as W
    from whisper_finetune_torch.optim import get_optimizer, get_schedule
    from whisper_finetune_torch.optim.quantized import BLOCK, QMoment
    from whisper_finetune_torch.tools import first_slice as fs
    from whisper_finetune_torch.train import TrainState, make_train_step

    gc.collect()  # no earlier leg's garbage in this leg's peaks
    torch.cuda.empty_cache()
    cfg = C.load_config(SPLIT_CONFIG)
    notes = C.check_training_keys(cfg)
    keys, step_notes = C.resolve_step_keys(cfg, full_tree=True, zero_active=False)
    notes += step_notes
    if keys != {"split_update": True, "manual_backward": True, "manual_precast": True} or notes:
        raise AssertionError(f"[split] the one-chip config resolves to {keys}, notes {notes}")
    dims = dims or get_preset_dims(cfg["model"]["init_name"])
    B, accum = int(cfg["dataset"]["batch_size"]), int(cfg["training"]["accum_grad_steps"])
    model = init_params(dims, device=device, seed=0)
    paths = [path for path, _ in model.leaves()]
    leaves = [p for _, p in model.leaves()]
    fcfg = C.build_forward_config(cfg, is_lora_run=False, device=device)
    feat = C.build_featurize_config(cfg, dims.n_mels)
    schedule = get_schedule(cfg["lr_scheduler"], TRAIN_STEPS)
    tx, _ = get_optimizer(model.leaves(), cfg["optimizer"], schedule)
    state = TrainState(model, tx.init(leaves), 0)
    t = cfg["training"]

    def make(**kw):
        return make_train_step(dims, fcfg, tx, float(t["label_smoothing"]), feat_cfg=feat,
                               max_grad_norm=float(t["max_grad_norm"]),
                               accum_dtype=t["grad_accum_dtype"], device=device, **kw)

    step = make(**keys)
    log(f"  [split] {dims.n_audio_layer}+{dims.n_text_layer} layers, batch {B}, accum {accum}, "
        f"attn {fcfg.enc_attn}/{fcfg.dec_attn}/{fcfg.cross_attn}, stochastic depth "
        f"{fcfg.sd_encoder}, deep SpecAugment {fcfg.dsa_apply}, {tx.labels.count('muon')} Muon + "
        f"{tx.labels.count('adamw')} AdamW leaves; keys {keys}")

    # (1) manual against automatic, one accumulation each
    batch2 = fs.synthetic_batch(dims, 2, B, device=device)
    draws = W.draw_forward(torch.Generator(device=device).manual_seed(0), dims, device, 2)
    compare = {}
    kernels = fs.reset_counts()
    for name, fn in (("automatic", make(split_update=True)), ("manual", step),
                     ("manual_per_layer", make(split_update=True, manual_backward=True))):
        gc.collect()
        _sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        buf, loss = fn.accumulate(state, batch2, torch.Generator(device=device).manual_seed(1),
                                  draws)
        loss = loss.item()
        _sync()
        compare[name] = {"loss": loss, "s": time.perf_counter() - t0,
                         "peak_bytes": torch.cuda.max_memory_allocated(), "base_bytes": base,
                         "norms": fs.layer_grad_norms(paths, buf)}
        del buf
    compare_launches = {fn.__name__: fn.launches for fn in kernels}
    blocks2 = (W.encoder_forward.blocks_run, W.decoder_forward.blocks_run)
    ref = compare["automatic"]
    for name in ("manual", "manual_per_layer"):
        c = compare[name]
        c["norm_rel_diff"] = fs.norms_rel_diff(c["norms"], ref["norms"])
        c["peak_diff_bytes"] = c["peak_bytes"] - ref["peak_bytes"]
        c["peak_diff_reckoned_bytes"] = SPLIT_PEAK_DIFF[name]
        if c["loss"] != ref["loss"]:
            raise AssertionError(f"[split] {name} loss {c['loss']!r} != automatic {ref['loss']!r}")
        if not c["norm_rel_diff"] <= GRAD_NORM_TOL:
            raise AssertionError(f"[split] {name} per-layer gradient norms {c['norm_rel_diff']:.3e} "
                                 f"from the automatic path's")
    man = compare["manual"]
    if not (man["peak_diff_bytes"] < 0
            and abs(man["peak_diff_bytes"] - SPLIT_PEAK_DIFF["manual"]) <= SPLIT_PEAK_TOL):
        raise AssertionError(f"[split] manual peak - automatic peak {man['peak_diff_bytes'] / GB:.3f}"
                             f" GB, reckoned {SPLIT_PEAK_DIFF['manual'] / GB:.3f}")
    # each kept block: one attention site (encoder self or cross) through the
    # kernels, forward and recompute (or replay) plus backward
    expect = {"attn_fwd": 2 * (blocks2[0] + blocks2[1]), "attn_bwd": blocks2[0] + blocks2[1],
              "fused_adamw8_leaf": 0}
    if compare_launches != expect:
        raise AssertionError(f"[split] accumulations' launches {compare_launches} != {expect}")
    for name, c in compare.items():
        log(f"  [split] accum 2, {name}: loss {c['loss']:.6f}, peak "
            f"{c['peak_bytes'] / GB:.3f} GB over {c['base_bytes'] / GB:.3f} resident, "
            f"{c['s']:.2f} s" + (f"; peak - automatic {c['peak_diff_bytes'] / GB:+.3f} GB "
                                 f"(reckoned {c['peak_diff_reckoned_bytes'] / GB:+.2f}), layer "
                                 f"norms within {c['norm_rel_diff']:.2e}" if name != "automatic"
                                 else ""))
    del batch2

    # (2) one accumulation at the flagship's batch 32
    big = fs.synthetic_batch(dims, 1, SPLIT_BIG_BATCH, device=device)
    _sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    buf, loss = step.accumulate(state, big, torch.Generator(device=device).manual_seed(2))
    loss = loss.item()
    _sync()
    big_rec = {"batch": SPLIT_BIG_BATCH, "loss": loss, "s": time.perf_counter() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated()}
    del buf, big
    log(f"  [split] one accumulation at batch {SPLIT_BIG_BATCH} (manual, precast): peak "
        f"{big_rec['peak_bytes'] / GB:.3f} GB, {big_rec['s']:.2f} s, loss {loss:.4f}")
    torch.cuda.empty_cache()

    # (3) three optimizer steps at the shipped accumulation
    batch = fs.synthetic_batch(dims, accum, B, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    before = [p.detach()[(0,) * (p.dim() - 1)][:8].clone() for p in leaves]
    aux_fused = sum(isinstance(mu, QMoment) and p.numel() % BLOCK == 0
                    for p, mu in zip(tx._pick("adamw", leaves), state.opt_state.adamw.mu))
    warmup, timed = 1, 2
    kernels = fs.reset_counts()
    losses, times, timings, lrs = [], [], [], []
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        lrs.append((tx.muon.lr(state.opt_state.count), tx.adamw.lr(state.opt_state.count)))
        _sync()
        t0 = time.perf_counter()
        state, loss = step(state, batch, gen)
        loss = loss.item()
        _sync()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        timings.append(dict(step.last_timing))
        log(f"  [split] step {i}: loss {loss:.4f}, {times[-1] * 1e3:.1f} ms (accum "
            f"{timings[-1]['accum_s'] * 1e3:.1f}, update {timings[-1]['update_s'] * 1e3:.1f}), "
            f"lr {lrs[-1][0]:.3e}")
    launches = {fn.__name__: fn.launches for fn in kernels}
    enc_blocks, dec_blocks = W.encoder_forward.blocks_run, W.decoder_forward.blocks_run
    peak = torch.cuda.max_memory_allocated()
    n_steps = warmup + timed
    expect = {"attn_fwd": 2 * (enc_blocks + dec_blocks), "attn_bwd": enc_blocks + dec_blocks,
              "fused_adamw8_leaf": aux_fused * n_steps}
    if launches != expect or not aux_fused:
        raise AssertionError(f"[split] launch counts {launches} != expected {expect} "
                             f"(blocks run: encoder {enc_blocks}, decoder {dec_blocks})")
    if not all(math.isfinite(x) for x in losses) or abs(losses[0] - math.log(dims.n_vocab)) > 0.5:
        raise AssertionError(f"[split] losses {losses}")
    changed = sum(not torch.equal(b, p.detach()[(0,) * (p.dim() - 1)][:8])
                  for b, p in zip(before, leaves))
    if changed != len(leaves) or state.step != n_steps or state.opt_state.count != n_steps:
        raise AssertionError(f"[split] {changed} of {len(leaves)} leaves moved, step "
                             f"{state.step}, count {state.opt_state.count}")
    warm = float(cfg["lr_scheduler"]["warmup_steps"])
    for c, (lr_m, lr_a) in enumerate(lrs):
        want_m = float(cfg["optimizer"]["muon_params"]["lr"]) * c / warm
        want_a = float(cfg["optimizer"]["params"]["lr"]) * c / warm
        if abs(lr_m - want_m) > 1e-6 * max(want_m, 1e-12) or abs(lr_a - want_a) > 1e-6 * max(want_a, 1e-12):
            raise AssertionError(f"[split] lr at count {c}: {lr_m}, {lr_a} != {want_m}, {want_a}")
    rec = {
        "config": str(SPLIT_CONFIG.relative_to(ROOT)), "keys": keys, "batch": B, "accum": accum,
        "layers": [dims.n_audio_layer, dims.n_text_layer],
        "compare": {k: {kk: vv for kk, vv in v.items() if kk != "norms"}
                    for k, v in compare.items()},
        "compare_launches": compare_launches, "big_batch": big_rec,
        "losses": losses, "step_s_all": times, "step_s_median": statistics.median(times[warmup:]),
        "timings": timings, "lr": lrs, "peak_mem_bytes": peak, "launches": launches,
        "blocks_run": {"encoder": enc_blocks, "decoder": dec_blocks}, "aux_fused": aux_fused,
        "audio_hours_per_s": accum * B * 30 / 3600 / statistics.median(times[warmup:]),
    }
    log(f"  [split] median step {rec['step_s_median'] * 1e3:.1f} ms "
        f"({rec['audio_hours_per_s']:.4f} audio-h/s), peak {peak / GB:.3f} GB, blocks run "
        f"{enc_blocks}+{dec_blocks}, launches {launches} ({smi_line()})")
    del state, step, model, leaves, batch, before, tx
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# Phase 9: KV-cached decoding and the transcribe CLI
# ---------------------------------------------------------------------------

DECODE_ROWS, DECODE_MAX_LEN, DECODE_BEAM = 8, 224, 5
DECODE_LOGIT_TOL = 0.25  # cached step against the teacher-forced bf16 forward, max |logit diff|
DRIVER_PT = SCRATCH / "driver_last_model.pt"  # the driver leg's last_model.pt, for the CLI


def decode_token_bound(dims, rows: int, max_len: int, beam: bool = False):
    """(ms, "bytes"/"operations") of one cached token step at ``rows`` rows:
    the decoder's block weights in bf16 (vectors float32), the float32 tied
    head, every layer's cross K/V and the whole self-attention window read
    once; with ``beam`` the caches' reorder (read and write) too; operations:
    2 per weight element a row."""
    L, d, S, V = dims.n_text_layer, dims.n_text_state, dims.n_audio_ctx, dims.n_vocab
    mats = L * 16 * d * d  # q, k, v, o twice; fc1, fc2
    vecs = L * (13 * d + 4 * d)  # biases and layer-norm gains
    cross = 2 * L * rows * S * d * 2
    window = 2 * L * rows * max_len * d * 2
    n_bytes = mats * 2 + vecs * 4 + V * d * 4 + cross + window + (2 * window if beam else 0)
    flops = 2 * rows * (mats + V * d) + 2 * 2 * rows * L * (S + max_len) * d
    return bound_ms(n_bytes, flops)


def decode_leg(cli_checkpoint: Path, dims=None, device="cuda") -> dict:
    """large-v3 at random weights (seed 0), 8 rows of synthetic 30 s audio
    (numpy seed 0), ``max_len`` 224, language ``de``, ``without_timestamps``,
    bf16, ``attn_impl: auto``, through ``transcribe_batch``: greedy with the
    shipped six-rung fallback (random weights fail the log-prob threshold,
    so every rung runs), then beam 5 at temperature 0 (40 rows), then beam 1.
    Counters zeroed just before and read just after: ``attn_fwd`` 32 a
    decode call (its encoder pass), no ``attn_bwd``. Then, outside the count:
    the first rung's tokens teacher-forced through ``forward_impl`` against
    the cached step's logits at every generated position (max |diff| <=
    DECODE_LOGIT_TOL; where the full forward's filtered top-2 margin exceeds
    it, its argmax is the generated token); beam 1's tokens equal greedy's up
    to a position where the beam's running score merged greedy's top two
    log-probs (a tie in float32, which the assertion checks). Times: the
    encoder pass, each call, ms a token beside its bound, peaks. Last, the
    transcribe CLI as a subprocess on ``cli_checkpoint`` (the driver leg's
    fp16 ``last_model.pt``) and a 16 kHz wav: exit 0, one line."""
    import os

    import numpy as np
    import torch
    from scipy.io import wavfile

    from whisper_finetune_torch.models import decoding as D
    from whisper_finetune_torch.models import get_preset_dims, init_params
    from whisper_finetune_torch.models.whisper import ForwardConfig, encoder_forward, forward_impl
    from whisper_finetune_torch.ops.attention import resolve_auto_impls
    from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig, featurize_impl
    from whisper_finetune_torch.tokenizer import get_tokenizer
    from whisper_finetune_torch.tools import first_slice as fs

    gc.collect()  # no earlier leg's garbage in this leg's peaks
    torch.cuda.empty_cache()
    dims = dims or get_preset_dims("large-v3")
    N, max_len = DECODE_ROWS, min(DECODE_MAX_LEN, dims.n_text_ctx)
    model = init_params(dims, device=device, seed=0)
    params = model.params()
    tok = get_tokenizer(language="de", task="transcribe")
    audio = (np.random.default_rng(0).standard_normal((N, 480000)) * 0.05).astype(np.float32)
    fcfg = ForwardConfig(compute_dtype="bfloat16", **resolve_auto_impls(device))
    eval_fcfg = D._eval_fcfg(fcfg)
    filters = D.default_filters(tok)
    with torch.no_grad():
        mel = featurize_impl(torch.from_numpy(audio).to(device),
                             torch.full((N,), 3000, dtype=torch.int32, device=device), None,
                             FeaturizeConfig(n_mels=dims.n_mels), train=False)
        enc_ms = cuda_time_ms(lambda: encoder_forward(params, mel, dims, eval_fcfg), iters=2,
                              repeats=3)
    log(f"  [decode] encoder pass at {N} rows: {enc_ms:.2f} ms")

    calls = []
    originals = {name: getattr(D, name) for name in ("greedy_decode", "beam_decode")}

    def timed(name):
        def run(p, mel_r, init_r, *args, **kw):
            _sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = originals[name](p, mel_r, init_r, *args, **kw)
            _sync()
            calls.append({"fn": name, "rows": int(mel_r.shape[0]),
                          "beam": kw.get("beam_size", 1) if name == "beam_decode" else None,
                          "temperature": float(kw.get("temperature", 0.0)),
                          "s": time.perf_counter() - t0,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "tokens": out[0], "avg_logprob": out[1].cpu(), "mel": mel_r,
                          "init": init_r})
            return out
        return run

    kernels = fs.reset_counts()
    try:
        for name in originals:
            setattr(D, name, timed(name))
        texts = D.transcribe_batch(params, dims, audio, tok, fcfg=fcfg, language="de",
                                   max_len=max_len)
        beam_texts = D.transcribe_batch(params, dims, audio, tok, fcfg=fcfg, language="de",
                                        max_len=max_len, beam_size=DECODE_BEAM,
                                        temperatures=(0.0,))
        init = calls[0]["init"]
        D.beam_decode(params, mel, init, tok.eot, dims, fcfg, max_len=max_len, beam_size=1,
                      filters=filters)
    finally:
        for name, fn in originals.items():
            setattr(D, name, fn)
    launches = {fn.__name__: fn.launches for fn in kernels}
    passes = len(calls)
    expect = {"attn_fwd": dims.n_audio_layer * passes, "attn_bwd": 0, "fused_adamw8_leaf": 0}
    if launches != expect:
        raise AssertionError(f"[decode] launches {launches} != {expect} ({passes} encoder passes)")
    rungs = calls[:-2]
    if [c["temperature"] for c in rungs] != [0.0, 0.2, 0.4, 0.6, 0.8, 1.0] or \
            any(c["rows"] != N for c in rungs) or len(texts) != N:
        raise AssertionError(f"[decode] rungs {[(c['temperature'], c['rows']) for c in rungs]}")
    beam, beam1 = calls[-2], calls[-1]
    if beam["fn"] != "beam_decode" or beam["rows"] != N or len(beam_texts) != N:
        raise AssertionError("[decode] the beam call is not the expected one")

    # The cached step against the teacher-forced forward, at every position
    # that predicted a generated token.
    greedy = calls[0]["tokens"]
    T0 = init.shape[1]
    seq = torch.cat([init, greedy], 1)
    with torch.no_grad():
        dec = D._encode(params, mel, dims, fcfg, max_len)
        cached = torch.stack([dec.step(seq[:, i], i) for i in range(max_len - 1)], 1)
        del dec
        full = forward_impl(params, mel, seq[:, :-1], dims, eval_fcfg)
    cached, full = cached[:, T0 - 1:], full[:, T0 - 1:]  # (N, n_gen, V)
    diff = (cached - full).abs()
    logit_err = diff.max().item()
    logit_rms = diff.square().mean().sqrt().item()
    del diff
    eot = tok.eot
    zeros = torch.zeros((N,), dtype=torch.long, device=device)
    checked = agree = 0
    lp_all = []
    for j in range(greedy.shape[1]):
        full_j = filters.apply(full[:, j], zeros, zeros, zeros, j)
        top2 = full_j.topk(2, dim=-1).values
        live = (greedy[:, :j] != eot).all(1) if j else torch.ones_like(zeros, dtype=torch.bool)
        sure = live & (top2[:, 0] - top2[:, 1] > DECODE_LOGIT_TOL)
        checked += int(sure.sum())
        agree += int((sure & (full_j.argmax(-1) == greedy[:, j])).sum())
        lp_all.append(torch.log_softmax(filters.apply(cached[:, j], zeros, zeros, zeros, j), -1))
    if not logit_err <= DECODE_LOGIT_TOL or agree != checked or checked == 0:
        raise AssertionError(f"[decode] cached step against the teacher-forced forward: max "
                             f"|diff| {logit_err:.4f} (tolerance {DECODE_LOGIT_TOL}); argmax "
                             f"agrees at {agree} of {checked} positions past the margin")
    # Beam 1 against greedy: equal, or diverging first where the running
    # score's float32 sum cannot tell greedy's two best continuations apart.
    b1 = beam1["tokens"]
    equal_rows, tie_rows = 0, []
    for r in range(N):
        d = (b1[r] != greedy[r]).nonzero()
        if len(d) == 0:
            equal_rows += 1
            continue
        d = int(d[0])
        lp = [x[r] for x in lp_all]
        g, b = lp[d][greedy[r, d]], lp[d][b1[r, d]]
        score = lp[0][greedy[r, 0]]  # the beam's running sum, in its order
        for j in range(1, d):
            score = score + lp[j][greedy[r, j]]
        tie = bool(g == b) if d == 0 else bool(score + g == score + b)
        if not tie:
            raise AssertionError(f"[decode] beam 1 leaves greedy at row {r}, token {d}: log-probs "
                                 f"{g.item()!r} / {b.item()!r}, score {score.item()!r}")
        tie_rows.append((r, d))
    del cached, full, lp_all

    def per_token(c, rows):
        ms = (c["s"] * 1e3 - enc_ms) / max_len
        bound, by = decode_token_bound(dims, rows, max_len, beam=c["fn"] == "beam_decode")
        return {"ms": ms, "bound_ms": bound, "bound_by": by, "gap": ms / bound,
                "tokens_per_s": rows * (max_len - T0) / c["s"]}

    g_tok, b_tok = per_token(rungs[0], N), per_token(beam, N * DECODE_BEAM)
    rec = {
        "rows": N, "max_len": max_len, "beam": DECODE_BEAM, "encoder_ms": enc_ms,
        "greedy_per_token": g_tok, "beam_per_token": b_tok,
        "rung_s": [c["s"] for c in rungs], "beam_s": beam["s"], "beam1_s": beam1["s"],
        "greedy_peak_bytes": max(c["peak_bytes"] for c in rungs),
        "beam_peak_bytes": beam["peak_bytes"],
        "cross_cache_bytes": {"greedy": 2 * dims.n_text_layer * N * dims.n_audio_ctx
                              * dims.n_text_state * 2,
                              "beam": 2 * dims.n_text_layer * N * DECODE_BEAM * dims.n_audio_ctx
                              * dims.n_text_state * 2},
        "logit_max_abs_diff": logit_err, "logit_rms_diff": logit_rms,
        "argmax_checked": checked, "beam1_equal_rows": equal_rows, "beam1_tie_rows": tie_rows,
        "avg_logprob_rung0": calls[0]["avg_logprob"].tolist(), "launches": launches,
        "encoder_passes": passes, "texts": texts, "beam_texts": beam_texts,
    }
    log(f"  [decode] greedy, 6 rungs of {N} rows: {[round(s, 2) for s in rec['rung_s']]} s; "
        f"{g_tok['ms']:.2f} ms a token (bound {g_tok['bound_ms']:.3f} by {g_tok['bound_by']}, "
        f"{g_tok['gap']:.1f}x), {g_tok['tokens_per_s']:.0f} tokens/s, peak "
        f"{rec['greedy_peak_bytes'] / GB:.3f} GB")
    log(f"  [decode] beam {DECODE_BEAM} ({N * DECODE_BEAM} rows): {beam['s']:.2f} s, "
        f"{b_tok['ms']:.2f} ms a token (bound {b_tok['bound_ms']:.3f}, {b_tok['gap']:.1f}x), "
        f"{b_tok['tokens_per_s']:.0f} tokens/s, peak {rec['beam_peak_bytes'] / GB:.3f} GB; "
        f"beam 1 {beam1['s']:.2f} s")
    log(f"  [decode] cached step against the teacher-forced forward: max |diff| {logit_err:.4f}, "
        f"rms {logit_rms:.5f}; argmax agrees at all {checked} positions past the margin; beam 1 "
        f"= greedy on {equal_rows} of {N} rows, float32 ties at {tie_rows}; launches {launches}")
    del model, params, calls, rungs, beam, beam1, mel
    torch.cuda.empty_cache()

    # The CLI on the driver leg's checkpoint, as a user runs it.
    wav = SCRATCH / "decode_cli.wav"
    wavfile.write(str(wav), 16000, (np.random.default_rng(0).standard_normal(16000 * 5) * 0.05
                                    ).astype(np.float32))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "whisper_finetune_torch.scripts.transcribe",
                          "--checkpoint", str(cli_checkpoint), str(wav)], cwd=ROOT,
                         capture_output=True, text=True, timeout=900,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    cli_s = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or len(lines) != 1 or not lines[0].startswith(f"{wav}\t"):
        raise AssertionError(f"[decode] transcribe CLI exit {out.returncode}, stdout "
                             f"{out.stdout[-2000:]!r}, stderr {out.stderr[-4000:]}")
    rec["cli"] = {"s": cli_s, "line": lines[0]}
    log(f"  [decode] transcribe CLI on the driver leg's last_model.pt: exit 0 in {cli_s:.1f} s: "
        f"{lines[0][:120]!r} ({smi_line()})")
    wav.unlink()
    return rec


# ---------------------------------------------------------------------------
# Phase 10: packaging (convert to HF, local publish, batch publish)
# ---------------------------------------------------------------------------

PACKAGE_ROWS, PACKAGE_TOKENS = 8, 64
# The HF model against the port's float32 forward on the plain attention, max
# |logit diff|: 3x the worst measured on an H100, 3.4e-5 (PERF.md §6, packaging).
PACKAGE_F32_TOL = 1e-4
PACKAGE_DIR = SCRATCH / "package"  # removed at the end of the leg


def _versions(names) -> dict:
    import importlib

    out = {}
    for name in names:
        try:
            out[name] = getattr(importlib.import_module(name), "__version__", "?")
        except ImportError:
            out[name] = "absent"
    return out


def _compare_logits(got, want, tol: float) -> dict:
    """max / rms of |got - want|, and whether the argmax agrees wherever
    ``want``'s top-2 margin exceeds ``tol``."""
    diff = (got - want).abs()
    top2 = want.topk(2, dim=-1).values
    sure = top2[..., 0] - top2[..., 1] > tol
    agree = (got.argmax(-1) == want.argmax(-1)) & sure
    return {"max_abs_diff": diff.max().item(), "rms_diff": diff.square().mean().sqrt().item(),
            "argmax_checked": int(sure.sum()), "argmax_agree": int(agree.sum())}


def _check_snapshot(cache: Path, repo_id: str, pt: Path, assets) -> dict:
    """A ``--local-only`` snapshot: resolved through the HF cache, its
    ``.pt`` the source's bytes, each of ``assets`` (name -> expected file, or
    None for present only) as expected, and its revision the content hash
    recomputed over its files."""
    import filecmp

    from huggingface_hub import try_to_load_from_cache

    from whisper_finetune_torch.scripts.upload_model_to_hub import snapshot_revision

    resolved = try_to_load_from_cache(repo_id, pt.name, cache_dir=str(cache))
    if not isinstance(resolved, str) or not filecmp.cmp(resolved, pt, shallow=False):
        raise AssertionError(f"[package] {repo_id}: {pt.name} resolved to {resolved!r}, "
                             "not the source's bytes")
    snap = Path(resolved).parent
    files = sorted(p.name for p in snap.iterdir())
    if files != sorted({pt.name, "README.md", *assets}):
        raise AssertionError(f"[package] {repo_id}: snapshot files {files}")
    for name, want in assets.items():
        if want is not None and not filecmp.cmp(snap / name, want, shallow=False):
            raise AssertionError(f"[package] {repo_id}: {name} is not {want}")
    readme = (snap / "README.md").read_text()
    revision = snapshot_revision(repo_id, [(n, str(snap / n)) for n in files if n != "README.md"],
                                 readme)
    if snap.name != revision or "library_name: whisper_finetune_torch" not in readme:
        raise AssertionError(f"[package] {repo_id}: revision {snap.name} != {revision}")
    return {"revision": revision, "files": files}


def package_leg(pt: Path, device="cuda") -> dict:
    """The packaging CLIs on ``pt`` (the driver leg's fp16 ``last_model.pt``:
    large-v3, 32 + 32 layers at full width). Probe the optional packages;
    convert with ``convert_openai_whisper_to_tfms`` on the card (timed apart
    from ``save_pretrained``; the files against the float32 tree with the tied
    embedding once); read the folder back with ``from_pretrained`` (logits
    bit-equal); hold the HF float32 logits of 8 rows of synthetic 30 s audio
    (numpy seed 0) and 64 teacher-forced tokens against the port's
    ``forward_impl`` on the same ``.pt`` read by ``load_model``: bf16 under
    ``auto`` (max |diff| <= DECODE_LOGIT_TOL; ``attn_fwd`` once a block and a
    cross site, counted from ``blocks_run``) and float32 on the plain attention
    (<= PACKAGE_F32_TOL); ``upload_model_to_hub.main --convert-hf --local-only``
    (the snapshot resolves, its ``.pt`` is ``pt``'s bytes, its JSONs
    ``whisper_v3_utils``'s, its revision the content hash); ``--convert-ct2``
    raises ``convert_to_ct2``'s ``ImportError`` without ``ctranslate2``; the
    batch CLI's ``run_batch`` over ``pt`` and a whisper-tiny ``.pt`` (two
    snapshots, checked alike). Without ``transformers`` every conversion must
    raise the ``ImportError`` instead."""
    import shutil

    import numpy as np
    import torch

    from whisper_finetune_torch.models import get_preset_dims, init_params, load_model
    from whisper_finetune_torch.models import save_checkpoint
    from whisper_finetune_torch.models import whisper as W
    from whisper_finetune_torch.models.whisper import ForwardConfig, forward_impl
    from whisper_finetune_torch.ops.attention import resolve_auto_impls
    from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig, featurize_impl
    from whisper_finetune_torch.scripts import upload_model_to_hub as up
    from whisper_finetune_torch.scripts import wandb_to_ct2_upload as batch
    from whisper_finetune_torch.scripts.convert_openai_to_hf import convert_openai_whisper_to_tfms
    from whisper_finetune_torch.tokenizer import get_tokenizer
    from whisper_finetune_torch.tools import first_slice as fs

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_leg = time.perf_counter()
    versions = _versions(("transformers", "huggingface_hub", "safetensors", "ctranslate2",
                          "wandb"))
    log(f"  [package] {json.dumps(versions)} ({smi_line()})")
    shutil.rmtree(PACKAGE_DIR, ignore_errors=True)
    PACKAGE_DIR.mkdir(parents=True)
    tiny_pt = PACKAGE_DIR / "tiny.pt"
    tiny_dims = get_preset_dims("tiny")
    save_checkpoint(str(tiny_pt), init_params(tiny_dims, device=device, seed=0), tiny_dims)

    def publish(ckpt: Path, repo_id: str, *extra):
        up.main(up.build_parser().parse_args([
            "--checkpoint", str(ckpt), "--repo-id", repo_id, "--workdir",
            str(PACKAGE_DIR / "work"), "--convert-hf", "--local-only", "--cache-dir",
            str(PACKAGE_DIR / "cache"), "--device", str(device), *extra]))

    if versions["transformers"] == "absent":
        attempts = {
            "convert": lambda: convert_openai_whisper_to_tfms(str(pt), None, device=device),
            "publish": lambda: publish(pt, "wft/large-v3-smoke"),
            "batch": lambda: batch.run_batch([str(pt)], ["wft/large-v3-batch"], ["float16"],
                                             str(PACKAGE_DIR / "work"), True, False,
                                             cache_dir=str(PACKAGE_DIR / "cache"),
                                             device=device),
        }
        for name, attempt in attempts.items():
            try:
                attempt()
            except ImportError as exc:
                log(f"  [package] {name}: ImportError as expected without transformers: {exc}")
                continue
            raise AssertionError(f"[package] {name} ran without transformers")
        shutil.rmtree(PACKAGE_DIR)
        return {"versions": versions, "transformers": "absent",
                "launches": {"attn_fwd": 0, "attn_bwd": 0, "fused_adamw8_leaf": 0}}

    from transformers import WhisperForConditionalGeneration

    # Convert on the card, then write: timed apart.
    _sync()
    t0 = time.perf_counter()
    hf, multilingual, n_lang = convert_openai_whisper_to_tfms(str(pt), None, device=device)
    _sync()
    convert_s = time.perf_counter() - t0
    convert_peak = torch.cuda.max_memory_allocated()
    hf_dir = PACKAGE_DIR / "hf"
    t0 = time.perf_counter()
    hf.save_pretrained(str(hf_dir))
    write_s = time.perf_counter() - t0
    disk_bytes = sum(p.stat().st_size for p in hf_dir.iterdir())
    weight_bytes = sum(p.stat().st_size for p in hf_dir.glob("*.safetensors"))
    once = {p.data_ptr(): p for p in hf.parameters()}  # the tied embedding once
    reckoned = sum(p.numel() * 4 for p in once.values())
    placed = all(p.dtype == torch.float32 and p.device.type == torch.device(device).type
                 for p in once.values())
    del once
    if not placed or not 0 <= weight_bytes - reckoned < 1e6 or \
            hf.proj_out.weight.data_ptr() != hf.model.decoder.embed_tokens.weight.data_ptr():
        raise AssertionError(f"[package] {weight_bytes} safetensors bytes against {reckoned} "
                             "reckoned (float32 on the device, the tied embedding once)")
    log(f"  [package] t+{time.perf_counter() - t_leg:.1f} s: converted on the card in "
        f"{convert_s:.1f} s (peak {convert_peak / GB:.3f} "
        f"GB), written in {write_s:.1f} s: {disk_bytes / GB:.3f} GB on disk "
        f"({weight_bytes / GB:.3f} GB of weights; reckoned {reckoned / GB:.3f})")

    # Inputs: the decode leg's audio, the sot sequence and random text tokens.
    tok = get_tokenizer(language="de", task="transcribe")
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((PACKAGE_ROWS, 480000)) * 0.05).astype(np.float32)
    sot = np.tile(np.array(tok.sot_sequence), (PACKAGE_ROWS, 1))
    text = rng.integers(0, tok.eot, (PACKAGE_ROWS, PACKAGE_TOKENS - sot.shape[1]))
    tokens = torch.from_numpy(np.concatenate([sot, text], 1)).to(device)
    with torch.no_grad():
        mel = featurize_impl(torch.from_numpy(audio).to(device),
                             torch.full((PACKAGE_ROWS,), 3000, dtype=torch.int32, device=device),
                             None, FeaturizeConfig(n_mels=hf.config.num_mel_bins), train=False)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # float32 convolutions in both float32 forwards
    try:
        with torch.no_grad():
            ref = hf.eval()(input_features=mel, decoder_input_ids=tokens).logits
            del hf
            t0 = time.perf_counter()
            back = WhisperForConditionalGeneration.from_pretrained(str(hf_dir))
            back = back.to(device).eval()
            read_s = time.perf_counter() - t0
            if any(p.dtype != torch.float32 for p in back.parameters()):
                raise AssertionError("[package] from_pretrained did not give float32 weights")
            reread = back(input_features=mel, decoder_input_ids=tokens).logits
            del back
        if not torch.equal(reread, ref):
            raise AssertionError(f"[package] from_pretrained logits differ from the converter's: "
                                 f"max {(reread - ref).abs().max().item()}")
        del reread
        shutil.rmtree(hf_dir)
        torch.cuda.empty_cache()

        # The port's forward on the same .pt: bf16 through the kernels, float32 plain.
        model, pdims = load_model(str(pt), device=device)
        params = model.params()
        bf16 = ForwardConfig(compute_dtype="bfloat16", remat_encoder=False, remat_decoder=False,
                             **resolve_auto_impls(device))
        f32 = ForwardConfig(compute_dtype="float32", remat_encoder=False, remat_decoder=False)
        kernels = fs.reset_counts()
        with torch.no_grad():
            port_bf16 = forward_impl(params, mel, tokens, pdims, bf16)
            _sync()
            launches = {fn.__name__: fn.launches for fn in kernels}
            blocks = (W.encoder_forward.blocks_run, W.decoder_forward.blocks_run)
            port_f32 = forward_impl(params, mel, tokens, pdims, f32)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    expect = {"attn_fwd": sum(blocks), "attn_bwd": 0, "fused_adamw8_leaf": 0}
    if launches != expect or blocks != (pdims.n_audio_layer, pdims.n_text_layer):
        raise AssertionError(f"[package] launches {launches} != {expect} (blocks run {blocks})")
    cmp_bf16 = _compare_logits(port_bf16, ref, DECODE_LOGIT_TOL)
    cmp_f32 = _compare_logits(port_f32, ref, PACKAGE_F32_TOL)
    ref_std = ref.std().item()
    log(f"  [package] t+{time.perf_counter() - t_leg:.1f} s: HF float32 logits (std "
        f"{ref_std:.3f}) against the port: bf16 + attn_fwd "
        f"{json.dumps(cmp_bf16)}; float32 plain {json.dumps(cmp_f32)}; launches {launches}")
    for cmp, tol in ((cmp_bf16, DECODE_LOGIT_TOL), (cmp_f32, PACKAGE_F32_TOL)):
        if not cmp["max_abs_diff"] <= tol or cmp["argmax_agree"] != cmp["argmax_checked"]:
            raise AssertionError(f"[package] the port against the HF model: {cmp} (limit {tol})")
    del model, params, port_bf16, port_f32, ref, mel
    torch.cuda.empty_cache()

    # Publish locally; --convert-ct2 without ctranslate2; the batch CLI.
    assets = {n: ROOT / "whisper_v3_utils" / n for n in up.DEPLOYMENT_ASSET_FILES}
    t0 = time.perf_counter()
    publish(pt, "wft/large-v3-smoke")
    publish_s = time.perf_counter() - t0
    snapshots = {"wft/large-v3-smoke": _check_snapshot(PACKAGE_DIR / "cache",
                                                       "wft/large-v3-smoke", pt, assets)}
    shutil.rmtree(PACKAGE_DIR / "work")
    ct2 = None
    if versions["ctranslate2"] == "absent":
        try:
            publish(tiny_pt, "wft/tiny-ct2", "--convert-ct2")
        except ImportError as exc:
            ct2 = str(exc)
        if ct2 is None or "ctranslate2" not in ct2:
            raise AssertionError(f"[package] --convert-ct2 without ctranslate2: {ct2!r}")
    t0 = time.perf_counter()
    repos = ["wft/large-v3-batch", "wft/tiny-batch"]
    batch.run_batch([str(pt), str(tiny_pt)], repos, ["float16"], str(PACKAGE_DIR / "batch"),
                    local_only=True, convert_ct2=False, cache_dir=str(PACKAGE_DIR / "cache2"),
                    device=device)
    batch_s = time.perf_counter() - t0
    snapshots[repos[0]] = _check_snapshot(PACKAGE_DIR / "cache2", repos[0], pt, assets)
    snapshots[repos[1]] = _check_snapshot(PACKAGE_DIR / "cache2", repos[1], tiny_pt, {
        "config.json": PACKAGE_DIR / "batch" / "wft__tiny-batch" / "hf" / "config.json",
        "preprocessor_config.json": None})
    shutil.rmtree(PACKAGE_DIR)
    rec = {
        "versions": versions, "convert_s": convert_s, "convert_peak_bytes": convert_peak,
        "write_s": write_s, "disk_bytes": disk_bytes, "weight_bytes": weight_bytes,
        "reckoned_bytes": reckoned, "read_s": read_s, "multilingual": multilingual,
        "languages": n_lang, "logits_std": ref_std, "bf16": cmp_bf16, "float32": cmp_f32,
        "launches": launches, "blocks_run": list(blocks), "publish_s": publish_s,
        "batch_s": batch_s, "ct2_import_error": ct2, "snapshots": snapshots,
        "peak_bytes": torch.cuda.max_memory_allocated(), "s": time.perf_counter() - t_leg,
    }
    log(f"  [package] from_pretrained in {read_s:.1f} s, logits bit-equal; local publish "
        f"{publish_s:.1f} s, batch of 2 {batch_s:.1f} s, snapshots "
        f"{ {k: v['revision'][:12] for k, v in snapshots.items()} }; --convert-ct2: "
        f"{ct2!r}; leg {rec['s']:.1f} s, peak {rec['peak_bytes'] / GB:.3f} GB ({smi_line()})")
    return rec


def profile_steps(step, state, batch, gen, n_steps: int = 2) -> dict:
    """Device time by kernel over ``n_steps`` main-path steps
    (``torch.profiler``), grouped, with the device's busy share of the
    window's wall time. Only with ``--profile``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, loss = step(state, batch, gen)
            loss.item()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    groups = {"attention kernels": ("attn_",), "fused_adamw8": ("fused_adamw8",),
              "matmul": ("gemm", "xmma", "cutlass", "sm90_", "nvjet"),
              "convolution": ("conv", "cudnn", "implicit")}
    by_group = {}
    for e in kernels:
        name = e.key.lower()
        g = next((g for g, keys in groups.items() if any(k in name for k in keys)), "other")
        by_group[g] = by_group.get(g, 0.0) + e.self_device_time_total
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:25]
    log(f"  profile over {n_steps} steps: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{total_us / 1e3:.1f} ms ({100 * total_us / wall_us:.1f}%)")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"    {g}: {us / 1e3 / n_steps:.1f} ms/step ({100 * us / total_us:.1f}%)")
    for e in top:
        log(f"    {e.self_device_time_total / 1e3 / n_steps:8.2f} ms/step "
            f"{e.count // n_steps:6d}x  {e.key[:110]}")
    return {"steps": n_steps, "wall_ms": wall_us / 1e3, "device_ms": total_us / 1e3,
            "group_ms_per_step": {g: us / 1e3 / n_steps for g, us in by_group.items()},
            "top": [{"name": e.key, "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
                     "calls_per_step": e.count / n_steps} for e in top]}


def attention_entries(enc, cross, dec_self, attn_err, repeatable, fwd_res, by_leg,
                      per_step) -> list:
    """The ``kernels`` entries of ``attn_fwd`` and ``attn_bwd``: the encoder
    site's numbers at the top level, the other two sites under their names.
    ``by_leg`` maps a leg to its launch counts; it is empty when no leg ran."""
    tpu = "whisper_finetune_tpu/ops/attention.py"
    sources = {
        "attn_fwd": f"{tpu}:236 (splash_mha forward); {tpu}:53 (flash_mha forward); "
                    f"{tpu}:290 (flash_fwd_xla_bwd: the forward without residuals)",
        "attn_bwd": f"{tpu}:236 (splash_mha fused_bwd: dq and dk/dv); "
                    f"{tpu}:53 (flash_mha dK/dV and dQ kernels)",
    }
    routes = {"attn_fwd": ["splash", "flash", "flash_fwd"], "attn_bwd": ["splash", "flash"]}
    site_keys = ("shape", "causal", "ms", "eager_ms", "plain_ms", "library_ms",
                 "library_eager_ms", "bound_ms", "bound_by")
    entries = []
    for name in A_NAMES:
        r = enc[name]
        entry = {
            "name": name, "route": "cuda",
            "source": "whisper_finetune_torch/csrc/attention.cu",
            "replaces": sources[name], "attn_impls": routes[name],
            "launches": sum(leg[name] for leg in by_leg.values()),
            "launches_by_leg": {k: leg[name] for k, leg in by_leg.items()},
            "max_abs_err": attn_err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "launches_per_step": per_step.get(name, 0),
            "shape": r["shape"],
            **{site: {k: rec[name][k] for k in site_keys}
               for site, rec in (("cross", cross), ("decoder_self", dec_self))},
        }
        if name == "attn_fwd":
            entry["resources"] = fwd_res
            entry["repeatable"] = "o and lse bit-equal over two runs"
            entry["no_lse"] = {"max_abs_err": attn_err["attn_fwd_nolse"], **{
                site: {"ms": rec[name]["nolse_ms"], "plain_ms": rec[name]["nolse_plain_ms"]}
                for site, rec in (("encoder", enc), ("cross", cross), ("decoder_self", dec_self))}}
        else:
            entry["dq_max_diff_between_runs"] = repeatable["dq_max_diff"]
        entries.append(entry)
    return entries


def print_result(kernels: list) -> None:
    """The last three lines of the output."""
    import torch

    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


T_START = time.perf_counter()


def main() -> int:
    if "--ddp-rank" in sys.argv[1:]:
        return ddp_rank(sys.argv[sys.argv.index("--ddp-rank") + 1])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "whisper_finetune_torch" / "csrc").is_dir():
        print(f"chip_smoke: no whisper_finetune_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from whisper_finetune_torch import _build

    smi = smi_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"card: {smi}")
    libs = _build.libraries(verbose_ptxas=True)
    log(f"kernels built in {libs.build_seconds:.1f} s")
    for line in libs.ptxas_log.splitlines():
        if any(w in line for w in ("registers", "spill", "arning", "wgmma")) or line.startswith("=="):
            log("  " + line.strip())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    log("kernels vs plain twins:")
    fwd_res = fwd_resources(libs.ptxas_log)
    attn_err = check_attention(gen)
    check_fwd_repeatable(gen)
    repeatable = check_bwd_repeatable(gen)
    adam = check_adamw8(gen)
    log("timing at main-path shapes:")
    enc = time_attention(gen, "encoder self-attention", 8, 20, 1500, 1500)
    cross = time_attention(gen, "cross-attention", 8, 20, 448, 1500)
    dec_self = time_attention(gen, "decoder self-attention (causal)", 8, 20, 448, 448,
                              causal=True)
    dec_route = time_decoder_self(gen)
    for site in (enc, cross, dec_self):
        for name in A_NAMES:
            r = site[name]
            log(f"  {name} [{r['site']}]: {r['ms']:.3f} ms device time (eager loop "
                f"{r['eager_ms']:.3f}; plain {r['plain_ms']:.3f}; library {r['library_ms']:.3f}, "
                f"eager {r['library_eager_ms']:.3f}; bound {r['bound_ms']:.3f} by "
                f"{r['bound_by']}; {r['tflops']:.1f} TFLOP/s)")
        log(f"  attn_fwd without lse [{site[A_NAMES[0]]['site']}]: "
            f"{site['attn_fwd']['nolse_ms']:.3f} ms (plain {site['attn_fwd']['nolse_plain_ms']:.3f})")
    log(f"  decoder self-attention 8x20x448x448 causal, forward+backward: kernels "
        f"{dec_route['kernels']['fwd_bwd_ms']:.3f} ms, plain path {dec_route['plain']['fwd_bwd_ms']:.3f} ms; "
        f"forward alone {dec_route['kernels']['fwd_ms']:.3f} / {dec_route['plain']['fwd_ms']:.3f} ms")

    if "--kernels-only" in sys.argv[1:]:
        print_result(attention_entries(enc, cross, dec_self, attn_err, repeatable, fwd_res, {}, {}))
        return 0

    log("main path:")
    main_rec, state, step, batch, step_gen, full_first_step = main_path()
    if "--profile" in sys.argv[1:]:
        main_rec["profile"] = profile_steps(step, state, batch, step_gen)
    log("fused_adamw8 vs plain twin on large-v3's own leaves and state:")
    adam = check_adamw8_leaves(state.model, state.opt_state, gen, adam)
    adam_t = time_adamw8(state.model, state.opt_state, gen)
    log(f"  fused_adamw8 over {adam_t['leaves']} leaves ({adam_t['elements']} elements): "
        f"{adam_t['ms']:.3f} ms (plain {adam_t['plain_ms']:.3f}, bound "
        f"{adam_t['bound_ms']:.3f}, {adam_t['gbps']:.0f} GB/s)")

    # The first slice's model and state go before the flagship legs, so that
    # each leg's peak memory is its own.
    del state, step, step_gen
    torch.cuda.empty_cache()
    log("Muon flagship (configs/config_large_v3_best_muon.yaml):")
    legs = {
        "flash": flagship_leg("flash", "flash", None, None, steps=3, warmup=1),
        "flash_fwd": flagship_leg(
            "flash_fwd", "flash_fwd", (4, 4), 2, steps=2, warmup=0, stochastic_depth=0.0,
            optimizer_extra={"8bit": True, "muon_momentum_dtype": "int8", "muon_aux_8bit": True}),
        "auto": flagship_leg("auto", "auto", (4, 4), None, steps=2, warmup=0),
    }
    if legs["flash_fwd"]["launches"]["attn_fwd"] != 96:
        raise AssertionError(f"flash_fwd leg: {legs['flash_fwd']['launches']} (96 forwards expected)")
    if legs["flash"]["launches"]["fused_adamw8_leaf"] != 0:
        raise AssertionError("flash leg launched the 8-bit AdamW kernel")
    if not legs["flash_fwd"]["launches"]["fused_adamw8_leaf"] > 0:
        raise AssertionError("flash_fwd leg: the 8-bit auxiliary AdamW launched no kernel")
    for leg in legs.values():
        print(json.dumps({"leg": leg["leg"], "step_ms_median": leg["step_s_median"] * 1e3,
                          "step_ms_max": leg["step_s_max"] * 1e3,
                          "audio_hours_per_s": leg["audio_hours_per_s"],
                          "peak_gib": leg["peak_mem_bytes"] / 2**30,
                          "optimizer_update_ms": leg["update_s_median"] * 1e3,
                          "launches": leg["launches"], "blocks_run": leg["blocks_run"]}),
              flush=True)

    SCRATCH.mkdir(parents=True, exist_ok=True)
    log("remat policies on the first slice:")
    remat = remat_leg(main_rec, full_first_step, batch)
    del full_first_step
    log("LoRA (configs/config_small_lora.yaml):")
    lora = lora_leg()
    log("layer surgery (init_name whisper-4832):")
    surgery = surgery_leg(batch)
    del batch
    torch.cuda.empty_cache()
    log("training driver (scripts/finetune.py on large-v3):")
    driver = driver_leg(main_rec["step_s_median"])
    print(json.dumps({"leg": "driver", "step_ms_median": driver["step_s_median"] * 1e3,
                      "host_batch_build_ms_median": driver["host_batch_build_s_median"] * 1e3,
                      "first_slice_step_ms_median": driver["first_slice_step_s_median"] * 1e3,
                      "peak_gib": driver["peak_mem_bytes"] / 2**30, "saves": driver["saves"],
                      "launches": driver["launches"], "card": smi_line()}), flush=True)
    log("data parallelism (ZeRO-1, two ranks on the card; reference one rank over NCCL):")
    ddp = ddp_leg(driver)
    print(json.dumps({"leg": "ddp", "backend": ddp["backend"], "world": ddp["world"],
                      "reference_backend": ddp["reference_backend"],
                      "step_ms": ddp["step_ms"], "peak_gb": [b / GB for b in ddp["peak_bytes"]],
                      "peak_reckoned_gb": [b / GB for b in ddp["peak_reckoned_bytes"]],
                      "collectives_per_step": ddp["comm_per_step"],
                      "save_s": ddp["save_s"], "read_s": ddp["read_s"],
                      "train_state_gb": ddp["file_gb"], "launches": ddp["launches"],
                      "card": smi_line()}), flush=True)
    log("the one-chip Muon flagship: split step, manual backward "
        "(configs/config_large_v3_best_muon_1chip.yaml):")
    split = split_leg()
    print(json.dumps({"leg": "split", "step_ms": [x * 1e3 for x in split["step_s_all"]],
                      "accum_ms": [x["accum_s"] * 1e3 for x in split["timings"]],
                      "update_ms": [x["update_s"] * 1e3 for x in split["timings"]],
                      "peak_gb": split["peak_mem_bytes"] / GB,
                      "accum2_peak_gb": {k: v["peak_bytes"] / GB
                                         for k, v in split["compare"].items()},
                      "batch32_peak_gb": split["big_batch"]["peak_bytes"] / GB,
                      "launches": split["launches"], "card": smi_line()}), flush=True)
    log("KV-cached decoding and the transcribe CLI (large-v3):")
    decode = decode_leg(DRIVER_PT)
    print(json.dumps({"leg": "decode", "encoder_ms": decode["encoder_ms"],
                      "greedy_ms_per_token": decode["greedy_per_token"]["ms"],
                      "beam_ms_per_token": decode["beam_per_token"]["ms"],
                      "bound_ms_per_token": [decode["greedy_per_token"]["bound_ms"],
                                             decode["beam_per_token"]["bound_ms"]],
                      "rung_s": decode["rung_s"], "beam_s": decode["beam_s"],
                      "peak_gb": [decode["greedy_peak_bytes"] / GB, decode["beam_peak_bytes"] / GB],
                      "logit_max_abs_diff": decode["logit_max_abs_diff"],
                      "launches": decode["launches"], "cli_s": decode["cli"]["s"],
                      "card": smi_line()}), flush=True)
    log("packaging: convert to HF, local publish, batch publish (large-v3):")
    package = package_leg(DRIVER_PT)
    DRIVER_PT.unlink()
    print(json.dumps({"leg": "package", **{k: package.get(k) for k in (
        "versions", "convert_s", "write_s", "read_s", "publish_s", "batch_s", "s")},
        "disk_gb": package.get("disk_bytes", 0) / GB,
        "peak_gb": package.get("peak_bytes", 0) / GB,
        "logit_max_abs_diff": {k: package[k]["max_abs_diff"] for k in ("bf16", "float32")
                               if k in package},
        "launches": package["launches"], "card": smi_line()}), flush=True)
    new_legs = {**{f"remat {k}": v for k, v in remat.items()}, "lora": lora, "surgery": surgery}
    for name, leg in new_legs.items():
        print(json.dumps({"leg": name, "step_ms_median": leg["step_s_median"] * 1e3,
                          "step_ms_all": [t * 1e3 for t in leg["step_s_all"]],
                          "peak_gib": leg["peak_mem_bytes"] / 2**30,
                          "peak_over_full_gb": (leg["peak_over_full_bytes"] / GB
                                                if "peak_over_full_bytes" in leg else None),
                          "launches": leg["launches"]}), flush=True)

    per_step = main_rec["launches_per_step"]
    by_leg = {"splash_adamw8": main_rec["launches"], **{k: v["launches"] for k, v in legs.items()},
              **{k: v["launches"] for k, v in new_legs.items()}, "driver": driver["launches"],
              **ddp["launches"], "split accum 2 x 3": split["compare_launches"],
              "split": split["launches"], "decode": decode["launches"],
              "package": package["launches"]}
    kernels = attention_entries(enc, cross, dec_self, attn_err, repeatable, fwd_res, by_leg,
                                per_step)
    kernels.append({
        "name": "fused_adamw8", "route": "cuda",
        "source": "whisper_finetune_torch/csrc/fused_adamw8.cu",
        "replaces": "whisper_finetune_tpu/ops/fused_adamw8.py:132 (fused_adamw8_leaf)",
        "launches": sum(leg["fused_adamw8_leaf"] for leg in by_leg.values()),
        "launches_by_leg": {k: leg["fused_adamw8_leaf"] for k, leg in by_leg.items()},
        "max_abs_err": adam["p"],
        "ms": adam_t["ms"], "plain_ms": adam_t["plain_ms"], "bound_ms": adam_t["bound_ms"],
        "bound_by": adam_t["bound_by"], "library_ms": None,
        "launches_per_step": per_step["fused_adamw8_leaf"],
        "codes_off_by_one": {"m": adam["m_codes_off"], "nu": adam["n_codes_off"]},
    })

    record = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": libs.build_seconds, "kernels": kernels, "attention_timing":
              {"encoder": enc, "cross": cross, "decoder_self": dec_self,
               "decoder_self_routes": dec_route}, "adamw8_timing": adam_t,
              "adamw8_check": adam, "attn_bwd_repeatable": repeatable,
              "main_path": main_rec, "flagship_legs": legs, "model_layer_legs": new_legs,
              "driver_leg": driver, "ddp_leg": ddp, "split_leg": split, "decode_leg": decode,
              "package_leg": package,
              "seconds": time.perf_counter() - T_START}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    log(f"chip_smoke: {record['seconds']:.1f} s in all")
    print_result(kernels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
