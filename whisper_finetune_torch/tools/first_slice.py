"""The first slice's training step and its step loop, shared by
``chip_smoke.py`` and ``python -m whisper_finetune_torch.tools.remat_policies``.

The first slice: large-v3 (random weights from seed 0, or a given model),
8-bit AdamW(2e-5, wd 0.01), bf16 compute, ``attn_impl: auto`` (on a card the
kernels at all three attention sites), log-mel + SpecAugment inside the
step, label smoothing 0.1, clip 1.0, bf16 gradient accumulator, over a batch
of synthetic 30 s audio.
:func:`record_grad_norms` keeps the norms of a step's gradients, layer by
layer, so that one remat policy's backward can be held against another's.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch


def build(dims, policy: str = "full", model=None, device="cuda"):
    """(state, step, tx, leaves through ``fused_adamw8`` a step) of the
    first slice under ``policy`` over ``model`` (random from seed 0 if
    None)."""
    from whisper_finetune_torch.models import ForwardConfig, init_params
    from whisper_finetune_torch.ops.attention import resolve_auto_impls
    from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig
    from whisper_finetune_torch.optim import adamw_8bit
    from whisper_finetune_torch.optim.quantized import BLOCK, QMoment
    from whisper_finetune_torch.train import TrainState, make_train_step

    if model is None:
        model = init_params(dims, device=device, seed=0)
    leaves = [p for _, p in model.leaves()]
    tx = adamw_8bit(2e-5, weight_decay=0.01)
    state = TrainState(model, tx.init(leaves), 0)
    fcfg = ForwardConfig(compute_dtype="bfloat16", remat_policy=policy,
                         **resolve_auto_impls(device))
    feat = FeaturizeConfig(n_mels=dims.n_mels, spec_augment=True, p=1.0)
    step = make_train_step(dims, fcfg, tx, 0.1, feat_cfg=feat, max_grad_norm=1.0,
                           accum_dtype="bfloat16", device=device)
    fused = sum(isinstance(mu, QMoment) and p.numel() % BLOCK == 0
                for p, mu in zip(leaves, state.opt_state.mu))
    return state, step, tx, fused


def synthetic_batch(dims, accum: int = 1, batch: int = 8, seed: int = 0, device="cuda"):
    """``(accum, batch, ...)`` tensors of 30 s audio, ``N(0, 0.05²)``, and
    random tokens, from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = {
        "audio": torch.from_numpy(
            (rng.standard_normal((accum, batch, 480000)) * 0.05).astype(np.float32)),
        "crop_frames": torch.full((accum, batch), 3000, dtype=torch.int32),
        "dec_input": torch.from_numpy(
            rng.integers(0, dims.n_vocab, (accum, batch, dims.n_text_ctx)).astype(np.int64)),
        "dec_output": torch.from_numpy(
            rng.integers(0, dims.n_vocab, (accum, batch, dims.n_text_ctx)).astype(np.int64)),
    }
    return {k: v.to(device) for k, v in out.items()}


def attn_sites(fcfg, enc_blocks: int, dec_blocks: int) -> dict:
    """The attention sites that ``enc_blocks`` encoder and ``dec_blocks``
    decoder blocks run through the kernels under ``fcfg``: ``fwd`` through
    ``attn_fwd`` (once a forward pass, again in a remat recompute or manual
    replay), ``bwd`` through ``attn_bwd`` (once a backward), and of them
    ``causal_fwd`` / ``causal_bwd`` the decoder's self-attention."""
    fwd_routes, bwd_routes = ("splash", "flash", "flash_fwd"), ("splash", "flash")
    out = {}
    for key, routes in (("fwd", fwd_routes), ("bwd", bwd_routes)):
        causal = dec_blocks * (fcfg.dec_attn in routes)
        out[key] = (enc_blocks * (fcfg.enc_attn in routes) + causal
                    + dec_blocks * (fcfg.cross_attn in routes))
        out[f"causal_{key}"] = causal
    return out


def reset_counts() -> tuple:
    """Sets every kernel's launch counter (the attention kernels' causal
    counts too) and the forwards' ``blocks_run`` to 0; returns the attention
    and AdamW kernels' wrappers (the layer norms' are
    ``ops/layer_norm.py::KERNELS``)."""
    from whisper_finetune_torch.models import whisper as W
    from whisper_finetune_torch.ops import attention as A
    from whisper_finetune_torch.ops import layer_norm as LN
    from whisper_finetune_torch.ops.fused_adamw8 import fused_adamw8_leaf

    kernels = (*A.KERNELS, fused_adamw8_leaf)
    for fn in (*kernels, *LN.KERNELS):
        fn.launches = 0
    for fn in A.KERNELS:
        fn.causal_launches = 0
    W.encoder_forward.blocks_run = W.decoder_forward.blocks_run = 0
    return kernels


def run_steps(name: str, step, state, batch, gen, warmup: int, timed: int, log=print,
              after_first=None):
    """``warmup + timed`` steps (host clock around a synchronised step) with
    the launch counters zeroed before and read after; the peak is reset
    after the warm-up; ``after_first(state)`` runs after the first step,
    outside the timing. Returns (state, record)."""
    kernels = reset_counts()
    losses, times = [], []
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch, gen)
        loss = float(loss)  # syncs
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(loss)
        if i >= warmup:
            times.append(dt)
        log(f"  [{name}] step {i}: loss {loss:.4f}, {dt * 1e3:.1f} ms")
        if i == 0 and after_first is not None:
            after_first(state)
    return state, {
        "losses": losses, "step_s_all": times, "step_s_median": statistics.median(times),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": {fn.__name__: fn.launches for fn in kernels},
    }


def layer_grad_norms(paths, grads) -> torch.Tensor:
    """Float32 norms of ``grads`` on the host: one per layer for a stacked
    block leaf (a path through ``blocks``, layers on dim 0), one per leaf
    otherwise, in the leaves' order."""
    out = []
    for path, g in zip(paths, grads):
        g = g.detach().float()
        out.append(g.flatten(1).norm(dim=1) if "blocks" in path else g.norm().reshape(1))
    return torch.cat(out).cpu()


def record_grad_norms(tx, paths) -> list:
    """Wraps ``tx.fused_apply`` so that its first call (the first step's
    update) appends :func:`layer_grad_norms` of the gradient sums it is
    given to the returned list."""
    apply, out = tx.fused_apply, []

    def fused_apply(grads, *args, **kwargs):
        if not out:
            out.append(layer_grad_norms(paths, grads))
        return apply(grads, *args, **kwargs)

    tx.fused_apply = fused_apply
    return out


def norms_rel_diff(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest ``|got - ref| / ref`` over the norms (NaN-safe: a NaN gives
    inf)."""
    d = ((got - ref).abs() / ref.clamp_min(1e-30)).max().item()
    return d if d == d else float("inf")
