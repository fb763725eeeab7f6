"""The ``train`` kind: a shipped training recipe's optimizer steps on the card.

Set-up builds the step as ``scripts/finetune.py::main`` does (the recipe
through ``validate_config``; the model from the seed's weights with every
leaf trainable; ``build_forward_config`` / ``build_featurize_config``; the
optimizer and schedule of ``optim``; ``make_train_step`` with the keys
``resolve_step_keys`` gives), then drives that one step object through its
first two optimizer steps, which warm up every shape the window uses and are
the steps the reference follows. The window then runs whole optimizer steps
until ``--seconds`` have passed, closing at the end of the first step that
ends after them. As ``finetune.main_loop`` does, the next batch is built on
the host (the port's ``collate``, ``stack_microbatches`` and ``to_device``)
after the step call returns and before the loss is read.

Traffic (``benchmark/traffic/<name>.json``): synthetic 30 s clips of
N(0, ``audio_std``^2) noise, ``distinct_rows`` of them made from the seed and
cycled in a seeded order (the first two steps' rows all differ); random text
of ``text_tokens`` [lo, hi] ids after the prompt; the recipe's batch and
accumulation. Stochastic depth and deep SpecAugment draws are made here and
handed in: each step drops the same number of encoder and of decoder blocks
whatever the seed (``round(rate * accum * layers)`` coins below the rate,
the rest above it, in a seeded order), so the seed changes which work, not
how much.
"""

from __future__ import annotations

import copy
import gc
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import yaml

from benchmark import spec
from benchmark.reference.train import ReferenceTrainer
from benchmark.reference.whisper import Draws, Precision, no_tf32
from benchmark.trace import Profiled
from benchmark.weights import leaf_specs, make_leaf, make_weights

GIB = float(1 << 30)
N_SAMPLES = 480000


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def load_recipe(cell: Mapping) -> Dict:
    """The recipe's YAML (a frozen copy under ``benchmark/recipes``) with
    the cell's ``overrides`` ({"section.key": value})."""
    with open(spec.ROOT / cell["traffic_spec"]["recipe"], encoding="utf-8") as f:
        recipe = yaml.safe_load(f)
    for dotted, value in (cell.get("overrides") or {}).items():
        node = recipe
        keys = dotted.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return recipe


def stratified_coins(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    """``n`` float32 coins of which exactly ``round(rate * n)`` fall below
    ``rate`` (uniform there) and the rest above it, in a random order."""
    k = int(round(rate * n))
    low = rng.uniform(0.0, rate, size=k) if rate > 0 else np.zeros(0)
    high = rng.uniform(rate, 1.0, size=n - k)
    coins = np.concatenate([low, high]).astype(np.float32)
    coins = np.minimum(coins, np.float32(np.nextafter(np.float32(1.0), np.float32(0.0))))
    return coins[rng.permutation(n)]


class Feed:
    """The cell's data: host clips, token rows, forward draws, a step's
    batch."""

    def __init__(self, traffic: Mapping, recipe: Mapping, dims: Mapping, seed: int, device):
        self.rows = int(recipe["dataset"]["batch_size"])
        self.accum = int(recipe["training"]["accum_grad_steps"])
        self.dims, self.seed, self.device = dims, int(seed), torch.device(device)
        self.pad_to = int(traffic["pad_to"])
        self.sd = float(recipe["training"].get("stochastic_depth", 0.0))
        R = int(traffic["distinct_rows"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 7 + 1) % (1 << 63))
        clips = torch.randn((R, N_SAMPLES), generator=gen, device=self.device)
        self.clips = (clips * float(traffic["audio_std"])).cpu().numpy()
        del clips
        rng = np.random.default_rng([self.seed, 1])
        prompt = [int(t) for t in traffic["prompt"]]
        eot = int(traffic["eot"])
        lo, hi = traffic["text_tokens"]
        self.tokens = []
        for n in rng.integers(int(lo), int(hi) + 1, size=R):
            text = rng.integers(0, eot, size=int(n)).tolist()
            self.tokens.append((prompt + text, prompt[1:] + text + [eot]))
        self.order = rng.permutation(R)

    def host_batch(self, k: int) -> Dict[str, np.ndarray]:
        """Step ``k``'s (accum, B, ...) arrays, laid out by the port's
        ``collate`` and ``stack_microbatches``."""
        from whisper_finetune_torch.data import collate, stack_microbatches

        per_step = self.rows * self.accum
        idx = [int(self.order[(k * per_step + j) % len(self.order)]) for j in range(per_step)]
        micro = []
        for m in range(self.accum):
            samples = [{"audio": self.clips[r], "crop_frames": 3000,
                        "dec_input": self.tokens[r][0], "dec_output": self.tokens[r][1]}
                       for r in idx[m * self.rows:(m + 1) * self.rows]]
            micro.append(collate(samples, pad_to=self.pad_to))
        return stack_microbatches(micro)

    def device_batch(self, k: int) -> Dict[str, torch.Tensor]:
        from whisper_finetune_torch.data import to_device

        return to_device(self.host_batch(k), self.device)

    def draws(self, k: int) -> List[Draws]:
        """Step ``k``'s forward draws, one a microbatch."""
        Le, Ld = int(self.dims["n_audio_layer"]), int(self.dims["n_text_layer"])
        rng = np.random.default_rng([self.seed, 2, k])
        enc = stratified_coins(rng, self.accum * Le, self.sd).reshape(self.accum, Le)
        dec = stratified_coins(rng, self.accum * Ld, self.sd).reshape(self.accum, Ld)
        u = rng.random((self.accum, 1 + 4 * Le), dtype=np.float32)
        return [Draws(enc[i], dec[i], u[i, 0], u[i, 1:1 + 2 * Le].reshape(Le, 2),
                      u[i, 1 + 2 * Le:].reshape(Le, 2)) for i in range(self.accum)]


def program_draws(draws: List[Draws]):
    from whisper_finetune_torch.models.whisper import ForwardDraws

    return [ForwardDraws(enc_coin=d.enc_coin, dec_coin=d.dec_coin, dsa_gate=d.dsa_gate,
                         dsa_time=d.dsa_time, dsa_feat=d.dsa_feat) for d in draws]


# ---------------------------------------------------------------------------
# The program's step
# ---------------------------------------------------------------------------

class TimedTx:
    """The optimizer, with CUDA events around each ``fused_apply`` while
    ``timing`` is on."""

    def __init__(self, tx):
        self.tx = tx
        self.timing = False
        self.events = []

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def init(self, params):
        return self.tx.init(params)

    def fused_apply(self, grads, state, params, g_scale=None):
        if not self.timing:
            return self.tx.fused_apply(grads, state, params, g_scale=g_scale)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.tx.fused_apply(grads, state, params, g_scale=g_scale)
        b.record()
        self.events.append((a, b))
        return out


def build_step(recipe: Mapping, dims_obj, seed: int, device, horizon: int):
    """(step, state, tx, model) built as the training script builds them."""
    from whisper_finetune_torch.config import (build_featurize_config, build_forward_config,
                                               resolve_step_keys, validate_config)
    from whisper_finetune_torch.models.whisper import Whisper
    from whisper_finetune_torch.optim import get_optimizer, get_schedule
    from whisper_finetune_torch.train.step import (TrainState, make_train_step,
                                                   mark_trainable, trainable_leaves)

    config = validate_config(copy.deepcopy(dict(recipe)))
    model = Whisper(dims_obj, make_weights(dims_obj.to_dict(), seed, device))
    mark_trainable(model.params(), None)
    fcfg = build_forward_config(config, False, device)
    feat_cfg = build_featurize_config(config, dims_obj.n_mels)
    schedule = get_schedule(config["lr_scheduler"], horizon)
    named = trainable_leaves(model)
    opt, _ = get_optimizer(named, config["optimizer"], schedule=schedule)
    tx = TimedTx(opt)
    state = TrainState(model, tx.init([p for _, p in named]), 0)
    keys, _ = resolve_step_keys(config, True, False)
    t = config["training"]
    step = make_train_step(dims_obj, fcfg, tx, label_smoothing=float(t["label_smoothing"]),
                           feat_cfg=feat_cfg, max_grad_norm=float(t["max_grad_norm"]),
                           accum_dtype=t.get("grad_accum_dtype"), **keys, device=device)
    return step, state, tx, model, config


def first_gradient_norms(opt_state, tx, leaves, b1: float) -> List[float]:
    """Each leaf's gradient as the optimizer got it at the first update,
    worked out from the optimizer's state after it: Muon's momentum is that
    gradient; an Adam first moment is (1 - b1) times it (8-bit codes read
    back through their block scales)."""

    def moment(m, like):
        if isinstance(m, torch.Tensor):
            return m.float()
        codes, scale = m
        return (codes.float() * scale).reshape(-1)[:like.numel()].view(like.shape)

    norms = []
    if hasattr(opt_state, "muon"):
        mu_it = iter(opt_state.muon.momentum)
        ad_it = iter(opt_state.adamw.mu)
        for label, p in zip(tx.labels, leaves):
            if label == "muon":
                g = moment(next(mu_it), p)
            else:
                g = moment(next(ad_it), p) / (1.0 - b1)
            norms.append(float(torch.linalg.vector_norm(g.double())))
    else:
        for m, p in zip(opt_state.mu, leaves):
            norms.append(float(torch.linalg.vector_norm(moment(m, p).double()) / (1.0 - b1)))
    return norms


def change_norms(leaves, dims: Mapping, seed: int, device) -> List[float]:
    """Each leaf's distance from the seed's weights, leaf by leaf made anew."""
    out = []
    for i, (spec_i, p) in enumerate(zip(leaf_specs(dims), leaves)):
        p0 = make_leaf(spec_i, seed, i, device)
        out.append(float(torch.linalg.vector_norm((p.detach() - p0).double())))
        del p0
    return out


def _counters() -> Dict[str, int]:
    from whisper_finetune_torch.models.whisper import decoder_forward, encoder_forward
    from whisper_finetune_torch.ops.attention import attn_bwd, attn_fwd
    from whisper_finetune_torch.ops.fused_adamw8 import fused_adamw8_leaf

    return {"attn_fwd": attn_fwd.launches, "attn_bwd": attn_bwd.launches,
            "fused_adamw8": fused_adamw8_leaf.launches,
            "enc_blocks_run": encoder_forward.blocks_run,
            "dec_blocks_run": decoder_forward.blocks_run}


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------

def compare(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """The numbers compared: the widest loss gap over the steps (nats); the
    worst leaf's gap between the two first-gradient norms and between the two
    parameter-change norms, each over the larger of that leaf's reference
    norm and the median leaf's. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change."""
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = np.asarray(ref["grad_norms"])
    g_med = float(np.median(g_ref))
    grad_gap = max(abs(a - b) / max(b, g_med) for a, b in zip(prog["grad_norms"], g_ref))
    keep = g_ref >= 1e-3 * g_med
    c_ref = np.asarray(ref["change_norms"])[keep]
    c_prog = np.asarray(prog["change_norms"])[keep]
    c_med = float(np.median(c_ref))
    change_gap = max(abs(a - b) / max(b, c_med) for a, b in zip(c_prog, c_ref))
    return {"loss_gap": float(loss_gap), "grad_gap": float(grad_gap),
            "change_gap": float(change_gap), "leaves_left_out": int((~keep).sum())}


def reference_readings(cell: Mapping, recipe: Mapping, dims: Mapping, seed: int, device,
                       feed: Feed, gen_states, precision: str = "float32",
                       n_steps: int = 2) -> Dict:
    """The reference's losses, first-gradient norms and parameter-change
    norms over the first ``n_steps`` steps."""
    horizon = int(cell["traffic_spec"]["schedule_steps"])
    w = make_weights(dims, seed, device)
    trainer = ReferenceTrainer(w, dims, recipe, horizon, Precision(precision),
                               int(cell["traffic_spec"]["reference_slice_rows"]))
    losses, grad_norms = [], None
    with no_tf32():
        for k in range(n_steps):
            hb = feed.host_batch(k)
            batch = {key: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for key, v in hb.items()}
            for key in ("dec_input", "dec_output"):
                batch[key] = batch[key].long()
            r = trainer.step(batch, feed.draws(k), gen_states[k])
            losses.append(r["loss"])
            if grad_norms is None:
                grad_norms = [float(torch.linalg.vector_norm(g.double())) for g in r["grads"]]
            del r, batch
    leaves = [leaf for _, leaf in trainer.named]
    changes = change_norms(leaves, dims, seed, device)
    del trainer, w, leaves
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": changes}


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def program_first_steps(recipe, dims_obj, seed, device, feed, horizon, wrap_step=None):
    """Build the step and run its first two optimizer steps: (step, state,
    tx, model, the program's readings, the SpecAugment generator, its states
    before each step, the next batch). ``wrap_step`` (the control's faults)
    replaces the step by ``wrap_step(step, tx)``."""
    dims = dims_obj.to_dict()
    step, state, tx, model, config = build_step(recipe, dims_obj, seed, device, horizon)
    if wrap_step is not None:
        step = wrap_step(step, tx)
    named_paths = [path for path, _ in model.leaves()]
    if named_paths != [s[0] for s in leaf_specs(dims)]:
        raise RuntimeError("the program's leaves are not the benchmark's weights' leaves")
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 13 + 5) % (1 << 63))
    b1 = float((config["optimizer"].get("params") or {}).get("betas", (0.9, 0.999))[0])
    readings = {"losses": []}
    gen_states = []
    batch = feed.device_batch(0)
    for k in range(2):
        gen_states.append(gen.get_state())
        state, loss = step(state, batch, gen, program_draws(feed.draws(k)))[:2]
        batch = feed.device_batch(k + 1)
        readings["losses"].append(float(loss))
        if k == 0:
            readings["grad_norms"] = first_gradient_norms(
                state.opt_state, tx, [p for _, p in model.leaves()], b1)
    readings["change_norms"] = change_norms([p for _, p in model.leaves()], dims, seed, device)
    return step, state, tx, model, readings, gen, gen_states, batch


def run(cell: Mapping, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", dims_override: Optional[Mapping] = None) -> Dict:
    """One run of a ``train`` cell; returns the result's fields (metrics by
    name, the record the per-layer readers take, the check's numbers)."""
    from whisper_finetune_torch.models.dims import MODEL_PRESETS

    dev = torch.device(device)
    cfg = cell["config_spec"]
    dims_obj = MODEL_PRESETS[cfg["preset"]]
    if dims_override:
        dims_obj = dims_obj.replace(**dims_override)
    dims = dims_obj.to_dict()
    recipe = load_recipe(cell)
    horizon = int(cell["traffic_spec"]["schedule_steps"])
    feed = Feed(cell["traffic_spec"], recipe, dims, seed, dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    step, state, tx, model, prog, gen, gen_states, batch = program_first_steps(
        recipe, dims_obj, seed, dev, feed, horizon)
    setup_s = time.monotonic() - t_start
    per_step = feed.rows * feed.accum

    import torch.autograd.profiler as tprof

    c0 = _counters()
    tx.timing = trace and cuda
    n_steps, k = 0, 2
    trace_steps = int(cell["traffic_spec"]["trace_steps"])
    with Profiled(trace and cuda) as prof:
        with tprof.record_function("bench.window"):
            t0 = time.perf_counter()
            while True:
                with tprof.record_function("bench.step"):
                    state, loss = step(state, batch, gen, program_draws(feed.draws(k)))[:2]
                with tprof.record_function("bench.host_batch"):
                    batch = feed.device_batch(k + 1)
                with tprof.record_function("bench.loss_sync"):
                    float(loss)
                n_steps += 1
                k += 1
                if (n_steps >= trace_steps) if trace else (time.perf_counter() - t0 >= seconds):
                    break
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    c1 = _counters()
    t_window_end = time.monotonic()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    update_ms = [a.elapsed_time(b) for a, b in tx.events]
    accum_bytes = 2 if recipe["training"].get("grad_accum_dtype") in ("bfloat16", "bf16") else 4
    q_elems = sum(p.numel() for _, p in model.leaves() if p.numel() >= 4096 and p.numel() % 256 == 0)
    del step, state, tx, model, batch, gen
    _free()

    ref = reference_readings(cell, recipe, dims, seed, dev, feed, gen_states)
    numbers = compare(prog, ref)
    seconds_taken = {"setup": setup_s, "window": window_s,
                     "reference": time.monotonic() - t_window_end}
    limits = cell["limits"]
    check = {name: {"value": numbers[name], "limit": float(limits[name])}
             for name in ("loss_gap", "grad_gap", "change_gap")}
    correct = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in check.values())
    samples = n_steps * per_step
    record = {
        "kind": "train", "dims": dims, "rows": feed.rows, "accum": feed.accum,
        "steps": n_steps, "window_s": window_s, "trace": prof.result,
        "counters": {key: c1[key] - c0[key] for key in c0}, "update_ms": update_ms,
        "adamw8_elements": q_elems, "grad_bytes": accum_bytes,
    }
    return {
        "correct": bool(correct), "attempted": samples, "failed": 0,
        "e2e": {"train_audio_h_per_s": samples * 30.0 / 3600.0 / window_s,
                "peak_mem_gib": peak / GIB, "setup_s": setup_s},
        "record": record, "peak_bytes": peak, "check": check,
        "readings": {"program": prog, "reference": ref, "numbers": numbers,
                     "seconds": seconds_taken},
    }

