"""Training driver: ``python -m whisper_finetune_torch.scripts.finetune --config x.yaml``.

The port of ``whisper_finetune_tpu/scripts/finetune.py`` with the same YAML
schema, CLI and run flow: config validation, seeding, the global -> local
accumulation mapping, the model build (base checkpoint, layer surgery,
LoRA, frozen leaves), dataset processing, step math, samplers, optimizer and
schedule, the initial eval, the train loop with its ``perf/*``, parameter
and gradient telemetry, periodic eval with best/step checkpoints, the
divergence kill-switch, the last checkpoint and the peak-memory report.

It runs on one card (``--device cuda``, the default; it raises without
one) or, when asked, on the CPU (``--device cpu``). Under ``torchrun`` (see
``launchers/torchrun_finetune.sh``) one process drives one card
(``cuda:LOCAL_RANK``): the ranks read disjoint shards of each epoch
(``ShardedSampler``), seed their random draws with ``seed + rank``, split
the global ``accum_grad_steps`` between them and reduce the gradients once
an optimizer step; ``zero_shard_optimizer`` shards the optimizer state
(ZeRO-1), and without it Muon's Newton-Schulz splits over the ranks. Rank 0
logs and writes the ``.pt`` checkpoints; the ranks meet at barriers around
them. ``training.save_train_state`` writes the whole train state at every
eval step (``train/state_io.py``) and ``training.resume_from`` continues
from one. ``split_optimizer_step``, ``manual_backward`` and
``manual_precast_weights`` resolve as in the JAX driver
(``config.resolve_step_keys``): ``auto`` splits the step where Muon is on and
then takes the hand-written backward on a full fine-tune.
The host builds samples in loader threads; each optimizer step's batch goes
to the card from pinned memory with ``non_blocking`` copies while the card
still runs the previous step.
"""

from __future__ import annotations

import argparse
import collections
import filecmp
import json
import os
import time
from pprint import pprint
from typing import Callable, Dict, Optional

import numpy as np
import torch

import whisper_finetune_torch.runtime as rt
from whisper_finetune_torch._device import resolve_device
from whisper_finetune_torch.config import (
    build_featurize_config,
    build_forward_config,
    build_model,
    check_training_keys,
    resolve_step_keys,
    validate_config,
)
from whisper_finetune_torch.data import (
    BatchLoader,
    SampleBuilder,
    SampleDataset,
    ShardedSampler,
    WarmupDatasetSampler,
    get_dataset_boundary_indices,
    infinite_batches,
    process_dataset,
    stack_microbatches,
    to_device,
)
from whisper_finetune_torch.data.augment import (
    Compose,
    get_audio_augments_advanced,
    get_audio_augments_baseline,
    get_audio_augments_office,
)
from whisper_finetune_torch.eval import (
    evaluate_multiple_datasets,
    log_metrics_to_wandb,
    make_eval_step,
)
from whisper_finetune_torch.models import save_checkpoint
from whisper_finetune_torch.models.lora import LoRAUpdateTracker, get_lora_param_stats
from whisper_finetune_torch.optim import get_optimizer, get_schedule
from whisper_finetune_torch.parallel import DATA_AXIS
from whisper_finetune_torch.tokenizer import get_tokenizer
from whisper_finetune_torch.train.state_io import load_train_state, save_train_state
from whisper_finetune_torch.train.step import (
    TrainState,
    grad_histograms,
    make_train_step,
    trainable_leaves,
)
from whisper_finetune_torch.train.zero import zero_shard_state
from whisper_finetune_torch.utils import (
    calculate_training_steps,
    calculate_val_steps,
    get_unique_base_path,
    print_trainable_parameters,
    read_config,
    resolve_local_accum_grad_steps,
    set_seed,
)


def build_audio_augment(config: Dict):
    aud = config["augmentation"]["audio_augment"]
    pipelines = []
    if aud["apply_baseline_aug"]:
        ts = aud.get("time_stretch", {})
        pipelines.append(get_audio_augments_baseline(
            min_rate=ts.get("min_rate", 0.8), max_rate=ts.get("max_rate", 1.25)))
    if aud["apply_office_aug"]:
        pipelines.append(get_audio_augments_office())
    if aud.get("apply_advanced_aug", False):
        pipelines.append(get_audio_augments_advanced())
    return Compose(pipelines) if pipelines else None


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

def _build_lr_log_dict(group_metadata, schedule_factor: float, train_loss: float) -> Dict:
    log_data = {"Train loss": train_loss}
    current_lrs = [m["base_lr"] * schedule_factor for m in group_metadata]
    if len(current_lrs) == 1:
        log_data["Learning rate"] = current_lrs[0]
        return log_data

    log_data["Learning rate/min"] = min(current_lrs)
    log_data["Learning rate/max"] = max(current_lrs)
    log_data["Learning rate/mean"] = sum(current_lrs) / len(current_lrs)
    log_data["Learning rate/schedule_factor"] = schedule_factor

    grouped: Dict[str, list] = {}
    grouped_base: Dict[str, list] = {}
    for idx, (meta, lr) in enumerate(zip(group_metadata, current_lrs)):
        label = str(meta.get("lr_log_label", "group"))
        grouped.setdefault(label, []).append(lr)
        grouped_base.setdefault(label, []).append(meta.get("base_lr_unscaled", lr))
        log_data[f"Learning rate/{label}_group_{idx}"] = lr

    if "muon" in grouped:
        vals = grouped["muon"]
        log_data["Learning rate/muon_actual_min"] = min(vals)
        log_data["Learning rate/muon_actual_max"] = max(vals)
        log_data["Learning rate/muon_actual_mean"] = sum(vals) / len(vals)
        base = grouped_base["muon"]
        log_data["Learning rate/muon"] = (sum(base) / len(base)) * schedule_factor
    if "aux_adamw" in grouped:
        vals = grouped["aux_adamw"]
        log_data["Learning rate/aux_adamw_actual"] = sum(vals) / len(vals)
        base = grouped_base["aux_adamw"]
        log_data["Learning rate/aux_adamw"] = (sum(base) / len(base)) * schedule_factor

    if "Learning rate/muon" in log_data:
        log_data["Learning rate"] = log_data["Learning rate/muon"]
    elif "Learning rate/aux_adamw" in log_data:
        log_data["Learning rate"] = log_data["Learning rate/aux_adamw"]
    else:
        log_data["Learning rate"] = current_lrs[0]
    return log_data


def _np_histogram_record(counts, lo: float, hi: float) -> Dict:
    """A fixed-range histogram as the record ``rt.log`` understands (a
    wandb.Histogram when W&B is live, stored as-is in metrics.jsonl)."""
    counts = np.asarray(counts).astype(int)
    if hi <= lo:
        hi = lo + 1e-12
    edges = np.linspace(lo, hi, counts.size + 1)
    return {"_type": "histogram", "counts": counts.tolist(), "edges": [float(e) for e in edges]}


def _histogram_records(prefix: str, hists) -> Dict[str, Dict]:
    return {f"{prefix}/{name}": _np_histogram_record(counts.cpu(), float(lo), float(hi))
            for name, (counts, lo, hi) in hists.items()}


def _param_norms_by_module(named) -> Dict[str, float]:
    """``params/<side>.<module>`` L2 norms over the trainable leaves, summed
    in float32 on the device and fetched as scalars."""
    groups: Dict[str, list] = collections.defaultdict(list)
    for path, leaf in named:
        groups[".".join(path[:2])].append(torch.sum(torch.square(leaf.detach().float())))
    return {f"params/{name}": float(torch.sqrt(sum(sq))) for name, sq in groups.items()}


def _global_norm(named) -> float:
    return float(torch.sqrt(sum(torch.sum(torch.square(leaf.detach().float()))
                                for _, leaf in named)))


# ---------------------------------------------------------------------------
# Eval + checkpoint
# ---------------------------------------------------------------------------

def _evaluate_and_maybe_checkpoint(model, dims, eval_step, dev_loaders: Dict, tokenizer,
                                   save_dir: str, step: int, min_wer: float,
                                   save_checkpoints: bool, device) -> float:
    dataset_metrics, macro_metrics = evaluate_multiple_datasets(
        eval_step, model, dev_loaders, tokenizer, device=device)
    eval_wer = macro_metrics["macro_wer"]
    if step == 0:
        rt.print_once(f"Initial Macro WER: {eval_wer:.4f}")
    else:
        rt.print_once(f"Step {step}: Macro WER={eval_wer:.4f}")
    log_metrics_to_wandb(dataset_metrics, macro_metrics, step=step, prefix="val")

    if step > 0 and eval_wer < min_wer:
        min_wer = eval_wer
        if rt.IS_MAIN:
            save_checkpoint(f"{save_dir}/best_model.pt", model, dims)
            print(f"  Saved new best model (WER: {min_wer:.4f})")
    if step > 0 and save_checkpoints and rt.IS_MAIN:
        save_checkpoint(f"{save_dir}/step{step}.pt", model, dims)
    return min(min_wer, eval_wer)


# ---------------------------------------------------------------------------
# Main loop
# ---------------------------------------------------------------------------

def main_loop(state: TrainState, step_fn, train_stream, accum_local: int, dev_loaders: Dict,
              eval_step, dims, save_dir: str, t_config: Dict, group_metadata, schedule,
              tokenizer, generator: torch.Generator, device,
              save_state: Optional[Callable[[TrainState], None]] = None) -> TrainState:
    """Steps ``state.step + 1 .. train_steps`` (a resumed state runs only the
    rest, on the same global step clock). ``save_state`` (every rank calls
    it) writes the whole train state at eval steps."""
    model = state.model
    lora_tracker = None
    if t_config.get("is_lora_run", False):
        lora_tracker = LoRAUpdateTracker(model.params())
        rt.print_once("LoRA debug logging enabled - tracking parameter and update norms")

    min_wer = float("inf")
    if dev_loaders:
        rt.print_once("\nRunning initial evaluation...")
        min_wer = _evaluate_and_maybe_checkpoint(
            model, dims, eval_step, dev_loaders, tokenizer, save_dir, step=0,
            min_wer=min_wer, save_checkpoints=False, device=device)
    rt.barrier()

    # WFT_PROFILE_DIR: a torch.profiler trace (host and card) of steps 3-8
    # (to the last step of a shorter run), written as a Chrome trace for
    # Perfetto / chrome://tracing; the program's ``wft.*`` spans are ranges
    # on its timeline.
    profile_dir = os.environ.get("WFT_PROFILE_DIR")
    profiler = None

    train_steps = t_config["train_steps"]
    val_steps = t_config["val_steps"]

    def next_device_batch():
        with rt.span("wft.host_batch"):
            micro = [next(train_stream) for _ in range(accum_local)]
            return to_device(stack_microbatches(micro), device)

    start_step = int(state.step)
    if start_step >= train_steps:
        rt.print_once(f"Resumed state is already at step {start_step} >= "
                      f"train_steps {train_steps}; nothing to train.")

    try:
        from tqdm import tqdm

        pbar = tqdm(total=train_steps, initial=start_step, disable=not rt.IS_MAIN,
                    dynamic_ncols=True)
    except ImportError:
        pbar = None

    batch = next_device_batch() if start_step < train_steps else None
    last_step_time = None
    for step in range(start_step + 1, train_steps + 1):
        if profile_dir and step == 3 and rt.IS_MAIN:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(device).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        state, loss, ghists = step_fn(state, batch, generator)
        # The step's kernels are queued on the card: build and send the next
        # batch meanwhile, then sync on the loss. The build is timed apart by
        # the span clock (perf/host_batch_build_s, the ``wft.host_batch``
        # span): the host starves the card when it approaches
        # perf/step_time_s.
        host_build_s = 0.0
        if step < train_steps:
            with rt.timed() as clock:
                batch = next_device_batch()
            host_build_s = clock["wft.host_batch"][1]
        train_loss = float(loss)

        if profiler is not None and step == min(8, train_steps):
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            trace = os.path.join(profile_dir, "trace.json")
            profiler.export_chrome_trace(trace)
            profiler = None
            rt.print_once(f"Profiler trace for steps 3-{step} written to {trace}")

        schedule_factor = float(schedule(step - 1)) if schedule is not None else 1.0
        log_data = _build_lr_log_dict(group_metadata, schedule_factor, train_loss)

        now = time.time()
        if last_step_time is not None:
            dt = now - last_step_time
            samples_per_step = accum_local * rt.WORLD_SIZE * int(
                t_config.get("_per_device_batch", 0) or 0)
            log_data["perf/step_time_s"] = dt
            log_data["perf/host_batch_build_s"] = host_build_s
            if samples_per_step:
                log_data["perf/samples_per_sec"] = samples_per_step / dt
                log_data["perf/audio_hours_per_sec"] = samples_per_step * 30 / 3600 / dt
        last_step_time = now
        is_eval_step = (step % val_steps) == 0 or step == train_steps
        if is_eval_step:
            # wandb.watch(log="all") telemetry: parameter norms and
            # histograms here, gradient histograms from the step's third
            # output (real counts on steps that are multiples of val_steps).
            named = trainable_leaves(model)
            log_data["params/trainable_global_norm"] = _global_norm(named)
            log_data.update(_param_norms_by_module(named))
            log_data.update(_histogram_records("params_hist", grad_histograms(named, 64)))
            if (step % val_steps) == 0:
                log_data.update(_histogram_records("grads_hist", ghists))
        if lora_tracker is not None and is_eval_step:
            log_data.update(get_lora_param_stats(model.params()))
            log_data.update(lora_tracker.update_and_stats(model.params()))
        rt.log(log_data, step=step)
        if pbar is not None:
            pbar.update(1)
            pbar.set_postfix({"loss": f"{train_loss:.4f}"})
        elif rt.IS_MAIN and step % 10 == 0:
            print(f"step {step}/{train_steps} loss={train_loss:.4f}")

        # Divergence kill-switch.
        if not train_loss < t_config["max_train_loss"]:
            raise RuntimeError(f"Train loss is above {t_config['max_train_loss']}, "
                               "the loss is unable to converge.")

        if is_eval_step:
            if save_state is not None:
                save_state(state)
            if dev_loaders:
                min_wer = _evaluate_and_maybe_checkpoint(
                    model, dims, eval_step, dev_loaders, tokenizer, save_dir, step=step,
                    min_wer=min_wer, save_checkpoints=t_config["save_all_checkpoints"],
                    device=device)
            rt.barrier()

    if pbar is not None:
        pbar.close()
    if rt.IS_MAIN:
        save_checkpoint(f"{save_dir}/last_model.pt", model, dims)

    if rt.IS_MAIN and t_config.get("upload_models_to_wandb", False):
        last_path = f"{save_dir}/last_model.pt"
        best_path = f"{save_dir}/best_model.pt"
        if os.path.exists(best_path) and filecmp.cmp(last_path, best_path, shallow=False):
            print("Last model and best model are identical. Uploading only best_model.pt.")
            rt.save_wandb_file(best_path)
        else:
            print("Uploading both last_model.pt and best_model.pt.")
            rt.save_wandb_file(last_path)
            if os.path.exists(best_path):
                rt.save_wandb_file(best_path)
    rt.barrier()
    return state


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(config: Dict, device="cuda", backend: Optional[str] = None):
    """Train as ``config`` says on ``device`` (a bare ``cuda`` is this
    rank's card, ``cuda:LOCAL_RANK``). Under ``torchrun`` (``WORLD_SIZE`` >
    1), or with a ``backend`` named, the ranks join a process group over
    ``backend`` (default ``nccl`` on cards, ``gloo`` on the CPU). Returns
    (the final :class:`TrainState`, the run directory); the caller ends the
    process group (``runtime.cleanup``)."""
    config = validate_config(config)
    notes = check_training_keys(config)
    resolve_device(device)
    dev = rt.setup_distributed(device, backend)
    generator = torch.Generator(device=dev)
    set_seed(int(config["seed"]) + rt.RANK, generator)

    global_accum_grad_steps = int(config["training"]["accum_grad_steps"])
    local_accum_grad_steps = resolve_local_accum_grad_steps(global_accum_grad_steps,
                                                            rt.WORLD_SIZE)
    config["training"]["global_accum_grad_steps"] = global_accum_grad_steps
    config["training"]["accum_grad_steps"] = local_accum_grad_steps

    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rt.print_once(f"Runtime: processes={rt.WORLD_SIZE}, rank={rt.RANK}, device={dev} ({card})")
    rt.print_once("Gradient accumulation: "
                  f"global_accum_grad_steps={global_accum_grad_steps}, "
                  f"local_accum_grad_steps={local_accum_grad_steps}, "
                  f"data-parallel width={rt.WORLD_SIZE}")
    for note in notes:
        rt.print_once(note)

    config["save_dir"] = os.path.join(config["save_dir"], get_unique_base_path())
    if rt.IS_MAIN:
        os.makedirs(config["save_dir"], exist_ok=True)
    rt.barrier()

    is_lora_run = bool(config["model"].get("lora", False))
    config["training"]["is_lora_run"] = is_lora_run
    if rt.IS_MAIN and is_lora_run:
        with open(os.path.join(config["save_dir"], "lora_config.json"), "w",
                  encoding="utf-8") as handle:
            json.dump(config["model"].get("lora_config", {}), handle, indent=2, sort_keys=True)

    if rt.IS_MAIN and "SLURM_JOB_ID" in os.environ:
        print(f"SLURM job: {os.environ['SLURM_JOB_ID']} on "
              f"{os.environ.get('SLURMD_NODENAME', '?')}")
    rt.print_once("PyTorch version:", torch.__version__)

    # -- model ---------------------------------------------------------------
    if config["model"].get("bfloat16"):
        rt.print_once(
            "WARNING: config['model']['bfloat16'] is deprecated and ignored. "
            "Params stay fp32; compute precision comes from "
            "training.mixed_precision_training / mp_dtype.")
    if is_lora_run:
        rt.print_once("Applying LoRA adapters...")
    model, dims = build_model(config, dev)
    print_trainable_parameters(model)

    fcfg = build_forward_config(config, is_lora_run, dev)
    feat_cfg = build_featurize_config(config, dims.n_mels)

    # -- data ----------------------------------------------------------------
    ds_config = config["dataset"]
    warmup_dataset_idx = ds_config.get("warmup_dataset_idx")
    data_rng = np.random.default_rng(int(config["seed"]) + rt.RANK)
    train_hf = process_dataset(
        ds_config["train_datasets"],
        ds_config["select_n_per_t_ds"],
        ds_config["train_split_name"],
        ds_config["groupby_col"],
        select_language_tag=ds_config.get("select_language_tag"),
        return_sizes=warmup_dataset_idx is not None,
        rng=data_rng,
    )
    dataset_sizes = None
    if warmup_dataset_idx is not None:
        train_hf, dataset_sizes = train_hf
        rt.print_once(f"\nDataset sizes: {dataset_sizes}")

    val_datasets_dict = {}
    val_config = ds_config.get("val_datasets", []) or []
    if isinstance(val_config, str):
        val_config = [val_config]
    val_names = ds_config.get("val_dataset_names")
    if val_names is None:
        val_names = [v.split("/")[-1] if "/" in v else v for v in val_config]
    for i, (val_ds, val_name) in enumerate(zip(val_config, val_names)):
        select_n = (ds_config["select_n_per_v_ds"][i]
                    if i < len(ds_config["select_n_per_v_ds"]) else None)
        val_datasets_dict[val_name] = process_dataset(
            [val_ds], [select_n], ds_config["valid_split_name"], [None],
            rng=np.random.default_rng(int(config["seed"]) + 10_000 + i))

    # -- step math -----------------------------------------------------------
    train_drop_last = bool(ds_config.get("drop_last", True))
    config["training"]["train_steps"] = calculate_training_steps(
        config, len(train_hf), world_size=rt.WORLD_SIZE, drop_last=train_drop_last)
    config["training"]["val_steps"] = calculate_val_steps(config)
    if config["lr_scheduler"]["warmup_steps"] < 1.0:
        config["lr_scheduler"]["warmup_steps"] = int(
            config["lr_scheduler"]["warmup_steps"] * config["training"]["train_steps"])

    tokenizer = get_tokenizer(multilingual=True, language="de", task="transcribe")

    # -- loaders -------------------------------------------------------------
    batch_size = int(ds_config["batch_size"])
    config["training"]["_per_device_batch"] = batch_size
    builder = SampleBuilder(
        tokenizer,
        no_timestamp_training=bool(ds_config["no_timestamp_training"]),
        max_prompt_length=int(ds_config["max_prompt_length"]),
        prompt_use_rate=float(ds_config["prompt_use_rate"]),
        no_timestamps_rate=float(ds_config["no_timestamp_rate"]),
        bpe_dropout=float(config["augmentation"]["bpe_dropout"]),
        audio_augment=build_audio_augment(config),
    )
    train_ds = SampleDataset(train_hf, builder, seed=int(config["seed"]))

    if rt.WORLD_SIZE > 1 and warmup_dataset_idx is not None:
        raise ValueError("dataset.warmup_dataset_idx is not supported with multi-host data "
                         "sharding yet.")
    if warmup_dataset_idx is not None:
        warmup_start, warmup_end = get_dataset_boundary_indices(
            dataset_sizes)[warmup_dataset_idx]
        sampler = WarmupDatasetSampler(
            warmup_indices=list(range(warmup_start, warmup_end)),
            all_indices=list(range(len(train_ds))),
            warmup_steps=int(config["lr_scheduler"]["warmup_steps"]),
            batch_size=batch_size,
            shuffle=True,
            seed=int(config["seed"]),
        )
    else:
        sampler = ShardedSampler(len(train_ds), rank=rt.RANK, world_size=rt.WORLD_SIZE,
                                 shuffle=True, seed=int(config["seed"]),
                                 drop_last=train_drop_last)

    train_num_workers = ds_config.get("train_num_workers")
    if train_num_workers is None:
        train_num_workers = min(os.cpu_count() or 1, 8)
    eval_num_workers = int(ds_config.get("eval_num_workers") or 0)
    rt.print_once(f"Train loader workers: {train_num_workers}, eval workers: {eval_num_workers}")

    pad_buckets = ds_config.get("decoder_pad_buckets")
    train_loader = BatchLoader(
        train_ds,
        batch_size=batch_size,
        sampler=sampler,
        num_workers=int(train_num_workers),
        drop_last=train_drop_last,
        seed=int(config["seed"]),
        pad_to=tuple(pad_buckets) if pad_buckets else 448,
    )
    train_stream = infinite_batches(train_loader)

    eval_builder = SampleBuilder(tokenizer, no_timestamp_training=True, prompt_use_rate=0.0,
                                 no_timestamps_rate=0.0)
    dev_loaders = {}
    for val_name, val_hf in val_datasets_dict.items():
        loader = BatchLoader(SampleDataset(val_hf, eval_builder, seed=int(config["seed"])),
                             batch_size=int(ds_config["batch_size_eval"]), shuffle=False,
                             num_workers=eval_num_workers)
        dev_loaders[val_name] = loader.__iter__

    # -- optimizer / scheduler ---------------------------------------------------
    schedule = get_schedule(config["lr_scheduler"], config["training"]["train_steps"])
    named = trainable_leaves(model)
    zero_shard = bool(config["training"].get("zero_shard_optimizer")) and rt.WORLD_SIZE > 1
    # Without ZeRO, Muon's Newton-Schulz splits over the ranks; under ZeRO
    # the update itself is already sharded (no double slicing), as in JAX.
    opt, group_metadata = get_optimizer(named, config["optimizer"], schedule=schedule,
                                        is_lora_run=is_lora_run,
                                        data_shard_axis=None if zero_shard else DATA_AXIS,
                                        data_axis_size=1 if zero_shard else rt.WORLD_SIZE)
    leaves = [p for _, p in named]
    state = TrainState(model, opt.init(leaves), 0)
    if zero_shard:
        rt.print_once(f"ZeRO-1: optimizer state sharded over {rt.WORLD_SIZE} ranks")
        state = TrainState(model, zero_shard_state(opt, state.opt_state, leaves), 0)
    if config["training"].get("resume_from"):
        state = load_train_state(config["training"]["resume_from"], state, opt, zero_shard)
        rt.print_once(f"Resumed training state from {config['training']['resume_from']} "
                      f"at step {state.step}")
    save_state = None
    if config["training"].get("save_train_state"):
        path = os.path.join(config["save_dir"], "train_state.pt")

        def save_state(s):
            save_train_state(path, s, opt, zero_shard)

    if rt.IS_MAIN:
        pprint(config)

    full_tree = len(named) == len(model.leaves()) and not is_lora_run
    step_keys, step_notes = resolve_step_keys(config, full_tree, zero_shard)
    for note in step_notes:
        rt.print_once(note)
    step_fn = make_train_step(
        dims,
        fcfg,
        opt,
        label_smoothing=float(config["training"]["label_smoothing"]),
        feat_cfg=feat_cfg,
        max_grad_norm=float(config["training"]["max_grad_norm"]),
        accum_dtype=config["training"].get("grad_accum_dtype"),
        grad_hist_every=int(config["training"]["val_steps"]),
        zero_shard=zero_shard,
        **step_keys,
        device=dev,
    )
    eval_step = make_eval_step(dims, fcfg, n_mels=dims.n_mels)

    # -- observability ---------------------------------------------------------
    wandb_conf = dict(config.get("wandb") or {})
    if not bool(wandb_conf.pop("enabled", True)):
        wandb_conf.setdefault("mode", "disabled")
    rt.setup_wandb(config=config, metrics_dir=config["save_dir"], **wandb_conf)
    try:
        slurm_job_id = os.environ.get("SLURM_JOB_ID")
        if slurm_job_id:
            rt.update_wandb_config({"slurm_job_id": slurm_job_id}, allow_val_change=True)
            rt.set_wandb_summary("slurm_job_id", slurm_job_id)

        # -- train -------------------------------------------------------------
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        state = main_loop(
            state, step_fn, train_stream, local_accum_grad_steps, dev_loaders, eval_step,
            dims, config["save_dir"], config["training"], group_metadata, schedule,
            tokenizer, generator, dev, save_state)

        if dev.type == "cuda":
            peak = torch.cuda.max_memory_allocated(dev)
            rt.print_once(f"Peak memory usage: {peak / 1024**2:.2f} MB")
    finally:
        rt.finish_wandb()
    return state, config["save_dir"]


def cli(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description="Script Configuration")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to the configuration YAML file")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: this rank's card; raises without one) or cpu")
    args = parser.parse_args(argv)
    config = read_config(args.config)
    config["path_to_config"] = args.config
    try:
        main(config, device=args.device)
    finally:
        rt.cleanup()


if __name__ == "__main__":
    cli()
