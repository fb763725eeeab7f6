"""Run configuration: the YAML schema's defaults and the functions that turn a
config ``dict`` into the model's and the feature stage's static settings.

The schema is the JAX package's (``whisper_finetune_tpu/config.py``; configs
written for it run unmodified): :func:`with_defaults` fills the sections the
functions and the optimizer factory read (``training``, ``augmentation``,
``optimizer``, ``lr_scheduler``, ``model``) and checks their values;
:func:`validate_config` is the training script's whole normalisation (the
dataset section too, unknown keys warned about), and
:func:`check_training_keys` notes the keys served differently, and
:func:`resolve_step_keys` turns the split-step keys into the step's flags
as the JAX driver does.
:func:`build_forward_config` and :func:`build_featurize_config` are the
ones of ``scripts/finetune.py``, and :func:`build_model` is that script's
model section (base checkpoint, layer surgery, LoRA, frozen leaves).
"""

from __future__ import annotations

import copy
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from whisper_finetune_torch._device import resolve_device
from whisper_finetune_torch.models.lora import lora_scale
from whisper_finetune_torch.models.whisper import ForwardConfig, Whisper
from whisper_finetune_torch.ops.attention import resolve_auto_impls
from whisper_finetune_torch.ops.spec_augment import FeaturizeConfig

_TRAINING_DEFAULTS: Dict[str, Any] = {
    "accum_grad_steps": 1,
    "label_smoothing": 0.0,
    "train_only_decoder": False,
    "train_only_encoder": False,
    "max_grad_norm": 1.0,
    "stochastic_depth": 0.0,
    "epochs": 1,
    "eval_steps": 0.25,
    "save_all_checkpoints": False,
    "upload_models_to_wandb": False,
    "max_train_loss": 25.0,
    "mixed_precision_training": True,
    "mp_dtype": "bf16",
    "gradient_checkpointing_encoder": True,
    "gradient_checkpointing_encoder_last_only": False,
    "gradient_checkpointing_decoder": True,
    "ddp_find_unused_parameters": None,
    "resume_from": None,
    "save_train_state": False,
    "zero_shard_optimizer": False,
    # Reduced-precision gradient accumulator ("bfloat16" halves the gradient
    # tree; None keeps float32).
    "grad_accum_dtype": None,
    "split_optimizer_step": "auto",
    "manual_backward": "auto",
    "manual_precast_weights": False,
    # Rematerialization policy inside checkpointed blocks: full, dots, attn,
    # save:<sites>, offload:<sites> (ops/remat.py).
    "remat_policy": "full",
    # "auto" picks the per-site mix for the device (ops/attention.py
    # resolve_auto_impls): on a card the kernels at all three sites, the
    # decoder's causal self-attention too (the JAX package keeps that site
    # plain, its faster choice on the TPU; on an H100 the kernels are
    # faster there); plain on the CPU. Explicit: "xla", "flash", "splash",
    # "flash_fwd".
    "attn_impl": "auto",
    "compiler_options": None,
}

_AUG_DEFAULTS: Dict[str, Any] = {
    "spec_augment": {
        "apply": False,
        "time_mask_param": 100,
        "freq_mask_param": 43,
        "time_warp_w": 80,
        "p": 1.0,
    },
    "deep_spec_augment": {
        "apply": False,
        "time_mask_param": 100,
        "freq_mask_param": 27,
        "p": 1.0,
        "layer_indices": None,
    },
    "bpe_dropout": 0.0,
    "extremes_spec_augment": {
        "apply": False,
        "low_freq_range": 10,
        "high_freq_range": 20,
    },
    "audio_augment": {
        "apply_baseline_aug": False,
        "apply_office_aug": False,
        "apply_advanced_aug": False,
        "time_stretch": {"min_rate": 0.8, "max_rate": 1.25},
    },
}

_OPTIMIZER_DEFAULTS: Dict[str, Any] = {
    "type": "adamw",
    "8bit": False,
    "muon": None,
    "muon_ndim_threshold": 2,
    "muon_params": {},
    "muon_match_adamw_update_rms": True,
    "muon_match_factor": 0.2,
    # Muon momentum storage: "bfloat16", "int8" (blockwise), None = float32.
    "muon_momentum_dtype": None,
    "muon_ns_steps": 5,
    "muon_ns_coeffs": "classic",
    # Blockwise 8-bit state for the auxiliary AdamW leaves.
    "muon_aux_8bit": False,
    # Bound (MB) on the float32 working set of one Muon leaf update; null
    # disables chunking.
    "muon_chunk_temp_mb": 128.0,
    "params": {},
}

_SCHEDULER_DEFAULTS: Dict[str, Any] = {
    "type": "linear",
    "warmup_steps": 0,
    "lr_num_cycles": 1,
    "lr_gamma": 1.0,
    "chill_steps": 100,
    "chill_range": 0.02,
}


def _merge_defaults(section: Optional[Dict[str, Any]], defaults: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(defaults)
    if not section:
        return out
    for key, value in section.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            merged = copy.deepcopy(out[key])
            merged.update(value)
            out[key] = merged
        else:
            out[key] = value
    return out


def with_defaults(config: Dict[str, Any]) -> Dict[str, Any]:
    """A raw config dict with the training, augmentation, optimizer,
    lr_scheduler and model sections normalized (defaults filled, values
    checked as ``validate_config`` checks them). Other sections pass through.
    Returns a new dict; the input is not mutated."""
    if not isinstance(config, dict):
        raise TypeError(f"Config must be a mapping, got {type(config).__name__}")
    out = dict(config)
    model = dict(config.get("model") or {})
    model.setdefault("bfloat16", False)
    model.setdefault("lora", False)
    model.setdefault("lora_config", {})
    out["model"] = model
    out["training"] = _merge_defaults(config.get("training"), _TRAINING_DEFAULTS)
    out["augmentation"] = _merge_defaults(config.get("augmentation"), _AUG_DEFAULTS)
    out["optimizer"] = _merge_defaults(config.get("optimizer"), _OPTIMIZER_DEFAULTS)
    out["lr_scheduler"] = _merge_defaults(config.get("lr_scheduler"), _SCHEDULER_DEFAULTS)

    tr = out["training"]
    if int(tr["accum_grad_steps"]) < 1:
        raise ValueError("training.accum_grad_steps must be >= 1")
    if not 0.0 <= float(tr["stochastic_depth"]) < 1.0:
        raise ValueError("training.stochastic_depth must be in [0, 1)")
    if tr["mp_dtype"] not in ("fp16", "bf16", "bfloat16", "fp32"):
        raise ValueError(f"training.mp_dtype must be fp16/bf16/fp32, got {tr['mp_dtype']}")
    if tr["gradient_checkpointing_encoder"] and tr["gradient_checkpointing_encoder_last_only"]:
        raise ValueError(
            "gradient_checkpointing_encoder_last_only is not supported when "
            "gradient_checkpointing_encoder is enabled"
        )
    opt = out["optimizer"]
    if int(opt["muon_ns_steps"]) < 1:
        raise ValueError(f"optimizer.muon_ns_steps must be >= 1, got {opt['muon_ns_steps']}")
    if opt["muon_ns_coeffs"] not in ("classic", "polar_express"):
        raise ValueError(
            "optimizer.muon_ns_coeffs must be 'classic' or 'polar_express', "
            f"got {opt['muon_ns_coeffs']!r}"
        )
    aug = out["augmentation"]
    for section_name in ("spec_augment", "deep_spec_augment"):
        p = float(aug[section_name].get("p", 1.0))
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"augmentation.{section_name}.p must be in [0, 1], got {p}")
    return out


_KNOWN_SECTIONS = {
    "model", "dataset", "lr_scheduler", "optimizer", "training", "augmentation", "wandb",
    "seed", "save_dir", "path_to_config",
    "ddp",  # documentation-only block in reference configs; accepted, unused
}

_MODEL_KEYS = {
    "init_name", "bfloat16", "lora", "lora_config", "base_init_name", "encoder_layers",
    "encoder_layer", "decoder_layers", "decoder_layer",
    "deocer_layer",  # typo accepted by the reference
    "checkpoint_path",
}

_DATASET_DEFAULTS: Dict[str, Any] = {
    "train_datasets": [],
    "select_n_per_t_ds": [],
    "groupby_col": [],
    "select_language_tag": None,
    "warmup_dataset_idx": None,
    "val_datasets": [],
    "val_dataset_names": None,
    "select_n_per_v_ds": [],
    "train_split_name": "train",
    "valid_split_name": "validation",
    "no_timestamp_training": False,
    "max_prompt_length": 223,
    "prompt_use_rate": 0.5,
    "no_timestamp_rate": 0.5,
    "batch_size": 1,
    "batch_size_eval": 1,
    "train_num_workers": None,
    "eval_num_workers": 0,
    "drop_last": True,
    # Pad decoder tokens to the smallest of these bucket lengths instead of
    # the fixed 448 context. None = fixed 448.
    "decoder_pad_buckets": None,
}


def validate_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """The training script's normalisation of a raw YAML dict, the JAX
    package's ``validate_config``: :func:`with_defaults`, the dataset
    section's defaults and checks, the training keys' value checks, warnings
    for unknown sections and model keys, and ``wandb`` / ``seed`` /
    ``save_dir``. Returns a new dict; the input is not mutated."""
    if not isinstance(config, dict):
        raise TypeError(f"Config must be a mapping, got {type(config).__name__}")
    unknown = set(config) - _KNOWN_SECTIONS
    if unknown:
        warnings.warn(f"Unknown top-level config sections ignored: {sorted(unknown)}")
    model = config.get("model") or {}
    if "init_name" not in model:
        raise ValueError("config.model.init_name is required")
    unknown_model = set(model) - _MODEL_KEYS
    if unknown_model:
        warnings.warn(f"Unknown model config keys ignored: {sorted(unknown_model)}")

    normalized = with_defaults(config)
    out: Dict[str, Any] = {"model": normalized["model"],
                           "dataset": _merge_defaults(config.get("dataset"), _DATASET_DEFAULTS)}
    for section in ("training", "augmentation", "optimizer", "lr_scheduler"):
        out[section] = normalized[section]

    ds = out["dataset"]
    for rate_key in ("prompt_use_rate", "no_timestamp_rate"):
        rate = float(ds[rate_key])
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dataset.{rate_key} must be in [0, 1], got {rate}")
    if int(ds["batch_size"]) < 1 or int(ds["batch_size_eval"]) < 1:
        raise ValueError("dataset.batch_size/batch_size_eval must be >= 1")

    tr = out["training"]
    for key in ("split_optimizer_step", "manual_backward"):
        if tr[key] not in ("auto", True, False):
            raise ValueError(f"training.{key} must be 'auto', true, or false, got {tr[key]!r}")
    if tr["compiler_options"] is not None and not isinstance(tr["compiler_options"], dict):
        raise ValueError(
            "training.compiler_options must be a mapping of XLA option "
            f"name -> value, got {type(tr['compiler_options']).__name__}"
        )
    if not 0.0 <= float(out["augmentation"]["bpe_dropout"]) < 1.0:
        raise ValueError("augmentation.bpe_dropout must be in [0, 1)")

    out["wandb"] = dict(config.get("wandb") or {})
    out["seed"] = int(config.get("seed", 0))
    out["save_dir"] = config.get("save_dir", "output")
    if "path_to_config" in config:
        out["path_to_config"] = config["path_to_config"]
    return out


def check_training_keys(config: Dict[str, Any]) -> List[str]:
    """The notes to log once for training keys the port serves differently:
    XLA's ``compiler_options`` mean nothing here. Every training key is
    honoured (``ddp_find_unused_parameters`` is accepted and ignored, as in
    the JAX package: the step reduces every gradient itself and wraps no DDP
    module)."""
    tr = config["training"]
    notes = []
    if tr["compiler_options"]:
        notes.append(f"WARNING: training.compiler_options {sorted(tr['compiler_options'])} "
                     "are XLA compile options; ignored by the PyTorch port")
    return notes


def resolve_step_keys(config: Dict[str, Any], full_tree: bool, zero_active: bool
                      ) -> Tuple[Dict[str, bool], List[str]]:
    """``make_train_step``'s ``split_update``, ``manual_backward`` and
    ``manual_precast`` from the training keys, as the JAX driver resolves
    them: ``split_optimizer_step: auto`` splits exactly when Muon is on; under
    ZeRO at a world above 1 (``zero_active``) the split is off, with a note
    to log; ``manual_backward: auto`` is split on the full tree
    (``full_tree``: no LoRA, no frozen leaf), and an explicit ``true`` that
    cannot be honoured raises ``ValueError``. Returns (the three flags, the
    notes to log once)."""
    tr = config["training"]
    notes = []
    split = tr.get("split_optimizer_step", "auto")
    if split == "auto":
        split = bool(config["optimizer"].get("muon"))
    if split and zero_active:
        notes.append("split_optimizer_step is inert under zero_shard_optimizer on a "
                     "multi-device mesh (ZeRO keeps the single-program step); "
                     "continuing without it.")
        split = False
    manual = tr.get("manual_backward", "auto")
    if manual == "auto":
        manual = bool(split) and full_tree
    elif manual and not (split and full_tree):
        raise ValueError(
            "training.manual_backward=true requires split_optimizer_step "
            "(unavailable under zero_shard_optimizer on a multi-device "
            "mesh) and full fine-tuning (no LoRA / train_only_*)")
    return {"split_update": bool(split), "manual_backward": bool(manual),
            "manual_precast": bool(tr.get("manual_precast_weights", False))}, notes


def load_config(path) -> Dict[str, Any]:
    """Read a YAML run config and normalize it with :func:`with_defaults`."""
    import yaml

    with open(path) as f:
        return with_defaults(yaml.safe_load(f))


def _compute_dtype(t_config: Dict) -> str:
    if not t_config["mixed_precision_training"]:
        return "float32"
    # fp16 configs compute in bfloat16: no GradScaler exists here.
    if t_config["mp_dtype"] in ("fp16", "bf16", "bfloat16"):
        return "bfloat16"
    return "float32"


def _lora_hparams(lcfg: Dict) -> Dict:
    """Both key spellings: rank / lora_alpha / lora_dropout and the bare names."""
    return {
        "rank": int(lcfg.get("rank", 16)),
        "alpha": float(lcfg.get("lora_alpha", lcfg.get("alpha", 32))),
        "dropout": float(lcfg.get("lora_dropout", lcfg.get("dropout", 0.0))),
    }


def build_forward_config(config: Dict, is_lora_run: bool, device="cuda") -> ForwardConfig:
    """The model's static forward settings from a normalized config.
    ``attn_impl: auto`` resolves for ``device``."""
    t = config["training"]
    dsa = config["augmentation"]["deep_spec_augment"]
    # train_only_* zeroes stochastic depth on the frozen side.
    sd = float(t["stochastic_depth"])
    sd_encoder = 0.0 if t["train_only_decoder"] else sd
    sd_decoder = 0.0 if t["train_only_encoder"] else sd
    lora_cfg = _lora_hparams(config["model"].get("lora_config", {}) or {})
    attn_impl = str(t.get("attn_impl", "auto"))
    attn_kwargs = (resolve_auto_impls(device) if attn_impl == "auto"
                   else {"attn_impl": attn_impl})
    return ForwardConfig(
        compute_dtype=_compute_dtype(t),
        remat_encoder=bool(t["gradient_checkpointing_encoder"]),
        remat_encoder_last_only=bool(t["gradient_checkpointing_encoder_last_only"]),
        remat_decoder=bool(t["gradient_checkpointing_decoder"]),
        remat_policy=str(t.get("remat_policy", "full")),
        stochastic_depth=sd,
        stochastic_depth_encoder=sd_encoder,
        stochastic_depth_decoder=sd_decoder,
        dsa_apply=bool(dsa["apply"]),
        dsa_time_mask_param=int(dsa["time_mask_param"]),
        dsa_freq_mask_param=int(dsa["freq_mask_param"]),
        dsa_p=float(dsa.get("p", 1.0)),
        dsa_layer_indices=(tuple(dsa["layer_indices"]) if dsa.get("layer_indices") else None),
        lora_scale=lora_scale(lora_cfg["rank"], lora_cfg["alpha"]) if is_lora_run else 0.0,
        lora_dropout=lora_cfg["dropout"] if is_lora_run else 0.0,
        **attn_kwargs,
    )


def build_model(config: Dict, device="cuda"):
    """The run's model, built as the training script builds it: the base
    checkpoint of ``model.init_name`` through ``load_model`` (a preset such
    as ``whisper-4832`` names its base and layer counts:
    ``resolve_model_architecture``), resized, LoRA adapters where
    ``model.lora`` (A drawn from a generator seeded with ``config["seed"]``),
    and the frozen leaves of LoRA and ``train_only_*`` marked
    (``requires_grad=False``). Returns (model, dims); the optimizer takes
    ``train.trainable_leaves(model)``."""
    from whisper_finetune_torch.models.checkpoint import load_model
    from whisper_finetune_torch.models.lora import apply_lora
    from whisper_finetune_torch.models.surgery import (resize_whisper_layers,
                                                       resolve_model_architecture)
    from whisper_finetune_torch.train.step import build_trainable_mask, mark_trainable

    dev = resolve_device(device)
    arch = resolve_model_architecture(config["model"])
    if arch["base_init_name"] != arch["init_name"]:
        print(f"Model alias '{arch['init_name']}' resolved to base model "
              f"'{arch['base_init_name']}'.")
    model, dims = load_model(arch["base_init_name"], dev)
    params, dims, _ = resize_whisper_layers(model.params(), dims, arch["encoder_layers"],
                                            arch["decoder_layers"])
    t = config["training"]
    lora_mask = None
    if config["model"].get("lora"):
        h = _lora_hparams(config["model"].get("lora_config") or {})
        gen = torch.Generator(device=dev).manual_seed(int(config.get("seed", 0)))
        params, lora_mask = apply_lora(
            params, rank=h["rank"], alpha=h["alpha"], dropout=h["dropout"],
            encoder_only=bool(t["train_only_encoder"]),
            decoder_only=bool(t["train_only_decoder"]), generator=gen)
    model = Whisper(dims, params)
    mark_trainable(model.params(), build_trainable_mask(params, t, lora_mask))
    return model, dims


def build_featurize_config(config: Dict, n_mels: int) -> FeaturizeConfig:
    aug = config["augmentation"]
    sa = aug["spec_augment"]
    ex = aug["extremes_spec_augment"]
    return FeaturizeConfig(
        n_mels=n_mels,
        spec_augment=bool(sa["apply"]),
        time_mask_param=int(sa["time_mask_param"]),
        freq_mask_param=int(sa["freq_mask_param"]),
        time_warp_w=int(sa["time_warp_w"]),
        p=float(sa.get("p", 1.0)),
        extremes=bool(ex["apply"]),
        low_freq_range=int(ex["low_freq_range"]),
        high_freq_range=int(ex["high_freq_range"]),
    )
