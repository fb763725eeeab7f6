"""Optimizer factory, the port of ``whisper_finetune_tpu/optim/optimizers.py``:
Adam / AdamW / Muon-with-auxiliary-AdamW from a config's ``optimizer`` section.

* ``type: adam`` / ``adamw`` with the config's ``params`` passed through
  (torch-default hyperparameters where unspecified; ``Adam``'s coupled L2 and
  ``AdamW``'s decoupled decay are both reproduced),
* ``8bit: true`` dispatches to the blockwise 8-bit state of
  ``optim/quantized.py``,
* ``muon: true`` partitions the parameters like the reference: matrices
  inside encoder/decoder blocks go to Muon, everything else (gains, biases,
  embeddings, convs, final norms) to the auxiliary AdamW. The partition is a
  label per leaf over the stacked block axis.

Every optimizer here follows one protocol: ``init(params) -> state`` and
``fused_apply(grads, state, params, g_scale) -> state`` over lists of leaves
in one fixed order, updating parameters and state buffers IN PLACE;
``state.count`` is the number of updates applied, kept on the host, and the
learning rate of an update is ``base_lr * schedule(count)`` read from it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from whisper_finetune_torch.optim.muon import Muon, rms_match_scale
from whisper_finetune_torch.optim.quantized import _div, adam_8bit, adamw_8bit

Schedule = Callable[[int], float]
Leaves = Sequence[Tuple[Tuple[str, ...], torch.Tensor]]  # Whisper.leaves()


# ---------------------------------------------------------------------------
# float32 Adam / AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Adam:
    """Adam with float32 moments: decoupled weight decay (``optax.adamw`` /
    ``torch.optim.AdamW``) or, with ``decoupled=False``, coupled L2
    (``torch.optim.Adam``: the decay joins the gradient first)."""

    def __init__(self, learning_rate: Union[float, Schedule], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                 decoupled: bool = True):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.decoupled = decoupled

    def lr(self, count: int) -> float:
        """The learning rate of the update that follows ``count`` updates."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        def zeros():
            return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]

        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def fused_apply(self, grads: Sequence[torch.Tensor], state: AdamState,
                    params: Sequence[torch.Tensor],
                    g_scale: Optional[torch.Tensor] = None) -> AdamState:
        """Update ``params`` and both moments in place with ``grads * g_scale``."""
        count = state.count + 1
        f32 = np.float32
        c1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        c2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        lr = float(f32(self.lr(state.count)))
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
            g = g.float()
            if g_scale is not None:
                g = g * g_scale
            if wd and not self.decoupled:
                g = g + wd * p
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = _div(mu, c1) / (torch.sqrt(_div(nu, c2)) + self.eps)
            if wd and self.decoupled:
                upd = upd + wd * p
            p.add_(upd, alpha=-lr)
        return AdamState(count, state.mu, state.nu)


# ---------------------------------------------------------------------------
# Muon + auxiliary AdamW partition
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PartitionState:
    muon: Any
    adamw: Any

    @property
    def count(self) -> int:
        return self.muon.count


class MuonWithAuxAdam:
    """Routes each leaf to Muon or to the auxiliary AdamW by its label and
    applies both in one pass (the JAX package's partition applier)."""

    def __init__(self, labels: Sequence[str], muon_tx: Muon, aux_tx):
        self.labels = list(labels)
        self.muon, self.adamw = muon_tx, aux_tx

    def _pick(self, want: str, leaves: Sequence) -> list:
        if len(leaves) != len(self.labels):
            raise ValueError(f"{len(leaves)} leaves for {len(self.labels)} labels")
        return [x for lab, x in zip(self.labels, leaves) if lab == want]

    def init(self, params: Sequence[torch.Tensor]) -> PartitionState:
        return PartitionState(self.muon.init(self._pick("muon", params)),
                              self.adamw.init(self._pick("adamw", params)))

    def fused_apply(self, grads, state: PartitionState, params,
                    g_scale: Optional[torch.Tensor] = None) -> PartitionState:
        new_muon = self.muon.fused_apply(
            self._pick("muon", grads), state.muon, self._pick("muon", params), g_scale=g_scale)
        new_aux = self.adamw.fused_apply(
            self._pick("adamw", grads), state.adamw, self._pick("adamw", params),
            g_scale=g_scale)
        return PartitionState(new_muon, new_aux)


def _scheduled_lr(base_lr: float, schedule: Optional[Schedule]):
    if schedule is None:
        return base_lr
    return lambda count: base_lr * schedule(count)


def _as_leaves(params) -> Leaves:
    if isinstance(params, dict):
        from whisper_finetune_torch.models.whisper import flatten

        return flatten(params)
    return list(params)


def muon_param_labels(params, ndim_threshold: int = 2) -> List[str]:
    """"muon" or "adamw" for each leaf of ``params`` (a nested dict, or the
    (path, leaf) list of ``Whisper.leaves()``), in leaf order. Stacked block
    leaves carry a leading layer axis, so the per-layer ndim is
    ``leaf.ndim - 1``."""
    return [
        "muon" if "blocks" in path and leaf.ndim - 1 >= ndim_threshold else "adamw"
        for path, leaf in _as_leaves(params)
    ]


def _muon_bucket_metadata(params, labels: Sequence[str], muon_lr: float, match: bool,
                          factor: float) -> List[Dict]:
    """Per-bucket LR telemetry: one entry per distinct effective last
    dimension among Muon-eligible matrices."""
    buckets = {}
    for (_, leaf), lab in zip(_as_leaves(params), labels):
        if lab != "muon":
            continue
        shape = tuple(leaf.shape[1:] if leaf.ndim >= 3 else leaf.shape)
        key = (len(shape), shape[-1])
        if key not in buckets:
            scale = rms_match_scale(shape, factor) if match else 1.0
            buckets[key] = {
                "lr_log_label": "muon",
                "base_lr_unscaled": muon_lr,
                "base_lr": muon_lr * scale,
                "bucket": key,
            }
    return list(buckets.values())


def _adam_like(conf: Dict, schedule: Optional[Schedule], decoupled: bool,
               use_8bit: bool = False):
    lr = float(conf.get("lr", 1e-3))
    betas = conf.get("betas", (0.9, 0.999))
    eps = float(conf.get("eps", 1e-8))
    wd = float(conf.get("weight_decay", 0.01 if decoupled else 0.0))
    kwargs = dict(learning_rate=_scheduled_lr(lr, schedule), b1=float(betas[0]),
                  b2=float(betas[1]), eps=eps, weight_decay=wd)
    if use_8bit:
        return (adamw_8bit if decoupled else adam_8bit)(**kwargs)
    return Adam(decoupled=decoupled, **kwargs)


def _use_muon(optimizer_conf: Dict) -> bool:
    if optimizer_conf.get("muon") is not None:
        return bool(optimizer_conf["muon"])
    return optimizer_conf.get("type") == "muon"


def get_optimizer(
    trainable_params,
    optimizer_conf: Dict,
    schedule: Optional[Schedule] = None,
    is_lora_run: bool = False,
    data_shard_axis: Optional[str] = None,
    data_axis_size: int = 1,
):
    """Build the optimizer for the trainable parameters (a nested dict, or
    the (path, leaf) list of ``Whisper.leaves()``; its ``init`` and
    ``fused_apply`` take the leaves in that order).

    Returns (optimizer, group_metadata); group_metadata is the per-group LR
    record the training script logs.
    """
    use_8bit = bool(optimizer_conf.get("8bit"))
    if use_8bit and is_lora_run:
        print("WARNING: Using 8-bit optimizer with LoRA training.")
        print(
            "If you observe training instability or zero gradients, try "
            "setting optimizer.8bit=False (8-bit state can quantize small "
            "gradient values to zero)."
        )

    if _use_muon(optimizer_conf):
        if optimizer_conf.get("type") not in (None, "adamw", "muon"):
            print(
                "WARNING: optimizer.type is ignored when optimizer.muon=True. "
                "Using Muon with auxiliary AdamW."
            )
        aux_8bit = bool(optimizer_conf.get("muon_aux_8bit", False))
        if use_8bit and not aux_8bit:
            print(
                "WARNING: optimizer.8bit=True is ignored for Muon "
                "(set optimizer.muon_aux_8bit=True for 8-bit auxiliary "
                "AdamW state)."
            )
        ndim_threshold = int(optimizer_conf.get("muon_ndim_threshold", 2))
        if ndim_threshold < 1:
            raise ValueError(
                f"optimizer.muon_ndim_threshold must be >= 1, got {ndim_threshold}"
            )
        match = bool(optimizer_conf.get("muon_match_adamw_update_rms", True))
        factor = float(optimizer_conf.get("muon_match_factor", 0.2))
        if factor <= 0:
            raise ValueError(
                f"optimizer.muon_match_factor must be > 0, got {factor}"
            )

        muon_conf = optimizer_conf.get("muon_params", {}) or {}
        adamw_conf = dict(optimizer_conf.get("params", {}) or {})
        adamw_conf.setdefault("lr", 3e-4)
        adamw_conf.setdefault("betas", (0.9, 0.95))
        adamw_conf.setdefault("eps", 1e-10)
        adamw_conf.setdefault("weight_decay", 0.0)
        if "amsgrad" in adamw_conf:
            print("WARNING: optimizer.params.amsgrad is not used by Muon auxiliary AdamW.")
            adamw_conf.pop("amsgrad")

        muon_lr = float(muon_conf.get("lr", 0.02))
        muon_momentum = float(muon_conf.get("momentum", 0.95))
        muon_wd = float(muon_conf.get("weight_decay", adamw_conf["weight_decay"]))

        labels = muon_param_labels(trainable_params, ndim_threshold)
        muon_tx = Muon(
            learning_rate=_scheduled_lr(muon_lr, schedule),
            momentum=muon_momentum,
            weight_decay=muon_wd,
            ns_steps=int(optimizer_conf.get("muon_ns_steps", 5)),
            ns_coeffs=str(optimizer_conf.get("muon_ns_coeffs", "classic")),
            match_adamw_update_rms=match,
            match_factor=factor,
            shard_axis=data_shard_axis,
            shard_axis_size=data_axis_size,
            momentum_dtype=optimizer_conf.get("muon_momentum_dtype"),
            chunk_temp_mb=optimizer_conf.get("muon_chunk_temp_mb", 128.0),
        )
        aux_tx = _adam_like(adamw_conf, schedule, decoupled=True, use_8bit=aux_8bit)
        tx = MuonWithAuxAdam(labels, muon_tx, aux_tx)
        metadata = _muon_bucket_metadata(trainable_params, labels, muon_lr, match, factor)
        n_muon = sum(1 for lab in labels if lab == "muon")
        n_aux = len(labels) - n_muon
        if n_aux > 0:
            metadata.append(
                {
                    "lr_log_label": "aux_adamw",
                    "base_lr_unscaled": float(adamw_conf["lr"]),
                    "base_lr": float(adamw_conf["lr"]),
                }
            )
        if match:
            print(
                f"Muon RMS matching active: factor={factor}, shared "
                f"base_lr={muon_lr}, shared weight_decay={muon_wd}"
            )
        print(
            f"Using Muon with auxiliary AdamW: {n_muon} Muon param leaves and "
            f"{n_aux} AuxAdamW param leaves"
        )
        return tx, metadata

    otype = optimizer_conf.get("type")
    params_conf = optimizer_conf.get("params", {}) or {}
    if otype == "adam":
        tx = _adam_like(params_conf, schedule, decoupled=False, use_8bit=use_8bit)
    elif otype == "adamw":
        tx = _adam_like(params_conf, schedule, decoupled=True, use_8bit=use_8bit)
    else:
        raise ValueError(
            f"Unknown optimizer type: {otype}. Must be adam or adamw."
        )
    metadata = [
        {
            "lr_log_label": otype,
            "base_lr_unscaled": float(params_conf.get("lr", 1e-3)),
            "base_lr": float(params_conf.get("lr", 1e-3)),
        }
    ]
    return tx, metadata
