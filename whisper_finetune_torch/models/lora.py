"""LoRA: low-rank adapters on the transformer block linears, the port of
``whisper_finetune_tpu/models/lora.py``.

Adapters are extra leaves inside the stacked block tree, beside the kernel
they adapt: ``attn["q_w_lora"] = {"a": (L, in, r), "b": (L, r, out)}``, on
every block linear (q, k, v, out, cross-attention q, k, v, out, fc1, fc2),
encoder-only or decoder-only if asked. minLoRA's initialisation: A uniform
in +-1/sqrt(in) from an explicit ``torch.Generator``, B zero. The forward
folds a layer's adapters into its float32 kernels inside the checkpointed
block (:func:`materialize_block_lora`): ``W + scale * (a @ b)``, so no
merged copy of the model exists and the recompute folds again.
:func:`merge_lora` folds the same way layer by layer, so a merged model's
forward gives the runtime-LoRA forward's logits bit for bit (with TF32 off,
PyTorch's default for matmuls).

LoRA dropout masks rows of A (the input rows, one mask a layer, shared by the
batch): the draws come in with the forward's other draws
(``models/whisper.py::ForwardDraws``), as a {0, 1} row vector a layer that
:func:`materialize_block_lora` consumes kernel by kernel, in the block's
sorted key order (the JAX package's key walk).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from whisper_finetune_torch.models.whisper import Params, flatten
from whisper_finetune_torch.ops.remat import named

# Block-linear kernels (conv stem and embeddings excluded).
_ENCODER_TARGETS = [("attn", "q_w"), ("attn", "k_w"), ("attn", "v_w"), ("attn", "o_w"),
                    ("mlp", "fc1_w"), ("mlp", "fc2_w")]
_DECODER_TARGETS = _ENCODER_TARGETS + [
    ("cross_attn", "q_w"), ("cross_attn", "k_w"),
    ("cross_attn", "v_w"), ("cross_attn", "o_w"),
]

LORA_SUFFIX = "_lora"


def _copy_dicts(tree: Params) -> Params:
    return {k: _copy_dicts(v) if isinstance(v, dict) else v for k, v in tree.items()}


def apply_lora(
    params: Params,
    rank: int = 16,
    alpha: float = 32.0,
    dropout: float = 0.0,
    encoder_only: bool = False,
    decoder_only: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Params, Params]:
    """Adapter leaves added to a copy of the tree, and the trainable mask
    (True on adapter leaves only: every base parameter is frozen). A is drawn
    from ``generator`` (one seeded with 0 on the kernels' device if None),
    side by side and target by target."""
    if encoder_only and decoder_only:
        raise ValueError("encoder_only and decoder_only are mutually exclusive")
    params = _copy_dicts(params)
    sides = []
    if not decoder_only:
        sides.append(("encoder", _ENCODER_TARGETS))
    if not encoder_only:
        sides.append(("decoder", _DECODER_TARGETS))
    for side, targets in sides:
        blocks = params[side]["blocks"]
        for group, name in targets:
            w = blocks[group][name]
            n_layers, fan_in, fan_out = w.shape
            if generator is None:
                generator = torch.Generator(device=w.device).manual_seed(0)
            bound = 1.0 / math.sqrt(fan_in)
            a = torch.empty((n_layers, fan_in, rank), dtype=torch.float32, device=w.device)
            blocks[group][name + LORA_SUFFIX] = {
                "a": a.uniform_(-bound, bound, generator=generator),
                "b": torch.zeros((n_layers, rank, fan_out), dtype=torch.float32,
                                 device=w.device),
            }

    def mask(tree, lora: bool):
        return {k: mask(v, lora or k.endswith(LORA_SUFFIX)) if isinstance(v, dict) else lora
                for k, v in tree.items()}

    return params, mask(params, False)


def lora_scale(rank: int, alpha: float) -> float:
    return float(alpha) / float(rank)


def has_lora(params: Params) -> bool:
    return any(any(k.endswith(LORA_SUFFIX) for k in path) for path, _ in flatten(params))


def merged_kernel(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """One layer's ``w + scale * (a @ b)`` in float32; ``a @ b`` is a
    ``dots`` site."""
    return w + scale * named(None, torch.mm, a, b, dot=True)


def materialize_block_lora(bp: Params, scale: float, dropout: float = 0.0,
                           keep: Optional[torch.Tensor] = None) -> Params:
    """One layer's block dict with each adapted kernel replaced by
    :func:`merged_kernel` and the adapter leaves dropped. ``keep`` is the
    layer's LoRA dropout row vector ({0, 1}), consumed kernel by kernel in
    sorted key order; None (or ``dropout`` 0) for no dropout."""
    out: Params = {}
    offset = 0
    for group in sorted(bp):
        sub = bp[group]
        if not isinstance(sub, dict):
            out[group] = sub
            continue
        new_sub = {}
        for name in sorted(sub):
            if name.endswith(LORA_SUFFIX):
                continue
            lora = sub.get(name + LORA_SUFFIX)
            if lora is None:
                new_sub[name] = sub[name]
                continue
            a = lora["a"]
            if keep is not None and dropout > 0.0:
                rows = keep[offset:offset + a.shape[0]]
                offset += a.shape[0]
                a = a * rows[:, None] / (1.0 - dropout)
            new_sub[name] = merged_kernel(sub[name], a, lora["b"], scale)
        out[group] = new_sub
    return out


def _is_adapter(name: str, leaf) -> bool:
    return name.endswith(LORA_SUFFIX) and isinstance(leaf, dict) and set(leaf) == {"a", "b"}


@torch.no_grad()
def merge_lora(params: Params, rank: int, alpha: float) -> Params:
    """Fold adapters into their kernels for good and drop them: layer by
    layer, the computation of the runtime forward."""
    scale = lora_scale(rank, alpha)

    def walk(tree):
        out = {}
        for name, leaf in tree.items():
            if _is_adapter(name, leaf):
                continue
            lora = tree.get(name + LORA_SUFFIX)
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif lora is not None and _is_adapter(name + LORA_SUFFIX, lora):
                out[name] = torch.stack([
                    merged_kernel(w, a, b, scale)
                    for w, a, b in zip(leaf.unbind(0), lora["a"].unbind(0), lora["b"].unbind(0))])
            else:
                out[name] = leaf
        return out

    return walk(params)


def remove_lora(params: Params) -> Params:
    """Drop the adapters without merging them."""
    return {k: remove_lora(v) if isinstance(v, dict) else v
            for k, v in params.items() if not _is_adapter(k, v)}


# ---------------------------------------------------------------------------
# Debug statistics
# ---------------------------------------------------------------------------

def _lora_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    """("a" or "b", leaf) of every adapter leaf of a nested dict, or of a
    (path, leaf) list such as ``Whisper.leaves()`` or a gradient list zipped
    with its paths."""
    leaves = flatten(tree) if isinstance(tree, dict) else tree
    return [(path[-1], leaf) for path, leaf in leaves
            if any(k.endswith(LORA_SUFFIX) for k in path[:-1]) and path[-1] in ("a", "b")]


def _sq(leaf: torch.Tensor) -> float:
    return float(leaf.detach().double().square().sum())


def get_lora_param_stats(params) -> Dict[str, float]:
    """Global A/B Frobenius norms, adapter count (layers x kernels) and
    parameter counts."""
    a_sq = b_sq = 0.0
    a_count = b_count = n_adapters = 0
    for which, leaf in _lora_leaves(params):
        if which == "a":
            a_sq += _sq(leaf)
            a_count += leaf.numel()
            n_adapters += leaf.shape[0]  # stacked layer axis
        else:
            b_sq += _sq(leaf)
            b_count += leaf.numel()
    return {
        "lora_debug/num_adapters": n_adapters,
        "lora_debug/A_norm": math.sqrt(a_sq),
        "lora_debug/B_norm": math.sqrt(b_sq),
        "lora_debug/A_params": a_count,
        "lora_debug/B_params": b_count,
    }


def get_lora_grad_stats(grads) -> Dict[str, float]:
    """Gradient norms over the adapter leaves (after the backward, before the
    update)."""
    sq = {"a": 0.0, "b": 0.0}
    for which, leaf in _lora_leaves(grads):
        sq[which] += _sq(leaf)
    return {"lora_debug/A_grad_norm": math.sqrt(sq["a"]),
            "lora_debug/B_grad_norm": math.sqrt(sq["b"])}


class LoRAUpdateTracker:
    """||dA|| and ||dB|| between snapshots of the adapters (taken at eval
    boundaries): each call reports the change since the previous one."""

    def __init__(self, params):
        self._prev = self._snapshot(params)

    @staticmethod
    def _snapshot(params) -> List[Tuple[str, torch.Tensor]]:
        return [(which, leaf.detach().float().clone()) for which, leaf in _lora_leaves(params)]

    def update_and_stats(self, params) -> Dict[str, float]:
        cur = self._snapshot(params)
        sq = {"a": 0.0, "b": 0.0}
        for (which, now), (_, prev) in zip(cur, self._prev):
            sq[which] += _sq(now.double() - prev.double())
        self._prev = cur
        return {"lora_debug/A_update_norm": math.sqrt(sq["a"]),
                "lora_debug/B_update_norm": math.sqrt(sq["b"])}
