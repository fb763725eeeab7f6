"""Random Uni-MoE-2.0-Omni weights from a seed, drawn on the device one unit
at a time: the benchmark's own statement of the speech-to-text path's leaves
(it imports nothing of the program, which the reference shares).

A unit is one leaf, or one layer of a language-model block leaf (a leaf
stacked over the 28 layers would be up to 30 GB in float32): each comes from
``benchmark/weights.py::make_leaf`` with the unit's index in :func:`units`,
so any unit can be drawn again alone. The tower's units are the Whisper
encoder's leaves of ``benchmark/weights.py`` (the same laws), whole.

Laws: kernels (in, out) and biases U(+-1/sqrt(fan_in)), as a torch
``Linear`` draws them; the router U(+-3/sqrt(d)), so that its logits spread
enough for the top-p cut to take one expert at about a third of the
(token, layer) pairs and two at the rest; RMSNorm gains 1 + U(-0.1, 0.1);
the embedding N(0, 0.02^2).

The deployment serves a bf16 checkpoint, so every unit is rounded to bf16
as soon as it is drawn: the program holds it so (the norm gains and the
router upcast to float32 again), the reference upcasts it to float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from benchmark.weights import Spec, leaf_specs, make_leaf

ROUTER_SCALE = 3.0
FLOAT32_KEYS = ("attn_norm", "mlp_norm", "norm", "router")
Unit = Tuple[Spec, Optional[int]]


def lm_specs(dims: Mapping) -> List[Spec]:
    """(path, shape, law, scale) of the adapter's and the language model's
    leaves, the block leaves with their leading layer axis."""
    L, d, D = int(dims["n_layer"]), int(dims["d_model"]), int(dims["head_dim"])
    hq, hkv = int(dims["n_head"]) * D, int(dims["n_kv_head"]) * D
    nf, ff = int(dims["n_fixed"]), int(dims["fixed_width"])
    ne, fe = int(dims["n_dynamic"]), int(dims["dynamic_width"])
    da, V = int(dims["tower"]["n_audio_state"]), int(dims["n_vocab"])
    R = int(dims["n_dynamic"]) + int(dims["n_null"])
    u = 1.0 / math.sqrt(d)
    b = ("lm", "blocks")
    specs = [
        (("adapter", "b"), (d,), "uniform", 1.0 / math.sqrt(da)),
        (("adapter", "w"), (da, d), "uniform", 1.0 / math.sqrt(da)),
        (b + ("attn", "k_b"), (L, hkv), "uniform", u),
        (b + ("attn", "k_w"), (L, d, hkv), "uniform", u),
        (b + ("attn", "o_w"), (L, hq, d), "uniform", 1.0 / math.sqrt(hq)),
        (b + ("attn", "q_b"), (L, hq), "uniform", u),
        (b + ("attn", "q_w"), (L, d, hq), "uniform", u),
        (b + ("attn", "v_b"), (L, hkv), "uniform", u),
        (b + ("attn", "v_w"), (L, d, hkv), "uniform", u),
        (b + ("attn_norm",), (L, d), "gain", 0.1),
        (b + ("experts", "down"), (L, ne, fe, d), "uniform", 1.0 / math.sqrt(fe)),
        (b + ("experts", "gate"), (L, ne, d, fe), "uniform", u),
        (b + ("experts", "up"), (L, ne, d, fe), "uniform", u),
        (b + ("fixed", "down"), (L, nf, ff, d), "uniform", 1.0 / math.sqrt(ff)),
        (b + ("fixed", "gate"), (L, nf, d, ff), "uniform", u),
        (b + ("fixed", "up"), (L, nf, d, ff), "uniform", u),
        (b + ("mlp_norm",), (L, d), "gain", 0.1),
        (b + ("router",), (L, d, R), "uniform", ROUTER_SCALE * u),
        (("lm", "embed"), (V, d), "normal", 0.02),
        (("lm", "head"), (d, V), "uniform", u),
        (("lm", "norm"), (d,), "gain", 0.1),
    ]
    return sorted(specs, key=lambda s: s[0])


def units(dims: Mapping) -> List[Unit]:
    """Every unit drawn, in index order: the tower's leaves, then the
    adapter's and the language model's (block leaves a layer a unit)."""
    out: List[Unit] = [(s, None) for s in leaf_specs(dims["tower"]) if s[0][0] == "encoder"]
    for path, shape, law, scale in lm_specs(dims):
        if path[:2] == ("lm", "blocks"):
            out += [((path, shape[1:], law, scale), i) for i in range(shape[0])]
        else:
            out.append(((path, shape, law, scale), None))
    return out


def held_dtype(path: Tuple[str, ...], dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if path[0] == "lm" and path[-1] in FLOAT32_KEYS else dtype


def _put(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def program_weights(dims: Mapping, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The nested dict the program holds: every unit drawn, rounded to bf16
    at once and laid into its (stacked) leaf in the held dtype."""
    L = int(dims["n_layer"])
    tree: Dict = {}
    stacked: Dict[Tuple[str, ...], torch.Tensor] = {}
    for i, (spec, layer) in enumerate(units(dims)):
        path = spec[0]
        leaf = make_leaf(spec, seed, i, device).to(torch.bfloat16).to(held_dtype(path, dtype))
        if layer is None:
            _put(tree, path, leaf)
            continue
        if path not in stacked:
            stacked[path] = torch.empty((L,) + tuple(spec[1]), dtype=leaf.dtype, device=device)
            _put(tree, path, stacked[path])
        stacked[path][layer].copy_(leaf)
        del leaf
    return tree


class ReferenceLeaves:
    """The units drawn again, one at a time, as the reference reads them:
    float32 of the bf16-rounded values."""

    def __init__(self, dims: Mapping, seed: int, device):
        self.seed, self.device = int(seed), device
        self.index = {(spec[0], layer): (i, spec) for i, (spec, layer) in enumerate(units(dims))}

    def get(self, path: Tuple[str, ...], layer: Optional[int] = None) -> torch.Tensor:
        i, spec = self.index[(tuple(path), layer)]
        return make_leaf(spec, self.seed, i, self.device).to(torch.bfloat16).float()

    def tree(self, prefix: Tuple[str, ...], layer: Optional[int] = None) -> Dict:
        """Every unit under ``prefix`` (of one layer, for the blocks) as a
        nested dict below the prefix."""
        out: Dict = {}
        for (path, lay) in self.index:
            if path[: len(prefix)] == prefix and lay == layer:
                _put(out, path[len(prefix):], self.get(path, layer))
        return out
