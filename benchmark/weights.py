"""Random Whisper weights from a seed, made on the device.

The benchmark's own input: a nested dict of float32 tensors in the port's
parameter layout (linear kernels (in, out), conv kernels (width, in, out),
block leaves stacked on a leading layer axis, keys sorted as the port
flattens them). Each leaf comes from a ``torch.Generator`` of its own,
seeded from the run's seed and the leaf's index, in one call a leaf, so any
leaf can be made again alone (the parameters' change after the first steps
is read against the leaf made anew) and the reference gets the very same
numbers without taking anything from the program.

Kernels are uniform in +-1/sqrt(fan_in) as a torch ``Linear`` draws them;
biases too (not zero, so that a path that drops a bias shows); layer-norm
gains are 1 + U(-0.1, 0.1) and shifts U(-0.1, 0.1); the token embedding is
N(0, 0.02^2), the learned positions N(0, 0.01^2).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

Spec = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]


def _block_specs(prefix: Tuple[str, ...], L: int, d: int, cross: bool) -> List[Spec]:
    s = []
    attn_names = ("attn", "cross_attn") if cross else ("attn",)
    for a in attn_names:
        for k in ("k_w", "o_b", "o_w", "q_b", "q_w", "v_b", "v_w"):
            shape = (L, d) if k.endswith("_b") else (L, d, d)
            s.append((prefix + (a, k), shape, "uniform", 1.0 / math.sqrt(d)))
        s.append((prefix + (a + "_ln", "bias"), (L, d), "shift", 0.1))
        s.append((prefix + (a + "_ln", "scale"), (L, d), "gain", 0.1))
    s += [
        (prefix + ("mlp", "fc1_b"), (L, 4 * d), "uniform", 1.0 / math.sqrt(d)),
        (prefix + ("mlp", "fc1_w"), (L, d, 4 * d), "uniform", 1.0 / math.sqrt(d)),
        (prefix + ("mlp", "fc2_b"), (L, d), "uniform", 1.0 / math.sqrt(4 * d)),
        (prefix + ("mlp", "fc2_w"), (L, 4 * d, d), "uniform", 1.0 / math.sqrt(4 * d)),
        (prefix + ("mlp_ln", "bias"), (L, d), "shift", 0.1),
        (prefix + ("mlp_ln", "scale"), (L, d), "gain", 0.1),
    ]
    return s


def leaf_specs(dims: Mapping) -> List[Spec]:
    """(path, shape, law, scale) of every leaf, in sorted-key order."""
    m, da, La = int(dims["n_mels"]), int(dims["n_audio_state"]), int(dims["n_audio_layer"])
    dt, Lt = int(dims["n_text_state"]), int(dims["n_text_layer"])
    V, T = int(dims["n_vocab"]), int(dims["n_text_ctx"])
    specs = (
        _block_specs(("decoder", "blocks"), Lt, dt, cross=True)
        + [
            (("decoder", "ln", "bias"), (dt,), "shift", 0.1),
            (("decoder", "ln", "scale"), (dt,), "gain", 0.1),
            (("decoder", "pos_emb"), (T, dt), "normal", 0.01),
            (("decoder", "tok_emb"), (V, dt), "normal", 0.02),
        ]
        + _block_specs(("encoder", "blocks"), La, da, cross=False)
        + [
            (("encoder", "conv1", "b"), (da,), "uniform", 1.0 / math.sqrt(3 * m)),
            (("encoder", "conv1", "w"), (3, m, da), "uniform", 1.0 / math.sqrt(3 * m)),
            (("encoder", "conv2", "b"), (da,), "uniform", 1.0 / math.sqrt(3 * da)),
            (("encoder", "conv2", "w"), (3, da, da), "uniform", 1.0 / math.sqrt(3 * da)),
            (("encoder", "ln_post", "bias"), (da,), "shift", 0.1),
            (("encoder", "ln_post", "scale"), (da,), "gain", 0.1),
        ]
    )
    return sorted(specs, key=lambda s: s[0])


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` of a run seeded ``seed``."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63)


def make_leaf(spec: Spec, seed: int, index: int, device) -> torch.Tensor:
    _, shape, law, scale = spec
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if law == "normal":
        return out.normal_(0.0, scale, generator=gen)
    out.uniform_(-scale, scale, generator=gen)
    if law == "gain":
        out.add_(1.0)
    return out


def make_weights(dims: Mapping, seed: int, device) -> Dict:
    """The nested dict of every leaf."""
    tree: Dict = {}
    for i, spec in enumerate(leaf_specs(dims)):
        path, leaf = spec[0], make_leaf(spec, seed, i, device)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
