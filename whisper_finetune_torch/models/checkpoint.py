"""Checkpoint I/O: OpenAI-whisper ``.pt`` files and the JAX package's tree
<-> the port's parameters; the port of
``whisper_finetune_tpu/models/checkpoint.py``.

The port keeps the JAX package's parameter layout (linear kernels (in, out),
conv kernels (width, in, out), block leaves stacked on a leading layer axis),
so the bridge to a JAX tree moves arrays across unchanged:
:func:`params_from_jax` takes the tree as nested dicts of numpy arrays (the
caller runs ``jax.tree.map(np.asarray, params)``) and :func:`params_to_numpy`
gives it back.

The OpenAI checkpoint is ``{"model_state_dict": ..., "dims": ...}`` with
torch's (out, in) kernels, one key per layer, written in fp16: the format
``whisper.load_model``, faster-whisper and CTranslate2's converter read.
Unmerged LoRA adapters are written under torch-parametrize / minLoRA names
(``<linear>.parametrizations.weight.original``, ``.0.lora_A`` (rank, in),
``.0.lora_B`` (out, rank)). Transposes and casts run on the parameters'
device, one stacked leaf at a time; the file itself is read and written on
the host.
"""

from __future__ import annotations

import hashlib
import os
import urllib.request
import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch

from whisper_finetune_torch._device import resolve_device
from whisper_finetune_torch.models.dims import ModelDimensions, get_preset_dims
from whisper_finetune_torch.models.lora import LORA_SUFFIX
from whisper_finetune_torch.models.whisper import Params, Whisper, flatten, init_params, sinusoids

NumpyTree = Dict[str, Any]

# (block-param path) -> (OpenAI per-layer suffix, transposed)
_BLOCK_MAP = [
    (("attn", "q_w"), "attn.query.weight", True),
    (("attn", "q_b"), "attn.query.bias", False),
    (("attn", "k_w"), "attn.key.weight", True),
    (("attn", "v_w"), "attn.value.weight", True),
    (("attn", "v_b"), "attn.value.bias", False),
    (("attn", "o_w"), "attn.out.weight", True),
    (("attn", "o_b"), "attn.out.bias", False),
    (("attn_ln", "scale"), "attn_ln.weight", False),
    (("attn_ln", "bias"), "attn_ln.bias", False),
    (("mlp", "fc1_w"), "mlp.0.weight", True),
    (("mlp", "fc1_b"), "mlp.0.bias", False),
    (("mlp", "fc2_w"), "mlp.2.weight", True),
    (("mlp", "fc2_b"), "mlp.2.bias", False),
    (("mlp_ln", "scale"), "mlp_ln.weight", False),
    (("mlp_ln", "bias"), "mlp_ln.bias", False),
]

_CROSS_MAP = [
    (("cross_attn", "q_w"), "cross_attn.query.weight", True),
    (("cross_attn", "q_b"), "cross_attn.query.bias", False),
    (("cross_attn", "k_w"), "cross_attn.key.weight", True),
    (("cross_attn", "v_w"), "cross_attn.value.weight", True),
    (("cross_attn", "v_b"), "cross_attn.value.bias", False),
    (("cross_attn", "o_w"), "cross_attn.out.weight", True),
    (("cross_attn", "o_b"), "cross_attn.out.bias", False),
    (("cross_attn_ln", "scale"), "cross_attn_ln.weight", False),
    (("cross_attn_ln", "bias"), "cross_attn_ln.bias", False),
]

# top-level (param path) -> OpenAI key
_TOP_MAP = [
    (("encoder", "ln_post", "scale"), "encoder.ln_post.weight"),
    (("encoder", "ln_post", "bias"), "encoder.ln_post.bias"),
    (("decoder", "tok_emb"), "decoder.token_embedding.weight"),
    (("decoder", "pos_emb"), "decoder.positional_embedding"),
    (("decoder", "ln", "scale"), "decoder.ln.weight"),
    (("decoder", "ln", "bias"), "decoder.ln.bias"),
]


def _sides(dims: ModelDimensions):
    return (("encoder", dims.n_audio_layer, _BLOCK_MAP),
            ("decoder", dims.n_text_layer, _BLOCK_MAP + _CROSS_MAP))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _expected_shapes(dims: ModelDimensions) -> Dict[tuple, tuple]:
    d_a, d_t = dims.n_audio_state, dims.n_text_state
    return {
        ("encoder", "conv1", "w"): (3, dims.n_mels, d_a),
        ("encoder", "conv2", "w"): (3, d_a, d_a),
        ("encoder", "blocks", "attn", "q_w"): (dims.n_audio_layer, d_a, d_a),
        ("decoder", "tok_emb"): (dims.n_vocab, d_t),
        ("decoder", "pos_emb"): (dims.n_text_ctx, d_t),
        ("decoder", "blocks", "attn", "q_w"): (dims.n_text_layer, d_t, d_t),
    }


def _check_shapes(shapes: Dict[tuple, tuple], dims: ModelDimensions) -> None:
    for path, want in _expected_shapes(dims).items():
        if shapes.get(path) != want:
            raise ValueError(f"{'.'.join(path)}: shape {shapes.get(path)}, dims say {want}")


# ---------------------------------------------------------------------------
# The JAX tree
# ---------------------------------------------------------------------------

def params_from_jax(tree: NumpyTree, dims: ModelDimensions, device="cuda") -> Whisper:
    """JAX parameter tree (nested dicts of numpy arrays, LoRA adapters
    included) -> :class:`Whisper` on ``device``, holding float32 copies of
    the same values."""
    dev = resolve_device(device)
    _check_shapes({path: np.shape(a) for path, a in flatten(tree)}, dims)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)

    return Whisper(dims, convert(tree))


def params_to_numpy(model: Whisper) -> NumpyTree:
    """:class:`Whisper` -> the JAX parameter tree as nested dicts of float32
    numpy arrays (the inverse of :func:`params_from_jax`)."""

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return node.detach().to("cpu", torch.float32).numpy()

    return convert(model.params())


# ---------------------------------------------------------------------------
# OpenAI state dicts
# ---------------------------------------------------------------------------

def state_dict_to_params(state_dict: Dict[str, Any], dims: ModelDimensions,
                         device="cuda") -> Params:
    """An OpenAI-whisper state dict (torch tensors or numpy arrays, any float
    dtype; unmerged LoRA keys included) -> the stacked tree of float32
    tensors on ``device``."""
    dev = resolve_device(device)

    def grab(name: str) -> torch.Tensor:
        return torch.as_tensor(state_dict[name]).to(dev).float()

    def stack(tensors, transpose: bool) -> torch.Tensor:
        t = torch.stack([torch.as_tensor(x) for x in tensors]).to(dev).float()
        return t.transpose(-1, -2).contiguous() if transpose else t

    params: Params = {"encoder": {}, "decoder": {}}
    for conv in ("conv1", "conv2"):  # torch (out, in, k) -> (k, in, out)
        params["encoder"][conv] = {
            "w": grab(f"encoder.{conv}.weight").permute(2, 1, 0).contiguous(),
            "b": grab(f"encoder.{conv}.bias"),
        }
    for path, key in _TOP_MAP:
        _set(params, path, grab(key))

    for side, n_layers, maps in _sides(dims):
        blocks: Params = {}
        for path, suffix, transpose in maps:
            keys = [f"{side}.blocks.{i}.{suffix}" for i in range(n_layers)]
            if all(k in state_dict for k in keys):
                _set(blocks, path, stack([state_dict[k] for k in keys], transpose))
                continue
            # torch-parametrize / minLoRA layout (an unmerged LoRA checkpoint)
            bases = [f"{side}.blocks.{i}.{suffix[:-len('.weight')]}.parametrizations.weight"
                     for i in range(n_layers)]
            have = [f"{b}.0.lora_A" in state_dict for b in bases]
            if any(have) and not all(have):
                raise ValueError(f"Partial LoRA adapters for {side}.{suffix}: "
                                 f"{sum(have)}/{n_layers} layers")
            _set(blocks, path, stack([state_dict[f"{b}.original"] for b in bases], transpose))
            # minLoRA: A (rank, in), B (out, rank); ours are their transposes
            _set(blocks, path[:-1] + (path[-1] + LORA_SUFFIX,), {
                "a": stack([state_dict[f"{b}.0.lora_A"] for b in bases], True),
                "b": stack([state_dict[f"{b}.0.lora_B"] for b in bases], True),
            })
        params[side]["blocks"] = blocks
    return params


def params_to_state_dict(params: Params, dims: ModelDimensions,
                         dtype: torch.dtype = torch.float16) -> Dict[str, torch.Tensor]:
    """The tree (tensors on any device) -> an OpenAI-whisper state dict of
    contiguous host tensors in ``dtype`` (fp16 by default, as the reference
    saves), each key its own storage. Adapted kernels are written under the
    parametrize names."""
    out: Dict[str, torch.Tensor] = {}

    def host(t: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        t = t.detach().to(dtype)
        if transpose:
            t = t.transpose(-1, -2)
        return t.contiguous().cpu()

    def put_layers(prefix: str, leaves) -> None:
        """(suffix, stacked leaf, transposed) written layer by layer."""
        layers = [(suffix, host(t, transpose).unbind(0)) for suffix, t, transpose in leaves]
        for i in range(len(layers[0][1])):
            for suffix, ts in layers:
                out[f"{prefix}.{i}.{suffix}"] = ts[i].clone()

    enc, dec = params["encoder"], params["decoder"]
    for conv in ("conv1", "conv2"):
        out[f"encoder.{conv}.weight"] = host(enc[conv]["w"].permute(2, 1, 0))
        out[f"encoder.{conv}.bias"] = host(enc[conv]["b"])
    # The sinusoidal buffer is part of the official state dict.
    out["encoder.positional_embedding"] = host(
        torch.from_numpy(sinusoids(dims.n_audio_ctx, dims.n_audio_state)))
    for path, key in _TOP_MAP:
        out[key] = host(_get(params, path))

    for side, _, maps in _sides(dims):
        blocks = params[side]["blocks"]
        for path, suffix, transpose in maps:
            group = blocks[path[0]]
            lora = group.get(path[1] + LORA_SUFFIX)
            prefix = f"{side}.blocks"
            if lora is None:
                put_layers(prefix, [(suffix, group[path[1]], transpose)])
                continue
            base = f"{suffix[:-len('.weight')]}.parametrizations.weight"
            put_layers(prefix, [(f"{base}.original", group[path[1]], transpose),
                                (f"{base}.0.lora_A", lora["a"], True),
                                (f"{base}.0.lora_B", lora["b"], True)])
    return out


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def load_checkpoint(path: str, device="cuda") -> Tuple[Whisper, ModelDimensions]:
    """An OpenAI-format ``.pt`` file -> (:class:`Whisper` on ``device``, dims)."""
    dev = resolve_device(device)
    with open(path, "rb") as fp:
        ckpt = torch.load(fp, map_location="cpu", weights_only=True)
    if "omni_dims" in ckpt:  # the speech LLM's own format (models/omni.py)
        from whisper_finetune_torch.models import omni

        return omni.from_checkpoint(ckpt, dev)
    if "dims" not in ckpt or "model_state_dict" not in ckpt:
        raise ValueError(f"{path} is not an OpenAI-whisper checkpoint "
                         "(missing 'dims'/'model_state_dict')")
    dims = ModelDimensions.from_dict(ckpt["dims"])
    params = state_dict_to_params(ckpt["model_state_dict"], dims, dev)
    _check_shapes({p: tuple(a.shape) for p, a in flatten(params)}, dims)
    return Whisper(dims, params), dims


def save_checkpoint(path: str, params, dims: ModelDimensions,
                    dtype: torch.dtype = torch.float16) -> None:
    """Write ``{"model_state_dict", "dims"}`` in ``dtype`` (fp16 by default,
    loadable by ``whisper.load_model``: the reference's output contract;
    float32 keeps trained adapters exact for a later merge). ``params``: a
    :class:`Whisper` or its tree."""
    if isinstance(params, Whisper):
        params = params.params()
    state = params_to_state_dict(params, dims, dtype)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model_state_dict": state, "dims": dims.to_dict()}, path)


# Official OpenAI checkpoint digests; the URL layout is
# <base>/<sha256>/<name>.pt. large-v3-turbo has no digest here: no
# unverifiable downloads.
_OFFICIAL_BASE_URL = "https://openaipublic.azureedge.net/main/whisper/models"
_OFFICIAL_SHA256 = {
    "tiny.en": "d3dd57d32accea0b295c96e26691aa14d8822fac7d9d27d5dc00b4ca2826dd03",
    "tiny": "65147644a518d12f04e32d6f3b26facc3f8dd46e5390956a9424a650c0ce22b9",
    "base.en": "25a8566e1d0c1e2231d1c762132cd20e0f96a85d16145c3a00adf5d1ac670ead",
    "base": "ed3a0b6b1c0edf879ad9b11b1af5a0e6ab5db9205f891f668f8b0e6c6326e34e",
    "small.en": "f953ad0fd29cacd07d5a9eda5624af0f6bcf2258be67c92b79389873d91e0872",
    "small": "9ecf779972d90ba49c06d968637d720dd632c55bbf19d441fb42bf17a411e794",
    "medium.en": "d7440d1dc186f76616474e0ff0b3b6b879abc9d1a4926b7adfa41db2d497ab4f",
    "medium": "345ae4da62f9b3d59415adc60127b97c714f32e89e936602e85993674d08dcb1",
    "large": "e4b87e7e0bf463eb8e6956e646f1e277e901512310def2c24bf0e11bd3c28e9a",
    "large-v2": "81f7c96c852ee8fc832187b0132e569d6c3065a3252ed18e56effd0b6a73e524",
    "large-v3": "e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb",
}


def _sha256_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fp:
        for chunk in iter(lambda: fp.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def fetch_checkpoint(name: str, root: str) -> str:
    """SHA256-verified download of an official OpenAI checkpoint into
    ``root``; returns its path. A cached file with the right digest is
    reused, a cached mismatch warns and downloads again, a mismatch after the
    download raises. ``WFT_CHECKPOINT_BASE_URL`` overrides the base URL (a
    mirror, or a ``file://`` tree)."""
    expected = _OFFICIAL_SHA256.get(name)
    if expected is None:
        raise ValueError(f"No official checkpoint digest for '{name}' "
                         f"(available: {', '.join(sorted(_OFFICIAL_SHA256))})")
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, f"{name}.pt")
    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if _sha256_file(target) == expected:
            return target
        warnings.warn(f"{target} exists, but the SHA256 checksum does not match; "
                      "re-downloading")
    base = os.environ.get("WFT_CHECKPOINT_BASE_URL", _OFFICIAL_BASE_URL)
    url = f"{base}/{expected}/{name}.pt"
    print(f"Downloading {url}")
    with urllib.request.urlopen(url) as source, open(target, "wb") as out:
        for buf in iter(lambda: source.read(1 << 20), b""):
            out.write(buf)
    if _sha256_file(target) != expected:
        raise RuntimeError(f"Downloaded {name}.pt but the SHA256 checksum does not match; "
                           "retry the download.")
    return target


def load_model(name: str, device="cuda") -> Tuple[Whisper, ModelDimensions]:
    """A model by checkpoint path or preset name, on ``device``: a file path
    loads that file; a preset (``tiny`` .. ``large-v3-turbo``, or the speech
    LLM ``uni-moe-2.0-omni``, :class:`omni.OmniModel`) loads
    ``$WHISPER_CHECKPOINT_DIR/<name>.pt``, else with ``WFT_ALLOW_DOWNLOAD=1``
    fetches the official file into that directory (default
    ``~/.cache/whisper_finetune_tpu``), else with ``WFT_ALLOW_RANDOM_INIT=1``
    initialises at random (seed 0). Otherwise missing weights are an error:
    fine-tuning a random model by accident would waste a whole run."""
    dev = resolve_device(device)
    if os.path.isfile(name):
        return load_checkpoint(name, dev)
    from whisper_finetune_torch.models import omni

    dims = get_preset_dims(name) or omni.OMNI_PRESETS.get(name)
    if dims is None:
        raise ValueError(f"Unknown model name or missing checkpoint file: {name}")
    ckpt_dir = os.environ.get("WHISPER_CHECKPOINT_DIR")
    if ckpt_dir:
        candidate = os.path.join(ckpt_dir, f"{name}.pt")
        if os.path.isfile(candidate):
            return load_checkpoint(candidate, dev)
    if os.environ.get("WFT_ALLOW_DOWNLOAD") and name in _OFFICIAL_SHA256:
        root = ckpt_dir or os.path.expanduser("~/.cache/whisper_finetune_tpu")
        return load_checkpoint(fetch_checkpoint(name, root), dev)
    if not os.environ.get("WFT_ALLOW_RANDOM_INIT"):
        raise FileNotFoundError(
            f"No pretrained checkpoint for preset '{name}'. Point "
            f"WHISPER_CHECKPOINT_DIR at a directory containing {name}.pt "
            "(an OpenAI-format whisper checkpoint), pass an explicit "
            "checkpoint path as model.init_name, set WFT_ALLOW_DOWNLOAD=1 "
            "to fetch the official checkpoint (SHA256-verified), or set "
            "WFT_ALLOW_RANDOM_INIT=1 to deliberately train from random "
            "initialization."
        )
    print(f"No local checkpoint for '{name}'; initializing {name} architecture "
          "with random weights (WFT_ALLOW_RANDOM_INIT=1).")
    if omni.is_omni(dims):
        return omni.init_params(dims, device=dev, seed=0), dims
    return init_params(dims, device=dev, seed=0), dims
