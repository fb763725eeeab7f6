"""Whisper encoder-decoder, the port of ``whisper_finetune_tpu/models/whisper.py``.

Parameters keep the JAX package's pytree and layout exactly: linear kernels
(in, out), conv kernels (width, in, out), block weights stacked on a leading
layer axis, ``(L, in, out)`` per leaf. :class:`Whisper` holds that tree as
``nn.Parameter``s; the forward functions are plain functions over the nested
dict that :meth:`Whisper.params` returns, mirroring the JAX functions one for
one. Keeping the stacked layout matters to the optimizer: every leaf flattens
in the same order as in JAX, so the 8-bit AdamW's 256-element blocks and its
``MIN_QUANT_SIZE`` decisions match the reference, and its kernel launches
once per stacked leaf.

Each forward takes the per-layer views with ONE ``unbind(0)`` per stacked
leaf (its backward is a single stack; indexing ``w[i]`` in the layer loop
would make autograd build a zero-padded full-size gradient per layer). In a
bf16 forward the stacked matrices are first cast once (``w.to(bf16)``, the
counterpart of ``_cast_blocks_once``), which is numerically the cast that
``_dense`` would do at use; with ``precast_weights=False`` they stay float32
and each block casts its own slices at use (inside the checkpointed block,
so only one layer's bf16 copies are live: ``_cast_block_slice``).

Precision policy: parameters float32, matmuls and convs in ``compute_dtype``,
layer norms and softmax in float32, the tied logits stored in the compute
dtype and then upcast. A projection with a bias is one ``addmm`` (the bias
joins in the product's epilogue, one rounding to the compute dtype).

Rematerialisation: each checkpointed block runs under
``torch.utils.checkpoint`` (non-reentrant); ``remat_policy`` other than
``full`` keeps the named sites of JAX's forward (``enc_qkv``, ``cross_kv``,
``enc_mlp_h``, ``dec_ln2``, ``attn_probs``, ...) through
:mod:`whisper_finetune_torch.ops.remat`. LoRA adapters (``<kernel>_lora``
leaves, :mod:`whisper_finetune_torch.models.lora`) are folded into their
float32 kernels inside the checkpointed block, so the recompute folds them
again; a LoRA forward casts weights at use instead of precasting them.

Randomness of a training forward (stochastic depth, deep SpecAugment, LoRA
dropout) is a :class:`ForwardDraws`: every uniform number of the forward,
drawn at once by :func:`draw_forward` and held on the host. The layer loop reads the coins as
Python floats (a skipped layer runs nothing and syncs nothing) and the masks
are built from them outside the checkpointed blocks, so a recompute sees
exactly the forward's values. The layout is the JAX package's
(``encoder_step_rng`` / ``decoder_step_rng``): per encoder layer one coin and
one (time, feature) mask pair, one gate per forward, per decoder layer one
coin.

A float32 forward on the card would run the stem's convolutions through
cuDNN in TF32 unless ``torch.backends.cudnn.allow_tf32`` is off; the main
path computes in bf16, where this does not arise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from whisper_finetune_torch._device import resolve_device
from whisper_finetune_torch.models.dims import ModelDimensions
from whisper_finetune_torch.ops.attention import attention
from whisper_finetune_torch.ops.layer_norm import layer_norm_op
from whisper_finetune_torch.ops.remat import named, parse_remat_policy
from whisper_finetune_torch.runtime import span

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Static forward configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ForwardConfig:
    """The JAX ``ForwardConfig`` fields (``remat_policy``: the grammar of
    :mod:`whisper_finetune_torch.ops.remat`; ``lora_scale`` 0 leaves any
    adapters inert)."""

    compute_dtype: str = "bfloat16"
    remat_encoder: bool = True
    remat_encoder_last_only: bool = False
    remat_decoder: bool = True
    remat_policy: str = "full"
    stochastic_depth: float = 0.0
    stochastic_depth_encoder: Optional[float] = None
    stochastic_depth_decoder: Optional[float] = None
    dsa_apply: bool = False
    dsa_time_mask_param: int = 100
    dsa_freq_mask_param: int = 27
    dsa_p: float = 1.0
    dsa_layer_indices: Optional[Tuple[int, ...]] = None
    lora_scale: float = 0.0
    lora_dropout: float = 0.0
    attn_impl: str = "xla"
    attn_impl_encoder: Optional[str] = None
    attn_impl_decoder: Optional[str] = None
    attn_impl_cross: Optional[str] = None
    precast_weights: bool = True

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def sd_encoder(self) -> float:
        return (self.stochastic_depth if self.stochastic_depth_encoder is None
                else self.stochastic_depth_encoder)

    @property
    def sd_decoder(self) -> float:
        return (self.stochastic_depth if self.stochastic_depth_decoder is None
                else self.stochastic_depth_decoder)

    @property
    def lora_draws(self) -> bool:
        """Whether a training forward draws LoRA dropout masks."""
        return bool(self.lora_scale and self.lora_dropout > 0.0)

    @property
    def needs_draws(self) -> bool:
        """Whether a training forward draws random numbers."""
        return bool(self.sd_encoder > 0.0 or self.sd_decoder > 0.0 or self.dsa_apply
                    or self.lora_draws)

    @property
    def enc_attn(self) -> str:
        return self.attn_impl_encoder or self.attn_impl

    @property
    def dec_attn(self) -> str:
        return self.attn_impl_decoder or self.attn_impl

    @property
    def cross_attn(self) -> str:
        return self.attn_impl_cross or self.attn_impl

    def check_supported(self, n_audio_layer: Optional[int] = None, decoder: bool = True) -> None:
        """Raise ``ValueError`` for a ``remat_policy`` outside the grammar
        where a block is rematted, as JAX raises the same errors only when it
        traces a rematted block: the encoder's (given its ``n_audio_layer``:
        every block under ``remat_encoder``, the last of more than one under
        ``remat_encoder_last_only``) and, with ``decoder``, the decoder's."""
        enc = n_audio_layer is not None and (
            self.remat_encoder or (self.remat_encoder_last_only and n_audio_layer > 1))
        if enc or (decoder and self.remat_decoder):
            parse_remat_policy(self.remat_policy)


def dsa_layer_flags(fcfg: ForwardConfig, n_layers: int) -> np.ndarray:
    """Boolean per-layer flags for deep SpecAugment, last layer always off."""
    flags = np.zeros((n_layers,), dtype=bool)
    if not fcfg.dsa_apply:
        return flags
    if fcfg.dsa_layer_indices is None:
        flags[: max(n_layers - 1, 0)] = True
        return flags
    for idx in fcfg.dsa_layer_indices:
        if idx >= n_layers:
            raise ValueError(f"deep_spec_augment layer index {idx} out of range")
        if idx == n_layers - 1:
            continue  # the final block is skipped silently
        flags[idx] = True
    return flags


@dataclasses.dataclass(frozen=True)
class ForwardDraws:
    """Every uniform [0, 1) draw of one training forward, float32 on the host.

    A layer is skipped where its coin is below the stochastic-depth rate;
    deep SpecAugment is on where ``dsa_gate`` is below ``dsa_p``; the mask
    pairs are [width, start] draws (see :func:`axis_keep_masks`). With LoRA
    dropout, an adapter's A keeps an input row where its draw is below
    ``1 - lora_dropout``: one draw per input row of each adapted kernel of a
    layer, the kernels in the block's sorted order (:func:`lora_draw_width`
    a layer)."""

    enc_coin: np.ndarray  # (n_audio_layer,)
    dec_coin: np.ndarray  # (n_text_layer,)
    dsa_gate: float
    dsa_time: np.ndarray  # (n_audio_layer, 2)
    dsa_feat: np.ndarray  # (n_audio_layer, 2)
    enc_lora: Optional[np.ndarray] = None  # (n_audio_layer, lora_draw_width)
    dec_lora: Optional[np.ndarray] = None  # (n_text_layer, lora_draw_width)


def lora_draw_width(d: int, cross: bool) -> int:
    """LoRA dropout draws a layer: the input rows of every block linear (q,
    k, v, out and fc1 take d, fc2 takes 4d; the decoder adds cross q, k, v,
    out)."""
    return (13 if cross else 9) * d


def draw_forward(generator: Optional[torch.Generator], dims: ModelDimensions,
                 device, n: int = 1, lora: bool = False) -> List[ForwardDraws]:
    """Draws for ``n`` forwards from ``generator`` (on ``device``): one
    ``torch.rand`` and one transfer to the host for all of them; with
    ``lora``, a second one for the LoRA dropout draws."""
    Le, Ld = dims.n_audio_layer, dims.n_text_layer
    per = 5 * Le + Ld + 1
    u = torch.rand((n, per), generator=generator, device=device).cpu().numpy()
    enc_lora = dec_lora = [None] * n
    if lora:
        we = lora_draw_width(dims.n_audio_state, cross=False)
        wd = lora_draw_width(dims.n_text_state, cross=True)
        v = torch.rand((n, Le * we + Ld * wd), generator=generator, device=device).cpu().numpy()
        enc_lora = [r[:Le * we].reshape(Le, we) for r in v]
        dec_lora = [r[Le * we:].reshape(Ld, wd) for r in v]
    return [
        ForwardDraws(
            enc_coin=r[:Le], dec_coin=r[Le:Le + Ld], dsa_gate=float(r[Le + Ld]),
            dsa_time=r[Le + Ld + 1:3 * Le + Ld + 1].reshape(Le, 2),
            dsa_feat=r[3 * Le + Ld + 1:].reshape(Le, 2),
            enc_lora=el, dec_lora=dl,
        )
        for r, el, dl in zip(u, enc_lora, dec_lora)
    ]


def axis_keep_masks(draws: np.ndarray, size: int, mask_param: int) -> np.ndarray:
    """(L, size) {0, 1} keep-vectors from (L, 2) uniform draws [width, start]:
    width ~ U[0, mask_param), start ~ U[0, size - width), torchaudio's axis
    masking, in float32 like ``_axis_mask``."""
    draws = np.asarray(draws, np.float32)
    width = draws[:, :1] * np.float32(mask_param)
    start = draws[:, 1:2] * (np.float32(size) - width)
    idx = np.arange(size, dtype=np.float32)[None, :]
    masked = (idx >= start) & (idx < start + width)
    return np.where(masked, np.float32(0.0), np.float32(1.0))


# ---------------------------------------------------------------------------
# Parameter tree
# ---------------------------------------------------------------------------

def flatten(tree: Params, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in JAX's flatten order (dict keys sorted)."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.extend(flatten(val, prefix + (key,)))
        else:
            out.append((prefix + (key,), val))
    return out


def _set(tree: Params, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class _Tree(nn.Module):
    """A nested dict of tensors as child modules and parameters."""

    def __init__(self, tree: Params):
        super().__init__()
        for key in sorted(tree):
            val = tree[key]
            if isinstance(val, dict):
                self.add_module(key, _Tree(val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def as_dict(self) -> Params:
        out: Params = dict(self._parameters)
        for name, child in self._modules.items():
            out[name] = child.as_dict()
        return out


class Whisper(nn.Module):
    """The Whisper parameter tree (JAX layout) and its forward."""

    def __init__(self, dims: ModelDimensions, params: Params):
        super().__init__()
        self.dims = dims
        self.tree = _Tree(params)

    def params(self) -> Params:
        """The nested dict of parameters the forward functions take."""
        return self.tree.as_dict()

    def leaves(self) -> List[Tuple[Tuple[str, ...], nn.Parameter]]:
        """(path, parameter) in JAX's flatten order: the optimizer's order."""
        return flatten(self.params())

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor,
                fcfg: ForwardConfig = ForwardConfig(), train: bool = False,
                draws: Optional[ForwardDraws] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return forward_impl(self.params(), mel, tokens, self.dims, fcfg, train,
                            draws, generator)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Sinusoidal position embedding, openai-whisper's recipe."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


def init_params(dims: ModelDimensions, generator: Optional[torch.Generator] = None,
                device="cuda", seed: int = 0) -> Whisper:
    """Random initialization (torch-Linear-style uniform, normal embeddings),
    the distributions of the JAX ``init_params`` drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; one seeded with ``seed`` if None)."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

    def uniform(fan_in: int, shape) -> torch.Tensor:
        bound = 1.0 / np.sqrt(fan_in)
        return torch.empty(shape, dtype=torch.float32, device=dev).uniform_(
            -bound, bound, generator=gen)

    def zeros(*shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def ln(*lead, d) -> Params:
        return {"scale": torch.ones((*lead, d), dtype=torch.float32, device=dev),
                "bias": zeros(*lead, d)}

    def attn(L: int, d: int) -> Params:
        return {
            "q_w": uniform(d, (L, d, d)), "q_b": zeros(L, d),
            "k_w": uniform(d, (L, d, d)),
            "v_w": uniform(d, (L, d, d)), "v_b": zeros(L, d),
            "o_w": uniform(d, (L, d, d)), "o_b": zeros(L, d),
        }

    def blocks(L: int, d: int, cross: bool) -> Params:
        out = {
            "attn": attn(L, d),
            "attn_ln": ln(L, d=d),
            "mlp": {
                "fc1_w": uniform(d, (L, d, 4 * d)), "fc1_b": zeros(L, 4 * d),
                "fc2_w": uniform(4 * d, (L, 4 * d, d)), "fc2_b": zeros(L, d),
            },
            "mlp_ln": ln(L, d=d),
        }
        if cross:
            out["cross_attn"] = attn(L, d)
            out["cross_attn_ln"] = ln(L, d=d)
        return out

    d_a, d_t = dims.n_audio_state, dims.n_text_state
    params = {
        "encoder": {
            "conv1": {"w": uniform(dims.n_mels * 3, (3, dims.n_mels, d_a)), "b": zeros(d_a)},
            "conv2": {"w": uniform(d_a * 3, (3, d_a, d_a)), "b": zeros(d_a)},
            "blocks": blocks(dims.n_audio_layer, d_a, cross=False),
            "ln_post": ln(d=d_a),
        },
        "decoder": {
            "tok_emb": torch.randn((dims.n_vocab, d_t), generator=gen, device=dev) * 0.02,
            "pos_emb": torch.randn((dims.n_text_ctx, d_t), generator=gen, device=dev) * 0.01,
            "blocks": blocks(dims.n_text_layer, d_t, cross=True),
            "ln": ln(d=d_t),
        },
    }
    return Whisper(dims, params)


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5,
               name: Optional[str] = None, time_keep: Optional[torch.Tensor] = None,
               feat_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype, then times the deep
    SpecAugment keep-vectors ``time_keep`` (T,) and ``feat_keep`` (d,) where
    given (in x's dtype); the result is the remat site ``name``. A float32 x
    without keep-vectors is ``F.layer_norm``; every other x goes through
    ``wft::layer_norm`` (:mod:`whisper_finetune_torch.ops.layer_norm`: one
    kernel each way for bf16 on a card, the same composite elsewhere)."""
    w, b = p["scale"].float(), p["bias"].float()
    if x.dtype == torch.float32 and time_keep is None and feat_keep is None:
        return named(name, F.layer_norm, x, (x.shape[-1],), w, b, eps)
    return named(name, layer_norm_op, x, w, b, eps, time_keep, feat_keep)[0]


def _dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           dtype: torch.dtype, name: Optional[str] = None) -> torch.Tensor:
    """x (..., in) @ w (in, out) [+ b] in ``dtype``: one ``mm`` / ``addmm``,
    a ``dots`` site and the remat site ``name``."""
    x2 = x.to(dtype).reshape(-1, x.shape[-1])
    w = w.to(dtype)
    if b is None:
        y = named(name, torch.mm, x2, w, dot=True)
    else:
        y = named(name, torch.addmm, b.to(dtype), x2, w, dot=True)
    return y.view(*x.shape[:-1], w.shape[-1])


def multi_head_attention(x: torch.Tensor, kv: torch.Tensor, p: Params, n_head: int,
                         dtype: torch.dtype, causal: bool = False,
                         impl: str = "xla", probs_name: str = "attn_probs",
                         site: str = "enc") -> torch.Tensor:
    """Whisper MHA: q/k/v projections, attention with sm_scale = d_head**-0.5
    (``impl`` picks the plain path or the kernels), output projection. The
    projections are the remat sites ``{site}_qkv``, or ``cross_q`` and
    ``cross_kv`` for ``site="cross"``; ``probs_name`` names the plain path's
    probabilities."""
    B, T, d = x.shape
    S = kv.shape[1]
    d_head = d // n_head
    q_name, kv_name = ("cross_q", "cross_kv") if site == "cross" else (f"{site}_qkv",) * 2
    q = _dense(x, p["q_w"], p["q_b"], dtype, q_name).view(B, T, n_head, d_head)
    k = _dense(kv, p["k_w"], None, dtype, kv_name).view(B, S, n_head, d_head)
    v = _dense(kv, p["v_w"], p["v_b"], dtype, kv_name).view(B, S, n_head, d_head)
    o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=causal, sm_scale=float(d_head) ** -0.5, impl=impl,
                  probs_name=probs_name)
    o = o.transpose(1, 2).reshape(B, T, d).to(dtype)
    return _dense(o, p["o_w"], p["o_b"], dtype)


def _mlp(x: torch.Tensor, p: Params, dtype: torch.dtype, site: str = "enc") -> torch.Tensor:
    # fc1's output (the GELU input) is the remat site {site}_mlp_h
    h = F.gelu(_dense(x, p["fc1_w"], p["fc1_b"], dtype, f"{site}_mlp_h"))  # exact erf GELU
    return _dense(h, p["fc2_w"], p["fc2_b"], dtype)


def _with_lora(bp: Params, fcfg: ForwardConfig, lora_keep: Optional[torch.Tensor]) -> Params:
    """The layer's kernels with its adapters folded in (float32, inside the
    checkpointed block), where the forward runs LoRA."""
    if not fcfg.lora_scale:
        return bp
    from whisper_finetune_torch.models.lora import materialize_block_lora

    return materialize_block_lora(bp, fcfg.lora_scale, fcfg.lora_dropout, lora_keep)


def _encoder_block(x: torch.Tensor, bp: Params, fcfg: ForwardConfig, n_head: int,
                   time_keep: Optional[torch.Tensor] = None,
                   feat_keep: Optional[torch.Tensor] = None,
                   lora_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``time_keep`` (T,) and ``feat_keep`` (d,) are this layer's deep
    SpecAugment keep-vectors (batch-shared), None where it is off;
    ``lora_keep`` its LoRA dropout keep-vector, None without dropout."""
    with span("wft.enc_block"):
        dtype = fcfg.dtype
        bp = _with_lora(bp, fcfg, lora_keep)
        x_ln = layer_norm(x, bp["attn_ln"], name="enc_ln1", time_keep=time_keep,
                          feat_keep=feat_keep)
        x = x + multi_head_attention(x_ln, x_ln, bp["attn"], n_head, dtype,
                                     impl=fcfg.enc_attn, site="enc")
        x_ln2 = layer_norm(x, bp["mlp_ln"], name="enc_ln2")
        return x + _mlp(x_ln2, bp["mlp"], dtype, site="enc")


def _decoder_block(x: torch.Tensor, bp: Params, xa: torch.Tensor,
                   fcfg: ForwardConfig, n_head: int,
                   lora_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    with span("wft.dec_block"):
        dtype = fcfg.dtype
        bp = _with_lora(bp, fcfg, lora_keep)
        x_ln = layer_norm(x, bp["attn_ln"], name="dec_ln1")
        x = x + multi_head_attention(x_ln, x_ln, bp["attn"], n_head, dtype,
                                     causal=True, impl=fcfg.dec_attn, site="dec")
        x_lnc = layer_norm(x, bp["cross_attn_ln"], name="dec_ln_cross")
        x = x + multi_head_attention(x_lnc, xa, bp["cross_attn"], n_head, dtype,
                                     impl=fcfg.cross_attn, probs_name="cross_attn_probs",
                                     site="cross")
        x_ln2 = layer_norm(x, bp["mlp_ln"], name="dec_ln2")
        return x + _mlp(x_ln2, bp["mlp"], dtype, site="dec")


def _layer_views(blocks: Params, n_layers: int, dtype: torch.dtype,
                 precast: bool = True) -> List[Params]:
    """Per-layer dicts from the stacked tree: one ``unbind(0)`` per leaf.
    With ``precast`` the stacked (L, in, out) matrices are first cast to the
    compute dtype once (the counterpart of ``_cast_blocks_once``); without
    it they stay float32 and ``_dense`` casts each slice at use
    (``_cast_block_slice``). 1-D-per-layer leaves stay float32 and are cast
    at use either way, as in JAX."""
    layers: List[Params] = [{} for _ in range(n_layers)]
    for path, a in flatten(blocks):
        if precast and dtype != torch.float32 and a.dtype == torch.float32 and a.dim() >= 3:
            a = a.to(dtype)
        for i, view in enumerate(a.unbind(0)):
            _set(layers[i], path, view)
    return layers


def _precast(fcfg: ForwardConfig) -> bool:
    """Whether the stacked matrices are cast once before the layer loop: not
    in a LoRA forward, whose adapters fold into float32 kernels
    (``_cast_blocks_once`` skips LoRA runs too)."""
    return fcfg.precast_weights and not fcfg.lora_scale


def _stochastic(block, keep_prob: float):
    """``block`` with stochastic depth's rescale for a kept layer:
    ``x + (block(x) - x) / keep_prob``. The divisor is a tensor in x's dtype,
    the value JAX's weakly typed scalar takes."""
    if keep_prob >= 1.0:
        return block

    def kept(x, *args):
        out = block(x, *args)
        return x + (out - x) / torch.full((), keep_prob, dtype=x.dtype, device=x.device)

    return kept


def _remat(fcfg: ForwardConfig):
    """``run(fn, remat, *args)``: ``fn(*args)``, checkpointed under the
    config's ``remat_policy`` where ``remat`` and gradients are on."""
    kwargs = None  # the policy is read at the first rematted block

    def run(fn, remat: bool, *args):
        nonlocal kwargs
        if remat and torch.is_grad_enabled():
            if kwargs is None:
                policy = parse_remat_policy(fcfg.remat_policy)
                kwargs = {} if policy.is_full else {"context_fn": policy.contexts}
            # Every random value a block uses is drawn outside it and passed
            # in, so no RNG state is stashed for the recompute.
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                              **kwargs)
        return fn(*args)

    return run


def _lora_keep(fcfg: ForwardConfig, draws: Optional["ForwardDraws"], u_name: str,
               device) -> Optional[torch.Tensor]:
    """(L, width) {0, 1} LoRA dropout keep-rows from the draws, or None."""
    u = getattr(draws, u_name) if draws is not None and fcfg.lora_draws else None
    if u is None:
        return None
    keep = np.asarray(u, np.float32) < np.float32(1.0 - fcfg.lora_dropout)
    return torch.from_numpy(keep.astype(np.float32)).to(device)


def _kept(coins: Optional[np.ndarray], p: float, n_layers: int) -> List[bool]:
    """Which layers run: all of them without stochastic depth, else those
    whose coin is not below the drop rate ``p``."""
    if coins is None or p <= 0.0:
        return [True] * n_layers
    return [not bool(c < np.float32(p)) for c in coins]


def dsa_masks(fcfg: ForwardConfig, draws: Optional[ForwardDraws], n_layers: int,
              x: torch.Tensor):
    """Deep SpecAugment of an encoder forward over x (B, T, d): (per-layer
    on-flags, (L, T) time and (L, d) feature keep-vectors in x's dtype, or
    None where no layer is on)."""
    gate = draws is not None and draws.dsa_gate < np.float32(fcfg.dsa_p)
    dsa_on = dsa_layer_flags(fcfg, n_layers) & bool(gate)
    if not dsa_on.any():
        return dsa_on, None, None
    time_keep = torch.from_numpy(axis_keep_masks(
        draws.dsa_time, x.shape[1], fcfg.dsa_time_mask_param)).to(x.device, x.dtype)
    feat_keep = torch.from_numpy(axis_keep_masks(
        draws.dsa_feat, x.shape[2], fcfg.dsa_freq_mask_param)).to(x.device, x.dtype)
    return dsa_on, time_keep, feat_keep


# ---------------------------------------------------------------------------
# Shared forward segments
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _sinusoids_cached(length: int, channels: int) -> np.ndarray:
    return sinusoids(length, channels)


def conv_stem(enc: Params, mel: torch.Tensor, dims: ModelDimensions,
              dtype: torch.dtype) -> torch.Tensor:
    """Conv1 -> GELU -> conv2 (stride 2) -> GELU -> + sinusoidal positions.
    mel (B, n_mels, 3000) -> (B, n_audio_ctx, d) in the compute dtype,
    contiguous: the convolution leaves (B, d, T) in memory, and the encoder's
    residual stream, its elementwise kernels and every layer norm read rows.
    The (width, in, out) kernels are laid out for ``conv1d`` here."""
    x = mel.to(dtype)
    w1 = enc["conv1"]["w"].to(dtype).permute(2, 1, 0)
    x = F.gelu(F.conv1d(x, w1, padding=1) + enc["conv1"]["b"].to(dtype)[:, None])
    w2 = enc["conv2"]["w"].to(dtype).permute(2, 1, 0)
    x = F.gelu(F.conv1d(x, w2, stride=2, padding=1) + enc["conv2"]["b"].to(dtype)[:, None])
    x = x.transpose(1, 2)
    pos = torch.from_numpy(_sinusoids_cached(dims.n_audio_ctx, dims.n_audio_state))
    pos = pos.to(device=x.device, dtype=dtype)
    return (x + pos[None, : x.shape[1]]).to(dtype).contiguous()


def decoder_embed(dec: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token + learned positional embedding -> (B, T, d) in the compute dtype."""
    T = tokens.shape[-1]
    return (F.embedding(tokens, dec["tok_emb"]) + dec["pos_emb"][:T]).to(dtype)


# ---------------------------------------------------------------------------
# Encoder / decoder forwards
# ---------------------------------------------------------------------------

def _training_draws(fcfg: ForwardConfig, dims: ModelDimensions, train: bool,
                    draws: Optional[ForwardDraws], generator, device
                    ) -> Optional[ForwardDraws]:
    if not (train and fcfg.needs_draws):
        return None
    if draws is not None:
        return draws
    return draw_forward(generator, dims, device, lora=fcfg.lora_draws)[0]


def encoder_forward(params: Params, mel: torch.Tensor, dims: ModelDimensions,
                    fcfg: ForwardConfig, train: bool = False,
                    draws: Optional[ForwardDraws] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """mel (B, n_mels, 3000) -> audio features (B, n_audio_ctx, d), float32.
    A training forward with stochastic depth or deep SpecAugment takes its
    random numbers from ``draws``, or draws them from ``generator``."""
    fcfg.check_supported(dims.n_audio_layer, decoder=False)
    enc = params["encoder"]
    dtype, L = fcfg.dtype, dims.n_audio_layer
    with span("wft.encoder"):
        x = conv_stem(enc, mel, dims, dtype)
        draws = _training_draws(fcfg, dims, train, draws, generator, x.device)

        kept = _kept(draws.enc_coin if draws else None, fcfg.sd_encoder, L)
        dsa_on, time_keep, feat_keep = dsa_masks(fcfg, draws, L, x)
        lora_keep = _lora_keep(fcfg, draws, "enc_lora", x.device)
        block = _stochastic(_encoder_block, 1.0 - fcfg.sd_encoder if draws else 1.0)
        run = _remat(fcfg)

        last_only = fcfg.remat_encoder_last_only and not fcfg.remat_encoder and L > 1
        views = _layer_views(enc["blocks"], L, dtype, _precast(fcfg))
        for i, bp in enumerate(views):
            if not kept[i]:
                continue
            encoder_forward.blocks_run += 1
            masks = (time_keep[i], feat_keep[i]) if dsa_on[i] else (None, None)
            remat = fcfg.remat_encoder or (last_only and i == L - 1)
            x = run(block, remat, x, bp, fcfg, dims.n_audio_head, *masks,
                    None if lora_keep is None else lora_keep[i])
        return layer_norm(x, enc["ln_post"]).float()


def decoder_forward(params: Params, tokens: torch.Tensor, xa: torch.Tensor,
                    dims: ModelDimensions, fcfg: ForwardConfig,
                    train: bool = False, draws: Optional[ForwardDraws] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """tokens (B, T) int, xa (B, S, d) -> logits (B, T, n_vocab) float32."""
    fcfg.check_supported()
    dec = params["decoder"]
    dtype, L = fcfg.dtype, dims.n_text_layer
    with span("wft.decoder"):
        x = decoder_embed(dec, tokens, dtype)
        xa = xa.to(dtype)
        draws = _training_draws(fcfg, dims, train, draws, generator, x.device)
        kept = _kept(draws.dec_coin if draws else None, fcfg.sd_decoder, L)
        lora_keep = _lora_keep(fcfg, draws, "dec_lora", x.device)
        block = _stochastic(_decoder_block, 1.0 - fcfg.sd_decoder if draws else 1.0)
        run = _remat(fcfg)
        for i, bp in enumerate(_layer_views(dec["blocks"], L, dtype, _precast(fcfg))):
            if not kept[i]:
                continue
            decoder_forward.blocks_run += 1
            x = run(block, fcfg.remat_decoder, x, bp, xa, fcfg, dims.n_text_head,
                    None if lora_keep is None else lora_keep[i])
    with span("wft.loss"):  # the logits are the loss's input
        return decoder_head(dec, x, dtype)


def decoder_head(dec: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Final layer norm and the tied output embedding: logits stored in the
    compute dtype, upcast for the loss."""
    x = layer_norm(x, dec["ln"])
    return torch.matmul(x.to(dtype), dec["tok_emb"].to(dtype).t()).float()


# Blocks run by the layer loops (a layer dropped by stochastic depth is not
# counted; a remat recompute is not counted either): with the kernels'
# ``.launches`` they say how many launches a run must have made.
encoder_forward.blocks_run = 0
decoder_forward.blocks_run = 0


def forward_impl(params: Params, mel: torch.Tensor, tokens: torch.Tensor,
                 dims: ModelDimensions, fcfg: ForwardConfig,
                 train: bool = False, draws: Optional[ForwardDraws] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Teacher-forced forward: (mel, decoder tokens) -> float32 logits."""
    draws = _training_draws(fcfg, dims, train, draws, generator, mel.device)
    xa = encoder_forward(params, mel, dims, fcfg, train, draws)
    return decoder_forward(params, tokens, xa, dims, fcfg, train, draws)
