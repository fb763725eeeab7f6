"""Attention for the transformer, the port of ``whisper_finetune_tpu/ops/attention.py``.

Four implementations, picked per call site by :func:`attention`:

* ``"xla"``: :func:`xla_mha`, the reference-faithful plain path. q and k are
  each scaled by ``sm_scale**0.5``, the scores are stored in the compute
  dtype, the softmax runs in float32 and the probabilities are cast back.
* ``"splash"``: :func:`splash_mha`, the port of the TPU's splash-attention
  kernels (``ops/attention.py:236 splash_mha``, built by ``_splash_kernel``,
  variant ``fused_bwd``).
* ``"flash"``: :func:`flash_mha`, the port of the TPU's flash-attention
  kernels (``ops/attention.py:53 flash_mha``: the library's forward, dK/dV
  and dQ ``pallas_call``s).
* ``"flash_fwd"``: :func:`flash_fwd_xla_bwd` (``ops/attention.py:290``): the
  flash forward without its row statistics, and a backward that
  differentiates :func:`xla_mha` on the saved q, k, v.

The TPU's splash and flash kernels compute one function, so here they are
one ``torch.autograd.Function`` over the two kernel wrappers of
``csrc/attention.cu``:

  - ``attn_fwd``: flash-style forward, one warpgroup per (batch*head,
    64-row q-tile) and three blocks an SM, online softmax in float32, writes
    O (bf16) and, unless the caller asks for none, the per-row log-sum-exp
    (float32). TMA brings Q once and K and V in tiles of 128 keys, one tile
    ahead; Q stays in registers as the A operand of S = QK^T, and S and
    O += PV are ``wgmma`` products with the softmax in the accumulator
    registers between them. At D = 64 the forward does one ``exp2`` for
    every 256 tensor FLOP, and the special-function unit's 16 a clock an SM
    make the exponentials as long as the products; the three blocks of an
    SM overlap one another's softmax and products.
  - ``attn_bwd``: the whole backward, (dq, dk, dv) from (q, k, v, o, do,
    lse), what splash's ``fused_bwd`` and flash's dK/dV + dQ kernels compute.
    Three launches on one stream: the row statistics (``lse * log2(e)`` and
    ``delta = rowsum(dO * O)``) with the zeroing of a float32 dQ accumulator;
    the fused kernel, one warpgroup per (batch*head, 64-key tile) and three
    blocks an SM, that keeps K and V in shared memory, streams (Q, dO, lse,
    delta) tiles through a ring of ``cp.async`` stages one tile ahead of the
    products, builds S and dP once per tile pair by ``wgmma``, keeps dK and
    dV in registers and adds each tile's share of dQ to the accumulator with
    one bulk float32 reduction from shared memory; and the conversion of the
    accumulator to bf16 dq. dK and dV are deterministic; dQ is summed over
    key tiles in the order the hardware picks, so two runs may differ in the
    last float32 bits before the rounding to bf16.

  What bounds them on an H100 depends on the shape. With
  F = B*H*Tq*Tk*64 (under a causal mask only the tiles at or below the
  diagonal, the rest are skipped) the forward does 4F FLOP and the backward
  10F against 989 TFLOP/s bf16; the bytes are q, k, v, o, do and the
  gradients once each against 3.35 TB/s. At the encoder's 1500 x 1500 and
  the cross-attention's 448 x 1500 (batch 8, 20 heads) the operations are
  the larger time, the bytes a quarter to a half of it; at the decoder's
  causal 448 x 448 the bytes are the bound, by a factor of two. Nothing of
  size Tq*Tk touches device memory: every score tile lives in registers.
  Tq and Tk are masked inside the kernels, so 1500 and 448 need no padding
  to 128 and there are no garbage rows (splash pads and points padded query
  rows at key 0; flash pads and masks by segment ids).

  The wrappers take q unscaled and hand ``sm_scale`` to the kernels, which
  apply it to the float32 scores: flash's own arithmetic, and the same
  number as splash's pre-scaled q (0.125 is exact in bf16).

Each kernel wrapper has its plain twin here (``*_plain``: the kernels' math
in float32, outputs in the input dtype). A wrapper takes its twin only for a
CPU tensor; for a CUDA tensor it launches its kernel or raises. Each counts
its launches (``.launches``) and, of them, those under a causal mask
(``.causal_launches``); a twin call counts nothing.

``attn_impl: auto`` (:func:`resolve_auto_impls`) sends all three of
Whisper's attention sites through the kernels on a card: the encoder's
self-attention, the cross-attention and the decoder's causal
self-attention. The JAX package's mix leaves the causal site on the plain
path, which on the TPU was the faster there; the function is the same, and
on an H100 the kernels win at every decoder length from 16 to 448 (at
32 x 20 x 448 x 448, forward and backward 0.49 ms against the plain path's
4.22 ms): the plain path writes and reads back the float32 T x T scores,
mask and probabilities that the kernels keep in registers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from whisper_finetune_torch.ops.remat import named
from whisper_finetune_torch.runtime import span

HEAD_DIM = 64  # the kernels' head width (every Whisper preset uses 64)


# ---------------------------------------------------------------------------
# Plain paths
# ---------------------------------------------------------------------------

def xla_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = False, sm_scale: float = 1.0,
            probs_name: str = "attn_probs") -> torch.Tensor:
    """q (B, H, Tq, D), k/v (B, H, Tk, D) -> (B, H, Tq, D): scores in the
    compute dtype (float32 accumulation), softmax in float32, probabilities
    cast back: the remat site ``probs_name`` (``attn_probs`` or
    ``cross_attn_probs``, per call site)."""
    dtype = q.dtype
    Tq, Tk = q.shape[2], k.shape[2]
    scale = sm_scale ** 0.5
    qk = torch.matmul(q * scale, (k * scale).transpose(-1, -2)).float()
    if causal:
        qk = qk + torch.full((Tq, Tk), float("-inf"), device=q.device).triu(1)
    if dtype == torch.float32:
        w = named(probs_name, torch.softmax, qk, -1)
    else:
        w = named(probs_name, torch.softmax(qk, dim=-1).to, dtype)
    return torch.matmul(w, v)


def _scores(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """float32 scaled scores, causal positions (key > query) at -inf."""
    s = torch.matmul(q.float() * sm_scale, k.float().transpose(-1, -2))
    if causal:
        Tq, Tk = s.shape[-2:]
        keep = torch.ones((Tq, Tk), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def attn_fwd_plain(q, k, v, causal: bool, sm_scale: float):
    """Plain twin of ``attn_fwd``: (o in q's dtype, lse (B, H, Tq) float32)."""
    s = _scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    return o.to(q.dtype), lse


def attn_fwd_nolse_plain(q, k, v, causal: bool, sm_scale: float) -> torch.Tensor:
    """Plain twin of ``attn_fwd(..., with_lse=False)``: o only, as a plain
    float32 softmax."""
    p = torch.softmax(_scores(q, k, causal, sm_scale), dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def attn_bwd_plain(q, k, v, o, do, lse, causal: bool, sm_scale: float):
    """Plain twin of ``attn_bwd``: (dq in q's dtype, dk and dv in k's), the
    kernel's math in float32 with P rebuilt from the saved log-sum-exp."""
    delta = (do.float() * o.float()).sum(-1)
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, k.float()) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * sm_scale
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries of a library built from ``csrc/attention.cu``."""
    if not getattr(lib, "_wft_bound", False):
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        dims = [I, I, I, I, L, L, L, L, L, L, F, I, P]
        lib.wft_attn_fwd.argtypes = [P] * 5 + dims
        lib.wft_attn_bwd.argtypes = [P] * 11 + dims
        lib.wft_attn_fwd_occupancy.argtypes = [I, P, P]
        for fn in (lib.wft_attn_fwd, lib.wft_attn_bwd, lib.wft_attn_fwd_occupancy):
            fn.restype = I
        lib._wft_bound = True
    return lib


def _lib():
    from whisper_finetune_torch._build import libraries

    return bind(libraries()["attention"])


def _kernel_ready(x: torch.Tensor) -> bool:
    """The kernels read 16-byte rows: head dim contiguous, every other
    stride a multiple of 8 elements, base 16-byte aligned."""
    return (
        x.stride(-1) == 1
        and all(s % 8 == 0 for s in x.stride()[:-1])
        and x.data_ptr() % 16 == 0
    )


def _as_layout(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """x with ref's strides (a copy only where they differ)."""
    if x.stride() == ref.stride():
        return x
    out = torch.empty_like(ref)
    out.copy_(x)
    return out


def _check_inputs(q, k, v) -> None:
    """Raise on what the kernels do not take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
        if x.dim() != 4 or x.shape[-1] != HEAD_DIM:
            raise ValueError(f"{name} must be (B, H, T, {HEAD_DIM}), got {tuple(x.shape)}")
    if q.shape[:2] != k.shape[:2] or k.shape != v.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")


def _layout(q, k, v):
    """q, k, v in the layouts the kernels take: q (and o, do) one stride
    set, k and v another (copies only where a tensor does not comply)."""
    if not _kernel_ready(q):
        q = q.contiguous()
    if not _kernel_ready(k):
        k = k.contiguous()
    v = _as_layout(v, k)
    if not _kernel_ready(v):
        k, v = k.contiguous(), v.contiguous()
    return q, k, v


def _prep(q, k, v):
    """Check the inputs of a kernel launch and lay them out."""
    _check_inputs(q, k, v)
    return _layout(q, k, v)


def _bwd_layout(q, k, v, o, do):
    """The backward's five inputs, each laid out once: o and do (in bf16)
    take q's strides."""
    q, k, v = _layout(q, k, v)
    return q, k, v, _as_layout(o, q), _as_layout(do.to(torch.bfloat16), q)


def _dims(q, k, sm_scale, causal):
    B, H, Tq, _ = q.shape
    Tk = k.shape[2]
    return [B, H, Tq, Tk, *q.stride()[:3], *k.stride()[:3],
            float(sm_scale), int(bool(causal))]


def attn_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, sm_scale: float, with_lse: bool = True
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Forward kernel: -> (o (B, H, Tq, 64) bf16 with q's strides,
    lse (B, H, Tq) float32). With ``with_lse=False`` the kernel instance
    that writes no log-sum-exp runs and lse is None."""
    if q.device.type == "cpu":
        if with_lse:
            return attn_fwd_plain(q, k, v, causal, sm_scale)
        return attn_fwd_nolse_plain(q, k, v, causal, sm_scale), None
    from whisper_finetune_torch._build import check, stream_ptr

    q, k, v = _prep(q, k, v)
    B, H, Tq, _ = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    rc = lib.wft_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), lse.data_ptr() if with_lse else None,
                          *_dims(q, k, sm_scale, causal), stream_ptr())
    check(lib, rc, "attn_fwd")
    attn_fwd.launches += 1
    attn_fwd.causal_launches += bool(causal)
    return o, lse


attn_fwd.launches = 0
attn_fwd.causal_launches = 0


def attn_fwd_occupancy(with_lse: bool = True) -> dict:
    """The forward's blocks an SM by the occupancy calculator, and the
    dynamic shared memory a block takes (the card's current device)."""
    from whisper_finetune_torch._build import check

    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    lib = _lib()
    check(lib, lib.wft_attn_fwd_occupancy(int(with_lse), ctypes.addressof(blocks),
                                          ctypes.addressof(smem)), "attn_fwd_occupancy")
    return {"blocks_per_sm": blocks.value, "smem_bytes": smem.value}


def attn_bwd(q, k, v, o, do, lse, causal: bool, sm_scale: float):
    """Backward kernels: -> (dq with q's strides, dk and dv with k's), all
    bf16. One C call launches the three kernels on the current stream; the
    float32 scratch (the row statistics (2, B, H, Tq): lse * log2(e) and
    delta = rowsum(dO * O); the dQ accumulator (B, H, Tq, 64))
    is allocated here and freed on return."""
    if q.device.type == "cpu":
        return attn_bwd_plain(q, k, v, o, do, lse, causal, sm_scale)
    from whisper_finetune_torch._build import check, stream_ptr

    _check_inputs(q, k, v)
    q, k, v, o, do = _bwd_layout(q, k, v, o, do)
    B, H, Tq, _ = q.shape
    stats = torch.empty((2, B, H, Tq), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((B, H, Tq, HEAD_DIM), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(k)
    lib = _lib()
    rc = lib.wft_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), stats.data_ptr(),
                          dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          *_dims(q, k, sm_scale, causal), stream_ptr())
    check(lib, rc, "attn_bwd")
    attn_bwd.launches += 1
    attn_bwd.causal_launches += bool(causal)
    return dq, dk, dv


attn_bwd.launches = 0
attn_bwd.causal_launches = 0


class _KernelAttention(torch.autograd.Function):
    """Forward and backward are the kernels (their plain twins on the CPU);
    saves q, k, v, o and the (B, H, Tq) log-sum-exp. Each kernel wrapper
    lays out its own inputs once; the model's q, k, v views already have the
    kernels' layout, so nothing is copied."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = attn_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        with span("wft.attn"):
            q, k, v, o, lse = ctx.saved_tensors
            dq, dk, dv = attn_bwd(q, k, v, o, do, lse, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


class _KernelForwardPlainBackward(torch.autograd.Function):
    """The forward kernel without its log-sum-exp; saves only q, k, v, and
    the backward is autograd's gradient of :func:`xla_mha` on them
    (``_ffxb_bwd``). The two directions scale differently, as in JAX: the
    forward scales the float32 scores by ``sm_scale``, the backward's
    ``xla_mha`` scales q and k by ``sm_scale**0.5`` each in their dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, _ = attn_fwd(q, k, v, causal, sm_scale, with_lse=False)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        with span("wft.attn"):
            q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
            with torch.enable_grad():
                o = xla_mha(q, k, v, causal=ctx.causal, sm_scale=ctx.sm_scale)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), do.to(o.dtype))
        return dq, dk, dv, None, None


def _check_device(name: str, q: torch.Tensor) -> None:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")


def splash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = False, sm_scale: float = 1.0) -> torch.Tensor:
    """q (B, H, Tq, 64), k/v (B, H, Tk, 64) -> (B, H, Tq, 64). CUDA: the
    kernels (bf16 only). CPU: their plain twins, any float dtype."""
    _check_device("splash_mha", q)
    return _KernelAttention.apply(q, k, v, causal, sm_scale)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, sm_scale: float = 1.0) -> torch.Tensor:
    """The flash route: the same kernels and shapes as :func:`splash_mha`,
    forward and backward (the TPU's two kernel families compute one
    function; see the module docstring)."""
    _check_device("flash_mha", q)
    return _KernelAttention.apply(q, k, v, causal, sm_scale)


def flash_fwd_xla_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = False, sm_scale: float = 1.0) -> torch.Tensor:
    """The forward kernel (no log-sum-exp written) with :func:`xla_mha`'s
    gradients: no backward kernel launches on this route."""
    _check_device("flash_fwd_xla_bwd", q)
    return _KernelForwardPlainBackward.apply(q, k, v, causal, sm_scale)


KERNELS = (attn_fwd, attn_bwd)  # each carries .launches and .causal_launches counts


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def resolve_auto_impls(device) -> dict:
    """ForwardConfig attention fields for ``attn_impl: auto``: on CUDA the
    kernels serve all three sites, the encoder self-attention, the decoder's
    causal self-attention and the cross-attention; elsewhere everything is
    plain. The JAX package keeps the causal site plain, its faster choice on
    the TPU; on an H100 the kernels are the faster there too (the module
    docstring; PERF.md has the card's times), and compute the same
    function."""
    if torch.device(device).type == "cuda":
        return {
            "attn_impl": "xla",
            "attn_impl_encoder": "splash",
            "attn_impl_decoder": "splash",
            "attn_impl_cross": "splash",
        }
    return {"attn_impl": "xla"}


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, sm_scale: float = 1.0,
              impl: str = "xla", probs_name: str = "attn_probs") -> torch.Tensor:
    """``probs_name``: the remat site of the plain path's probabilities (the
    kernels never materialise them). Every implementation runs inside the
    span ``wft.attn``, as do the kernels' backwards."""
    with span("wft.attn"):
        if impl == "xla":
            return xla_mha(q, k, v, causal=causal, sm_scale=sm_scale, probs_name=probs_name)
        if impl == "splash":
            return splash_mha(q, k, v, causal=causal, sm_scale=sm_scale)
        if impl == "flash":
            return flash_mha(q, k, v, causal=causal, sm_scale=sm_scale)
        if impl == "flash_fwd":
            return flash_fwd_xla_bwd(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"Unknown attention impl: {impl}")
