"""Layer norm over the last axis with bf16 in and out and float32 statistics,
and deep SpecAugment's keep-vectors applied to its output.

The math is the model's composite: x cast to float32, ``F.layer_norm`` with
float32 gamma and beta, one rounding to x's dtype, then ``y *
time_keep[:, None]`` and ``* feat_keep`` in that dtype (keep-vectors of 0
and 1, so exact). This module holds that rule for every dtype.

:func:`layer_norm_op` is one dispatcher op, ``wft::layer_norm`` (a
``torch.library`` custom op with its autograd), returning ``(y, mean,
rstd)``: one op is what ``ops/remat.py::named`` needs of a remat site.
Its forward is :func:`layer_norm_fwd`, its backward :func:`layer_norm_bwd`.
On a CUDA bf16 tensor each launches ``csrc/layer_norm.cu`` (one kernel
forward; one pass of two kernels backward), or raises where the width is
not a multiple of 8 up to 2048. On any other tensor (the CPU, or a float32
or float16 one) each takes its plain version (:func:`layer_norm_fwd_plain`,
:func:`layer_norm_bwd_plain`), which is the composite and its autograd bit
for bit. The backward saves x in its own dtype and the float32 mean and
rstd a row, not a float32 copy of x.
"""

import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

# The device kernels of csrc/layer_norm.cu, by the names a profile shows.
KERNEL_NAMES = ("wft_layer_norm_fwd", "wft_layer_norm_bwd", "wft_layer_norm_bwd_sum")
MAX_WIDTH = 2048


def _apply_keep(y: Tensor, time_keep: Optional[Tensor], feat_keep: Optional[Tensor]) -> Tensor:
    """y (..., T, d) times time_keep (T,) by row, then feat_keep (d,) by
    column, each a multiply in y's dtype (the composite's order)."""
    if time_keep is not None:
        y = y * time_keep[:, None]
    if feat_keep is not None:
        y = y * feat_keep
    return y


def layer_norm_fwd_plain(x: Tensor, weight: Tensor, bias: Tensor, eps: float,
                         time_keep: Optional[Tensor] = None,
                         feat_keep: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """The composite: -> (y in x's dtype, mean (rows,), rstd (rows,)) float32."""
    y, mean, rstd = torch.native_layer_norm(x.float(), (x.shape[-1],), weight, bias, eps)
    return _apply_keep(y.to(x.dtype), time_keep, feat_keep), mean.view(-1), rstd.view(-1)


def layer_norm_bwd_plain(dy: Tensor, x: Tensor, mean: Tensor, rstd: Tensor, weight: Tensor,
                         bias: Tensor, time_keep: Optional[Tensor] = None,
                         feat_keep: Optional[Tensor] = None
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """The composite's autograd: -> (dx in x's dtype, dgamma, dbeta float32)."""
    if feat_keep is not None:
        dy = dy * feat_keep
    if time_keep is not None:
        dy = dy * time_keep[:, None]
    stat = x.shape[:-1] + (1,)
    dx, dw, db = torch.ops.aten.native_layer_norm_backward(
        dy.float(), x.float(), (x.shape[-1],), mean.view(stat), rstd.view(stat), weight,
        bias, [True, True, True])
    return dx.to(x.dtype), dw, db


def _lib():
    from whisper_finetune_torch._build import libraries

    lib = libraries()["layer_norm"]
    if not getattr(lib, "_wft_bound", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.wft_layer_norm_fwd_launch.argtypes = [P] * 8 + [L, I, I, ctypes.c_float, P]
        lib.wft_layer_norm_bwd_blocks.argtypes = [I, P]
        lib.wft_layer_norm_bwd_launch.argtypes = [P] * 11 + [L, I, I, I, P]
        for fn in (lib.wft_layer_norm_fwd_launch, lib.wft_layer_norm_bwd_blocks,
                   lib.wft_layer_norm_bwd_launch):
            fn.restype = I
        lib._wft_bound = True
    return lib


def _rows(x: Tensor, what: str) -> Tensor:
    """x as the kernels read it: bf16 on a card, contiguous, 16-byte
    aligned, a width they take."""
    d = x.shape[-1]
    if not x.is_cuda or x.dtype != torch.bfloat16:
        raise ValueError(f"{what} must be a CUDA bfloat16 tensor, got {x.dtype} on {x.device}")
    if d % 8 or not 8 <= d <= MAX_WIDTH:
        raise ValueError(f"{what}: width {d} is not a multiple of 8 from 8 to {MAX_WIDTH}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")
    return x


def _vector(v: Optional[Tensor], like: Tensor, n: int, dtype: torch.dtype, what: str,
            wide: bool = True):
    """A (n,) vector the kernels read, contiguous, or None; 16-byte aligned
    where they read it 16 bytes at a time (``wide``: gamma, beta,
    feat_keep)."""
    if v is None:
        return None
    if v.device != like.device or v.dtype != dtype or tuple(v.shape) != (n,):
        raise ValueError(f"{what} must be {dtype} ({n},) on {like.device}, "
                         f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    v = v.contiguous()
    if wide and v.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")
    return v


def _keep_args(x: Tensor, time_keep, feat_keep):
    d = x.shape[-1]
    t = 1
    if time_keep is not None:
        if x.dim() < 2 or x.shape[-2] != time_keep.numel():
            raise ValueError(f"time_keep {tuple(time_keep.shape)} does not match "
                             f"x {tuple(x.shape)}")
        t = x.shape[-2]
    tk = _vector(time_keep, x, t, x.dtype, "time_keep", wide=False)
    fk = _vector(feat_keep, x, d, x.dtype, "feat_keep")
    return tk, fk, t


def _ptr(v: Optional[Tensor]):
    return None if v is None else v.data_ptr()


def layer_norm_fwd(x: Tensor, weight: Tensor, bias: Tensor, eps: float,
                   time_keep: Optional[Tensor] = None, feat_keep: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (y like x, mean, rstd (rows,) float32). weight, bias (d,) float32;
    time_keep (T,) for x (..., T, d) and feat_keep (d,) in x's dtype, or
    None. One kernel launch for a CUDA bf16 x, the plain version else."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        return layer_norm_fwd_plain(x, weight, bias, eps, time_keep, feat_keep)
    from whisper_finetune_torch._build import check, stream_ptr

    x = _rows(x, "layer_norm x")
    d = x.shape[-1]
    w = _vector(weight, x, d, torch.float32, "layer_norm weight")
    b = _vector(bias, x, d, torch.float32, "layer_norm bias")
    tk, fk, t = _keep_args(x, time_keep, feat_keep)
    n = x.numel() // d
    y = torch.empty_like(x)
    mean = torch.empty((n,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    lib = _lib()
    rc = lib.wft_layer_norm_fwd_launch(x.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(tk),
                                       _ptr(fk), y.data_ptr(), mean.data_ptr(),
                                       rstd.data_ptr(), n, d, t, float(eps), stream_ptr())
    check(lib, rc, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mean, rstd


layer_norm_fwd.launches = 0

_BWD_GRID: Dict[Tuple[int, int], int] = {}  # (device, d) -> blocks that fit on the card


def _bwd_blocks(lib, device: torch.device, n: int, d: int) -> int:
    """The backward's persistent grid: the blocks that fit on the card at
    once (asked once a device and width), at most one for every four rows."""
    from whisper_finetune_torch._build import check

    key = (device.index, d)
    if key not in _BWD_GRID:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            check(lib, lib.wft_layer_norm_bwd_blocks(d, ctypes.addressof(out)),
                  "layer_norm_bwd_blocks")
        _BWD_GRID[key] = out.value
    return min(_BWD_GRID[key], -(-n // 4))


def layer_norm_bwd(dy: Tensor, x: Tensor, mean: Tensor, rstd: Tensor, weight: Tensor,
                   bias: Tensor, time_keep: Optional[Tensor] = None,
                   feat_keep: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (dx like x, dgamma, dbeta (d,) float32) from dy (the gradient of
    y), the saved x, mean and rstd, the forward's weight and bias (the
    kernels read no bias) and keep-vectors. One pass on a card: dx and
    per-block partial sums of dgamma and dbeta, then their sum in block
    order (no atomics: the same bits every run). The plain version where x
    is not a CUDA bf16 tensor."""
    if not (x.is_cuda and x.dtype == torch.bfloat16):
        return layer_norm_bwd_plain(dy, x, mean, rstd, weight, bias, time_keep, feat_keep)
    from whisper_finetune_torch._build import check, stream_ptr

    x = _rows(x, "layer_norm x")
    dy = _rows(dy.to(x.dtype), "layer_norm dy")
    d = x.shape[-1]
    n = x.numel() // d
    w = _vector(weight, x, d, torch.float32, "layer_norm weight")
    mean = _vector(mean, x, n, torch.float32, "layer_norm mean", wide=False)
    rstd = _vector(rstd, x, n, torch.float32, "layer_norm rstd", wide=False)
    tk, fk, t = _keep_args(x, time_keep, feat_keep)
    lib = _lib()
    blocks = _bwd_blocks(lib, x.device, n, d)
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, 2, d), dtype=torch.float32, device=x.device)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    db = torch.empty_like(dw)
    rc = lib.wft_layer_norm_bwd_launch(dy.data_ptr(), x.data_ptr(), mean.data_ptr(),
                                       rstd.data_ptr(), w.data_ptr(), _ptr(tk), _ptr(fk),
                                       dx.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                                       db.data_ptr(), n, d, t, blocks, stream_ptr())
    check(lib, rc, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dw, db


layer_norm_bwd.launches = 0

KERNELS = (layer_norm_fwd, layer_norm_bwd)  # each carries a .launches count


def _forward(x, weight, bias, eps, time_keep, feat_keep):
    return layer_norm_fwd(x, weight, bias, eps, time_keep, feat_keep)


def _setup_context(ctx, inputs, output):
    x, weight, bias, _, time_keep, feat_keep = inputs
    _, mean, rstd = output
    ctx.mark_non_differentiable(mean, rstd)
    ctx.save_for_backward(x, weight, bias, mean, rstd, time_keep, feat_keep)


def _backward(ctx, dy, _dmean, _drstd):
    x, weight, bias, mean, rstd, time_keep, feat_keep = ctx.saved_tensors
    dx, dw, db = layer_norm_bwd(dy, x, mean, rstd, weight, bias, time_keep, feat_keep)
    return dx, dw, db, None, None, None


# Defined through torch.library.Library rather than torch.library.custom_op:
# the latter wraps each call in torch._disable_dynamo, whose first call
# imports torch._dynamo (seconds of set-up in a process that has no other
# use for it, such as transcription).
_LIB = torch.library.Library("wft", "DEF")
_LIB.define("layer_norm(Tensor x, Tensor weight, Tensor bias, float eps, Tensor? time_keep, "
            "Tensor? feat_keep) -> (Tensor, Tensor, Tensor)")
for _key in ("CPU", "CUDA"):
    _LIB.impl("layer_norm", _forward, _key)
torch.library.register_autograd("wft::layer_norm", _backward, setup_context=_setup_context,
                                lib=_LIB)
# :func:`layer_norm_fwd` as one dispatcher op with its autograd: (x, weight,
# bias, eps, time_keep, feat_keep) -> (y, mean, rstd).
layer_norm_op = torch.ops.wft.layer_norm.default
