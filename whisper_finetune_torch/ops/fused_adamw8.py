"""Fused blockwise-8-bit AdamW update, the port of
``whisper_finetune_tpu/ops/fused_adamw8.py``.

:func:`fused_adamw8_leaf` updates one quantized leaf, viewed as (NB, 256)
blocks, in one pass and IN PLACE: the parameter, both code arrays and both
scale arrays are overwritten (the JAX version returns new arrays; here the
buffers are reused, which saves a second copy of the optimizer state).

On a CUDA tensor it launches the kernel of ``csrc/fused_adamw8.cu`` (one
warp a 256-element block, warp-shuffle block maxima; bound by the ~14 bytes
it moves an element) or raises. On a CPU tensor it runs
:func:`fused_adamw8_plain`, the plain PyTorch twin of the kernel, which
follows ``_update_math`` (``ops/fused_adamw8.py:61-91``) operation by
operation: ``exp(x*ln10)`` for the codebook, ``log(x)/ln10`` back, and
division by c1 and c2.

Constant divisors in the plain version are 0-dim tensors on the data's
device: PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, which rounds differently from the kernel's (and JAX's) division.
"""

from __future__ import annotations

import ctypes

import torch

from whisper_finetune_torch.optim.quantized import BLOCK, _LOG_DECADES, _LOG_LEVELS

_LN10 = 2.302585092994046


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def fused_adamw8_plain(p, g, m_codes, m_scale, n_codes, n_scale, lr: float,
                       c1: float, c2: float, g_scale: torch.Tensor, *,
                       b1: float, b2: float, eps: float, wd: float):
    """Functional plain twin of the kernel: returns new
    (p, m_codes, m_scale, n_codes, n_scale) for (NB, 256) blocks."""
    gg = g.float() * g_scale
    m = b1 * (m_codes.float() * m_scale) + (1.0 - b1) * gg
    qf = n_codes.float()
    r = torch.exp(((qf - 1.0) / _const(_LOG_LEVELS, qf) * _LOG_DECADES
                   - _LOG_DECADES) * _LN10)
    nu_prev = torch.where(qf == 0, 0.0, r) * n_scale
    nu = b2 * nu_prev + (1.0 - b2) * gg * gg
    upd = (m / _const(c1, m)) / (torch.sqrt(nu / _const(c2, nu)) + eps)
    p_new = p - lr * (upd + wd * p)

    ms_new = m.abs().amax(dim=1, keepdim=True) / _const(127.0, m)
    ms_safe = torch.where(ms_new == 0, 1.0, ms_new)
    mc_new = torch.clamp(torch.round(m / ms_safe), -127, 127).to(torch.int8)

    ns_new = nu.amax(dim=1, keepdim=True)
    ns_safe = torch.where(ns_new == 0, 1.0, ns_new)
    rq = torch.clamp(nu / ns_safe, 0.0, 1.0)
    logr = torch.log(torch.clamp(rq, min=10.0 ** (-_LOG_DECADES))) / _const(_LN10, rq)
    codes = 1.0 + torch.round((logr + _LOG_DECADES) / _const(_LOG_DECADES, rq)
                              * _LOG_LEVELS)
    nc_new = torch.where(rq == 0, 0.0, codes).to(torch.uint8)
    return p_new, mc_new, ms_new, nc_new, ns_new


def _lib():
    from whisper_finetune_torch._build import libraries

    lib = libraries()["fused_adamw8"]
    if not getattr(lib, "_wft_bound", False):
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.wft_fused_adamw8.argtypes = [P, P, I, P, P, P, P, L, P] + [F] * 9 + [P]
        lib.wft_fused_adamw8.restype = ctypes.c_int
        lib._wft_bound = True
    return lib


def _check(p, g, m_codes, m_scale, n_codes, n_scale, g_scale):
    nb = p.shape[0]
    expect = (
        ("p", p, torch.float32, (nb, BLOCK)),
        ("m_codes", m_codes, torch.int8, (nb, BLOCK)),
        ("m_scale", m_scale, torch.float32, (nb, 1)),
        ("n_codes", n_codes, torch.uint8, (nb, BLOCK)),
        ("n_scale", n_scale, torch.float32, (nb, 1)),
        ("g_scale", g_scale, torch.float32, ()),
    )
    for name, x, dtype, shape in expect + (("g", g, g.dtype, (nb, BLOCK)),):
        if not x.is_cuda or x.device != p.device:
            raise ValueError(f"fused_adamw8: {name} must be on {p.device}")
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"fused_adamw8: {name} must be {dtype} {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"fused_adamw8: {name} must be contiguous and 16-byte aligned")
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_adamw8: g must be bfloat16 or float32, got {g.dtype}")


def fused_adamw8_leaf(p, g, m_codes, m_scale, n_codes, n_scale, lr: float,
                      c1: float, c2: float, g_scale: torch.Tensor, *,
                      b1: float, b2: float, eps: float, wd: float) -> None:
    """One AdamW step of a quantized leaf, in place. p (NB, 256) float32,
    g (NB, 256) bf16 or float32, codes (NB, 256) int8 / uint8, scales (NB, 1)
    float32, g_scale a 0-dim float32 tensor on p's device (read by the kernel
    from device memory, so no host sync), lr/c1/c2 Python floats."""
    if p.device.type == "cpu":
        out = fused_adamw8_plain(p, g, m_codes, m_scale, n_codes, n_scale, lr,
                                 c1, c2, g_scale, b1=b1, b2=b2, eps=eps, wd=wd)
        for dst, src in zip((p, m_codes, m_scale, n_codes, n_scale), out):
            dst.copy_(src)
        return
    if p.device.type != "cuda":
        raise ValueError(f"fused_adamw8_leaf: unsupported device {p.device}")
    from whisper_finetune_torch._build import check, stream_ptr

    _check(p, g, m_codes, m_scale, n_codes, n_scale, g_scale)
    lib = _lib()
    rc = lib.wft_fused_adamw8(
        p.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16),
        m_codes.data_ptr(), m_scale.data_ptr(), n_codes.data_ptr(),
        n_scale.data_ptr(), p.shape[0], g_scale.data_ptr(),
        lr, c1, c2, b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, stream_ptr(),
    )
    check(lib, rc, "fused_adamw8")
    fused_adamw8_leaf.launches += 1


fused_adamw8_leaf.launches = 0
