"""The port's attention against the JAX package's: the splash path (here the
kernels' plain twins under the same ``autograd.Function``) against
``splash_mha`` in Pallas interpret mode and against ``xla_mha``, forward and
gradients, valid rows only (splash pads to 128 and slices the padding off);
the flash and flash_fwd routes against ``attention(impl=...)`` of JAX, which
on the CPU runs ``flash_mha`` through ``xla_mha`` as its own tests do."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.ops.attention import attention as j_attention
from whisper_finetune_tpu.ops.attention import splash_mha as j_splash
from whisper_finetune_tpu.ops.attention import xla_mha as j_xla
from whisper_finetune_torch.ops import attention as A


def _qkv(Tq, Tk, B=2, H=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, T, D)).astype(np.float32) for T in (Tq, Tk, Tk))


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


# ragged, fewer queries than a tile, causal; one query and one key past a
# whole tile (the forward kernel's last tiles), plain and causal
CASES = [(48, 96, False), (77, 131, False), (24, 150, False), (64, 64, True), (77, 77, True),
         (129, 257, False), (257, 257, True)]


@pytest.mark.parametrize("Tq,Tk,causal", CASES)
def test_splash_forward_matches_jax(Tq, Tk, causal):
    q, k, v = _qkv(Tq, Tk)
    scale = q.shape[-1] ** -0.5
    ref_s = np.asarray(j_splash(*map(jnp.asarray, (q, k, v)), causal=causal, sm_scale=scale))
    ref_x = np.asarray(j_xla(*map(jnp.asarray, (q, k, v)), causal=causal, sm_scale=scale))
    out = A.splash_mha(_t(q), _t(k), _t(v), causal=causal, sm_scale=scale).detach().numpy()
    assert out.shape == ref_s.shape
    # float32 on both sides, softmax in another order: measured ~1e-6.
    np.testing.assert_allclose(out, ref_s, atol=2e-5, rtol=0)
    np.testing.assert_allclose(out, ref_x, atol=2e-5, rtol=0)


@pytest.mark.parametrize("Tq,Tk,causal", CASES)
def test_splash_grads_match_jax(Tq, Tk, causal):
    q, k, v = _qkv(Tq, Tk, seed=1)
    cot = np.random.default_rng(2).standard_normal((2, 2, Tq, 16)).astype(np.float32)
    scale = q.shape[-1] ** -0.5

    def loss(fn, q, k, v):
        return jnp.sum(fn(q, k, v, causal=causal, sm_scale=scale) * cot)

    g_spl = jax.grad(lambda *a: loss(j_splash, *a), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    g_xla = jax.grad(lambda *a: loss(j_xla, *a), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (A.splash_mha(tq, tk, tv, causal=causal, sm_scale=scale) * _t(cot)).sum().backward()
    for got, a, b in zip((tq.grad, tk.grad, tv.grad), g_spl, g_xla):
        np.testing.assert_allclose(got.numpy(), np.asarray(a), atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_xla_mha_matches_jax(dtype, causal):
    q, k, v = _qkv(40, 40, seed=3)
    scale = q.shape[-1] ** -0.5
    jd = jnp.dtype(dtype)
    ref = np.asarray(j_xla(*(jnp.asarray(x, jd) for x in (q, k, v)), causal=causal,
                           sm_scale=scale).astype(jnp.float32))
    td = getattr(torch, dtype)
    out = A.xla_mha(*(_t(x).to(td) for x in (q, k, v)), causal=causal,
                    sm_scale=scale).float().numpy()
    # bf16: scores and probabilities stored in bf16 (one ulp ~ 4e-3 at 1).
    np.testing.assert_allclose(out, ref, atol=2e-5 if dtype == "float32" else 3e-2, rtol=0)


def test_plain_twins_compose_to_autograd():
    """The backward twin gives autograd's gradients of the forward twin,
    and the forward twin's lse is the row log-sum-exp."""
    q, k, v = (_t(x, True) for x in _qkv(33, 70, seed=4))
    do = _t(np.random.default_rng(5).standard_normal((2, 2, 33, 16)).astype(np.float32))
    scale = 0.3
    o, lse = A.attn_fwd_plain(q, k, v, False, scale)
    ref_lse = torch.logsumexp(torch.matmul(q * scale, k.transpose(-1, -2)), -1)
    torch.testing.assert_close(lse, ref_lse)
    gq, gk, gv = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        dq, dk, dv = A.attn_bwd(q, k, v, o, do, lse, False, scale)
    for a, b in ((dq, gq), (dk, gk), (dv, gv)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# the encoder's square shape, and the decoder's causal site (the route
# ``auto`` takes on a card) at 8 and at a length no multiple of 64
@pytest.mark.parametrize("T,causal", [(8, False), (8, True), (77, True)])
def test_dispatch_and_auto_impls(T, causal):
    q, k, v = (_t(x, True) for x in _qkv(T, T))
    do = _t(np.random.default_rng(16).standard_normal((2, 2, T, 16)).astype(np.float32))
    scale = q.shape[-1] ** -0.5
    want = A.attention(q, k, v, causal=causal, sm_scale=scale, impl="xla")
    want_grads = torch.autograd.grad(want, (q, k, v), do)
    got = A.attention(q, k, v, causal=causal, sm_scale=scale, impl="splash")
    # float32 on both sides, the twins' softmax in another order: <= 6e-7
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    for a, b in zip(torch.autograd.grad(got, (q, k, v), do), want_grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    for impl in ("flash", "flash_fwd"):
        torch.testing.assert_close(A.attention(q, k, v, causal=causal, sm_scale=scale, impl=impl),
                                   want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        A.attention(q, k, v, impl="nope")
    assert A.resolve_auto_impls("cpu") == {"attn_impl": "xla"}
    assert A.resolve_auto_impls("cuda") == {
        "attn_impl": "xla", "attn_impl_encoder": "splash", "attn_impl_decoder": "splash",
        "attn_impl_cross": "splash"}


def test_cpu_path_counts_no_launch():
    for fn in A.KERNELS:
        fn.launches = fn.causal_launches = 0
    for causal in (False, True):
        q, k, v = (_t(x, True) for x in _qkv(8, 8))
        A.splash_mha(q, k, v, causal=causal).sum().backward()
    assert [fn.__name__ for fn in A.KERNELS] == ["attn_fwd", "attn_bwd"]
    assert [fn.launches for fn in A.KERNELS] == [0, 0]
    assert [fn.causal_launches for fn in A.KERNELS] == [0, 0]


# ragged, fewer keys than queries, causal (square and ragged)
BWD_CASES = [(33, 70, False), (77, 131, False), (130, 40, False), (64, 64, True),
             (77, 77, True), (200, 200, True)]


@pytest.mark.parametrize("Tq,Tk,causal", BWD_CASES)
def test_attn_bwd_plain_matches_autograd_of_forward_twin(Tq, Tk, causal):
    q, k, v = (_t(x, True) for x in _qkv(Tq, Tk, seed=13))
    do = _t(np.random.default_rng(14).standard_normal((2, 2, Tq, 16)).astype(np.float32))
    o, lse = A.attn_fwd_plain(q, k, v, causal, 0.25)
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        got = A.attn_bwd_plain(q, k, v, o, do, lse, causal, 0.25)
        same = A.attn_bwd(q, k, v, o, do, lse, causal, 0.25)  # CPU tensors: the twin
    for a, b, c in zip(got, want, same):
        # float32 on both sides; autograd sums in another order
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        assert torch.equal(a, c)


def test_backward_calls_attn_bwd_once(monkeypatch):
    """``_KernelAttention.backward`` is one ``attn_bwd`` call with the saved
    q, k, v, o, lse and the incoming gradient."""
    calls = []
    real = A.attn_bwd

    def counting(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(A, "attn_bwd", counting)
    q, k, v = (_t(x, True) for x in _qkv(12, 20, seed=15))
    out = A.flash_mha(q, k, v, causal=False, sm_scale=0.25)
    assert calls == []
    out.sum().backward()
    assert len(calls) == 1
    assert len(calls[0]) == 8 and calls[0][6:] == (False, 0.25)
    assert calls[0][3].shape == out.shape and calls[0][5].shape == out.shape[:3]


def test_backward_inputs_are_laid_out_once(monkeypatch):
    """The backward's inputs take the kernels' layout in one place: the
    model's (B, T, H, 64) views pass through untouched, and a gradient that
    arrives in another layout (or dtype) is copied exactly once."""
    copies = []
    real = A._as_layout

    def recording(x, ref):
        out = real(x, ref)
        copies.append(out is not x)
        return out

    monkeypatch.setattr(A, "_as_layout", recording)

    def heads(T):  # the model's layout
        return torch.zeros((2, T, 3, 64), dtype=torch.bfloat16).transpose(1, 2)

    q, k, v, o = heads(10), heads(14), heads(14), heads(10)
    do = torch.ones((2, 3, 10, 64))  # contiguous float32: the wrong layout and dtype
    lq, lk, lv, lo, ldo = A._bwd_layout(q, k, v, o, do)
    assert (lq is q) and (lk is k) and (lv is v) and (lo is o)
    assert ldo.dtype == torch.bfloat16 and ldo.stride() == q.stride()
    assert torch.equal(ldo.float(), do)
    assert copies == [False, False, True]  # v, o untouched; do copied once


# ragged (no multiple of 64 or 128), causal and not, square and cross shapes
FLASH_CASES = [(48, 96, False), (77, 131, False), (24, 150, False), (64, 64, True),
               (77, 77, True), (150, 150, False), (129, 257, False), (257, 257, True)]


@pytest.mark.parametrize("impl", ["flash", "flash_fwd"])
@pytest.mark.parametrize("Tq,Tk,causal", FLASH_CASES)
def test_flash_routes_forward_match_jax(impl, Tq, Tk, causal):
    q, k, v = _qkv(Tq, Tk, seed=6)
    scale = q.shape[-1] ** -0.5
    ref = np.asarray(j_attention(*map(jnp.asarray, (q, k, v)), causal=causal, sm_scale=scale,
                                 impl=impl))
    out = A.attention(_t(q), _t(k), _t(v), causal=causal, sm_scale=scale, impl=impl)
    # float32 on both sides, scores scaled at another place: measured ~1e-6.
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("impl", ["flash", "flash_fwd"])
@pytest.mark.parametrize("Tq,Tk,causal", FLASH_CASES)
def test_flash_routes_grads_match_jax(impl, Tq, Tk, causal):
    q, k, v = _qkv(Tq, Tk, seed=7)
    cot = np.random.default_rng(8).standard_normal((2, 2, Tq, 16)).astype(np.float32)
    scale = q.shape[-1] ** -0.5
    ref = jax.grad(lambda *a: jnp.sum(j_attention(*a, causal=causal, sm_scale=scale, impl=impl)
                                      * cot), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    (A.attention(tq, tk, tv, causal=causal, sm_scale=scale, impl=impl) * _t(cot)).sum().backward()
    # float32: the kernels' twins (flash) or autograd of xla_mha (flash_fwd)
    # against JAX's VJP of xla_mha; sums in another order.
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_bf16_mixes_two_scalings(causal):
    """In bf16 the forward scales the float32 scores by D**-0.5 and the plain
    backward scales q and k by D**-0.25 each in bf16 (not exact there), as
    JAX does on a TPU. On the CPU JAX's forward is xla_mha too, so the
    forward differs by that rounding: a few bf16 ulps of the output (1 ulp
    = 2**-8 relative; limit 3e-2 absolute on O(1) values, as for xla_mha).
    The backward is the same function on both sides: bf16 rounding only."""
    q, k, v = _qkv(40, 40, seed=9)
    cot = np.random.default_rng(10).standard_normal((2, 2, 40, 16)).astype(np.float32)
    scale = q.shape[-1] ** -0.5
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jcot = jnp.asarray(cot, jnp.bfloat16)
    ref_o = j_attention(jq, jk, jv, causal=causal, sm_scale=scale, impl="flash_fwd")
    ref_g = jax.grad(lambda *a: jnp.sum((j_attention(*a, causal=causal, sm_scale=scale,
                                                     impl="flash_fwd") * jcot)
                                        .astype(jnp.float32)), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (_t(x).bfloat16().requires_grad_() for x in (q, k, v))
    out = A.flash_fwd_xla_bwd(tq, tk, tv, causal=causal, sm_scale=scale)
    assert out.dtype == torch.bfloat16
    out.backward(_t(cot).bfloat16())
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(ref_o.astype(jnp.float32)), atol=3e-2, rtol=0)
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_g):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2e-2 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("Tq,Tk,causal", [(33, 70, False), (50, 50, True)])
def test_nolse_twin_is_the_forward_twin(Tq, Tk, causal):
    q, k, v = (_t(x) for x in _qkv(Tq, Tk, seed=11))
    o, lse = A.attn_fwd(q, k, v, causal, 0.3)
    o2, none = A.attn_fwd(q, k, v, causal, 0.3, with_lse=False)
    assert none is None and lse.shape == (2, 2, Tq)
    torch.testing.assert_close(o2, o, atol=1e-6, rtol=0)
    torch.testing.assert_close(A.attn_fwd_nolse_plain(q, k, v, causal, 0.3), o2, atol=0, rtol=0)


def test_flash_fwd_saves_no_statistics_and_runs_no_backward_kernel():
    q, k, v = (_t(x, True) for x in _qkv(12, 20, seed=12))
    out = A.flash_fwd_xla_bwd(q, k, v, sm_scale=0.25)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 and all(s.shape == x.shape for s, x in zip(saved, (q, k, v)))
    full = A.flash_mha(q, k, v, sm_scale=0.25)
    assert len(full.grad_fn.saved_tensors) == 5  # q, k, v, o, lse
    gq, gk, gv = torch.autograd.grad(out.sum(), (q, k, v))
    rq, rk, rv = torch.autograd.grad(A.xla_mha(q, k, v, sm_scale=0.25).sum(), (q, k, v))
    for a, b in ((gq, rq), (gk, rk), (gv, rv)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn", ["flash_mha", "flash_fwd_xla_bwd"])
def test_flash_wrappers_refuse_other_devices(fn):
    q = torch.empty((1, 1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(A, fn)(q, q, q)


class _FakeEntry:
    """A stand-in for a ctypes function of the kernel library."""
    argtypes = restype = None


def test_bind_declares_every_c_entry():
    """``bind`` gives each C entry of ``csrc/attention.cu`` its argument
    types (pointers and the stream as ``c_void_p``, the dims as int, long
    long and float, in the order of ``WFT_DIMS_ARGS``) and an int result,
    once for a library."""
    import ctypes
    import types

    lib = types.SimpleNamespace(**{name: _FakeEntry() for name in
                                   ("wft_attn_fwd", "wft_attn_bwd", "wft_attn_fwd_occupancy")})
    assert A.bind(lib) is lib and lib._wft_bound
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    dims = [I, I, I, I, L, L, L, L, L, L, F, I, P]
    assert lib.wft_attn_fwd.argtypes == [P] * 5 + dims
    assert lib.wft_attn_bwd.argtypes == [P] * 11 + dims
    assert lib.wft_attn_fwd_occupancy.argtypes == [I, P, P]
    assert all(getattr(lib, n).restype is I for n in
               ("wft_attn_fwd", "wft_attn_bwd", "wft_attn_fwd_occupancy"))
    lib.wft_attn_fwd.argtypes = None
    A.bind(lib)  # bound already: left as it is
    assert lib.wft_attn_fwd.argtypes is None
    source = (Path(A.__file__).parent.parent / "csrc" / "attention.cu").read_text()
    assert all(f'extern "C" int {n}(' in source for n in
               ("wft_attn_fwd", "wft_attn_bwd", "wft_attn_fwd_occupancy"))
