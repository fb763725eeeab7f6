"""The port's attention against the JAX package's: the splash path (here the
kernels' plain twins under the same ``autograd.Function``) against
``splash_mha`` in Pallas interpret mode and against ``xla_mha``, forward and
gradients, valid rows only (splash pads to 128 and slices the padding off)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.ops.attention import splash_mha as j_splash
from whisper_finetune_tpu.ops.attention import xla_mha as j_xla
from whisper_finetune_torch.ops import attention as A


def _qkv(Tq, Tk, B=2, H=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, T, D)).astype(np.float32) for T in (Tq, Tk, Tk))


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


CASES = [(48, 96, False), (77, 131, False), (24, 150, False), (64, 64, True), (77, 77, True)]


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
    """The backward twins give autograd's gradients of the forward twin,
    and the forward twin's lse is the row log-sum-exp."""
    q, k, v = (_t(x, True) for x in _qkv(33, 70, seed=4))
    do = _t(np.random.default_rng(5).standard_normal((2, 2, 33, 16)).astype(np.float32))
    scale = 0.3
    o, lse = A.attn_fwd_plain(q, k, v, False, scale)
    ref_lse = torch.logsumexp(torch.matmul(q * scale, k.transpose(-1, -2)), -1)
    torch.testing.assert_close(lse, ref_lse)
    gq, gk, gv = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        dq, delta = A.attn_bwd_dq(q, k, v, o, do, lse, False, scale)
        dk, dv = A.attn_bwd_dkdv(q, k, v, do, lse, delta, False, scale)
    for a, b in ((dq, gq), (dk, gk), (dv, gv)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_dispatch_and_auto_impls():
    q, k, v = (_t(x) for x in _qkv(8, 8))
    torch.testing.assert_close(A.attention(q, k, v, impl="splash"),
                               A.attention(q, k, v, impl="xla"), atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError, match="queue 2"):
        A.attention(q, k, v, impl="flash")
    with pytest.raises(ValueError):
        A.attention(q, k, v, impl="nope")
    assert A.resolve_auto_impls("cpu") == {"attn_impl": "xla"}
    assert A.resolve_auto_impls("cuda") == {
        "attn_impl": "xla", "attn_impl_encoder": "splash", "attn_impl_cross": "splash"}


def test_cpu_path_counts_no_launch():
    for fn in A.KERNELS:
        fn.launches = 0
    q, k, v = (_t(x, True) for x in _qkv(8, 8))
    A.splash_mha(q, k, v).sum().backward()
    assert [fn.launches for fn in A.KERNELS] == [0, 0, 0]
