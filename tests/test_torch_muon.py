"""The port's Muon against the JAX package's ``optim/muon.py``: Newton-Schulz
(both coefficient tables, tall, wide and stacked matrices), the shape and RMS
scales, and whole updates through ``fused_apply`` for every momentum dtype,
one and two updates, chunked and whole-leaf.

Tolerances. Newton-Schulz runs in bf16 on both sides with every intermediate
rounded at the same places, so the only difference is the order in which a
bf16 matmul's float32 sum is taken; the iteration amplifies a flipped
rounding. Measured on the CPU: identical on most inputs, up to 2.4% relative
Frobenius error (a stacked (2, 96, 32) leaf, 7 polar-express iterations);
single matrices mostly 0 to 1%. The limit is 5%. A Muon
update is ``lr * scale * O``, so updates are held to the same relative
Frobenius error, and float32 / bf16 momentum (no Newton-Schulz in it) to
float32 / bf16 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.optim import muon as jm
from whisper_finetune_tpu.optim.quantized import _QMoment
from whisper_finetune_torch.optim import muon as tm
from whisper_finetune_torch.optim.quantized import QMoment
from whisper_finetune_torch.optim.state_bridge import muon_state_from_numpy

NS_REL_TOL = 5e-2


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64))
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


@pytest.mark.parametrize("coeffs,steps", [("classic", 5), ("polar_express", 6),
                                          ("polar_express", 7), ("classic", 0)])
@pytest.mark.parametrize("shape", [(64, 64), (48, 128), (128, 48), (3, 64, 256), (2, 96, 32)])
def test_newton_schulz_matches_jax(shape, coeffs, steps):
    g = np.random.default_rng(len(shape) + shape[-1] + steps).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jm.newton_schulz_orthogonalize(jnp.asarray(g), steps=steps, coeffs=coeffs))
    out = tm.newton_schulz_orthogonalize(_t(g), steps=steps, coeffs=coeffs)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    assert _rel(out.numpy(), ref) <= NS_REL_TOL
    if steps >= 5:
        # On its own: the result is near semi-orthogonal. No singular value
        # overshoots (classic settles below ~1.25, polar express below ~1.0),
        # and where the input is well conditioned (aspect >= 2) none is left
        # behind: classic >= ~0.55, polar express >= ~0.8 (bf16; a square
        # Gaussian matrix has singular values near 0 that no 5 steps lift).
        sv = np.linalg.svd(out.numpy().reshape(-1, *shape[-2:]), compute_uv=False)
        lo, hi = (0.5, 1.3) if coeffs == "classic" else (0.75, 1.05)
        assert sv.max() <= hi, sv.max()
        if max(shape[-2:]) >= 2 * min(shape[-2:]):
            assert sv.min() >= lo, sv.min()


def test_newton_schulz_tables_and_errors():
    for coeffs, steps in (("classic", 5), ("polar_express", 7), ("classic", 0)):
        np.testing.assert_array_equal(tm._ns_coeff_table(steps, coeffs).numpy(),
                                      np.asarray(jm._ns_coeff_table(steps, coeffs)))
    with pytest.raises(ValueError, match="at most 7"):
        tm._ns_coeff_table(8, "polar_express")
    with pytest.raises(ValueError, match="unknown ns_coeffs"):
        tm.newton_schulz_orthogonalize(torch.zeros(4, 4), coeffs="nope")
    bf = tm.newton_schulz_orthogonalize(torch.randn(8, 16).bfloat16())
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(1280, 5120), (5120, 1280), (1280, 1280), (32, 1280, 5120)[1:],
                                   (64, 16), (16, 64)])
def test_scales_match_jax(shape):
    # The port keeps the (in, out) layout, so rows and cols are JAX's.
    assert tm.muon_shape_scale(shape) == jm.muon_shape_scale(shape)
    for factor in (0.2, 0.35):
        assert tm.rms_match_scale(shape, factor) == jm.rms_match_scale(shape, factor)
    with pytest.raises(ValueError, match="ndim >= 2"):
        tm.rms_match_scale((7,))


def _leaves(rng):
    # stacked wide, stacked tall (both >= MIN_QUANT_SIZE), a plain matrix
    # below it (float32 momentum even under int8)
    return [rng.standard_normal(s).astype(np.float32) * 0.1
            for s in ((3, 64, 128), (2, 128, 64), (32, 48))]


def _j_momentum(state):
    out = []
    for m in state.momentum:
        out.append((np.asarray(m.codes), np.asarray(m.scale)) if isinstance(m, _QMoment)
                   else np.asarray(m))
    return out


@pytest.mark.parametrize("match", [True, False])
@pytest.mark.parametrize("momentum_dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("chunk_mb", [128.0, 0.04])  # 0.04 MB: one layer a chunk
def test_muon_updates_match_jax(momentum_dtype, chunk_mb, match):
    rng = np.random.default_rng(7)
    params = _leaves(rng)
    kw = dict(momentum=0.95, weight_decay=0.01, match_adamw_update_rms=match,
              momentum_dtype=momentum_dtype, chunk_temp_mb=chunk_mb)
    lr = lambda count: 1e-3 * (1.0 - 0.25 * count)  # noqa: E731  a schedule of the count
    jtx = jm.scale_by_muon(lambda c: 1e-3 * (1.0 - 0.25 * c), **kw)
    ttx = tm.scale_by_muon(lr, **kw)
    jp = [jnp.asarray(p) for p in params]
    js = jtx.init(jp)
    tp = [_t(p) for p in params]
    ts = ttx.init(tp)
    assert [isinstance(m, QMoment) for m in ts.momentum] == [
        isinstance(m, _QMoment) for m in js.momentum]
    if ttx._layers_per_chunk(tp[0], (64, 128)) is not None:
        assert chunk_mb < 1 and ttx._layers_per_chunk(tp[0], (64, 128)) == 1
    for step in range(2):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        gs = np.float32(0.5)
        before = [np.asarray(p) for p in jp]
        jp, js = jtx.fused_apply([jnp.asarray(g, jnp.bfloat16) for g in grads], js, jp,
                                 g_scale=jnp.float32(gs))
        ts = ttx.fused_apply([_t(g).bfloat16() for g in grads], ts, tp,
                             g_scale=torch.tensor(gs))
        assert ts.count == int(js.count) == step + 1
        for b, j, t in zip(before, jp, tp):
            assert _rel(t.numpy() - b, np.asarray(j) - b) <= NS_REL_TOL
        for jmom, tmom in zip(_j_momentum(js), ts.momentum):
            if isinstance(tmom, QMoment):
                # momentum itself involves no Newton-Schulz: codes to one level
                # (a .5 tie in another rounding), scales to float32 rounding
                assert np.abs(tmom.codes.numpy().astype(int) - jmom[0].astype(int)).max() <= 1
                np.testing.assert_allclose(tmom.scale.numpy(), jmom[1], rtol=1e-6)
            elif momentum_dtype == "bfloat16":
                np.testing.assert_allclose(tmom.float().numpy(), jmom.astype(np.float32),
                                           rtol=2 ** -7, atol=1e-6)
            else:
                np.testing.assert_allclose(tmom.numpy(), jmom, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("momentum_dtype", [None, "bfloat16", "int8"])
def test_chunked_equals_whole_leaf(momentum_dtype):
    rng = np.random.default_rng(3)
    p0 = (rng.standard_normal((4, 64, 128)) * 0.1).astype(np.float32)
    outs = []
    for chunk_mb in (None, 0.07):  # 0.07 MB -> two layers a chunk
        tx = tm.Muon(1e-3, weight_decay=0.01, momentum_dtype=momentum_dtype,
                     chunk_temp_mb=chunk_mb)
        p = [_t(p0)]
        st = tx.init(p)
        g_rng = np.random.default_rng(4)
        for _ in range(2):
            st = tx.fused_apply([_t(g_rng.standard_normal(p0.shape).astype(np.float32))], st, p)
        outs.append((p[0], st.momentum[0]))
    assert tm.Muon(1e-3, chunk_temp_mb=0.07)._layers_per_chunk(_t(p0), (64, 128)) == 2
    (pa, ma), (pb, mb) = outs
    # Batched matmuls over 4 or 2 layers: the same per-matrix arithmetic.
    torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    for a, b in zip(ma if isinstance(ma, QMoment) else (ma,), mb if isinstance(mb, QMoment) else (mb,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("momentum_dtype", [None, "bfloat16", "int8"])
def test_state_bridge_from_jax(momentum_dtype):
    """A JAX mid-training state, carried across, continues like JAX."""
    rng = np.random.default_rng(11)
    params = _leaves(rng)
    kw = dict(weight_decay=0.01, momentum_dtype=momentum_dtype)
    jtx, ttx = jm.scale_by_muon(1e-3, **kw), tm.scale_by_muon(1e-3, **kw)
    jp = [jnp.asarray(p) for p in params]
    js = jtx.init(jp)
    g1 = [jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)) for p in params]
    jp, js = jtx.fused_apply(g1, js, jp)
    tp = [_t(np.asarray(p)) for p in jp]
    ts = muon_state_from_numpy(int(js.count), _j_momentum(js), device="cpu")
    fresh = ttx.init(tp)
    assert ts.count == 1
    for a, b in zip(ts.momentum, fresh.momentum):
        assert type(a) is type(b)
        for x, y in zip(a if isinstance(a, QMoment) else (a,), b if isinstance(b, QMoment) else (b,)):
            assert x.dtype == y.dtype and x.shape == y.shape
    g2 = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
    before = [np.asarray(p) for p in jp]
    jp, js = jtx.fused_apply([jnp.asarray(g) for g in g2], js, jp)
    ts = ttx.fused_apply([_t(g) for g in g2], ts, tp)
    for b, j, t in zip(before, jp, tp):
        assert _rel(t.numpy() - b, np.asarray(j) - b) <= NS_REL_TOL


def test_shard_axis_waits_for_data_parallel_slice():
    """The data-parallel slice has come: a Muon sharded over 2 ranks splits
    the Newton-Schulz of every stacked leaf whose layer count divides (the
    JAX package's condition; no layer chunking then) and keeps the others
    whole; outside a 2-rank process group it refuses to update. Its parity
    with JAX across two ranks: tests/test_torch_parallel.py."""
    mu = tm.scale_by_muon(1e-3, shard_axis="data", shard_axis_size=2, chunk_temp_mb=1e-4)
    assert mu._sharded(torch.zeros(4, 8, 8)) and not mu._sharded(torch.zeros(3, 8, 8))
    assert not mu._sharded(torch.zeros(8, 8))
    assert mu._layers_per_chunk(torch.zeros(4, 16, 16), (16, 16)) is None
    assert mu._layers_per_chunk(torch.zeros(3, 16, 16), (16, 16)) == 1
    p = [torch.zeros(4, 8, 8)]
    with pytest.raises(RuntimeError, match="process group has 1"):
        mu.fused_apply([torch.ones(4, 8, 8)], mu.init(p), p)
    one = tm.scale_by_muon(1e-3, shard_axis="data", shard_axis_size=1)  # one device: plain path
    assert not one._sharded(torch.zeros(4, 8, 8))
