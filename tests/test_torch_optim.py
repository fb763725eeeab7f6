"""The port's blockwise 8-bit AdamW against the JAX package's: quantizers,
the fused per-leaf update (the kernel's plain twin against
``fused_adamw8_leaf`` in Pallas interpret mode, on identical codes and
scales, over its 3-D and 2-D leaf layouts) and ``fused_apply`` over a tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_finetune_tpu.ops.fused_adamw8 import fused_adamw8_leaf as j_leaf
from whisper_finetune_tpu.optim import quantized as jq
from whisper_finetune_torch.ops.fused_adamw8 import fused_adamw8_leaf as t_leaf
from whisper_finetune_torch.ops.fused_adamw8 import fused_adamw8_plain
from whisper_finetune_torch.optim import quantized as tq

HP = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_constants_match():
    assert (tq.BLOCK, tq.MIN_QUANT_SIZE, tq._LOG_DECADES, tq._LOG_LEVELS) == (
        jq.BLOCK, jq.MIN_QUANT_SIZE, jq._LOG_DECADES, jq._LOG_LEVELS)


@pytest.mark.parametrize("n", [256 * 20, 4096 + 77])
def test_quantizers_match_jax(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    jc, js = jq.quantize_blockwise(jnp.asarray(x))
    tc, ts = tq.quantize_blockwise(_t(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(tc, ts, (n,)).numpy(),
        np.asarray(jq.dequantize_blockwise(jc, js, (n,))))

    nu = x * x
    jc, js = jq.quantize_log_blockwise(jnp.asarray(nu))
    tc, ts = tq.quantize_log_blockwise(_t(nu))
    # log10 in two libraries: a code may sit one level apart at a rounding
    # edge (measured: none on these inputs).
    assert np.abs(tc.numpy().astype(int) - np.asarray(jc).astype(int)).max() <= 1
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq_t = tq.dequantize_log_blockwise(_t(np.asarray(jc)), ts, (n,)).numpy()
    deq_j = np.asarray(jq.dequantize_log_blockwise(jc, js, (n,)))
    np.testing.assert_allclose(deq_t, deq_j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("nb", [256, 100])  # JAX: 3-D (NB % 128 == 0) and 2-D layouts
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_fused_leaf_matches_pallas(nb, g_dtype):
    rng = np.random.default_rng(nb)
    p = rng.standard_normal((nb, 256)).astype(np.float32)
    jstate = [jnp.asarray(p), jnp.zeros((nb, 256), jnp.int8), jnp.zeros((nb, 1), jnp.float32),
              jnp.zeros((nb, 256), jnp.uint8), jnp.zeros((nb, 1), jnp.float32)]
    tstate = [_t(np.asarray(a)) for a in jstate]
    f32 = np.float32
    for t in range(1, 4):
        g = (rng.standard_normal((nb, 256)) * 0.1).astype(np.float32)
        gj = jnp.asarray(g, jnp.dtype(g_dtype))
        c1 = f32(1) - f32(0.9) ** f32(t)
        c2 = f32(1) - f32(0.999) ** f32(t)
        gs = f32(0.7)
        out = j_leaf(jstate[0], gj, *jstate[1:], jnp.float32(1e-3), jnp.float32(c1),
                     jnp.float32(c2), jnp.float32(gs), interpret=True, **HP)
        jstate = list(out)
        gt = _t(np.asarray(gj.astype(jnp.float32))).to(getattr(torch, g_dtype))
        t_leaf(tstate[0], gt, *tstate[1:], 1e-3, float(c1), float(c2),
               torch.tensor(gs), **HP)  # in place
    p_j, mc_j, ms_j, nc_j, ns_j = (np.asarray(a) for a in jstate)
    p_t, mc_t, ms_t, nc_t, ns_t = (a.numpy() for a in tstate)
    # XLA's and PyTorch's exp differ by an ulp at 30 of the 256 codebook
    # values, and bf16 gradients put many m/scale quotients on exact .5 ties,
    # so a code can sit one level apart (measured: up to 55 of 65536 after 3
    # steps). A flipped code moves that element's p by up to ~4% of lr and a
    # block's absmax scale by up to 1/127. Everything else agrees to float32
    # rounding.
    lr = 1e-3
    dp = np.abs(p_t - p_j)
    assert dp.max() <= 0.1 * lr
    assert (dp > 1e-6).mean() <= 1e-3
    assert np.abs(mc_t.astype(int) - mc_j.astype(int)).max() <= 1
    assert np.abs(nc_t.astype(int) - nc_j.astype(int)).max() <= 1
    np.testing.assert_allclose(ms_t, ms_j, rtol=1.0 / 127, atol=0)
    np.testing.assert_allclose(ns_t, ns_j, rtol=1e-6, atol=0)


def test_plain_twin_is_functional_and_wrapper_in_place():
    rng = np.random.default_rng(0)
    args = [_t(rng.standard_normal((4, 256)).astype(np.float32)),
            _t((rng.standard_normal((4, 256)) * 0.1).astype(np.float32)),
            torch.zeros((4, 256), dtype=torch.int8), torch.zeros((4, 1)),
            torch.zeros((4, 256), dtype=torch.uint8), torch.zeros((4, 1))]
    before = [a.clone() for a in args]
    out = fused_adamw8_plain(*args, 1e-3, 0.1, 0.001, torch.tensor(1.0), **HP)
    assert all(torch.equal(a, b) for a, b in zip(args, before))
    t_leaf(*args, 1e-3, 0.1, 0.001, torch.tensor(1.0), **HP)
    for got, want in zip([args[0], *args[2:]], out):
        assert torch.equal(got, want)


def _tree(rng):
    return {
        "big": rng.standard_normal((16, 256)).astype(np.float32),       # fused kernel
        "odd": rng.standard_normal(4096 + 100).astype(np.float32),      # quantized, plain
        "small": rng.standard_normal(16).astype(np.float32),            # float32 moments
    }


@pytest.mark.parametrize("clip", [None, 1.0])
def test_fused_apply_matches_jax(clip):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [{k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    jtx = jq.adamw_8bit(1e-2, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    keys = sorted(params)  # JAX's flatten order
    tleaves = [_t(params[k]) for k in keys]
    ttx = tq.adamw_8bit(1e-2, weight_decay=0.01)
    ts = ttx.init(tleaves)
    for g in grads:
        gs = None
        if clip is not None:
            gnorm = np.sqrt(sum(float(np.sum(np.square(x))) for x in g.values()))
            gs = np.float32(min(1.0, clip / (gnorm + 1e-6)))
        jp, js = jtx.fused_apply(jax.tree.map(jnp.asarray, g), js, jp,
                                 g_scale=None if gs is None else jnp.float32(gs))
        ts = ttx.fused_apply([_t(g[k]) for k in keys], ts, tleaves,
                             g_scale=None if gs is None else torch.tensor(gs))
    assert ts.count == int(js[0].count) == 3
    for k, leaf in zip(keys, tleaves):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=k)
    for k, mu, nu in zip(keys, ts.mu, ts.nu):
        jmu, jnu = js[0].mu[k], js[0].nu[k]
        if isinstance(mu, tq.QMoment):
            assert isinstance(jmu, jq._QMoment)
            assert np.abs(mu.codes.numpy().astype(int) - np.asarray(jmu.codes).astype(int)).max() <= 1
            assert np.abs(nu.codes.numpy().astype(int) - np.asarray(jnu.codes).astype(int)).max() <= 1
            np.testing.assert_allclose(mu.scale.numpy(), np.asarray(jmu.scale), rtol=1e-5)
            np.testing.assert_allclose(nu.scale.numpy(), np.asarray(jnu.scale), rtol=1e-5)
        else:
            np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-5, atol=1e-8)
            np.testing.assert_allclose(nu.numpy(), np.asarray(jnu), rtol=1e-5, atol=1e-10)
    assert [isinstance(m, tq.QMoment) for m in ts.mu] == [True, True, False]  # big, odd, small


def test_init_state_layout():
    leaves = [torch.zeros(4096), torch.zeros(16), torch.zeros((3, 1400))]
    st = tq.adamw_8bit(1e-3).init(leaves)
    assert st.count == 0
    assert isinstance(st.mu[0], tq.QMoment) and st.mu[0].codes.shape == (16, 256)
    assert st.mu[0].codes.dtype == torch.int8 and st.nu[0].codes.dtype == torch.uint8
    assert not isinstance(st.mu[1], tq.QMoment) and st.mu[1].dtype == torch.float32
    assert st.nu[2].codes.shape == (17, 256) and st.nu[2].scale.shape == (17, 1)


def test_schedule_not_ported_yet():
    """Schedules are ported now: a callable learning rate is read from the
    optimizer's own count of updates, before each update, as in JAX."""
    seen = []

    def schedule(count):
        seen.append(count)
        return 1e-2 * (count + 1)

    params = _tree(np.random.default_rng(2))
    keys = sorted(params)
    grads = [{k: np.ones_like(v) for k, v in params.items()} for _ in range(2)]
    jtx = jq.adamw_8bit(lambda c: 1e-2 * (c + 1), weight_decay=0.0)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    ttx = tq.adamw_8bit(schedule, weight_decay=0.0)
    tleaves = [_t(params[k]) for k in keys]
    ts = ttx.init(tleaves)
    for g in grads:
        jp, js = jtx.fused_apply(jax.tree.map(jnp.asarray, g), js, jp)
        ts = ttx.fused_apply([_t(g[k]) for k in keys], ts, tleaves)
    assert seen == [0, 1] and ttx.lr(5) == pytest.approx(6e-2)
    for k, leaf in zip(keys, tleaves):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=k)
