"""The port's hand-written kernels against their plain twins on the card: one
home for each comparison and its limits.

``tests/test_torch_cuda.py`` (run with ``-m cuda``) calls these at small
shapes and at the main path's; ``chip_smoke.py`` calls them at the main
path's shapes before it times the kernels, and on large-v3's own leaves and
8-bit state after the main path's steps. Each check raises
``AssertionError`` past a limit and returns its largest errors, as a share
of the limit where the limit scales with the data.
"""

from __future__ import annotations

import torch

# Attention's limits, about 2.5x the worst error measured on an H100 over
# the main path's shapes: max |err| <= tol * max|ref| for o (worst 3.2e-3 of
# the peak; bf16 output, bf16 P) and dq, dk, dv (worst 4.5e-3; bf16 dS into
# the products). lse is float32 on both sides: absolute.
ATTN_TOL_O = 8e-3
ATTN_TOL_GRAD = 1.2e-2
ATTN_TOL_LSE = 1e-3

# The main path's attention at batch 2: the encoder's self-attention, the
# cross-attention and the decoder's causal self-attention.
ATTN_MAIN_SHAPES = ((2, 20, 1500, 1500, False), (2, 20, 448, 1500, False),
                    (2, 20, 448, 448, True))

# The layer norm's shapes: the encoder's rows of a 32-clip microbatch
# without and with deep SpecAugment's keep-vectors, and greedy's token step
# (8 rows, replayed in a CUDA graph).
LN_SHAPES = ((48000, 1280, False), (48000, 1280, True), (8, 1280, False))


def attention_heads(B: int, H: int, T: int, gen) -> torch.Tensor:
    """A bf16 (B, H, T, 64) tensor in the model's layout: a (B, T, H, 64)
    buffer seen through a transpose."""
    return torch.randn((B, T, H, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)


def _share(name: str, got, ref, tol: float) -> float:
    """max |got - ref| as a share of ``tol * max|ref|``; past 1 (or NaN) raises."""
    err, peak = (got.float() - ref).abs().max().item(), ref.abs().max().item()
    share = err / (tol * peak)
    assert share <= 1, f"{name}: max |err| {err} > {tol} * max|ref| {peak}"
    return share


def check_attention(B: int, H: int, Tq: int, Tk: int, causal: bool, with_lse: bool,
                    gen) -> dict:
    """``attn_fwd`` (with or without its log-sum-exp write) and, with it,
    ``attn_bwd`` against their float32 twins, each run twice on the same
    inputs: the forward has no atomics, so o and lse are bit-equal, as are dk
    and dv (sums in a fixed order); dq is summed over key tiles by bulk
    reductions in the order the hardware picks, so it is held to the
    gradients' limit. With the log-sum-exp, ``splash_mha``'s autograd too:
    each kernel launched once, its gradients within the same limit."""
    from whisper_finetune_torch.ops import attention as A

    scale = 64 ** -0.5
    q, k, v, do = (attention_heads(B, H, T, gen) for T in (Tq, Tk, Tk, Tq))
    qf, kf, vf = q.float(), k.float(), v.float()
    o, lse = A.attn_fwd(q, k, v, causal, scale, with_lse=with_lse)
    o2, lse2 = A.attn_fwd(q, k, v, causal, scale, with_lse=with_lse)
    assert torch.equal(o, o2), "attn_fwd: o differs between two runs"
    if not with_lse:
        assert lse is None and lse2 is None
        return {"o": _share("o", o, A.attn_fwd_nolse_plain(qf, kf, vf, causal, scale), ATTN_TOL_O)}
    assert torch.equal(lse, lse2), "attn_fwd: lse differs between two runs"
    o_r, lse_r = A.attn_fwd_plain(qf, kf, vf, causal, scale)
    out = {"o": _share("o", o, o_r, ATTN_TOL_O), "lse_max_abs": (lse - lse_r).abs().max().item()}
    assert out["lse_max_abs"] <= ATTN_TOL_LSE, out
    dq, dk, dv = A.attn_bwd(q, k, v, o, do, lse, causal, scale)
    dq2, dk2, dv2 = A.attn_bwd(q, k, v, o, do, lse, causal, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2), "attn_bwd: dk or dv differ between two runs"
    out["dq_between_runs"] = _share("dq between runs", dq2, dq.float(), ATTN_TOL_GRAD)
    refs = A.attn_bwd_plain(qf, kf, vf, o_r, do.float(), lse_r, causal, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        out[name] = _share(name, got, ref, ATTN_TOL_GRAD)
    counts = [fn.launches for fn in A.KERNELS]
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    A.splash_mha(qr, kr, vr, causal=causal, sm_scale=scale).backward(do)
    assert [fn.launches - c for fn, c in zip(A.KERNELS, counts)] == [1, 1]
    for name, got, ref in zip(("dq", "dk", "dv"), (qr.grad, kr.grad, vr.grad), refs):
        _share(f"splash_mha {name}", got, ref, ATTN_TOL_GRAD)
    return out


def check_adamw8(p, m_codes, m_scale, n_codes, n_scale, gen, steps: int = 3) -> dict:
    """``steps`` steps of ``fused_adamw8_leaf`` and of its plain twin from the
    same (p, moments' codes and scales), each on its own copy, with fresh
    bf16 gradients: the same operations in the same order on the same card's
    libm, no FMA contraction in the kernel, so every tensor bit-equal."""
    from whisper_finetune_torch.ops.fused_adamw8 import fused_adamw8_leaf, fused_adamw8_plain

    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    kern = [x.clone() for x in (p, m_codes, m_scale, n_codes, n_scale)]
    ref = [x.clone() for x in kern]
    gs = torch.tensor(0.5, device="cuda")
    for t in range(1, steps + 1):
        g = (torch.randn(p.shape, generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        fused_adamw8_leaf(kern[0], g, *kern[1:], 1e-3, c1, c2, gs, **hp)
        ref = list(fused_adamw8_plain(ref[0], g, *ref[1:], 1e-3, c1, c2, gs, **hp))
    names = ("p", "m_codes", "m_scale", "n_codes", "n_scale")
    differ = [n for n, a, b in zip(names, kern, ref) if not torch.equal(a, b)]
    assert not differ, f"fused_adamw8 against its twin, NB {p.shape[0]}: {differ} differ"
    return {"nb": p.shape[0], "m_codes_nonzero": int((m_codes != 0).sum().item())}


def check_adamw8_leaf(p, mu, nu, gen) -> dict:
    """:func:`check_adamw8` on copies of a model's leaf and its 8-bit moments
    (``optim.quantized.QMoment``) as the optimizer holds them."""
    from whisper_finetune_torch.optim.quantized import BLOCK

    return check_adamw8(p.detach().view(-1, BLOCK), mu.codes, mu.scale, nu.codes, nu.scale, gen)


def bf16_ulp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of the larger of |a| and |b|
    (8 significant bits), elementwise, float32."""
    m = torch.maximum(a.float().abs(), b.float().abs()).clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def layer_norm_inputs(gen, n: int, d: int, masks: bool):
    """x (n // T, T, d) bf16 with T = 1500 where it divides n (the encoder's
    rows), gamma and beta float32, dy bf16, keep-vectors from draws (bf16, as
    the model passes them)."""
    from whisper_finetune_torch.models.whisper import axis_keep_masks

    T = 1500 if n % 1500 == 0 else n
    x = (torch.randn((n // T, T, d), generator=gen, device="cuda") * 2 + 0.3).to(torch.bfloat16)
    w = 1 + 0.2 * torch.randn((d,), generator=gen, device="cuda")
    b = 0.1 * torch.randn((d,), generator=gen, device="cuda")
    dy = torch.randn((n // T, T, d), generator=gen, device="cuda").to(torch.bfloat16)
    tk = fk = None
    if masks:
        u = torch.rand((2, 1, 2), generator=gen, device="cuda").cpu().numpy()
        tk = torch.from_numpy(axis_keep_masks(u[0], T, min(100, T))[0]).cuda().to(torch.bfloat16)
        fk = torch.from_numpy(axis_keep_masks(u[1], d, 27)[0]).cuda().to(torch.bfloat16)
    return x, w, b, dy, tk, fk


def check_layer_norm(n: int, d: int, masks: bool, gen) -> dict:
    """``wft::layer_norm`` (one forward launch) and ``layer_norm_bwd`` (run
    twice) against their plain versions, the float32 composite on the card."""
    from whisper_finetune_torch.ops import layer_norm as LN

    x, w, b, dy, tk, fk = layer_norm_inputs(gen, n, d, masks)
    launches = [fn.launches for fn in LN.KERNELS]
    y, mean, rstd = LN.layer_norm_op(x, w, b, 1e-5, tk, fk)
    dx, dw, db = LN.layer_norm_bwd(dy, x, mean, rstd, w, b, tk, fk)
    dx2, dw2, db2 = LN.layer_norm_bwd(dy, x, mean, rstd, w, b, tk, fk)
    assert [fn.launches - c for fn, c in zip(LN.KERNELS, launches)] == [1, 2]
    y_r, mean_r, rstd_r = LN.layer_norm_fwd_plain(x, w, b, 1e-5, tk, fk)
    dx_r, dw_r, db_r = LN.layer_norm_bwd_plain(dy, x, mean_r, rstd_r, w, b, tk, fk)
    stat = x.shape[:-1] + (1,)
    xh = (x.float() - mean_r.view(stat)) * rstd_r.view(stat)
    g = dy.float() if not masks else (dy * fk * tk[:, None]).float()
    # The forward: float32 statistics and affine in another order, rounded
    # once to bf16: within one bf16 ulp, plus where xhat * gamma + beta
    # cancels toward 0 the float32 value's own error, which the statistics'
    # last bits move by ~1e-6 of the terms |xhat * gamma| and |gamma|
    # (allowed: 1e-5 of them). dx: float32 row sums over d in another order
    # (each ~d * 2**-24 of the largest term) before one rounding to bf16: one
    # bf16 ulp plus 1e-4 of the row's largest |dx|. dgamma, dbeta: float32
    # column sums over n rows, the kernel's in a tree of at most
    # n / (4 * blocks) + 4 + blocks sequential adds, the reference's in its
    # own: the error of either is below 1e-3 (n 96,000: ~2**-24 * 2,000 adds
    # ~ 1.2e-4) of the sum of the terms' magnitudes.
    limits = {
        "y": bf16_ulp(y, y_r) + 1e-5 * ((xh * w).abs() + w.abs()),
        "dx": bf16_ulp(dx, dx_r) + 1e-4 * dx_r.float().abs().amax(dim=-1, keepdim=True),
        "dgamma": 1e-3 * (g * xh).abs().sum(dim=(0, 1)) + 1e-6,
        "dbeta": 1e-3 * g.abs().sum(dim=(0, 1)) + 1e-6,
    }
    errs = {"y": (y.float() - y_r.float()).abs(), "dx": (dx.float() - dx_r.float()).abs(),
            "dgamma": (dw - dw_r).abs(), "dbeta": (db - db_r).abs()}
    out = {k: (errs[k] / limits[k]).max().item() for k in errs}
    past = [k for k, share in out.items() if not share <= 1]
    assert not past, f"layer_norm {n}x{d} keep={masks}: {past} past their limits: {out}"
    assert dw.dtype == torch.float32 and db.dtype == torch.float32
    if masks:
        assert torch.equal(y == 0, y_r == 0) and (y_r == 0).any(), "the keep-vectors' zeros"
    torch.testing.assert_close(mean, mean_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, rtol=1e-5, atol=0)
    # No atomics: the same bits every run.
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2) and torch.equal(db, db2), \
        "layer_norm_bwd: two runs differ"
    return out
