"""The port's flash attention against the reference's Pallas kernels on
the CPU.  The same numpy inputs go to both sides; the reference's kernels
run in interpret mode, as its own tests run them (``test_kernels.py``,
``test_flash_backward.py``).

Three things per case: the plain forward (o, lse) against
``_flash_fwd_call``; the plain dq, dk and dv against ``_flash_bwd_call``
with the same o, lse and do; and the gradients of the port's autograd
Function against ``jax.grad`` through the Pallas ``flash_attention``.

Tolerances.  f32: 1e-5 absolute plus 1e-5 relative, twenty times tighter
than the reference's own 5e-4 against its oracle; both sides compute the
same blocked f32 arithmetic and differ by summation order (about 1e-6
here).  bf16 outputs: both sides round the same f32 value to bf16, so
an element may land one bf16 step apart (2**-7 relative) where the f32
values straddle a rounding boundary, plus the f32 summation noise of
1e-5 absolute (where terms cancel, as dq's first causal row, one side
rounds to exactly 0 and the other to 1e-7); lse stays f32 at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.kernels import flash_attention as ref_fa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL_F32 = 1e-5
BF16_STEP = 2.0 ** -7

# (B, H, KV, S, d, causal, window, block, dtype): GQA (4,4), (4,2), (2,1);
# causal on and off; window 48 (its start inside a 64-block at S = 128);
# one block (S <= 128 clamps it) and two (block 64 at S = 128)
CASES = {
    "mha-causal-s64": (2, 4, 4, 64, 32, True, None, 128, "float32"),
    "gqa2-full-s128": (2, 4, 2, 128, 32, False, None, 128, "float32"),
    "mqa-window48-s128-blk64": (1, 2, 1, 128, 64, True, 48, 64, "float32"),
    "gqa2-causal-s128-blk64": (1, 4, 2, 128, 32, True, None, 64, "float32"),
    "mha-full-s64-d64": (1, 4, 4, 64, 64, False, None, 128, "float32"),
    "mqa-window48-s64": (1, 2, 1, 64, 32, True, 48, 128, "float32"),
    "gqa2-causal-s64-bf16": (1, 4, 2, 64, 32, True, None, 128, "bfloat16"),
}


def _inputs(case, seed=0):
    B, H, KV, S, d, causal, window, block, dtype = CASES[case]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, H, S, d), (B, KV, S, d), (B, KV, S, d),
                            (B, H, S, d))]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx = [jnp.asarray(a).astype(jdt) for a in arrays]
    tx = [torch.from_numpy(a).to(tdt) for a in arrays]
    return jx, tx, dict(causal=causal, window=window), block, dtype


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    if dtype == "bfloat16":
        err = np.abs(got - want)
        assert np.all(err <= BF16_STEP * np.abs(want) + TOL_F32), \
            (what, float(err.max()))
    else:
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32,
                                   err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_pallas_forward(case):
    (q, k, v, _), (tq, tk, tv, _), mask, block, dtype = _inputs(case)
    o, lse = ref_fa._flash_fwd_call(q, k, v, mask["causal"], mask["window"],
                                    block, block, True)
    got_o, got_lse = ref.flash_fwd_ref(tq, tk, tv, **mask, block_q=block,
                                       block_k=block)
    assert got_o.dtype == tq.dtype and got_lse.dtype == torch.float32
    _close(got_o, o, dtype, f"o {case}")
    _close(got_lse, lse, "float32", f"lse {case}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_pallas_backward(case):
    """dq, dk, dv from the reference's o, lse and the same do; delta is
    the port's, from o as saved in q's dtype."""
    (q, k, v, do), (tq, tk, tv, tdo), mask, block, dtype = _inputs(case)
    o, lse = ref_fa._flash_fwd_call(q, k, v, mask["causal"], mask["window"],
                                    block, block, True)
    dq, dk, dv = ref_fa._flash_bwd_call(q, k, v, o, lse, do, mask["causal"],
                                        mask["window"], block, block, True)
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).to(tq.dtype)
    tlse = torch.from_numpy(np.array(lse))
    delta = ref.flash_delta(to, tdo)
    kw = dict(mask, block_q=block, block_k=block)
    got_dq = ref.flash_dq_ref(tq, tk, tv, tdo, tlse, delta, **kw)
    got_dk, got_dv = ref.flash_dkv_ref(tq, tk, tv, tdo, tlse, delta, **kw)
    for name, got, want in (("dq", got_dq, dq), ("dk", got_dk, dk),
                            ("dv", got_dv, dv)):
        assert got.shape == tuple(want.shape) and got.dtype == tq.dtype
        _close(got, want, dtype, f"{name} {case}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_gradients_match_jax_grad_through_pallas(case):
    """loss = sum(o * w): the Function's forward and its backward (delta,
    the saved residuals, the group sum) on the CPU against jax.grad
    through the reference's custom VJP."""
    (q, k, v, w), (tq, tk, tv, tw), mask, block, dtype = _inputs(case)

    def loss(a, b, c):
        o = ref_fa.flash_attention(a, b, c, **mask, block_q=block,
                                   block_k=block, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = fa.flash_attention(*leaves, **mask)
    got = torch.autograd.grad((o.float() * tw.float()).sum(), leaves)
    for name, g, e in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tq.dtype
        _close(g, e, dtype, f"{name} {case}")


def test_supports_equals_reference():
    for S in (1, 16, 48, 64, 100, 128, 192, 256, 384, 2048):
        for d in (32, 64, 128):
            assert fa.supports(S, d) == ref_fa.supports(S, d), (S, d)


def test_naive_oracle_matches_reference_oracle():
    from repro.kernels import ref as ref_oracle
    (q, k, v, _), (tq, tk, tv, _), mask, _, _ = _inputs("mqa-window48-s64")
    want = ref_oracle.flash_attention_ref(q, k, v, **mask)
    got = ref.flash_attention_ref(tq, tk, tv, **mask)
    _close(got, want, "float32", "oracle")


def test_no_grad_runs_the_forward_only_and_saves_nothing():
    _, (tq, tk, tv, _), mask, _, _ = _inputs("gqa2-causal-s64-bf16")
    leaves = [t.float().requires_grad_() for t in (tq, tk, tv)]
    with torch.no_grad():
        o = fa.flash_attention(*leaves, **mask)
    assert o.grad_fn is None and not o.requires_grad
    with_graph = fa.flash_attention(*leaves, **mask)
    assert with_graph.grad_fn is not None
    assert torch.equal(o, with_graph.detach())


def test_a_create_graph_backward_through_the_function_raises():
    """The Function's backward is once differentiable: a
    ``create_graph=True`` backward (DLG's second derivative, here of a
    projection's gradient in the input) raises on the host's plain
    versions as the kernels would have to on the card, and the plain
    first-order backward still runs."""
    torch.manual_seed(0)
    x = torch.randn(1, 64, 8, requires_grad=True)
    w = torch.randn(8, 64, requires_grad=True)

    def loss():
        q = (x @ w).view(1, 64, 2, 32).transpose(1, 2)
        return (fa.flash_attention(q, q, q) ** 2).sum()

    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(loss(), (w,), create_graph=True)
    (gw,) = torch.autograd.grad(loss(), (w,))
    assert gw.shape == w.shape and not gw.requires_grad


def test_wrappers_refuse_what_the_kernels_do_not_take():
    _, (tq, tk, tv, _), _, _, _ = _inputs("mha-causal-s64")
    with pytest.raises(ValueError, match="implies causal"):
        fa.flash_attention(tq, tk, tv, causal=False, window=8)
    with pytest.raises(ValueError, match="is on meta"):
        fa.flash_fwd(tq, tk.to("meta"), tv)
    with pytest.raises(ValueError, match="no kernel for meta"):
        fa.flash_fwd(tq.to("meta"), tk.to("meta"), tv.to("meta"))
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_fwd(tq, tk[:, :3], tv[:, :3])


# ------------------------------------------ the tensor-core backward (bf16)
# (B, H, KV, S, d, causal, window): a d = 128 head at S = 64, qwen2-0.5b's
# 14 query heads over 2 at d = 64, a window of 48 over S = 256
TC_CASES = {
    "d128-s64": (1, 2, 2, 64, 128, True, None),
    "gqa7-d64-s64": (1, 14, 2, 64, 64, True, None),
    "window48-s256": (1, 2, 1, 256, 64, True, 48),
}


def _split(x):
    """x as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _tensor_core_backward(q, k, v, do, lse, delta, causal, window):
    """The arithmetic of the bf16 dq and dk/dv kernels
    (``csrc/flash_bwd_sm90.cu``): q unscaled in the products, s = scale
    (q . k) in f32 with scale = f32(d**-0.5), p and ds each entering the
    second products as two bf16 terms, dq and dk scaled once at the end,
    the group sum in f32 and one cast."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    scale = float(np.float32(d ** -0.5))
    qf, dof = q.float(), do.float()
    kf, vf = (t.float().repeat_interleave(G, 1) for t in (k, v))
    pos = torch.arange(S)
    s = ref._flash_mask(scale * (qf @ kf.transpose(-1, -2)), pos, pos,
                        causal, window)
    p = torch.exp(s - lse.view(B, H, S, 1))
    ds = p * (dof @ vf.transpose(-1, -2) - delta.view(B, H, S, 1))
    (p_hi, p_lo), (ds_hi, ds_lo) = _split(p), _split(ds)
    dq = scale * (ds_hi @ kf + ds_lo @ kf)
    dk = scale * (ds_hi.transpose(-1, -2) @ qf + ds_lo.transpose(-1, -2) @ qf)
    dv = p_hi.transpose(-1, -2) @ dof + p_lo.transpose(-1, -2) @ dof
    dk, dv = (t.view(B, -1, G, S, d).sum(2) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tc_inputs(case, cases=TC_CASES, seed=3):
    B, H, KV, S, d, causal, window = cases[case]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, H, S, d), (B, KV, S, d), (B, KV, S, d),
                            (B, H, S, d))]
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return jx, tx, dict(causal=causal, window=window)


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tensor_core_arithmetic_holds_one_bf16_step(case):
    """The bf16 kernels' arithmetic (the two-term p and ds) against the
    reference's ``_flash_bwd_call`` in interpret mode, at the card tests'
    and chip smoke's gate: 2**-7 |ref| + 1e-4, one bf16 step of the
    output (rounding p and ds once to bf16 breaks it)."""
    (q, k, v, do), (tq, tk, tv, tdo), mask = _tc_inputs(case)
    S = tq.shape[2]
    block = min(ref.FLASH_BLOCK, S)
    o, lse = ref_fa._flash_fwd_call(q, k, v, mask["causal"], mask["window"],
                                    block, block, True)
    want = ref_fa._flash_bwd_call(q, k, v, o, lse, do, mask["causal"],
                                  mask["window"], block, block, True)
    to = torch.from_numpy(np.array(o.astype(jnp.float32))).to(torch.bfloat16)
    tlse = torch.from_numpy(np.array(lse))
    got = _tensor_core_backward(tq, tk, tv, tdo, tlse,
                                ref.flash_delta(to, tdo), **mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == tuple(w.shape) and g.dtype == torch.bfloat16
        err = np.abs(_np(g) - _np(w))
        assert np.all(err <= BF16_STEP * np.abs(_np(w)) + 1e-4), \
            (name, case, float(err.max()))


def test_group_sum_matches_the_plain_group_sum():
    """``group_sum`` over per-query-head f32 partials (the bf16 dk/dv
    kernel's output for G > 1: here the plain version run with k and v
    repeated to every query head, in f32) against ``flash_dkv_ref``'s own
    sum over the group, at one bf16 step."""
    _, (tq, tk, tv, tdo), mask = _tc_inputs("gqa7-d64-s64")
    G = tq.shape[1] // tk.shape[1]
    o, lse = ref.flash_fwd_ref(tq, tk, tv, **mask)
    delta = ref.flash_delta(o, tdo)
    want = ref.flash_dkv_ref(tq, tk, tv, tdo, lse, delta, **mask)
    partials = ref.flash_dkv_ref(
        tq.float(), tk.float().repeat_interleave(G, 1),
        tv.float().repeat_interleave(G, 1), tdo.float(), lse, delta, **mask)
    for p, w in zip(partials, want):
        assert p.dtype == torch.float32 and p.shape == tq.shape
        got = fa.group_sum(p, torch.empty_like(w))
        assert got.dtype == w.dtype and got.shape == w.shape
        err = (got.float() - w.float()).abs()
        assert bool((err <= BF16_STEP * w.float().abs() + 1e-4).all()), \
            float(err.max())


# ------------------------------------------- the tensor-core forward (bf16)
# TC_CASES and a causal S = 512 at d = 128 (eight q-tiles over eight k-tiles)
FWD_CASES = {**TC_CASES, "d128-s512": (1, 2, 1, 512, 128, True, None)}
TILE = 64                                     # the kernel's q- and k-tiles


def _tensor_core_forward(q, k, v, causal, window, terms=2):
    """The arithmetic of the bf16 forward kernel (``csrc/flash_fwd_sm90.cu``):
    q unscaled in the product, s = scale (q . k) in f32 with
    scale = f32(d**-0.5), online softmax over 64-key tiles within the
    reference's lo/hi bounds (a masked key takes p = 0), p entering
    acc += P V as ``terms`` bf16 terms (hi = bf16(p), lo = bf16(p - hi)),
    o = acc / max(l, 1e-30) cast once, lse = m + log(max(l, 1e-30))."""
    B, H, S, d = q.shape
    G = H // k.shape[1]
    scale = float(np.float32(d ** -0.5))
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(G, 1) for t in (k, v))
    n = -(-S // TILE)
    o = torch.zeros(B, H, S, d)
    lse = torch.zeros(B, H, S)
    for qt in range(n):
        rows = torch.arange(qt * TILE, min(qt * TILE + TILE, S))
        hi = min(n, qt + 1) if causal else n
        lo = max(0, (qt * TILE - window + 1) // TILE) if window else 0
        m = torch.full((B, H, len(rows)), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, len(rows), d)
        for kt in range(lo, hi):
            cols = torch.arange(kt * TILE, min(kt * TILE + TILE, S))
            s = scale * (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2))
            seen = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                seen &= cols[None] <= rows[:, None]
            if window:
                seen &= cols[None] > rows[:, None] - window
            m_new = torch.maximum(m, torch.where(seen, s, -1e30).amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(seen, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            p_hi = p.to(torch.bfloat16).float()
            pv = p_hi @ vf[:, :, cols]
            if terms == 2:
                pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vf[:, :, cols]
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = l.clamp_min(1e-30)
        o[:, :, rows] = acc / l_safe[..., None]
        lse[:, :, rows] = m + torch.log(l_safe)
    return o.to(q.dtype), lse.reshape(B * H, S)


def _forward_gate_shares(case, terms):
    """The emulated forward against the reference's ``_flash_fwd_call`` in
    interpret mode: the largest error of o and of lse as a share of its
    gate (o: 2**-7 |ref| + 1e-4; lse: 1e-4 + 1e-4 |ref|)."""
    (q, k, v, _), (tq, tk, tv, _), mask = _tc_inputs(case, FWD_CASES)
    block = min(ref.FLASH_BLOCK, tq.shape[2])
    o, lse = ref_fa._flash_fwd_call(q, k, v, mask["causal"], mask["window"],
                                    block, block, True)
    got_o, got_lse = _tensor_core_forward(tq, tk, tv, **mask, terms=terms)
    assert got_o.dtype == torch.bfloat16 and got_o.shape == tq.shape
    o_err = np.abs(_np(got_o) - _np(o)) / (BF16_STEP * np.abs(_np(o)) + 1e-4)
    want_lse = np.asarray(lse, np.float64).reshape(got_lse.shape)
    lse_err = np.abs(_np(got_lse) - want_lse) / (1e-4 + 1e-4 * np.abs(want_lse))
    return float(o_err.max()), float(lse_err.max())


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_tensor_core_forward_arithmetic_holds_one_bf16_step(case):
    """The bf16 forward's arithmetic, p as two bf16 terms, holds the card's
    gate against the reference: o within one bf16 step, lse within
    1e-4 + 1e-4 |lse|."""
    o_share, lse_share = _forward_gate_shares(case, terms=2)
    assert o_share <= 1.0 and lse_share <= 1.0, (case, o_share, lse_share)


def test_one_bf16_term_of_p_breaks_the_forward_gate():
    """Why the kernel keeps two terms: p rounded once to bf16 misses the
    one-step gate on o many times over, even at S = 64."""
    o_share, _ = _forward_gate_shares("d128-s64", terms=1)
    assert o_share > 4.0, o_share
