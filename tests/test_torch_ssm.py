"""The recurrent mixers (``repro_torch/models/ssm.py``) against the
reference's ``repro/models/ssm.py`` on the CPU, from the same numpy
inputs.

The reference runs under ``jax.jit`` (eager dispatch compiles each
call's ops one by one, ten times slower here).  ``associative_scan``
combines in jax's tree: a sum scan (no fused multiply-add to differ) is
equal bit for bit at nine lengths from 1 to 33.
``ssm_scan`` at the reference tests' (T, chunk) cases, padding included:
f32 y and h_final within 1e-6 relative norm (torch's sums and XLA's
fused multiply-adds differ in the last bits); bf16 inputs with
``scan_f32`` on and off, y within 1e-6 and h within 1e-6 (in practice
equal but for a few f32 bits).  ``mlstm_parallel`` with ``scores_f32`` on
and off: f32 within 1e-6 (softplus, log-sigmoid and the cumulative sum
differ in the last bits), bf16 within 1e-6.  The decode steps within
1e-6, the first mLSTM step from m = -1e30 included (its decay is exactly
0, not NaN).  The gradients of ``ssm_scan`` and ``mlstm_parallel``
against ``jax.grad`` within 1e-5 relative norm.  Past ~128 steps the
reference's mLSTM gradient is NaN (an overflowing exponent in the
masked pairs); the port's is finite there and equals the gradient of the
recurrent form within 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

F32_RTOL, BF16_RTOL, GRAD_RTOL, LONG_GRAD_RTOL = 1e-6, 1e-6, 1e-5, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _ssm_inputs(T, seed=0, Bt=2, Di=6, N=4):
    """u, dt (softplus of a normal), B, C, A_log, D_skip as the reference
    tests draw them, from numpy."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((Bt, T, Di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, T, Di)))).astype(
        np.float32)
    B = rng.standard_normal((Bt, T, N)).astype(np.float32)
    C = rng.standard_normal((Bt, T, N)).astype(np.float32)
    A_log = (0.5 * rng.standard_normal((Di, N))).astype(np.float32)
    D_skip = np.full(Di, 0.3, np.float32)
    return u, dt, B, C, A_log, D_skip


def _mlstm_inputs(T, seed=1, B=2, H=3, hd=8, f_shift=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((B, T, H)).astype(np.float32)
    f_pre = (rng.standard_normal((B, T, H)) + f_shift).astype(np.float32)
    return q, k, v, i_pre, f_pre


# ------------------------------------------------------- associative scan
def test_associative_scan_combines_in_jaxs_tree():
    rng = np.random.default_rng(2)
    scan = jax.jit(lambda x, y: jax.lax.associative_scan(
        lambda a, b: (a[0] + b[0], a[1] * b[1]), (x, y), axis=1))
    for n in (1, 2, 3, 5, 8, 13, 16, 17, 33):
        x = rng.standard_normal((3, n)).astype(np.float32)
        y = rng.standard_normal((3, n)).astype(np.float32)
        want = scan(jnp.asarray(x), jnp.asarray(y))
        got = ssm.associative_scan(lambda a, b: [a[0] + b[0], a[1] * b[1]],
                                   [_t(x), _t(y)], 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"n={n}")


# ---------------------------------------------------------------- ssm scan
SCAN_CASES = [(32, 32, "float32", True), (64, 16, "float32", True),
              (33, 8, "float32", True), (17, 32, "float32", True),
              (33, 8, "bfloat16", True), (33, 8, "bfloat16", False)]


@pytest.mark.parametrize("T,chunk,dtype,scan_f32", SCAN_CASES)
def test_ssm_scan_matches_reference(T, chunk, dtype, scan_f32):
    u, dt, B, C, A_log, D_skip = _ssm_inputs(T)
    want_y, want_h = jax.jit(functools.partial(
        ref_ssm.ssm_scan, chunk=chunk, scan_f32=scan_f32))(
        *(_j(a, dtype) for a in (u, dt, B, C)), _j(A_log), _j(D_skip))
    y, h = ssm.ssm_scan(*(_t(a, dtype) for a in (u, dt, B, C)), _t(A_log),
                        _t(D_skip), chunk=chunk, scan_f32=scan_f32)
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    assert tuple(y.shape) == u.shape and tuple(h.shape) == want_h.shape
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    assert _rel(y.float().numpy(), _np(want_y)) < tol
    assert _rel(h.numpy(), _np(want_h)) < tol


def test_ssm_scan_gradient_matches_reference():
    """d/d(every input) of sum(y * wy) + sum(h_final * wh), T = 33 over
    chunks of 8 (a padded last chunk)."""
    args = _ssm_inputs(33, seed=3)
    rng = np.random.default_rng(4)
    wy = rng.standard_normal(args[0].shape).astype(np.float32)
    wh = rng.standard_normal((2, 6, 4)).astype(np.float32)

    def ref_obj(*a):
        y, h = ref_ssm.ssm_scan(*a, chunk=8)
        return (y * wy).sum() + (h * wh).sum()

    want = jax.jit(jax.grad(ref_obj, argnums=tuple(range(6))))(
        *(jnp.asarray(a) for a in args))
    leaves = [_t(a).requires_grad_() for a in args]
    y, h = ssm.ssm_scan(*leaves, chunk=8)
    got = torch.autograd.grad((y * _t(wy)).sum() + (h * _t(wh)).sum(),
                              leaves)
    for name, g, w in zip(("u", "dt", "B", "C", "A_log", "D_skip"), got,
                          want):
        assert _rel(g.numpy(), _np(w)) < GRAD_RTOL, name


def test_ssm_decode_step_matches_reference():
    u, dt, B, C, A_log, D_skip = _ssm_inputs(4, seed=5)
    h_ref = jnp.zeros((2, 6, 4))
    h = torch.zeros(2, 6, 4)
    for t in range(4):
        h_ref, y_ref = ref_ssm.ssm_decode_step(
            h_ref, *(jnp.asarray(a[:, t]) for a in (u, dt, B, C)),
            jnp.asarray(A_log), jnp.asarray(D_skip))
        h, y = ssm.ssm_decode_step(h, *(_t(a[:, t]) for a in (u, dt, B, C)),
                                   _t(A_log), _t(D_skip))
        assert _rel(y.numpy(), _np(y_ref)) < F32_RTOL, t
        assert _rel(h.numpy(), _np(h_ref)) < F32_RTOL, t


# ------------------------------------------------------------------- mLSTM
MLSTM_CASES = [(16, 16, "float32", True), (33, 8, "float32", True),
               (33, 8, "bfloat16", True), (33, 8, "bfloat16", False)]


@pytest.mark.parametrize("T,chunk,dtype,scores_f32", MLSTM_CASES)
def test_mlstm_parallel_matches_reference(T, chunk, dtype, scores_f32):
    args = _mlstm_inputs(T)
    want = jax.jit(functools.partial(
        ref_ssm.mlstm_parallel, chunk=chunk, scores_f32=scores_f32))(
        *(_j(a, dtype) for a in args))
    got = ssm.mlstm_parallel(*(_t(a, dtype) for a in args), chunk=chunk,
                             scores_f32=scores_f32)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_RTOL if dtype == "float32" else BF16_RTOL
    assert _rel(got.float().numpy(), _np(want)) < tol


def test_mlstm_parallel_gradient_matches_reference():
    args = _mlstm_inputs(33, seed=6)
    w = np.random.default_rng(7).standard_normal(args[0].shape).astype(
        np.float32)
    want = jax.jit(jax.grad(
        lambda *a: (ref_ssm.mlstm_parallel(*a, chunk=8) * w).sum(),
        argnums=tuple(range(5))))(*(jnp.asarray(a) for a in args))
    leaves = [_t(a).requires_grad_() for a in args]
    got = torch.autograd.grad(
        (ssm.mlstm_parallel(*leaves, chunk=8) * _t(w)).sum(), leaves)
    for name, g, wg in zip(("q", "k", "v", "i_pre", "f_pre"), got, want):
        assert _rel(g.numpy(), _np(wg)) < GRAD_RTOL, name


def test_mlstm_decode_step_matches_reference_from_the_empty_state():
    q, k, v, i_pre, f_pre = _mlstm_inputs(4, seed=8)
    B, _, H, hd = q.shape
    ref_st = {"C": jnp.zeros((B, H, hd, hd)), "n": jnp.zeros((B, H, hd)),
              "m": jnp.full((B, H), -1e30)}
    st = {"C": torch.zeros(B, H, hd, hd), "n": torch.zeros(B, H, hd),
          "m": torch.full((B, H), -1e30)}
    for t in range(4):
        ref_st, h_ref = ref_ssm.mlstm_decode_step(
            ref_st, *(jnp.asarray(a[:, t]) for a in (q, k, v, i_pre, f_pre)))
        st, h = ssm.mlstm_decode_step(
            st, *(_t(a[:, t]) for a in (q, k, v, i_pre, f_pre)))
        for name in ("C", "n", "m"):
            assert bool(st[name].isfinite().all()), (t, name)
            assert _rel(st[name].numpy(), _np(ref_st[name])) < F32_RTOL, \
                (t, name)
        assert _rel(h.numpy(), _np(h_ref)) < F32_RTOL, t
        if t == 0:
            # from m = -1e30 the old state's weight is exactly 0
            np.testing.assert_array_equal(st["m"].numpy(), i_pre[:, 0])


def test_mlstm_long_sequence_gradient_is_finite_and_recurrent():
    """At T = 160 with open forget gates (f ~ N(0, 1), the init's b_f =
    0) exp(b_s - m_t) overflows in the masked pairs: the reference's
    gradient holds NaNs, the port's is finite and equals the gradient of
    the same outputs computed by ``mlstm_decode_step`` step by step."""
    T = 160
    args = _mlstm_inputs(T, seed=9, B=1, H=2, hd=4, f_shift=0.0)
    w = np.random.default_rng(10).standard_normal(args[0].shape).astype(
        np.float32)
    ref_g = jax.jit(jax.grad(
        lambda *a: (ref_ssm.mlstm_parallel(*a, chunk=T) * w).sum(),
        argnums=(0, 3)))(*(jnp.asarray(a) for a in args))
    assert not all(bool(jnp.isfinite(g).all()) for g in ref_g)

    leaves = [_t(a).requires_grad_() for a in args]
    par = torch.autograd.grad(
        (ssm.mlstm_parallel(*leaves, chunk=64) * _t(w)).sum(), leaves)
    st = {"C": torch.zeros(1, 2, 4, 4), "n": torch.zeros(1, 2, 4),
          "m": torch.full((1, 2), -1e30)}
    outs = []
    for t in range(T):
        st, h = ssm.mlstm_decode_step(st, *(x[:, t] for x in leaves))
        outs.append(h)
    rec = torch.autograd.grad((torch.stack(outs, 1) * _t(w)).sum(), leaves)
    for name, g, r in zip(("q", "k", "v", "i_pre", "f_pre"), par, rec):
        assert bool(g.isfinite().all()), name
        assert _rel(g.numpy(), r.numpy()) < LONG_GRAD_RTOL, name
