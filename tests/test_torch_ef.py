"""The dense compressors, error feedback and the dense DSC client step of
the port, against the reference's jitted functions on the CPU, with the
same keys (the port's threefry stream is jax's).

Compressors keyed by integer draws (RandP, QSGD, TopK, the int8 round
trip) are held to bits, as XLA compiles them: a division by a constant
is a multiply by its f32 reciprocal, and ``s + gamma * v`` one fused
multiply-add.  RandK ranks Gumbel scores, a few ulps from jax's, and is
held to bits on the test set.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.core import compressors as ref_comp  # noqa: E402
from repro.core import dsc as ref_dsc  # noqa: E402
from repro.core import error_feedback as ref_ef  # noqa: E402
from repro.core import fl as ref_fl  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.core import compressors as comp  # noqa: E402
from repro_torch.core import dsc, error_feedback, fl, pipeline  # noqa: E402

N = 10_007


def _pair(name):
    """(reference's, port's) compressor."""
    kinds = {
        "identity": lambda m: m.Identity(),
        "rand_p-0.25": lambda m: m.RandP(p=0.25),
        "rand_p-0.3": lambda m: m.RandP(p=0.3),
        "rand_k": lambda m: m.RandK(k=500),
        "qsgd-16": lambda m: m.QSGD(s=16),
        "qsgd-5": lambda m: m.QSGD(s=5),
        "top_k": lambda m: m.TopK(k=500),
        "int8-rand_p": lambda m: m.Int8RoundTrip(inner=m.RandP(p=0.3)),
        "int8-identity": lambda m: m.Int8RoundTrip(),
    }
    return kinds[name](ref_comp), kinds[name](comp)


def _vec(seed, n=N, zero=True):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if zero:
        x[256:512] = 0.0                      # a zero block
    return x


NAMES = ["identity", "rand_p-0.25", "rand_p-0.3", "rand_k", "qsgd-16",
         "qsgd-5", "top_k", "int8-rand_p", "int8-identity"]


@pytest.mark.parametrize("name", NAMES)
def test_compressor_equals_jitted_reference(name):
    rc, c = _pair(name)
    x = _vec(1)
    for seed in (0, 9):
        want = jax.jit(rc)(jax.random.PRNGKey(seed), jnp.asarray(x))
        got = c(random.PRNGKey(seed), torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_equal((c.omega(N), c.retention(N), c.unbiased),
                            (rc.omega(N), rc.retention(N), rc.unbiased))
    assert c.wire_bits(N) == float(rc.wire_bits(N))


def test_qsgd_of_zero_is_zero():
    z = comp.QSGD()(random.PRNGKey(0), torch.zeros(300))
    assert torch.equal(z, torch.zeros(300))


@pytest.mark.parametrize("name", ["top_k", "rand_p-0.3", "qsgd-16",
                                  "int8-rand_p"])
def test_ef_client_compress_equals_reference(name):
    """Two steps of error feedback over K = 3 clients: the transmitted v
    and the residuals e, bit for bit, as the reference's jitted
    ``client_compress``."""
    rc, c = _pair(name)
    K = 3
    g = np.stack([_vec(10 + k) for k in range(K)])
    state = error_feedback.init_state(K, N)
    ref_state = ref_ef.init_state(K, N)
    step = jax.jit(lambda st, g, key: ref_ef.client_compress(st, g, rc,
                                                             key))
    for t in range(2):
        want_v, ref_state = step(ref_state, jnp.asarray(g),
                                 jax.random.PRNGKey(t))
        v, state = error_feedback.client_compress(
            state, torch.from_numpy(g), c, random.PRNGKey(t))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(state.e.numpy(),
                                      np.asarray(ref_state.e))


@pytest.mark.parametrize("name", ["rand_p-0.3", "int8-rand_p", "qsgd-16",
                                  "top_k"])
def test_dsc_client_compress_equals_reference(name, monkeypatch):
    """The dense DSC client step over K = 3 clients, twice: v and the
    shifts bit for bit, RandP through the chunked path (CHUNK is cut to
    2048 coordinates), the others dense."""
    rc, c = _pair(name)
    K, gamma = 3, 0.37
    g = np.stack([_vec(20 + k) for k in range(K)])
    state = dsc.init_state(K, N)
    ref_state = ref_dsc.init_state(K, N)
    step = jax.jit(lambda st, g, key: ref_dsc.client_compress(
        st, g, rc, gamma, key))
    monkeypatch.setattr(random, "CHUNK", 2048)
    for t in range(2):
        want_v, s_new = step(ref_state, jnp.asarray(g), jax.random.PRNGKey(t))
        ref_state = ref_state._replace(s_clients=s_new)
        v, s = dsc.client_compress(state, torch.from_numpy(g), c, gamma,
                                   random.PRNGKey(t))
        assert s is state.s_clients
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_new))


# ------------------------------------------------------- the eris round
def _lsq(seed=0, K=3, n=40):
    """A least-squares problem over K clients: loss(w, (A, b))."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((K, 16, n)).astype(np.float32)
    b = rng.standard_normal((K, 16)).astype(np.float32)
    return a, b


def _ref_loss(p, batch):
    a, b = batch
    return jnp.mean((a @ p["w"] - b) ** 2)


def _loss(p, batch):
    a, b = batch
    return ((a @ p["w"] - b) ** 2).mean()


@pytest.mark.parametrize("int8", [False, True])
def test_eris_with_error_feedback_tracks_reference(int8):
    """eris with use_ef and TopK (on the int8 wire: the registry wraps it
    in Int8RoundTrip, as the reference's does), four rounds: x within
    1e-5 relative norm, the residual state allocated and moving."""
    a, b = _lsq()
    kw = dict(method="eris", K=3, A=4, lr=0.05, use_ef=True, int8_wire=int8)
    ref_run = ref_fl.FLRun(ref_fl.FLConfig(**kw, compressor=ref_comp.TopK(
        k=8)), {"w": jnp.zeros(40)}, _ref_loss)
    run = fl.FLRun(fl.FLConfig(**kw, compressor=comp.TopK(k=8)),
                   {"w": torch.zeros(40)}, _loss, device="cpu")
    stage = run.pipeline.compress[0]
    assert isinstance(stage, pipeline.EFCompress)
    assert isinstance(stage.compressor, comp.Int8RoundTrip) == int8
    assert run.state.dsc is None and run.state.ef.e.shape == (3, 40)
    for _ in range(4):
        ref_run.step((jnp.asarray(a), jnp.asarray(b)))
        run.step((torch.from_numpy(a), torch.from_numpy(b)))
        x, want = run.x.numpy(), np.asarray(ref_run.x)
        assert np.linalg.norm(x - want) <= 1e-5 * np.linalg.norm(want)
    assert run.state.ef.e.abs().sum() > 0
    np.testing.assert_allclose(run.state.ef.e.numpy(),
                               np.asarray(ref_run.ef.e), rtol=0, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_error_feedback_round_is_bit_identical(int8):
    """Given the same gradient (a loss whose gradient is the batch), two
    eris rounds with error feedback leave every client's residual bit for
    bit as the reference's jitted round leaves it (on the int8 wire, the
    residual subtracts q * scale rounded once, as XLA fuses it)."""
    g = np.random.default_rng(3).standard_normal((2, 3, N)).astype(
        np.float32)
    kw = dict(method="eris", K=3, A=4, lr=0.1, use_ef=True, int8_wire=int8)
    ref_run = ref_fl.FLRun(ref_fl.FLConfig(**kw, compressor=ref_comp.TopK(
        k=900)), {"w": jnp.zeros(N)}, lambda q, b: jnp.sum(q["w"] * b))
    run = fl.FLRun(fl.FLConfig(**kw, compressor=comp.TopK(k=900)),
                   {"w": torch.zeros(N)}, lambda q, b: (q["w"] * b).sum(),
                   device="cpu")
    for t in range(2):
        ref_run.step(jnp.asarray(g[t]))
        run.step(torch.from_numpy(g[t]))
        np.testing.assert_array_equal(run.state.ef.e.numpy(),
                                      np.asarray(ref_run.ef.e))


@pytest.mark.parametrize("int8", [False, True])
def test_dsc_window_equals_slice_of_whole(int8, monkeypatch):
    """A window [offset, offset + m) of one client's compression draws
    and rounds what the whole vector's compression gives there, as the
    chip smoke's replay of a full-width client relies on."""
    monkeypatch.setattr(random, "CHUNK", 1024)
    c = comp.RandP(p=0.3)
    c = comp.Int8RoundTrip(inner=c) if int8 else c
    g, s0 = torch.from_numpy(_vec(5)), torch.from_numpy(0.2 * _vec(6))
    key = random.PRNGKey(8)
    s_all = s0.clone()
    v_all = dsc.compress_client(s_all, g, c, 0.37, key)
    lo, hi = 2048, 2048 + 3000
    s_win = s0[lo:hi].clone()
    v_win = dsc.compress_client(s_win, g[lo:hi], c, 0.37, key, offset=lo,
                                n=N)
    assert torch.equal(v_win, v_all[lo:hi]) and torch.equal(s_win,
                                                            s_all[lo:hi])
    with pytest.raises(ValueError, match="whole vectors"):
        dsc.compress_client(s_win, g[lo:hi], comp.QSGD(), 0.37, key,
                            offset=lo, n=N)
