"""jax's gamma family in the port (``repro_torch.random``: ``gamma``,
``loggamma``, ``exponential``, ``dirichlet``) and the original counter
layout past 2**32 - 1 counters, against jax on the CPU under both of
jax's layouts (``jax_threefry_partitionable`` True and False, set for
each case and restored after it).

The samplers run jax's Marsaglia-Tsang loop on the same keys, so every
element takes the same number of passes; the values go through ``log``,
``log1p``, ``pow``, ``exp`` and ``normal``, whose last bits differ
between XLA and torch.  The tolerances, each about three times the
largest error over 25 seeds of each alpha and layout:

* gamma: relative 3e-5 (the largest seen 1.2e-5, at alpha 1);
* loggamma: 2e-6 of max(|x|, 1) (a sum of logs that may cancel);
* dirichlet: relative 5e-5 (the largest seen 1.5e-5, alpha 0.05, where
  the softmax takes log-gammas near -190);
* exponential: 4 ulps of max(x, 1);
* zeros equal: XLA flushes subnormal results, and so does the port.

An accept test that one ulp flips would show as an element far outside
these bounds: no seed here flips one.  The block layout is held bit for
bit to an oracle built from jax's own ``threefry_split`` and
``threefry_2x32`` on hand-built counter pairs, since jax cannot draw
2**32 elements here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from jax._src import prng as jax_prng  # noqa: E402

from repro_torch import random  # noqa: E402

ALPHAS = (0.05, 0.3, 1.0, 4.0)
GAMMA_RTOL, LOGGAMMA_TOL, DIRICHLET_RTOL, EXP_ULPS = 3e-5, 2e-6, 5e-5, 4
M = 2**32 - 1                       # counters one original block hashes


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request, monkeypatch):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    monkeypatch.setattr(random, "partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


def _rel_ok(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got == 0, want == 0)
    nz = want != 0
    assert (np.abs(got - want)[nz] <= rtol * np.abs(want[nz])).all(), \
        np.max(np.abs(got - want)[nz] / np.abs(want[nz]))


@pytest.mark.parametrize("alpha", ALPHAS)
def test_gamma_loggamma_dirichlet_within_tolerance_of_jax(layout, alpha):
    shape = (30, 40)
    for seed in (0, 11):
        key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
        _rel_ok(random.gamma(key, alpha, shape),
                jax.random.gamma(jkey, alpha, shape), GAMMA_RTOL)
        lg = random.loggamma(key, alpha, shape).numpy()
        jlg = np.asarray(jax.random.loggamma(jkey, alpha, shape))
        assert (np.abs(lg - jlg) <= LOGGAMMA_TOL *
                np.maximum(np.abs(jlg), 1)).all()
        a = alpha * np.ones(40, np.float32)
        d = random.dirichlet(key, torch.from_numpy(a), (30,))
        jd = jax.random.dirichlet(jkey, jnp.asarray(a), (30,))
        assert d.shape == (30, 40)
        _rel_ok(d, jd, DIRICHLET_RTOL)


def test_gamma_takes_an_alpha_per_element_and_a_batch_shape(layout):
    """alpha broadcast against ``shape`` (element i's own alpha on key i
    of the row-major split), a mixed alpha vector across the boost, and
    the default shape from alpha."""
    a = np.array([0.05, 0.5, 0.999, 1.0, 1.5, 30.0], np.float32)
    key, jkey = random.PRNGKey(5), jax.random.PRNGKey(5)
    _rel_ok(random.gamma(key, torch.from_numpy(a), (4, 6)),
            jax.random.gamma(jkey, jnp.asarray(a), (4, 6)), GAMMA_RTOL)
    _rel_ok(random.gamma(key, torch.from_numpy(a)),
            jax.random.gamma(jkey, jnp.asarray(a)), GAMMA_RTOL)
    da = np.array([[0.1, 2.0, 0.5], [3.0, 3.0, 0.05]], np.float32)
    _rel_ok(random.dirichlet(key, torch.from_numpy(da)),
            jax.random.dirichlet(jkey, jnp.asarray(da)), DIRICHLET_RTOL)


def test_exponential_within_ulps_of_jax(layout):
    key, jkey = random.PRNGKey(2), jax.random.PRNGKey(2)
    e = random.exponential(key, (5000,)).numpy()
    je = np.asarray(jax.random.exponential(jkey, (5000,)))
    ulp = np.spacing(np.maximum(je, 1).astype(np.float32))
    assert (np.abs(e - je) <= EXP_ULPS * ulp).all()


# ------------------------------------------- original layout's blocks
def _oracle_block_bits(jkey, n, idx):
    """Elements ``idx`` of the original layout's 32-bit draw of n >= M
    elements: jax's ``threefry_split`` into n // M + 1 keys, then for
    element i of block b (size M, the last n % M) jax's ``threefry_2x32``
    of the counter pair the layout gives it, computed one block at a
    time on just those pairs."""
    nblocks, rem = divmod(n, M)
    keys = jax_prng.threefry_split(jkey, (nblocks + 1,))
    idx = np.asarray(idx, np.int64)
    out = np.empty(idx.shape, np.uint64)
    for b in np.unique(idx // M):
        sel = idx // M == b
        j = idx[sel] - b * M
        size = M if b < nblocks else rem
        half = (size + 1) // 2
        first = j < half
        a = np.where(first, j, j - half)
        pair = np.where(a + half < size, a + half, 0)
        counters = jnp.asarray(np.concatenate([a, pair]).astype(np.uint32))
        y = np.asarray(jax_prng.threefry_2x32(keys[b], counters))
        y = y.astype(np.uint64)
        out[sel] = np.where(first, y[:len(a)], y[len(a):])
    return out


@pytest.mark.parametrize("n", [M, M + 1, 2 * M + 7, 4 * 1_816_565_760],
                         ids=["M", "M+1", "2M+7", "4-full-clients"])
def test_original_layout_blocks_equal_jax_oracle(monkeypatch, n):
    """Windows around each block edge and inside the last block, for a
    draw of exactly 2**32 - 1 (the block path with an empty last block),
    one more, two blocks and a few, and four full-width clients' LDP
    noise; ``bits`` bit for bit, ``normal`` as its bits through the
    port's own map, two half windows equal the whole."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    monkeypatch.setattr(random, "partitionable", False)
    try:
        key = random.fold_in(random.PRNGKey(3), 7)
        jkey = jax.random.fold_in(jax.random.PRNGKey(3), 7)
        windows = [(0, 5), (M // 2 - 3, M // 2 + 3), (M - 9, min(n, M + 9))]
        if n > 2 * M:
            windows += [(2 * M - 4, 2 * M + 3), (n - 6, n)]
        for lo, hi in windows:
            got = random.bits(key, (n,), window=(lo, hi))
            want = _oracle_block_bits(jkey, n, np.arange(lo, hi))
            np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
            mid = (lo + hi) // 2
            halves = torch.cat([random.bits(key, (n,), window=(lo, mid)),
                                random.bits(key, (n,), window=(mid, hi))])
            assert torch.equal(halves, got)
            u = random.uniform(key, (n,), window=(lo, hi))
            assert torch.equal(u, random._float_bits(got))
        # a (rows, cols) shape draws over its flat index
        rows = 4 if n % 4 == 0 else 1
        x = random.normal(key, (rows, n // rows), window=(M - 3, M + 3)) \
            if n > M + 3 else None
        if x is not None:
            assert torch.equal(x, random.normal(key, (n,),
                                                window=(M - 3, M + 3)))
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def test_original_layout_below_the_block_edge_is_one_hash(monkeypatch):
    """Just under 2**32 - 1 counters the draw is one ``threefry_2x32`` of
    ``iota(n)``, as before: its last pair pads with 0 at odd n."""
    monkeypatch.setattr(random, "partitionable", False)
    n = M - 1
    key, jkey = random.PRNGKey(4), jax.random.PRNGKey(4)
    j = np.array([0, 1, n // 2 - 1, n // 2, n - 1], np.int64)
    half = (n + 1) // 2
    first = j < half
    a = np.where(first, j, j - half)
    counters = jnp.asarray(np.concatenate([a, a + half]).astype(np.uint32))
    y = np.asarray(jax_prng.threefry_2x32(jkey, counters)).astype(np.int64)
    want = np.where(first, y[:len(a)], y[len(a):])
    got = torch.cat([random.bits(key, (n,), window=(int(i), int(i) + 1))
                     for i in j])
    np.testing.assert_array_equal(got.numpy(), want)
