"""The port's threefry key stream (``repro_torch.random``) against
``jax.random`` on the CPU, under both of jax's counter layouts
(``jax_threefry_partitionable`` True and False, set for each case and
restored after it).

Integer draws, ``uniform`` and ``bernoulli`` are held to bits; ``gumbel``
and ``normal`` go through ``log`` and ``erfinv``, whose last bits differ
between XLA and torch, and are held to the ulp bounds stated below; a
``categorical`` draw is an argmax over Gumbel noise and is held to bits
on the test set.  The synthetic data (``repro_torch.data``) is held to
the reference's ``repro.data`` the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from jax._src import prng as jax_prng  # noqa: E402

from repro import data as ref_data  # noqa: E402
from repro_torch import data, random  # noqa: E402

SEEDS = (0, 42, 2**31 + 5)
FULL_N = 1_816_565_760      # eris-gptneo-1.3b's parameters: one client


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request, monkeypatch):
    """Both streams in one counter layout for the test, restored after."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    monkeypatch.setattr(random, "partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _f32_bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _ulps(a, b):
    """|a - b| in units of the f32 grid, for finite values of one sign."""
    return np.abs(_f32_bits(a).astype(np.int64) - _f32_bits(b))


# ------------------------------------------------------------------ keys
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_equal_jax(layout, seed):
    key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
    _eq(key, jkey)
    for num in (2, 5, (2, 3), 1):
        _eq(random.split(key, num), jax.random.split(jkey, num))
    for d in (0, 7, 2**31 + 3, 2**32 - 1):
        _eq(random.fold_in(key, d), jax.random.fold_in(jkey, d))
    # keys chain: split of a folded key of a split key
    k2 = random.split(random.fold_in(random.split(key)[1], 3), 3)[2]
    j2 = jax.random.split(jax.random.fold_in(jax.random.split(jkey)[1], 3),
                          3)[2]
    _eq(k2, j2)
    assert random.PRNGKey(2**40 + 7).tolist() == \
        np.asarray(jax.random.PRNGKey(2**40 + 7)).tolist()


def test_batched_keys_split_and_randint_equal_jax_vmap(layout):
    """A (B, 2) batch of keys splits and draws ``randint`` as jax's vmap
    over the keys does (the MIA audit's bootstrap)."""
    keys = random.split(random.PRNGKey(3), 7)
    jkeys = jax.random.split(jax.random.PRNGKey(3), 7)
    _eq(random.split(keys), jax.vmap(jax.random.split)(jkeys))
    _eq(random.split(keys, (2, 3)),
        jax.vmap(lambda k: jax.random.split(k, (2, 3)))(jkeys))
    _eq(random.randint(keys, (5,), 0, 11),
        jax.vmap(lambda k: jax.random.randint(k, (5,), 0, 11))(jkeys))


def test_threefry_hash_takes_ints_and_tensors():
    ints = random.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88,
                               0x85A308D3)
    t = random.threefry2x32(torch.tensor([0x13198A2E]),
                            torch.tensor([0x03707344]),
                            torch.tensor([0x243F6A88]),
                            torch.tensor([0x85A308D3]))
    assert ints == (int(t[0]), int(t[1]))
    # the Random123 known-answer vector for threefry2x32, 20 rounds
    assert ints == (0xC4923A9C, 0x483DF7A0)


# ------------------------------------------------------------ bulk draws
@pytest.mark.parametrize("shape", [(), (1,), (7,), (5, 9), (2**20 + 3,)],
                         ids=["scalar", "1", "odd", "2d", "2**20+3"])
def test_bits_uniform_bernoulli_equal_jax(layout, shape):
    seeds = SEEDS[:1] if shape == (2**20 + 3,) else SEEDS
    for seed in seeds:
        key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
        _eq(random.bits(key, shape),
            jax.random.bits(jkey, shape, dtype=jnp.uint32))
        _eq(_f32_bits(random.uniform(key, shape)),
            _f32_bits(jax.random.uniform(jkey, shape)))
        for p in (0.25, 0.3, 0.5):
            _eq(random.bernoulli(key, p, shape),
                jax.random.bernoulli(jkey, p, shape))


def test_uniform_bounds_and_tensor_p_equal_jax(layout):
    key, jkey = random.PRNGKey(3), jax.random.PRNGKey(3)
    for lo, hi in ((-3.3, 7.1), (0.1, 0.9), (2.5, 1e6)):
        _eq(_f32_bits(random.uniform(key, (1001,), lo, hi)),
            _f32_bits(jax.random.uniform(jkey, (1001,), minval=lo,
                                         maxval=hi)))
    p = np.random.default_rng(0).random((4, 33)).astype(np.float32)
    _eq(random.bernoulli(key, torch.from_numpy(p)),
        jax.random.bernoulli(jkey, jnp.asarray(p)))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_equal_jax(layout, seed):
    key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape in ((), (7,), (5, 9), (4096,)):
        for lo, hi in ((0, 10), (-5, 100003), (0, 2**31 - 1), (3, 3),
                       (-2**31, 2**31 - 1)):
            _eq(random.randint(key, shape, lo, hi),
                jax.random.randint(jkey, shape, lo, hi))


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 2000, 2**20 + 3])
def test_permutation_equal_jax(layout, n):
    """jax's shuffle: one sort round up to 1625 elements, two above."""
    for seed in (SEEDS[:1] if n > 2000 else SEEDS):
        key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
        _eq(random.permutation(key, n), jax.random.permutation(jkey, n))
    x = np.arange(37) * 3 - 50
    _eq(random.permutation(key, torch.from_numpy(x)),
        jax.random.permutation(jkey, jnp.asarray(x)))


def test_choice_with_p_equal_jax(layout):
    rng = np.random.default_rng(1)
    for seed in SEEDS:
        key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
        for a in (1, 17, 1000):
            p = rng.random(a).astype(np.float32)
            p[::5] = 0.0 if a > 1 else p[::5]       # plateaus in the sums
            p /= p.sum()
            for shape in ((), (7,), (3, 50)):
                _eq(random.choice(key, a, shape, p=torch.from_numpy(p)),
                    jax.random.choice(jkey, a, shape, p=jnp.asarray(p)))


def test_xla_order_sums_equal_jax():
    """The blocked cumulative sum and the windowed sum of XLA's CPU
    compiler, bit for bit, at lengths around their block sizes."""
    rng = np.random.default_rng(2)
    for n in (1, 2, 15, 16, 17, 31, 32, 33, 256, 257, 1000, 50257, 70001):
        x = (rng.random(n) * rng.choice([1, 1e3, 1e-3], n)).astype(
            np.float32)
        _eq(_f32_bits(random.cumsum(torch.from_numpy(x))),
            _f32_bits(jnp.cumsum(jnp.asarray(x))))
        _eq(_f32_bits(random.reduce_sum(torch.from_numpy(x))),
            _f32_bits(jnp.sum(jnp.asarray(x))))
    x = rng.random((3, 1000)).astype(np.float32)
    _eq(_f32_bits(random.cumsum(torch.from_numpy(x))),
        _f32_bits(jnp.cumsum(jnp.asarray(x), axis=-1)))


# --------------------------------------------------------- large draws
def test_window_near_full_width_equals_jax_threefry(layout, monkeypatch):
    """A window of a draw of eris-gptneo-1.3b's n = 1,816,565,760 (one
    client's RandP mask), against jax's ``threefry_2x32`` on the same
    counters, so that jax never draws 1.8e9 elements: the partitionable
    layout hashes (i >> 32, i & 0xFFFFFFFF) and xors the words; the
    original pairs i with i - ceil(n / 2) past the half and keeps the
    second word.  The window allocates nothing n-sized."""
    lo, hi = 1_800_000_000, 1_800_000_000 + 4099
    key = random.fold_in(random.PRNGKey(7), 3)
    jkey = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    largest = []
    arange = torch.arange

    def spy(*a, **k):
        out = arange(*a, **k)
        largest.append(out.numel())
        return out

    monkeypatch.setattr(torch, "arange", spy)
    got = random.bits(key, (FULL_N,), window=(lo, hi))
    keep = random.bernoulli(key, 0.25, (FULL_N,), window=(lo, hi))
    monkeypatch.setattr(torch, "arange", arange)
    assert max(largest) == hi - lo
    i = np.arange(lo, hi, dtype=np.uint64)
    if layout:
        counters = np.concatenate([i >> 32, i & 0xFFFFFFFF])
        y = np.asarray(jax_prng.threefry_2x32(jkey, jnp.asarray(
            counters.astype(np.uint32))))
        want = y[:hi - lo] ^ y[hi - lo:]
    else:
        half = (FULL_N + 1) // 2
        counters = np.concatenate([i - half, i])
        want = np.asarray(jax_prng.threefry_2x32(jkey, jnp.asarray(
            counters.astype(np.uint32))))[hi - lo:]
    _eq(got, want)
    u = ((want.astype(np.uint32) >> 9) | 0x3F800000).view(np.float32) - 1
    _eq(keep, u < np.float32(0.25))


def test_chunked_draws_equal_one_piece(layout, monkeypatch):
    key = random.PRNGKey(11)
    whole = [random.bits(key, (10_007,)), random.uniform(key, (10_007,)),
             random.bernoulli(key, 0.3, (10_007,))]
    monkeypatch.setattr(random, "CHUNK", 1000)
    chunked = [random.bits(key, (10_007,)), random.uniform(key, (10_007,)),
               random.bernoulli(key, 0.3, (10_007,))]
    windows = [torch.cat([f(key, (10_007,), window=(lo, min(10_007,
                                                             lo + 777)))
                          for lo in range(0, 10_007, 777)])
               for f in (random.bits, random.uniform)]
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    for a, b in zip(whole, windows):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="outside a draw"):
        random.bits(key, (10,), window=(5, 11))


def test_randint_and_normal_windows_equal_the_whole_draw(layout):
    """``randint`` and ``normal`` over a flat window of a (3, 4099) draw:
    the whole draw's slice (bits for both: the same computation), and
    jax's full draw of that shape (bits for randint, the ulp bound below
    for normal), whatever the window."""
    shape, L = (3, 4099), 819_200
    n = shape[0] * shape[1]
    key, jkey = random.PRNGKey(9), jax.random.PRNGKey(9)
    whole_i = random.randint(key, shape, -L, L).reshape(-1)
    whole_x = random.normal(key, shape).reshape(-1)
    want_i = np.asarray(jax.random.randint(jkey, shape, -L, L)).reshape(-1)
    want_x = np.asarray(jax.random.normal(jkey, shape)).reshape(-1)
    _eq(whole_i, want_i)
    for lo, hi in ((0, 1), (4090, 4110), (n // 3 - 5, n // 3 + 777),
                   (n - 10, n), (0, n)):
        got_i = random.randint(key, shape, -L, L, window=(lo, hi))
        got_x = random.normal(key, shape, window=(lo, hi))
        assert torch.equal(got_i, whole_i[lo:hi])
        assert torch.equal(got_x, whole_x[lo:hi])
        _eq(got_i, want_i[lo:hi])
        assert _ulps(got_x.numpy(), want_x[lo:hi]).max() <= NORMAL_ULPS


def test_randint_and_normal_windows_straddle_2_32(layout):
    """A window across index 2**32 of a (4, 1,816,565,760) draw (the LDP
    noise of four full-width clients), against jax's ``threefry_2x32`` on
    the same counters (jax cannot draw 7.3e9 elements here) folded by
    randint's formula, and for normal the bits through jax's own
    uniform and ``erf_inv``; two half windows equal the whole.  In the
    original layout the window also crosses the first block edge
    (2**32 - 1 counters): each block's key is jax's ``threefry_split``
    of the key into n // (2**32 - 1) + 1, and each block hashes its own
    ``iota``."""
    shape, L = (4, FULL_N), 819_200
    lo, hi = 2**32 - 2000, 2**32 + 2099
    key, jkey = random.fold_in(random.PRNGKey(3), 7), \
        jax.random.fold_in(jax.random.PRNGKey(3), 7)
    i = np.arange(lo, hi, dtype=np.uint64)
    M = 2**32 - 1

    def jbits(k):
        if layout:
            counters = jnp.asarray(np.concatenate(
                [i >> 32, i & 0xFFFFFFFF]).astype(np.uint32))
            y = np.asarray(jax_prng.threefry_2x32(k, counters)).astype(
                np.uint64)
            return y[:hi - lo] ^ y[hi - lo:]
        n = 4 * FULL_N
        keys = jax_prng.threefry_split(k, (n // M + 1,))
        out = np.empty(hi - lo, np.uint64)
        for b in np.unique(i // M):
            sel = i // M == b
            j = (i[sel] - b * M).astype(np.int64)
            size = M if b < n // M else n % M
            half = (size + 1) // 2
            first = j < half
            a = np.where(first, j, j - half)
            pair = np.where(a + half < size, a + half, 0)
            y = np.asarray(jax_prng.threefry_2x32(keys[int(b)], jnp.asarray(
                np.concatenate([a, pair]).astype(np.uint32)))).astype(
                    np.uint64)
            out[sel] = np.where(first, y[:len(a)], y[len(a):])
        return out

    k1, k2 = jax.random.split(jkey)
    span = 2 * L
    mult = (2**16 % span) ** 2 % 2**32 % span
    want_i = ((jbits(k1) % span * mult % 2**32 + jbits(k2) % span) % 2**32
              % span).astype(np.int64) - L
    got_i = random.randint(key, shape, -L, L, window=(lo, hi))
    _eq(got_i, want_i)
    mid = (lo + hi) // 2
    assert torch.equal(torch.cat([
        random.randint(key, shape, -L, L, window=(lo, mid)),
        random.randint(key, shape, -L, L, window=(mid, hi))]), got_i)
    low = np.nextafter(np.float32(-1), np.float32(0))

    @jax.jit
    def jnormal(b):
        f = jax.lax.bitcast_convert_type(
            (b >> 9) | np.uint32(0x3F800000), jnp.float32) - 1.0
        u = jnp.maximum(low, f * (np.float32(1) - low) + low)
        return np.float32(np.sqrt(2)) * jax.lax.erf_inv(u)

    want_x = np.asarray(jnormal(jnp.asarray(jbits(jkey).astype(np.uint32))))
    got_x = random.normal(key, shape, window=(lo, hi))
    assert _ulps(got_x.numpy(), want_x).max() <= NORMAL_ULPS
    assert torch.equal(torch.cat([
        random.normal(key, shape, window=(lo, mid)),
        random.normal(key, shape, window=(mid, hi))]), got_x)


# ----------------------------------------------- floating-point draws
# gumbel: -log(-log(u)), both logs a last bit from XLA's; |g| up to ~16,
# and where g crosses 0 the relative error grows, so the bound is in ulps
# of max(|g|, 1).  normal: sqrt(2) erfinv(u), XLA's erfinv polynomial
# over torch's log1p.
GUMBEL_ULPS, NORMAL_ULPS = 8, 4


def test_gumbel_and_normal_within_ulps_of_jax(layout):
    for seed in SEEDS:
        key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
        g = random.gumbel(key, (20_000,)).numpy()
        jg = np.asarray(jax.random.gumbel(jkey, (20_000,)))
        ulp = np.spacing(np.maximum(np.abs(jg), 1).astype(np.float32))
        assert np.all(np.abs(g - jg) <= GUMBEL_ULPS * ulp)
        x = random.normal(key, (20_000,)).numpy()
        jx = np.asarray(jax.random.normal(jkey, (20_000,)))
        assert np.all(np.sign(x) == np.sign(jx))
        assert _ulps(x, jx).max() <= NORMAL_ULPS


def test_categorical_equals_jax(layout):
    logits = np.random.default_rng(1).standard_normal((4, 300)).astype(
        np.float32)
    for seed in SEEDS:
        key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
        _eq(random.categorical(key, torch.from_numpy(logits)),
            jax.random.categorical(jkey, jnp.asarray(logits)))
        keys = jax.random.split(jkey, 4)
        _eq(random.categorical(torch.from_numpy(np.asarray(keys).astype(
            np.int64)), torch.from_numpy(logits)),
            jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits)))


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("vocab", [96, 50257])
def test_lm_token_batches_equal_reference(layout, vocab):
    """Zipf tokens: ``powf`` per rank, XLA's sum and cumsum, choice and
    the coin, token for token."""
    for seed in (0, 5):
        key = random.fold_in(random.PRNGKey(seed), 1)
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        got = data.lm_token_batches(key, 4, 4, 64, vocab)
        _eq(got, ref_data.lm_token_batches(jkey, 4, 4, 64, vocab))
        assert got.dtype == torch.int32


def test_classification_equals_reference(layout):
    """Labels and the IID split's indices bit for bit; features within
    the normal draws' ulps (2.0 and 0.5 scale them, the centers add)."""
    key, jkey = random.PRNGKey(3), jax.random.PRNGKey(3)
    x, y = data.make_classification(key, 500, 16, 4)
    rx, ry = ref_data.synthetic.make_classification(jkey, 500, 16, 4)
    _eq(y, ry)
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=0, atol=4e-6)
    x, y = data.federated_classification(key, 3, 20)
    rx, ry = ref_data.federated_classification(jkey, 3, 20)
    assert x.shape == (3, 20, 16)
    _eq(y, ry)
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=0, atol=4e-6)
    # the Dirichlet split (tests/test_torch_data.py holds it in full)
    x, y = data.federated_classification(key, 3, 20, alpha=0.5)
    rx, ry = ref_data.federated_classification(jkey, 3, 20, alpha=0.5)
    _eq(y, ry)
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=0, atol=4e-6)
