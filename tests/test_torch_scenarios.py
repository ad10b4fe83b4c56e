"""The port's scenario pack against the reference, on the CPU: the
defense x failure matrix (``rounds.scenarios``), the RDP accountant,
secure aggregation and its pairwise masks, failure injection, PriPrune's
withholding and ShatterLite, with the reference's int32 index wraps at
full width.

Given the same transmitted vectors, the stages are held to bits where
the reference's arithmetic is exact or copied (the pairwise masks and
secure aggregation's mean, PriPrune's threshold and zeros), within the
ulps of ``normal`` and the norm for LDP noise, and within 1e-6 relative
norm for the aggregates that sum clients in another order (shatter,
failure injection).  Every feasible cell's three-round trajectory is
held to 1e-5 relative norm; every infeasible one raises the reference's
error.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.core import accountant as ref_acct  # noqa: E402
from repro.core import baselines as ref_bl  # noqa: E402
from repro.core import fl as ref_fl  # noqa: E402
from repro.core import fsa as ref_fsa  # noqa: E402
from repro.core import masks as ref_masks  # noqa: E402
from repro.core import pipeline as ref_pl  # noqa: E402
from repro.core import secure_agg as ref_sa  # noqa: E402
from repro.core.compressors import RandP as RefRandP  # noqa: E402
from repro.core.rounds import scenarios as ref_sc  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.core import accountant as acct  # noqa: E402
from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.core import fl, fsa, masks  # noqa: E402
from repro_torch.core import pipeline as pl  # noqa: E402
from repro_torch.core import secure_agg as sa  # noqa: E402
from repro_torch.core.compressors import RandP  # noqa: E402
from repro_torch.core.rounds import scenarios as sc  # noqa: E402

K, N = 6, 40
FULL_N = 1_816_565_760      # eris-gptneo-1.3b's parameters
QWEN_N = 494_032_768        # qwen2-0.5b's


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _f32_bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _keys(seed):
    return (pl.split_round_keys(random.PRNGKey(seed)),
            ref_pl.split_round_keys(jax.random.PRNGKey(seed)))


def _updates(seed, k=K, n=N, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(
        (k, n))).astype(np.float32)


# ------------------------------------------------------- the matrix
CELLS = [c.name for c in ref_sc.scenario_matrix(feasible_only=False)]


def test_matrix_equals_reference():
    cells = sc.scenario_matrix(feasible_only=False)
    assert [c.name for c in cells] == CELLS and len(cells) == 18
    assert len(sc.scenario_matrix()) == 15
    for cell in cells:
        ref = ref_sc.get(cell.name)
        assert (cell.feasible, cell.refusal, cell.q, cell.int8) == \
            (ref.feasible, ref.refusal, ref.q, ref.int8)
        assert sorted(cell.knobs) == sorted(ref.knobs)
        for n in (1, 255, 256, 257, N, FULL_N):
            assert cell.wire_bytes_per_client(n) == \
                ref.wire_bytes_per_client(n)
        for rounds in (1, 20):
            assert cell.accountant(rounds) == ref.accountant(rounds)
    assert sc.get("int8") == sc.Scenario("int8", "none")
    with pytest.raises(ValueError, match="unknown defense"):
        sc.Scenario("nope", "none")


@pytest.mark.parametrize("name", [c for c in CELLS
                                  if ref_sc.get(c).feasible])
def test_feasible_cell_tracks_reference(name):
    """Three rounds of the cell (K = 6, A = 4, lr 0.3, the quadratic
    problem) within 1e-5 relative norm of the reference's."""
    ref_cfg = ref_sc.get(name).fl_config(K=K, A=4, rounds=3, lr=0.3, seed=2)
    cfg = sc.get(name).fl_config(K=K, A=4, rounds=3, lr=0.3, seed=2)
    assert cfg.method == ref_cfg.method
    rng = np.random.default_rng(1)
    a = (1.0 + rng.random((K, N))).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ref_run = ref_fl.FLRun(ref_cfg, jnp.zeros(N), lambda x, bt: 0.5 * jnp.mean(
        (bt[0] * x - bt[1]) ** 2))
    run = fl.FLRun(cfg, {"x": torch.zeros(N)}, lambda p, bt: 0.5 * (
        (bt[0] * p["x"] - bt[1]) ** 2).mean(), device="cpu")
    for t in range(3):
        ref_run.step((jnp.asarray(a), jnp.asarray(b)))
        run.step((torch.from_numpy(a), torch.from_numpy(b)))
        got, want = run.x.numpy(), np.asarray(ref_run.x)
        if want.any():
            assert _rel(got, want) < 1e-5, t
        else:
            assert not got.any(), t


@pytest.mark.parametrize("name", [c for c in CELLS
                                  if not ref_sc.get(c).feasible])
def test_infeasible_cell_refuses_with_reference_message(name):
    with pytest.raises(ValueError) as ours:
        sc.get(name).fl_config()
    with pytest.raises(ValueError) as theirs:
        ref_sc.get(name).fl_config()
    assert str(ours.value) == str(theirs.value)
    assert "infeasible" in str(ours.value)


# ---------------------------------------------------- the accountant
def test_accountant_figures():
    """20 rounds at eps = 8 compose to 64.66; at q = 0.75, 54.14."""
    full = acct.ldp_cumulative_epsilon(sc.SCENARIO_LDP, 20)
    sub = acct.ldp_cumulative_epsilon(sc.SCENARIO_LDP, 20, q=0.75)
    assert round(full["eps"], 2) == 64.66 and round(sub["eps"], 2) == 54.14
    assert full == ref_acct.ldp_cumulative_epsilon(ref_sc.SCENARIO_LDP, 20)
    assert acct.ldp_cumulative_epsilon(None, 20) is None
    assert acct.DEFAULT_ORDERS == ref_acct.DEFAULT_ORDERS


@pytest.mark.parametrize("q", [0.0, 0.01, 0.3, 0.75, 1.0])
def test_rdp_curve_equals_reference(q):
    for z in (0.0, 0.6, 1.1, 4.0):
        for alpha in (2, 7, 32, 512):
            assert acct.rdp_subsampled_gaussian(alpha, q, z) == \
                ref_acct.rdp_subsampled_gaussian(alpha, q, z)
        ours, theirs = acct.RDPAccountant(), ref_acct.RDPAccountant()
        ours.step(z, q=q, steps=7)
        theirs.step(z, q=q, steps=7)
        assert ours.epsilon(1e-5) == theirs.epsilon(1e-5)
    with pytest.raises(ValueError, match="integer order"):
        acct.rdp_subsampled_gaussian(2.5, 0.5, 1.0)
    with pytest.raises(ValueError, match="delta"):
        acct.eps_from_rdp([2], [1.0], 1.5)


# ------------------------------------------------- secure aggregation
@pytest.mark.parametrize("Kc,n,scale,seed", [
    (2, 1, 1e4, 0), (2, 17, 1.0, 1), (3, 300, 100.0, 2), (7, 64, 1e4, 3),
    (12, 33, 100.0, 4), (24, 5, 1.0, 5)])
def test_pairwise_masks_bit_for_bit_and_cancel(Kc, n, scale, seed):
    key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
    got = sa.pairwise_masks(key, Kc, n, scale)
    want = np.asarray(ref_sa.pairwise_masks(jkey, Kc, n, scale))
    np.testing.assert_array_equal(_f32_bits(got.numpy()), _f32_bits(want))
    assert not got.sum(0).any()                 # cancels exactly
    assert sa._grid(scale, Kc) == ref_sa._grid(scale, Kc)
    mid = n // 2
    for i in (0, Kc - 1):
        row = sa.pairwise_mask_row(key, i, Kc, n, scale, window=(mid, n))
        np.testing.assert_array_equal(row.numpy(), want[i, mid:])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_secure_agg_aggregate_bit_for_bit(seed):
    """Given the same transmitted vectors, the masked updates (the
    adversary view) and their mean are the reference's bits: rows added
    in order, times the f32 reciprocal of K."""
    v = _updates(seed, scale=0.1)
    keys, ref_keys = _keys(seed)
    res = pl.SecureAggAggregate().apply(
        keys, pl.RoundState(None, None, ()), iter(torch.from_numpy(v)), K,
        collect_views=True)
    ref = jax.jit(lambda k, x: ref_pl.SecureAggAggregate().apply(
        k, ref_pl.RoundState(None, None, None, None), x, None))(
        ref_keys, jnp.asarray(v))
    np.testing.assert_array_equal(_f32_bits(res.update.numpy()),
                                  _f32_bits(ref.update))
    np.testing.assert_array_equal(_f32_bits(res.views.numpy()),
                                  _f32_bits(ref.views))
    x, lr = np.linspace(-1, 1, N, dtype=np.float32), 0.3
    got_x, got_m = sa.secure_agg_round(keys.comp, torch.from_numpy(x),
                                       torch.from_numpy(v), lr)
    want_x, want_m = jax.jit(ref_sa.secure_agg_round)(
        ref_keys.comp, jnp.asarray(x), jnp.asarray(v), lr)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert _rel(got_x.numpy(), np.asarray(want_x)) < 1e-6
    with pytest.raises(ValueError, match="full-cohort"):
        pl.SecureAggAggregate().apply(keys, None, iter(()), K,
                                      torch.ones(K))


@pytest.mark.parametrize("seed", [0, 5])
def test_pairwise_mask_stage_bit_for_bit(seed):
    """PairwiseMask given the same vectors: each client's transmitted
    row is the reference's, bit for bit (the key folded with the salt)."""
    v = _updates(seed)
    keys, ref_keys = _keys(seed)
    want = np.asarray(jax.jit(lambda k, x: ref_pl.PairwiseMask().apply(
        k, None, x)[0])(ref_keys, jnp.asarray(v)))
    st = pl.RoundState(None, None, ())
    for k in range(K):
        got = pl.PairwiseMask().apply(keys, st, torch.from_numpy(v[k]), k, K)
        np.testing.assert_array_equal(_f32_bits(got.numpy()),
                                      _f32_bits(want[k]))


# ------------------------------------------------------- LDP noise
# normal is within 4 ulps of jax's (tests/test_torch_random.py); times
# sigma that is up to 8 ulps of the product, and the product and the sum
# round twice here where XLA fuses them into one multiply-add: 10 ulps of
# max(|out|, sigma)
LDP_ULPS = 10


@pytest.mark.parametrize("seed,clip", [(0, 1.0), (1, 0.1), (2, 50.0)])
def test_ldp_stage_within_ulps(seed, clip):
    """LDPNoise given the same vectors: client k's row of the (K, n)
    noise draw plus its clipped update, within a few ulps of the noise
    and the norm (XLA's erfinv and summation order)."""
    v = _updates(seed)
    cfg, ref_cfg = bl.LDPConfig(8.0, 1e-5, clip), \
        ref_bl.LDPConfig(8.0, 1e-5, clip)
    keys, ref_keys = _keys(seed)
    want = np.asarray(jax.jit(lambda k, x: ref_pl.LDPNoise(ldp=ref_cfg).apply(
        k, None, x)[0])(ref_keys, jnp.asarray(v)))
    st = pl.RoundState(None, None, ())
    sigma = bl.gaussian_sigma(8.0, 1e-5, clip)
    for k in range(K):
        got = pl.LDPNoise(ldp=cfg).apply(keys, st, torch.from_numpy(v[k]),
                                         k, K).numpy()
        ulp = np.spacing(np.maximum(np.abs(want[k]), sigma).astype(
            np.float32))
        assert np.all(np.abs(got - want[k]) <= LDP_ULPS * ulp), k
    assert bl.gaussian_sigma(8.0, 1e-5, clip) == \
        ref_bl.gaussian_sigma(8.0, 1e-5, clip)
    np.testing.assert_allclose(
        bl.clip_by_norm(torch.from_numpy(v[0]), clip).numpy(),
        np.asarray(ref_bl.clip_by_norm(jnp.asarray(v[0]), clip)), rtol=1e-6)


# ---------------------------------------------------------- PriPrune
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate,n,ties", [(0.1, 40, False), (0.3, 1000, True),
                                         (0.01, 70_001, False),
                                         (0.5, 9, True)])
def test_prune_stage_bit_for_bit(dtype, rate, n, ties):
    """PruneWithhold given the same vectors: the exact threshold (the
    k-th largest |g| with its ties, no sort) and ``where(|g| >= t, 0,
    g)``, the reference's bits; at least k coordinates withheld."""
    rng = np.random.default_rng(n)
    v = rng.standard_normal((3, n)).astype(np.float32)
    if ties:
        v = np.round(v * 4) / 4                 # many equal magnitudes
    jv = jnp.asarray(v).astype(dtype)
    want = np.asarray(ref_bl.prune_withhold(jv, rate).astype(jnp.float32))
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    k = max(1, int(round(rate * n)))
    for c in range(3):
        got = pl.PruneWithhold(rate=rate).apply(None, None, tv[c], c, 3)
        assert got.dtype == tv.dtype
        np.testing.assert_array_equal(got.float().numpy(), want[c])
        assert int((got == 0).sum()) >= k
        thresh = bl.withhold_threshold(tv[c], k)
        assert thresh == torch.topk(tv[c].float().abs(), k).values[-1]


def test_prune_threshold_is_chunked(monkeypatch):
    """The selection takes the vector a chunk at a time and gives the
    same threshold."""
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        10_007).astype(np.float32))
    want = bl.withhold_threshold(g, 1001)
    monkeypatch.setattr(random, "CHUNK", 1000)
    assert bl.withhold_threshold(g, 1001) == want
    with pytest.raises(ValueError, match="outside"):
        bl.withhold_threshold(g, 0)


# ------------------------------------------------------------ Shatter
@pytest.mark.parametrize("chunks,r,n", [(8, 4, 40), (5, 2, 37), (3, 6, 10)])
def test_shatter_aggregate_equals_reference(chunks, r, n):
    v = _updates(chunks, n=n)
    keys, ref_keys = _keys(chunks)
    res = pl.ShatterAggregate(chunks=chunks, r=r).apply(
        keys, None, iter(torch.from_numpy(v)), K)
    want = ref_pl.ShatterAggregate(chunks=chunks, r=r).apply(
        ref_keys, None, jnp.asarray(v), None).update
    assert _rel(res.update.numpy(), np.asarray(want)) < 1e-6
    got = bl.shatter_update(keys.comp, torch.from_numpy(v), chunks, r)
    assert _rel(got.numpy(), np.asarray(ref_bl.shatter_update(
        ref_keys.comp, jnp.asarray(v), chunks, r))) < 1e-6


@pytest.mark.parametrize("n", [FULL_N, QWEN_N])
def test_shatter_chunks_wrap_as_reference(n):
    """Windows of the chunk ids past the int32 wrap (i * 8 >= 2**31),
    against jax's formula on the same int32 window, read through jnp's
    negative-index normalisation as the reference gathers them."""
    chunks = 8
    member = jnp.arange(chunks)
    for lo in (0, 2**28 - 3, 2**29 + 11, 10**9, n - 5):
        if lo >= n:
            continue
        hi = min(n, lo + 4099)
        i = jnp.arange(lo, hi, dtype=jnp.int32)
        ids = jnp.minimum(i * chunks // n, chunks - 1)
        want = np.asarray(member[ids])
        got = bl.shatter_chunk_window(n, chunks, lo, hi)
        np.testing.assert_array_equal(got.numpy(), want)
    if n == FULL_N:
        assert int(bl.shatter_chunk_window(n, 8, 2**28, 2**28 + 1)[0]) == 6


# ---------------------------------------------- failure injection
@pytest.mark.parametrize("A,scheme,dsc", [(4, "strided", False),
                                          (3, "contiguous", True),
                                          (8, "strided", True)])
def test_failure_injected_fsa_equals_reference(A, scheme, dsc):
    """FailureInjectedFSA given the same vectors, streamed: the update,
    the Eq. 4 shift and the received (A, K, n) views within 1e-6 of the
    reference's (the dead aggregator's coordinates exactly 0); and the
    (A, K, n) function ``fsa_round_with_failures`` likewise."""
    v = _updates(A)
    keys, ref_keys = _keys(A)
    kw = dict(A=A, mask_scheme=scheme, agg_dropout=0.4, link_failure=0.3,
              use_dsc=dsc, gamma=0.5, keep_views=True)
    s_agg = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    st = pl.RoundState(None, pl.dsc_lib.DSCState(
        torch.zeros(K, N), torch.from_numpy(s_agg.copy())), ())
    ref_st = ref_pl.RoundState(None, ref_pl.dsc_lib.DSCState(
        jnp.zeros((K, N)), jnp.asarray(s_agg)), None, None)
    res = pl.FailureInjectedFSA(**kw).apply(keys, st,
                                            iter(torch.from_numpy(v)), K)
    ref = ref_pl.FailureInjectedFSA(**kw).apply(ref_keys, ref_st,
                                                jnp.asarray(v), None)
    assert _rel(res.update.numpy(), np.asarray(ref.update)) < 1e-6
    assert _rel(res.state.dsc.s_agg.numpy(),
                np.asarray(ref.state.dsc.s_agg)) < 1e-6
    assert _rel(res.views.numpy(), np.asarray(ref.views)) < 1e-6
    agg_alive, link_alive = pl.FailureInjectedFSA(**kw).draws(keys, K)
    assign = masks.make_assignment(N, A, scheme)
    for a in np.flatnonzero(~agg_alive.numpy()):
        dead = (assign == int(a)).numpy()
        assert not res.update.numpy()[dead].any() or dsc
    x = np.linspace(-1, 1, N, dtype=np.float32)
    got = fsa.fsa_round_with_failures(
        torch.from_numpy(x), torch.from_numpy(v), assign, A, 0.3, agg_alive,
        link_alive, keep_views=True)
    want = ref_fsa.fsa_round_with_failures(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(assign.numpy()), A, 0.3,
        jnp.asarray(agg_alive.numpy()), jnp.asarray(link_alive.numpy()),
        keep_views=True)
    assert _rel(got.x_new.numpy(), np.asarray(want.x_new)) < 1e-6
    np.testing.assert_array_equal(got.shard_views.numpy(),
                                  np.asarray(want.shard_views))


@pytest.mark.parametrize("n", [FULL_N, QWEN_N])
@pytest.mark.parametrize("A", [4, 8])
def test_contiguous_assignment_wraps_as_reference(n, A):
    """Windows of the contiguous assignment past the int32 wrap (i * A >=
    2**31) against the reference's formula on the same int32 window:
    negative aggregators where the product wrapped."""
    wrap = 2**31 // A
    for lo in (0, wrap - 3, wrap + 7, 2 * wrap + 1, n - 4099):
        if lo >= n:
            continue
        hi = min(n, lo + 4099)
        i = jnp.arange(lo, hi, dtype=jnp.int32)
        want = np.asarray(jnp.minimum(i * A // max(n, 1), A - 1))
        got = masks.assignment_window(n, A, "contiguous", lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    if (n, A) == (FULL_N, 8):
        at = [268_435_455, 268_435_456, 1_000_000_000, FULL_N - 1]
        assert [int(masks.assignment_window(n, A, "contiguous", i, i + 1)[0])
                for i in at] == [1, -2, -1, 0]
    small = masks.make_assignment(1000, A, "contiguous")
    np.testing.assert_array_equal(small.numpy(), np.asarray(
        ref_masks.make_assignment(1000, A, "contiguous")))
    assert math.isclose(float((small >= 0).float().mean()), 1.0)


def test_baseline_round_functions_equal_reference():
    """The baselines' one-call rounds (``fedavg_round`` ...
    ``shatter_round``) on the same inputs and keys: within 1e-6 relative
    norm (LDP: the noise's ulps), the SoteriaFL shifts updated in
    place."""
    x = np.linspace(-1, 1, N, dtype=np.float32)
    g = _updates(11)
    w = np.random.default_rng(12).uniform(0.5, 2.0, K).astype(np.float32)
    key, jkey = random.PRNGKey(13), jax.random.PRNGKey(13)
    tx, tg, jx, jg = (torch.from_numpy(x), torch.from_numpy(g),
                      jnp.asarray(x), jnp.asarray(g))
    pairs = [
        (bl.fedavg_round(tx, tg, 0.3, torch.from_numpy(w)),
         ref_bl.fedavg_round(jx, jg, 0.3, jnp.asarray(w))),
        (bl.min_leakage_round(tx, tg, 0.3), ref_bl.min_leakage_round(
            jx, jg, 0.3)),
        (bl.fedavg_ldp_round(key, tx, tg, 0.3, bl.LDPConfig()),
         ref_bl.fedavg_ldp_round(jkey, jx, jg, 0.3, ref_bl.LDPConfig())),
        (bl.priprune_round(tx, tg, 0.3, 0.2),
         ref_bl.priprune_round(jx, jg, 0.3, 0.2)),
        (bl.shatter_round(key, tx, tg, 0.3, 5, 3),
         ref_bl.shatter_round(jkey, jx, jg, 0.3, 5, 3))]
    st = bl.SoteriaState(pl.dsc_lib.init_state(K, N))
    got, st2 = bl.soteriafl_round(key, tx, tg, 0.3, st, RandP(p=0.5), 0.4,
                                  bl.LDPConfig())
    want, rst = ref_bl.soteriafl_round(
        jkey, jx, jg, 0.3, ref_bl.SoteriaState(ref_pl.dsc_lib.init_state(
            K, N)), RefRandP(p=0.5), 0.4, ref_bl.LDPConfig())
    pairs.append((got, want))
    for ours, theirs in pairs:
        assert _rel(ours.numpy(), np.asarray(theirs)) < 1e-6
    assert st2.dsc.s_clients is st.dsc.s_clients
    assert _rel(st2.dsc.s_clients.numpy(),
                np.asarray(rst.dsc.s_clients)) < 1e-6
