"""The distributed step's draws against the reference's expressions in
jax, on the CPU: the failure draws, the async arrivals and their mass, the
pairwise mask rows, LDP's per-leaf noise and ``cohort_batch``.

Each reference expression is the one ``repro/launch/train.py`` evaluates
inside its step (its line in brackets), with the salts taken from
``repro.core.eris.ROLE_SALTS`` and ``repro.core.pipeline``, jitted as the
step is; the port's draws are the module-level functions of
``repro_torch/launch/train.py``.  Bits match everywhere but in
``normal``, which agrees to ``NORMAL_ULPS`` (XLA's ``log`` and
``erfinv``, ``tests/test_torch_random.py``), and in the sign of the
one-rank mask row's zeros.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.core import secure_agg as ref_sa  # noqa: E402
from repro.core.eris import ROLE_SALTS as REF_SALTS  # noqa: E402
from repro.core.pipeline import ARRIVAL_SALT as REF_ARRIVAL  # noqa: E402
from repro.core.pipeline import ArrivalModel as RefArrival  # noqa: E402
from repro.core.pipeline import PAIRWISE_SALT as REF_PAIRWISE  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.pipeline import ArrivalModel  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import train  # noqa: E402

SEEDS = range(5)
N_CLIENTS = (1, 3, 4)
CASES = [(seed, n) for seed in SEEDS for n in N_CLIENTS]
IDS = [f"key{seed}-n{n}" for seed, n in CASES]
NORMAL_ULPS = 4
# the scenario pack's knobs: agg_fail and client_drop with the chip's
# delay_max
AGG_DROPOUT, LINK_FAILURE = 0.25, 0.1
ARRIVAL = dict(delay_max=2, dropout=0.25, alpha=1.0)
LEAF_SHAPES = [shape for _, shape in sh.spec_items(
    get_config("qwen2-0.5b").smoke())]
MASK_LEAVES = (0, 5)
# the port draws windows of this many elements of the larger leaves: the
# port's int64 threefry passes are the slow part of this file on a loaded
# host, and a window is the draw's own slice
WINDOW = 4096


def _eq(got, want, what, bits=True):
    """Equal values; with ``bits``, equal bit patterns too (the sign of a
    zero included)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)
    if bits and got.dtype.kind == "f":
        assert (got.view(np.int32) == want.view(np.int32)).all(), what


@pytest.mark.parametrize("seed,n", CASES, ids=IDS)
def test_failure_draws_match_the_reference(seed, n):
    """``agg_alive``, ``link_alive`` and ``link_cnt`` (reference
    :431-440), bit for bit."""
    @jax.jit
    def ref(key):
        ka, kl = jax.random.split(jax.random.fold_in(key, REF_SALTS["fail"]))
        agg = jax.random.bernoulli(ka, 1.0 - AGG_DROPOUT, (n,)
                                   ).astype(jnp.float32)
        link = jax.random.bernoulli(kl, 1.0 - LINK_FAILURE, (n, n)
                                    ).astype(jnp.float32)
        return agg, link, jnp.maximum(link.sum(0), 1.0)

    got = train.failure_draws(random.PRNGKey(seed), n, AGG_DROPOUT,
                              LINK_FAILURE)
    for what, g, w in zip(("agg_alive", "link_alive", "link_cnt"), got,
                          ref(jax.random.PRNGKey(seed))):
        _eq(g, w, what)


@pytest.mark.parametrize("seed,n", CASES, ids=IDS)
def test_arrival_draws_match_the_reference(seed, n):
    """``tau``, ``alive``, ``omega`` and ``w_round = omega.mean()``
    (reference :416-421), bit for bit."""
    @jax.jit
    def ref(key):
        tau, alive, omega = RefArrival(**ARRIVAL).draw(
            jax.random.fold_in(key, REF_ARRIVAL), n)
        return tau, alive, omega, omega.mean()

    got = train.arrival_draws(random.PRNGKey(seed), n,
                              ArrivalModel(**ARRIVAL))
    for what, g, w in zip(("tau", "alive", "omega", "w_round"), got,
                          ref(jax.random.PRNGKey(seed))):
        _eq(g, w, what)


@pytest.mark.parametrize("seed,n", CASES, ids=IDS)
def test_mask_rows_match_the_reference(seed, n):
    """Every rank's mask row of leaves 0 and 5 (reference :533-537), bit
    for bit: leaf 0 whole and on a window that starts past 0, leaf 5 (a
    (2, 512, 256) leaf) on its first and on its last WINDOW elements; on
    each, the rows of all ranks sum to exactly zero in f32.  At one rank
    the values only: the reference's row is ``0 * m_ii``, its one term,
    so it holds -0.0 where its (i, i) draw is negative, and the port's
    +0.0 without drawing it (a gradient plus either is the same but at
    -0.0)."""
    key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
    for i in MASK_LEAVES:
        size = math.prod(LEAF_SHAPES[i])
        mk = jax.random.fold_in(jax.random.fold_in(jkey, REF_PAIRWISE), i)
        windows = ([(0, size), (37, size - 11)] if size <= WINDOW else
                   [(0, WINDOW), (size - WINDOW - 11, size - 11)])
        for lo, hi in windows:
            total = torch.zeros(hi - lo)
            for aidx in range(n):
                want = np.asarray(ref_sa.pairwise_mask_row(
                    mk, jnp.int32(aidx), n, size))[lo:hi]
                row = train.mask_row(key, i, aidx, n, size, window=(lo, hi))
                _eq(row, want, f"leaf {i} rank {aidx} [{lo}, {hi})",
                    bits=n > 1)
                total += row
            assert bool((total == 0).all()), f"leaf {i}: rows do not cancel"
            if n == 1:
                assert bool((want == 0).all()) and bool((want.view(
                    np.int32) != 0).any()), "the reference's row: no -0.0"
                assert bool((row.view(torch.int32) == 0).all())
            else:
                assert bool((row != 0).any())


@pytest.mark.parametrize("seed", SEEDS)
def test_ldp_noise_matches_the_reference(seed):
    """Each rank's noise of leaf 5 at four ranks (reference :480-484) on
    a window that starts past 0, within ``normal``'s ulps (that a window
    is the whole draw's slice, ``tests/test_torch_random.py``)."""
    key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
    i, shape = 5, LEAF_SHAPES[5]
    lo, hi = 1000, 1000 + WINDOW
    for aidx in range(4):
        want = np.asarray(jax.random.normal(jax.random.fold_in(
            jax.random.fold_in(jkey, REF_SALTS["noise"] + i), aidx),
            shape)).reshape(-1)
        got = train.ldp_noise(key, i, aidx, shape, window=(lo, hi)).numpy()
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want[lo:hi].view(np.int32))
        assert np.sign(got).tolist() == np.sign(want[lo:hi]).tolist()
        assert ulps.max() <= NORMAL_ULPS, (aidx, ulps.max())


@pytest.mark.parametrize("seed", SEEDS)
def test_cohort_batch_matches_the_reference(seed):
    """``cohort_batch`` over a population of 16 (reference :144-151): the
    cohort ids and the gathered rows, bit for bit, at n_client 1, 3, 4."""
    toks = np.random.default_rng(seed).integers(
        0, 512, (16, 2, 8)).astype(np.int32)
    for n in N_CLIENTS:
        ids, rows = ref_train.cohort_batch({"tokens": jnp.asarray(toks)},
                                           jax.random.PRNGKey(seed), 16, n)
        got_ids, got = train.cohort_batch(
            {"tokens": torch.from_numpy(toks)}, random.PRNGKey(seed), 16, n)
        _eq(got_ids, ids, f"ids n={n}")
        _eq(got["tokens"], rows["tokens"], f"rows n={n}")


def test_settings_resolve_as_the_references():
    """``async_settings()``, ``arrival_model()`` and ``ldp_config()``: the
    reference's values for flat knobs, for an attached ``AsyncSettings``
    and with LDP off and on."""
    from repro.core.settings import AsyncSettings as RefAsync
    from repro_torch.core.settings import AsyncSettings
    cases = [dict(), dict(delay_max=2, client_dropout=0.25,
                          buffer_cadence=2),
             dict(async_=dict(delay_max=1, staleness_alpha=0.5)),
             dict(ldp_eps=8.0, ldp_clip=0.5)]
    for fields in cases:
        ref_f, port_f = dict(fields), dict(fields)
        if "async_" in fields:
            ref_f["async_"] = RefAsync(**fields["async_"])
            port_f["async_"] = AsyncSettings(**fields["async_"])
        ref = ref_train.TrainSettings(**ref_f)
        port = train.TrainSettings(**port_f)
        assert dataclasses.asdict(port.async_settings()) == \
            dataclasses.asdict(ref.async_settings())
        assert dataclasses.asdict(port.arrival_model()) == \
            dataclasses.asdict(ref.arrival_model())
        assert (None if port.ldp_config() is None else dataclasses.asdict(
            port.ldp_config())) == (None if ref.ldp_config() is None else
                                     dataclasses.asdict(ref.ldp_config()))
