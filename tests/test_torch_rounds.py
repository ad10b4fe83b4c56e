"""The port's round matrix against the reference, on the CPU: every
method of ``rounds.METHODS``, every eris branch (LDP noise, pairwise
masks, failure injection, fresh masks, views), the async methods
(``BufferedAggregate``, ``ArrivalModel``, ``CohortSample``,
``AsyncSettings``) and the scan engine ``core/eris.py``.

Both packages take the same numpy inputs (a least-squares problem made
from a seed) and each draws its own keys from the same seed.  The
tolerances: trajectories of three rounds within 1e-5 relative norm (the
frameworks' gradients differ in their last bits and the streamed client
sum adds in another order than the reference's einsum); aggregates given
the same transmitted vectors within 1e-6; the draws (cohort ids, arrival
draws, role keys) and the async degenerate cases bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.core import baselines as ref_bl  # noqa: E402
from repro.core import eris as ref_eris  # noqa: E402
from repro.core import fl as ref_fl  # noqa: E402
from repro.core import pipeline as ref_pl  # noqa: E402
from repro.core import settings as ref_settings  # noqa: E402
from repro.core.compressors import RandP as RefRandP  # noqa: E402
from repro.core.rounds import METHODS as REF_METHODS  # noqa: E402
from repro.core.rounds import build_round as ref_build_round  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.core import eris, fl, pipeline as pl, settings  # noqa: E402
from repro_torch.core.compressors import RandP  # noqa: E402
from repro_torch.core.rounds import METHODS, build_round  # noqa: E402

K, N, POP = 6, 40, 10


# ------------------------------------------------------------ helpers
def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _close(got, want, tol):
    """got within ``tol`` relative norm of want; where want is all zero
    (a buffered round that held), got is all zero too."""
    if not np.asarray(want).any():
        return not np.asarray(got).any()
    return _rel(got, want) < tol


def _problem(rows=K, n=N, seed=0):
    """A least-squares client problem: per-client (a, b), numpy."""
    rng = np.random.default_rng(seed)
    return {"a": (1.0 + rng.random((rows, n))).astype(np.float32),
            "b": rng.standard_normal((rows, n)).astype(np.float32)}


def _ref_loss(p, batch):
    r = batch["a"] * p["w"] - batch["b"]
    return 0.5 * jnp.mean(r * r)


def _loss(p, batch):
    r = batch["a"] * p["w"] - batch["b"]
    return 0.5 * (r * r).mean()


def _cfgs(kw):
    """(reference FLConfig, port FLConfig) of the same fields; ``ldp``
    and ``compressor`` are given by name and built in each package."""
    kw = dict(kw)
    ldp = kw.pop("ldp", None)
    comp = kw.pop("compressor", None)
    ref_kw, kw_ = dict(kw), dict(kw)
    if ldp is not None:
        ref_kw["ldp"], kw_["ldp"] = ref_bl.LDPConfig(**ldp), \
            bl.LDPConfig(**ldp)
    if comp is not None:
        ref_kw["compressor"], kw_["compressor"] = RefRandP(p=comp), \
            RandP(p=comp)
    return ref_fl.FLConfig(**ref_kw), fl.FLConfig(**kw_)


def run_both(kw, rounds=3, seed=0):
    """Both FLRuns on the same numpy problem, each keyed from the
    configs' seed; the batches carry the population when it is set."""
    ref_cfg, cfg = _cfgs(kw)
    data = _problem(cfg.population or cfg.K, seed=seed)
    ref_run = ref_fl.FLRun(ref_cfg, {"w": jnp.zeros(N)}, _ref_loss)
    run = fl.FLRun(cfg, {"w": torch.zeros(N)}, _loss, device="cpu")
    out = []
    for _ in range(rounds):
        ref_run.step({k: jnp.asarray(v) for k, v in data.items()})
        run.step({k: torch.from_numpy(v) for k, v in data.items()})
        out.append((run.x.numpy().copy(), np.asarray(ref_run.x)))
    return out, run, ref_run


def _assert_tracks(kw, tol=1e-5, rounds=3):
    out, run, _ = run_both(kw, rounds)
    moved = False
    for t, (got, want) in enumerate(out):
        assert np.isfinite(got).all()
        assert _close(got, want, tol), (t, got, want)
        moved |= bool(want.any())
    assert moved
    return run


# ---------------------------------------------------- every method
METHOD_CASES = {
    "fedavg": dict(method="fedavg"),
    "min_leakage": dict(method="min_leakage"),
    "fedavg_ldp": dict(method="fedavg_ldp"),
    "fedavg_ldp-eps8": dict(method="fedavg_ldp",
                            ldp=dict(eps=8.0, delta=1e-5, clip=1.0)),
    "soteriafl": dict(method="soteriafl", compressor=0.5),
    "soteriafl-ldp": dict(method="soteriafl", compressor=0.5,
                          ldp=dict(eps=8.0, delta=1e-5, clip=1.0)),
    "priprune": dict(method="priprune"),
    "priprune-0.3": dict(method="priprune", prune_rate=0.3),
    "shatter": dict(method="shatter"),
    "shatter-r2": dict(method="shatter", shatter_chunks=5, shatter_r=2),
    "secure_agg": dict(method="secure_agg"),
    "eris": dict(method="eris"),
    "fedbuff": dict(method="fedbuff", population=POP, client_dropout=0.25,
                    delay_max=2, buffer_cadence=2),
    "fedbuff-int8": dict(method="fedbuff", int8_wire=True, delay_max=3,
                         staleness_alpha=0.5),
    "eris_async": dict(method="eris_async", population=POP,
                       client_dropout=0.25, delay_max=2, buffer_cadence=2),
    "eris_async-int8-views": dict(method="eris_async", int8_wire=True,
                                  keep_views=True, client_dropout=0.4),
}


def test_methods_are_the_reference_ten():
    assert list(METHODS) == list(REF_METHODS) and len(METHODS) == 10


@pytest.mark.parametrize("case", sorted(METHOD_CASES))
def test_method_tracks_reference(case):
    """Three rounds of each method (K = 6, A = 4, lr 0.3) within 1e-5
    relative norm of the reference's FLRun."""
    kw = dict(K=K, A=4, lr=0.3, seed=3, **METHOD_CASES[case])
    run = _assert_tracks(kw)
    assert type(run.pipeline.aggregate).__name__ == type(
        REF_METHODS[kw["method"]](_cfgs(kw)[0], N).aggregate).__name__


# ------------------------------------------------ every eris branch
ERIS_CASES = {
    "ldp": dict(ldp=dict(eps=8.0, delta=1e-5, clip=1.0)),
    "ldp-int8": dict(ldp=dict(eps=8.0, delta=1e-5, clip=1.0),
                     int8_wire=True),
    "ldp-dsc": dict(ldp=dict(eps=8.0, delta=1e-5, clip=1.0), use_dsc=True,
                    compressor=0.5),
    "secure_mask": dict(secure_mask=True),
    "secure_mask-dsc": dict(secure_mask=True, use_dsc=True, compressor=0.5),
    "agg_fail": dict(agg_dropout=0.25, link_failure=0.1),
    "agg_fail-int8-views": dict(agg_dropout=0.25, link_failure=0.1,
                                int8_wire=True, keep_views=True),
    "agg_fail-dsc-int8-fused": dict(agg_dropout=0.25, link_failure=0.1,
                                    use_dsc=True, compressor=0.5,
                                    int8_wire=True, compress_impl="fused"),
    "agg_fail-contiguous-A3": dict(agg_dropout=0.3, link_failure=0.2, A=3,
                                   mask_scheme="contiguous"),
    "link_fail-participation": dict(link_failure=0.3, participation=0.5),
    "fresh-masks-fedyogi": dict(fresh_masks=True, server_opt="fedyogi"),
}


@pytest.mark.parametrize("case", sorted(ERIS_CASES))
def test_eris_branch_tracks_reference(case):
    kw = dict(dict(method="eris", K=K, A=4, lr=0.3, seed=4),
              **ERIS_CASES[case])
    _assert_tracks(kw)


# the configurations that raised NotImplementedError (ROADMAP queue 1.7)
# before the round matrix was ported: each builds and steps
FORMERLY_UNPORTED = {
    "agg_dropout": dict(agg_dropout=0.1),
    "link_failure": dict(link_failure=0.1),
    "ldp": dict(ldp=dict()),
    "secure_mask": dict(secure_mask=True),
    "fedbuff": dict(method="fedbuff"),
    "soteriafl": dict(method="soteriafl", compressor=0.5),
}


@pytest.mark.parametrize("case", sorted(FORMERLY_UNPORTED))
def test_formerly_unported_configurations_build_and_step(case):
    _, cfg = _cfgs(dict(K=3, **FORMERLY_UNPORTED[case]))
    data = _problem(3)
    run = fl.FLRun(cfg, {"w": torch.zeros(N)}, _loss, device="cpu")
    run.step({k: torch.from_numpy(v) for k, v in data.items()})
    assert run.t == 1 and bool(run.x.isfinite().all())
    assert bool((run.x != 0).any())


# -------------------------------------------- async: bit-exact gates
def _trajectory(kw, T=4):
    _, cfg = _cfgs(dict(K=4, lr=0.05, **kw))
    data = _problem(4)
    run = fl.FLRun(cfg, {"w": torch.zeros(N)}, _loss, device="cpu")
    return run.run_scanned({k: torch.from_numpy(np.stack([v] * T))
                            for k, v in data.items()})


@pytest.mark.parametrize("sync,async_", [
    (dict(method="fedavg", seed=7), dict(method="fedbuff", seed=7)),
    (dict(method="eris", A=2, seed=7), dict(method="eris_async", A=2,
                                            seed=7)),
    (dict(method="eris", int8_wire=True, seed=9),
     dict(method="fedbuff", int8_wire=True, seed=9)),
    (dict(method="eris", A=2, agg_dropout=0.25, seed=5),
     dict(method="eris_async", A=2, agg_dropout=0.25, seed=5)),
])
def test_async_degenerates_to_sync_bit_exact(sync, async_):
    """Trivial arrivals and cadence 1: the buffer fold is ``0 + 1.0 u``
    and ``u / 1.0``, so the async method IS the synchronous one, bit for
    bit (the reference's degeneracy gate, tests/test_fedbuff.py)."""
    assert torch.equal(_trajectory(sync), _trajectory(async_))


# -------------------------------------------------------- the draws
@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request, monkeypatch):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    monkeypatch.setattr(random, "partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("seed", [0, 17, 2**31 + 5])
def test_cohort_ids_equal_reference(layout, seed):
    keys = pl.split_round_keys(random.PRNGKey(seed))
    ref_keys = ref_pl.split_round_keys(jax.random.PRNGKey(seed))
    for population, cohort in ((10, 4), (64, 64), (1000, 17)):
        got = pl.CohortSample(population, cohort).draw(keys)
        want = ref_pl.CohortSample(population, cohort).draw(ref_keys)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    batches = {"x": torch.arange(30.0).view(10, 3), "y": torch.arange(10)}
    idx, got = pl.CohortSample(10, 4).gather(keys, batches)
    assert torch.equal(got["x"], batches["x"][idx])
    assert torch.equal(got["y"], batches["y"][idx])


@pytest.mark.parametrize("seed", [0, 17, 2**31 + 5])
@pytest.mark.parametrize("delay_max,dropout,alpha", [
    (0, 0.25, 1.0), (2, 0.0, 1.0), (3, 0.4, 1.0), (4, 0.5, 0.5),
    (6, 0.9, 2.0)])
def test_arrival_draws_equal_reference(layout, seed, delay_max, dropout,
                                       alpha):
    """(tau, alive) bit for bit; the weights 1/(1+tau)^alpha * alive bit
    for bit at alpha 1 (a division in both) and within an ulp else."""
    am = pl.ArrivalModel(delay_max=delay_max, dropout=dropout, alpha=alpha)
    ref_am = ref_pl.ArrivalModel(delay_max=delay_max, dropout=dropout,
                                 alpha=alpha)
    tau, alive, omega = am.draw(random.PRNGKey(seed), 32)
    rtau, ralive, romega = ref_am.draw(jax.random.PRNGKey(seed), 32)
    np.testing.assert_array_equal(tau.numpy(), np.asarray(rtau))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(ralive))
    if alpha == 1.0:
        np.testing.assert_array_equal(omega.numpy(), np.asarray(romega))
    np.testing.assert_allclose(omega.numpy(), np.asarray(romega), rtol=2e-7)
    assert am.trivial == ref_am.trivial


# --------------------------------------------------- the buffer fold
@pytest.mark.parametrize("cadence,delay_max,dropout,weighted", [
    (1, 0, 0.0, False), (2, 2, 0.4, False), (3, 4, 0.0, True),
    (2, 1, 0.9, True), (1, 3, 0.25, False)])
def test_buffered_aggregate_folds_as_reference(cadence, delay_max, dropout,
                                               weighted):
    """Five rounds of BufferedAggregate around the weighted mean, on the
    same transmitted vectors and round keys: each update within 1e-6 of
    the reference's (zero, exactly, between applies)."""
    rng = np.random.default_rng(cadence * 10 + delay_max)
    n = 33
    stage = pl.BufferedAggregate(arrival=pl.ArrivalModel(delay_max,
                                                         dropout, 0.7),
                                 cadence=cadence)
    ref_stage = ref_pl.BufferedAggregate(
        arrival=ref_pl.ArrivalModel(delay_max, dropout, 0.7),
        cadence=cadence)
    st = pl.RoundState(torch.zeros(n), None, (), buf=pl.init_buffer(n))
    ref_st = ref_pl.RoundState(jnp.zeros(n), None, None, None,
                               ref_pl.init_buffer(n))
    for t in range(5):
        v = rng.standard_normal((K, n)).astype(np.float32)
        w = (rng.random(K) < 0.7).astype(np.float32) if weighted else None
        if w is not None:
            w[0] = 1.0
        keys = pl.split_round_keys(random.PRNGKey(t))
        ref_keys = ref_pl.split_round_keys(jax.random.PRNGKey(t))
        res = stage.apply(keys, st, iter(torch.from_numpy(v)), K,
                          None if w is None else torch.from_numpy(w))
        ref = ref_stage.apply(ref_keys, ref_st, jnp.asarray(v),
                              None if w is None else jnp.asarray(w))
        assert _close(res.update.numpy(), np.asarray(ref.update), 1e-6), t
        st, ref_st = res.state, ref.state
        assert st.buf.t == int(ref_st.buf.t)
        np.testing.assert_allclose(float(st.buf.w), float(ref_st.buf.w),
                                   rtol=1e-6)


def test_dropped_inf_row_gives_nan_as_reference():
    """A dropped client's row is multiplied by 0, not skipped: an inf in
    it makes the mean NaN, in both."""
    arrival = dict(delay_max=0, dropout=0.5, alpha=1.0)
    keys = pl.split_round_keys(random.PRNGKey(2))
    ref_keys = ref_pl.split_round_keys(jax.random.PRNGKey(2))
    _, alive, _ = pl.ArrivalModel(**arrival).draw(
        random.fold_in(keys.fail, pl.ARRIVAL_SALT), K)
    dead = int(np.flatnonzero(~alive.numpy())[0])
    v = np.ones((K, 8), np.float32)
    v[dead, 3] = np.inf
    stage = pl.BufferedAggregate(arrival=pl.ArrivalModel(**arrival))
    ref_stage = ref_pl.BufferedAggregate(arrival=ref_pl.ArrivalModel(
        **arrival))
    res = stage.apply(keys, pl.RoundState(None, None, (),
                                          buf=pl.init_buffer(8)),
                      iter(torch.from_numpy(v)), K)
    ref = ref_stage.apply(ref_keys, ref_pl.RoundState(
        None, None, None, None, ref_pl.init_buffer(8)), jnp.asarray(v), None)
    np.testing.assert_array_equal(np.isnan(res.update.numpy()),
                                  np.isnan(np.asarray(ref.update)))
    assert np.isnan(res.update.numpy()[3])


def test_refusals_carry_the_reference_messages():
    """Every refused composition raises the reference's ValueError, word
    for word."""
    def message(fn):
        with pytest.raises(ValueError) as err:
            fn()
        return str(err.value)

    n = 40
    for kw in (dict(method="eris_async", use_dsc=True, compressor=0.5),
               dict(method="fedbuff", use_ef=True),
               dict(method="eris", secure_mask=True, participation=0.5),
               dict(method="eris", secure_mask=True, agg_dropout=0.1),
               dict(method="eris", secure_mask=True, client_dropout=0.2),
               dict(method="fedbuff", population=3, K=4),
               dict(method="fedbuff", buffer_cadence=0),
               dict(method="nope")):
        ref_cfg, cfg = _cfgs(kw)
        assert message(lambda: build_round(cfg, n)) == \
            message(lambda: ref_build_round(ref_cfg, n))
    for kw in (dict(secure_mask=True, link_failure=0.1),
               dict(async_buffer=True, use_dsc=True)):
        assert message(lambda: eris.stages(eris.ErisConfig(**kw), n)) == \
            message(lambda: ref_eris.stages(ref_eris.ErisConfig(**kw), n))
    assert message(lambda: pl.BufferedAggregate(
        inner=pl.SecureAggAggregate())) == message(
        lambda: ref_pl.BufferedAggregate(inner=ref_pl.SecureAggAggregate()))
    assert message(lambda: pl.CohortSample(4, 5)) == \
        message(lambda: ref_pl.CohortSample(4, 5))
    assert message(lambda: pl.BufferedAggregate().apply(
        None, pl.RoundState(None, None, ()), iter(()), 1)) == message(
        lambda: ref_pl.BufferedAggregate().apply(
            None, ref_pl.RoundState(None, None, None, None), None, None))


# ---------------------------------------------------- async settings
def test_async_settings_equal_reference():
    fields = [f.name for f in dataclasses.fields(settings.AsyncSettings)]
    assert fields == [f.name for f in dataclasses.fields(
        ref_settings.AsyncSettings)]
    assert settings.ASYNC_FIELDS == ref_settings.ASYNC_FIELDS
    for bad in (dict(population=-1), dict(buffer_cadence=0),
                dict(staleness_alpha=-0.5), dict(delay_max=-1),
                dict(client_dropout=1.5)):
        with pytest.raises(ValueError) as ours:
            settings.AsyncSettings(**bad)
        with pytest.raises(ValueError) as theirs:
            ref_settings.AsyncSettings(**bad)
        assert str(ours.value) == str(theirs.value)
    explicit = settings.AsyncSettings(population=12, delay_max=2)
    ref_explicit = ref_settings.AsyncSettings(population=12, delay_max=2)
    cfg = fl.FLConfig(delay_max=3, async_=explicit)
    ref_cfg = ref_fl.FLConfig(delay_max=3, async_=ref_explicit)
    with pytest.raises(ValueError) as ours:
        cfg.async_settings()
    with pytest.raises(ValueError) as theirs:
        ref_cfg.async_settings()
    assert str(ours.value) == str(theirs.value)
    a = fl.FLConfig(delay_max=2, async_=explicit).async_settings()
    assert a is explicit and a.cohort(4) == pl.CohortSample(12, 4)
    assert a.arrival_model() == pl.ArrivalModel(2, 0.0, 1.0)
    assert fl.FLConfig().async_settings().cohort(4) is None


# ------------------------------------------------- the scan engine
def _grad(x, batch):
    return batch[0] * (batch[0] * x - batch[1])


ENGINE_CASES = {
    "plain": dict(),
    "dsc": dict(use_dsc=True, compressor=0.5),
    "fresh-masks-dsc": dict(use_dsc=True, compressor=0.5, fresh_masks=True),
    "ldp": dict(ldp=dict(eps=8.0, delta=1e-5, clip=1.0)),
    "secure_mask": dict(secure_mask=True),
    "failures-dsc": dict(agg_dropout=0.25, link_failure=0.1, use_dsc=True,
                         compressor=0.5),
    "async-dropout": dict(async_buffer=True, client_dropout=0.3,
                          delay_max=2, buffer_cadence=2),
    "participation": dict(participation=0.5),
}


def _engine_cfgs(kw):
    kw = dict(kw)
    ldp, comp = kw.pop("ldp", None), kw.pop("compressor", None)
    ref_kw, kw_ = dict(A=4, lr=0.05, **kw), dict(A=4, lr=0.05, **kw)
    if ldp is not None:
        ref_kw["ldp"], kw_["ldp"] = ref_bl.LDPConfig(**ldp), \
            bl.LDPConfig(**ldp)
    if comp is not None:
        ref_kw["compressor"], kw_["compressor"] = RefRandP(p=comp), \
            RandP(p=comp)
    return ref_eris.ErisConfig(**ref_kw), eris.ErisConfig(**kw_)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_eris_engine_run_tracks_reference(case):
    """``core/eris.run`` over three rounds (K = 4, n = 32): the iterates
    within 1e-5 relative norm of the reference's scan, and round_step's
    assignment and views as the reference's."""
    ref_cfg, cfg = _engine_cfgs(ENGINE_CASES[case])
    rng = np.random.default_rng(8)
    T, K_, n = 3, 4, 32
    a = (1.0 + rng.random((K_, n))).astype(np.float32)
    b = rng.standard_normal((K_, n)).astype(np.float32)
    batches = np.stack([np.stack([a, b], 1)] * T)          # (T, K, 2, n)
    ref_state, ref_xs = ref_eris.run(jax.random.PRNGKey(1), jnp.zeros(n),
                                     ref_cfg, _grad, jnp.asarray(batches), T)
    state, xs = eris.run(random.PRNGKey(1), torch.zeros(n), cfg, _grad,
                         torch.from_numpy(batches), T)
    for t in range(T):
        assert _close(xs[t].numpy(), np.asarray(ref_xs[t]), 1e-5), t
    np.testing.assert_array_equal(state.key.numpy(), np.asarray(ref_state.key))
    assert state.t == int(ref_state.t) == T
    st, aux = eris.round_step(eris.init(random.PRNGKey(2), torch.zeros(n),
                                        K_, cfg.async_buffer), cfg, _grad,
                              torch.from_numpy(batches[0]), keep_views=True)
    ref_st, ref_aux = ref_eris.round_step(
        ref_eris.init(jax.random.PRNGKey(2), jnp.zeros(n), K_,
                      ref_cfg.async_buffer), ref_cfg, _grad,
        jnp.asarray(batches[0]), keep_views=True)
    np.testing.assert_array_equal(aux["assign"].numpy(),
                                  np.asarray(ref_aux["assign"]))
    assert _rel(aux["transmitted"].numpy(),
                np.asarray(ref_aux["transmitted"])) < 1e-5
    if ref_aux["shard_views"] is None:
        assert aux["shard_views"] is None
    else:
        assert _rel(aux["shard_views"].numpy(),
                    np.asarray(ref_aux["shard_views"])) < 1e-5


@pytest.mark.parametrize("role_bits", range(8))
def test_eris_round_keys_equal_reference(layout, role_bits):
    active = frozenset(r for i, r in enumerate(sorted(eris.ROLE_SALTS))
                       if role_bits >> i & 1)
    k_mask, k_comp = random.split(random.PRNGKey(role_bits))
    rk_mask, rk_comp = jax.random.split(jax.random.PRNGKey(role_bits))
    got = eris._round_keys(k_mask, k_comp, active)
    want = ref_eris._round_keys(rk_mask, rk_comp, active)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert eris.ROLE_SALTS == ref_eris.ROLE_SALTS


def test_eris_stage_roles_equal_reference():
    for kw in ENGINE_CASES.values():
        ref_cfg, cfg = _engine_cfgs(kw)
        got = eris.stage_roles(*eris.stages(cfg, 32))
        want = ref_eris.stage_roles(*ref_eris.stages(ref_cfg, 32))
        assert got == want, kw
