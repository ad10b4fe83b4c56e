"""The non-IID feeds of ``repro_torch.data`` (``dirichlet_partition``,
``balanced_dirichlet_indices``, ``federated_population`` and
``federated_classification(alpha=...)``) against ``repro.data`` on the
CPU, under both threefry layouts, as ``tests/test_cohorts.py`` exercises
the reference's: exactly-once coverage, the indivisible population's
rejection, the rebalancing that follows the owner where it can, the
alpha-controlled concentration.

Owners, indices and labels are held bit for bit: the class proportions
come from ``random.dirichlet`` within a few ulps of jax's, and no sample
here draws a uniform within those ulps of a boundary.  Features go
through ``random.normal``: within 1e-6 absolute (|x| < 10).  Then the
simulator's population runs (fedbuff, eris_async) on the Dirichlet feed
of each package track each other for three rounds within 1e-5 relative
norm, the bound of ``tests/test_torch_rounds.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro import data as ref_data  # noqa: E402
from repro.core import fl as ref_fl  # noqa: E402
from repro_torch import data, random  # noqa: E402
from repro_torch.core import fl  # noqa: E402

X_ATOL, TRAJ_RTOL = 1e-6, 1e-5


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request, monkeypatch):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    monkeypatch.setattr(random, "partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


def _labels(seed, n, n_classes):
    """The same int labels in both packages (bit-exact randint)."""
    key = random.fold_in(random.PRNGKey(seed), 1)
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    got = random.randint(key, (n,), 0, n_classes)
    want = jax.random.randint(jkey, (n,), 0, n_classes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got, want


@pytest.mark.parametrize("K,alpha,n_classes,seed",
                         [(2, 0.05, 2, 1), (4, 0.3, 3, 7), (6, 8.0, 6, 123),
                          (8, 1.0, 4, 2**16)])
def test_partition_covers_population_exactly_once_and_equals_reference(
        layout, K, alpha, n_classes, seed):
    n = 24 * K
    labels, jlabels = _labels(seed, n, n_classes)
    key, jkey = random.PRNGKey(seed), jax.random.PRNGKey(seed)
    owner = data.dirichlet_partition(key, labels, K, alpha, n_classes)
    np.testing.assert_array_equal(
        owner.numpy(),
        np.asarray(ref_data.dirichlet_partition(jkey, jlabels, K, alpha,
                                                n_classes)))
    idx = data.balanced_dirichlet_indices(key, labels, K, alpha, n_classes)
    assert idx.shape == (K, n // K) and idx.dtype == torch.int64
    np.testing.assert_array_equal(np.sort(idx.numpy().ravel()), np.arange(n))
    np.testing.assert_array_equal(
        idx.numpy(),
        np.asarray(ref_data.balanced_dirichlet_indices(jkey, jlabels, K,
                                                       alpha, n_classes)))


def test_partition_rejects_indivisible_population():
    with pytest.raises(ValueError, match="divisible"):
        data.balanced_dirichlet_indices(random.PRNGKey(0),
                                        torch.zeros(10, dtype=torch.int64),
                                        3, 0.5, 2)


def test_partition_follows_dirichlet_owner_where_it_can(layout):
    """Rebalancing moves only the surplus: a client under quota keeps
    every sample its raw owner gave it; a client over quota keeps only
    its own."""
    K, n_classes, n = 4, 3, 240
    labels, _ = _labels(0, n, n_classes)
    key = random.PRNGKey(0)
    owner = data.dirichlet_partition(key, labels, K, 0.3, n_classes).numpy()
    idx = data.balanced_dirichlet_indices(key, labels, K, 0.3,
                                          n_classes).numpy()
    quota, moved = n // K, False
    for k in range(K):
        raw, got = set(np.where(owner == k)[0].tolist()), set(idx[k].tolist())
        if len(raw) <= quota:
            assert raw <= got
        else:
            assert got <= raw
        moved |= raw != got
    assert moved


def test_concentration_monotone_in_alpha():
    """Smaller alpha, more label-skewed clients, on the port's partition
    (the reference's trend test, its sizes and bounds)."""
    K, n_classes, n = 8, 4, 960

    def concentration(alpha):
        vals = []
        for s in range(4):
            key = random.PRNGKey(100 + s)
            labels = random.randint(random.fold_in(key, 1), (n,), 0,
                                    n_classes)
            idx = data.balanced_dirichlet_indices(key, labels, K, alpha,
                                                  n_classes).numpy()
            lab = labels.numpy()[idx]
            frac = np.stack([(lab == c).mean(axis=1)
                             for c in range(n_classes)])
            vals.append(frac.max(axis=0).mean())
        return float(np.mean(vals))

    c_skew, c_mid, c_iid = (concentration(a) for a in (0.05, 0.5, 5.0))
    assert c_skew > c_mid > c_iid, (c_skew, c_mid, c_iid)
    assert c_skew > 0.6 and c_iid < 0.45


def test_federated_population_equals_reference(layout):
    key, jkey = random.PRNGKey(0), jax.random.PRNGKey(0)
    x, y = data.federated_population(key, population=16,
                                     samples_per_client=5, dim=6,
                                     n_classes=3, alpha=0.4)
    rx, ry = ref_data.federated_population(jkey, population=16,
                                           samples_per_client=5, dim=6,
                                           n_classes=3, alpha=0.4)
    assert x.shape == (16, 5, 6) and y.shape == (16, 5)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=0,
                               atol=X_ATOL)
    rows = x.numpy().reshape(-1, 6)
    assert len(np.unique(rows, axis=0)) == rows.shape[0]


@pytest.mark.parametrize("alpha", [0.1, 2.0])
def test_federated_classification_dirichlet_equals_reference(layout, alpha):
    """Each client's first S owned samples, topped up from
    ``RandomState(k).choice`` when it owns fewer (alpha 0.1 leaves some
    clients short: the top-up runs)."""
    K, S = 10, 32
    key, jkey = random.PRNGKey(4), jax.random.PRNGKey(4)
    x, y = data.federated_classification(key, K, S, alpha=alpha)
    rx, ry = ref_data.federated_classification(jkey, K, S, alpha=alpha)
    assert x.shape == (K, S, 16) and y.shape == (K, S)
    np.testing.assert_array_equal(y.numpy(), np.asarray(ry))
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=0,
                               atol=X_ATOL)
    if alpha < 1:
        kd, kp, _ = random.split(key, 3)
        _, pool_y = data.make_classification(kd, 4 * K * S, 16, 4)
        owner = data.dirichlet_partition(kp, pool_y, K, alpha, 4)
        assert int(torch.bincount(owner, minlength=K).min()) < S


def _ce_loss(p, batch):
    logits = batch["x"] @ p["w"]
    lse = torch.logsumexp(logits, -1)
    ll = logits.gather(-1, batch["y"].long()[..., None])[..., 0]
    return (lse - ll).mean()


def _ref_ce_loss(p, batch):
    logits = batch["x"] @ p["w"]
    lse = jax.nn.logsumexp(logits, -1)
    ll = jnp.take_along_axis(logits, batch["y"][..., None], -1)[..., 0]
    return jnp.mean(lse - ll)


@pytest.mark.parametrize("method", ["fedbuff", "eris_async"])
def test_population_runs_on_the_dirichlet_feed_track_the_reference(method):
    """``FLConfig.population`` rounds whose batches are each package's
    ``federated_population``: a softmax regression, three rounds."""
    pop, spc, dim, ncls = 12, 8, 6, 3
    x, y = data.federated_population(random.PRNGKey(1), pop, spc, dim,
                                     ncls, alpha=0.3)
    rx, ry = ref_data.federated_population(jax.random.PRNGKey(1), pop, spc,
                                           dim, ncls, alpha=0.3)
    kw = dict(method=method, K=4, population=pop, lr=0.5)
    run = fl.FLRun(fl.FLConfig(**kw), {"w": torch.zeros(dim, ncls)},
                   _ce_loss, device="cpu")
    ref_run = ref_fl.FLRun(ref_fl.FLConfig(**kw),
                           {"w": jnp.zeros((dim, ncls))}, _ref_ce_loss)
    moved = False
    for _ in range(3):
        run.step({"x": x, "y": y})
        ref_run.step({"x": rx, "y": ry})
        got, want = run.x.numpy(), np.asarray(ref_run.x)
        if not want.any():
            assert not got.any()
            continue
        moved = True
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < TRAJ_RTOL, rel
    assert moved
