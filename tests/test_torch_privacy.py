"""The port's privacy audit (``repro_torch.core.privacy``,
``repro_torch.privacy.views`` and ``.harness``) against the reference's,
on the CPU.

The same numpy inputs go through both packages: the reference's captured
MLP views and iterates (``harness.capture_run``) are carried over, so the
port's statistics are held to the reference's on the same scores'
inputs.  Tolerances: the bounds, the view geometry and every statistic
computed from the scores (AUC, balanced accuracy, both bootstrap
intervals) are equal; the scores themselves differ in the order of their
sums only (the port streams the canaries and sums the alignments in f64,
``core/privacy.py``), so they and the score gap agree to 1e-5; the views
``capture_run`` captures agree to 1e-6 (the frameworks' gradients differ
in the last bits); DLG's Adam trajectories start from normals within a
few ulps of jax's and XLA fuses the optimizer's multiply-adds, so the
match losses agree to 1e-3 relative over the first 20 steps and the
reconstruction to 1e-3 after 400.  The reference's audit tests that pass
run again on the port alone, at their sizes.
"""
import dataclasses

import jax
import jax.flatten_util  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from repro.core import masks as ref_masks  # noqa: E402
from repro.core import privacy as ref_privacy  # noqa: E402
from repro.privacy import harness as ref_harness  # noqa: E402
from repro.privacy import views as ref_views  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.convert import params_from_jax, ravel_params  # noqa: E402
from repro_torch.core import masks as masks_lib  # noqa: E402
from repro_torch.core import privacy  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.privacy import harness, views  # noqa: E402

KEY = jax.random.PRNGKey(0)
CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


def _key(k):
    """A jax key as the port's: its two uint32 words as int64."""
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def ci_leq(lo_side, hi_side, slack: float = 0.0) -> bool:
    """Interval comparison: 'lo_side <= hi_side' holds unless the entire
    CI of lo_side sits above the entire CI of hi_side (plus slack)."""
    return lo_side[0] <= hi_side[1] + slack


# ------------------------------------------------------------ the bounds
def test_bounds_equal_the_reference():
    for n, T, p, A, c, a_c in [(1000, 10, 1.0, 1, 1.0, 1),
                               (1000, 10, 0.1, 4, 0.5, 1),
                               (1816565760, 2, 1.0, 8, 1.0, 3)]:
        assert privacy.mi_bound(n, T, p, A, c, a_c) == \
            ref_privacy.mi_bound(n, T, p, A, c, a_c)
        assert privacy.observed_fraction(p, A, a_c) == \
            ref_privacy.observed_fraction(p, A, a_c)
    for snr in (0.0, 0.3, 3.0, 1e6):
        assert privacy.gaussian_cmax(snr) == ref_privacy.gaussian_cmax(snr)


def test_observed_fraction():
    assert privacy.observed_fraction(1.0, 4) == 0.25
    assert privacy.observed_fraction(0.1, 50) == pytest.approx(0.002)


# ------------------------------------------------------------ the scores
def test_mia_scores_match_the_reference():
    """The reference's ``test_mia_scan_scores_match_direct_computation``
    inputs: the streamed scores equal its (C, n) scan's to 1e-5."""
    n, T, C = 24, 5, 6
    k1, k2, k3 = jax.random.split(KEY, 3)
    x_traj = jax.random.normal(k1, (T, n))
    views_ = jax.random.normal(k2, (T, n))
    canaries = jax.random.normal(k3, (C, n))
    obs = ref_masks.mask_for(ref_masks.make_assignment(n, 2, "strided"), 0)
    want = ref_privacy._mia_scores(lambda x, c: c * jnp.sum(x) + x, x_traj,
                                   views_, obs, canaries)
    got = privacy._mia_scores(lambda x, c: c * torch.sum(x) + x,
                              _t(x_traj), _t(views_), _t(obs), _t(canaries))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _captured(spec):
    """The reference's captured MLP run with its canary grad_fn, and the
    port's grad_fn over the same ravelled params."""
    params0, loss_fn, batches, members, non = \
        ref_harness.mlp_canary_problem(spec)
    run, x_traj, views_ = ref_harness.capture_run(spec, params0, loss_fn,
                                                  batches)
    _, port_loss = harness.mlp_model(device=CPU)
    _, unravel = ravel_params(params_from_jax(
        jax.tree.map(np.asarray, params0), device=CPU))
    grad_fn = harness.flat_grad(
        lambda p, c: port_loss(p, (c[:-1][None], c[-1][None].long())),
        unravel)
    ref_grad = jax.grad(lambda xf, c: loss_fn(
        run.unravel(xf), (c[:-1][None], c[-1][None].astype(jnp.int32))))
    return run, x_traj, views_, members, non, grad_fn, ref_grad


AUDIT_SPECS = {
    "f32_A2": ref_harness.AuditSpec(A=2, rounds=12, n_bootstrap=64, seed=1),
    "int8_dsc_A4": ref_harness.AuditSpec(A=4, rounds=12, n_bootstrap=64,
                                         seed=1, use_dsc=True,
                                         int8_wire=True),
}


@pytest.mark.parametrize("name", list(AUDIT_SPECS))
def test_mia_audit_equals_the_reference_on_captured_views(name):
    """On the reference's captured views (coalition union, de-shifted),
    the port's AUC, balanced accuracy and both bootstrap intervals equal
    the reference's; the score gap agrees to 1e-5."""
    spec = AUDIT_SPECS[name]
    run, x_traj, views_, members, non, grad_fn, ref_grad = _captured(spec)
    assign = ref_masks.make_assignment(run.n, spec.A, spec.mask_scheme)
    obs, v = ref_harness.coalition_views(views_, assign, 1)
    v = ref_harness.deshift_views(v, ref_harness.dsc_gamma_of(run))
    want = ref_privacy.mia_audit(jax.random.PRNGKey(7), ref_grad,
                                 x_traj, v, obs, members, non,
                                 n_bootstrap=64)
    got = privacy.mia_audit(random.PRNGKey(7), grad_fn, _t(x_traj), _t(v),
                            _t(obs), _t(members), _t(non), n_bootstrap=64)
    assert 0.0 < want["auc"] < 1.0          # the ranking is not trivial
    for k in ("auc", "balanced_accuracy", "auc_ci", "bal_acc_ci"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["score_gap"] == pytest.approx(want["score_gap"], rel=1e-5)


def test_mia_audit_sweep_matches_the_reference_per_mask():
    """The collusion sweep's stack of coalition masks, mask for mask."""
    spec = ref_harness.AuditSpec(A=4, rounds=8, n_bootstrap=32, seed=2)
    run, x_traj, views_, members, non, grad_fn, ref_grad = _captured(spec)
    assign = ref_masks.make_assignment(run.n, spec.A, spec.mask_scheme)
    masks, vs = [], []
    for a_c in range(1, spec.A + 1):
        obs, v = ref_harness.coalition_views(views_, assign, a_c)
        masks.append(obs)
        vs.append(v)
    want = ref_privacy.mia_audit_sweep(
        jax.random.PRNGKey(3), ref_grad, x_traj, jnp.stack(vs),
        jnp.stack(masks), members, non, n_bootstrap=32)
    got = privacy.mia_audit_sweep(
        random.PRNGKey(3), grad_fn, _t(x_traj), _t(jnp.stack(vs)),
        _t(jnp.stack(masks)), _t(members), _t(non), n_bootstrap=32)
    for k in ("auc", "balanced_accuracy", "auc_ci", "bal_acc_ci"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["score_gap"], want["score_gap"],
                               rtol=1e-5)


def test_attack_mesh_spreads_the_canaries():
    """A two-device mesh (both the host here) gives the one-device
    scores; the mesh is the longest prefix dividing the canary count."""
    assert privacy.attack_mesh(6, ["cpu"] * 4) == (torch.device("cpu"),) * 3
    assert privacy.attack_mesh(7, ["cpu"] * 4) == (torch.device("cpu"),)
    spec = harness.AuditSpec(A=2, rounds=3, n_canaries=4, n_bootstrap=16)
    one = harness.mia_mlp(spec, device=CPU)
    two = harness.mia_mlp(dataclasses.replace(spec, shard_attack=True),
                          device=CPU)
    assert one == two


# ------------------------------------------------------------------ DLG
def test_dlg_attack_matches_the_reference():
    """``dlg_mlp``'s sizes (dim 36, A = 1): match losses within 1e-3
    relative over the first 20 steps, the reconstruction within 1e-3
    after 400 steps."""
    dim, classes = 36, 3
    k1, k2, k3, _ = jax.random.split(KEY, 4)
    params0 = {"w": 0.5 * jax.random.normal(k1, (dim, classes)),
               "b": jnp.zeros(classes)}
    from jax.flatten_util import ravel_pytree
    x_flat, unravel = ravel_pytree(params0)

    def ref_loss(xf, inp, label):
        p = unravel(xf)
        return -jax.nn.log_softmax(inp @ p["w"] + p["b"])[label]

    ref_grad = jax.grad(ref_loss)
    target = jax.random.normal(k2, (dim,))
    g = ref_grad(x_flat, target, 1)
    obs = jnp.ones_like(x_flat)
    want = ref_privacy.dlg_attack(k3, ref_grad, x_flat, g, obs, (dim,), 1,
                                  steps=400, lr=0.05)
    tp, tunravel = ravel_params(params_from_jax(
        jax.tree.map(np.asarray, params0), device=CPU))
    grad_fn = harness.flat_grad(
        lambda p, inp, label: -torch.log_softmax(
            inp @ p["w"] + p["b"], -1)[label], tunravel, create_graph=True)
    got = privacy.dlg_attack(_key(k3), grad_fn, _t(x_flat), _t(g), _t(obs), (dim,), 1,
                             steps=400, lr=0.05)
    np.testing.assert_allclose(got["match_losses"][:20].numpy(),
                               np.asarray(want["match_losses"][:20]),
                               rtol=1e-3)
    np.testing.assert_allclose(got["reconstruction"].numpy(),
                               np.asarray(want["reconstruction"]),
                               rtol=1e-3, atol=1e-3)
    assert privacy.reconstruction_mse(got["reconstruction"], _t(target)) \
        == pytest.approx(ref_privacy.reconstruction_mse(
            want["reconstruction"], target), abs=1e-4)


# ---------------------------------------------------------------- views
def _abstract(shapes):
    return {f"l{i:02d}": np.zeros(s, np.float32) for i, s in
            enumerate(shapes)}


LM_SHAPES = [tuple(s) for _, s in sh.spec_items(harness.tiny_lm_config())]
MIXED = [(6, 4), (5,), (2, 9), (12,), (3, 1)]


@pytest.mark.parametrize("shapes,n_client", [
    (LM_SHAPES, 2), (LM_SHAPES, 3), (LM_SHAPES, 4), (MIXED, 2), (MIXED, 3)],
    ids=["lm2", "lm3", "lm4", "mixed2", "mixed3"])
def test_views_equal_the_reference(shapes, n_client):
    """``view_layouts``, ``mesh_flat_assignment``,
    ``flat_views_from_leaves`` and ``colluding_view`` give the
    reference's arrays exactly; at tiny-lm's 3 every leaf takes the
    all-reduce (-1) and both raise alike, and the mixed trees hold
    scattered and -1 leaves side by side."""
    abstract = _abstract(shapes)
    got, want = (views.view_layouts(abstract, n_client),
                 ref_views.view_layouts(abstract, n_client))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.index, g.offset, g.shape, g.dim, g.tp_dim, g.m_loc,
                g.dup) == (w.index, w.offset, w.shape, w.dim, w.tp_dim,
                           w.m_loc, w.dup)
        assert len(g.chunks) == len(w.chunks)
        for a, b in zip(g.chunks, w.chunks):
            np.testing.assert_array_equal(a, b)
    assign = views.mesh_flat_assignment(abstract, n_client)
    np.testing.assert_array_equal(
        assign, ref_views.mesh_flat_assignment(abstract, n_client))
    assert assign.dtype == np.int32
    rng = np.random.default_rng(n_client)
    leaves = {str(g.index): rng.standard_normal(
        (n_client, 3, g.m_loc)).astype(np.float32) for g in got if g.dim >= 0}
    if not leaves:
        assert (assign == -1).all()
        with pytest.raises(ValueError) as ref_err:
            ref_views.flat_views_from_leaves(leaves, abstract, n_client)
        with pytest.raises(ValueError, match="no captured view leaves") as e:
            views.flat_views_from_leaves(leaves, abstract, n_client)
        assert str(e.value) == str(ref_err.value)
        return
    flat = views.flat_views_from_leaves(
        {k: torch.from_numpy(v) for k, v in leaves.items()}, abstract,
        n_client)
    np.testing.assert_array_equal(
        flat, ref_views.flat_views_from_leaves(leaves, abstract, n_client))
    coalition = list(range(n_client - 1))
    np.testing.assert_array_equal(
        views.colluding_view(flat[None], coalition),
        ref_views.colluding_view(flat[None], coalition))
    if shapes is MIXED:
        assert (assign == -1).any() and (assign >= 0).any()


def test_views_over_a_model_axis_name_their_queue():
    """``tp > 1`` no longer raises: without specs every leaf is replicated
    over the model axis (its captured width duplicated), and an empty
    spec tree places no leaf, both as the reference's.  Sharded leaves
    over a model axis: ``tests/test_torch_tp.py``."""
    abstract = _abstract(MIXED)
    got = views.view_layouts(abstract, 2, tp=2)
    want = ref_views.view_layouts(abstract, 2, tp=2)
    assert [(g.dim, g.tp_dim, g.m_loc, g.dup) for g in got] == \
        [(w.dim, w.tp_dim, w.m_loc, w.dup) for w in want]
    assert any(g.dup for g in got)
    np.testing.assert_array_equal(
        views.mesh_flat_assignment(abstract, 2, tp_specs={}),
        ref_views.mesh_flat_assignment(abstract, 2, tp_specs={}))


# ------------------------------------------------------------ the capture
@pytest.mark.parametrize("wire", ["f32", "int8_dsc"])
def test_capture_run_matches_the_reference(wire):
    """``capture_run``'s (T, A, K, n) views and iterates at
    ``AuditSpec(A=2, rounds=4)`` agree with the reference's to 1e-6, on
    the f32 wire and on int8 + DSC."""
    kw = {} if wire == "f32" else dict(int8_wire=True, use_dsc=True)
    spec = ref_harness.AuditSpec(A=2, rounds=4, seed=3, **kw)
    params0, _, batches, _, _ = ref_harness.mlp_canary_problem(spec)
    _, x_want, v_want = ref_harness.capture_run(
        spec, params0, ref_harness.mlp_model()[1], batches)
    _, loss_fn = harness.mlp_model(device=CPU)
    port_spec = harness.AuditSpec(A=2, rounds=4, seed=3, **kw)
    run, x_got, v_got = harness.capture_run(
        port_spec, params_from_jax(jax.tree.map(np.asarray, params0),
                                   device=CPU), loss_fn,
        tuple(_t(b) for b in batches), device=CPU)
    assert tuple(v_got.shape) == tuple(v_want.shape) == (4, 2, 4, run.n)
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_want),
                               rtol=0, atol=1e-6)
    assert np.abs(np.asarray(v_want)).max() > 1e-2


def test_harness_problems_draw_the_references_inputs():
    """The canaries are threefry ``randint`` draws, bit for bit; the MLP's
    Gaussian inputs and weights within a few ulps (``random.normal``)."""
    spec = harness.AuditSpec(A=2, rounds=2, seed=5)
    ref = ref_harness.mlp_canary_problem(ref_harness.AuditSpec(seed=5))
    got = harness.mlp_canary_problem(spec, device=CPU)
    np.testing.assert_allclose(ravel_params(got[0])[0].numpy(),
                               np.asarray(jax.flatten_util.ravel_pytree(
                                   ref[0])[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2][1].numpy(), np.asarray(ref[2][1]))
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(ref[2][0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]),
                               rtol=1e-6, atol=1e-6)
    cfg = harness.tiny_lm_config()
    ref_cfg = ref_harness.tiny_lm_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    _, _, b_got, m_got, n_got = harness.lm_canary_problem(
        cfg, spec, params0={}, device=CPU)
    _, _, b_want, m_want, n_want = ref_harness.lm_canary_problem(
        ref_cfg, ref_harness.AuditSpec(seed=5))
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_want))
    np.testing.assert_array_equal(n_got.numpy(), np.asarray(n_want))
    np.testing.assert_array_equal(b_got["tokens"].numpy(),
                                  np.asarray(b_want["tokens"]))


def test_harness_default_transformer_params_are_the_references():
    """Without ``params0`` the transformer problems start from the
    reference's params: ``lm_canary_problem`` from ``init_params(PRNGKey(
    seed))``, DLG from ``init_params(fold_in(PRNGKey(seed), 1))`` (its
    true embeddings are rows of that init's table), within ``normal``'s
    ulps (4, and the scale's rounding: 1e-6 absolute here)."""
    spec = harness.AuditSpec(A=2, rounds=2, seed=5)
    cfg, ref_cfg = harness.tiny_lm_config(), ref_harness.tiny_lm_config()
    got = harness.lm_canary_problem(cfg, spec, device=CPU)[0]
    want = ref_harness.lm_canary_problem(ref_cfg,
                                         ref_harness.AuditSpec(seed=5))[0]
    np.testing.assert_allclose(
        ravel_params(got)[0].numpy(),
        np.asarray(jax.flatten_util.ravel_pytree(want)[0]), rtol=0,
        atol=1e-6)
    _, emb_true = harness.dlg_lm_runs(cfg, [1], seed=3, seq=8, steps=1,
                                      device=CPU)
    from repro.models import transformer as ref_tr
    key = jax.random.PRNGKey(3)
    ref_p = ref_tr.init_params(jax.random.fold_in(key, 1), ref_cfg)
    toks = jax.random.randint(jax.random.fold_in(key, 2), (1, 8), 0,
                              ref_cfg.vocab)
    np.testing.assert_allclose(emb_true.numpy(),
                               np.asarray(ref_p["embed"][toks[0]]), rtol=0,
                               atol=1e-6)


def test_deshift_views_equals_the_reference():
    """The de-shift's shift update is XLA's one FMA: equal at gamma 0.3,
    in place or not."""
    v = jax.random.normal(KEY, (6, 1000))
    want = np.asarray(ref_harness.deshift_views(v, 0.3))
    np.testing.assert_array_equal(
        harness.deshift_views(_t(v), 0.3).numpy(), want)
    tv = _t(v)
    assert harness.deshift_views(tv, 0.3, inplace=True) is tv
    np.testing.assert_array_equal(tv.numpy(), want)
    assert harness.deshift_views(tv, 0.0) is tv


# --------------------------- the reference's audit tests, on the port alone
def test_mia_bootstrap_ci_uses_key():
    """The audit key drives a bootstrap CI on AUC / balanced accuracy:
    intervals bracket the point estimates, are deterministic per key,
    move with the key, and n_bootstrap=0 disables them."""
    spec = harness.AuditSpec(A=2, rounds=12, n_bootstrap=64, seed=1)
    params0, loss_fn, batches, members, non = harness.mlp_canary_problem(
        spec, device=CPU)
    run, x_traj, views_ = harness.capture_run(spec, params0, loss_fn,
                                              batches, device=CPU)
    assign = masks_lib.make_assignment(run.n, spec.A, spec.mask_scheme)
    obs, v = harness.coalition_views(views_, assign, 1)
    grad_fn = harness._mlp_grad_fn(run, loss_fn)

    def audit(seed, n_bootstrap=64):
        return privacy.mia_audit(random.PRNGKey(seed), grad_fn, x_traj, v,
                                 obs, members, non, n_bootstrap=n_bootstrap)

    r1, r2, r3 = audit(7), audit(7), audit(8)
    for r in (r1, r3):
        lo, hi = r["auc_ci"]
        assert 0.0 <= lo <= hi <= 1.0
        assert lo - 1e-6 <= r["auc"] <= hi + 1e-6
        blo, bhi = r["bal_acc_ci"]
        assert blo - 1e-6 <= r["balanced_accuracy"] <= bhi + 1e-6
    assert r1["auc_ci"] == r2["auc_ci"]
    assert r1["auc"] == r3["auc"]
    assert ci_leq(r1["auc_ci"], r3["auc_ci"]) \
        and ci_leq(r3["auc_ci"], r1["auc_ci"])
    r0 = audit(7, 0)
    assert "auc_ci" not in r0 and r0["auc"] == r1["auc"]


AUDIT_KW = dict(rounds=40, lr=0.5, n_canaries=24, n_bootstrap=128)
AUDIT_DIM = 16


def test_mia_auc_monotone_in_A():
    """Same seed => same trajectory (Theorem B.1), so the audits at A =
    1, 4, 8 attack the same trajectories through shrinking views: AUC is
    monotone non-increasing, interval-compared plus a point band."""
    res = {A: harness.mia_mlp(harness.AuditSpec(A=A, seed=0, **AUDIT_KW),
                              dim=AUDIT_DIM, device=CPU) for A in (1, 4, 8)}
    assert res[1]["auc"] > 0.7
    for lo_A, hi_A in ((1, 4), (4, 8), (1, 8)):
        assert ci_leq(res[hi_A]["auc_ci"], res[lo_A]["auc_ci"]), res
        assert res[hi_A]["auc"] <= res[lo_A]["auc"] + 0.05, res
    assert res[8]["mi_bound"] < res[4]["mi_bound"] < res[1]["mi_bound"]


def test_colluding_views_recover_full_attack_strength():
    """Cor. D.2: a coalition of a_c = A aggregators observes everything:
    its AUC matches the A = 1 audit, and AUC is non-decreasing in a_c
    (interval-compared) along the sweep."""
    sweep = harness.mia_mlp_collusion_sweep(
        harness.AuditSpec(A=8, seed=0, **AUDIT_KW), dim=AUDIT_DIM,
        device=CPU)
    full = harness.mia_mlp(harness.AuditSpec(A=1, seed=0, **AUDIT_KW),
                           dim=AUDIT_DIM, device=CPU)
    auc, ci = sweep["auc"], sweep["auc_ci"]
    np.testing.assert_allclose(auc[-1], full["auc"], atol=1e-6)
    for i in range(len(auc) - 1):
        assert ci_leq(tuple(ci[i]), tuple(ci[i + 1])), (i, ci)
    np.testing.assert_array_equal(sweep["a_c"], np.arange(1, 9))


def test_sampling_views_zero_on_skipped_rounds():
    """The async arrival model zeroes every wire row of a dropped
    client-round, across all aggregator shards at once, and with q =
    0.25 over 12 rounds some rounds are skipped."""
    spec = harness.AuditSpec(A=2, rounds=12, K=4, n_canaries=4,
                             n_bootstrap=0, q=0.25, seed=3)
    assert harness.fl_config(spec).method == "eris_async"
    params0, loss_fn, batches, _, _ = harness.mlp_canary_problem(
        spec, device=CPU)
    _, _, views_ = harness.capture_run(spec, params0, loss_fn, batches,
                                       device=CPU)
    views_ = views_.numpy()
    alive = np.abs(views_).sum(axis=(1, 3)) > 0          # (T, K)
    assert not alive.all() and alive.any()
    per_agg = np.abs(views_).sum(axis=3)                 # (T, A, K)
    assert ((per_agg > 0).all(axis=1) == alive).all()
    assert ((per_agg > 0).any(axis=1) == alive).all()


def test_mia_sampling_at_q_one_is_the_synchronous_audit():
    """q = 1 is the synchronous engine: the same AUC and bound, and the
    amplified bound is linear in q."""
    kw = dict(A=4, rounds=6, n_canaries=4, n_bootstrap=16, lr=0.5, seed=2)
    res = harness.mia_mlp_sampling(harness.AuditSpec(**kw), (0.25, 1.0),
                                   device=CPU)
    sync = harness.mia_mlp(harness.AuditSpec(**kw), device=CPU)
    assert res[1.0] == sync
    assert res[0.25]["mi_bound"] == pytest.approx(0.25 * sync["mi_bound"])


def test_keep_views_sum_to_transmitted():
    """FSASharded views are the masked decomposition of the transmitted
    payload: disjoint supports, int8 wire included."""
    spec = harness.AuditSpec(A=4, rounds=3, int8_wire=True, seed=5,
                             n_bootstrap=0)
    params0, loss_fn, batches, _, _ = harness.mlp_canary_problem(
        spec, device=CPU)
    _, _, views_ = harness.capture_run(spec, params0, loss_fn, batches,
                                       device=CPU)
    views_ = views_.numpy()
    total = views_.sum(axis=1)
    np.testing.assert_allclose(np.abs(views_).sum(axis=1), np.abs(total),
                               rtol=1e-6, atol=1e-6)
    assert np.abs(total).max() > 0


def test_dlg_against_int8_wire_not_better_than_f32():
    """DLG against the dequantized int8 payload does not reconstruct
    better than against the f32 view, at full view and under 1/8
    sharding; sharding still degrades the attack."""
    f32 = harness.dlg_mlp([1, 8], wire="f32", steps=300, device=CPU)
    s8 = harness.dlg_mlp([1, 8], wire="int8", steps=300, device=CPU)
    for A in (1, 8):
        assert s8[A] >= f32[A] - 0.05, (A, s8, f32)
    assert s8[8] > 2 * s8[1]
    assert f32[1] < 0.5


# ------------------------------------------------ the repairs it rests on
def test_run_scanned_collects_views_and_refuses_without_them():
    """``FLRun.run_scanned(collect_views=True)`` stacks the rounds' views
    (T, A, K, n), the views ``step`` returns round by round; a pipeline
    with no adversary view raises the reference's error."""
    spec = harness.AuditSpec(A=2, rounds=3, K=2, n_canaries=2, seed=4)
    params0, loss_fn, batches, _, _ = harness.mlp_canary_problem(
        spec, device=CPU)
    stacked = tuple(torch.stack([b] * 3) for b in batches)
    run = harness.FLRun(harness.fl_config(spec), params0, loss_fn,
                        device=CPU)
    xs, got = run.run_scanned(stacked, collect_views=True)
    step = harness.FLRun(harness.fl_config(spec), params0, loss_fn,
                         device=CPU)
    want = torch.stack([step.step(batches, collect_views=True)
                        for _ in range(3)])
    assert torch.equal(got, want) and torch.equal(xs[-1], step.x)
    plain = harness.FLRun(dataclasses.replace(harness.fl_config(spec),
                                              method="min_leakage"),
                          params0, loss_fn, device=CPU)
    with pytest.raises(ValueError, match="exposes no adversary view"):
        plain.run_scanned(stacked, collect_views=True)
    assert plain.run_scanned(stacked).shape == (3, plain.n)


def test_assign_override_pins_the_simulator_masks():
    """``FSASharded.assign_override`` wins over the scheme, as the
    reference's: both packages' views under one explicit assignment
    agree to 1e-6, and their supports follow it exactly."""
    from repro.core.fl import FLRun as RefRun
    spec = ref_harness.AuditSpec(A=3, rounds=2, K=2, n_canaries=2, seed=6)
    params0, loss_fn, batches, _, _ = ref_harness.mlp_canary_problem(spec)
    n = jax.flatten_util.ravel_pytree(params0)[0].shape[0]
    assign = np.random.default_rng(0).integers(0, 3, n).astype(np.int32)
    ref_run = RefRun(ref_harness.fl_config(spec), params0, loss_fn)
    ref_run.pipeline = dataclasses.replace(
        ref_run.pipeline, aggregate=dataclasses.replace(
            ref_run.pipeline.aggregate, assign_override=jnp.asarray(assign)))
    want = np.asarray(ref_run.step(batches, collect_views=True))
    _, port_loss = harness.mlp_model(device=CPU)
    run = harness.FLRun(harness.fl_config(harness.AuditSpec(
        A=3, rounds=2, K=2, n_canaries=2, seed=6)), params_from_jax(
        jax.tree.map(np.asarray, params0), device=CPU), port_loss,
        device=CPU)
    run.pipeline = dataclasses.replace(
        run.pipeline, aggregate=dataclasses.replace(
            run.pipeline.aggregate, assign_override=torch.from_numpy(assign)))
    got = run.step(tuple(_t(b) for b in batches), collect_views=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for a in range(3):
        assert np.abs(got[a][:, assign != a]).max() == 0
    np.testing.assert_allclose(run.x.numpy(), np.asarray(ref_run.x),
                               rtol=0, atol=1e-6)


def test_inputs_embeds_replaces_the_lookup():
    """``forward``/``loss_fn`` take ``inputs_embeds``: the embedding rows
    give the token path's loss bit for bit, and the DLG hook's second
    derivative (the match loss's gradient in the embeddings, through the
    parameter gradient) agrees with the reference's to 1e-4."""
    from repro.models import transformer as ref_tr
    from repro_torch.models import transformer as tr
    cfg, ref_cfg = harness.tiny_lm_config(), ref_harness.tiny_lm_config()
    jparams = ref_tr.init_params(jax.random.PRNGKey(1), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 8))
    tt = torch.from_numpy(toks)
    emb = params["embed"][tt]
    assert torch.equal(
        tr.loss_fn(params, cfg, {"tokens": tt}),
        tr.loss_fn(params, cfg, {"tokens": tt, "inputs_embeds": emb}))
    x_flat, unravel = ravel_params(params)
    grad_fn = harness.flat_grad(
        lambda p, d: tr.loss_fn(p, cfg, {"tokens": tt, "inputs_embeds": d}),
        unravel, create_graph=True)
    dummy = (0.1 * torch.arange(emb.numel(), dtype=torch.float32)
             .reshape(emb.shape).sin()).requires_grad_()
    g_obs = grad_fn(x_flat, emb).detach()
    with torch.enable_grad():
        match = torch.sum((grad_fn(x_flat, dummy) - g_obs) ** 2)
        got = torch.autograd.grad(match, dummy)[0]
    jx, junravel = jax.flatten_util.ravel_pytree(jparams)

    def jgrad(xf, d):
        return jax.grad(lambda f: ref_tr.loss_fn(
            junravel(f), ref_cfg,
            {"tokens": jnp.asarray(toks), "inputs_embeds": d}))(xf)

    jg_obs = jgrad(jx, jnp.asarray(emb.numpy()))
    want = jax.grad(lambda d: jnp.sum((jgrad(jx, d) - jg_obs) ** 2))(
        jnp.asarray(dummy.detach().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want)).max())
    out = harness.dlg_lm(cfg, [1], steps=2, params0=params, device=CPU)
    assert np.isfinite(out[1])
