"""The port's distributed step under the scenario and async knobs against
the reference's, on the CPU, four ranks.

The 15 feasible cells of the defense x failure matrix
(``repro.core.rounds.scenarios``), each as the ``TrainSettings`` the
reference's own ``benchmarks/scenario_snapshot.py::_dist_settings_kw``
makes of it, step three times on the reference's shard_map step (four
forced host devices) and on the port's (four gloo ranks), with
``tests/test_torch_train.py``'s launches, inputs and tolerance scheme:
the params' error as a share of the reference's motion, with the planted
fault (one rank's rows left out) beyond each row's tolerance.
``none+none`` and ``int8+none`` are that file's ``fsa_sgd`` and ``int8``
rows and are not run again.  The cells are cut over two launches: the
wire cells (none, int8, dsc_int8) here, the LDP and secure-aggregation
cells in ``tests/test_torch_train_scenarios_ldp.py``.  This file's launch
also runs the port's FedBuff step alone: against the port's
``eris_async`` simulator, and with trivial arrivals and cadence 1
against the synchronous step, bit for bit.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from conftest import SUBPROC_ENV  # noqa: E402
from repro.core.rounds import scenarios as ref_scenarios  # noqa: E402
from repro_torch import random  # noqa: E402
from repro_torch.core import fl  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from test_torch_train import (A, B, LR, PORT_WORKER, REF_SCRIPT, S,  # noqa: E402
                              STEPS, _assemble, _cfg, _dims, _dist, _inputs,
                              _port_params)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _dist_settings_kw():
    spec = importlib.util.spec_from_file_location(
        "scenario_snapshot", REPO / "benchmarks" / "scenario_snapshot.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._dist_settings_kw


# (cell, tolerances: the params' error as a share of the motion, the
# losses' and grad norms' relative error).  Measured with these inputs,
# params (the planted fault in brackets): none+agg_fail 3.2e-6 (0.79),
# none+client_drop 3.2e-6 (0.77), as the healthy f32 row; int8+agg_fail
# 2.6e-4 (0.79), int8+client_drop 2.3e-4 (0.77), dsc_int8+none 3.2e-4
# (0.66), dsc_int8+agg_fail 2.7e-4 (0.76), the int8 wire's flipped codes;
# ldp+none 1.4e-7 (1.3e-3), ldp+agg_fail 1.3e-7 (1.5e-3), ldp+client_drop
# 1.4e-7 (1.5e-3): the Gaussian noise (sigma 0.61 a coordinate, within
# normal's 4 ulps of jax's) is most of the motion, so both the error and
# the fault are smaller shares of it; ldp_int8+none 3.8e-5 (2.8e-3),
# +agg_fail 4.6e-5 (3.2e-3), +client_drop 3.4e-5 (3.1e-3); secure_agg+none
# 2.6e-4 (0.63), of which all but the unmasked row's 3e-6 is f32
# absorption: each rank's gradient rides on masks of up to 3 x 100, so it
# keeps ~2**-15 absolute, and the masked rows' partial sums round where
# gloo adds them in another order than XLA (the masks still cancel
# exactly).  Metrics <= 2.1e-6 everywhere.
ALREADY_RUN = {"none+none", "int8+none"}     # tests/test_torch_train.py
TOLERANCES = {
    "none+agg_fail": (1e-5, 1e-5),
    "none+client_drop": (1e-5, 1e-5),
    "int8+agg_fail": (1e-3, 1e-4),
    "int8+client_drop": (1e-3, 1e-4),
    "dsc_int8+none": (1e-3, 1e-4),
    "dsc_int8+agg_fail": (1e-3, 1e-4),
    "ldp+none": (1e-6, 1e-5),
    "ldp+agg_fail": (1e-6, 1e-5),
    "ldp+client_drop": (1e-6, 1e-5),
    "ldp_int8+none": (2e-4, 1e-4),
    "ldp_int8+agg_fail": (2e-4, 1e-4),
    "ldp_int8+client_drop": (2e-4, 1e-4),
    "secure_agg+none": (1e-3, 1e-5),
}
CELLS = [c.name for c in ref_scenarios.scenario_matrix()
         if c.name not in ALREADY_RUN]
# the cells this file runs; the LDP and secure-aggregation ones are
# tests/test_torch_train_scenarios_ldp.py's, one launch each
LDP_CELLS = [c for c in CELLS if c.startswith(("ldp", "secure_agg"))]
WIRE_CELLS = [c for c in CELLS if c not in LDP_CELLS]
# the port alone: its FedBuff step on the int8 wire with trivial arrivals,
# cadence 2 over four steps against its simulator, and cadence 1 against
# the synchronous step
ASYNC_STEPS, CADENCE = 4, 2
PORT_ONLY = [
    ("async_sim", "float32", ["sgd", LR],
     dict(grad_dtype="float32", int8_wire=True, async_buffer=True,
          buffer_cadence=CADENCE)),
    ("async_c1", "float32", ["sgd", LR],
     dict(grad_dtype="float32", int8_wire=True, async_buffer=True)),
    ("sync_int8", "float32", ["sgd", LR],
     dict(grad_dtype="float32", int8_wire=True)),
]


def _rows(cells):
    kw = _dist_settings_kw()
    return [(name, "float32", ["sgd", LR], kw(ref_scenarios.get(name)))
            for name in cells]


def launch(tmp_path_factory, cells, port_only):
    """The reference's and the port's four-rank launches, side by side,
    of ``cells`` (and the port's own ``port_only`` rows).  Returns (the
    reference's arrays, the port's ranks' arrays)."""
    work = tmp_path_factory.mktemp("scenarios")
    params, toks = _inputs()
    np.savez(work / "inputs.npz", tokens=toks, **params)
    (work / "configs.json").write_text(json.dumps(
        {str(A): _rows(cells), "steps": STEPS, "ckpt": None,
         "port_only": {str(A): port_only},
         "steps_of": {"async_sim": ASYNC_STEPS}, "traj": ["async_sim"]}))
    (work / "worker.py").write_text(PORT_WORKER)
    procs = [
        subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work),
                          str(A)], cwd=REPO, env=SUBPROC_ENV,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True),
        subprocess.Popen([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", str(A),
                          str(work / "worker.py"), str(work)],
                         cwd=REPO, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)]
    try:
        results = [proc.communicate(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (_, err) in zip(procs, results):
        assert proc.returncode == 0, err[-3000:]
    return (dict(np.load(work / f"ref{A}.npz")),
            [dict(np.load(work / f"port{A}_{r}.npz")) for r in range(A)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The wire cells (none, int8, dsc_int8) and the port-only FedBuff
    rows."""
    return launch(tmp_path_factory, WIRE_CELLS, PORT_ONLY)


def test_the_draws_exercise_every_failure_and_arrival_path():
    """At four ranks and keys ``PRNGKey(0..2)`` the scenario pack's failure
    draws kill aggregators 2 and 3, then 2, then 1 and 3, and one to
    three links at every step, and its arrival draw drops clients 0 and
    2 at step 1 (the draws equal jax's, tests/test_torch_train_draws.py):
    every ``agg_fail`` and ``client_drop`` row runs its path."""
    cell = ref_scenarios.get("none+agg_fail").knobs
    dead_aggs, dead_links, dropped = [], [], []
    arrival = train.TrainSettings(
        async_buffer=True,
        client_dropout=ref_scenarios.get("none+client_drop").knobs[
            "client_dropout"]).arrival_model()
    for i in range(STEPS):
        agg, link, _ = train.failure_draws(
            random.PRNGKey(i), A, cell["agg_dropout"], cell["link_failure"])
        dead_aggs.append([a for a in range(A) if agg[a] == 0])
        dead_links.append(int((link == 0).sum()))
        _, alive, _, _ = train.arrival_draws(random.PRNGKey(i), A, arrival)
        dropped.append([k for k in range(A) if not alive[k]])
    assert dead_aggs == [[2, 3], [2], [1, 3]]
    assert all(1 <= d <= 3 for d in dead_links), dead_links
    assert dropped[0] == [0, 2], dropped


def check_cell(runs, name):
    """Params, losses and grad norms after three steps within the cell's
    tolerance of the reference's, the planted fault beyond it; the
    FedBuff buffer (u, w, t) of the ``client_drop`` cells too; losses and
    grad norms equal on every rank."""
    ref, ranks = runs
    tol, metric_tol = TOLERANCES[name]
    fields = {n: f for n, _, _, f in _rows([name])}[name]
    dims = _dims(fields)
    want = [ref[f"{name}/p{i}"] for i in range(len(dims))]
    got = _port_params(ranks, name, fields)
    p0 = list(_inputs()[0].values())
    motion = _dist(want, p0)
    err = _dist(got, want) / motion
    fault = _dist([ref[f"{name}/fault_p{i}"] for i in range(len(dims))],
                  want) / motion
    assert err <= tol < fault, (
        f"{name}: params error {err:.3e} of the motion (tol {tol:.0e}); "
        f"a step without one rank's rows {fault:.3e}")
    for metric in ("loss", "gnorm"):
        r, p = ref[f"{name}/{metric}"], ranks[0][f"{name}/{metric}"]
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[f"{name}/{metric}"], p)
        rel = np.abs(p - r) / np.maximum(np.abs(r), 1e-30)
        assert (rel <= metric_tol).all(), f"{name} {metric}: {p} vs {r}"
    if fields.get("async_buffer"):
        for key in ("buf_w", "buf_t"):
            np.testing.assert_array_equal(ranks[0][f"{name}/{key}"],
                                          ref[f"{name}/{key}"])
        # cadence 1: every round applies, so both buffers end empty
        for i, d in enumerate(dims):
            np.testing.assert_array_equal(
                _assemble(ranks, f"{name}/buf_u{i}", d),
                ref[f"{name}/buf_u{i}"])


@pytest.mark.parametrize("name", WIRE_CELLS)
def test_scenario_cell_matches_reference_step(runs, name):
    check_cell(runs, name)


def _flat(ranks, name, fields, step=None):
    suffix = "" if step is None else f"@{step}"
    return np.concatenate([
        _assemble(ranks, f"{name}/p{i}{suffix}", d).ravel()
        for i, d in enumerate(_dims(fields))])


def test_async_step_tracks_the_simulator(runs):
    """The port's FedBuff step (int8 wire, cadence 2, trivial arrivals,
    four ranks) against the port's ``FLRun(eris_async, K=4, A=4,
    int8_wire=True, buffer_cadence=2)`` on the same client rows: within
    1e-2 every round (the int8 draws differ), still at rounds 1 and 3
    and moved at 2 and 4 in both, as the reference's
    ``test_async_buffer_distributed_matches_simulator`` holds its own."""
    _, ranks = runs
    params, toks = _inputs()
    cfg = _cfg()
    tree = {}
    for key, x in params.items():
        node, path = tree, key.split("/")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.from_numpy(x)
    run = fl.FLRun(fl.FLConfig(method="eris_async", K=A, A=A, lr=LR,
                               int8_wire=True, buffer_cadence=CADENCE,
                               rounds=ASYNC_STEPS), tree,
                   lambda p, b: tr.loss_fn(p, cfg, b), device="cpu")
    batches = {"tokens": torch.from_numpy(toks).reshape(A, B // A, S)}
    x0 = run.x.numpy().copy()
    sim, dist = [], []
    fields = PORT_ONLY[0][3]
    for t in range(ASYNC_STEPS):
        run.step(batches)
        sim.append(run.x.numpy().copy())
        dist.append(_flat(ranks, "async_sim", fields, t))
    np.testing.assert_allclose(np.stack(dist), np.stack(sim), atol=1e-2)
    for traj in (sim, dist):
        prev = [x0] + traj[:-1]
        moved = [bool(np.abs(a - b).max() > 0) for a, b in zip(traj, prev)]
        assert moved == [False, True, False, True], moved
    assert np.abs(sim[-1] - x0).max() > 1e-3


def test_trivial_async_step_equals_the_synchronous_step(runs):
    """With trivial arrivals and cadence 1 the FedBuff fold is an IEEE
    identity (0 + 1.0 g, then u / 1.0): the port's async step lands on
    its synchronous step bit for bit, and its buffer is empty (w 0, t 3)."""
    _, ranks = runs
    a = _flat(ranks, "async_c1", PORT_ONLY[1][3])
    b = _flat(ranks, "sync_int8", PORT_ONLY[2][3])
    assert (a.view(np.int32) == b.view(np.int32)).all()
    for r in ranks:
        assert float(r["async_c1/buf_w"]) == 0.0
        assert int(r["async_c1/buf_t"]) == STEPS
        for key in ("loss", "gnorm"):
            np.testing.assert_array_equal(r[f"async_c1/{key}"],
                                          r[f"sync_int8/{key}"])
