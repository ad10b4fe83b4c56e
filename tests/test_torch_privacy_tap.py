"""The distributed step's adversary-view tap (``TrainSettings.
capture_views``) against the reference's shard_map tap, on the CPU, four
ranks.

One JAX subprocess runs the reference's step on four forced host devices
and one ``torch.distributed.run`` launch runs the port's on four gloo
ranks, side by side, from the same numpy params and tokens
(``privacy.harness.tiny_lm_config``), two sgd steps with keys
``PRNGKey(i)``, in four settings: the int8 wire with DSC at p 1 (the
reference's three-engine view-parity settings), the f32 wire,
``ldp_int8+agg_fail`` (dead aggregators and dead links in both steps) and
the FedBuff buffer on the int8 wire with client dropout (two clients drop
in the first step).  Each round's captured leaves, gathered over the
ranks, go through ``privacy.views.flat_views_from_leaves`` into the
simulator's ``(A, K, n)`` form.

Tolerances (``CONFIGS``), measured with these inputs: the f32 wire's
views agree with the reference's to 2.0e-7 (the frameworks' gradients
differ in the last bits); on the int8 wire a code flips where a draw
falls within an ulp of its fraction, which moves a view coordinate by one
quantization step of its block: 2.0e-4 with DSC, 9.7e-4 under the buffer
(atol 1e-3); ``ldp_int8+agg_fail`` 3.6e-7, no code flipped, but its
blocks carry the LDP noise (sigma 0.6), so a flip would move a
coordinate by ~2e-2 (atol 3e-2, the reference's own int8 band).  Every
mean error is below 2e-9 (held to 1e-6).  Supports and dropped rows are held exactly: zero off each
aggregator's mask, and zero in the same (round, aggregator, client) rows
as the reference's.  The port's simulator, pinned by ``FSASharded.
assign_override`` to ``mesh_flat_assignment``, agrees with the port's
tap within the int8 band (the reference's slow three-engine assertions
at this size).
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from conftest import SUBPROC_ENV  # noqa: E402
from repro.privacy import views as ref_views  # noqa: E402
from repro_torch.core.compressors import RandP  # noqa: E402
from repro_torch.core.fl import FLConfig, FLRun  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.privacy import harness, views  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
A, STEPS, B, S, LR = 4, 2, 8, 32, 0.05
LDP_AGG_FAIL = dict(grad_dtype="float32", int8_wire=True, ldp_eps=8.0,
                    ldp_delta=1e-5, ldp_clip=1.0, agg_dropout=0.25,
                    link_failure=0.1)
# (name, TrainSettings fields, views' atol, the params' error after the
# steps as a share of the reference's motion): every one with
# capture_views.  Measured shares: dsc_int8 2.7e-4, f32 1.3e-5 (one ulp
# of the norm scales, ~1, against a motion of 9e-3 in two steps),
# ldp_int8+agg_fail 1.1e-6 (the noise is most of the motion), the
# buffer 2.0e-3 (two clients dropped: less motion for the same flipped
# codes)
CONFIGS = [
    ("dsc_int8", dict(grad_dtype="float32", int8_wire=True, use_dsc=True,
                      dsc_p=1.0, dsc_gamma=0.5), 1e-3, 1e-3),
    ("f32", dict(grad_dtype="float32"), 1e-6, 5e-5),
    ("ldp_int8+agg_fail", LDP_AGG_FAIL, 3e-2, 1e-5),
    ("async_int8_drop", dict(grad_dtype="float32", int8_wire=True,
                             async_buffer=True, client_dropout=0.25), 1e-3,
     5e-3),
]


def _cfg():
    return harness.tiny_lm_config()


def _inputs(seed=0):
    """params0 (a flat dict "path" -> f32 array, flatten order) and the
    (B, S) tokens, from numpy."""
    rng = np.random.default_rng(seed)
    cfg = _cfg()
    params = {}
    for path, shape in sh.spec_items(cfg):
        if path[-1].startswith("ln"):
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            x = rng.standard_normal(shape) * shape[-2] ** -0.5 \
                if len(shape) >= 2 else rng.standard_normal(shape)
        params["/".join(path)] = x.astype(np.float32)
    return params, rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


REF_SCRIPT = textwrap.dedent("""
    import os, sys, json
    work = sys.argv[1]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import (TrainSettings, init_dsc_state,
                                    make_train_step)
    from repro.optim import sgd
    from repro.privacy.harness import tiny_lm_config

    spec = json.load(open(os.path.join(work, "configs.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    cfg = tiny_lm_config()
    mesh = make_host_mesh(data=4, model=1)
    params0 = {}
    for key in raw.files:
        if key == "tokens":
            continue
        node, path = params0, key.split("/")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(raw[key])
    out = {}
    for name, fields in spec["configs"]:
        settings = TrainSettings(capture_views=True, **fields)
        opt = sgd(spec["lr"])
        step, shardings = make_train_step(cfg, mesh, opt, settings)
        with mesh:
            params = jax.device_put(params0, shardings["store"])
            opt_state = opt.init(params)
            dsc = init_dsc_state(cfg, mesh, settings)
            jstep = jax.jit(step)
            for t in range(spec["steps"]):
                params, opt_state, dsc, m, v = jstep(
                    params, opt_state, dsc, {"tokens": raw["tokens"]},
                    jax.random.PRNGKey(t))
                for i, x in jax.device_get(v).items():
                    out[f"{name}/v{t}/{i}"] = np.asarray(x, np.float32)
        for i, x in enumerate(jax.tree.leaves(jax.device_get(params))):
            out[f"{name}/p{i}"] = np.asarray(x, np.float32)
    np.savez(os.path.join(work, "ref.npz"), **out)
""")

PORT_WORKER = textwrap.dedent("""
    import os, sys, json
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.convert import tree_leaves
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.launch.train import (TrainSettings, init_dsc_state,
                                          make_train_step, store_params)
    from repro_torch.optim import sgd
    from repro_torch.privacy.harness import tiny_lm_config

    work = sys.argv[1]
    spec = json.load(open(os.path.join(work, "configs.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    device = init_process_group("cpu")
    mesh = make_host_mesh(device="cpu")
    rank = dist.get_rank()
    cfg = tiny_lm_config()
    out = {}
    for name, fields in spec["configs"]:
        params0 = {}
        for key in raw.files:
            if key == "tokens":
                continue
            node, path = params0, key.split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = torch.from_numpy(raw[key])
        settings = TrainSettings(capture_views=True, **fields)
        opt = sgd(spec["lr"])
        step = make_train_step(cfg, mesh, opt, settings, device="cpu")
        params = store_params(params0, cfg, mesh, settings)
        opt_state = opt.init(params)
        dsc = init_dsc_state(cfg, mesh, settings, device="cpu")
        batch = {"tokens": torch.from_numpy(raw["tokens"])}
        for t in range(spec["steps"]):
            params, opt_state, dsc, m, v = step(params, opt_state, dsc,
                                                batch, random.PRNGKey(t))
            for i, x in v.items():
                assert x.dtype == torch.float32 and x.shape[0] == 1
                out[f"{name}/v{t}/{i}"] = x.numpy()
        for i, x in enumerate(tree_leaves(params)):
            out[f"{name}/p{i}"] = x.float().numpy()
    np.savez(os.path.join(work, f"port_{rank}.npz"), **out)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's and the port's four-rank launches, side by side.
    Returns (the reference's arrays, the port's ranks' arrays)."""
    work = tmp_path_factory.mktemp("tap")
    params, toks = _inputs()
    np.savez(work / "inputs.npz", tokens=toks, **params)
    (work / "configs.json").write_text(json.dumps(
        {"configs": [[n, f] for n, f, _, _ in CONFIGS], "steps": STEPS,
         "lr": LR}))
    (work / "worker.py").write_text(PORT_WORKER)
    procs = [
        subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work)],
                         cwd=REPO, env=SUBPROC_ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True),
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
    return (dict(np.load(work / "ref.npz")),
            [dict(np.load(work / f"port_{r}.npz")) for r in range(A)])


def _abstract():
    return sh.shape_tree(_cfg(), lambda shape: np.zeros(shape, np.float32))


def _flat_views(arrays, name, gather):
    """(T, A, K, n) flat views of one configuration: ``gather(arrays,
    name, t, i)`` gives round t's (A, K, m) leaf i."""
    scattered = [lay.index for lay in views.view_layouts(_abstract(), A)
                 if lay.dim >= 0]
    return np.stack([views.flat_views_from_leaves(
        {str(i): gather(arrays, name, t, i) for i in scattered},
        _abstract(), A) for t in range(STEPS)])


def _ref_leaf(ref, name, t, i):
    return ref[f"{name}/v{t}/{i}"]


def _port_leaf(ranks, name, t, i):
    return np.concatenate([r[f"{name}/v{t}/{i}"] for r in ranks], axis=0)


@pytest.mark.parametrize("name,atol", [(n, a) for n, _, a, _ in CONFIGS],
                         ids=[n for n, _, _, _ in CONFIGS])
def test_tap_views_match_the_reference(runs, name, atol):
    """The port's gathered views equal the reference's shard_map views
    within the stated band, exactly zero off each aggregator's mask and
    in the same dropped rows; the params after the two steps agree as
    ``tests/test_torch_train.py``'s rows do."""
    ref, ranks = runs
    assign = views.mesh_flat_assignment(_abstract(), A)
    assert (assign >= 0).all()          # every tiny-lm leaf is scattered
    got = _flat_views(ranks, name, _port_leaf)
    want = _flat_views(ref, name, _ref_leaf)
    # the reference's own reassembly of the reference's payloads: equal
    want_ref = np.stack([ref_views.flat_views_from_leaves(
        {k.split("/")[-1]: v for k, v in ref.items()
         if k.startswith(f"{name}/v{t}/")}, _abstract(), A)
        for t in range(STEPS)])
    np.testing.assert_array_equal(want, want_ref)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.abs(got - want).mean() < 1e-6
    for a in range(A):
        assert np.abs(got[:, a][:, :, assign != a]).max() == 0
    # dropped rows (dead links, dead aggregators, dropped clients): the
    # same (round, aggregator, client) rows are zero in both
    dead_got = np.abs(got).sum(-1) == 0
    np.testing.assert_array_equal(dead_got, np.abs(want).sum(-1) == 0)
    if name in ("ldp_int8+agg_fail", "async_int8_drop"):
        assert dead_got.any() and not dead_got.all()


def test_tap_params_follow_the_reference(runs):
    """After two steps, every rank's store shards equal the reference's
    segments within the rows' tolerances (``CONFIGS``, a share of the
    reference's motion)."""
    ref, ranks = runs
    params, _ = _inputs()
    leaves0 = list(params.values())
    for name, _, _, share in CONFIGS:
        err = motion = 0.0
        for i, x0 in enumerate(leaves0):
            d = sh.scatter_dim_for(x0.shape, A)
            got = (np.concatenate([r[f"{name}/p{i}"] for r in ranks],
                                  axis=d) if d >= 0
                   else ranks[0][f"{name}/p{i}"])
            want = ref[f"{name}/p{i}"]
            err = max(err, float(np.abs(got - want).max()))
            motion = max(motion, float(np.abs(want - x0).max()))
        assert motion > 0 and err <= share * motion, (name, err / motion)


def test_simulator_pinned_to_the_mesh_matches_the_tap(runs):
    """The port's simulator with the mesh-induced assignment
    (``assign_override``) on the reference's view-parity settings sees
    the views the port's tap captured, within the int8 band, and lands
    on its params."""
    ref, ranks = runs
    cfg = _cfg()
    params, toks = _inputs()
    tree = {}
    for key, x in params.items():
        node, path = tree, key.split("/")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.from_numpy(x)
    assign = torch.from_numpy(views.mesh_flat_assignment(_abstract(), A))
    fl_cfg = FLConfig(method="eris", K=A, A=A, lr=LR, use_dsc=True,
                      gamma=0.5, int8_wire=True, keep_views=True,
                      rounds=STEPS, compressor=RandP(p=1.0))
    run = FLRun(fl_cfg, tree, lambda p, b: tr.loss_fn(p, cfg, b),
                device="cpu")
    agg = dataclasses.replace(run.pipeline.aggregate, assign_override=assign)
    run.pipeline = dataclasses.replace(run.pipeline, aggregate=agg)
    batches = {"tokens": torch.from_numpy(toks).reshape(A, B // A, S)}
    stacked = {"tokens": torch.stack([batches["tokens"]] * STEPS)}
    _, sim = run.run_scanned(stacked, collect_views=True)
    sim = sim.numpy()
    dist_views = _flat_views(ranks, "dsc_int8", _port_leaf)
    np.testing.assert_allclose(dist_views, sim, atol=3e-2)
    assert np.abs(dist_views - sim).mean() < 1e-3
    for a in range(A):
        assert np.abs(sim[:, a][:, :, (assign != a).numpy()]).max() == 0
    # Eq. 4 end to end: the DSC-compensated distributed model follows
    # the simulator
    dist_x = []
    for i, (key, x0) in enumerate(params.items()):
        d = sh.scatter_dim_for(x0.shape, A)
        dist_x.append(np.concatenate(
            [r[f"dsc_int8/p{i}"] for r in ranks], axis=d).reshape(-1))
    np.testing.assert_allclose(np.concatenate(dist_x), run.x.numpy(),
                               atol=1e-2)
    assert np.abs(run.x.numpy() - np.concatenate(
        [x.reshape(-1) for x in params.values()])).max() > 1e-3
