"""The port's distributed FSA step on a (data, model) mesh against the
reference's, on the CPU.

The reference's ``make_train_step`` runs in one JAX subprocess on four
forced host devices: ``make_host_mesh(data=2, model=2)`` for the
configurations of ``CONFIGS`` (qwen2-0.5b's smoke config at one layer:
attention, FFN and vocab sharded, the ring conjugates), and a ``(1, 3)``
mesh over three devices for ``FALLBACK`` (xlstm-350m's smoke config,
whose plan is inactive at 3: the model axis splits the group's batch).
The port's runs in one ``torch.distributed.run --nproc-per-node 4``
launch of a worker script this test writes: ``make_host_mesh(data=2,
model=2)`` over four gloo ranks, and for the fallback a mesh of ranks
0-2 built from groups by hand (rank 3 sits it out).  Both start from the
same numpy params and tokens and step with the same keys.  Params,
losses, grad norms, the DSC state and the captured views are compared
after the steps, each rank's pieces assembled through the composite
store layout (model at the TP dim, data at the TP-local scatter dim), with
the tolerances stated at ``CONFIGS``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
from conftest import SUBPROC_ENV  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import tree_leaves  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.models import shard_plan as sp  # noqa: E402

STEPS, B, S, LR = 3, 8, 32, 0.05
# (name, arch, ModelConfig overrides, TrainSettings fields, (data, model),
# rows of the batch, tolerances: the params' error as a share of the
# reference's motion, the metrics' relative error, the DSC state's and
# the views' relative error).  As in tests/test_torch_train.py: the f32
# wires to 1e-5; on the int8 wire a code flips where a draw falls within
# an ulp of its fraction, so 1e-3 (the DSC state, which tracks the codes,
# 1e-2).
SMALL = dict(n_layers=1)
CONFIGS = [
    ("fsa_sgd", "qwen2-0.5b", SMALL, dict(grad_dtype="float32"), (2, 2), B,
     1e-5, 1e-5, None),
    # the int8 wire with the adversary-view tap over the model axis
    ("int8_views", "qwen2-0.5b", SMALL,
     dict(grad_dtype="float32", int8_wire=True, capture_views=True),
     (2, 2), B, 1e-3, 1e-4, 1e-3),
    ("dsc_int8_fused", "qwen2-0.5b", SMALL,
     dict(grad_dtype="float32", use_dsc=True, int8_wire=True), (2, 2), B,
     2e-3, 1e-4, 1e-2),
]
# no plan applies (xlstm's smoke config at 3: 2 D, the vocab and the heads
# all indivisible), the batch divides n_client * model: model_split
FALLBACK = [("model_split", "xlstm-350m", SMALL, dict(grad_dtype="float32"),
             (1, 3), 6, 1e-5, 1e-5, None)]
ALL = CONFIGS + FALLBACK


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch).smoke(), **over)


def _inputs() -> dict:
    out = {}
    for k, (name, arch, over, *_ , rows, _t, _m, _s) in enumerate(ALL):
        cfg = _cfg(arch, over)
        rng = np.random.default_rng(2000 + k)
        for path, shape in sh.spec_items(cfg):
            leaf = path[-1]
            if leaf.startswith("ln"):
                x = 1.0 + 0.1 * rng.standard_normal(shape)
            elif leaf.startswith("b"):
                x = 0.05 * rng.standard_normal(shape)
            else:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                x = rng.standard_normal(shape) * fan_in ** -0.5
            out[f"{name}/param/" + "/".join(path)] = x.astype(np.float32)
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab,
                                             (rows, S)).astype(np.int32)
    return out


COMMON = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np

    def case_tree(raw, name, cast):
        tree = {}
        for key in raw.files:
            if key.startswith(name + "/param/"):
                node, path = tree, key[len(name) + 7:].split("/")
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = cast(raw[key])
        return tree
""")

REF_SCRIPT = COMMON + textwrap.dedent("""
    work = sys.argv[1]
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        "--xla_backend_optimization_level=0 "
        "--xla_llvm_disable_expensive_passes=true")
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.dist import sharding as sh
    from repro.launch.train import (TrainSettings, init_dsc_state,
                                    make_train_step)
    from repro.optim import sgd

    spec = json.load(open(os.path.join(work, "spec.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    out = {}
    for name, arch, over, fields, (data, model), *_ in spec["configs"]:
        cfg = dataclasses.replace(get_config(arch).smoke(), **over)
        devs = np.array(jax.devices()[:data * model]).reshape(data, model)
        mesh = Mesh(devs, ("data", "model"))
        opt = sgd(spec["lr"])
        settings = TrainSettings(**fields)
        step, shardings = make_train_step(cfg, mesh, opt, settings)
        params0 = case_tree(raw, name, jnp.asarray)
        with mesh:
            params = jax.device_put(params0, shardings["store"])
            opt_state = jax.device_put(
                opt.init(params),
                sh.opt_state_shardings(cfg, mesh, opt, params0))
            dsc = init_dsc_state(cfg, mesh, settings)
            jstep = jax.jit(step)
            batch = {"tokens": jnp.asarray(raw[name + "/tokens"])}
            loss, gnorm = [], []
            for i in range(spec["steps"]):
                res = jstep(params, opt_state, dsc, batch,
                            jax.random.PRNGKey(i))
                params, opt_state, dsc, m = res[:4]
                loss.append(float(m["loss"]))
                gnorm.append(float(m["grad_norm"]))
                if settings.capture_views:
                    for key, v in res[4].items():
                        out[f"{name}/view{key}@{i}"] = np.asarray(v)
        for i, x in enumerate(jax.tree.leaves(jax.device_get(params))):
            out[f"{name}/p{i}"] = np.asarray(x, np.float32)
        if settings.use_dsc:
            for part in ("s_clients", "s_agg"):
                for i, x in enumerate(jax.tree.leaves(
                        jax.device_get(dsc[part]))):
                    out[f"{name}/{part}{i}"] = np.asarray(x, np.float32)
        out[f"{name}/loss"] = np.asarray(loss)
        out[f"{name}/gnorm"] = np.asarray(gnorm)
    np.savez(os.path.join(work, "ref.npz"), **out)
""")

PORT_WORKER = COMMON + textwrap.dedent("""
    work = sys.argv[1]
    import torch
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.launch.train import (TrainSettings, init_dsc_state,
                                          make_train_step, store_params)
    from repro_torch.optim import sgd

    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(work, "spec.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    init_process_group("cpu")
    rank = dist.get_rank()


    class HandMesh:
        # a (data, model) mesh over some of the ranks, from its groups
        mesh_dim_names = ("data", "model")

        def __init__(self, shape, groups):
            self.shape, self.groups = shape, groups

        def size(self, i):
            return self.shape[i]

        def get_group(self, name):
            return self.groups[name]


    meshes = {(2, 2): make_host_mesh(data=2, model=2, device="cpu")}
    # (1, 3) over ranks 0-2; every rank makes every group
    model3 = dist.new_group([0, 1, 2])
    singles = [dist.new_group([r]) for r in range(3)]
    if rank < 3:
        meshes[(1, 3)] = HandMesh((1, 3), {"data": singles[rank],
                                           "model": model3})
    out = {}
    for name, arch, over, fields, shape, *_ in spec["configs"]:
        shape = tuple(shape)
        if shape not in meshes:
            continue
        mesh = meshes[shape]
        cfg = dataclasses.replace(get_config(arch).smoke(), **over)
        opt = sgd(spec["lr"])
        settings = TrainSettings(**fields)
        step = make_train_step(cfg, mesh, opt, settings, device="cpu")
        params = store_params(case_tree(raw, name, torch.from_numpy), cfg,
                              mesh, settings)
        opt_state = opt.init(params)
        dsc = init_dsc_state(cfg, mesh, settings, device="cpu")
        batch = {"tokens": torch.from_numpy(raw[name + "/tokens"])}
        loss, gnorm = [], []
        for i in range(spec["steps"]):
            res = step(params, opt_state, dsc, batch, random.PRNGKey(i))
            params, opt_state, dsc, m = res[:4]
            loss.append(float(m["loss"]))
            gnorm.append(float(m["grad_norm"]))
            if settings.capture_views:
                for key, v in res[4].items():
                    out[f"{name}/view{key}@{i}"] = v.numpy()
        for i, x in enumerate(tree_leaves(params)):
            out[f"{name}/p{i}"] = x.float().numpy()
        if settings.use_dsc:
            for part in ("s_clients", "s_agg"):
                for i, x in enumerate(tree_leaves(dsc[part])):
                    out[f"{name}/{part}{i}"] = x.float().numpy()
        out[f"{name}/loss"] = np.asarray(loss)
        out[f"{name}/gnorm"] = np.asarray(gnorm)
    np.savez(os.path.join(work, f"port_{rank}.npz"), **out)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's four-rank launch, side by
    side.  Returns (the reference's arrays, the four ranks' arrays)."""
    work = tmp_path_factory.mktemp("tp_step")
    (work / "spec.json").write_text(json.dumps(
        {"configs": ALL, "steps": STEPS, "lr": LR}))
    np.savez(work / "inputs.npz", **_inputs())
    (work / "worker.py").write_text(PORT_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work)],
                         cwd=repo, env=SUBPROC_ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", str(work / "worker.py"), str(work)],
            cwd=repo, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
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
            [dict(np.load(work / f"port_{r}.npz")) for r in range(4)])


def _assemble(pieces, tp_dim, fsa_dim, shift=0):
    """A leaf's global value from the pieces of ranks (a, j), ``pieces[a]
    [j]``: each model position's TP-local leaf joined over the data ranks
    at its scatter dim, then the positions joined at the TP dim;
    replicated pieces checked equal first.  ``shift`` moves both dims
    (the client-stacked DSC state)."""
    cols = []
    for j in range(len(pieces[0])):
        rows = [p[j] for p in pieces]
        if fsa_dim >= 0:
            cols.append(np.concatenate(rows, fsa_dim + shift))
        else:
            for r in rows[1:]:
                np.testing.assert_array_equal(r, rows[0])
            cols.append(rows[0])
    if tp_dim >= 0:
        return np.concatenate(cols, tp_dim + shift)
    for c in cols[1:]:
        np.testing.assert_array_equal(c, cols[0])
    return cols[0]


def _rel(a, b):
    a = np.concatenate([np.ravel(x).astype(np.float64) for x in a])
    b = np.concatenate([np.ravel(x).astype(np.float64) for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize(
    "name,arch,over,fields,shape,rows,tol,metric_tol,state_tol", ALL,
    ids=[c[0] for c in ALL])
def test_tp_step_matches_the_references(runs, name, arch, over, fields,
                                        shape, rows, tol, metric_tol,
                                        state_tol):
    """After ``STEPS`` sgd steps: the params within ``tol`` of the
    reference's motion, the losses and grad norms within ``metric_tol``
    (and equal on every rank), the DSC state and the views within
    ``state_tol``."""
    ref, ranks = runs
    data, model = shape
    cfg = _cfg(arch, over)
    plan = sp.build_plan(cfg, model)
    assert plan.active == (name != "model_split")
    mesh = type("M", (), {"mesh_dim_names": ("data", "model"),
                          "size": lambda self, i: shape[i]})()
    specs = tree_leaves(sh.tp_specs(cfg, model))
    dims = tree_leaves(sh.fsa_scatter_dims(cfg, mesh))
    grid = [[ranks[a * model + j] for j in range(model)]
            for a in range(data)]
    p0 = [x for k, x in sorted(_inputs().items())
          if k.startswith(f"{name}/param/")]
    got, want = [], []
    for i, (s, d) in enumerate(zip(specs, dims)):
        got.append(_assemble([[r[f"{name}/p{i}"] for r in row]
                              for row in grid], s.dim, d))
        want.append(ref[f"{name}/p{i}"])
        assert got[-1].shape == want[-1].shape, (name, i)
    moved = [w - x for w, x in zip(want, p0)]
    err = _rel([g - x for g, x in zip(got, p0)], moved)
    assert err <= tol, (name, err)
    for metric in ("loss", "gnorm"):
        first = grid[0][0][f"{name}/{metric}"]
        for row in grid:
            for r in row:
                np.testing.assert_array_equal(r[f"{name}/{metric}"], first)
        w = ref[f"{name}/{metric}"]
        assert (np.abs(first - w) / np.abs(w) <= metric_tol).all(), \
            (name, metric, first, w)
    if fields.get("use_dsc"):
        for i, (s, d) in enumerate(zip(specs, dims)):
            sc = np.concatenate([_assemble(
                [[r[f"{name}/s_clients{i}"] for r in row]], s.dim, -1,
                shift=1) for row in grid])
            sa = _assemble([[r[f"{name}/s_agg{i}"] for r in row]
                            for row in grid], s.dim, d)
            for part, x in (("s_clients", sc), ("s_agg", sa)):
                w = ref[f"{name}/{part}{i}"]
                assert x.shape == w.shape, (part, i)
                assert _rel([x], [w]) <= state_tol, (name, part, i)
    if fields.get("capture_views"):
        # the first step's views: both packages' params are the same
        # there, so the views differ only where a code flipped
        keys = sorted(k for k in ref
                      if k.startswith(f"{name}/view") and k.endswith("@0"))
        assert keys
        for key in keys:
            # every model rank returns its aggregator's whole view
            for row in grid:
                for r in row[1:]:
                    np.testing.assert_array_equal(r[key], row[0][key])
            x = np.concatenate([row[0][key] for row in grid])
            assert x.shape == ref[key].shape, key
            assert _rel([x], [ref[key]]) <= state_tol, key
