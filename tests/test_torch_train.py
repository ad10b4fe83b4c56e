"""The port's distributed FSA step against the reference's, on the CPU.

The reference's ``make_train_step`` runs in one JAX subprocess on
``make_host_mesh(data=4, model=1)`` over four forced host devices; the
port's runs in one ``torch.distributed.run --standalone
--nproc-per-node 4`` launch of a worker script owned by this test, four
gloo ranks.  Both start from the same numpy params0 and tokens
(qwen2-0.5b's smoke config, as the reference's parity tests use it) and
step with the same keys ``PRNGKey(i)``; the two launches run side by
side (the DSC int8 wire, FedAvg and bf16 params are
``tests/test_torch_train_wire.py``'s launch).  Each configuration's params, losses, grad norms and DSC state are
compared, with the tolerance stated at ``CONFIGS``; the port's FSA step
with sgd is held to the port's ``FLRun(eris, K=4, A=4)`` (Theorem B.1,
as the reference's ``PARITY_SCRIPT`` holds its own); and checkpoints
cross between the packages both ways, bit for bit.

Why tolerances and not bits: the two frameworks' gradients differ in the
last bits (summation orders), gloo's ring adds the four ranks' rows in
another order than XLA's CPU reduce-scatter, and XLA fuses the
optimizer's multiply-adds under ``jit`` (the port's optimizers are the
un-jitted reference's, ``tests/test_torch_dist.py``).  On the int8 wire a
code flips where a draw falls within an ulp of its fraction, so those
configurations agree to 1e-3 of the motion.  Each case also holds a
planted fault, the reference's own steps without one rank's rows, to be
beyond its tolerance.
"""
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
from repro_torch.checkpoint import msgpack_ckpt as ck  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import ravel_params, tree_leaves  # noqa: E402
from repro_torch.core import fl  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

A, STEPS, B, S, LR = 4, 3, 8, 32, 0.05
# (name, param dtype, optimizer, TrainSettings fields, tolerances after
# STEPS steps: the params' error as a share of the reference's motion
# |ref - params0|, the losses' and grad norms' relative error, and the
# DSC state's relative error (the state starts at zero, so this too is of
# its motion)).  Measured with these inputs, params (the same steps with
# the last rank's rows replaced by the first rank's, the planted fault
# every case also checks, in brackets): f32 sgd 3.0e-6 (0.63), fedavg
# 3.0e-6 (0.63), dsc 2.0e-6 (0.71), 3 ranks 2.9e-6 (0.74); int8 wire
# 2.4e-4 (0.63), dsc + int8 fused 6.8e-4 (0.73), unfused 5.2e-4 (0.71)
# (a code flips where a draw falls within an ulp of its fraction; the
# state to 2.0e-3, since s_k tracks the dequantized codes and a flipped
# code moves it by a whole quantization step); f32 adam 2.0e-4 (0.79):
# its first step is ~ lr sign(g), so a coordinate whose gradient is
# within the frameworks' last-bit noise of zero moves the other way;
# bf16 adam 7.7e-2 (0.79): the two frameworks' bf16 gradients differ by
# 1.1-1.7e-2 relative (XLA keeps f32 between the fused bf16 ops that torch
# rounds one by one), which adam's sign-like first step turns into
# flipped coordinates.  Metrics: f32 <= 2e-7, bf16 2.1e-3.
CONFIGS = [
    ("fsa_sgd", "float32", ["sgd", LR], dict(grad_dtype="float32"),
     1e-5, 1e-5, None),
    ("fsa_adam", "float32", ["adam", 1e-2], dict(grad_dtype="float32"),
     5e-4, 1e-4, None),
    ("int8", "float32", ["sgd", LR],
     dict(grad_dtype="float32", int8_wire=True), 1e-3, 1e-4, None),
    ("dsc", "float32", ["sgd", LR], dict(grad_dtype="float32", use_dsc=True),
     1e-5, 1e-5, 1e-4),
    ("dsc_int8_fused", "float32", ["sgd", LR],
     dict(grad_dtype="float32", use_dsc=True, int8_wire=True),
     2e-3, 1e-4, 1e-2),
    ("dsc_int8_unfused", "float32", ["sgd", LR],
     dict(grad_dtype="float32", use_dsc=True, int8_wire=True,
          fused_wire=False), 2e-3, 1e-4, 1e-2),
    ("fedavg", "float32", ["sgd", LR], dict(grad_dtype="float32", fsa=False),
     1e-5, 1e-5, None),
    # bf16 params on TrainSettings' default bf16 wire
    ("bf16_adam", "bfloat16", ["adam", 1e-2], dict(), 0.15, 1e-2, None),
]
# At 4 ranks every leaf of the smoke config has a scatter dim; at 3 none
# has (test_replicated_leaves_by_rank_count), so every leaf takes the
# all-reduce and grad_norm counts each leaf three times, as the
# reference's psum does.  Run beside the four-rank launches.
CONFIGS_3 = [("fsa_sgd_3", "float32", ["sgd", LR],
              dict(grad_dtype="float32"), 1e-5, 1e-5, None)]
# the configurations are cut over two launches that run side by side:
# this file's, and tests/test_torch_train_wire.py's (the DSC int8 wire,
# FedAvg and bf16 params)
WIRE = ("dsc_int8_fused", "dsc_int8_unfused", "fedavg", "bf16_adam")
WORLDS = {A: [c for c in CONFIGS if c[0] not in WIRE], 3: CONFIGS_3}
CKPT_CONFIG = "fsa_sgd"


def _cfg(dtype="float32"):
    import dataclasses
    return dataclasses.replace(get_config("qwen2-0.5b").smoke(), dtype=dtype)


def _inputs(seed=0):
    """params0 (a flat dict of "path" -> f32 array, flatten order) and the
    (B, S) tokens, from numpy."""
    rng = np.random.default_rng(seed)
    cfg = _cfg()
    params = {}
    for path, shape in sh.spec_items(cfg):
        name = path[-1]
        if name.startswith("ln"):
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name.startswith("b"):
            x = 0.05 * rng.standard_normal(shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            x = rng.standard_normal(shape) * fan_in ** -0.5
        params["/".join(path)] = x.astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return params, toks


REF_SCRIPT = textwrap.dedent("""
    import os, sys, json, dataclasses
    work, world = sys.argv[1], int(sys.argv[2])
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={world} "
        "--xla_backend_optimization_level=0 "
        "--xla_llvm_disable_expensive_passes=true")
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.checkpoint import msgpack_ckpt as ck
    from repro.configs import get_config
    from repro.dist import sharding as sh
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import (TrainSettings, init_dsc_state,
                                    make_train_step)
    from repro.optim import adam, sgd

    spec = json.load(open(os.path.join(work, "configs.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    mesh = make_host_mesh(data=world, model=1)
    # the global batch: the rows the ranks share equally (6 of 8 at 3)
    toks = raw["tokens"][:len(raw["tokens"]) // world * world]
    out, dtypes = {}, {}
    for name, dtype, (opt_name, lr), fields, *_ in spec[str(world)]:
        cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                                  dtype=dtype)
        params0 = {}
        for key in raw.files:
            if key == "tokens":
                continue
            node, path = params0, key.split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(raw[key]).astype(dtype)
        opt = {"sgd": sgd, "adam": adam}[opt_name](lr)
        settings = TrainSettings(**fields)
        step, shardings = make_train_step(cfg, mesh, opt, settings)
        with mesh:
            params = jax.device_put(params0, shardings["store"])
            opt_state = jax.device_put(
                opt.init(params),
                sh.opt_state_shardings(cfg, mesh, opt, params0))
            dsc = init_dsc_state(cfg, mesh, settings)
            jstep = jax.jit(step)
            # the planted fault: the same steps with the last rank's rows
            # replaced by the first rank's (one rank's rows left out)
            b = len(toks) // world
            bad = np.concatenate([toks[:-b], toks[:b]])
            runs = {}
            for what, rows in (("", toks), ("fault_", bad)):
                p, o, d = params, opt_state, dsc
                loss, gnorm = [], []
                for i in range(spec["steps"]):
                    p, o, d, m = jstep(p, o, d, {"tokens": rows},
                                       jax.random.PRNGKey(i))
                    loss.append(float(m["loss"]))
                    gnorm.append(float(m["grad_norm"]))
                runs[what] = p, d, loss, gnorm
            params, dsc, loss, gnorm = runs[""]
        for i, x in enumerate(jax.tree.leaves(jax.device_get(runs["fault_"][0]))):
            out[f"{name}/fault_p{i}"] = np.asarray(x, np.float32)
        leaves = jax.tree.leaves(jax.device_get(params))
        dtypes[name] = [str(x.dtype) for x in leaves]
        for i, x in enumerate(leaves):
            out[f"{name}/p{i}"] = np.asarray(x, np.float32)
        if settings.use_dsc:
            for part in ("s_clients", "s_agg"):
                for i, x in enumerate(jax.tree.leaves(
                        jax.device_get(dsc[part]))):
                    out[f"{name}/{part}{i}"] = np.asarray(x, np.float32)
        if settings.async_buffer:
            buf = jax.device_get(dsc["buffer"])
            for i, x in enumerate(jax.tree.leaves(buf["u"])):
                out[f"{name}/buf_u{i}"] = np.asarray(x, np.float32)
            out[f"{name}/buf_w"] = np.asarray(buf["w"], np.float32)
            out[f"{name}/buf_t"] = np.asarray(buf["t"], np.int32)
        out[f"{name}/loss"] = np.asarray(loss)
        out[f"{name}/gnorm"] = np.asarray(gnorm)
        if name == spec["ckpt"]:
            ck.save_sharded(os.path.join(work, "ref_ckpt"), params)
    np.savez(os.path.join(work, f"ref{world}.npz"), **out)
    json.dump(dtypes, open(os.path.join(work, f"ref{world}_dtypes.json"),
                           "w"))
""")

PORT_WORKER = textwrap.dedent("""
    import os, sys, json, dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.checkpoint import msgpack_ckpt as ck
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_leaves
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.launch.train import (TrainSettings, _scatter_dims,
                                          init_dsc_state, make_train_step,
                                          store_params)
    from repro_torch.optim import adam, sgd

    work = sys.argv[1]
    spec = json.load(open(os.path.join(work, "configs.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    device = init_process_group("cpu")
    mesh = make_host_mesh(device="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    out, dtypes = {}, {}
    # the configurations both packages run, then those only the port runs;
    # a configuration may take its own step count, and keep its params
    # after every step
    port_only = spec.get("port_only", {}).get(str(world), [])
    for name, dtype, (opt_name, lr), fields, *_ in (spec[str(world)]
                                                    + port_only):
        cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(),
                                  dtype=dtype)
        params0 = {}
        for key in raw.files:
            if key == "tokens":
                continue
            node, path = params0, key.split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = torch.from_numpy(raw[key]).to(
                getattr(torch, dtype))
        opt = {"sgd": sgd, "adam": adam}[opt_name](lr)
        settings = TrainSettings(**fields)
        step = make_train_step(cfg, mesh, opt, settings, device="cpu")
        params = store_params(params0, cfg, mesh, settings)
        opt_state = opt.init(params)
        dsc = init_dsc_state(cfg, mesh, settings, device="cpu")
        toks = raw["tokens"][:len(raw["tokens"]) // world * world]
        batch = {"tokens": torch.from_numpy(toks)}
        loss, gnorm = [], []
        for i in range(spec.get("steps_of", {}).get(name, spec["steps"])):
            params, opt_state, dsc, m = step(params, opt_state, dsc, batch,
                                             random.PRNGKey(i))
            loss.append(float(m["loss"]))
            gnorm.append(float(m["grad_norm"]))
            if name in spec.get("traj", ()):
                for j, x in enumerate(tree_leaves(params)):
                    out[f"{name}/p{j}@{i}"] = x.float().numpy()
        leaves = tree_leaves(params)
        dtypes[name] = [str(x.dtype).replace("torch.", "") for x in leaves]
        for i, x in enumerate(leaves):
            out[f"{name}/p{i}"] = x.float().numpy()
        if settings.use_dsc:
            for part in ("s_clients", "s_agg"):
                for i, x in enumerate(tree_leaves(dsc[part])):
                    out[f"{name}/{part}{i}"] = x.float().numpy()
        if settings.async_buffer:
            buf = dsc["buffer"]
            for i, x in enumerate(tree_leaves(buf["u"])):
                out[f"{name}/buf_u{i}"] = x.numpy()
            out[f"{name}/buf_w"] = buf["w"].numpy()
            out[f"{name}/buf_t"] = buf["t"].numpy()
        out[f"{name}/loss"] = np.asarray(loss)
        out[f"{name}/gnorm"] = np.asarray(gnorm)
        if name == spec["ckpt"]:
            ck.save_sharded(os.path.join(work, "port_ckpt"), params,
                            dims=_scatter_dims(cfg, mesh, settings))
    np.savez(os.path.join(work, f"port{world}_{rank}.npz"), **out)
    json.dump(dtypes, open(
        os.path.join(work, f"port{world}_{rank}_dtypes.json"), "w"))
    dist.destroy_process_group()
""")


def launch(tmp_path_factory, worlds, ckpt=None):
    """The reference's and the port's launches of ``worlds`` ({ranks:
    configurations}), side by side, ``ckpt`` the configuration whose
    params both save.  Returns (work dir, {world: (the reference's
    arrays, the port's ranks' arrays, the reference's dtypes, the ranks'
    dtypes)})."""
    work = tmp_path_factory.mktemp("train")
    params, toks = _inputs()
    np.savez(work / "inputs.npz", tokens=toks, **params)
    (work / "configs.json").write_text(json.dumps(
        {**{str(w): c for w, c in worlds.items()}, "steps": STEPS,
         "ckpt": ckpt}))
    (work / "worker.py").write_text(PORT_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for world in worlds:
        procs.append(subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(work), str(world)],
            cwd=repo, env=SUBPROC_ENV, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(world), str(work / "worker.py"),
             str(work)],
            cwd=repo, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        results = [proc.communicate(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (_, err) in zip(procs, results):
        assert proc.returncode == 0, err[-3000:]
    out = {}
    for world in worlds:
        out[world] = (
            dict(np.load(work / f"ref{world}.npz")),
            [dict(np.load(work / f"port{world}_{r}.npz"))
             for r in range(world)],
            json.loads((work / f"ref{world}_dtypes.json").read_text()),
            [json.loads((work / f"port{world}_{r}_dtypes.json").read_text())
             for r in range(world)])
    return work, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four launches (the reference and the port, at 4 and at 3
    ranks) of this file's configurations."""
    return launch(tmp_path_factory, WORLDS, CKPT_CONFIG)


def _assemble(ranks, key, dim):
    """A leaf's global value from the ranks' pieces: concatenated along
    its scatter dim, or (replicated) rank 0's after checking that every
    rank holds the same."""
    pieces = [r[key] for r in ranks]
    if dim >= 0:
        return np.concatenate(pieces, axis=dim)
    for p in pieces[1:]:
        np.testing.assert_array_equal(p, pieces[0],
                                      err_msg=f"{key} differs across ranks")
    return pieces[0]


def _dims(fields, world=A):
    dims = tree_leaves(sh.fsa_scatter_dims(_cfg(), world))
    return dims if fields.get("fsa", True) else [-1] * len(dims)


def _port_params(ranks, name, fields):
    return [_assemble(ranks, f"{name}/p{i}", d)
            for i, d in enumerate(_dims(fields, len(ranks)))]


def _dist(a, b):
    """The norm of a - b over every leaf."""
    a = np.concatenate([np.ravel(x).astype(np.float64) for x in a])
    b = np.concatenate([np.ravel(x).astype(np.float64) for x in b])
    return float(np.linalg.norm(a - b))


def _rel(a, b):
    return _dist(a, b) / _dist(b, [np.zeros_like(x) for x in b])


def check_step(runs, world, name, dtype, fields, tol, metric_tol,
               state_tol):
    """Params, losses and grad norms after STEPS steps, and the DSC
    state, within the stated tolerances of the reference's, and the
    planted fault (one rank's rows left out) beyond the params'; the
    params' dtypes equal (a bf16 model's are f32 after an adam step, as
    the reference's); losses and grad norms equal on every rank, and
    every replicated leaf equal on every rank."""
    ref, ranks, ref_dtypes, port_dtypes = runs[1][world]
    dims = _dims(fields, world)
    want = [ref[f"{name}/p{i}"] for i in range(len(dims))]
    got = _port_params(ranks, name, fields)
    for (g, w) in zip(got, want):
        assert g.shape == w.shape
    # errors are of the motion |ref - params0|: the steps, not the weights
    p0 = [torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
          for x in _inputs()[0].values()]
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
        rel = np.abs(p - r) / np.abs(r)
        assert (rel <= metric_tol).all(), f"{name} {metric}: {p} vs {r}"
    assert all(d == ref_dtypes[name] for d in
               (pd[name] for pd in port_dtypes)), \
        (name, ref_dtypes[name], port_dtypes[0][name])
    if state_tol is not None:
        # s_k is client-stacked: rank a holds block a of (world, *shape)
        for i, d in enumerate(dims):
            sc = np.concatenate([r[f"{name}/s_clients{i}"] for r in ranks])
            sa = _assemble(ranks, f"{name}/s_agg{i}", d)
            for part, x in (("s_clients", sc), ("s_agg", sa)):
                w = ref[f"{name}/{part}{i}"]
                assert x.shape == w.shape, (part, i)
                e = _rel([x], [w])
                assert e <= state_tol, f"{name} {part}{i}: {e:.3e}"


@pytest.mark.parametrize(
    "world,name,dtype,opt,fields,tol,metric_tol,state_tol",
    [(w, *c) for w, cs in WORLDS.items() for c in cs],
    ids=[c[0] for cs in WORLDS.values() for c in cs])
def test_port_step_matches_reference_step(runs, world, name, dtype, opt,
                                          fields, tol, metric_tol,
                                          state_tol):
    check_step(runs, world, name, dtype, fields, tol, metric_tol,
               state_tol)


def test_replicated_leaves_by_rank_count():
    """Which leaves of the smoke config the FSA layout replicates: none
    at 4 ranks (so the four-rank launch runs no all-reduce path and its
    grad_norm counts no leaf twice), every one at 3."""
    assert -1 not in tree_leaves(sh.fsa_scatter_dims(_cfg(), A))
    assert set(tree_leaves(sh.fsa_scatter_dims(_cfg(), 3))) == {-1}


def test_fsa_sgd_step_equals_the_simulator(runs):
    """Theorem B.1 in the port: the distributed FSA step with sgd lands
    where the port's own simulator, ``FLRun(eris, K=4, A=4)`` on the same
    client rows, does (1e-5: the sums run in other orders)."""
    _, ranks, _, _ = runs[1][A]
    params, toks = _inputs()
    cfg = _cfg()
    tree = {}
    for key, x in params.items():
        node, path = tree, key.split("/")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.from_numpy(x)
    run = fl.FLRun(fl.FLConfig(method="eris", K=A, A=A, lr=LR,
                               rounds=STEPS), tree,
                   lambda p, b: tr.loss_fn(p, cfg, b), device="cpu")
    batches = {"tokens": torch.from_numpy(toks).reshape(A, B // A, S)}
    for _ in range(STEPS):
        run.step(batches)
    dist_flat = np.concatenate([
        x.ravel() for x in _port_params(ranks, "fsa_sgd", {})])
    x0 = ravel_params(tree)[0].numpy()
    moved = np.linalg.norm(run.x.numpy() - x0)
    err = np.linalg.norm(dist_flat - run.x.numpy()) / moved
    assert err <= 1e-5, f"dist vs simulator: {err:.3e} of the motion"


def test_reference_checkpoint_reads_in_the_port(runs):
    """The reference's ``save_sharded`` of its store-layout params (four
    devices' shards) read by the port's ``restore_sharded``: the
    reference's params bit for bit; and cut to each rank's store shard."""
    work, (ref, _, _, _) = runs[0], runs[1][A]
    params, _ = _inputs()
    target = {}
    for key, x in params.items():
        node, path = target, key.split("/")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.empty(x.shape)
    got = tree_leaves(ck.restore_sharded(work / "ref_ckpt", target))
    for i, x in enumerate(got):
        np.testing.assert_array_equal(x.numpy(), ref[f"{CKPT_CONFIG}/p{i}"])
    dims = sh.fsa_scatter_dims(_cfg(), A)
    for rank in (0, 3):
        shards = tree_leaves(ck.restore_sharded(
            work / "ref_ckpt", target, dims, rank=rank, world=A))
        for x, full, d in zip(shards, got, tree_leaves(dims)):
            np.testing.assert_array_equal(
                x.numpy(), sh.store_shard(full, d, A, rank).numpy())


def test_port_checkpoint_reads_in_the_reference(runs):
    """The port's four ranks' ``save_sharded`` read by the reference's
    ``restore_sharded``: the port's params bit for bit."""
    import jax
    from repro.checkpoint import msgpack_ckpt as ref_ck
    work, (_, ranks, _, _) = runs[0], runs[1][A]
    params, _ = _inputs()
    target = {}
    for key, x in params.items():
        node, path = target, key.split("/")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.zeros(x.shape, np.float32)
    got = jax.tree.leaves(ref_ck.restore_sharded(work / "port_ckpt",
                                                 target))
    for x, want in zip(got, _port_params(ranks, CKPT_CONFIG, {})):
        np.testing.assert_array_equal(np.asarray(x), want)
    assert sorted(p.name for p in (work / "port_ckpt").iterdir()) == [
        "manifest.msgpack"] + [f"shard-{r}.msgpack" for r in range(A)]
