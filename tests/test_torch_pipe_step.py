"""The port's pipe axis over gloo ranks against the reference, on the CPU.

One ``torch.distributed.run --nproc-per-node 8`` launch of a worker
script this test writes runs every case, each on its own mesh of the
eight ranks (``make_host_mesh(data, pipe, model)``; the checkpoint's
(data 2, pipe 2) mesh is built from groups of ranks 0-3 by hand).  Beside
it, one JAX subprocess on four forced host devices runs the reference's
``pipeline_loss_fn`` under a manual shard_map over (pipe, model) for the
cases whose loss only that function defines, and this process takes the
reference's replicated ``loss_fn`` and its gradients.  All start from the
same numpy params and tokens.

* ``CASES``: the reference's five ``PIPE_PARITY_SCRIPT`` cases
  (``tests/test_pipe_parallel.py``: qwen2-0.5b's smoke config at 4
  layers and width 128, B 8, S 32, pp 2 and 4, tp 1, 2 and 4 with the
  ring attention, 2 and 4 microbatches): the pipelined loss within 1e-5
  of the replicated ``loss_fn``, each merged gradient leaf within 1e-3
  of its max, the reference's gates.
* ``ORACLES``: olmoe at pp 2 and tp 2 with a ``loss_mask`` (a sum of
  per-microbatch masked means and the load-balance term over (p m): not
  ``loss_fn``'s value) and hymba at pp 2 and tp 2 (the hybrid head, the
  final norm on sequence chunks), against the reference's own
  ``pipeline_loss_fn``, the same gates.
* ``STEPS``: one step of ``make_train_step`` at (data 2, pipe 2, model 2)
  and at (data 1, pipe 2, model 4) with DSC on the fused int8 wire: the
  loss within 1e-5 and the grad norm within 1e-3 of the replicated
  gradient's, the reference's ``PIPE_TRAIN_STEP_SCRIPT`` gates.  The DSC
  case takes p = 1, so that its first update is the int8 round trip of
  the gradient, whose norm the replicated one gives to well within the
  gate.
* the composite checkpoint at (data 2, pipe 2) after one step, read by
  the reference's ``restore_sharded`` bit for bit, and
  ``ServeEngine.from_checkpoint``'s greedy tokens equal to those of an
  engine built from the same params.
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
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import SUBPROC_ENV  # noqa: E402
from repro.checkpoint import msgpack_ckpt as ref_ck  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.serve import ServeEngine, ServeSettings  # noqa: E402

B, S, WORLD, LR = 8, 32, 8, 0.05
LOSS_TOL, GRAD_TOL, GNORM_TOL = 1e-5, 1e-3, 1e-3
# the reference's PIPE_PARITY_SCRIPT config: 4 layers, so that pp 2 and
# 4 both split into equal stages
BASE = dict(n_layers=4, d_model=128, head_dim=32, d_ff=256, vocab=256,
            attn_chunk=16)
# (name, arch, overrides, tp, pipe, microbatches, with a loss_mask)
CASES = [
    ("pp2", "qwen2-0.5b", BASE, 1, 2, 2, False),
    ("pp2_tp2", "qwen2-0.5b", BASE, 2, 2, 2, False),
    ("pp2_tp2_mb4", "qwen2-0.5b", BASE, 2, 2, 4, False),
    ("pp4_mb4", "qwen2-0.5b", BASE, 1, 4, 4, False),
    # 2 kv heads over tp 4: the ring attention inside the pipeline
    ("pp2_tp4_ring_gqa", "qwen2-0.5b", BASE, 4, 2, 2, False),
]
ORACLES = [
    ("olmoe_mask", "olmoe-1b-7b", {}, 2, 2, 2, True),
    ("hymba", "hymba-1.5b", {}, 2, 2, 2, False),
]
# (name, arch, overrides, (data, pipe, model), microbatches, TrainSettings
# fields)
STEPS = [
    ("client_pp2_tp2_mb4", "qwen2-0.5b", {}, (2, 2, 2), 4,
     dict(grad_dtype="float32")),
    ("client_pp2_ring_gqa_dsc_int8", "qwen2-0.5b", {}, (1, 2, 4), 2,
     dict(grad_dtype="float32", use_dsc=True, int8_wire=True, dsc_p=1.0)),
]
# the checkpoint: BASE at (data 2, pipe 2), one sgd step, then saved
CKPT = ("ckpt", "qwen2-0.5b", BASE, (2, 2, 1), 2,
        dict(grad_dtype="float32"))


def _cfg(arch, over, ref=False):
    get = ref_get_config if ref else get_config
    return dataclasses.replace(get(arch).smoke(), **over)


def _inputs() -> dict:
    """Params (numpy, f32) and tokens of every case, each from its own
    seed; norm scales near 1, biases and hymba's skip small, hymba's
    ``m_A`` near log(1..N)."""
    out = {}
    cases = ([c[:3] for c in CASES + ORACLES]
             + [c[:3] for c in STEPS] + [CKPT[:3]])
    for k, (name, arch, over) in enumerate(cases):
        cfg = _cfg(arch, over)
        rng = np.random.default_rng(3000 + k)
        for path, shape in sh.spec_items(cfg):
            leaf = path[-1]
            if leaf.startswith(("ln", "q_norm", "k_norm", "m_ln")):
                x = 1.0 + 0.1 * rng.standard_normal(shape)
            elif leaf.startswith("b") or leaf == "m_D":
                x = 0.05 * rng.standard_normal(shape)
            elif leaf == "m_A":
                x = (np.log(np.arange(1, shape[-1] + 1))
                     + 0.05 * rng.standard_normal(shape))
            else:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                x = rng.standard_normal(shape) * fan_in ** -0.5
            out[f"{name}/param/" + "/".join(path)] = x.astype(np.float32)
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab,
                                             (B, S)).astype(np.int32)
        # a ragged mask: each row keeps a prefix of 12..32 positions
        keep = rng.integers(12, S + 1, (B, 1))
        out[f"{name}/mask"] = (np.arange(S)[None] < keep).astype(np.float32)
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
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_config
    from repro.dist import sharding as sh
    from repro.models import shard_plan as sp
    from repro.models import transformer as tr

    def shard_map(f, mesh, in_specs, out_specs):
        if hasattr(jax, "shard_map"):
            return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False)
        from jax.experimental.shard_map import shard_map as _sm
        return _sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_rep=False)

    def one(s, pd):
        hi = max(s.dim, pd)
        if hi < 0:
            return P()
        parts = [None] * (hi + 1)
        if pd >= 0:
            parts[pd] = "pipe"
        if s.dim >= 0:
            parts[s.dim] = "model"
        return P(*parts)

    spec = json.load(open(os.path.join(work, "spec.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    out = {}
    for name, arch, over, tp, pipe, mb, masked in spec["oracles"]:
        cfg = dataclasses.replace(get_config(arch).smoke(), **over)
        params = case_tree(raw, name, jnp.asarray)
        batch = {"tokens": jnp.asarray(raw[name + "/tokens"])}
        if masked:
            batch["loss_mask"] = jnp.asarray(raw[name + "/mask"])
        plan = tr.tp_plan(cfg, tp)
        pplan = sp.build_pipeline_plan(cfg, pipe, mb)
        assert plan.active and pplan.active, (name, plan, pplan)
        specs = sh.tp_specs(cfg, tp)
        pdims = sh.pipe_dims(cfg, pipe)
        pspec = jax.tree.map(one, specs, pdims)
        mesh = Mesh(np.array(jax.devices()[:pipe * tp]).reshape(pipe, tp),
                    ("pipe", "model"))

        def body(params, pidx, midx):
            tp_rt = tr.TPRuntime("model", tp, midx[0], plan)
            pipe_rt = sp.PipeRuntime("pipe", pipe, pidx[0], pplan)
            loss, grads = jax.value_and_grad(
                lambda p: tr.pipeline_loss_fn(p, cfg, batch, tp=tp_rt,
                                              pipe=pipe_rt))(params)
            grads = sh.tp_grad_sync(grads, specs, "model")
            grads = sh.pipe_grad_sync(grads, pdims, "pipe")
            return loss, grads

        fn = jax.jit(shard_map(body, mesh,
                               in_specs=(pspec, P("pipe"), P("model")),
                               out_specs=(P(), pspec)))
        with mesh:
            loss, grads = fn(params, jnp.arange(pipe, dtype=jnp.int32),
                             jnp.arange(tp, dtype=jnp.int32))
        out[name + "/loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{name}/g{i}"] = np.asarray(g)
    np.savez(os.path.join(work, "ref.npz"), **out)
""")

PORT_WORKER = COMMON + textwrap.dedent("""
    work = sys.argv[1]
    import torch
    import torch.distributed as dist
    from repro_torch import random
    from repro_torch.checkpoint import msgpack_ckpt as ck
    from repro_torch.configs import get_config
    from repro_torch.convert import tree_leaves, tree_unflatten
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    from repro_torch.models import shard_plan as sp
    from repro_torch.models import transformer as tr
    from repro_torch.optim import sgd

    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(work, "spec.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    init_process_group("cpu")
    rank = dist.get_rank()


    class HandMesh:
        # a (data, pipe, model) mesh over some of the ranks, from groups
        mesh_dim_names = ("data", "pipe", "model")

        def __init__(self, shape, groups):
            self.shape, self.groups = shape, groups

        def size(self, i):
            return self.shape[i]

        def get_group(self, name):
            return self.groups[name]


    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            d, p, m = shape
            meshes[shape] = make_host_mesh(data=d, pipe=p, model=m,
                                           device="cpu")
        return meshes[shape]

    def coord(mesh, i, name):
        if mesh.size(i) == 1:
            return 0
        return dist.get_rank(mesh.get_group(name))

    def cfg_of(arch, over):
        return dataclasses.replace(get_config(arch).smoke(), **over)

    out = {}
    # the pipelined loss and its gradient, merged over the axes
    for name, arch, over, tp, pipe, mb, masked in (spec["cases"]
                                                   + spec["oracles"]):
        cfg = cfg_of(arch, over)
        mesh = mesh_of((spec["world"] // (pipe * tp), pipe, tp))
        s, j = coord(mesh, 1, "pipe"), coord(mesh, 2, "model")
        plan = tr.tp_plan(cfg, tp)
        tp_rt = (sp.TPRuntime(mesh.get_group("model"), tp, j, plan)
                 if plan.active else None)
        pipe_rt = sp.PipeRuntime(mesh.get_group("pipe"), pipe, s,
                                 sp.build_pipeline_plan(cfg, pipe, mb))
        specs = tree_leaves(sh.tp_specs(cfg, tp))
        pdims = tree_leaves(sh.pipe_dims(cfg, pipe))
        full = case_tree(raw, name, torch.from_numpy)
        leaves = [sh.cut_piece(x, ((pd, pipe, s), (t.dim, tp, j)))
                  .clone().requires_grad_()
                  for x, t, pd in zip(tree_leaves(full), specs, pdims)]
        batch = {"tokens": torch.from_numpy(raw[name + "/tokens"])}
        if masked:
            batch["loss_mask"] = torch.from_numpy(raw[name + "/mask"])
        loss = tr.pipeline_loss_fn(tree_unflatten(full, leaves), cfg, batch,
                                   tp=tp_rt, pipe=pipe_rt)
        grads = list(torch.autograd.grad(loss, leaves))
        if tp_rt is not None:
            grads = sh.tp_grad_sync(grads, specs, tp_rt)
        grads = sh.pipe_grad_sync(grads, pdims, pipe_rt)
        out[name + "/loss"] = loss.detach().numpy()
        for i, g in enumerate(grads):
            out[f"{name}/g{i}"] = g.numpy()

    # one step of the pipelined FSA step
    for name, arch, over, shape, mb, fields in spec["steps"]:
        cfg = cfg_of(arch, over)
        mesh = mesh_of(tuple(shape))
        settings = train.TrainSettings(microbatches=mb, **fields)
        opt = sgd(spec["lr"])
        step = train.make_train_step(cfg, mesh, opt, settings, device="cpu")
        params = train.store_params(case_tree(raw, name, torch.from_numpy),
                                    cfg, mesh, settings)
        state = opt.init(params)
        dsc = train.init_dsc_state(cfg, mesh, settings, device="cpu")
        _, _, _, m = step(params, state, dsc,
                          {"tokens": torch.from_numpy(raw[name + "/tokens"])},
                          random.PRNGKey(0))
        out[name + "/loss"] = m["loss"].numpy()
        out[name + "/gnorm"] = m["grad_norm"].numpy()

    # the composite checkpoint at (data 2, pipe 2) over ranks 0-3: rank
    # a * 2 + s is aggregator a's stage s (every rank makes every group)
    name, arch, over, shape, mb, fields = spec["ckpt"]
    data_groups = [dist.new_group([s, 2 + s]) for s in range(2)]
    pipe_groups = [dist.new_group([2 * a, 2 * a + 1]) for a in range(2)]
    if rank < 4:
        a, s = divmod(rank, 2)
        mesh = HandMesh(tuple(shape), {"data": data_groups[s],
                                       "pipe": pipe_groups[a]})
        cfg = cfg_of(arch, over)
        settings = train.TrainSettings(microbatches=mb, **fields)
        opt = sgd(spec["lr"])
        step = train.make_train_step(cfg, mesh, opt, settings, device="cpu")
        params = train.store_params(case_tree(raw, name, torch.from_numpy),
                                    cfg, mesh, settings)
        params, _, _, m = step(
            params, opt.init(params),
            train.init_dsc_state(cfg, mesh, settings, device="cpu"),
            {"tokens": torch.from_numpy(raw[name + "/tokens"])},
            random.PRNGKey(0))
        cuts = train.store_cuts(cfg, mesh, settings)
        ck.save_sharded(os.path.join(work, "ckpt"), params, cuts=cuts)
        for i, x in enumerate(tree_leaves(params)):
            out[f"{name}/p{i}"] = x.numpy()
        out[name + "/cuts"] = np.asarray(json.dumps(cuts))
    np.savez(os.path.join(work, f"port_{rank}.npz"), **out)
    dist.destroy_process_group()
""")


def _replicated(name, arch, over, inputs, mask=False):
    """The reference's replicated ``loss_fn`` and its gradient leaves."""
    cfg = _cfg(arch, over, ref=True)
    params = {}
    for key, x in inputs.items():
        if key.startswith(name + "/param/"):
            node, path = params, key[len(name) + 7:].split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(x)
    batch = {"tokens": jnp.asarray(inputs[name + "/tokens"])}
    if mask:
        batch["loss_mask"] = jnp.asarray(inputs[name + "/mask"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: ref_tr.loss_fn(p, cfg, batch)))(params)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's eight-rank launch side by
    side, and the reference's replicated gradients here meanwhile.
    Returns (the work directory, the inputs, the replicated results, the
    reference's pipelined results, the eight ranks' arrays)."""
    work = tmp_path_factory.mktemp("pipe_step")
    (work / "spec.json").write_text(json.dumps(
        {"cases": CASES, "oracles": ORACLES, "steps": STEPS, "ckpt": CKPT,
         "world": WORLD, "lr": LR}))
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    (work / "worker.py").write_text(PORT_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work)],
                         cwd=repo, env=SUBPROC_ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(WORLD), str(work / "worker.py"),
             str(work)],
            cwd=repo, env=dict(SUBPROC_ENV, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    try:
        rep = {c[0]: _replicated(*c[:3], inputs) for c in CASES + STEPS}
        results = [proc.communicate(timeout=600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (_, err) in zip(procs, results):
        assert proc.returncode == 0, err[-3000:]
    return (work, inputs, rep, dict(np.load(work / "ref.npz")),
            [dict(np.load(work / f"port_{r}.npz")) for r in range(WORLD)])


def _merge(pieces: dict, shape, cuts_of) -> np.ndarray:
    """A leaf of ``shape`` from the ranks' ``pieces`` (rank -> array),
    each placed at the box its cuts select (``cuts_of(rank)``); pieces
    that land on one box must be equal, and every coordinate is
    covered."""
    full = np.zeros(shape, np.float32)
    seen = np.zeros(shape, bool)
    for r, piece in pieces.items():
        start, size = sh.composite_box(tuple(shape), cuts_of(r))
        box = tuple(slice(st, st + sz) for st, sz in zip(start, size))
        assert piece.shape == tuple(size), (r, piece.shape, size)
        if seen[box].any():
            np.testing.assert_array_equal(piece, full[box])
        full[box], seen[box] = piece, True
    assert seen.all()
    return full


def _merged_grads(ranks, name, arch, over, tp, pipe):
    """Every gradient leaf of a pipelined case, merged over the (pipe,
    model) positions of all eight ranks (rank = (a * pipe + s) * tp +
    j)."""
    cfg = _cfg(arch, over)
    specs = tree_leaves(sh.tp_specs(cfg, tp))
    pdims = tree_leaves(sh.pipe_dims(cfg, pipe))
    out = []
    for i, ((_, shape), t, pd) in enumerate(zip(sh.spec_items(cfg), specs,
                                                pdims)):
        def cuts_of(r):
            s, j = divmod(r % (pipe * tp), tp)
            return ((pd, pipe, s), (t.dim, tp, j))
        out.append(_merge({r: ranks[r][f"{name}/g{i}"]
                           for r in range(WORLD)}, shape, cuts_of))
    return out


def _worst(got, want) -> float:
    return max(float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-4))
               for g, w in zip(got, want))


@pytest.mark.parametrize("name,arch,over,tp,pipe,mb,masked", CASES,
                         ids=[c[0] for c in CASES])
def test_pipeline_loss_matches_replicated(runs, name, arch, over, tp, pipe,
                                          mb, masked):
    """The reference's five cases: the pipelined loss (the same on every
    rank) within 1e-5 of the replicated ``loss_fn``, each merged gradient
    leaf within 1e-3 of its max."""
    _, _, rep, _, ranks = runs
    ref_loss, ref_grads = rep[name]
    losses = {float(r[name + "/loss"]) for r in ranks}
    assert len(losses) == 1, losses
    assert abs(losses.pop() - ref_loss) < LOSS_TOL, name
    got = _merged_grads(ranks, name, arch, over, tp, pipe)
    assert _worst(got, ref_grads) < GRAD_TOL, name


@pytest.mark.parametrize("name,arch,over,tp,pipe,mb,masked", ORACLES,
                         ids=[c[0] for c in ORACLES])
def test_pipeline_loss_matches_the_references_pipeline(runs, name, arch,
                                                       over, tp, pipe, mb,
                                                       masked):
    """Where only the reference's ``pipeline_loss_fn`` defines the loss
    (a loss_mask, moe's load-balance term): the port's within 1e-5 of it
    and each merged gradient leaf within 1e-3 of its max."""
    _, _, _, ref, ranks = runs
    losses = {float(r[name + "/loss"]) for r in ranks}
    assert len(losses) == 1, losses
    assert abs(losses.pop() - float(ref[name + "/loss"])) < LOSS_TOL, name
    got = _merged_grads(ranks, name, arch, over, tp, pipe)
    want = [ref[f"{name}/g{i}"] for i in range(len(got))]
    assert _worst(got, want) < GRAD_TOL, name


@pytest.mark.parametrize("name,arch,over,shape,mb,fields", STEPS,
                         ids=[c[0] for c in STEPS])
def test_pipelined_step_matches_replicated(runs, name, arch, over, shape, mb,
                                           fields):
    """One step on the (data, pipe, model) mesh: its loss (equal on every
    rank) within 1e-5 of the replicated loss, its grad norm within 1e-3
    of the replicated gradient's (every leaf has a scatter dim at these
    data sizes, so none is counted twice)."""
    _, _, rep, _, ranks = runs
    ref_loss, ref_grads = rep[name]
    gn_ref = float(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                               for g in ref_grads)))
    for metric in ("loss", "gnorm"):
        assert len({float(r[f"{name}/{metric}"]) for r in ranks}) == 1
    assert abs(float(ranks[0][name + "/loss"]) - ref_loss) < LOSS_TOL
    assert abs(float(ranks[0][name + "/gnorm"]) - gn_ref) / gn_ref \
        < GNORM_TOL, (float(ranks[0][name + "/gnorm"]), gn_ref)


def _ckpt_params(ranks):
    """The checkpoint case's params after its step, merged from the four
    ranks' store pieces at the cuts each rank reported."""
    name, arch, over = CKPT[:3]
    cfg = _cfg(arch, over)
    cuts = {r: json.loads(str(ranks[r][name + "/cuts"])) for r in range(4)}
    return [_merge({r: ranks[r][f"{name}/p{i}"] for r in range(4)}, shape,
                   lambda r, i=i: cuts[r][i])
            for i, (_, shape) in enumerate(sh.spec_items(cfg))]


def test_composite_checkpoint_reads_in_the_reference(runs):
    """The (data 2, pipe 2) checkpoint written by the four ranks after a
    step: the reference's ``restore_sharded`` gives the merged params bit
    for bit, the port's too (whole), and each rank's cuts give back its
    own pieces; the layout put stage 1's block rows on ranks 1 and 3."""
    work, inputs, _, _, ranks = runs
    name, arch, over, shape = CKPT[:4]
    cfg = _cfg(arch, over)
    params = _ckpt_params(ranks)
    p0 = [inputs[f"{name}/param/" + "/".join(path)]
          for path, _ in sh.spec_items(cfg)]
    assert any(not np.array_equal(p, q) for p, q in zip(params, p0))
    target = sh.shape_tree(cfg, np.zeros)
    got = ref_ck.restore_sharded(work / "ckpt", target)
    for g, p in zip(jax.tree.leaves(got), params):
        np.testing.assert_array_equal(np.asarray(g), p)
    from repro_torch.checkpoint import msgpack_ckpt as ck
    whole = ck.restore_any(work / "ckpt", target)
    for g, p in zip(tree_leaves(whole), params):
        np.testing.assert_array_equal(g.numpy(), p)
    for r in range(4):
        cuts = json.loads(str(ranks[r][name + "/cuts"]))
        assert all(c[0][2] == r % 2 for c in cuts)      # the stage
        mine = ck.restore_sharded(work / "ckpt", target, rank=r, world=4,
                                  cuts=cuts)
        for i, g in enumerate(tree_leaves(mine)):
            np.testing.assert_array_equal(g.numpy(),
                                          ranks[r][f"{name}/p{i}"])


def test_from_checkpoint_serves_the_saved_params(runs):
    """``ServeEngine.from_checkpoint`` on the (data 2, pipe 2) checkpoint
    generates the greedy tokens of an engine built from the ranks' merged
    params, four requests of 8 tokens (the plain decode on the host)."""
    work, _, _, _, ranks = runs
    name, arch, over = CKPT[:3]
    cfg = _cfg(arch, over)
    settings = ServeSettings(max_concurrency=4, block_size=8, num_blocks=32,
                             max_model_len=40, max_new_tokens=8,
                             cache_dtype="float32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(4, 20, 4)]
    params = tree_unflatten(sh.shape_tree(cfg, lambda s: None),
                            [torch.from_numpy(p) for p in _ckpt_params(ranks)])
    outs = []
    for engine in (ServeEngine.from_checkpoint(work / "ckpt", cfg, settings,
                                               device="cpu"),
                   ServeEngine(cfg, params, settings, device="cpu")):
        outs.append([o.tokens for o in engine.run(prompts)])
    assert outs[0] == outs[1]
    assert all(len(t) == 8 for t in outs[0])
