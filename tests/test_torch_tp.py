"""The port's model axis (tensor, sequence, context and expert parallelism)
against the reference's, on the CPU.

Two layers, as ``tests/test_tp.py`` has them:

* plans and placements, in process: ``build_plan``, ``tp_specs``,
  ``PARAM_ROLES``, ``build_pipeline_plan`` and ``pipeline_schedule``
  equal to the reference's for every zoo config at tp in {1, 2, 4, 8,
  16}; the split/merge round trips, the TP-local wire geometry and the
  view layouts over a model axis equal to the reference's.
* collectives and ``loss_fn``, across processes: the reference runs
  once, its work cut over two JAX subprocesses on four forced host
  devices each (a manual ``shard_map`` over a ``("model",)`` mesh of 2
  or 4); the port runs once, in one ``python -m torch.distributed.run
  --nproc-per-node 4``
  launch of a worker script this test writes (gloo groups of 2 and of
  4).  Both take the same numpy inputs.  Each conjugate's forward and
  backward (the psum pair, its ring variant, the sequence pair, the
  context pair, ring attention, the sharded RMS norm) is compared rank
  by rank; the ring all-reduce's forward bit for bit, in f32 and bf16
  (it adds the chunks in the reference's order).  Then the reference's
  twelve ``loss_fn`` cases of ``tests/test_tp.py``: the port's TP loss
  and merged gradients against both the reference's TP ones and its
  replicated ones, at the reference's own gates (``LOSS_TOL``,
  ``GRAD_TOL``).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import SUBPROC_ENV  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.dist import sharding as ref_sh  # noqa: E402
from repro.models import shard_plan as ref_sp  # noqa: E402
from repro.privacy import views as ref_views  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import tree_leaves  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.models import shard_plan as sp  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.privacy import views  # noqa: E402

TPS = [1, 2, 4, 8, 16]
# the reference's gates (tests/test_tp.py): |loss error| and each leaf's
# max |error| over max(max |ref|, 1e-4).  Measured against both of the
# reference's results: losses within 1.5e-6, gradients within 1.9e-6,
# but for xlstm's (2.9e-4: its b_i gradient is analytically zero, so the
# floor decides; the reference's own TP against its replicated is 1.4e-4)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-3


# ---------------------------------------------------------- plans, specs
def _spec_tuple(spec):
    return (spec.dim, spec.kind)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_and_specs_equal_the_references(arch, tp):
    """For the config and its seq-parallel variant: the plan field for
    field, every leaf's TPSpec, the pipeline plan at that many stages
    (microbatches 1 and 4) and the role table."""
    for seq in (False, True):
        ref = dataclasses.replace(ref_get_config(arch), seq_parallel=seq)
        cfg = dataclasses.replace(get_config(arch), seq_parallel=seq)
        assert dataclasses.asdict(sp.build_plan(cfg, tp)) == \
            dataclasses.asdict(ref_sp.build_plan(ref, tp))
        assert sp.build_plan(cfg, tp).active == \
            ref_sp.build_plan(ref, tp).active
        got = [_spec_tuple(s) for s in tree_leaves(sh.tp_specs(cfg, tp))]
        want = [_spec_tuple(s) for s in
                jax.tree.leaves(ref_sh.tp_specs(ref, tp))]
        assert got == want, (arch, tp, seq)
        for m in (1, 4):
            assert dataclasses.asdict(sp.build_pipeline_plan(cfg, tp, m)) \
                == dataclasses.asdict(ref_sp.build_pipeline_plan(ref, tp, m))
            assert sp.build_pipeline_plan(cfg, tp, m).bubble_fraction == \
                ref_sp.build_pipeline_plan(ref, tp, m).bubble_fraction
    assert sp.PARAM_ROLES == ref_sp.PARAM_ROLES
    assert tr.tp_plan is sp.build_plan


@pytest.mark.parametrize("p", TPS)
def test_pipeline_schedule_equals_the_references(p):
    for m in (1, 2, 3, 8):
        assert sp.pipeline_schedule(p, m) == ref_sp.pipeline_schedule(p, m)


@pytest.mark.parametrize("dim,tp", [(0, 2), (1, 4), (2, 2), (2, 1), (-1, 4)])
def test_split_merge_round_trip(dim, tp):
    """``tp_split_leaf`` gives the reference's shards, and ``tp_merge_leaf``
    inverts it (replicated leaves: stacked copies, shard 0 back)."""
    shape = [6, 8, 4]
    if dim >= 0:
        shape[dim] *= tp
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    spec = sh.TPSpec(dim, "col" if dim >= 0 else "replicate")
    rspec = ref_sh.TPSpec(dim, spec.kind)
    shards = sh.tp_split_leaf(torch.from_numpy(x), spec, tp)
    np.testing.assert_array_equal(
        shards.numpy(), np.asarray(ref_sh.tp_split_leaf(jnp.asarray(x),
                                                        rspec, tp)))
    assert tuple(shards.shape[1:]) == ref_sh.tp_local_shape(
        tuple(shape), rspec, tp) == sh.tp_local_shape(tuple(shape), spec, tp)
    np.testing.assert_array_equal(sh.tp_merge_leaf(shards, spec).numpy(), x)


def _meshes(data, model):
    """Stand-ins of a (data, model) mesh for both packages' shape
    helpers."""
    ref = types.SimpleNamespace(axis_names=("data", "model"),
                                devices=np.zeros((data, model)))
    port = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 size=lambda i: (data, model)[i])
    return ref, port


@pytest.mark.parametrize("arch", ["eris-gptneo-1.3b", "olmoe-1b-7b",
                                  "hymba-1.5b", "qwen2-0.5b", "xlstm-350m"])
@pytest.mark.parametrize("data,model", [(2, 2), (1, 2), (4, 4), (2, 8)])
def test_tp_local_geometry_equals_the_references(arch, data, model):
    """Scatter dims of the TP-local shapes, the int8 wire layouts, the
    wire bytes both ways and the resident bytes per device on a (data,
    model) mesh."""
    ref_mesh, mesh = _meshes(data, model)
    ref, cfg = ref_get_config(arch), get_config(arch)
    assert tree_leaves(sh.fsa_scatter_dims(cfg, mesh)) == \
        jax.tree.leaves(ref_sh.fsa_scatter_dims(ref, ref_mesh))
    got = [dataclasses.astuple(w) for w in
           tree_leaves(sh.int8_wire_layouts(cfg, mesh))]
    want = [dataclasses.astuple(w) for w in jax.tree.leaves(
        ref_sh.int8_wire_layouts(ref, ref_mesh),
        is_leaf=lambda x: isinstance(x, ref_sh.WireLayout))]
    assert got == want
    for int8 in (False, True):
        assert sh.mesh_wire_bytes(cfg, mesh, int8=int8) == \
            ref_sh.mesh_wire_bytes(ref, ref_mesh, int8=int8)
    assert sh.param_bytes_per_device(cfg, mesh) == \
        ref_sh.param_bytes_per_device(ref, ref_mesh)


@pytest.mark.parametrize("tp,n_client", [(2, 2), (4, 2), (2, 4)])
def test_view_layouts_over_a_model_axis(tp, n_client):
    """``view_layouts``, ``mesh_flat_assignment`` and
    ``flat_views_from_leaves`` with ``tp > 1`` equal the reference's on
    the smoke config (sharded, replicated-duplicate and psum leaves)."""
    ref, cfg = (ref_get_config("qwen2-0.5b").smoke(),
                get_config("qwen2-0.5b").smoke())
    shapes = sh.shape_tree(cfg, lambda s: np.zeros(s, np.float32))
    ref_abs = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                           shapes)
    specs, ref_specs = sh.tp_specs(cfg, tp), ref_sh.tp_specs(ref, tp)
    got = views.view_layouts(shapes, n_client, tp, specs)
    want = ref_views.view_layouts(ref_abs, n_client, tp, ref_specs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.index, g.offset, g.shape, g.dim, g.tp_dim, g.m_loc,
                g.dup) == (w.index, w.offset, w.shape, w.dim, w.tp_dim,
                           w.m_loc, w.dup)
        assert len(g.chunks) == len(w.chunks)
        for a, b in zip(g.chunks, w.chunks):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        views.mesh_flat_assignment(shapes, n_client, tp, specs),
        ref_views.mesh_flat_assignment(ref_abs, n_client, tp, ref_specs))
    rng = np.random.default_rng(tp * 10 + n_client)
    leaves = {str(lay.index): rng.standard_normal(
        (n_client, 3, lay.m_loc * tp)).astype(np.float32)
        for lay in want if lay.dim >= 0}
    np.testing.assert_array_equal(
        views.flat_views_from_leaves(leaves, shapes, n_client, tp, specs),
        ref_views.flat_views_from_leaves(leaves, ref_abs, n_client, tp,
                                         ref_specs))


# ------------------------------------------- collectives and loss_fn
# (name, tp, arch, ModelConfig overrides, loss mask): tests/test_tp.py's
# twelve cases, the dense ones at its reduced width
DENSE = dict(n_layers=1, d_model=128, head_dim=32, d_ff=256, vocab=256,
             attn_chunk=16)
CASES = [
    ("tp2_full", 2, "qwen2-0.5b", DENSE, False),
    ("tp4_gqa_fallback", 4, "qwen2-0.5b", DENSE, False),
    ("tp2_qknorm_untied", 2, "qwen2-0.5b",
     dict(DENSE, qk_norm=True, tie_embeddings=False,
          loss_fp32_logits=False), False),
    ("tp4_masked", 4, "qwen2-0.5b", DENSE, True),
    ("moe_tp2", 2, "olmoe-1b-7b", dict(n_layers=1, moe_group_size=8), False),
    ("moe_tp4", 4, "olmoe-1b-7b", dict(n_layers=1, moe_group_size=8), False),
    ("ssm_tp2", 2, "xlstm-350m", dict(n_layers=1), False),
    ("ssm_tp4", 4, "xlstm-350m", dict(n_layers=1), False),
    ("hybrid_tp2", 2, "hymba-1.5b", dict(n_layers=1), False),
    ("hybrid_tp4", 4, "hymba-1.5b", dict(n_layers=1), False),
    ("seq_tp2", 2, "qwen2-0.5b", dict(n_layers=1, seq_parallel=True), False),
    ("seq_tp4", 4, "qwen2-0.5b", dict(n_layers=1, seq_parallel=True), False),
]
B, S = 2, 16
REF_PARTS = 2

# the conjugates: (name, inputs as (B, C, D) blocks unless stated); each
# rank's inputs and cotangents are slice r of a (tp, ...) numpy array
CONJ = ["push", "pull", "psum", "push_ring", "pull_ring", "psum_ring",
        "seq_gather", "seq_scatter", "ctx_enter", "ctx_exit", "ring_attn",
        "ring_attn_window", "rms_sharded", "pull_ring_bf16"]

COMMON = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np

    def conj_inputs(tp):
        rng = np.random.default_rng(100 + tp)
        f = lambda *s: rng.standard_normal((tp, *s)).astype(np.float32)
        return {"x": f(2, 8, 16), "ct": f(2, 8, 16),
                "ct_gather": f(2, 8 * tp, 16), "ct_scatter": f(2, 8 // tp, 16),
                "ct_enter": f(2, 8 // tp, 16),
                "q": f(2, 4, 4, 8), "k": f(2, 4, 2, 8), "v": f(2, 4, 2, 8),
                "ct_attn": f(2, 4, 4, 8), "scale": f(16),
                "odd": f(2, 7, 5)}

    def case_tree(raw, name):
        # a case's params as nested dicts of numpy arrays
        tree = {}
        for key in raw.files:
            if key.startswith(name + "/param/"):
                node, path = tree, key[len(name) + 7:].split("/")
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = raw[key]
        return tree
""")


def _inputs(cases) -> dict:
    """Every case's numpy params (in the reference's init scales), tokens,
    loss mask and a vlm's image embeddings, under "name/param/path",
    "name/tokens", "name/mask", "name/fe"."""
    out = {}
    for k, (name, tp, arch, over, mask) in enumerate(cases):
        cfg = dataclasses.replace(get_config(arch).smoke(), **over)
        rng = np.random.default_rng(1000 + k)
        for path, shape in sh.spec_items(cfg):
            leaf = path[-1]
            if leaf.startswith(("ln", "q_norm", "k_norm", "m_ln")):
                x = 1.0 + 0.1 * rng.standard_normal(shape)
            elif leaf.startswith("b") or leaf in ("m_D", "m_A"):
                x = 0.1 * rng.standard_normal(shape)
            else:
                fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                x = rng.standard_normal(shape) * fan_in ** -0.5
            out[f"{name}/param/" + "/".join(path)] = x.astype(np.float32)
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab,
                                             (B, S)).astype(np.int32)
        if mask:
            out[f"{name}/mask"] = (rng.random((B, S)) > 0.3).astype(
                np.float32)
        if cfg.frontend == "vlm":
            out[f"{name}/fe"] = rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_frontend)).astype(
                    np.float32)
    return out

REF_SCRIPT = COMMON + textwrap.dedent("""
    work, part, parts = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        "--xla_backend_optimization_level=0 "
        "--xla_llvm_disable_expensive_passes=true")
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import get_config
    from repro.dist import sharding as sh
    from repro.launch.train import _shard_map
    from repro.models import layers as L
    from repro.models import transformer as tr

    spec = json.load(open(os.path.join(work, "spec.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    out = {}

    def conjugates(tp):
        a = conj_inputs(tp)
        M = "model"

        def body(x, ct, ctg, cts, cte, q, k, v, cta, scale, odd):
            x, ct, ctg, cts, cte, q, k, v, cta, scale, odd = (
                t[0] for t in (x, ct, ctg, cts, cte, q, k, v, cta, scale,
                               odd))
            res = {}

            def vjp(name, f, args, cot):
                y, back = jax.vjp(f, *args)
                res[name + "/y"] = y[None]
                for i, g in enumerate(back(cot)):
                    res[name + f"/g{i}"] = g[None]

            vjp("push", lambda t: L.tp_push(t, M), (x,), ct)
            vjp("pull", lambda t: L.tp_pull(t, M), (x,), ct)
            vjp("psum", lambda t: L.tp_psum(t, M), (x,), ct)
            vjp("push_ring", lambda t: L.tp_push_ring(t, M, tp), (x,), ct)
            vjp("pull_ring", lambda t: L.tp_pull_ring(t, M, tp), (x,), ct)
            vjp("psum_ring", lambda t: L.tp_psum_ring(t, M, tp), (x,), ct)
            vjp("seq_gather", lambda t: L.tp_seq_gather(t, M, 1), (x,), ctg)
            vjp("seq_scatter", lambda t: L.tp_seq_scatter(t, M, 1), (x,),
                cts)
            vjp("ctx_enter", lambda t: L.ctx_enter(t, M, tp), (x,), cte)
            vjp("ctx_exit", lambda t: L.ctx_exit(t, M, tp), (x,), ctg)
            vjp("ring_attn", lambda a_, b_, c_: L.ring_attention(
                a_, b_, c_, M, tp), (q, k, v), cta)
            vjp("ring_attn_window", lambda a_, b_, c_: L.ring_attention(
                a_, b_, c_, M, tp, window=5), (q, k, v), cta)
            vjp("rms_sharded", lambda t, s: L.rms_norm_sharded(
                t, s, 1e-6, M, 16 * tp), (x, scale), ct)
            res["pull_ring_bf16/y"] = L.tp_pull_ring(
                odd.astype(jnp.bfloat16), M, tp).astype(jnp.float32)[None]
            res["pull_ring_odd/y"] = L.tp_pull_ring(odd, M, tp)[None]
            return res

        mesh = Mesh(np.array(jax.devices()[:tp]), (M,))
        names = ("x", "ct", "ct_gather", "ct_scatter", "ct_enter", "q", "k",
                 "v", "ct_attn", "scale", "odd")
        fn = _shard_map(body, mesh, in_specs=(P(M),) * len(names),
                        out_specs=P(M))
        with mesh:
            res = jax.jit(fn)(*(jnp.asarray(a[n]) for n in names))
        for key, val in res.items():
            out[f"conj{tp}/{key}"] = np.asarray(val)

    def run_case(name, tp, arch, over, mask):
        cfg = dataclasses.replace(get_config(arch).smoke(), **over)
        params = jax.tree.map(jnp.asarray, case_tree(raw, name))
        batch = {"tokens": jnp.asarray(raw[name + "/tokens"])}
        if mask:
            batch["loss_mask"] = jnp.asarray(raw[name + "/mask"])
        if name + "/fe" in raw.files:
            batch["frontend_embeds"] = jnp.asarray(raw[name + "/fe"])
        rep_loss, rep_grads = jax.jit(jax.value_and_grad(
            lambda p: tr.loss_fn(p, cfg, batch)))(params)
        mesh = Mesh(np.array(jax.devices()[:tp]), ("model",))
        specs = sh.tp_specs(cfg, tp)
        plan = tr.tp_plan(cfg, tp)
        pspec = jax.tree.map(
            lambda s: P(*([None] * s.dim + ["model"])) if s.dim >= 0
            else P(), specs)

        def body(params, midx):
            rt = tr.TPRuntime("model", tp, midx[0], plan)
            loss, grads = jax.value_and_grad(
                lambda p: tr.loss_fn(p, cfg, batch, tp=rt))(params)
            return loss, sh.tp_grad_sync(grads, specs, "model")

        fn = _shard_map(body, mesh, in_specs=(pspec, P("model")),
                        out_specs=(P(), pspec))
        with mesh:
            loss, grads = jax.jit(fn)(params,
                                      jnp.arange(tp, dtype=jnp.int32))
        out[f"{name}/rep_loss"] = np.asarray(rep_loss)
        out[f"{name}/tp_loss"] = np.asarray(loss)
        for i, (g, r) in enumerate(zip(jax.tree.leaves(grads),
                                       jax.tree.leaves(rep_grads))):
            out[f"{name}/tp_g{i}"] = np.asarray(g)
            out[f"{name}/rep_g{i}"] = np.asarray(r)

    # part k of the reference's work: every parts-th case, and the
    # conjugates (where the run takes them) in the last part
    if part == parts - 1 and spec["conj"]:
        for tp in (2, 4):
            conjugates(tp)
    for case in spec["cases"][part::parts]:
        run_case(*case)
    np.savez(os.path.join(work, f"ref{part}.npz"), **out)
""")

PORT_WORKER = COMMON + textwrap.dedent("""
    work = sys.argv[1]
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_jax, tree_leaves, tree_map
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.models import layers as L
    from repro_torch.models import shard_plan as sp
    from repro_torch.models import transformer as tr

    torch.set_num_threads(1)
    spec = json.load(open(os.path.join(work, "spec.json")))
    raw = np.load(os.path.join(work, "inputs.npz"))
    init_process_group("cpu")
    rank = dist.get_rank()
    # every rank makes every group: pairs (0, 1), (2, 3) and all four
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {2: pairs[rank // 2], 4: dist.new_group([0, 1, 2, 3])}
    out = {}

    def conjugates(tp):
        a = {k: torch.from_numpy(v[rank % tp])
             for k, v in conj_inputs(tp).items()}
        rt = sp.TPRuntime(groups[tp], tp, rank % tp, sp.TPPlan(tp))

        def vjp(name, f, args, cot):
            args = [t.clone().requires_grad_() for t in args]
            y = f(*args)
            out[f"conj{tp}/{name}/y"] = y.detach().numpy()
            for i, g in enumerate(torch.autograd.grad(y, args, cot)):
                out[f"conj{tp}/{name}/g{i}"] = g.numpy()

        x, ct = a["x"], a["ct"]
        vjp("push", lambda t: L.tp_push(t, rt), (x,), ct)
        vjp("pull", lambda t: L.tp_pull(t, rt), (x,), ct)
        vjp("psum", lambda t: L.tp_psum(t, rt), (x,), ct)
        vjp("push_ring", lambda t: L.tp_push_ring(t, rt), (x,), ct)
        vjp("pull_ring", lambda t: L.tp_pull_ring(t, rt), (x,), ct)
        vjp("psum_ring", lambda t: L.tp_psum_ring(t, rt), (x,), ct)
        vjp("seq_gather", lambda t: L.tp_seq_gather(t, rt, 1), (x,),
            a["ct_gather"])
        vjp("seq_scatter", lambda t: L.tp_seq_scatter(t, rt, 1), (x,),
            a["ct_scatter"])
        vjp("ctx_enter", lambda t: L.ctx_enter(t, rt), (x,), a["ct_enter"])
        vjp("ctx_exit", lambda t: L.ctx_exit(t, rt), (x,), a["ct_gather"])
        qkv = (a["q"], a["k"], a["v"])
        vjp("ring_attn", lambda q, k, v: L.ring_attention(q, k, v, rt),
            qkv, a["ct_attn"])
        vjp("ring_attn_window", lambda q, k, v: L.ring_attention(
            q, k, v, rt, window=5), qkv, a["ct_attn"])
        vjp("rms_sharded", lambda t, s: L.rms_norm_sharded(
            t, s, 1e-6, rt, 16 * tp), (x, a["scale"]), ct)
        out[f"conj{tp}/pull_ring_bf16/y"] = L.tp_pull_ring(
            a["odd"].to(torch.bfloat16), rt).float().numpy()
        out[f"conj{tp}/pull_ring_odd/y"] = L.tp_pull_ring(
            a["odd"], rt).numpy()

    def run_case(name, tp, arch, over, mask):
        cfg = dataclasses.replace(get_config(arch).smoke(), **over)
        params = params_from_jax(case_tree(raw, name), device="cpu")
        batch = {"tokens": torch.from_numpy(raw[name + "/tokens"])}
        if mask:
            batch["loss_mask"] = torch.from_numpy(raw[name + "/mask"])
        if name + "/fe" in raw.files:
            batch["frontend_embeds"] = torch.from_numpy(raw[name + "/fe"])
        specs = sh.tp_specs(cfg, tp)
        rt = sp.TPRuntime(groups[tp], tp, rank % tp, sp.build_plan(cfg, tp))
        local = tree_map(lambda x, s: sh.tp_shard(x, s, tp, rank % tp)
                         .clone().requires_grad_(), params, specs)
        loss = tr.loss_fn(local, cfg, batch, tp=rt)
        grads = list(torch.autograd.grad(loss, tree_leaves(local)))
        grads = sh.tp_grad_sync(grads, tree_leaves(specs), rt)
        out[f"{name}/loss"] = loss.detach().numpy()
        for i, g in enumerate(grads):
            out[f"{name}/g{i}"] = g.numpy()

    if spec["conj"]:
        for tp in (2, 4):
            conjugates(tp)
    for case in spec["cases"]:
        run_case(*case)
    np.savez(os.path.join(work, f"port_{rank}.npz"), **out)
    dist.destroy_process_group()
""")


def launch(tmp_path_factory, cases, conj: bool):
    """The reference's subprocesses (its work cut in ``REF_PARTS``, whose
    compiles take most of the time) and the port's four-rank launch, side
    by side, on the same numpy inputs: ``cases``' losses and gradients,
    and with ``conj`` the conjugates.  Returns (the reference's arrays,
    the four ranks' arrays)."""
    work = tmp_path_factory.mktemp("tp")
    (work / "spec.json").write_text(json.dumps({"cases": cases,
                                                "conj": conj}))
    np.savez(work / "inputs.npz", **_inputs(cases))
    (work / "worker.py").write_text(PORT_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work),
                          str(part), str(REF_PARTS)],
                         cwd=repo, env=SUBPROC_ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for part in range(REF_PARTS)] + [
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
    ref = {}
    for part in range(REF_PARTS):
        ref.update(np.load(work / f"ref{part}.npz"))
    return ref, [dict(np.load(work / f"port_{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's twelve cases and the conjugates, both packages."""
    return launch(tmp_path_factory, CASES, conj=True)


CONJ_TOL = {"ring_attn": 2e-6, "ring_attn_window": 2e-6,
            "rms_sharded": 2e-6}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", CONJ)
def test_conjugate_matches_the_references(runs, name, tp):
    """Rank by rank, the conjugate's forward and its input gradients
    against the reference's ``shard_map``: the plain pair's sums within
    1e-6 of the output's scale (gloo and XLA may add in other orders;
    measured 8.3e-8 at 4 ranks), ring attention and the sharded norm
    within ``CONJ_TOL`` (measured 3.1e-7); the ring variants bit for bit
    both ways, and the ring all-reduce of an f32 and a bf16 payload whose
    size no chunk count divides, bit for bit."""
    ref, ranks = runs
    keys = sorted(k for k in ref if k.startswith(f"conj{tp}/{name}/"))
    assert keys, name
    for key in keys:
        want = ref[key]
        got = np.stack([ranks[r][key] for r in range(tp)])
        assert got.shape == want.shape, key
        if name.endswith(("_ring", "_ring_bf16")):
            np.testing.assert_array_equal(got, want, err_msg=key)
            continue
        tol = CONJ_TOL.get(name, 1e-6) * max(np.abs(want).max(), 1.0)
        assert np.abs(got - want).max() <= tol, key
    if name == "pull_ring_bf16":
        key = f"conj{tp}/pull_ring_odd/y"
        np.testing.assert_array_equal(
            np.stack([ranks[r][key] for r in range(tp)]), ref[key])


def _grad_err(got, want):
    return float(np.max(np.abs(got.astype(np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-4))


def check_case(runs, name, tp, arch, over):
    """The port's TP loss and gradients (each rank's shards merged,
    partial leaves all-reduced) against the reference's TP loss_fn and
    its replicated one: loss within ``LOSS_TOL``, each leaf within
    ``GRAD_TOL`` of its scale; replicated and partial leaves equal on
    every rank of the group."""
    ref, ranks = runs
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    specs = tree_leaves(sh.tp_specs(cfg, tp))
    assert sp.build_plan(cfg, tp).active
    loss = float(ranks[0][f"{name}/loss"])
    for r in range(1, tp):
        assert float(ranks[r][f"{name}/loss"]) == loss
    for kind in ("tp", "rep"):
        assert abs(loss - float(ref[f"{name}/{kind}_loss"])) <= LOSS_TOL, \
            (name, kind, loss, float(ref[f"{name}/{kind}_loss"]))
    for i, s in enumerate(specs):
        pieces = [ranks[r][f"{name}/g{i}"] for r in range(tp)]
        if s.dim >= 0:
            got = np.concatenate(pieces, s.dim)
        else:
            for p in pieces[1:]:
                np.testing.assert_array_equal(p, pieces[0])
            got = pieces[0]
        for kind in ("tp", "rep"):
            want = ref[f"{name}/{kind}_g{i}"]
            assert got.shape == want.shape, (name, i)
            err = _grad_err(got, want)
            assert err <= GRAD_TOL, (name, kind, i, err)


@pytest.mark.parametrize("name,tp,arch,over,mask", CASES,
                         ids=[c[0] for c in CASES])
def test_tp_loss_fn_matches_the_references(runs, name, tp, arch, over,
                                           mask):
    """The reference's twelve cases (:func:`check_case`)."""
    check_case(runs, name, tp, arch, over)
