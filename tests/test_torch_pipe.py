"""The pipe axis's geometry against the reference, in one process on the
CPU: ``pipe_dims``, ``pipe_local_shape``, which leaves ``pipe_grad_sync``
sums, the scatter dims, int8 wire layouts and byte counts of the pipe-
and TP-local leaves on (data, pipe, model) meshes, the composite store
box where the pipe, model and data cuts land on one dim (against the
reference's ``composite_store_spec``), the composite checkpoint written
by eight simulated ranks and read by the reference's
``restore_sharded``, and the 3-D mesh's layout.

The pipelined loss and step over gloo ranks are
``tests/test_torch_pipe_step.py``.
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

import jax  # noqa: E402

from repro.checkpoint import msgpack_ckpt as ref_ck  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.dist import sharding as ref_sh  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as ck  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import shard_plan as sp  # noqa: E402

# (data, pipe, model) meshes of the geometry tests
MESHES = [(2, 2, 1), (1, 2, 2), (2, 2, 2), (1, 4, 1), (2, 4, 2), (4, 2, 1)]


def _meshes(data, pipe, model):
    """Stubs of the reference's (data, pipe, model) ``Mesh`` and of the
    port's ``DeviceMesh``: the helpers read only the axis names and
    sizes."""
    shape = (data, pipe, model)
    ref = types.SimpleNamespace(axis_names=("data", "pipe", "model"),
                                devices=np.zeros(shape))
    port = types.SimpleNamespace(mesh_dim_names=("data", "pipe", "model"),
                                 size=lambda i: shape[i])
    return ref, port


@pytest.mark.parametrize("pp", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_pipe_dims_equal_the_references(arch, pp):
    """Every zoo config, full and smoke: the block leaves at dim 0 when
    the pipe axis is real, every other leaf -1, as the reference's tree;
    and each leaf's pipe-local shape."""
    for ref, cfg in ((ref_get_config(arch), get_config(arch)),
                     (ref_get_config(arch).smoke(), get_config(arch).smoke())):
        got = sh.pipe_dims(cfg, pp)
        want = ref_sh.pipe_dims(ref, pp)
        assert tree_leaves(got) == jax.tree.leaves(want)
        assert sorted(got) == sorted(want)
        assert sorted(got["blocks"]) == sorted(want["blocks"])
        for (_, shape), pd in zip(sh.spec_items(cfg), tree_leaves(got)):
            assert sh.pipe_local_shape(shape, pd, pp) == \
                ref_sh.pipe_local_shape(shape, pd, pp)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "olmoe-1b-7b", "hymba-1.5b",
                                  "internvl2-26b"])
def test_pipe_grad_sync_sums_the_references_leaves(arch, monkeypatch):
    """The leaves ``pipe_grad_sync`` all-reduces over the pipe group are
    the ones the reference's ``psum``s over 'pipe' (both collectives
    replaced by markers), in leaf order; the others pass through as the
    same tensors."""
    cfg, ref = get_config(arch).smoke(), ref_get_config(arch).smoke()
    pdims, ref_pdims = sh.pipe_dims(cfg, 2), ref_sh.pipe_dims(ref, 2)
    summed, ref_summed = [], []
    monkeypatch.setattr(sh.cl, "all_reduce",
                        lambda g, group: summed.append(int(g)) or -g)
    monkeypatch.setattr(jax.lax, "psum",
                        lambda g, axis: ref_summed.append(int(g)) or -g)
    grads = sh.shape_tree(cfg, lambda shape: None)
    grads = tree_unflatten(grads, [torch.tensor(i) for i in
                                   range(len(tree_leaves(grads)))])
    out = sh.pipe_grad_sync(grads, pdims, sp.PipeRuntime("pipe", 2, 0, None))
    ref_out = ref_sh.pipe_grad_sync(
        jax.tree.map(lambda t: int(t), grads), ref_pdims, "pipe")
    assert summed == ref_summed and summed
    assert [int(x) for x in tree_leaves(out)] == jax.tree.leaves(ref_out)
    for g, o, pd in zip(tree_leaves(grads), tree_leaves(out),
                        tree_leaves(pdims)):
        assert (o is g) == (pd >= 0)


@pytest.mark.parametrize("arch", ["eris-gptneo-1.3b", "qwen2-0.5b",
                                  "olmoe-1b-7b", "hymba-1.5b", "xlstm-350m"])
@pytest.mark.parametrize("data,pipe,model", MESHES)
def test_pipe_local_geometry_equals_the_references(arch, data, pipe, model):
    """On a (data, pipe, model) mesh: the scatter dims of the pipe- and
    TP-local shapes, the int8 wire layouts, the wire bytes both ways and
    the resident bytes per device, full width and smoke."""
    ref_mesh, mesh = _meshes(data, pipe, model)
    for ref, cfg in ((ref_get_config(arch), get_config(arch)),
                     (ref_get_config(arch).smoke(), get_config(arch).smoke())):
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


def _spec_box(spec, shape, sizes, coords):
    """The box a ``PartitionSpec`` gives the device at ``coords`` (mesh
    axis -> index): on each dim the named axes split it, the first
    major, as jax lays a ``NamedSharding``."""
    start, size = [0] * len(shape), list(shape)
    for d, axes in enumerate(tuple(spec) + (None,) * (len(shape)
                                                     - len(spec))):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        parts, index = 1, 0
        for a in axes:
            parts, index = parts * sizes[a], index * sizes[a] + coords[a]
        size[d] = shape[d] // parts
        start[d] = index * size[d]
    return start, size


# (full shape, pipe dim, TP dim) of the shared-dim leaves: (8, 3) has
# dim 0 both pipe-cut and the scatter dim (3 does not divide); (16, 3, 5)
# has the pipe, TP and scatter cuts all on dim 0; (8, 12) the pipe cut on
# dim 0, the TP and scatter cuts nested on dim 1; (4, 6) no pipe cut
SHARED = [((8, 3), 0, -1), ((16, 3, 5), 0, 0), ((8, 12), 0, 1),
          ((4, 6), -1, 0)]


@pytest.mark.parametrize("shape,pdim,tdim", SHARED)
@pytest.mark.parametrize("data,pipe,model", [(2, 2, 1), (2, 2, 2),
                                             (1, 2, 2)])
def test_composite_box_of_a_shared_dim_leaf(shape, pdim, tdim, data, pipe,
                                            model):
    """Rank (a, s, j)'s piece of a leaf whose cuts land on one dim is the
    box of the reference's ``composite_store_spec`` (pipe major, then
    model, then the data segment), one contiguous box; the boxes tile the
    leaf exactly once; ``composite_store_shard`` is that box."""
    tp_local = sh.tp_local_shape(shape, sh.TPSpec(tdim, "col"), model)
    local = sh.pipe_local_shape(tp_local, pdim, pipe)
    fdim = sh.scatter_dim_for(local, data)
    spec = ref_sh.composite_store_spec(tdim if model > 1 else -1, fdim,
                                       "data", pdim if pipe > 1 else -1)
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    sizes = {"data": data, "pipe": pipe, "model": model}
    seen = torch.zeros(shape, dtype=torch.int64)
    for a, s, j in itertools.product(range(data), range(pipe), range(model)):
        cuts = ((pdim, pipe, s), (tdim, model, j), (fdim, data, a))
        start, size = sh.composite_box(shape, cuts)
        assert (start, size) == _spec_box(
            spec, shape, sizes, {"data": a, "pipe": s, "model": j}), \
            (a, s, j, spec)
        piece = sh.composite_store_shard(x, sh.TPSpec(tdim, "col"), model,
                                         j, fdim, data, a, pdim, pipe, s)
        box = tuple(slice(st, st + sz) for st, sz in zip(start, size))
        assert torch.equal(piece, x[box])
        assert sh.whole_shape(tuple(piece.shape), cuts) == shape
        seen[box] += 1
    # replicated over an axis whose cut is -1: count its copies
    copies = ((1 if fdim >= 0 else data) * (1 if pdim >= 0 else pipe)
              * (1 if tdim >= 0 else model))
    assert bool((seen == copies).all())


def test_composite_checkpoint_reads_in_the_reference(tmp_path):
    """Eight simulated ranks of a (2, 2, 2) mesh write their pieces of a
    tree with shared-dim, TP-only, pipe-only and replicated leaves: only
    the rank at index 0 on every axis a leaf is not cut over writes it;
    the reference's ``restore_sharded`` reads every leaf back bit for
    bit, the port's whole and each rank's piece with its cuts."""
    rng = np.random.default_rng(3)
    tree = {"blocks": {"ln": rng.standard_normal((8, 3)).astype(np.float32),
                       "w": rng.standard_normal((4, 6, 8)).astype(
                           np.float32)},
            "embed": rng.standard_normal((10, 4)).astype(np.float32),
            "ln_f": rng.standard_normal((5,)).astype(np.float32)}
    # (pipe dim, TP dim) a leaf, in flatten order: blocks/ln, blocks/w,
    # embed, ln_f
    axes = [(0, -1), (0, 2), (-1, 0), (-1, -1)]
    full = [torch.from_numpy(x) for x in tree_leaves(tree)]
    data = pipe = model = 2
    chains = {}
    for r, (a, s, j) in enumerate(itertools.product(range(data), range(pipe),
                                                    range(model))):
        chain = []
        for x, (pd, td) in zip(full, axes):
            local = sh.pipe_local_shape(sh.tp_local_shape(
                tuple(x.shape), sh.TPSpec(td, "col"), model), pd, pipe)
            chain.append(((pd, pipe, s), (td, model, j),
                          (sh.scatter_dim_for(local, data), data, a)))
        chains[r] = chain
        pieces = [sh.cut_piece(x, c).clone() for x, c in zip(full, chain)]
        ck.save_sharded(tmp_path, tree_unflatten(tree, pieces), rank=r,
                        world=8, cuts=chain)
    # ln_f (5,) splits nowhere: one writer, rank 0; ln (8, 3) is cut at
    # dim 0 by pipe and data and replicated over model: four writers
    import msgpack
    writers = {k: [r for r in range(8) if msgpack.unpackb(
        (tmp_path / f"shard-{r}.msgpack").read_bytes())[k]]
        for k in ("ln_f", "blocks/ln", "blocks/w", "embed")}
    assert writers["ln_f"] == [0]
    assert writers["blocks/ln"] == [0, 2, 4, 6]
    assert writers["blocks/w"] == list(range(8))
    target = jax.tree.map(np.zeros_like, tree)
    got = ref_ck.restore_sharded(tmp_path, target)
    for g, x in zip(jax.tree.leaves(got), tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(g), x)
    whole = ck.restore_sharded(tmp_path, target)
    for g, x in zip(tree_leaves(whole), full):
        assert torch.equal(g, x)
    for r, chain in chains.items():
        mine = ck.restore_any(tmp_path, target, rank=r, world=8, cuts=chain)
        for g, x, c in zip(tree_leaves(mine), full, chain):
            assert torch.equal(g, sh.cut_piece(x, c))


def test_store_cuts_nest_pipe_model_data(monkeypatch):
    """``train.store_cuts`` on a (2, 2, 2) mesh: each leaf's cuts are its
    pipe dim, its TP dim and its scatter dim of the pipe- and TP-local
    shape, at the rank's coordinates, pipe first; ``store_params`` cuts
    each leaf to that box, and ``abstract_train_state`` and
    ``init_dsc_state`` give its shapes (ranks stubbed: aggregator 1,
    stage 1, model position 0)."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke(), n_layers=4)
    _, mesh = _meshes(2, 2, 2)
    mesh.get_group = lambda name: name
    coords = {"data": 1, "pipe": 1, "model": 0}
    monkeypatch.setattr(train.dist, "get_rank", lambda group: coords[group])
    cuts = train.store_cuts(cfg, mesh)
    dims = tree_leaves(sh.fsa_scatter_dims(cfg, mesh))
    pdims = tree_leaves(sh.pipe_dims(cfg, 2))
    specs = tree_leaves(sh.tp_specs(cfg, 2))
    assert cuts == [((pd, 2, 1), (s.dim, 2, 0), (d, 2, 1))
                    for pd, s, d in zip(pdims, specs, dims)]
    from repro_torch.models import transformer as tr
    params = tr.init_params(cfg, seed=0, device="cpu")
    stored = train.store_params(params, cfg, mesh)
    local = sh.local_shapes(cfg, mesh)
    for x, y, c, shape, d in zip(tree_leaves(params), tree_leaves(stored),
                                 cuts, local, dims):
        assert torch.equal(y, sh.cut_piece(x, c))
        want = list(shape)
        if d >= 0:
            want[d] //= 2
        assert list(y.shape) == want
    from repro_torch.optim import sgd
    settings = train.TrainSettings(use_dsc=True)
    abstract, _, _ = train.abstract_train_state(cfg, mesh, sgd(0.1),
                                                settings)
    dsc = train.init_dsc_state(cfg, mesh, settings, device="cpu")
    for y, a, s_agg, s_k, shape in zip(
            tree_leaves(stored), tree_leaves(abstract),
            tree_leaves(dsc["s_agg"]), tree_leaves(dsc["s_clients"]),
            local):
        assert a.shape == y.shape == s_agg.shape
        assert tuple(s_k.shape) == (1, *shape)


def test_make_host_mesh_lays_data_pipe_model(monkeypatch):
    """``make_host_mesh(pipe > 1)`` lays the reference's ``("data",
    "pipe", "model")`` mesh, model minor-most, then pipe (so rank = (a *
    pipe + s) * model + j), inferring data from the world size, and
    keeps the reference's messages for a factorization that does not
    fit."""
    import torch.distributed.device_mesh as dm
    laid = []
    monkeypatch.setattr(dm, "init_device_mesh",
                        lambda *a, **k: laid.append((a, k)) or "mesh")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 8)
    assert mesh_lib.make_host_mesh(device="cpu", pipe=2) == "mesh"
    assert mesh_lib.make_host_mesh(device="cpu", pipe=2, model=2) == "mesh"
    assert mesh_lib.make_host_mesh(device="cpu", data=1, pipe=2,
                                   model=4) == "mesh"
    names = {"mesh_dim_names": ("data", "pipe", "model")}
    assert laid == [(("cpu", (4, 2, 1)), names), (("cpu", (2, 2, 2)), names),
                    (("cpu", (1, 2, 4)), names)]
    with pytest.raises(ValueError, match="needs 16 devices but 8"):
        mesh_lib.make_host_mesh(device="cpu", data=4, pipe=2, model=2)
    with pytest.raises(ValueError, match="model axis size 3 x pipe 2"):
        mesh_lib.make_host_mesh(device="cpu", pipe=2, model=3)

