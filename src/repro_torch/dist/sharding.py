"""Sharding policy of the distributed FSA step (``repro/dist/sharding.py``,
Section 3.2.1 on a process group), on the data, pipe and model axes.

Every rank of the mesh's client axes (``"data"``, and ``"pod"`` on the
multi-pod production mesh) is one FSA *aggregator*: it
owns a disjoint segment of each parameter (the "store" layout), receives
exactly that segment of every client update through the reduce-scatter
(Eq. 2), and runs the shard-local optimizer on it.

The segment of a parameter is cut along its *scatter dim*: the rightmost
dimension divisible by the number of aggregators.  A leaf with no such
dimension is replicated and aggregated with a full all-reduce (always
correct, never sharded).  The set of (leaf, slice) pairs aggregator a
owns IS the mask m_(a) of ``core/masks`` at tensor granularity, disjoint
and complete by construction, so Theorem B.1 applies unchanged.

The model axis (tensor parallelism, ``models/shard_plan``) shards each
leaf at its :class:`TPSpec` dim, and the pipe axis slices every block
leaf's stacked layer dim 0 into contiguous stages (:func:`pipe_dims`);
the scatter dim is then taken of the PIPE- and TP-LOCAL shape, and the
store layout composes the three: rank (a, s, j) of the (data, pipe,
model) mesh holds aggregator a's segment of model position j's shard of
stage s's rows (:func:`composite_store_shard`).  Where two cuts land on
one dim they nest, pipe major, then model, then the client segment, so
each rank's piece of a leaf is one contiguous box
(:func:`composite_box`).  Theorem B.1 applies per (stage, model
position).

The reference expresses the layout as ``PartitionSpec``s of a jax
``Mesh``; here a rank holds its pieces as plain tensors.  Helpers that
take a ``mesh`` accept the port's ``DeviceMesh``
(``launch/mesh.make_host_mesh``) or the client count itself (a mesh
with the data axis alone).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.convert import tree_leaves, tree_map, tree_unflatten
from repro_torch.dist import collectives as cl
from repro_torch.models.shard_plan import (TPSpec, build_plan,  # noqa: F401
                                           tp_specs)

QBLOCK = 256        # coords per int8-wire scale (kernels/quantize.QBLOCK)
FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}

# ------------------------------------------------------------------ axes
def client_axes(mesh: Union[int, Any]) -> Tuple[str, ...]:
    """Mesh axes enumerating FSA aggregators: every axis but the
    intra-model "model" and "pipe" axes (("pod", "data") on the
    multi-pod production mesh, ("data",) on the host meshes)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ("data",))
    return tuple(a for a in names if a not in ("model", "pipe"))


def client_count(mesh: Union[int, Any]) -> int:
    """Aggregators on the mesh: the product of its client axes' sizes."""
    if isinstance(mesh, int):
        return mesh
    return math.prod(axis_size(mesh, a) for a in client_axes(mesh))


_FLAT_GROUPS: dict = {}     # id(mesh) -> (mesh, this rank's client group)


def client_group(mesh):
    """The process group of this rank's aggregators: the one client
    axis's group, or over several client axes the group of the ranks that
    share this rank's model and pipe positions, in the reference's order
    (the client axes flattened major to minor).  Made once a mesh, every
    rank making every such group in one order (``dist.new_group``'s
    rule)."""
    axes = client_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    hit = _FLAT_GROUPS.get(id(mesh))
    if hit is None:
        names = mesh.mesh_dim_names
        inner = [n for n in names if n not in axes]
        ranks = mesh.mesh.permute([names.index(n) for n in (*axes, *inner)])
        cols = ranks.reshape(client_count(mesh), -1).T.tolist()
        mine, _ = dist.new_subgroups_by_enumeration(cols)
        hit = _FLAT_GROUPS[id(mesh)] = (mesh, mine)
    return hit[1]


def client_rank(mesh) -> int:
    """This rank's aggregator index: its place in :func:`client_group`."""
    return dist.get_rank(client_group(mesh))


def axis_size(mesh: Union[int, Any], name: str) -> int:
    """The size of the mesh's axis ``name`` (1 where it has none, and for
    a bare client count)."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    return int(mesh.size(names.index(name))) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    """This rank's place on the mesh's axis ``name`` (0 where it has none
    or where the axis has one position)."""
    if axis_size(mesh, name) == 1:
        return 0
    return dist.get_rank(mesh.get_group(name))


def model_size(mesh: Union[int, Any]) -> int:
    """The size of the mesh's ``"model"`` axis."""
    return axis_size(mesh, "model")


def pipe_size(mesh: Union[int, Any]) -> int:
    """The size of the mesh's ``"pipe"`` axis."""
    return axis_size(mesh, "pipe")


# ----------------------------------------------------------- model axis
def tp_local_shape(shape: Tuple[int, ...], spec: TPSpec,
                   tp: int) -> Tuple[int, ...]:
    """The per-model-position shape of a leaf under ``spec``."""
    if spec.dim < 0 or tp <= 1:
        return tuple(shape)
    shape = list(shape)
    shape[spec.dim] //= tp
    return tuple(shape)


def tp_shard(x: torch.Tensor, spec: TPSpec, tp: int,
             index: int) -> torch.Tensor:
    """Model position ``index``'s piece of a leaf: the ``index``-th of
    ``tp`` contiguous chunks along ``spec.dim`` (the whole leaf where it
    replicates).  A view of ``x``."""
    if spec.dim < 0 or tp <= 1:
        return x
    size = x.shape[spec.dim] // tp
    return x.narrow(spec.dim, index * size, size)


def tp_split_leaf(x: torch.Tensor, spec: TPSpec, tp: int) -> torch.Tensor:
    """Every model position's shard of one leaf, stacked ``(tp,
    *local_shape)`` (shard i = position i's contiguous chunk); replicated
    leaves stack ``tp`` copies."""
    return torch.stack([tp_shard(x, spec, tp, i) for i in range(max(tp, 1))])


def tp_merge_leaf(shards: torch.Tensor, spec: TPSpec) -> torch.Tensor:
    """Inverse of :func:`tp_split_leaf` (replicated leaves: shard 0)."""
    if spec.dim < 0:
        return shards[0]
    return torch.cat(list(shards), spec.dim)


def tp_grad_sync(grads, specs, tp):
    """After the gradient on the model axis ``tp`` (a ``TPRuntime``):
    ``partial`` leaves (replicated values consumed on local shards) carry
    partial sums, all-reduced over the model group, in leaf order;
    sharded leaves' gradients are local and replicated ones complete, so
    both pass through.  ``grads`` and ``specs`` are trees of the same
    structure (dicts, or lists in flatten order)."""
    return tree_map(
        lambda g, s: (cl.all_reduce(g, tp.group) if s.kind == "partial"
                      else g), grads, specs)


# --------------------------------------------------------- pipe axis
# The pipe axis slices the leading L-stacked layer dim of every block leaf
# into contiguous stages (models/shard_plan.PipelinePlan); the other leaves
# (embed, lm_head, ln_f, proj_in) replicate over pipe: every stage embeds
# its own injection and computes the (masked) CE, so their gradients are
# per-stage partials, summed over the pipe group.
def pipe_dims(cfg, pp: int) -> dict:
    """Each leaf's pipe slice dim, a tree of ints matching the param tree:
    0 for the block leaves when the pipe axis is real, else -1."""
    from repro_torch.models import transformer as tr
    spec = tr.param_spec(cfg)
    out: dict = {}
    for name in spec:
        if name == "blocks":
            out["blocks"] = {bn: (0 if pp > 1 else -1)
                             for bn in spec["blocks"]}
        else:
            out[name] = -1
    return out


def pipe_local_shape(shape: Tuple[int, ...], pdim: int,
                     pp: int) -> Tuple[int, ...]:
    """The per-stage shape of a (TP-local) leaf."""
    if pdim < 0 or pp <= 1:
        return tuple(shape)
    shape = list(shape)
    shape[pdim] //= pp
    return tuple(shape)


def pipe_grad_sync(grads, pdims, pipe):
    """After the gradient of the pipelined loss on the pipe axis ``pipe``
    (a ``PipeRuntime``): the block leaves' gradients are the stage's own
    rows, complete, and pass through; the pipe-replicated leaves carry
    per-stage partial sums, all-reduced over the pipe group, in leaf
    order.  ``grads`` and ``pdims`` are trees of the same structure."""
    return tree_map(
        lambda g, pd: g if pd >= 0 else cl.all_reduce(g, pipe.group),
        grads, pdims)


# ------------------------------------------------- the composite cut
# A rank's piece of a leaf is a chain of cuts, each (dim, parts, index):
# the pipe axis's, the model axis's, then the data axis's, in that
# nesting.  A cut with dim -1 (or one part) leaves the leaf whole on its
# axis: the leaf replicates there.


def composite_box(shape: Tuple[int, ...], cuts) -> Tuple[list, list]:
    """The box a chain of ``cuts`` selects in a leaf of ``shape``: its
    origin and its extent per dim.  Each cut takes the index-th of parts
    contiguous chunks of what the cuts before it left, so cuts that land
    on one dim nest, the first major."""
    start, size = [0] * len(shape), list(shape)
    for dim, parts, index in cuts:
        if dim < 0 or parts <= 1:
            continue
        size[dim] //= parts
        start[dim] += index * size[dim]
    return start, size


def cut_piece(x: torch.Tensor, cuts) -> torch.Tensor:
    """The box of ``x`` that ``cuts`` select (:func:`composite_box`).  A
    view of ``x``."""
    start, size = composite_box(tuple(x.shape), cuts)
    for d, (st, sz) in enumerate(zip(start, size)):
        if sz != x.shape[d]:
            x = x.narrow(d, st, sz)
    return x


def whole_shape(shape: Tuple[int, ...], cuts) -> Tuple[int, ...]:
    """The full leaf's shape, from the shape of a piece that ``cuts``
    selected."""
    shape = list(shape)
    for dim, parts, _ in cuts:
        if dim >= 0 and parts > 1:
            shape[dim] *= parts
    return tuple(shape)


# ------------------------------------------------------- param shapes
def spec_items(cfg) -> Iterator[Tuple[Tuple[str, ...], tuple]]:
    """(key path, shape) of every parameter leaf of the config, in
    flatten order (dict keys sorted)."""
    from repro_torch.models import transformer as tr

    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                yield from walk(node[key], prefix + (key,))
            else:
                yield prefix + (key,), tuple(node[key])

    return walk(tr.param_spec(cfg), ())


def shape_tree(cfg, fn) -> dict:
    """``fn(shape)`` at every leaf of the config's parameter tree."""
    out: dict = {}
    for path, shape in spec_items(cfg):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = fn(shape)
    return out


# ----------------------------------------------------------- scatter dims
def scatter_dim_for(shape: Tuple[int, ...], n_client: int) -> int:
    """Rightmost dim divisible by n_client, else -1 (replicate + psum)."""
    for d in range(len(shape) - 1, -1, -1):
        if shape[d] >= n_client and shape[d] % n_client == 0:
            return d
    return -1


def local_shapes(cfg, mesh) -> list:
    """Each leaf's pipe- and TP-local shape on the mesh's pipe and model
    axes (the block rows of one stage, then one model position's shard),
    in flatten order."""
    tp, pp = model_size(mesh), pipe_size(mesh)
    return [pipe_local_shape(tp_local_shape(shape, s, tp), pd, pp)
            for (_, shape), s, pd in
            zip(spec_items(cfg), tree_leaves(tp_specs(cfg, tp)),
                tree_leaves(pipe_dims(cfg, pp)))]


def local_shape_tree(cfg, mesh, fn) -> dict:
    """``fn(pipe- and TP-local shape)`` at every leaf of the param tree."""
    return tree_unflatten(shape_tree(cfg, lambda shape: None),
                          [fn(shape) for shape in local_shapes(cfg, mesh)])


def fsa_scatter_dims(cfg, mesh) -> dict:
    """Per-leaf scatter dim for the FSA reduce-scatter and the shard-local
    optimizer (a tree of ints matching the param tree), of the PIPE- and
    TP-LOCAL shape: on each rank every leaf is already its stage's rows of
    its model position's shard, and the client segmentation divides
    that."""
    n_client = client_count(mesh)
    return local_shape_tree(cfg, mesh,
                            lambda shape: scatter_dim_for(shape, n_client))


def composite_store_shard(x: torch.Tensor, spec: TPSpec, tp: int,
                          midx: int, fsa_dim: int, n_client: int,
                          aidx: int, pipe_dim: int = -1, pp: int = 1,
                          pidx: int = 0) -> torch.Tensor:
    """Rank (aidx, pidx, midx)'s piece of a full leaf in the store layout:
    stage pidx's rows at ``pipe_dim``, model position midx's TP shard of
    them, then aggregator aidx's segment of that along its scatter dim
    (the reference's ``composite_store_spec``: pipe major, then model,
    then the client segment).  A view of ``x``."""
    return cut_piece(x, ((pipe_dim, pp, pidx), (spec.dim, tp, midx),
                         (fsa_dim, n_client, aidx)))


def store_shard(x: torch.Tensor, dim: int, n_client: int,
                aidx: int) -> torch.Tensor:
    """Aggregator ``aidx``'s piece of a leaf in the store layout: the
    ``aidx``-th of ``n_client`` contiguous segments along ``dim`` (the
    whole leaf where ``dim`` is -1).  A view of ``x``."""
    if dim < 0:
        return x
    size = x.shape[dim] // n_client
    return x.narrow(dim, aidx * size, size)


def shift_state_dtype(name: str) -> torch.dtype:
    """Residency dtype of the DSC shift state (s_clients / s_agg), the one
    knob ``TrainSettings.shift_dtype`` threads through the store layout."""
    dt = FLOAT_DTYPES.get(str(name))
    if dt is None:
        raise ValueError(f"shift_dtype must be a float store dtype, "
                         f"got {name!r}")
    return dt


# --------------------------------------------------------------- serving
# The serving engine's layout on a ("data", "model") mesh (the reference's
# ``paged_pool_shardings``, ``serve_batch_shardings`` and the TP piece of
# ``tp_param_in_specs``): each rank holds its model position's TP piece of
# every leaf, its kv heads of the pools, and decodes its data position's
# slots.
def serve_plan(cfg, tp: int):
    """The decode-safe TP plan that serving runs at model size ``tp``, in
    the engine and in the dry run's serving programs alike: the config's
    plan with no sequence, context or sequence-CE sharding (one token has
    no sequence to shard)."""
    return dataclasses.replace(build_plan(cfg, tp), seq=False,
                               seq_ce=False, ctx=1)


def paged_pool_heads(cfg, plan, tp: int, index: int) -> range:
    """The kv heads that model position ``index`` of ``tp`` holds in its
    paged pools (L, N, KV, bs, hd) under the decode ``plan``: its
    contiguous share where the plan shards attention (``plan.attn``: the
    heads AND the kv heads divide), else all of them, the pools
    replicated and every rank attending with every head.  The block dim
    N stays whole: any request's table may point anywhere in the pool."""
    if tp > 1 and plan.attn:
        kv = cfg.n_kv_heads // tp
        return range(index * kv, (index + 1) * kv)
    return range(cfg.n_kv_heads)


def serve_slots(n_slots: int, mesh) -> range:
    """This rank's decode slots: ``n_slots / n_client`` contiguous slots
    at its client position where the client count divides them (the
    reference's manual path), else every slot."""
    n_client = client_count(mesh)
    if n_slots % n_client:
        return range(n_slots)
    size = n_slots // n_client
    lo = (client_rank(mesh) if n_client > 1 else 0) * size
    return range(lo, lo + size)


def tp_cuts(cfg, tp: int, index: int) -> list:
    """Each leaf's chain of cuts (:func:`composite_box`) to model position
    ``index``'s TP piece, in flatten order: what ``restore_sharded``
    takes to read a rank's piece of any checkpoint."""
    return [((s.dim, tp, index),) for s in tree_leaves(tp_specs(cfg, tp))]


def tp_piece(params, cfg, tp: int, index: int):
    """Model position ``index``'s TP piece of each leaf of ``params``: a
    whole leaf is cut (a contiguous copy; replicated leaves stay whole),
    a leaf that already is the piece passes as it is."""
    whole = [shape for _, shape in spec_items(cfg)]
    return tree_unflatten(params, [
        tp_shard(x, s, tp, index).contiguous() if tuple(x.shape) == w
        else x
        for x, s, w in zip(tree_leaves(params),
                           tree_leaves(tp_specs(cfg, tp)), whole)])


# ------------------------------------------------------ int8 wire layouts
@dataclasses.dataclass(frozen=True)
class WireLayout:
    """Per-leaf layout of the int8 wire payload for the FSA exchange.

    A leaf with scatter dim ``dim >= 0`` is split into ``n_client``
    contiguous segments along ``dim``; each segment is flattened, padded
    to a multiple of QBLOCK, and quantized per-256-block (int8 values +
    one f32 scale per block).  The (block, scale) pair is what crosses
    the group.  ``dim == -1`` leaves (no divisible dimension) stay on the
    un-quantized all-reduce path in the step's ``grad_dtype``.
    """

    dim: int              # scatter dim (-1 = replicated, full psum)
    shard_elems: int      # un-padded elements per aggregator segment
    padded_elems: int     # rounded up to a QBLOCK multiple
    n_blocks: int         # scales per segment (= padded_elems // QBLOCK)

    @property
    def wire_bytes(self) -> int:
        """Bytes one client sends for ONE segment: int8 blocks + scales."""
        return self.padded_elems + 4 * self.n_blocks


def wire_layout_for(shape: Tuple[int, ...], n_client: int) -> WireLayout:
    """Layout of one leaf's int8 wire payload (the geometry the step
    quantizes and exchanges with)."""
    dim = scatter_dim_for(shape, n_client)
    if dim < 0:
        return WireLayout(-1, 0, 0, 0)
    m = math.prod(shape) // n_client
    padded = -(-m // QBLOCK) * QBLOCK
    return WireLayout(dim, m, padded, padded // QBLOCK)


def int8_wire_layouts(cfg, mesh) -> dict:
    """Tree of :class:`WireLayout` matching the parameter tree (the wire
    geometry of the pipe- and TP-local leaf each rank exchanges)."""
    n_client = client_count(mesh)
    return local_shape_tree(cfg, mesh,
                            lambda shape: wire_layout_for(shape, n_client))


def mesh_wire_bytes(cfg, mesh, *, int8: bool, grad_bytes: int = 2) -> int:
    """Bytes ONE client (rank) puts on the data axis per round under the
    FSA exchange: the sum over leaves of every transmitted segment
    (n_client - 1 remote segments + its own, counted once each, matching
    the collective's logical payload).  With a pipe or model axis each
    rank exchanges only its pipe- and TP-local shard, so this is per
    rank; those axes' own traffic is not counted here.  ``int8=False``
    accounts the ``grad_dtype`` path.  Computed from shapes, not
    measured."""
    n_client = client_count(mesh)
    total = 0
    for shape in local_shapes(cfg, mesh):
        lay = wire_layout_for(shape, n_client)
        if int8 and lay.dim >= 0:
            total += n_client * lay.wire_bytes
        else:
            total += math.prod(shape) * grad_bytes
    return total


def param_bytes_per_device(cfg, mesh) -> int:
    """Resident parameter bytes per device in the compute layout: every
    leaf at its pipe- and TP-local shape (client-replicated), in the
    config's dtype."""
    itemsize = FLOAT_DTYPES[cfg.dtype].itemsize
    return sum(math.prod(shape) * itemsize
               for shape in local_shapes(cfg, mesh))


def split_shards(x: torch.Tensor, dim: int, n_client: int) -> torch.Tensor:
    """Reorganize a leaf into its FSA segments: ``(n_client, m)`` rows,
    row a = the flattened contiguous segment of ``dim`` that aggregator a
    owns (the chunking of the reduce-scatter and of :func:`store_shard`;
    the rows ARE the masks m_(a)).  A view where the layout allows (dim 0,
    or one client), else a copy."""
    pre, post = x.shape[:dim], x.shape[dim + 1:]
    size = x.shape[dim] // n_client
    x = x.reshape(*pre, n_client, size, *post)
    x = torch.movedim(x, len(pre), 0)
    return x.reshape(n_client, -1)


def merge_shards(rows: torch.Tensor, dim: int, shape: Tuple[int, ...],
                 n_client: int) -> torch.Tensor:
    """Inverse of :func:`split_shards`: reassemble ``(n_client, m)`` rows
    into the full leaf of ``shape``."""
    pre, post = tuple(shape[:dim]), tuple(shape[dim + 1:])
    size = shape[dim] // n_client
    rows = rows.reshape(n_client, *pre, size, *post)
    rows = torch.movedim(rows, 0, len(pre))
    return rows.reshape(tuple(shape))
