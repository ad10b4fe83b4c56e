"""Adversary-view geometry (``repro/privacy/views.py``): what each
aggregator observes, and where.

The simulator's literal FSA (``core/fsa.fsa_round_sharded``) expresses an
aggregator's view as a masked flat vector, ``m_(a) (.) v_k`` over the
ravelled parameter vector.  The distributed step expresses the same view
as per-leaf segment rows: aggregator a receives, for every leaf with a
client scatter dim, the flattened contiguous segment a of every client's
update (on a model axis, of its TP-local update: ``launch/train.py``'s
``capture_views`` tap).  This module is the bridge:

* :func:`view_layouts` / :func:`mesh_flat_assignment` -- the flat
  coordinate->aggregator assignment induced by the mesh layout (the
  chunking of ``dist/sharding.split_shards`` and of the store shards;
  coordinates on the all-reduce fallback map to -1: no aggregator sees
  them per client, only their sum).
* :func:`flat_views_from_leaves` -- one round of captured view payloads
  reassembled into the simulator's ``(A, K, n)`` array, zeros off-mask.
* :func:`colluding_view` -- the Cor. D.2 coalition view (disjoint masks
  make the union a plain sum over the coalition's aggregators).

Plain numpy index bookkeeping, equal to the reference's: leaves are taken
in jax's flatten order (``convert.tree_leaves``) and need only a
``shape`` (tensors, meta tensors or numpy arrays).  With a model axis
(``tp > 1`` and ``tp_specs``, ``dist.sharding.tp_specs``) each leaf's
view rows are model position j's chunks in turn, j = 0 .. tp - 1, as the
tap concatenates them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.convert import tree_leaves
from repro_torch.dist.sharding import scatter_dim_for, tp_local_shape


def _np_split_rows(arr: np.ndarray, dim: int, n_client: int) -> np.ndarray:
    """numpy twin of ``dist/sharding.split_shards``: (n_client, m) rows of
    flat indices, row a = aggregator a's contiguous segment of ``dim``."""
    pre = arr.shape[:dim]
    size = arr.shape[dim] // n_client
    x = arr.reshape(*pre, n_client, size, *arr.shape[dim + 1:])
    x = np.moveaxis(x, len(pre), 0)
    return x.reshape(n_client, -1)


@dataclasses.dataclass(frozen=True)
class LeafViewLayout:
    """Where one parameter leaf's captured view rows land in flat coords.

    ``chunks[j][a]`` holds the flat ravel indices (leaf offset included)
    of model-position j's segment for aggregator a; ``dim < 0`` leaves
    (no client-divisible dimension: replicated and all-reduced) carry no
    chunks.  ``dup`` marks leaves replicated over the model axis whose
    captured width still concatenates ``tp`` identical chunks."""

    index: int                 # leaf position in jax.tree flatten order
    offset: int                # flat offset in the ravelled vector
    shape: tuple               # full (global) leaf shape
    dim: int                   # client scatter dim on the TP-local shape
    tp_dim: int                # model-axis shard dim (-1 = replicated)
    m_loc: int                 # flat elems per (model pos, aggregator) seg
    dup: bool                  # captured chunks are model-axis duplicates
    chunks: tuple              # tuple over model positions of (A, m_loc)


def _size(shape: tuple) -> int:
    return int(np.prod(shape)) if shape else 1


def view_layouts(params_abs: Any, n_client: int, tp: int = 1,
                 tp_specs: Optional[Any] = None) -> list:
    """Per-leaf view layouts for a parameter tree under (n_client, tp)."""
    leaves = tree_leaves(params_abs)
    spec_leaves = (tree_leaves(tp_specs) if tp_specs is not None
                   else [None] * len(leaves))
    out, offset = [], 0
    for i, (p, s) in enumerate(zip(leaves, spec_leaves)):
        shape = tuple(p.shape)
        size = _size(shape)
        tp_dim = s.dim if (s is not None and tp > 1) else -1
        loc_shape = tp_local_shape(shape, s, tp) if s is not None else shape
        dim = scatter_dim_for(loc_shape, n_client)
        if dim < 0:
            out.append(LeafViewLayout(i, offset, shape, -1, tp_dim, 0,
                                      False, ()))
            offset += size
            continue
        idx = np.arange(size, dtype=np.int64).reshape(shape)
        model_chunks = (np.split(idx, tp, axis=tp_dim) if tp_dim >= 0
                        else [idx])
        chunks = tuple(_np_split_rows(c, dim, n_client)
                       for c in model_chunks)
        out.append(LeafViewLayout(i, offset, shape, dim, tp_dim,
                                  chunks[0].shape[1], tp_dim < 0 and tp > 1,
                                  tuple(c + offset for c in chunks)))
        offset += size
    return out


def mesh_flat_assignment(params_abs: Any, n_client: int, tp: int = 1,
                         tp_specs: Optional[Any] = None) -> np.ndarray:
    """Flat (n,) int32 coordinate->aggregator assignment induced by the
    mesh layout (-1 = all-reduced coordinates: every aggregator observes
    only the client sum there, never a per-client value).  Given to
    ``FSASharded.assign_override`` it makes the simulator's masks the
    distributed step's segment slices, so per-aggregator views compare
    across engines."""
    layouts = view_layouts(params_abs, n_client, tp, tp_specs)
    n = sum(_size(lay.shape) for lay in layouts)
    assign = np.full(n, -1, dtype=np.int32)
    for lay in layouts:
        for rows in lay.chunks:
            for a in range(n_client):
                assign[rows[a]] = a
    return assign


def flat_views_from_leaves(view_leaves: dict, params_abs: Any,
                           n_client: int, tp: int = 1,
                           tp_specs: Optional[Any] = None) -> np.ndarray:
    """Reassemble one round of the distributed tap's captured payloads
    (``{str(leaf_index): (A, K, m_loc * tp)}``, tensors or arrays) into the
    simulator's ``(A, K, n)`` f32 adversary-view array (zeros outside
    each aggregator's mask and on all-reduced coordinates)."""
    layouts = view_layouts(params_abs, n_client, tp, tp_specs)
    n = sum(_size(lay.shape) for lay in layouts)
    if not view_leaves:
        raise ValueError(
            "no captured view leaves: every parameter leaf took the "
            "replicated-psum fallback (no dimension divisible by "
            f"n_client={n_client}), so no per-client payload exists")
    some = _numpy(next(iter(view_leaves.values())))
    A, K = some.shape[:2]
    out = np.zeros((A, K, n), dtype=np.float32)
    for lay in layouts:
        if lay.dim < 0:
            continue
        arr = _numpy(view_leaves[str(lay.index)])
        n_chunks = 1 if lay.dup else len(lay.chunks)
        for j in range(n_chunks):
            cols = arr[:, :, j * lay.m_loc:(j + 1) * lay.m_loc]
            rows = lay.chunks[j]
            for a in range(A):
                out[a][:, rows[a]] = cols[a]      # (K, m_loc) into the mask
    return out


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):                  # a torch tensor
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def colluding_view(views: np.ndarray, coalition) -> np.ndarray:
    """Union view of a colluding coalition (Cor. D.2): masks are disjoint,
    so the union is the sum over the coalition's aggregator axis entries.
    ``views``: (..., A, K, n) with the aggregator axis third-from-last."""
    coalition = list(coalition)
    return np.asarray(views)[..., coalition, :, :].sum(axis=-3)
