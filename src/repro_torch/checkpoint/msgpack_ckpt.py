"""msgpack checkpoints of trees of tensors, single-file and sharded, in
the reference's byte format (``repro/checkpoint/msgpack_ckpt.py``), so
either package reads what the other wrote.

Single-file (:func:`save` / :func:`restore`): dtype name, shape and raw
C-order bytes per leaf, keyed by the leaf's path joined with "/".

Sharded (:func:`save_sharded` / :func:`restore_sharded`): a DIRECTORY of

    manifest.msgpack        global dtype/shape per leaf (rank 0)
    shard-{rank}.msgpack    this rank's pieces, each as (start offsets,
                            shape, bytes)

The distributed step keeps each leaf as this rank's store piece: on a
(data, pipe, model) mesh a box of the full leaf, cut on the pipe axis
(the stage's block rows), then the model axis (its TP shard), then the
data axis (its segment at the scatter dim), each cut nested in the one
before (``dist/sharding.composite_box``).  A rank writes its box of each
leaf as one record, ``start`` the box's origin, and a leaf that
replicates over an axis is written only by the rank at index 0 on it, as
the reference writes replica 0 only, so every coordinate is written
once.  :func:`restore_sharded` assembles every leaf whole, and with
``cuts`` (or ``dims``, the data axis alone) cuts this rank's piece from
it.

bf16 has no numpy dtype here: its bytes are read and written as uint16
and viewed as ``torch.bfloat16``.  ``msgpack`` is imported inside these
functions only, so importing the module needs no msgpack.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import tree_leaves, tree_unflatten
from repro_torch.dist.sharding import composite_box, cut_piece, whole_shape

_MANIFEST = "manifest.msgpack"
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.bfloat16: "bfloat16", torch.float16: "float16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _key_paths(tree, prefix=()) -> list:
    """The reference's leaf keys (``jax.tree_util`` paths joined with
    "/": dict keys, sequence indices, ``.name`` for NamedTuple fields), in
    flatten order."""
    if isinstance(tree, dict):
        return [k for key in sorted(tree)
                for k in _key_paths(tree[key], prefix + (str(key),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [k for name, node in zip(tree._fields, tree)
                for k in _key_paths(node, prefix + (f".{name}",))]
    if isinstance(tree, (tuple, list)):
        return [k for i, node in enumerate(tree)
                for k in _key_paths(node, prefix + (str(i),))]
    return ["/".join(prefix)]


def _to_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_bytes(data: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(data, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.frombuffer(data, dtype=dtype)
                            .reshape(shape).copy())


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in _NAMES:
        raise TypeError(f"no checkpoint dtype for {t.dtype}")
    return _NAMES[t.dtype]


def save(path, tree) -> None:
    import msgpack
    leaves = {key: {"dtype": _dtype_name(t), "shape": list(t.shape),
                    "data": _to_bytes(t)}
              for key, t in zip(_key_paths(tree), tree_leaves(tree))}
    Path(path).write_bytes(msgpack.packb(leaves))


def restore(path, target, device=None):
    """The tree of ``target``'s structure read from a single-file
    checkpoint; ``target``'s leaves give the shapes to check."""
    import msgpack
    raw = msgpack.unpackb(Path(path).read_bytes())
    out = []
    for key, leaf in zip(_key_paths(target), tree_leaves(target)):
        rec = raw[key]
        t = _from_bytes(rec["data"], rec["dtype"], rec["shape"])
        if tuple(t.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(t.shape)} vs {tuple(np.shape(leaf))}")
        out.append(t.to(device) if device is not None else t)
    return tree_unflatten(target, out)


def _rank_world(rank: Optional[int], world: Optional[int]):
    if rank is None or world is None:
        import torch.distributed as dist
        on = dist.is_available() and dist.is_initialized()
        rank = (dist.get_rank() if on else 0) if rank is None else rank
        world = (dist.get_world_size() if on else 1) if world is None \
            else world
    return rank, world


def _leaf_cuts(n: int, dims: Any, cuts: Optional[list], rank: int,
               world: int) -> list:
    """Each leaf's chain of cuts (``dist/sharding.composite_box``):
    ``cuts`` as given, else the data axis alone from ``dims`` (the leaf
    cut at its dim into ``world`` store shards, of which this rank holds
    the ``rank``-th), else whole."""
    if cuts is not None:
        return list(cuts)
    dim_list = [-1] * n if dims is None else tree_leaves(dims)
    return [((d, world, rank),) for d in dim_list]


def save_sharded(path, tree, dims: Any = None, *, rank: Optional[int] = None,
                 world: Optional[int] = None,
                 cuts: Optional[list] = None) -> None:
    """Write this rank's pieces of ``tree`` into the checkpoint directory
    ``path`` (see the module docstring).  Each leaf of ``tree`` is the
    piece that a chain of cuts selects from the full leaf: ``cuts``, one
    chain of ``(dim, parts, index)`` per leaf in flatten order
    (``launch/train.store_cuts``), or ``dims`` (a tree of ints, as
    ``dist/sharding.fsa_scatter_dims``: the leaf cut at that dim into
    ``world`` store shards, of which ``tree`` holds the ``rank``-th; -1
    whole).  Neither means every leaf is whole and replicated.  A piece
    is written only by the rank whose index is 0 on every axis the leaf
    is not cut over.  ``rank`` and ``world`` default to the process
    group's (0 and 1 without one); ``rank`` names the shard file."""
    import msgpack
    rank, world = _rank_world(rank, world)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(tree)
    manifest, shards = {}, {}
    for key, t, chain in zip(_key_paths(tree), leaves,
                             _leaf_cuts(len(leaves), dims, cuts, rank,
                                        world)):
        shape = whole_shape(tuple(t.shape), chain)
        starts, _ = composite_box(shape, chain)
        manifest[key] = {"dtype": _dtype_name(t), "shape": list(shape)}
        writes = all(index == 0 for dim, parts, index in chain
                     if dim < 0 or parts <= 1)
        shards[key] = ([{"start": starts, "shape": list(t.shape),
                         "data": _to_bytes(t)}] if writes else [])
    (path / f"shard-{rank}.msgpack").write_bytes(msgpack.packb(shards))
    if rank == 0:
        (path / _MANIFEST).write_bytes(msgpack.packb(manifest))


def restore_sharded(path, target, dims: Any = None, *,
                    rank: Optional[int] = None, world: Optional[int] = None,
                    device=None, cuts: Optional[list] = None):
    """Assemble a checkpoint directory onto ``target``'s structure
    (``target``'s leaves give the GLOBAL shapes to check).  With ``cuts``
    or ``dims`` (as in :func:`save_sharded`), each leaf comes back as
    this rank's piece, else whole."""
    import msgpack
    path = Path(path)
    manifest = msgpack.unpackb((path / _MANIFEST).read_bytes())
    merged: dict = {}
    for f in sorted(path.glob("shard-*.msgpack")):
        for key, recs in msgpack.unpackb(f.read_bytes()).items():
            merged.setdefault(key, []).extend(recs)
    leaves = tree_leaves(target)
    chains = [()] * len(leaves)
    if dims is not None or cuts is not None:
        rank, world = _rank_world(rank, world)
        chains = _leaf_cuts(len(leaves), dims, cuts, rank, world)
    out = []
    for key, leaf, chain in zip(_key_paths(target), leaves, chains):
        meta = manifest[key]
        if tuple(meta["shape"]) != tuple(np.shape(leaf)):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(meta['shape'])} vs "
                             f"{tuple(np.shape(leaf))}")
        full = torch.zeros(meta["shape"], dtype=_DTYPES[meta["dtype"]])
        for rec in merged.get(key, ()):
            sl = tuple(slice(st, st + sz)
                       for st, sz in zip(rec["start"], rec["shape"]))
            full[sl] = _from_bytes(rec["data"], meta["dtype"], rec["shape"])
        if chain:
            full = cut_piece(full, chain).clone()
        out.append(full.to(device) if device is not None else full)
    return tree_unflatten(target, out)


def restore_any(path, target, dims: Any = None, **kw):
    """Dispatch on the checkpoint's format: a directory restores the
    sharded layout (whole leaves, or with ``cuts`` or ``dims`` this rank's
    pieces), a single file the legacy one (whole leaves)."""
    path = Path(path)
    if path.is_dir():
        return restore_sharded(path, target, dims, **kw)
    return restore(path, target, device=kw.get("device"))
