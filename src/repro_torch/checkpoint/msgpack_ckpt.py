"""msgpack checkpoints of trees of tensors, single-file and sharded, in
the reference's byte format (``repro/checkpoint/msgpack_ckpt.py``), so
either package reads what the other wrote.

Single-file (:func:`save` / :func:`restore`): dtype name, shape and raw
C-order bytes per leaf, keyed by the leaf's path joined with "/".

Sharded (:func:`save_sharded` / :func:`restore_sharded`): a DIRECTORY of

    manifest.msgpack        global dtype/shape per leaf (rank 0)
    shard-{rank}.msgpack    this rank's pieces, each as (start offsets,
                            shape, bytes)

The distributed step keeps each leaf as this rank's store shard (cut at
its scatter dim, ``dist/sharding.store_shard``), so a rank writes its
own piece, and a replicated leaf (scatter dim -1) is written once, by
rank 0, as the reference's replica 0 is.  :func:`restore_sharded`
assembles every leaf whole, and with ``dims`` cuts this rank's store
shard from it.

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
from repro_torch.dist.sharding import store_shard

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


def save_sharded(path, tree, dims: Any = None, *, rank: Optional[int] = None,
                 world: Optional[int] = None) -> None:
    """Write this rank's pieces of ``tree`` into the checkpoint directory
    ``path`` (see the module docstring).  ``dims`` (a tree of ints, as
    ``dist/sharding.fsa_scatter_dims``) says at which dim each leaf is cut
    into ``world`` store shards, of which ``tree`` holds the ``rank``-th;
    -1, or no ``dims``, means the leaf is whole and replicated.  ``rank``
    and ``world`` default to the process group's (0 and 1 without one).
    """
    import msgpack
    rank, world = _rank_world(rank, world)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(tree)
    dim_list = ([-1] * len(leaves) if dims is None else tree_leaves(dims))
    manifest, shards = {}, {}
    for key, t, dim in zip(_key_paths(tree), leaves, dim_list):
        shape = list(t.shape)
        starts = [0] * t.dim()
        if dim >= 0:
            starts[dim] = rank * shape[dim]
            shape[dim] *= world
        manifest[key] = {"dtype": _dtype_name(t), "shape": shape}
        writes = dim >= 0 or rank == 0
        shards[key] = ([{"start": starts, "shape": list(t.shape),
                         "data": _to_bytes(t)}] if writes else [])
    (path / f"shard-{rank}.msgpack").write_bytes(msgpack.packb(shards))
    if rank == 0:
        (path / _MANIFEST).write_bytes(msgpack.packb(manifest))


def restore_sharded(path, target, dims: Any = None, *,
                    rank: Optional[int] = None, world: Optional[int] = None,
                    device=None):
    """Assemble a checkpoint directory onto ``target``'s structure
    (``target``'s leaves give the GLOBAL shapes to check).  With ``dims``,
    each leaf comes back as this rank's store shard (``rank`` and
    ``world`` as in :func:`save_sharded`), else whole."""
    import msgpack
    path = Path(path)
    manifest = msgpack.unpackb((path / _MANIFEST).read_bytes())
    merged: dict = {}
    for f in sorted(path.glob("shard-*.msgpack")):
        for key, recs in msgpack.unpackb(f.read_bytes()).items():
            merged.setdefault(key, []).extend(recs)
    leaves = tree_leaves(target)
    dim_list = ([-1] * len(leaves) if dims is None else tree_leaves(dims))
    if dims is not None:
        rank, world = _rank_world(rank, world)
    out = []
    for key, leaf, dim in zip(_key_paths(target), leaves, dim_list):
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
        if dim >= 0:
            full = store_shard(full, dim, world, rank).clone()
        out.append(full.to(device) if device is not None else full)
    return tree_unflatten(target, out)


def restore_any(path, target, dims: Any = None, **kw):
    """Dispatch on the checkpoint's format: a directory restores the
    sharded layout, a single file the legacy one (whole leaves)."""
    path = Path(path)
    if path.is_dir():
        return restore_sharded(path, target, dims, **kw)
    return restore(path, target, device=kw.get("device"))
