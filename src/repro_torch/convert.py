"""Carry a JAX parameter tree into the port, and flatten a tree into the
paper's R^n vector as the reference's simulator does.

The reference's params are a nested dict of arrays with every per-layer
weight stacked on a leading L axis; the port keeps that layout, so the
conversion is a leaf-for-leaf copy.  The caller hands over the tree as
numpy (``jax.tree.map(np.asarray, params)``): the port never imports jax.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


def _leaf(x, device: torch.device) -> torch.Tensor:
    a = np.array(x, order="C")      # a writable copy: jax hands out views
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX hands over ml_dtypes'):
        # carry the 16-bit patterns and reinterpret them on the torch side
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree, device: DeviceLike = None) -> dict:
    """The port's params from the reference's param tree, given as numpy
    arrays (nested dicts of leaves).  Dtypes are kept: f32 stays f32 and
    bf16 stays bf16, bit for bit."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf(node, device)

    return walk(tree)


# ============================================================ flat vectors
def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.flatten_util.ravel_pytree`` order: dict keys
    sorted, depth first; tuples and lists in order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_unflatten(tree, leaves: Iterable[torch.Tensor]):
    """A tree of ``tree``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    return _unflatten(tree, iter(leaves))


def tree_map(fn: Callable, tree, *rest):
    """``jax.tree.map``: ``fn`` of the leaves at each place of ``tree``
    and of the trees in ``rest`` (same structure), in a tree of
    ``tree``'s structure."""
    columns = [tree_leaves(t) for t in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in
                                 zip(tree_leaves(tree), *columns)])


def _unflatten(node, it: Iterator[torch.Tensor]):
    # a plain recursive function: a nested one that calls itself sits in
    # a reference cycle with its closure, and the cycle would keep the
    # leaves (gigabytes of parameters) alive until the next GC pass
    if isinstance(node, dict):
        return {key: _unflatten(node[key], it) for key in sorted(node)}
    if isinstance(node, (tuple, list)):
        children = [_unflatten(child, it) for child in node]
        return (type(node)(*children) if hasattr(node, "_fields")
                else type(node)(children))
    return next(it)


def ravel_params(tree) -> Tuple[torch.Tensor, Callable]:
    """The tree as one flat vector, and the function that rebuilds it
    (``jax.flatten_util.ravel_pytree``).  The vector's dtype is the
    promotion of the leaves' (bf16 leaves give a bf16 vector).
    ``unravel(x)`` slices x in the same order and casts each leaf back to
    its own dtype, as JAX's unravel does; a leaf whose dtype is x's is a
    view of x."""
    leaves = tree_leaves(tree)
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in leaves))
    sizes = [t.numel() for t in leaves]
    flat = torch.empty(sum(sizes), dtype=dtype, device=leaves[0].device)
    offset = 0
    for t, size in zip(leaves, sizes):
        flat[offset:offset + size].copy_(t.reshape(-1))   # casts on copy
        offset += size
    specs = [(t.shape, t.dtype, size) for t, size in zip(leaves, sizes)]
    n = flat.numel()
    # the structure alone: unravel must not keep the tree's tensors alive
    skeleton = tree_unflatten(tree, [None] * len(leaves))

    def unravel(x: torch.Tensor):
        if x.shape != (n,):
            raise ValueError(f"unravel: want a vector of {n}, got "
                             f"{tuple(x.shape)}")
        out, offset = [], 0
        for shape, leaf_dtype, size in specs:
            out.append(x[offset:offset + size].view(shape).to(leaf_dtype))
            offset += size
        return tree_unflatten(skeleton, out)

    return flat, unravel
