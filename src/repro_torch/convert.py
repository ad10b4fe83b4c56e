"""Carry a JAX parameter tree into the port.

The reference's params are a nested dict of arrays with every per-layer
weight stacked on a leading L axis; the port keeps that layout, so the
conversion is a leaf-for-leaf copy.  The caller hands over the tree as
numpy (``jax.tree.map(np.asarray, params)``): the port never imports jax.
"""
from __future__ import annotations

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
