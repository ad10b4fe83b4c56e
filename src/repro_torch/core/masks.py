"""FSA shard masks (``repro/core/masks.py``, Section 3.2.1).

A mask set {m_(a)}_{a=1..A} over R^n must be disjoint and complete.  It
is stored as one integer assignment vector ``assign`` (n,) with values in
[0, A): coordinate i belongs to aggregator assign[i] (the reference's
``contiguous`` scheme wraps past 2**31 / A into negative values, which
belong to no aggregator: :func:`assignment_window`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import random


def make_assignment(n: int, A: int, scheme: str = "strided",
                    key: Optional[torch.Tensor] = None,
                    device=None) -> torch.Tensor:
    """The shard assignment of n coordinates over A aggregators.

    ``strided`` is round robin (i mod A); ``contiguous`` gives A
    contiguous blocks, with the reference's int32 arithmetic (see
    :func:`assignment_window`); ``random`` is a permutation of the
    strided assignment drawn with ``key`` (fresh masks a round when the
    key is the round's, the paper's m^t)."""
    if scheme != "random":
        return assignment_window(n, A, scheme, 0, n, device)
    strided = assignment_window(n, A, "strided", 0, n, device)
    if key is None:
        raise ValueError("random scheme needs a PRNG key")
    return random.permutation(key, strided)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as an int32 product overflows."""
    return (x + 2**31) % 2**32 - 2**31


def assignment_window(n: int, A: int, scheme: str, lo: int, hi: int,
                      device=None) -> torch.Tensor:
    """Coordinates [lo, hi) of the ``strided`` or ``contiguous``
    assignment of n coordinates (int32), built without an n-sized
    temporary.

    ``contiguous`` is the reference's ``min(i * A // n, A - 1)`` with i
    int32: the product wraps once i * A >= 2**31, and ``//`` floors, so
    past the wrap a coordinate gets a negative aggregator (at n =
    1,816,565,760 and A = 8, coordinate 2**28 gets -2).  A negative
    assignment belongs to no aggregator: the masks leave the coordinate
    out, as the reference's one-hot masks do."""
    if A < 1:
        raise ValueError("need A >= 1 aggregators")
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"window [{lo}, {hi}) outside {n} coordinates")
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    if scheme == "strided":
        return (idx % A).int()
    if scheme == "contiguous":
        prod = wrap_int32(idx * A)
        return torch.clamp(torch.div(prod, max(n, 1), rounding_mode="floor"),
                           max=A - 1).int()
    raise ValueError(f"unknown scheme {scheme!r}")


def mask_for(assign: torch.Tensor, a: int) -> torch.Tensor:
    """Binary mask m_(a) for aggregator a (float32, shape (n,))."""
    return (assign == a).float()


def union_mask(assign: torch.Tensor, coalition: Sequence[int]
               ) -> torch.Tensor:
    """A colluding coalition's view mask (Cor. D.2): the union of its
    members' masks."""
    members = torch.as_tensor(coalition, dtype=assign.dtype,
                              device=assign.device)
    return (assign[None, :] == members[:, None]).any(0).float()


def masks_stacked(assign: torch.Tensor, A: int) -> torch.Tensor:
    """All masks as an (A, n) stack (small-n simulator/testing only)."""
    return (assign[None, :] == torch.arange(A, device=assign.device)[:, None]
            ).float()


def check_disjoint_complete(assign: torch.Tensor, A: int) -> bool:
    m = masks_stacked(assign, A)
    overlap = (m[:, None] * m[None]).sum(-1) * (1 - torch.eye(A))
    return bool((overlap == 0).all()) and bool((m.sum(0) == 1).all())


def shard_sizes(assign: torch.Tensor, A: int) -> torch.Tensor:
    """Coordinates per aggregator (the largest shard drives worst-case
    leakage, Sec. 5 'Limitations')."""
    return torch.bincount(assign.long(), minlength=A)


def make_weighted_assignment(n: int, weights: Sequence[float],
                             key: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Heterogeneous shards (Sec. 5 'Limitations'): aggregator a takes a
    fraction weights[a] of the coordinates, in contiguous runs, permuted
    with ``key`` when one is given."""
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    bounds = np.floor(np.cumsum(w) * n + 0.5).astype(np.int32)
    assign = np.zeros(n, dtype=np.int32)
    start = 0
    for a, b in enumerate(bounds):
        assign[start:b] = a
        start = b
    out = torch.from_numpy(assign)
    return random.permutation(key, out) if key is not None else out
