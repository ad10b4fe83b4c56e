"""FSA shard masks (``repro/core/masks.py``, Section 3.2.1).

A mask set {m_(a)}_{a=1..A} over R^n must be disjoint and complete.  It
is stored as one integer assignment vector ``assign`` (n,) with values in
[0, A): coordinate i belongs to aggregator assign[i].
"""
from __future__ import annotations

import torch


def make_assignment(n: int, A: int, scheme: str = "strided",
                    device=None) -> torch.Tensor:
    """The shard assignment of n coordinates over A aggregators.

    ``strided`` is round robin (i mod A); ``contiguous`` gives A
    contiguous blocks.  ``random`` permutes the strided assignment with
    ``jax.random``, which the port cannot reproduce until its threefry
    stream exists (ROADMAP queue 1.2): it raises."""
    if A < 1:
        raise ValueError("need A >= 1 aggregators")
    idx = torch.arange(n, dtype=torch.int32, device=device)
    if scheme == "strided":
        return idx % A
    if scheme == "contiguous":
        return torch.clamp(idx.long() * A // max(n, 1), max=A - 1).int()
    if scheme == "random":
        raise NotImplementedError(
            "mask scheme 'random' draws a jax.random permutation; the port "
            "has no threefry key stream yet (ROADMAP queue 1.2)")
    raise ValueError(f"unknown scheme {scheme!r}")


def mask_for(assign: torch.Tensor, a: int) -> torch.Tensor:
    """Binary mask m_(a) for aggregator a (float32, shape (n,))."""
    return (assign == a).float()


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
