"""Pairwise-masking secure aggregation baseline (``repro/core/
secure_agg.py``; Bonawitz et al. 2017, simplified: no dropout recovery).

Each unordered client pair {i, j} (i < j) shares a PRG seed; client i
adds PRG(seed_ij), client j subtracts it.  Masks cancel exactly in the
full-cohort sum, so the aggregate equals FedAvg while each masked update
hides the client's data, at the cost of O(K^2) mask draws a round and
total failure on dropout (no recovery round).  A weighted or partial sum
does not cancel, so callers refuse it (``pipeline.SecureAggAggregate``,
``rounds.scenarios``).

Masks are fixed point: integer multiples of a per-(K, scale) quantum
chosen so every f32 partial sum is exact, so cancellation is exactly 0
in any summation order.  The draws are the reference's
(``random.randint`` from the same fold_in keys), bit for bit; a
``window`` of coordinates draws what the whole row draws there.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch import random
from repro_torch.core.fsa import mean_rows

PAIR_SALT = 131071       # the pair's seed: fold_in(fold_in(key, lo * salt), hi)


def _grid(scale: float, K: int) -> tuple[float, int]:
    """Fixed-point quantum ``q`` and level count ``L`` (draws lie on
    q * [-L, L)).  q is the power of two making the worst-case partial
    sum over all K(K-1) signed pair masks fit in f32's 2^24 exact-integer
    range, so additions never round and cancellation is exact."""
    budget = 2.0 ** 24
    q = 2.0 ** math.ceil(math.log2(max(K * K * scale / budget, 2.0 ** -16)))
    L = max(1, int(scale / q))
    return q, L


def pairwise_mask_row(key: torch.Tensor, i: int, K: int, n: int,
                      scale: float = 100.0, *, device=None,
                      window: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """Client ``i``'s mask: sum over partners j of sign(j - i) * m_ij,
    m_ij drawn from a seed keyed on the unordered pair (min, max), so
    rows i and j derive the identical pair mask and the signs cancel.
    f32, the row's coordinates [lo, hi) with a ``window``."""
    q, L = _grid(scale, K)
    lo, hi = (0, n) if window is None else window
    out = torch.zeros(hi - lo, dtype=torch.float32, device=device)
    for j in range(K):
        if j == i:
            continue
        pair = random.fold_in(random.fold_in(key, min(i, j) * PAIR_SALT),
                              max(i, j))
        m = q * random.randint(pair, (n,), -L, L, device=device,
                               window=(lo, hi)).float()
        out += m if j > i else -m
    return out


def pairwise_masks(key: torch.Tensor, K: int, n: int,
                   scale: float = 100.0, device=None) -> torch.Tensor:
    """(K, n) masks that sum to exactly zero across clients."""
    return torch.stack([pairwise_mask_row(key, i, K, n, scale, device=device)
                        for i in range(K)])


def mask_row_update(key: torch.Tensor, v: torch.Tensor, i: int, K: int,
                    scale: float = 100.0) -> torch.Tensor:
    """Client i's masked update v + mask_i, :data:`random.CHUNK`
    coordinates at a time (a new f32 vector)."""
    n = v.numel()
    out = torch.empty(n, dtype=torch.float32, device=v.device)
    for lo in range(0, n, random.CHUNK):
        hi = min(n, lo + random.CHUNK)
        out[lo:hi] = v[lo:hi] + pairwise_mask_row(
            key, i, K, n, scale, device=v.device, window=(lo, hi))
    return out


def mask_updates(key: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """Masked per-client updates; their unweighted full-cohort mean
    equals the unmasked mean.  Weighted/partial means do not cancel."""
    K = updates.shape[0]
    return torch.stack([mask_row_update(key, updates[i], i, K)
                        for i in range(K)])


def secure_agg_round(key, x, grads, lr):
    """FedAvg via masked updates: the aggregators see only masked vectors
    (the adversary view), the model update is exact."""
    masked = mask_updates(key, grads)
    return x - lr * mean_rows(masked), masked
