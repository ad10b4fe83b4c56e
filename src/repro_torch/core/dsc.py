"""Distributed Shifted Compression (``repro/core/dsc.py``, Section 3.2.2).

Client side:    v_k = C_k(g_k - s_k);          s_k <- s_k + gamma * v_k
Aggregator a:   v_(a) = s_(a) + mean_k v_{k,(a)};
                s_(a) <- s_(a) + gamma * mean_k v_{k,(a)}         (Eq. 4)

The aggregator references live on disjoint coordinate shards, stored as
one coordinate-partitioned vector ``s_agg`` of shape (n,).  The client
side runs in the wire kernels (``core/pipeline.DSCCompress``).
"""
from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Union

import torch

from repro_torch.core.fsa import weighted_sum


class DSCState(NamedTuple):
    s_clients: torch.Tensor   # (K, n) client reference vectors s_k
    s_agg: torch.Tensor       # (n,)   aggregator references


def init_state(K: int, n: int, dtype=torch.float32,
               device=None) -> DSCState:
    return DSCState(torch.zeros((K, n), dtype=dtype, device=device),
                    torch.zeros((n,), dtype=dtype, device=device))


def gamma_star(omega: float) -> float:
    """The shift stepsize of Theorem 3.2:
    gamma = sqrt((1 + 2w) / (2 (1 + w)^3))."""
    return float(((1.0 + 2.0 * omega) / (2.0 * (1.0 + omega) ** 3)) ** 0.5)


def aggregate(state: DSCState,
              v: Union[torch.Tensor, Iterable[torch.Tensor]], gamma: float,
              K: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Aggregator-side shift compensation (Eq. 4), coordinate-wise over
    the partitioned s_agg, with the clients' mean.  ``v`` is the (K, n)
    stack or, streamed, an iterable of the K client vectors (then pass
    K).  Returns (v_global, s_agg_new); s_agg is updated IN PLACE (the
    returned tensor is ``state.s_agg``), so the round holds no second
    copy of it."""
    mean_v = weighted_sum(v, K=K)
    v_global = state.s_agg + mean_v
    s_agg = state.s_agg.add_(mean_v, alpha=gamma)
    return v_global, s_agg
