"""Federated Shard Aggregation (``repro/core/fsa.py``, Section 3.2.1).

* ``fsa_round_sharded`` is the literal protocol: per-aggregator masked
  shards are built, aggregated independently and reassembled.  It is
  what an honest-but-curious aggregator sees.
* ``fsa_round`` is the algebraic form: with disjoint, complete masks the
  reassembled model IS the centralized FedAvg update (Theorem B.1).

Both take the weighted client sum through :func:`weighted_sum`, in the
same order, so in the port they agree bit for bit.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core import masks as masks_lib
from repro_torch.core.compressors import scale_by_reciprocal

Updates = Union[torch.Tensor, Iterable[torch.Tensor]]


class FSAOutput(NamedTuple):
    x_new: torch.Tensor                  # reassembled global model (n,)
    shard_views: Optional[torch.Tensor]  # (A, K, n) what each aggregator saw


def client_weights(K: int, weights: Optional[torch.Tensor] = None
                   ) -> List[float]:
    """Normalized per-client weights as f32 values: 1/K each, or
    weights / sum(weights), as the reference's f32 arrays hold them."""
    if weights is None:
        return [float(np.float32(1.0 / K))] * K
    w = weights.detach().float().cpu()
    return [float(x) for x in (w / w.sum())]


def weighted_sum(updates: Updates, weights: Optional[torch.Tensor] = None,
                 K: Optional[int] = None) -> torch.Tensor:
    """sum_k w_k v_k in f32, taken one client at a time so that the
    clients' vectors never have to exist together: ``updates`` is a
    (K, n) tensor or an iterable of K vectors (then pass K).  The
    reference's ``einsum("k,kn->n")`` may sum in another order, so the
    two agree to rounding, not bit for bit."""
    if isinstance(updates, torch.Tensor):
        K = updates.shape[0]
    if K is None:
        raise ValueError("weighted_sum over an iterable needs K")
    w = client_weights(K, weights)
    acc = None
    count = 0
    # no enumerate: it would hold each vector while the next is made
    for v in updates:
        if acc is None:
            acc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        acc.add_(v, alpha=w[count])
        count += 1
        del v
    if count != K:
        raise ValueError(f"weighted_sum: expected {K} client vectors, got "
                         f"{count}")
    return acc


def mean_rows(rows: Updates) -> torch.Tensor:
    """``rows.mean(0)`` as XLA's CPU compiler computes it: the rows summed
    in order, then multiplied by the f32 reciprocal of their count (a
    division for a power of two only: at 3 rows, XLA's product differs
    from the quotient in a third of the coordinates).  ``rows`` is a
    (K, n) tensor or an iterable of K vectors."""
    acc, count = None, 0
    for r in rows:
        if acc is None:
            acc = r.clone()
        else:
            acc += r
        count += 1
        del r       # dropped before the next row is made
    return scale_by_reciprocal(acc, count)


def shard_update(v: torch.Tensor, assign: torch.Tensor, A: int
                 ) -> torch.Tensor:
    """Partition one client update into A masked shards -> (A, n)."""
    return masks_lib.masks_stacked(assign, A) * v[None, :]


def reassemble(x_shards: torch.Tensor, assign: torch.Tensor, A: int
               ) -> torch.Tensor:
    """x^{t+1} = sum_a m_(a) * x_(a)^{t+1}  (Algorithm 1 line 14)."""
    return (masks_lib.masks_stacked(assign, A) * x_shards).sum(0)


def fsa_round_sharded(x: torch.Tensor, client_updates: torch.Tensor,
                      assign: torch.Tensor, A: int, lr: float,
                      weights: Optional[torch.Tensor] = None,
                      keep_views: bool = True) -> FSAOutput:
    """Literal Algorithm 1 (no DSC): shard, aggregate per aggregator,
    update each model segment, reassemble.  client_updates: (K, n)."""
    shards = torch.stack([shard_update(v, assign, A)
                          for v in client_updates])          # (K, A, n)
    views = shards.transpose(0, 1)                           # (A, K, n)
    # aggregator a: v_(a) = sum_k w_k v_{k,(a)}   (Eq. 2, weighted form)
    v_a = torch.stack([weighted_sum(views[a], weights) for a in range(A)])
    m = masks_lib.masks_stacked(assign, A)
    x_a = m * x[None, :] - lr * v_a
    return FSAOutput(reassemble(x_a, assign, A),
                     views.contiguous() if keep_views else None)


def fsa_round(x: torch.Tensor, client_updates: Updates, lr: float,
              weights: Optional[torch.Tensor] = None,
              K: Optional[int] = None) -> torch.Tensor:
    """Algebraic form (Theorem B.1): identical iterates to FedAvg."""
    return x - lr * weighted_sum(client_updates, weights, K)


def fsa_round_with_failures(x: torch.Tensor, client_updates: torch.Tensor,
                            assign: torch.Tensor, A: int, lr: float,
                            agg_alive: torch.Tensor,
                            link_alive: torch.Tensor,
                            keep_views: bool = False):
    """Failure-injected round (Appendix F.5), the (A, K, n) form.

    agg_alive: (A,) bool -- a dropped aggregator leaves its model shard at
    x_(a)^t for the round.  link_alive: (K, A) bool -- a failed
    client->aggregator link drops that client's shard; the aggregator
    renormalizes over the shards it received.

    Returns x_new, or with ``keep_views`` an :class:`FSAOutput` whose
    views are what the aggregators received (zero where the link failed
    or the aggregator was down).  The streamed round computes the same
    sum one client at a time (``pipeline.FailureInjectedFSA``)."""
    m = masks_lib.masks_stacked(assign, A)                   # (A, n)
    shards = m[:, None, :] * client_updates[None]            # (A, K, n)
    w = link_alive.T.float().to(x.device)                    # (A, K)
    coef = w / torch.clamp(w.sum(1, keepdim=True), min=1.0)
    v_a = torch.einsum("ak,akn->an", coef, shards)
    v_a = v_a * agg_alive[:, None].float().to(x.device)
    x_a = m * x[None, :] - lr * v_a
    x_new = reassemble(x_a, assign, A)
    if not keep_views:
        return x_new
    views = (shards * w[:, :, None]
             * agg_alive[:, None, None].float().to(x.device))
    return FSAOutput(x_new, views)

