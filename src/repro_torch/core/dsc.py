"""Distributed Shifted Compression (``repro/core/dsc.py``, Section 3.2.2).

Client side:    v_k = C_k(g_k - s_k);          s_k <- s_k + gamma * v_k
Aggregator a:   v_(a) = s_(a) + mean_k v_{k,(a)};
                s_(a) <- s_(a) + gamma * mean_k v_{k,(a)}         (Eq. 4)

The aggregator references live on disjoint coordinate shards, stored as
one coordinate-partitioned vector ``s_agg`` of shape (n,).

The client side here is the reference's dense ``client_compress``: the
compressor's own draws from the threefry stream.  It rounds as the
reference's jitted round does on the CPU: ``s + gamma * v`` is one fused
multiply-add there, and so it is here (``kernels/ref.fma_f32``).
:func:`compress_client` streams one client and updates its shift in
place; for RandP, alone or inside the int8 round trip, it goes
``random.CHUNK`` coordinates at a time, so at n = 1.8e9 it adds no
n-sized vector beyond v.  The wire kernels' paths (``impl='pallas'`` and
``'fused'``) are in ``core/pipeline.DSCCompress``.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Union

import torch

from repro_torch import random
from repro_torch.core.compressors import (Compressor, Int8RoundTrip, RandP,
                                          reciprocal)
from repro_torch.core.fsa import weighted_sum
from repro_torch.kernels import quantize as q_kernel
from repro_torch.kernels.ref import fma_f32


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


def fma_shift(gamma: float, v: torch.Tensor, s: torch.Tensor
              ) -> torch.Tensor:
    """``s + gamma * v`` in s's shape and dtype, as XLA compiles it in the
    reference's jitted step.  With an f32 v, one FMA in f32
    (``fma_f32``, taken :data:`random.CHUNK` coordinates at a time so that
    its double temporaries stay small at any leaf size), rounded to s's
    dtype.  With v and s both 16-bit, gamma is rounded to their dtype
    first (JAX's weakly typed scalar); then bf16 rounds the product and
    the sum each, f16 rounds once after both in f32 (XLA's CPU compiler
    widens the two types differently)."""
    if v.dtype != torch.float32:
        g16 = torch.tensor(gamma, dtype=s.dtype)
        if s.dtype == torch.bfloat16:
            return s + g16 * v
        return (s.float() + float(g16) * v.float()).to(s.dtype)
    out = torch.empty_like(s)
    flat_out, flat_v, flat_s = out.view(-1), v.reshape(-1), s.reshape(-1)
    for lo in range(0, s.numel(), random.CHUNK):
        hi = min(s.numel(), lo + random.CHUNK)
        flat_out[lo:hi] = fma_f32(gamma, flat_v[lo:hi].float(),
                                  flat_s[lo:hi].float())
    return out


def compress_client(s: torch.Tensor, g: torch.Tensor,
                    compressor: Compressor, gamma: float, key: torch.Tensor,
                    *, offset: int = 0, n: Optional[int] = None
                    ) -> torch.Tensor:
    """One client's shifted compression, v = C(g - s) with the client's
    key; s <- s + gamma v IN PLACE.  g: (m,) any float dtype; s: (m,)
    f32.  Returns v (f32).  For RandP (alone or in the int8 round trip) g
    and s may be the window [offset, offset + m) of vectors of length n,
    which draws what the whole vector's compression draws there (offset
    a multiple of the int8 block)."""
    comp = compressor
    inner = comp.inner if isinstance(comp, Int8RoundTrip) else comp
    m = g.numel()
    n = m if n is None else n
    if not isinstance(inner, RandP):
        if (offset, n) != (0, m):
            raise ValueError(f"{comp.name} compresses whole vectors only")
        v = comp(key, g.float() - s)
        s.copy_(fma_f32(gamma, v, s))
        return v
    int8 = inner is not comp
    if int8:
        if offset % q_kernel.QBLOCK:
            raise ValueError(f"offset {offset} splits an int8 block")
        key, k_q = random.split(key)
        seed = int(random.bits(k_q))
    v = torch.empty(m, dtype=torch.float32, device=g.device)
    scale = reciprocal(inner.p)
    # CHUNK is a multiple of the int8 block, so no block straddles chunks
    for lo in range(0, m, random.CHUNK):
        hi = min(m, lo + random.CHUNK)
        keep = random.bernoulli(key, inner.p, (n,), device=g.device,
                                window=(offset + lo, offset + hi))
        vc = torch.where(keep, (g[lo:hi].float() - s[lo:hi]) * scale, 0.0)
        if int8:
            q, scales = q_kernel.quantize(vc, seed, index_base=offset + lo)
            vc = q_kernel.dequantize(q, scales)[:hi - lo]
        v[lo:hi] = vc
        s[lo:hi] = fma_f32(gamma, vc, s[lo:hi])
    return v


def client_compress(state: DSCState, grads: torch.Tensor,
                    compressor: Compressor, gamma: float,
                    key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All clients, as the reference: grads (K, n); client k compresses
    with ``split(key, K)[k]``.  Returns (v (K, n), s_clients), the shifts
    updated IN PLACE (the returned tensor is ``state.s_clients``)."""
    K = grads.shape[0]
    keys = random.split(key, K)
    v = torch.stack([compress_client(state.s_clients[k], grads[k],
                                     compressor, gamma, keys[k])
                     for k in range(K)])
    return v, state.s_clients


def aggregate(state: DSCState,
              v: Union[torch.Tensor, Iterable[torch.Tensor]], gamma: float,
              K: Optional[int] = None,
              weights: Optional[torch.Tensor] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Aggregator-side shift compensation (Eq. 4), coordinate-wise over
    the partitioned s_agg, with the clients' (weighted) mean.  ``v`` is
    the (K, n) stack or, streamed, an iterable of the K client vectors
    (then pass K).  Returns (v_global, s_agg_new); s_agg is updated IN
    PLACE (the returned tensor is ``state.s_agg``), so the round holds no
    second copy of it."""
    mean_v = weighted_sum(v, weights, K=K)
    v_global = state.s_agg + mean_v
    s_agg = state.s_agg.add_(mean_v, alpha=gamma)
    return v_global, s_agg
