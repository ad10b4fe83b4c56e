"""Baseline FL methods the paper compares against (``repro/core/
baselines.py``, Section 4.1).

All baselines share the ERIS engine's conventions: flat model vector x,
client gradients (K, n), one update per round.

* FedAvg           -- McMahan et al. 2017 (no defense, no compression)
* FedAvgLDP        -- per-client clipping + Gaussian noise (LDP-FL style)
* SoteriaFL        -- centralized shifted compression + LDP noise (Li et
                      al. 2022); == ERIS DSC with A=1 plus DP perturbation
* PriPrune         -- withhold the top-|g| fraction of coordinates
* ShatterLite      -- chunked partial exchange over random r-subsets
* MinLeakage       -- FedAvg iterates; the adversary sees only the final
                      model

The (K, n) functions are the reference's; beside each, the one-client
form the streamed round runs (:func:`ldp_perturb_client`,
:func:`prune_client`, :func:`shatter_members` with
:func:`shatter_chunk_window`), which computes client k's row (or a
window of coordinates) with no (K, n) or n-sized int64 temporary, so a
round of eris-gptneo-1.3b (n = 1.8e9) fits one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch import random
from repro_torch.core import dsc as dsc_lib
from repro_torch.core.compressors import Compressor
from repro_torch.core.fsa import weighted_sum
from repro_torch.core.masks import wrap_int32


def gaussian_sigma(eps: float, delta: float, clip: float) -> float:
    """Classic Gaussian-mechanism calibration sigma = C sqrt(2 ln(1.25/d))
    / eps."""
    return clip * math.sqrt(2.0 * math.log(1.25 / delta)) / eps


def vector_norm(g: torch.Tensor) -> torch.Tensor:
    """The L2 norm of a vector as a 0-d tensor of g's dtype, summed in
    double :data:`random.CHUNK` coordinates at a time (XLA sums in f32 in
    its own order: the two agree to a few ulps)."""
    flat = g.reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=g.device)
    for lo in range(0, flat.numel(), random.CHUNK):
        c = flat[lo:lo + random.CHUNK].double()
        total += (c * c).sum()
    return total.sqrt().to(g.dtype)


def clip_factor(g: torch.Tensor, clip: float) -> torch.Tensor:
    """``minimum(1, clip / maximum(norm(g), 1e-12))`` in g's dtype."""
    nrm = vector_norm(g)
    return torch.clamp(clip / torch.clamp(nrm, min=1e-12), max=1.0)


def clip_by_norm(g: torch.Tensor, clip: float) -> torch.Tensor:
    return g * clip_factor(g, clip)


# ---------------------------------------------------------------- FedAvg
def fedavg_round(x, grads, lr, weights=None):
    return x - lr * weighted_sum(grads, weights)


# ----------------------------------------------------------- FedAvg-LDP
@dataclasses.dataclass(frozen=True)
class LDPConfig:
    eps: float = 10.0
    delta: float = 1e-5
    clip: float = 1.0


def ldp_perturb_client(key: torch.Tensor, g: torch.Tensor, cfg: LDPConfig,
                       k: int, K: int) -> torch.Tensor:
    """Client k's row of :func:`ldp_perturb`: g clipped to L2 ``clip``
    plus ``sigma * normal(key, (K, n))[k]``, the flat window [k n,
    (k + 1) n) of the draw, taken :data:`random.CHUNK` coordinates at a
    time.  f32 out, as the reference's f32 noise promotes it."""
    n = g.numel()
    sigma = gaussian_sigma(cfg.eps, cfg.delta, cfg.clip)
    factor = clip_factor(g, cfg.clip)
    flat = g.reshape(-1)
    out = torch.empty(n, dtype=torch.float32, device=g.device)
    for lo in range(0, n, random.CHUNK):
        hi = min(n, lo + random.CHUNK)
        noise = random.normal(key, (K, n), device=g.device,
                              window=(k * n + lo, k * n + hi))
        out[lo:hi] = (flat[lo:hi] * factor).float() + sigma * noise
    return out


def ldp_perturb(key, grads: torch.Tensor, cfg: LDPConfig) -> torch.Tensor:
    K = grads.shape[0]
    return torch.stack([ldp_perturb_client(key, grads[k], cfg, k, K)
                        for k in range(K)])


def fedavg_ldp_round(key, x, grads, lr, cfg: LDPConfig):
    return fedavg_round(x, ldp_perturb(key, grads, cfg), lr)


# ------------------------------------------------------------ SoteriaFL
class SoteriaState(NamedTuple):
    dsc: dsc_lib.DSCState


def soteriafl_round(key, x, grads, lr, state: SoteriaState,
                    compressor: Compressor, gamma: float,
                    ldp: Optional[LDPConfig] = None):
    """Centralized shifted compression (+ optional LDP noise
    pre-compression).  The shifts are updated in place."""
    k_noise, k_comp = random.split(key)
    if ldp is not None:
        grads = ldp_perturb(k_noise, grads, ldp)
    v, s_clients = dsc_lib.client_compress(state.dsc, grads, compressor,
                                           gamma, k_comp)
    v_global, s_agg = dsc_lib.aggregate(state.dsc, v, gamma)
    return x - lr * v_global, SoteriaState(dsc_lib.DSCState(s_clients,
                                                            s_agg))


# ------------------------------------------------------------- PriPrune
def _sortable(a: torch.Tensor) -> torch.Tensor:
    """Non-negative floats as int64 keys in the same order: their bit
    patterns (f32 through int32, 16-bit floats through int16)."""
    view = torch.int32 if a.element_size() == 4 else torch.int16
    return a.contiguous().view(view).long()


def _select(hist: torch.Tensor, k: int) -> tuple[int, int]:
    """The digit holding the k-th largest key of a histogram, and k's
    rank inside that digit's bin."""
    above = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0]) - hist
    digit = int(((above < k) & (above + hist >= k)).nonzero()[0])
    return digit, k - int(above[digit])


def withhold_threshold(g: torch.Tensor, k: int) -> torch.Tensor:
    """``top_k(|g|, k)[0][-1]``, the k-th largest |g| counted with its
    ties, as a 0-d tensor of g's dtype: an exact radix selection over
    the values' bit patterns, 16 bits a pass (two passes for f32, one
    for 16-bit floats), each pass a histogram over :data:`random.CHUNK`
    coordinates at a time.  No sort, no index vector: besides g it holds
    one chunk's keys and a 65,536-bin histogram."""
    flat = g.reshape(-1)
    n = flat.numel()
    if not 1 <= k <= n:
        raise ValueError(f"k = {k} outside 1..{n}")
    wide = flat.element_size() == 4

    def histogram(select):
        hist = torch.zeros(1 << 16, dtype=torch.int64, device=g.device)
        for lo in range(0, n, random.CHUNK):
            keys = select(_sortable(flat[lo:lo + random.CHUNK].abs()))
            if keys.numel():
                hist += torch.bincount(keys, minlength=1 << 16)
        return hist

    if wide:
        high, k = _select(histogram(lambda x: x >> 16), k)
        low, _ = _select(histogram(lambda x: x[(x >> 16) == high] & 0xFFFF),
                         k)
        bits, view = (high << 16) | low, torch.int32
    else:
        bits, _ = _select(histogram(lambda x: x), k)
        view = torch.int16
    return torch.tensor([bits], dtype=view).view(g.dtype)[0].to(g.device)


def prune_client(g: torch.Tensor, prune_rate: float) -> torch.Tensor:
    """One client's update with its largest-magnitude ``prune_rate``
    fraction withheld: ``where(|g| >= thresh, 0, g)`` with the k-th
    largest |g| as the threshold, k = max(1, round(rate n)), so every
    tie of the threshold is withheld too.  A new vector; g is kept."""
    n = g.numel()
    thresh = withhold_threshold(g, max(1, int(round(prune_rate * n))))
    flat = g.reshape(-1)
    out = torch.empty_like(flat)
    for lo in range(0, n, random.CHUNK):
        c = flat[lo:lo + random.CHUNK]
        out[lo:lo + random.CHUNK] = torch.where(c.abs() >= thresh, 0.0, c)
    return out.view(g.shape)


def prune_withhold(grads: torch.Tensor, prune_rate: float) -> torch.Tensor:
    """Withhold (zero) the most informative (largest-magnitude)
    prune_rate fraction of each client update before transmission."""
    return torch.stack([prune_client(g, prune_rate) for g in grads])


def priprune_round(x, grads, lr, prune_rate: float):
    return fedavg_round(x, prune_withhold(grads, prune_rate), lr)


# ---------------------------------------------------------- ShatterLite
def shatter_members(key: torch.Tensor, n_chunks: int, K: int, r: int,
                    device=None) -> torch.Tensor:
    """(n_chunks, K) f32 weights: chunk c averages over the clients whose
    ``uniform(key, (n_chunks, K))`` score reaches the row's r-th largest
    (ties included), each weighted 1 / their count."""
    scores = random.uniform(key, (n_chunks, K), device=device)
    thresh = torch.topk(scores, r, dim=1).values[:, -1:]
    member = (scores >= thresh).float()
    return member / torch.clamp(member.sum(1, keepdim=True), min=1.0)


def shatter_chunk_window(n: int, n_chunks: int, lo: int, hi: int,
                         device=None) -> torch.Tensor:
    """The chunk whose weights coordinates [lo, hi) take, as the
    reference indexes them: ``min(i * n_chunks // n, n_chunks - 1)`` with
    i int32, so the product wraps once i * n_chunks >= 2**31 and the
    floor gives negative chunks, which jnp's indexing reads from the end
    (-2 is chunk n_chunks - 2).  At n = 1,816,565,760 and 8 chunks,
    coordinate 2**28 takes chunk 6's weights.  int64."""
    i = torch.arange(lo, hi, dtype=torch.int64, device=device)
    c = torch.clamp(torch.div(wrap_int32(i * n_chunks), max(n, 1),
                              rounding_mode="floor"), max=n_chunks - 1)
    return torch.clamp(torch.where(c < 0, c + n_chunks, c), 0, n_chunks - 1)


def shatter_update(key, grads: torch.Tensor, n_chunks: int, r: int
                   ) -> torch.Tensor:
    """Chunked partial gradient exchange: coordinates are split into
    n_chunks contiguous chunks; each chunk is averaged over a random
    r-subset of the K clients (a gossip-neighborhood approximation that
    intentionally deviates from full averaging)."""
    K, n = grads.shape
    member = shatter_members(key, n_chunks, K, r, grads.device)
    w = member[shatter_chunk_window(n, n_chunks, 0, n, grads.device)]
    return (w.T * grads).sum(0)


def shatter_round(key, x, grads, lr, n_chunks: int, r: int):
    return x - lr * shatter_update(key, grads, n_chunks, r)


# ---------------------------------------------------------- MinLeakage
min_leakage_round = fedavg_round  # identical iterates; differs in view
