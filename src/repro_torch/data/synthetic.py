"""Synthetic data (``repro/data/synthetic.py``): cluster-structured
classification and Zipf token streams, from the reference's keys.

Integer draws (tokens, labels, permutations) equal the reference's for
the same key.  The features go through ``random.normal``, within a
few ulps of jax's.  The non-IID feeds (``dirichlet_partition`` and what
is built on it) draw each client's class proportions from
``random.dirichlet``, within a few ulps of jax's: a sample's owner moves
only where its uniform draw falls within those ulps of a boundary of the
cumulative proportions.

``device`` is where the draws run (the key's device when None); the
host-side rebalancing of ``balanced_dirichlet_indices`` and the top-up
of ``federated_classification`` are numpy, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import random
from repro_torch.kernels.ref import powf


def zipf_probs(vocab: int, zipf_a: float = 1.2) -> torch.Tensor:
    """``ranks ** -a / sum`` in f32 with the reference's bits: XLA's CPU
    ``pow`` is the C library's ``powf``, called here once a rank, and the
    sum is taken in XLA's order (``random.reduce_sum``)."""
    a = float(np.float32(-zipf_a))
    probs = torch.tensor([powf(float(r), a) for r in range(1, vocab + 1)],
                         dtype=torch.float32)
    return probs / random.reduce_sum(probs)


def lm_token_batches(key: torch.Tensor, K: int, batch: int, seq_len: int,
                     vocab: int, zipf_a: float = 1.2, device=None
                     ) -> torch.Tensor:
    """(K, batch, seq_len) int32 Zipf token streams with a learnable
    next-token rule: with probability 1/2, token t + 1 is
    (7 * token t + 3) mod vocab."""
    k1, k2 = random.split(key)
    base = random.choice(k1, vocab, (K, batch, seq_len),
                         p=zipf_probs(vocab, zipf_a))
    det = (torch.roll(base, 1, dims=-1) * 7 + 3) % vocab
    coin = random.bernoulli(k2, 0.5, base.shape)
    return torch.where(coin, det, base).to(torch.int32).to(device)


def make_classification(key: torch.Tensor, n_samples: int, dim: int,
                        n_classes: int, noise: float = 0.5, device=None):
    """Gaussian cluster classification: (x (n, dim) f32, labels (n,))."""
    k1, k2, k3 = random.split(key, 3)
    centers = 2.0 * random.normal(k1, (n_classes, dim), device=device)
    labels = random.randint(k2, (n_samples,), 0, n_classes, device=device)
    x = centers[labels] + float(np.float32(noise)) * random.normal(
        k3, (n_samples, dim), device=device)
    return x, labels


def dirichlet_partition(key: torch.Tensor, labels: torch.Tensor, K: int,
                        alpha: float, n_classes: int) -> torch.Tensor:
    """Non-IID client assignment (n_samples,): class c's proportions over
    the K clients ~ Dir(alpha); sample i goes to the first client whose
    cumulative proportion (XLA's blocked cumsum) of its class exceeds a
    uniform draw, and to client 0 when none does (jnp's argmax of an
    all-False row).  The uniforms and the search run on ``labels``'
    device, one class at a time (the (n_samples, K) comparison is never
    built); the (n_classes, K) proportions are drawn on the host
    whatever that device is.  Their loop's ``log`` and ``exp`` round
    differently on a card, and with K in the thousands an ulp moves a
    sample across a boundary of ``cum`` every thousand or so samples,
    so host-drawn proportions keep one partition on every device."""
    device = labels.device
    alpha32 = float(np.float32(alpha))
    props = random.dirichlet(key, torch.full((K,), alpha32),
                             (n_classes,), device="cpu")
    # the first j with cum[j] > u: searchsorted over the running max
    # finds it whether or not the rounded sums are monotone
    cum = torch.cummax(random.cumsum(props), dim=1).values.to(device)
    u = random.uniform(random.fold_in(key, 1), tuple(labels.shape),
                       device=device)
    owner = torch.zeros(labels.shape, dtype=torch.int64, device=device)
    for c in range(n_classes):
        rows = labels == c
        j = torch.searchsorted(cum[c].contiguous(), u[rows].contiguous(),
                               right=True)
        owner[rows] = torch.where(j < K, j, 0)
    return owner


def _owned(owner: torch.Tensor, K: int) -> list:
    """Each client's samples in index order (``np.where(owner == k)``
    for every k, in one stable sort)."""
    owner = owner.cpu()
    order = torch.sort(owner, stable=True).indices.numpy()
    bounds = np.cumsum([0] + torch.bincount(owner, minlength=K).tolist())
    return [order[bounds[k]:bounds[k + 1]] for k in range(K)]


def balanced_dirichlet_indices(key: torch.Tensor, labels: torch.Tensor,
                               K: int, alpha: float, n_classes: int
                               ) -> torch.Tensor:
    """Exact-coverage Dirichlet(alpha) partition: (K, n_samples // K)
    int64 sample indices, each sample on exactly one client.  Owners come
    from :func:`dirichlet_partition`; the reference's numpy rebalancing
    follows: each over-full client, in id order, pops its highest
    indices onto a surplus stack, and each under-full client, in id
    order, takes from the stack's top.  On ``labels``' device."""
    n_samples = int(labels.shape[0])
    if n_samples % K:
        raise ValueError(f"population partition needs n_samples "
                         f"({n_samples}) divisible by K ({K})")
    quota = n_samples // K
    lists = [list(idx) for idx in _owned(
        dirichlet_partition(key, labels, K, alpha, n_classes), K)]
    surplus: list = []
    for k in range(K):
        while len(lists[k]) > quota:
            surplus.append(lists[k].pop())
    for k in range(K):
        while len(lists[k]) < quota:
            lists[k].append(surplus.pop())
    out = np.stack([np.sort(np.asarray(lst, dtype=np.int64))
                    for lst in lists])
    return torch.from_numpy(out).to(labels.device)


def federated_population(key: torch.Tensor, population: int,
                         samples_per_client: int, dim: int = 16,
                         n_classes: int = 4, alpha: float = 0.5,
                         noise: float = 0.5, device=None):
    """Population-scale non-IID federation: (x (population, S, dim), y
    (population, S)), one global dataset split exactly once over the
    population by :func:`balanced_dirichlet_indices` (the feed of the
    cohort-sampling async runtime, ``FLConfig.population``)."""
    kd, kp = random.split(key)
    x, y = make_classification(kd, population * samples_per_client, dim,
                               n_classes, noise, device=device)
    idx = balanced_dirichlet_indices(kp, y, population, alpha, n_classes)
    take = idx[:, :samples_per_client]
    return x[take], y[take]


def federated_classification(key: torch.Tensor, K: int,
                             samples_per_client: int, dim: int = 16,
                             n_classes: int = 4,
                             alpha: Optional[float] = None,
                             noise: float = 0.5, device=None):
    """(x (K, S, dim), y (K, S)) from a pool four times the federation's
    size: an IID split when ``alpha`` is None; else Dirichlet(alpha)
    label skew, each client taking its first S owned samples, topped up
    from ``np.random.RandomState(k).choice`` over the pool (without
    replacement) when it owns fewer."""
    n = K * samples_per_client
    kd, kp, _ = random.split(key, 3)
    x, y = make_classification(kd, 4 * n, dim, n_classes, noise,
                               device=device)
    if alpha is None:
        idx = random.permutation(kp, 4 * n, device=x.device)[:n]
        return (x[idx].reshape(K, samples_per_client, dim),
                y[idx].reshape(K, samples_per_client))
    rows = []
    for k, idx in enumerate(_owned(
            dirichlet_partition(kp, y, K, alpha, n_classes), K)):
        if len(idx) < samples_per_client:
            extra = np.random.RandomState(k).choice(
                len(y), samples_per_client - len(idx), replace=False)
            idx = np.concatenate([idx, extra])
        rows.append(idx[:samples_per_client])
    take = torch.from_numpy(np.stack(rows)).to(x.device)
    return x[take], y[take]
