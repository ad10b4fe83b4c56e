"""Synthetic data (``repro/data/synthetic.py``): cluster-structured
classification and Zipf token streams, from the reference's keys.

Integer draws (tokens, labels, permutations) equal the reference's for
the same key.  The features go through ``random.normal``, within a
few ulps of jax's.  ``dirichlet_partition`` and what is built on it (non-IID
label skew, ``balanced_dirichlet_indices``, ``federated_population``)
draw from jax's gamma sampler, a rejection loop not ported yet (ROADMAP
queue 1.2).
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
                        n_classes: int, noise: float = 0.5):
    """Gaussian cluster classification: (x (n, dim) f32, labels (n,))."""
    k1, k2, k3 = random.split(key, 3)
    centers = 2.0 * random.normal(k1, (n_classes, dim))
    labels = random.randint(k2, (n_samples,), 0, n_classes)
    x = centers[labels] + float(np.float32(noise)) * random.normal(
        k3, (n_samples, dim))
    return x, labels


def federated_classification(key: torch.Tensor, K: int,
                             samples_per_client: int, dim: int = 16,
                             n_classes: int = 4,
                             alpha: Optional[float] = None,
                             noise: float = 0.5):
    """(x (K, S, dim), y (K, S)): an IID split of a pool four times the
    federation's size (``alpha=None``)."""
    if alpha is not None:
        raise NotImplementedError(
            "Dirichlet label skew draws from jax's gamma sampler, not "
            "ported yet (ROADMAP queue 1.2)")
    n = K * samples_per_client
    kd, kp, _ = random.split(key, 3)
    x, y = make_classification(kd, 4 * n, dim, n_classes, noise)
    idx = random.permutation(kp, 4 * n)[:n]
    return (x[idx].reshape(K, samples_per_client, dim),
            y[idx].reshape(K, samples_per_client))
