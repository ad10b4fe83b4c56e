"""jax's threefry key stream, in plain torch: the keys and draws the ERIS
round takes (``jax.random`` with ``jax_threefry_partitionable`` on, the
default since jax 0.5).

Threefry-2x32 with 20 rounds (Salmon et al., SC 2011) hashes a counter
pair under a key pair.  A key is two uint32 words; ``PRNGKey(seed)`` is
(0, seed mod 2**32).  ``split(key, n)[i]`` is the hash of the counters
(i >> 32, i mod 2**32); element i of a 32-bit draw is the xor of the two
words that hash those counters.  A uniform in [0, 1) puts the draw's 23
high bits under the exponent of 1.0 and subtracts 1; ``bernoulli`` is
``uniform < f32(p)``.

Every 32-bit value lives in an int64 masked after each add and rotate.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
CHUNK = 1 << 24


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The hash of counters (x1, x2) under key (k1, k2); ints or int64
    tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def PRNGKey(seed: int) -> tuple:
    return (0, int(seed) & MASK)


def split(key: tuple, num: int = 2) -> list:
    k1, k2 = key
    return [threefry2x32(k1, k2, i >> 32, i & MASK) for i in range(num)]


def bits(key: tuple) -> int:
    """A 32-bit scalar draw (``jax.random.bits(key)``)."""
    y1, y2 = threefry2x32(key[0], key[1], 0, 0)
    return y1 ^ y2


def bernoulli_window(key: tuple, p: float, lo: int, hi: int,
                     device) -> torch.Tensor:
    """Elements [lo, hi) of ``jax.random.bernoulli(key, p, (n,))`` for
    any n >= hi: a bool tensor of hi - lo."""
    i = torch.arange(lo, hi, dtype=torch.int64, device=device)
    y1, y2 = threefry2x32(key[0], key[1], i >> 32, i & MASK)
    b = y1 ^ y2
    u = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return u < float(np.float32(p))
