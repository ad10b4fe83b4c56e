"""Counter-based PRNG of the port's wire kernels and their plain versions
(``repro/kernels/common.py``).

murmur3 fmix32 keyed on (seed, element index).  Torch has no uint32
``>>`` on the CPU, so the 32-bit arithmetic is emulated in int64 with
``& 0xFFFFFFFF`` after every step; the products of two values below
2**32 overflow int64, which wraps modulo 2**64 and leaves the low 32
bits -- the uint32 product -- intact.  Bit-exact against the reference.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of the low 32 bits of ``x``; int64 in, int64 out
    (values in [0, 2**32))."""
    x = x.to(torch.int64) & _MASK
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK
    x = x ^ (x >> 16)
    return x


def uniform_from_index(idx: torch.Tensor, seed) -> torch.Tensor:
    """U[0, 1) with 24-bit resolution from a global element index and a
    uint32 seed (tensor or int)."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=idx.device)
    bits = hash_u32((idx.to(torch.int64) & _MASK) ^ (seed & _MASK))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
