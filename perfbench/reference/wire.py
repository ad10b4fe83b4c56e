"""The client's shifted compression, plainly: RandP masks drawn as the
two compression paths of an ERIS round draw them, the int8 wire's block
quantization, and the shift update.

Two ways of keying the draws:

* ``jnp`` (threefry): client k's mask over coordinate i is element i of
  ``bernoulli(split(comp_key, K)[k], p, (n,))``.
* ``fused`` (the int8 wire's counter hash): coordinate i of client k
  draws u = (fmix32((k * n_pad + i) mod 2**32 xor seed) >> 8) / 2**24,
  murmur3's 32-bit finaliser, with seeds ``bits(k_in)`` for the mask and
  ``bits(k_q)`` for the rounding, (k_in, k_q) = ``split(comp_key)``;
  n_pad is n rounded up to the 256-coordinate block.

v = mask * (g - s) / p; on the wire, each block of 256 is scaled by
max|v| / 127 and rounded stochastically to int8; the shift then tracks
what was sent: s <- s + gamma * v_sent.
"""
from __future__ import annotations

import torch

from perfbench import inputs
from perfbench.reference import threefry

MASK = 0xFFFFFFFF
QBLOCK = 256


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x & MASK
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & MASK
    return x ^ (x >> 16)


def hash_uniform(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """U[0, 1) with 24 bits from the global index and a uint32 seed."""
    b = fmix32((idx & MASK) ^ (seed & MASK))
    return (b >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize_blocks(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The int8 wire's round trip of v (a whole number of blocks): each
    block scaled by max|v| / 127, rounded down or up with probability
    the fraction (u the block's uniforms), clipped to [-127, 127] and
    scaled back."""
    vb = v.view(-1, QBLOCK)
    scale = vb.abs().amax(1, keepdim=True) / 127.0
    y = vb / torch.where(scale > 0, scale, 1.0)
    low = torch.floor(y)
    q = (low + (u.view(-1, QBLOCK) < (y - low)).float()).clamp(-127, 127)
    return (q * scale).reshape(-1)


def padded(n: int) -> int:
    return -(-n // QBLOCK) * QBLOCK


def compress_client(g: torch.Tensor, s: torch.Tensor, comp_key: tuple,
                    k: int, K: int, *, p: float, gamma: float, path: str,
                    acc: torch.Tensor, weight: float,
                    sample: torch.Tensor | None = None,
                    kept: torch.Tensor | None = None) -> None:
    """Client k's transmitted vector, times ``weight``, added into
    ``acc`` (f32, g's length), and its shift s updated in place, a chunk
    at a time.  g: f32 gradient; ``path`` is ``jnp`` (threefry mask, no
    wire) or ``fused`` (hash mask, int8 wire).  With ``sample`` (sorted
    coordinates), ``kept`` (bool, the sample's length) is or-ed with the
    mask there."""
    n = g.numel()
    if path == "jnp":
        key = threefry.split(comp_key, K)[k]
    elif path == "fused":
        k_in, k_q = threefry.split(comp_key, 2)
        seed_mask, seed_round = threefry.bits(k_in), threefry.bits(k_q)
        base = k * padded(n)
    else:
        raise ValueError(f"unknown compression path {path!r}")
    starts = list(range(0, n, threefry.CHUNK))
    if sample is not None:
        bounds = inputs.leaf_bounds(sample, starts + [n])
    # CHUNK is a multiple of QBLOCK, so a block never straddles chunks
    for j, lo in enumerate(starts):
        hi = min(n, lo + threefry.CHUNK)
        diff = g[lo:hi] - s[lo:hi]
        if path == "jnp":
            keep = threefry.bernoulli_window(key, p, lo, hi, g.device)
            v = torch.where(keep, diff / p, 0.0)
        else:
            m = padded(hi - lo)
            idx = torch.arange(base + lo, base + lo + m, dtype=torch.int64,
                               device=g.device)
            v = torch.zeros(m, dtype=torch.float32, device=g.device)
            keep = hash_uniform(idx[:hi - lo], seed_mask) < p
            v[:hi - lo] = torch.where(keep, diff / p, 0.0)
            v = quantize_blocks(v, hash_uniform(idx, seed_round))[:hi - lo]
        if sample is not None:
            a, b = bounds[j], bounds[j + 1]
            kept[a:b] |= keep[sample[a:b] - lo]
        acc[lo:hi] += weight * v
        s[lo:hi] += gamma * v
