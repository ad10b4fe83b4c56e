"""Unbiased omega-compression operators (``repro/core/compressors.py``,
Definition 3.1 of the paper).

The port keeps the operators' constants (``omega``, ``retention``,
``wire_bits``), which size DSC's shift step and the wire accounting, and
runs the compressors themselves only inside the wire kernels: RandP in
``kernels/dsc_update`` and ``kernels/dsc_quantize``, the int8 round trip
in ``kernels/quantize``.  Calling a compressor densely draws its mask from
``jax.random`` in the reference; the port has no threefry stream yet
(ROADMAP queue 1.2), so ``__call__`` raises.

As in the reference, the dataclass fields of a subclass follow the base's
``name``: ``RandP(0.25)`` sets the name and keeps p = 0.1.  Write
``RandP(p=0.25)``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class: the identity."""

    name: str = "identity"

    def __call__(self, key, x):
        raise NotImplementedError(
            f"{type(self).__name__}.__call__ draws from jax.random in the "
            f"reference; the port has no threefry key stream yet (ROADMAP "
            f"queue 1.2).  RandP runs inside the wire kernels instead "
            f"(DSCCompress impl='pallas' or 'fused')")

    def omega(self, n: int) -> float:
        """Variance parameter of Definition 3.1."""
        return 0.0

    def retention(self, n: int) -> float:
        """Expected fraction of coordinates present in the output."""
        return 1.0

    def wire_bits(self, n: int) -> float:
        """Expected number of bits on the wire for an n-vector."""
        return 32.0 * n


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    name: str = "identity"


@dataclasses.dataclass(frozen=True)
class RandP(Compressor):
    """Random (Bernoulli) sparsification: keep each coordinate w.p. p,
    scale kept coordinates by 1/p.  omega = (1-p)/p (paper, Sec. 3.2.2)."""

    p: float = 0.1
    name: str = "rand_p"

    def omega(self, n):
        return (1.0 - self.p) / self.p

    def retention(self, n):
        return self.p

    def wire_bits(self, n):
        # value + index per surviving coordinate, in f32 as the reference
        # computes it (its log2 runs on an f32 array)
        index_bits = np.ceil(np.log2(np.float32(max(n, 2))))
        return float(np.float32(self.p * n)
                     * (np.float32(32.0) + index_bits))


@dataclasses.dataclass(frozen=True)
class Int8RoundTrip(Compressor):
    """Wire-format composition: inner omega-compressor followed by
    per-block stochastic int8 quantize->dequantize.  The int8 stage is
    unbiased and its variance negligible next to a sparsifying inner
    compressor, so ``omega`` reports the inner bound.  In the port only
    the fused kernel (``DSCCompress(impl='fused')``) runs it."""

    inner: Compressor = Identity()
    block: int = 256
    name: str = "int8_round_trip"

    def omega(self, n):
        return self.inner.omega(n)

    def retention(self, n):
        return self.inner.retention(n)

    def wire_bits(self, n):
        # a dense int8 vector + one f32 scale per block
        return 8.0 * n + 32.0 * math.ceil(n / self.block)
