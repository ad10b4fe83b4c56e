"""Unbiased omega-compression operators (``repro/core/compressors.py``,
Definition 3.1 of the paper).

Each compressor's ``__call__(key, x)`` draws from the port's threefry
stream (``repro_torch.random``) with the reference's keys, and rounds as
XLA compiles the reference's jitted round on the CPU: a division by a
constant is a multiply by its f32 reciprocal (``x / p`` in RandP, ``q /
s`` in QSGD).  Draws keyed by integers (RandP's mask, QSGD's rounding,
the int8 codes) are the reference's bit for bit; RandK ranks Gumbel
scores, which agree with jax's to a few ulps (``random.gumbel``).  The
constants (``omega``, ``retention``, ``wire_bits``) size DSC's shift
step and the wire accounting.

As in the reference, the dataclass fields of a subclass follow the base's
``name``: ``RandP(0.25)`` sets the name and keeps p = 0.1.  Write
``RandP(p=0.25)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch import random


def reciprocal(c: float) -> float:
    """The f32 constant XLA multiplies by for a division by the constant
    c: ``1 / c`` folded in f32."""
    return float(np.float32(1.0) / np.float32(c))


def scale_by_reciprocal(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as XLA's CPU compiler folds it: a multiply by the
    reciprocal of c, where c is first rounded to x's dtype (a weakly
    typed scalar).  f32 and bf16 (computed in f32) multiply by the f32
    reciprocal; f16 by the reciprocal rounded to f16."""
    if x.dtype == torch.float32:
        return x * reciprocal(c)
    c = float(torch.tensor(c, dtype=x.dtype))
    r = reciprocal(c)
    if x.dtype == torch.float16:
        r = float(torch.tensor(r, dtype=torch.float16))
    return (x.float() * r).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class: the identity.  ``__call__(key, x)`` maps an f32 vector
    to its compressed, densely represented value."""

    name: str = "identity"

    def __call__(self, key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x

    def omega(self, n: int) -> float:
        """Variance parameter of Definition 3.1."""
        return 0.0

    def retention(self, n: int) -> float:
        """Expected fraction of coordinates present in the output."""
        return 1.0

    def wire_bits(self, n: int) -> float:
        """Expected number of bits on the wire for an n-vector."""
        return 32.0 * n

    @property
    def unbiased(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    name: str = "identity"


@dataclasses.dataclass(frozen=True)
class RandP(Compressor):
    """Random (Bernoulli) sparsification: keep each coordinate w.p. p,
    scale kept coordinates by 1/p.  omega = (1-p)/p (paper, Sec. 3.2.2)."""

    p: float = 0.1
    name: str = "rand_p"

    def __call__(self, key, x):
        keep = random.bernoulli(key, self.p, tuple(x.shape), device=x.device)
        return torch.where(keep, scale_by_reciprocal(x, self.p), 0.0)

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
    compressor, so ``omega`` reports the inner bound.  The round trip
    runs the ``quantize`` kernels on a CUDA tensor and their plain
    versions on the host, which compute the reference's ``quantize_ref``
    bit for bit (``max|x| / 127`` as XLA compiles it)."""

    inner: Compressor = Identity()
    block: int = 256
    name: str = "int8_round_trip"

    def codes(self, key, x):
        """The wire payload of x: (int8 codes (n_pad,), f32 block
        scales), the inner compressor drawing with ``split(key)[0]`` and
        the rounding with ``split(key)[1]``."""
        from repro_torch.kernels import quantize as q_kernel
        if self.block != q_kernel.QBLOCK:
            raise ValueError(f"the int8 wire quantizes blocks of "
                             f"{q_kernel.QBLOCK}, not {self.block}")
        k_in, k_q = random.split(key)
        return q_kernel.quantize(self.inner(k_in, x), int(random.bits(k_q)))

    def __call__(self, key, x):
        from repro_torch.kernels import quantize as q_kernel
        return q_kernel.dequantize(*self.codes(key, x))[:x.numel()]

    def omega(self, n):
        return self.inner.omega(n)

    def retention(self, n):
        return self.inner.retention(n)

    def wire_bits(self, n):
        # a dense int8 vector + one f32 scale per block
        return 8.0 * n + 32.0 * math.ceil(n / self.block)

    @property
    def unbiased(self) -> bool:
        return self.inner.unbiased


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Random-k sparsification: keep exactly k uniformly chosen
    coordinates (Gumbel top-k), scale by n/k.  omega = n/k - 1."""

    k: int = 128
    name: str = "rand_k"

    def __call__(self, key, x):
        n = x.shape[-1]
        scores = random.gumbel(key, (n,), device=x.device)
        thresh = torch.topk(scores, self.k).values[-1]
        return torch.where(scores >= thresh, x * float(np.float32(n / self.k)),
                           0.0)

    def omega(self, n):
        return n / self.k - 1.0

    def retention(self, n):
        return self.k / n

    def wire_bits(self, n):
        return float(np.float32(self.k)
                     * (np.float32(32.0)
                        + np.ceil(np.log2(np.float32(max(n, 2))))))


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """QSGD stochastic quantization (Alistarh et al. 2017) with s levels:
    ``||x|| sign(x_i) xi_i``, xi_i a stochastic rounding of
    ``|x_i| / ||x|| * s`` to an integer, over s.  Unbiased."""

    s: int = 16
    name: str = "qsgd"

    def __call__(self, key, x):
        norm = torch.sqrt(random.reduce_sum(x * x))
        safe = torch.where(norm > 0, norm, 1.0)
        y = x.abs() / safe * float(self.s)
        low = torch.floor(y)
        up = random.bernoulli(key, y - low)
        q = (low + up.float()) * reciprocal(self.s)
        out = norm * torch.sign(x) * q
        return torch.where(norm > 0, out, 0.0)

    def omega(self, n):
        return float(min(n / self.s**2, (n**0.5) / self.s))

    def retention(self, n):
        return 1.0

    def wire_bits(self, n):
        return 32.0 + n * (1 + math.ceil(math.log2(self.s + 1)))


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Top-k by magnitude.  BIASED (not an omega-compressor): it runs
    under error feedback (``core/error_feedback.py``)."""

    k: int = 128
    name: str = "top_k"

    def __call__(self, key, x):
        thresh = torch.topk(x.abs(), self.k).values[-1]
        return torch.where(x.abs() >= thresh, x, 0.0)

    def omega(self, n):
        return float("nan")

    def retention(self, n):
        return self.k / n

    def wire_bits(self, n):
        return float(np.float32(self.k)
                     * (np.float32(32.0)
                        + np.ceil(np.log2(np.float32(max(n, 2))))))

    @property
    def unbiased(self) -> bool:
        return False


def get_compressor(name: str, n: Optional[int] = None, **kw) -> Compressor:
    """A compressor by name (``compressors.py:209-221``), with the
    reference's defaults: RandP p = 0.1, RandK and TopK k = n // 10 (n
    defaults to 1024, k at least 1), QSGD s = 16."""
    name = name.lower()
    if name in ("identity", "none"):
        return Identity()
    if name == "rand_p":
        return RandP(p=kw.get("p", 0.1))
    if name == "rand_k":
        return RandK(k=kw.get("k", max(1, (n or 1024) // 10)))
    if name == "qsgd":
        return QSGD(s=kw.get("s", 16))
    if name == "top_k":
        return TopK(k=kw.get("k", max(1, (n or 1024) // 10)))
    raise ValueError(f"unknown compressor {name!r}")
