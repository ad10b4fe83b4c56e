"""Plain torch versions of the wire kernels (``repro/kernels/ref.py``).

Each computes what its CUDA kernel computes, on any device, and is what
the kernel's wrapper runs for a CPU tensor.  They follow the Pallas
kernels, not the reference's jnp oracles, in the two places where those
differ:

* v is ``(g - s) * f32(1/p)`` with ``1/p`` taken in double on the host,
  as ``kernels/dsc_update.py:40`` and ``kernels/dsc_quantize.py:46`` do;
  the jnp oracles divide by p, which rounds differently.
* every random draw is keyed on ``index_base + i``: the coordinate's
  place in the flattened, padded ``(K, n_pad)`` client block the
  simulator hands one kernel call.  A caller that streams clients one at
  a time passes ``index_base = k * n_pad``.  The index is taken modulo
  2**32, as the reference's uint32 index (``kernels/common.py:39``) and
  its int32 grid base both wrap.

and in two more places where the reference, as XLA compiles the
interpret-mode kernels in the simulator's jitted round on the CPU, does
not round as its source reads:

* ``max|x| / 127`` is compiled to ``max|x| * f32(1/127)`` (XLA rewrites a
  division by a constant into a multiply by its reciprocal);
* dsc_quantize's ``s + gamma * (q * scale)`` is compiled to one fused
  multiply-add, rounded once.  dsc_update's ``s + gamma * v`` rounds
  twice there, as it reads (XLA fuses it into an FMA only in other
  contexts: the kernel jitted alone with a traced seed, or a bf16 g).

The plain versions compute exactly that (:func:`fma_f32` emulates the
single rounding on any device), and the CUDA kernels do the same with
``__fmul_rn``, ``__fadd_rn`` and ``__fmaf_rn``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.common import uniform_from_index

QBLOCK = 256          # coords per int8 scale (``kernels/quantize.QBLOCK``)
_MASK = 0xFFFFFFFF
# f32(1/127), the constant XLA multiplies by for ``/ 127.0``; exactly
# representable in f32, so the product below rounds once
INV127 = float(np.float32(1.0) / np.float32(127.0))


def flat_index(n: int, index_base: int, device) -> torch.Tensor:
    """The draws' index of coordinates 0..n-1: ``(index_base + i) mod
    2**32``, as int64."""
    return (torch.arange(n, dtype=torch.int64, device=device)
            + int(index_base)) & _MASK


def fma_f32(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``f32(a) * b + c`` for f32 tensors b, c, rounded once to f32 as a
    fused multiply-add rounds it.  The product is exact in double (24 + 24
    bits); the sum is taken in double rounded to odd (TwoSum for the
    error, then a nudge to the odd neighbour when inexact), and rounding
    that to f32 is the single rounding of the exact value."""
    prod = b.double() * float(np.float32(a))
    c = c.double()
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    nudge = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.copysign(torch.full_like(s, math.inf), err)
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def dsc_update_ref(g: torch.Tensor, s: torch.Tensor, seed: int, *,
                   p: float, gamma: float, index_base: int = 0):
    """v = where(u < p, (g - s) * (1/p), 0);  s' = s + gamma * v.

    g: (n,) any float dtype; s: (n,) f32.  Returns (v in g's dtype, s'
    f32).  s' is built from the unrounded f32 v, not from v in g's dtype
    (``kernels/dsc_update.py:39-42``)."""
    u = uniform_from_index(flat_index(g.numel(), index_base, g.device), seed)
    v = torch.where(u < p, (g.float() - s) * (1.0 / p), 0.0)
    return v.to(g.dtype), s + gamma * v


def _quantize_f32(x: torch.Tensor, seed: int, idx: torch.Tensor):
    """Block-wise stochastic int8 of an f32 vector whose length is a
    multiple of QBLOCK.  Returns (q as f32 codes, scales)."""
    xb = x.view(-1, QBLOCK)
    scale = xb.abs().amax(1) * INV127
    safe = torch.where(scale > 0, scale, 1.0)
    y = xb / safe[:, None]
    low = torch.floor(y)
    u = uniform_from_index(idx.view(-1, QBLOCK), seed)
    q = (low + (u < (y - low)).float()).clamp(-127.0, 127.0)
    return q, scale


def quantize_ref(x: torch.Tensor, seed: int, *, index_base: int = 0):
    """Per-256-block stochastic int8.  x: (n,) float, zero-padded to a
    QBLOCK multiple.  Returns (q int8 (n_pad,), scales f32 (n_pad/256,));
    a zero block gives scale 0 and codes 0."""
    n = x.numel()
    pad = (-n) % QBLOCK
    xp = F.pad(x.reshape(-1).float(), (0, pad))
    q, scale = _quantize_f32(xp, seed,
                             flat_index(n + pad, index_base, x.device))
    return q.to(torch.int8).reshape(-1), scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x = q * scale per 256-block; f32 (n_pad,)."""
    return (q.view(-1, QBLOCK).float() * scale[:, None]).reshape(-1)


def dsc_quantize_ref(g: torch.Tensor, s: torch.Tensor, seed_mask: int,
                     seed_round: int, *, p: float, gamma: float,
                     index_base: int = 0):
    """The fused client step: RandP on g - s (seed_mask), block int8 of v
    (seed_round), and s' = s + gamma * q * scale, the shift tracking the
    wire value.  g: (n,) f32 or bf16; s: (n,) f32.  Returns (q int8
    (n_pad,), scales f32 (n_pad/256,), s' f32 (n,)); the zero-padded tail
    has g = s = 0, so it never moves a scale."""
    n = g.numel()
    pad = (-n) % QBLOCK
    idx = flat_index(n + pad, index_base, g.device)
    diff = F.pad(g.float() - s, (0, pad))
    v = torch.where(uniform_from_index(idx, seed_mask) < p,
                    diff * (1.0 / p), 0.0)
    q, scale = _quantize_f32(v, seed_round, idx)
    v_hat = (q * scale[:, None]).reshape(-1)[:n]
    return q.to(torch.int8).reshape(-1), scale, fma_f32(gamma, v_hat, s)
