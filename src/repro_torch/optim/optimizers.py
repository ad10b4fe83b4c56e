"""Minimal optimizer library (``repro/optim/optimizers.py``): optax-style
(init, update) pairs on trees of tensors (nested dicts).

They run on the shard-local parameter segments of the distributed FSA
step (``launch/train.py``): each aggregator updates its own disjoint
shard, and since every optimizer here is coordinate-wise, the sharded
update equals the centralized one (Theorem B.1 holds for momentum and
Adam too; paper Sec. 5 'Benefits').

Dtypes and bits are the reference's, run op by op (un-jitted), which
means JAX's promotion rather than torch's:

* a Python scalar is weakly typed: it takes the tensor's dtype, so
  ``b1 * m`` on a bf16 m multiplies by bf16(0.9) (torch would multiply
  by the f32 0.9 and round once) -- :func:`weak`;
* a 0-d array is not: Adam's ``bc1 = 1 - b1 ** t.astype(f32)`` is an f32
  array, so ``m / bc1`` is f32 for a bf16 m (torch keeps bf16), and the
  delta of a bf16 parameter is f32.  ``params + delta`` is then f32:
  after one Adam step a bf16 model's stored parameters are f32, and from
  the next step on its moments are f32 too.

Under ``jit`` XLA fuses some multiply-adds (``b1 * m + (1 - b1) * g``)
into FMAs; the op-by-op form here is the un-jitted reference's.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.kernels.ref import powf


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]   # (g, state, p) -> (delta, state)


def weak(c: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX types it beside ``like``: rounded to
    ``like``'s dtype first.  A 0-d host tensor, which torch passes to a
    CUDA kernel by value (no copy to the card)."""
    return torch.tensor(c, dtype=like.dtype)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an f32 tensor, as XLA's.
    torch 2.13's CPU ``sqrt`` (its vectorized math library) is off by an
    ulp in ~0.7% of f32 values; the square root of the double, rounded to
    f32, is the correctly rounded f32 root (53 >= 2 * 24 + 2 bits).  On
    the card ``sqrt`` rounds correctly (CUDA's ``sqrtf``)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def sgd(lr: float) -> Optimizer:
    return Optimizer(
        init=lambda p: (),
        update=lambda g, s, p: (tree_map(lambda gi: weak(-lr, gi) * gi, g),
                                s))


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(p):
        return tree_map(torch.zeros_like, p)

    def update(g, m, p):
        m = tree_map(lambda mi, gi: weak(beta, mi) * mi + gi, m, g)
        return tree_map(lambda mi: weak(-lr, mi) * mi, m), m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    t: torch.Tensor


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(p):
        # t is a step count the host reads for the bias corrections, so it
        # stays on the host (no device sync a step)
        return AdamState(tree_map(torch.zeros_like, p),
                         tree_map(torch.zeros_like, p),
                         torch.zeros((), dtype=torch.int32))

    def update(g, s, p):
        t = s.t + 1
        mu = tree_map(lambda m, gi: weak(b1, m) * m + weak(1 - b1, gi) * gi,
                      s.mu, g)
        nu = tree_map(
            lambda v, gi: weak(b2, v) * v + weak(1 - b2, gi) * gi * gi,
            s.nu, g)
        # 1 - b1 ** t in f32, a (non-weak) 0-d array: computed on the host
        # from the step count, as glibc's powf gives it
        step = float(int(t))
        bc1 = float(np.float32(1) - np.float32(powf(b1, step)))
        bc2 = float(np.float32(1) - np.float32(powf(b2, step)))

        def one(m, v, pi):
            m, v = m.float(), v.float()      # promoted by the f32 bc1, bc2
            # divided by 0-d tensors on m's device: torch's CUDA division
            # by a host scalar multiplies by its reciprocal instead
            c1, c2 = (torch.tensor(c, dtype=torch.float32, device=m.device)
                      for c in (bc1, bc2))
            d = weak(-lr, m) * (m / c1) / (sqrt_f32(v / c2) + weak(eps, m))
            if weight_decay:
                d = d - weak(lr * weight_decay, pi) * pi
            return d

        return tree_map(one, mu, nu, p), AdamState(mu, nu, t)

    return Optimizer(init, update)
