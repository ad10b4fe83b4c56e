"""Rematerialization: the port's ``jax.checkpoint`` and the reference's
policy table (``repro/models/transformer.py:481-498``).

A region run through :func:`checkpoint` under autograd keeps its inputs
and drops what its ops save for the backward; the backward runs the
region again (``torch.utils.checkpoint``, non-reentrant) and takes the
saved tensors from that run.  A :class:`Policy` names products whose
outputs stay resident instead, as jax's saveable policies do: the
recompute takes them from the forward and does not run them again.

  * ``full`` (policy None): nothing is kept but the region's inputs;
  * ``dots``: the products with no batch dimensions (jax's
    ``dots_with_no_batch_dims_saveable``), which are aten's ``mm`` and
    ``addmm`` (what a 3-D by 2-D ``matmul`` lowers to); batched products
    (``bmm``, ``baddbmm``: attention's ``einsum``) are run again;
  * ``dots_batch``: every product (``dots_saveable``);
  * ``offload_dots``: what ``dots`` keeps, copied to pinned host memory
    in the forward and back to the device in the recompute
    (``offload_dot_with_no_batch_dims("device", "pinned_host")``).

torch's own selective checkpoint hands each kept tensor out once and then
refuses a second backward through the region; the reference takes one
(the DLG attack differentiates a gradient).  The policies here keep their
tensors for as long as the region's graph lives, so each backward's
recompute finds them again.

The port draws no torch RNG in a forward (its keys are threefry
counters), so no RNG state is stashed for the recompute.  On the meta
device the offloaded copy is a meta tensor that the account does not hold
on the device: its bytes go to ``Account.offload_bytes``.  On a host
tensor the copy is the tensor itself.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils.checkpoint import checkpoint as _checkpoint

from repro_torch.launch import accounting

aten = torch.ops.aten
_DOTS = frozenset({aten.mm, aten.addmm})
_BATCH_DOTS = frozenset({aten.bmm, aten.baddbmm})


@dataclasses.dataclass(frozen=True)
class Policy:
    """What a checkpointed region keeps beyond its inputs: the outputs of
    the aten ops in ``saves``, on the device or (``offload``) in host
    memory."""
    name: str
    saves: frozenset
    offload: bool = False


POLICIES = {
    "full": None,
    "dots": Policy("dots", _DOTS),
    "dots_batch": Policy("dots_batch", _DOTS | _BATCH_DOTS),
    "offload_dots": Policy("offload_dots", _DOTS, offload=True),
}


def checkpoint(fn: Callable, *args, policy: Optional[Policy] = None):
    """``fn(*args)``; where autograd records, under a non-reentrant
    ``torch.utils.checkpoint`` keeping what ``policy`` names (None: the
    inputs only)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(_contexts, policy)
    return _checkpoint(fn, *args, use_reentrant=False,
                       preserve_rng_state=False, **kw)


def _contexts(policy: Policy):
    store: list = []
    return _Keep(policy, store), _Replay(policy, store)


def _alias(t: torch.Tensor) -> torch.Tensor:
    """A fresh detached alias of a kept tensor: autograd attaches each
    recompute's node to its own alias, never to the kept one (torch's
    selective checkpoint detaches the same way)."""
    with torch._C._SetExcludeDispatchKeyGuard(
            torch._C.DispatchKey.ADInplaceOrView, False):
        return t.detach()


class _Keep(TorchDispatchMode):
    """The forward: runs every op and keeps the outputs of the policy's."""

    def __init__(self, policy: Policy, store: list):
        super().__init__()
        self.policy, self.store = policy, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in self.policy.saves:
            kept = _alias(out)
            if self.policy.offload:
                kept = _to_host(kept)
            self.store.append((func, kept, out.device))
        return out


class _Replay(TorchDispatchMode):
    """A recompute: the policy's ops return what the forward kept, in
    order; every other op runs again.  Entered anew by each backward."""

    def __init__(self, policy: Policy, store: list):
        super().__init__()
        self.policy, self.store, self.i = policy, store, 0

    def __enter__(self):
        self.i = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket not in self.policy.saves:
            return func(*args, **(kwargs or {}))
        if self.i >= len(self.store) or self.store[self.i][0] is not func:
            raise RuntimeError(
                f"remat_policy {self.policy.name!r}: the recompute reached "
                f"{func} as kept product {self.i}, which the forward did "
                f"not run there; the region is not deterministic")
        _, kept, device = self.store[self.i]
        self.i += 1
        if self.policy.offload and device.type != "cpu":
            return _from_host(kept, device)
        return _alias(kept)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """The offloaded copy of a device tensor (pinned, asynchronous on the
    card), outside the account but for its ``offload`` record."""
    if t.device.type == "cpu":
        return t
    accounting.offload(t)
    with _disable_current_modes():
        if t.device.type == "meta":
            return torch.empty_like(t)
        host = torch.empty_like(t, device="cpu", pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host


def _from_host(kept: torch.Tensor, device: torch.device) -> torch.Tensor:
    """An offloaded tensor back on ``device``, through the modes below
    (an account counts the copy and holds the result)."""
    if device.type == "meta":
        return kept.clone()
    return kept.to(device, non_blocking=True)
