"""The collectives of the model and data axes over ``torch.distributed``,
as the reference's ``jax.lax`` collectives compute them (``tiled=True``
throughout): ``all_reduce`` (``psum``; ``pmax`` with ``op``),
``all_gather`` and ``reduce_scatter`` along a dim, ``all_to_all`` with a
split and a concat axis, and ``ring_shift`` (a ``ppermute`` one place
around the group's ring).  Each returns a new tensor and takes no part in
autograd: ``models/layers`` builds the differentiable conjugates on them.

A group whose backend has no NCCL (``gloo``, chosen by the caller of
``launch.mesh.init_process_group``) carries CUDA tensors through host
buffers: each collective copies its operand to the host, runs there, and
copies the result back.  That is how several ranks share one card, which
NCCL refuses; its times are host staging, not the card's links.  NCCL
groups and CPU tensors run the collective in place.

Each collective reports itself to an active ``launch.accounting.Account``
(kind, payload, dtype, group); with none active that costs one check.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.launch import accounting


def host_staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` through host buffers: a CUDA tensor
    on a group with no NCCL backend."""
    return (x.device.type == "cuda"
            and "nccl" not in str(dist.get_backend(group)))


def _alone(group) -> bool:
    """Whether ``group`` has one rank: its collectives are the identity."""
    return dist.get_world_size(group) == 1


def _own(x: torch.Tensor) -> torch.Tensor:
    """The identity collective's result: a new contiguous tensor on
    ``x``'s device."""
    return x.detach().clone(memory_format=torch.contiguous_format)


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where the collective reads it: a host copy when the group
    stages it, else ``x`` itself."""
    return x.detach().to("cpu") if host_staged(x, group) else x.detach()


def _counted(kind: str):
    """Reports each call over a group of more than one rank to the active
    account as one ``kind`` collective (the reference's HLO op name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(x, group, *args, **kwargs):
            acc = accounting.active()
            if acc is None or _alone(group):
                return fn(x, group, *args, **kwargs)
            first = x[0] if isinstance(x, (list, tuple)) else x
            return acc.collective(kind, group, x, host_staged(first, group),
                                  lambda: fn(x, group, *args, **kwargs))
        return counted
    return wrap


@_counted("all-reduce")
def all_reduce(x: torch.Tensor, group,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``psum`` (``op`` SUM) or ``pmax`` (MAX) over the group."""
    if _alone(group):
        return _own(x)
    y = _wire(x, group)
    y = (y.clone(memory_format=torch.contiguous_format)
         if y.data_ptr() == x.data_ptr() else y.contiguous())
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


@_counted("all-gather")
def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    if _alone(group):
        return _own(x)
    y = _wire(x, group).contiguous()
    n = dist.get_world_size(group)
    buf = y.new_empty((n, *y.shape))
    dist.all_gather(list(buf.unbind(0)), y, group=group)
    out = buf.view(n * y.shape[0], *y.shape[1:]) if dim == 0 else \
        torch.cat(buf.unbind(0), dim)
    return out.to(x.device)


@_counted("reduce-scatter")
def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's ``dim``-chunk of the sum of every rank's ``x``."""
    if _alone(group):
        return _own(x)
    y = _wire(x, group)
    n = dist.get_world_size(group)
    parts = [c.contiguous() for c in y.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.to(x.device)


@_counted("all-to-all")
def all_to_all(x: torch.Tensor, group, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """``x`` cut into group-size chunks along ``split_axis``, chunk j to
    rank j; the chunks received concatenated along ``concat_axis`` in
    rank order."""
    if _alone(group):
        return _own(x)
    y = _wire(x, group)
    n = dist.get_world_size(group)
    if split_axis == 0 and concat_axis == 0:
        send = y.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv.to(x.device)
    send = torch.stack(y.chunk(n, split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), concat_axis).to(x.device)


@_counted("collective-permute")
def ring_shift(xs: list, group, shift: int = 1) -> list:
    """``ppermute`` of each tensor in ``xs`` by ``shift`` places around
    the group's ring: rank i sends to rank i + shift and receives from
    rank i - shift.  The tensors travel as separate messages of one
    batch (tag = their place in ``xs``)."""
    if _alone(group):
        return [_own(x) for x in xs]
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    send = [_wire(x, group).contiguous() for x in xs]
    recv = [torch.empty_like(y) for y in send]
    ops = []
    for tag, (s, r) in enumerate(zip(send, recv)):
        ops.append(dist.P2POp(dist.isend, s, dst, group=group, tag=tag))
        ops.append(dist.P2POp(dist.irecv, r, src, group=group, tag=tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [r.to(x.device) for r, x in zip(recv, xs)]
