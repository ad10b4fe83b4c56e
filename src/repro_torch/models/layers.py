"""Layers (``repro/models/layers.py``): RMS norm, rotary embedding,
query-chunked causal GQA attention, single-token attention on the dense
ring cache, and the model axis's conjugate collectives.

Plain torch throughout: the reference leaves these to XLA, the port to
PyTorch's eager kernels.  ``causal_attention`` deliberately does not
call ``scaled_dot_product_attention`` -- it is the same materialized
softmax as the reference, chunked over queries.

The model axis (tensor parallelism).  Each of the reference's
``custom_vjp`` conjugates is a ``torch.autograd.Function`` whose forward
and backward issue ``dist.collectives`` on the :class:`TPRuntime`'s
group (``tp`` below).  A region is
``y = tp_pull(partial(tp_push(x) @ W_col) @ W_row)``: the entry's
backward and the exit's forward all-reduce, exactly two collectives per
matmul pair each way.  Every rank runs the same program, so the ranks
issue the same collectives in the same order in the backward too; a
Function's backward runs whenever its output takes part in the loss,
with zeros for an output that does not (``set_materialize_grads``), so
no rank skips one.  ``ModelConfig.overlap_collectives`` (the default)
takes the ring variants (``tp_enter``/``tp_exit`` with ``ring``), whose
sums are :func:`ring_all_reduce`, adding the chunks in the reference's
order; the plain pair all-reduces in the backend's own order.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.dist import collectives as cl


# ------------------------------------------------ tensor-parallel region
class _Push(torch.autograd.Function):
    """Enter a TP region: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, tp, ring):
        ctx.tp, ctx.ring = tp, ring
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _sum(ct, ctx.tp, ctx.ring), None, None


class _Pull(torch.autograd.Function):
    """Exit a TP region: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, tp, ring):
        return _sum(x, tp, ring)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _PSum(torch.autograd.Function):
    """All-reduce forward AND backward: statistics consumed on every
    shard (the channel-sharded RMS norm's mean of squares)."""

    @staticmethod
    def forward(ctx, x, tp, ring):
        ctx.tp, ctx.ring = tp, ring
        return _sum(x, tp, ring)

    @staticmethod
    def backward(ctx, ct):
        return _sum(ct, ctx.tp, ctx.ring), None, None


def _sum(x, tp, ring: int):
    return ring_all_reduce(x, tp) if ring else cl.all_reduce(x, tp.group)


def tp_push(x, tp):
    """Enter a TP region: identity forward, psum(cotangent) backward."""
    return _Push.apply(x, tp, 0)


def tp_pull(x, tp):
    """Exit a TP region: psum(partials) forward, identity backward."""
    return _Pull.apply(x, tp, 0)


def tp_psum(x, tp):
    """psum forward and backward."""
    return _PSum.apply(x, tp, 0)


def tp_push_ring(x, tp):
    return _Push.apply(x, tp, tp.size)


def tp_pull_ring(x, tp):
    return _Pull.apply(x, tp, tp.size)


def tp_psum_ring(x, tp):
    return _PSum.apply(x, tp, tp.size)


def tp_enter(x, tp, ring: int = 0):
    """tp_push, or its ring variant when ``ring`` (the model-axis size) is
    nonzero."""
    return tp_push_ring(x, tp) if ring else tp_push(x, tp)


def tp_exit(x, tp, ring: int = 0):
    """tp_pull, or its ring variant."""
    return tp_pull_ring(x, tp) if ring else tp_pull(x, tp)


# --------------------------------------------- sequence-parallel region
class _SeqGather(torch.autograd.Function):
    """Enter a TP region from sequence shards: all-gather forward,
    reduce-scatter of the partial cotangents backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return cl.all_gather(x, tp.group, dim)

    @staticmethod
    def backward(ctx, ct):
        return cl.reduce_scatter(ct, ctx.tp.group, ctx.dim), None, None


class _SeqScatter(torch.autograd.Function):
    """Exit a TP region to sequence shards: reduce-scatter forward,
    all-gather backward."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return cl.reduce_scatter(x, tp.group, dim)

    @staticmethod
    def backward(ctx, ct):
        return cl.all_gather(ct, ctx.tp.group, ctx.dim), None, None


def tp_seq_gather(x, tp, dim: int):
    return _SeqGather.apply(x, tp, dim)


def tp_seq_scatter(x, tp, dim: int):
    return _SeqScatter.apply(x, tp, dim)


# ------------------------------------- overlapped (ring) model collectives
def ring_all_reduce(x: torch.Tensor, tp, *, buffers: int = 2):
    """psum(x) as the reference computes it: the flat payload (zero-padded
    to n * buffers chunks) in ``buffers`` interleaved chunk rings, a
    reduce-scatter ring of n - 1 one-place shifts then an all-gather ring
    of n - 1, the rings' chunks travelling side by side.  Rank i ends the
    reduce-scatter holding chunk i of each ring, summed in x's dtype as
    ((x_{i+1} + x_{i+2}) + ...) + x_i, ranks mod n."""
    n = tp.size
    if n == 1:
        return x
    shape, dt = x.shape, x.dtype
    flat = x.reshape(-1)
    m = flat.numel()
    nchunks = n * buffers
    pad = (-m) % nchunks
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.view(nchunks, -1)
    idx = tp.index

    def local(r, j):
        return chunks[r * n + j % n]

    accs = [local(r, idx + n - 1) for r in range(buffers)]
    for step in range(n - 1):
        accs = cl.ring_shift(accs, tp.group)
        accs = [a + local(r, idx + n - 2 - step)
                for r, a in enumerate(accs)]
    out = torch.empty_like(chunks)
    for r in range(buffers):
        out[r * n + idx] = accs[r]
    bufs = accs
    for step in range(1, n):
        bufs = cl.ring_shift(bufs, tp.group)
        for r in range(buffers):
            out[r * n + (idx - step) % n] = bufs[r]
    return out.view(-1)[:m].view(shape).to(dt)


# ------------------------------------------- context-parallel (ring) region
class _CtxEnter(torch.autograd.Function):
    """Enter a ring region: this rank's sequence chunk forward; the
    chunks' cotangents assembled (all-gather, no reduction) backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        c = x.shape[1] // tp.size
        return x[:, tp.index * c:(tp.index + 1) * c].clone()

    @staticmethod
    def backward(ctx, ct):
        return cl.all_gather(ct, ctx.tp.group, 1), None


class _CtxExit(torch.autograd.Function):
    """Exit a ring region: the chunks gathered forward; this rank's chunk
    of the replicated cotangent backward."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp = tp
        return cl.all_gather(y, tp.group, 1)

    @staticmethod
    def backward(ctx, ct):
        tp = ctx.tp
        c = ct.shape[1] // tp.size
        return ct[:, tp.index * c:(tp.index + 1) * c].contiguous(), None


def ctx_enter(x, tp):
    return _CtxEnter.apply(x, tp)


def ctx_exit(y, tp):
    return _CtxExit.apply(y, tp)


class _Shift(torch.autograd.Function):
    """``ppermute`` one place forward around the ring (rank i to i + 1);
    its backward, the inverse permutation."""

    @staticmethod
    def forward(ctx, tp, *xs):
        ctx.tp = tp
        return tuple(cl.ring_shift(list(xs), tp.group, 1))

    @staticmethod
    def backward(ctx, *cts):
        return (None, *cl.ring_shift(list(cts), ctx.tp.group, -1))


def shift_next(x, rt):
    """``ppermute`` of ``x`` one place forward around ``rt``'s group (a
    ``TPRuntime`` or a ``PipeRuntime``): the pipeline's boundary send."""
    return _Shift.apply(rt, x)[0]


def ring_attention(q, k, v, tp, *, window: Optional[int] = None):
    """Causal GQA attention over sequence chunks rotated around the ring.

    q: (B, C, H, hd), this rank's query chunk (C = S / n, global offset
    ``index * C``); k, v: (B, C, KV, hd), its key/value chunk.  Each of
    the n - 1 hops shifts the held K/V chunk one rank forward and folds it
    into the online-softmax recurrence (m, l, acc rescaled as the flash
    kernel's blocks are).  Plain torch: autograd runs back through the
    hops, each shift's backward the inverse one."""
    B, C, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    n, idx = tp.size, tp.index
    qg = q.reshape(B, C, KV, G, hd)
    scale = hd ** -0.5
    ar = torch.arange(C, device=q.device)
    qpos = idx * C + ar
    m = torch.full((B, KV, G, C), -1e30, device=q.device)
    l = torch.zeros((B, KV, G, C), device=q.device)
    acc = torch.zeros((B, KV, G, C, hd), device=q.device)
    kh, vh = k, v
    for t in range(n):
        kpos = ((idx - t) % n) * C + ar      # the chunk held after t hops
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kh).float() * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask, -1e30)
        m_cur = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p, vh.float())
        m = m_cur
        if t + 1 < n:
            kh, vh = _Shift.apply(tp, kh, vh)
    out = acc / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)


def pmax(x: torch.Tensor, tp) -> torch.Tensor:
    """The max over the model axis (no gradient: it is taken of a
    stop-gradient value, as the reference's)."""
    return cl.all_reduce(x.detach(), tp.group, dist.ReduceOp.MAX)


def all_to_all(x, tp, split_axis: int, concat_axis: int):
    """Differentiable ``all_to_all(x, split_axis, concat_axis,
    tiled=True)`` over the model axis; its backward the conjugate one."""
    return _AllToAll.apply(x, tp, split_axis, concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, split_axis, concat_axis):
        ctx.args = tp, split_axis, concat_axis
        return cl.all_to_all(x, tp.group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, ct):
        tp, split_axis, concat_axis = ctx.args
        return (cl.all_to_all(ct, tp.group, concat_axis, split_axis),
                None, None, None)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    # Rounding order matters for bf16 parity: the variance is taken in
    # f32, rsqrt is cast to x's dtype BEFORE the multiply, then * scale.
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rms_norm_sharded(x, scale, eps, tp, full_dim: int):
    """RMS norm whose normalized dim is sharded over the model axis: the
    mean of squares assembled by a both-ways psum (``tp_psum``)."""
    ss = x.float().square().sum(-1, keepdim=True)
    var = tp_psum(ss, tp) / full_dim
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotary embedding.  x: (..., S, H, hd), positions: (..., S).

    Rotates the two concatenated HALVES ``x[..., :hd/2]`` and
    ``x[..., hd/2:]`` against each other -- not interleaved even/odd
    pairs, which would give other numbers from the same weights."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    angles = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _scale_in(hd: int, dtype: torch.dtype) -> float:
    """hd**-0.5 rounded to ``dtype`` on the host, as a Python float: a
    tensor of ``dtype`` times it gives the bits of a product with the
    rounded scale as a tensor, with no copy to the device per call."""
    return torch.tensor(hd ** -0.5, dtype=dtype).item()


def _attend_block(q, k, v, qpos, kpos, window, scores_f32=True):
    """q: (B, Cq, KV, G, hd); k/v: (B, Skv, KV, hd); returns (B,Cq,KV,G,hd).
    Causal + optional sliding-window masking by absolute positions."""
    sdt = torch.float32 if scores_f32 else q.dtype
    neg = -1e30 if scores_f32 else -6e4
    # the scale is rounded to the score dtype first, as the reference does
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).to(sdt) * \
        _scale_in(q.shape[-1], sdt)
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~mask, neg)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v)


def causal_attention(q, k, v, *, q_offset: int = 0,
                     window: Optional[int] = None, chunk: int = 512,
                     scores_f32: bool = True):
    """Query-chunked causal GQA attention.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); H = KV * G.
    Query i has absolute position q_offset + i; key j has position j.
    Each query row depends only on its own chunk's scores, so the
    reference's zero-padding of the last chunk is a no-op here.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    kpos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for c0 in range(0, Sq, chunk):
        qi = qg[:, c0:c0 + chunk]
        qpos = q_offset + c0 + torch.arange(qi.shape[1], device=q.device)
        outs.append(_attend_block(qi, k, v, qpos, kpos, window, scores_f32))
    return torch.cat(outs, 1).reshape(B, Sq, H, hd)


def decode_attention(q, k_cache, v_cache, pos: int, *,
                     window: Optional[int] = None):
    """Single-token attention against a (possibly ring-buffered) K/V
    cache (``layers.py:444-470``).

    q: (B, 1, H, hd); k_cache, v_cache: (B, S, KV, hd); pos: the new
    token's absolute position.  With a window the cache is a ring of S =
    window slots, absolute position j at slot j % S; slot s then holds
    the largest position p <= pos with p % S == s, valid once written (p
    >= 0).  Without one, slots <= pos are valid.  A cache of another
    dtype than q computes in the promoted dtype, as jnp's einsum."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    dt = torch.promote_types(q.dtype, k_cache.dtype)
    qg = q.reshape(B, 1, KV, H // KV, hd).to(dt)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache.to(dt))
    scores = scores.float() * hd ** -0.5
    slot = torch.arange(S, device=q.device)
    if window is None:
        valid = slot <= pos
    else:
        valid = pos - (pos - slot) % S >= 0
    scores = scores.masked_fill(~valid, -1e30)
    w = torch.softmax(scores, -1).to(q.dtype)
    dv = torch.promote_types(w.dtype, v_cache.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(dv), v_cache.to(dv))
    return out.reshape(B, 1, H, hd)
