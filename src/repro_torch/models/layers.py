"""Single-device layers: RMS norm, rotary embedding, query-chunked
causal GQA attention and single-token attention on the dense ring cache
(``repro/models/layers.py``).

Plain torch throughout: the reference leaves these to XLA, the port to
PyTorch's eager kernels.  ``causal_attention`` deliberately does not
call ``scaled_dot_product_attention`` -- it is the same materialized
softmax as the reference, chunked over queries.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    # Rounding order matters for bf16 parity: the variance is taken in
    # f32, rsqrt is cast to x's dtype BEFORE the multiply, then * scale.
    var = x.float().square().mean(-1, keepdim=True)
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
