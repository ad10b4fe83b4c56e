"""Plain torch versions of the kernels (``repro/kernels/ref.py``): the
wire kernels and the flash-attention forward and backward.

Each computes what its CUDA kernel computes, on any device, and is what
the kernel's wrapper runs for a CPU tensor.  The flash-attention plain
versions follow the Pallas kernels' blocked arithmetic (the section at
the end); :func:`flash_attention_ref` is the reference's naive oracle.
The wire plain versions follow the Pallas kernels, not the reference's
jnp oracles, in the two places where those differ:

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

import ctypes
import ctypes.util
import functools
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


@functools.lru_cache(maxsize=None)
def _libm_powf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).powf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float] * 2
    return fn


def powf(base: float, exp: float) -> float:
    """f32 ``base ** exp`` as XLA's CPU ``pow`` computes it: the C
    library's ``powf``."""
    return _libm_powf()(float(np.float32(base)), float(np.float32(exp)))


def fma_f32(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``f32(a) * b + c`` for f32 tensors b, c (and a float or an f32
    tensor a), rounded once to f32 as a fused multiply-add rounds it.  The
    product is exact in double (24 + 24 bits); the sum is taken in double
    rounded to odd (TwoSum for the error, then a nudge to the odd
    neighbour when inexact), and rounding that to f32 is the single
    rounding of the exact value."""
    a = a.double() if isinstance(a, torch.Tensor) else float(np.float32(a))
    prod = b.double() * a
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


# -------------------------------------------------------- flash attention
# ``repro/kernels/flash_attention.py``: blocks of 128 clamped to S, masks
# at -1e30, q scaled by f32(d**-0.5) as it is loaded, everything in f32.
FLASH_BLOCK = 128
NEG_INF = -1e30


def _flash_mask(s, qpos, kpos, causal, window):
    """Causal and/or window mask of score tiles (..., bq, bk) whose rows
    sit at ``qpos`` (..., bq) and columns at ``kpos`` (..., bk)."""
    if not causal and window is None:
        return s
    q, k = qpos[..., :, None], kpos[..., None, :]
    ok = k <= q if causal else torch.ones_like(k <= q)
    if window is not None:
        ok = ok & (k > q - window)
    return torch.where(ok, s, NEG_INF)


def _flash_split(q, k, block_q, block_k):
    B, H, S, d = q.shape
    KV = k.shape[1]
    if k.shape != (B, KV, S, d) or H % KV:
        raise ValueError(f"flash attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} are not (B, H, S, d) and "
                         f"(B, KV, S, d) with H % KV == 0")
    bq, bk = min(block_q, S), min(block_k, S)
    if S % bq or S % bk:
        raise ValueError(f"flash attention: blocks {bq}, {bk} do not tile "
                         f"S = {S}")
    return B, H, KV, H // KV, S, d, bq, bk, float(np.float32(d ** -0.5))


def flash_fwd_ref(q, k, v, *, causal: bool = True, window=None,
                  block_q: int = FLASH_BLOCK, block_k: int = FLASH_BLOCK):
    """The forward kernel's online softmax over k-blocks, every q-block at
    once.  q: (B, H, S, d); k, v: (B, KV, S, d).  Returns (o in q's dtype,
    lse (B*H, S) f32).  It visits every k-block where the kernel stops at
    the diagonal and starts at the window: a block past the diagonal adds
    exact zeros, and a fully masked block before the first visible one is
    cleared exactly by the next block's alpha = exp(-1e30 - m) = 0."""
    B, H, KV, G, S, d, bq, bk, scale = _flash_split(q, k, block_q, block_k)
    nq = S // bq
    qs = (q.float() * scale).reshape(B, KV, G, nq, bq, d)
    kf = k.float()[:, :, None, None]                  # (B, KV, 1, 1, S, d)
    vf = v.float()[:, :, None, None]
    qpos = torch.arange(S, device=q.device).reshape(nq, bq)
    kpos = torch.arange(S, device=q.device)
    m = torch.full(qs.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qs)
    for k0 in range(0, S, bk):
        s = qs @ kf[..., k0:k0 + bk, :].transpose(-1, -2)
        s = _flash_mask(s, qpos, kpos[k0:k0 + bk], causal, window)
        m_cur = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vf[..., k0:k0 + bk, :]
        m = m_cur
    l_safe = l.clamp_min(1e-30)
    o = (acc / l_safe[..., None]).reshape(B, H, S, d).to(q.dtype)
    return o, (m + torch.log(l_safe)).reshape(B * H, S)


def flash_delta(o, do):
    """delta = rowsum(do * o) in f32, (B*H, S): computed outside the
    kernels, from o as saved in q's dtype (``flash_attention.py:221``)."""
    B, H, S, _ = o.shape
    return (do.float() * o.float()).sum(-1).reshape(B * H, S)


def _flash_bwd_inputs(q, k, v, do, lse, delta, block_q, block_k):
    B, H, KV, G, S, d, bq, bk, scale = _flash_split(q, k, block_q, block_k)
    qs = (q.float() * scale).reshape(B, KV, G, S, d)
    dof = do.float().reshape(B, KV, G, S, d)
    return (B, H, KV, G, S, d, bq, bk, scale, qs, dof,
            lse.reshape(B, KV, G, S), delta.reshape(B, KV, G, S))


def flash_dq_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                 window=None, block_q: int = FLASH_BLOCK,
                 block_k: int = FLASH_BLOCK):
    """The dq kernel: p = exp(s - lse), ds = p * (do v^T - delta), dq =
    scale * sum over k-blocks of ds k, in q's dtype.  Blocks the kernel
    skips have p = 0 exactly and add nothing."""
    (B, H, KV, G, S, d, bq, bk, scale, qs, dof, lse,
     delta) = _flash_bwd_inputs(q, k, v, do, lse, delta, block_q, block_k)
    nq = S // bq
    qs, dof = qs.reshape(B, KV, G, nq, bq, d), dof.reshape(B, KV, G, nq, bq, d)
    lse, delta = lse.reshape(B, KV, G, nq, bq), delta.reshape(B, KV, G, nq, bq)
    kf = k.float()[:, :, None, None]
    vf = v.float()[:, :, None, None]
    qpos = torch.arange(S, device=q.device).reshape(nq, bq)
    kpos = torch.arange(S, device=q.device)
    dq = torch.zeros_like(qs)
    for k0 in range(0, S, bk):
        kb, vb = kf[..., k0:k0 + bk, :], vf[..., k0:k0 + bk, :]
        s = _flash_mask(qs @ kb.transpose(-1, -2), qpos, kpos[k0:k0 + bk],
                        causal, window)
        p = torch.exp(s - lse[..., None])
        ds = p * (dof @ vb.transpose(-1, -2) - delta[..., None])
        dq = dq + ds @ kb
    return (dq * scale).reshape(B, H, S, d).to(q.dtype)


def flash_dkv_ref(q, k, v, do, lse, delta, *, causal: bool = True,
                  window=None, block_q: int = FLASH_BLOCK,
                  block_k: int = FLASH_BLOCK):
    """The dk/dv kernel: per query head, dv = sum p^T do and dk = sum
    ds^T q_hat (q_hat already scaled) over q-blocks, in f32; then the sum
    over the G heads of each group, still in f32, and one cast to k's and
    v's dtypes (``flash_attention.py:263-265``)."""
    (B, H, KV, G, S, d, bq, bk, scale, qs, dof, lse,
     delta) = _flash_bwd_inputs(q, k, v, do, lse, delta, block_q, block_k)
    nk = S // bk
    kf = k.float().reshape(B, KV, 1, nk, bk, d)
    vf = v.float().reshape(B, KV, 1, nk, bk, d)
    kpos = torch.arange(S, device=q.device).reshape(nk, bk)
    qpos = torch.arange(S, device=q.device)
    dk = torch.zeros(B, KV, G, nk, bk, d, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, S, bq):
        qb = qs[:, :, :, None, q0:q0 + bq]            # (B, KV, G, 1, bq, d)
        dob = dof[:, :, :, None, q0:q0 + bq]
        lb = lse[:, :, :, None, q0:q0 + bq, None]
        db = delta[:, :, :, None, q0:q0 + bq, None]
        s = qb @ kf.transpose(-1, -2)                 # (B, KV, G, nk, bq, bk)
        s = _flash_mask(s, qpos[q0:q0 + bq].expand(nk, bq), kpos, causal,
                        window)
        p = torch.exp(s - lb)
        dv = dv + p.transpose(-1, -2) @ dob
        ds = p * (dob @ vf.transpose(-1, -2) - db)
        dk = dk + ds.transpose(-1, -2) @ qb
    dk = dk.sum(2).reshape(B, KV, S, d).to(k.dtype)
    dv = dv.sum(2).reshape(B, KV, S, d).to(v.dtype)
    return dk, dv


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """The reference's naive oracle (``repro/kernels/ref.py:78``): the
    whole (Sq, Skv) score matrix in f32 and one softmax.  q: (B, H, Sq, d);
    k, v: (B, KV, Skv, d); differentiable by autograd."""
    B, H, Sq, d = q.shape
    KV, Skv = k.shape[1], k.shape[2]
    qg = q.reshape(B, KV, H // KV, Sq, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qg, k).float() * (d ** -0.5)
    if causal or window is not None:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = kpos <= qpos if causal else torch.ones(Sq, Skv, dtype=torch.bool,
                                                      device=q.device)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        scores = scores.masked_fill(~mask, -torch.inf)
    w = torch.softmax(scores, -1)
    return torch.einsum("bkgqs,bksd->bkgqd", w, v.float()).reshape(
        B, H, Sq, d).to(q.dtype)
