"""Recurrent sequence mixers: the selective SSM (mamba-style, hymba's
parallel heads) and the mLSTM (the xLSTM family)
(``repro/models/ssm.py``).

Training and prefill run the chunked parallel forms: a loop over time
chunks, each chunk's body under ``torch.utils.checkpoint`` as the
reference wraps it in ``jax.checkpoint`` (the backward recomputes a
chunk's scan from its inputs; without it, a 1 x 2048 hymba gradient at
full width would keep ~75 GB of scan temporaries).  Decode runs the O(1)
recurrent step.  Plain torch throughout: the reference computes these
in ``jnp``, with no Pallas kernel.

The reference's arithmetic is kept where it decides a value: the
within-chunk scan combines its elements in ``jax.lax.associative_scan``'s
tree (:func:`associative_scan`), in the element dtype (bf16 under
``scan_f32=False``); the mLSTM logits round in the input dtype before the
f32 cast; the cumulative log forget gate is summed in XLA's CPU order
(``random.cumsum``).  ``dt * u`` is taken in f32: the product of two
bf16 values is exact there, and XLA's CPU build folds away the bf16
rounding that the source writes before its f32 cast.  With these, a
bf16 scan and a bf16 mLSTM equal the reference's on the CPU bit for bit;
in f32, torch's softplus, log-sigmoid and sums differ from XLA's in the
last bits, so the port agrees to a stated tolerance.
"""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import random
from repro_torch.launch import accounting


# ------------------------------------------------------ associative scan
def associative_scan(fn: Callable, elems: List[torch.Tensor],
                     axis: int) -> List[torch.Tensor]:
    """``jax.lax.associative_scan(fn, elems, axis=axis)`` for a list of
    tensors, in jax's own recursion (``lax/control_flow/loops.py``,
    ``_scan``): combine adjacent pairs, scan the half-length sequence,
    combine its results with the even elements, interleave.  The
    elements are combined in the same tree as the reference's, so each
    output is the same sum of the same products.  ``fn(a, b)`` takes and
    returns lists of tensors."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems

    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start, stop, step)
        return x[tuple(idx)]

    reduced = fn([sl(e, 0, n - 1, 2) for e in elems],
                 [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([sl(o, 0, -1) for o in odd],
                  [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], axis) for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int):
    """a[0], b[0], a[1], b[1], ... along ``axis``; a holds as many
    elements as b or one more."""
    extra = a.shape[axis] - b.shape[axis]
    head = a.narrow(axis, 0, b.shape[axis])
    out = torch.stack([head, b], axis + 1).flatten(axis, axis + 1)
    if extra:
        out = torch.cat([out, a.narrow(axis, b.shape[axis], 1)], axis)
    return out


def _ssm_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return [a2 * a1, a2 * b1 + b2]


# ----------------------------------------------------------- selective SSM
def ssm_scan(u, dt, B, C, A_log, D_skip, *, chunk: int = 128,
             scan_f32: bool = True):
    """Chunked selective state-space scan.

    u: (Bt, T, Di) inputs; dt: (Bt, T, Di) positive step sizes;
    B, C: (Bt, T, N) input/output maps; A_log: (Di, N) (A = -exp(A_log));
    D_skip: (Di,).  h_t = exp(dt A) h_{t-1} + dt * B_t * u_t ;
    y_t = C_t . h_t + D u_t.  Returns (y (Bt, T, Di) in u's dtype,
    h_final (Bt, Di, N) f32)."""
    Bt, T, Di = u.shape
    N = B.shape[-1]
    A = -torch.exp(A_log.float())                                # (Di, N)
    chunk = min(chunk, T)
    n_chunks = -(-T // chunk)
    Tp = n_chunks * chunk
    if Tp != T:
        # dt == 0 makes the padded steps identity transitions (a = 1,
        # b = 0): h_final is exact and the padded y rows are dropped
        u, dt, B, C = (F.pad(x, (0, 0, 0, Tp - T)) for x in (u, dt, B, C))
    el_dtype = torch.float32 if scan_f32 else u.dtype
    h = torch.zeros(Bt, Di, N, dtype=torch.float32, device=u.device)
    ys = []
    for c0 in accounting.trips(range(0, Tp, chunk), u.device):
        inp = [x[:, c0:c0 + chunk] for x in (u, dt, B, C)]
        h, y = _maybe_checkpoint(_ssm_chunk, h, *inp, A, D_skip, el_dtype)
        ys.append(y)
    # a dry run's second trip stands for the rest: their outputs
    ys += [torch.empty_like(y) for _ in range(n_chunks - len(ys))]
    return torch.cat(ys, 1)[:, :T], h


def _ssm_chunk(h, ui, dti, Bi, Ci, A, D_skip, el_dtype):
    """One chunk: the (a, b) pairs, their associative scan, the states
    from the carried h, and the outputs (``ssm.py:47-66``)."""
    a = torch.exp(dti.float()[..., None] * A)                 # (Bt,c,Di,N)
    b = (dti.float() * ui.float())[..., None] * Bi.float()[..., None, :]
    a_cum, b_scan = associative_scan(
        _ssm_combine, [a.to(el_dtype), b.to(el_dtype)], 1)
    hseq = b_scan.float() + a_cum.float() * h[:, None]          # (Bt,c,Di,N)
    y = torch.einsum("bcdn,bcn->bcd", hseq, Ci.float())
    y = y + D_skip.float() * ui.float()
    return hseq[:, -1], y.to(ui.dtype)


def _maybe_checkpoint(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where autograd
    records: the backward recomputes the chunk from its inputs."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def ssm_decode_step(h, u, dt, B, C, A_log, D_skip):
    """One recurrent step.  u/dt: (Bt, Di); B/C: (Bt, N); h: (Bt, Di, N)
    f32.  Returns (h_new, y in u's dtype)."""
    A = -torch.exp(A_log.float())
    a = torch.exp(dt.float()[..., None] * A)
    h_new = a * h + (dt.float() * u.float())[..., None] * \
        B.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h_new, C.float())
    y = y + D_skip.float() * u.float()
    return h_new, y.to(u.dtype)


# ------------------------------------------------------------------- mLSTM
def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -F.softplus(-x)


def _mlstm_decay(i_pre, f_pre):
    """Stabilised decay quantities.  i_pre/f_pre: (B, H, T)
    pre-activations.  Returns (F, b, m): F the cumulative log forget gate,
    b_s = i_s - F_s the log-space key weight, m its running max; the
    weights are exp(b_s - m_t) for s <= t."""
    Fc = random.cumsum(_log_sigmoid(f_pre.float()))           # (B, H, T)
    b = i_pre.float() - Fc
    m = torch.cummax(b, -1).values
    return Fc, b, m


def mlstm_parallel(q, k, v, i_pre, f_pre, *, chunk: int = 512,
                   scores_f32: bool = True):
    """Quadratic (attention-like) stabilised mLSTM forward.

    q, k, v: (B, T, H, hd); i_pre, f_pre: (B, T, H).  Causal weights
    W_ts = exp(b_s - m_t) (q_t . k_s) / sqrt(hd); h_t = sum_s W_ts v_s /
    max(|sum_s W_ts|, 1).  Query-chunked, each chunk under
    ``torch.utils.checkpoint``.

    The weights of the masked pairs (s > t) are zeroed as the
    reference's, and their exponent is masked too: past ~128 steps
    exp(b_s - m_t) overflows there (b grows by -log sigmoid(f) a step),
    and the reference's gradient is NaN (``where``'s zero cotangent
    times inf).  The forward is the reference's bit for bit; so is the
    gradient wherever the reference's is finite."""
    B, T, H, hd = q.shape
    _, b, m = _mlstm_decay(i_pre.transpose(1, 2), f_pre.transpose(1, 2))
    chunk = min(chunk, T)
    outs = []
    for c0 in range(0, T, chunk):
        outs.append(_maybe_checkpoint(_mlstm_chunk, q[:, c0:c0 + chunk], k,
                                      v, b, m, c0, scores_f32))
    return torch.cat(outs, 1)


def _mlstm_chunk(qi, k, v, b, m, c0: int, scores_f32: bool):
    """One query chunk of :func:`mlstm_parallel` (``ssm.py:118-135``)."""
    T, hd = k.shape[1], k.shape[-1]
    qpos = c0 + torch.arange(qi.shape[1], device=qi.device)
    kpos = torch.arange(T, device=qi.device)
    m_q = m[..., qpos]                                          # (B, H, c)
    logits = torch.einsum("bqhd,bshd->bhqs", qi, k).float()
    causal = kpos[None, :] <= qpos[:, None]
    expo = (b[:, :, None, :] - m_q[..., None]).masked_fill(~causal,
                                                           float("-inf"))
    w = logits * hd ** -0.5 * torch.exp(expo)
    w = w.masked_fill(~causal, 0.0)
    den = w.sum(-1).abs()                                       # (B, H, c)
    if not scores_f32:
        # the decay weights are stabilised to <= 1; the denominator
        # above is still summed in f32
        w = w.to(v.dtype)
    num = torch.einsum("bhqs,bshd->bqhd", w, v.to(w.dtype)).float()
    h = num / torch.clamp_min(den, 1.0)[..., None].transpose(1, 2)
    return h.to(qi.dtype)


def mlstm_decode_step(state: dict, q, k, v, i_pre, f_pre):
    """Recurrent mLSTM step.

    state: dict(C (B, H, hd, hd), n (B, H, hd), m (B, H)), f32; q, k, v:
    (B, H, hd); i_pre, f_pre: (B, H).  From the initial m = -1e30 the
    decay exp(logf + m - m_new) is exactly 0.  Returns (new state, h in
    q's dtype)."""
    C, n, m = state["C"], state["n"], state["m"]
    hd = q.shape[-1]
    logf = _log_sigmoid(f_pre.float())
    i32 = i_pre.float()
    m_new = torch.maximum(logf + m, i32)
    f_eff = torch.exp(logf + m - m_new)                         # (B, H)
    i_eff = torch.exp(i32 - m_new)
    kf, vf = k.float(), v.float()
    C_new = f_eff[..., None, None] * C + \
        i_eff[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n_new = f_eff[..., None] * n + i_eff[..., None] * kf
    qf = q.float() * hd ** -0.5
    num = torch.einsum("bhd,bhde->bhe", qf, C_new)
    den = torch.einsum("bhd,bhd->bh", qf, n_new).abs()
    h = num / torch.clamp_min(den, 1.0)[..., None]
    return {"C": C_new, "n": n_new, "m": m_new}, h.to(q.dtype)
