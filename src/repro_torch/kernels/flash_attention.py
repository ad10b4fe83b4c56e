"""Flash attention for training, forward and backward
(``repro/kernels/flash_attention.py``).

:func:`flash_attention` is differentiable: its forward saves (q, k, v, o,
lse) and its backward computes delta = rowsum(do * o) as one torch
expression, as the reference does outside its kernels, then the dq and
the dk/dv kernels.  The three kernel wrappers, :func:`flash_fwd`,
:func:`flash_dq` and :func:`flash_dkv`, launch the hand-written CUDA
kernels on CUDA tensors, all on the tensor cores: in bf16 the forward
from ``csrc/flash_fwd_sm90.cu`` and dq and dk/dv from
``csrc/flash_bwd_sm90.cu``; in f32 all three at f32 accuracy (3xTF32)
from ``csrc/flash_f32_sm90.cu``.  Their designs and bounds are set out in
those files.  On CPU tensors they compute the plain versions in
``kernels/ref.py``, and only there: on a CUDA tensor they launch a kernel
or raise.  ``flash_fwd.launches``, ``flash_dq.launches`` and
``flash_dkv.launches`` count the kernels' launches, their
``tensor_core_launches`` the bf16 ones among them and their
``f32_tensor_core_launches`` the f32 ones.

Layout is the reference's, q (B, H, S, d) and k, v (B, KV, S, d), with
any strides so long as d is contiguous: the model hands over transposed
views of its (B, S, H, d) projections and the kernels read them in
place, without a copy.  Outputs take their input's strides
(``torch.empty_like``), so o comes back as a view of a contiguous
(B, S, H, d) tensor.  The kernels copy rows with 16-byte asynchronous
copies, so every row must start on 16 bytes (base address and the b, h
and s strides); the model's views do.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (FLASH_BLOCK, flash_delta, flash_dkv_ref,
                                     flash_dq_ref, flash_fwd_ref)

BLOCK_Q = BLOCK_K = FLASH_BLOCK
HEAD_DIMS = (16, 32, 64, 128)         # the head dims the CUDA kernels take
_DTYPES = (torch.float32, torch.bfloat16)
_P, _I = ctypes.c_void_p, ctypes.c_int
_MASK = [_I] * 5 + [ctypes.c_float, _I, _I]    # B H KV S d scale causal window
# symbol: (source, argument types); the bf16 dk/dv ends (partial, stream),
# the others (stream)
_ARGS = {"flash_fwd_sm90_launch": ("flash_fwd_sm90", [_P] * 6 + _MASK + [_P]),
         "flash_fwd_f32_sm90_launch": ("flash_f32_sm90",
                                       [_P] * 6 + _MASK + [_P]),
         "flash_dq_f32_sm90_launch": ("flash_f32_sm90",
                                      [_P] * 8 + _MASK + [_P]),
         "flash_dkv_f32_sm90_launch": ("flash_f32_sm90",
                                       [_P] * 9 + _MASK + [_P]),
         "flash_dq_sm90_launch": ("flash_bwd_sm90", [_P] * 8 + _MASK + [_P]),
         "flash_dkv_sm90_launch": ("flash_bwd_sm90",
                                   [_P] * 9 + _MASK + [_I, _P])}


def supports(S: int, d: int, block_q: int = BLOCK_Q,
             block_k: int = BLOCK_K) -> bool:
    """The reference's shape gate for its training integration: the
    (possibly clamped) blocks tile S exactly."""
    bq, bk = min(block_q, S), min(block_k, S)
    return S % bq == 0 and S % bk == 0


def _check(op: str, q, k, v, window, **more) -> None:
    """Shapes, devices and the mask, on any device; dtypes and the head
    dim only where a kernel will run."""
    tensors = dict(q=q, k=k, v=v, **more)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{op}: {name} is on {t.device}, q on "
                             f"{q.device}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{op}: want q (B, H, S, d) and k, v (B, KV, S, "
                         f"d), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, d = q.shape
    if k.shape[0] != B or k.shape[2:] != (S, d) or H % k.shape[1]:
        raise ValueError(f"{op}: k and v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (self-attention, H % KV == 0)")
    if window is not None and window < 1:
        raise ValueError(f"{op}: window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for {q.device}")
    for name, t in tensors.items():
        want = torch.float32 if name in ("lse", "delta") else q.dtype
        if t.dtype != want or (name == "q" and t.dtype not in _DTYPES):
            raise TypeError(f"{op}: q must be float32 or bfloat16 and every "
                            f"tensor but lse and delta of q's dtype, float32 "
                            f"for those; got {name} {t.dtype} with q "
                            f"{q.dtype}")
        if name in ("lse", "delta"):
            if t.shape != (B * H, S) or not t.is_contiguous():
                raise ValueError(f"{op}: {name} must be contiguous "
                                 f"(B * H, S), got {tuple(t.shape)}")
        elif t.stride(-1) != 1:
            raise ValueError(f"{op}: {name} must have a contiguous last dim, "
                             f"got strides {t.stride()}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{op}: the CUDA kernels take head dims "
                         f"{HEAD_DIMS}, got {d}")
    if B * H > 65535:
        raise ValueError(f"{op}: B * H = {B * H} beyond the kernels' grid")


def _aligned(t) -> bool:
    """Every (b, h, s) row of ``t`` starts on 16 bytes."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % step == 0
                                           for s in t.stride()[:3])


def _check_async_copies(op: str, **tensors) -> None:
    """The kernels copy 16-byte chunks of rows: raise on a row that does
    not start on 16 bytes (never fall back)."""
    for name, t in tensors.items():
        if not _aligned(t):
            raise ValueError(f"{op}: {name}'s rows must start on 16 bytes "
                             f"for the tensor-core kernel (base address and "
                             f"the b, h, s strides), got address "
                             f"{t.data_ptr()} and strides {t.stride()}")


def group_sum(partial: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The per-query-head f32 partials (B, H, S, d) summed over each group
    of H / KV heads in f32 and cast once into ``out`` (B, KV, S, d), as
    the reference sums after its dk/dv kernel (``flash_attention.py:264``)."""
    B, H, S, d = partial.shape
    KV = out.shape[1]
    return out.copy_(partial.view(B, KV, H // KV, S, d).sum(2))


def _strides(*tensors) -> ctypes.Array:
    """(b, h, s) element strides of each tensor, as one long long array."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(symbol: str, pointers, strides, q, k, causal, window,
            *flags) -> None:
    B, H, S, d = q.shape
    source, argtypes = _ARGS[symbol]
    with torch.cuda.device(q.device):
        err = _build.bind(source, symbol, argtypes)(
            *pointers, strides, B, H, k.shape[1], S, d, d ** -0.5,
            int(causal), -1 if window is None else int(window), *flags,
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error(source, err)


def flash_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """The forward kernel, on the tensor cores (f32 by 3xTF32).  Returns
    (o in q's dtype and strides, lse (B * H, S) f32)."""
    _check("flash_fwd", q, k, v, window)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, window=window)
    bf16 = q.dtype == torch.bfloat16
    _check_async_copies("flash_fwd", q=q, k=k, v=v)
    B, H, S, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=q.device)
    if o.numel():
        pointers = [t.data_ptr() for t in (q, k, v, o, lse)]
        strides = _strides(q, k, v, o)
        if bf16:
            _launch("flash_fwd_sm90_launch", pointers, strides, q, k, causal,
                    window)
            flash_fwd.tensor_core_launches += 1
        else:
            _launch("flash_fwd_f32_sm90_launch", pointers, strides, q, k,
                    causal, window)
            flash_fwd.f32_tensor_core_launches += 1
        flash_fwd.launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = True,
             window: Optional[int] = None):
    """The dq kernel, on the tensor cores (f32 by 3xTF32).  Returns dq in
    q's dtype and strides."""
    _check("flash_dq", q, k, v, window, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_dq_ref(q, k, v, do, lse, delta, causal=causal,
                            window=window)
    bf16 = q.dtype == torch.bfloat16
    _check_async_copies("flash_dq", q=q, k=k, v=v, do=do)
    dq = torch.empty_like(q)
    if dq.numel():
        pointers = [t.data_ptr() for t in (q, k, v, do, lse, delta, dq)]
        strides = _strides(q, k, v, do, dq)
        if bf16:
            _launch("flash_dq_sm90_launch", pointers, strides, q, k, causal,
                    window)
            flash_dq.tensor_core_launches += 1
        else:
            _launch("flash_dq_f32_sm90_launch", pointers, strides, q, k,
                    causal, window)
            flash_dq.f32_tensor_core_launches += 1
        flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
              window: Optional[int] = None):
    """The dk/dv kernel, the sum over each group's query heads included,
    on the tensor cores (bf16: a block per query head; with G > 1 query
    heads a kv head it writes f32 partials that :func:`group_sum` adds up;
    f32, by 3xTF32: a block per kv head, summing the group in registers).
    Returns (dk, dv) in k's and v's dtype and strides."""
    _check("flash_dkv", q, k, v, window, do=do, lse=lse, delta=delta)
    if q.device.type == "cpu":
        return flash_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                             window=window)
    bf16 = q.dtype == torch.bfloat16
    _check_async_copies("flash_dkv", q=q, k=k, v=v, do=do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        outs = (dk, dv)
        partial = bf16 and k.shape[1] != q.shape[1]
        if partial:                     # G > 1: per query head, in f32
            outs = torch.empty((2, *q.shape), dtype=torch.float32,
                               device=q.device)
        pointers = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)]
        strides = _strides(q, k, v, do, dk, dv)
        if bf16:
            _launch("flash_dkv_sm90_launch", pointers, strides, q, k, causal,
                    window, int(partial))
            if partial:
                group_sum(outs[0], dk)
                group_sum(outs[1], dv)
            flash_dkv.tensor_core_launches += 1
        else:
            _launch("flash_dkv_f32_sm90_launch", pointers, strides, q, k,
                    causal, window)
            flash_dkv.f32_tensor_core_launches += 1
        flash_dkv.launches += 1
    return dk, dv


for _fn in (flash_fwd, flash_dq, flash_dkv):
    _fn.launches = _fn.tensor_core_launches = _fn.f32_tensor_core_launches = 0


class _FlashAttention(torch.autograd.Function):
    """The reference's custom VJP: forward kernel, then delta, dq and
    dk/dv from the saved (q, k, v, o, lse).  The backward's kernels
    record no graph, so it is once differentiable on every device: a
    ``create_graph=True`` backward through it (the first half of a
    second derivative, as DLG takes) raises, on the host's plain
    versions as on the card, rather than drop attention's share of the
    second derivative in silence."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        # create_graph=True runs the backward with grad mode on; the
        # graph it asks for would miss the kernels' second derivative.
        # once_differentiable alone would not say so: its error node is
        # pruned when no path from it reaches the inputs asked for.
        if torch.is_grad_enabled():
            raise RuntimeError(
                "flash_attention is once differentiable: its backward "
                "kernels record no graph, so a create_graph=True backward "
                "(a second derivative, as gradient inversion takes) cannot "
                "go through them; run that model with "
                "cfg.flash_attention=False (the plain chunked attention)")
        return _FlashAttention._backward(ctx, do)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def _backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window = ctx.mask
        # e.g. the expanded grad of a sum, or rows off 16 bytes
        if do.stride(-1) != 1 or (do.is_cuda and not _aligned(do)):
            do = do.contiguous()
        delta = flash_delta(o, do)
        dq = flash_dq(q, k, v, do, lse, delta, causal=causal, window=window)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, causal=causal,
                           window=window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, d); k, v: (B, KV, S, d) with H % KV == 0 (GQA).
    Returns o (B, H, S, d) in q's dtype.  A window implies causal masking.
    Differentiable; without a gradient to take (``torch.no_grad`` or no
    input that requires one) only the forward kernel runs and nothing is
    saved."""
    if window is not None and not causal:
        raise ValueError("flash_attention: a sliding window implies causal "
                         "masking")
    window = None if window is None else int(window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), window)
    return flash_fwd(q, k, v, causal=causal, window=window)[0]
