"""Fused DSC -> int8 wire client step (``repro/kernels/dsc_quantize.py``).

    v    = (g - s) * mask / p            mask ~ Bernoulli(p)
    q, c = int8_quantize(v)              per-256-block stochastic round
    s'   = s + gamma * q * c             the shift tracks the WIRE value

:func:`dsc_quantize` launches the hand-written CUDA kernel
``csrc/dsc_quantize.cu`` on CUDA tensors; its design and its bound are set
out in that file.  On CPU tensors it computes
:func:`~repro_torch.kernels.ref.dsc_quantize_ref`, and only there.  On
meta tensors it allocates its outputs and launches nothing; on the card
and on meta it declares its work to an active
``launch.accounting.Account``.
``dsc_quantize.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.launch import accounting
from repro_torch.kernels.dsc_update import (aligned, check_scalars,
                                            check_vectors)
from repro_torch.kernels.quantize import padded
from repro_torch.kernels.ref import QBLOCK, dsc_quantize_ref

_ARGS = ([ctypes.c_void_p] * 5
         + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_ulonglong,
            ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def dsc_quantize(g: torch.Tensor, s: torch.Tensor, seed_mask: int,
                 seed_round: int, *, p: float, gamma: float,
                 index_base: int = 0, out: Optional[torch.Tensor] = None):
    """One client's fused shifted-compression step onto the int8 wire.

    g: (n,) f32 or bf16; s: (n,) f32; seeds: uint32.  ``index_base`` is
    the client's offset in the reference's flattened (K, n_pad) block:
    ``k * n_pad`` with n_pad = n rounded up to 256.  s' is written into
    ``out`` when given; ``out=s`` updates the shift IN PLACE (the kernel
    reads each coordinate of s before the same lane writes it), which is
    how the round keeps one f32 vector per client and no second copy.
    Returns (q int8 (n_pad,), scales f32 (n_pad / 256,), s' f32 (n,))."""
    check_scalars("dsc_quantize", p, index_base, seed_mask, seed_round)
    if g.device.type == "cpu":
        check_vectors("dsc_quantize", g, s, out)
        q, scales, s_new = dsc_quantize_ref(
            g, s, int(seed_mask), int(seed_round), p=p, gamma=gamma,
            index_base=index_base)
        return q, scales, (s_new if out is None else out.copy_(s_new))
    if g.device.type not in ("cuda", "meta"):
        raise ValueError(f"dsc_quantize: no kernel for {g.device}")
    check_vectors("dsc_quantize", g, s, out)
    n = g.numel()
    nb = padded(n) // QBLOCK
    q = torch.empty(nb * QBLOCK, dtype=torch.int8, device=g.device)
    scales = torch.empty(nb, dtype=torch.float32, device=g.device)
    s_out = torch.empty_like(s) if out is None else out
    if nb == 0:
        return q, scales, s_out
    accounting.declare("dsc_quantize", (g, s), (q, scales, s_out))
    if g.device.type == "meta":
        return q, scales, s_out
    with torch.cuda.device(g.device):
        err = _build.bind("dsc_quantize", "dsc_quantize_launch", _ARGS)(
            g.data_ptr(), s.data_ptr(), q.data_ptr(), scales.data_ptr(),
            s_out.data_ptr(), n, nb, index_base, int(seed_mask),
            int(seed_round), p, 1.0 / p, gamma,
            int(g.dtype == torch.bfloat16), int(aligned(g, s, s_out)),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error("dsc_quantize", err)
    dsc_quantize.launches += 1
    return q, scales, s_out


dsc_quantize.launches = 0
