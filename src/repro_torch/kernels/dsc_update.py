"""Fused DSC client update (``repro/kernels/dsc_update.py``).

    v  = (g - s) * mask / p     (mask ~ Bernoulli(p), counter-based RNG)
    s' = s + gamma * v

:func:`dsc_update` launches the hand-written CUDA kernel
``csrc/dsc_update.cu`` on CUDA tensors; its design and its bound are set
out in that file.  On CPU tensors it computes
:func:`~repro_torch.kernels.ref.dsc_update_ref`, and only there: on a CUDA
tensor it launches the kernel or raises.  On meta tensors it allocates its
outputs and launches nothing; on the card and on meta it declares its
work to an active ``launch.accounting.Account``.  ``dsc_update.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.launch import accounting
from repro_torch.kernels.ref import dsc_update_ref

# The reference pads each client row to this many coordinates before the
# kernel (``DSCCompress._compress_pallas``), so client k's draws start at
# index k * n_pad with n_pad = n rounded up to LANES.
LANES = 1024
_U32 = 1 << 32
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_ulonglong,
                                  ctypes.c_uint, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])


def check_vectors(op: str, g: torch.Tensor, s: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> None:
    """What the wire kernels take: 1-D contiguous g (f32 or bf16) and f32
    s (and out) of g's length, all on one device."""
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{op}: g must be float32 or bfloat16, got {g.dtype}")
    for name, t in (("g", g), ("s", s), ("out", out)):
        if t is None:
            continue
        if t.device != g.device:
            raise ValueError(f"{op}: {name} is on {t.device}, g on "
                             f"{g.device}")
        if t.dim() != 1 or t.shape != g.shape or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous vector of "
                             f"{g.numel()}, got {tuple(t.shape)}")
        if name != "g" and t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} must be float32, got {t.dtype}")


def check_scalars(op: str, p: float, index_base: int, *seeds: int) -> None:
    if not 0.0 < p <= 1.0:
        raise ValueError(f"{op}: p must be in (0, 1], got {p}")
    if index_base < 0:
        raise ValueError(f"{op}: index_base must be >= 0, got {index_base}")
    for seed in seeds:
        if not 0 <= int(seed) < _U32:
            raise ValueError(f"{op}: seed {seed} is not a uint32")


def aligned(*tensors: torch.Tensor) -> bool:
    """Every pointer on a 16-byte boundary: the kernels' vector loads."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def dsc_update(g: torch.Tensor, s: torch.Tensor, seed: int, *, p: float,
               gamma: float, index_base: int = 0,
               out: Optional[torch.Tensor] = None):
    """One client's shifted RandP step.

    g: (n,) f32 or bf16 gradient; s: (n,) f32 shift; seed: uint32.
    ``index_base`` is the client's offset in the reference's flattened
    (K, n_pad) block: pass ``k * n_pad`` with ``n_pad`` = n rounded up to
    :data:`LANES`.  s' goes into ``out`` when given; ``out=s`` updates the
    shift in place, which the kernel allows (each coordinate is read before
    it is written, by the same thread).  Returns (v in g's dtype, s')."""
    check_scalars("dsc_update", p, index_base, seed)
    if g.device.type == "cpu":
        check_vectors("dsc_update", g, s, out)
        v, s_new = dsc_update_ref(g, s, int(seed), p=p, gamma=gamma,
                                  index_base=index_base)
        return v, (s_new if out is None else out.copy_(s_new))
    if g.device.type not in ("cuda", "meta"):
        raise ValueError(f"dsc_update: no kernel for {g.device}")
    check_vectors("dsc_update", g, s, out)
    v = torch.empty_like(g)
    s_out = torch.empty_like(s) if out is None else out
    if g.numel() == 0:
        return v, s_out
    accounting.declare("dsc_update", (g, s), (v, s_out))
    if g.device.type == "meta":
        return v, s_out
    with torch.cuda.device(g.device):
        err = _build.bind("dsc_update", "dsc_update_launch", _ARGS)(
            g.data_ptr(), s.data_ptr(), v.data_ptr(), s_out.data_ptr(),
            g.numel(), index_base, int(seed), p, 1.0 / p, gamma,
            int(g.dtype == torch.bfloat16), int(aligned(g, s, v, s_out)),
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error("dsc_update", err)
    dsc_update.launches += 1
    return v, s_out


dsc_update.launches = 0
