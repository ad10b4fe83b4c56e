"""Per-block stochastic int8 (de)quantization (``repro/kernels/quantize.py``).

The beyond-paper wire format: 1 byte a coordinate plus one f32 scale per
256, about 1.02 B a coordinate against 2 (bf16) or 4 (f32).  Unbiased
(stochastic rounding), so it composes with DSC as an omega-compressor.

:func:`quantize` and :func:`dequantize` launch the hand-written CUDA
kernels of ``csrc/quantize.cu`` on CUDA tensors; their design and bound
are set out in that file.  On CPU tensors they compute the plain versions
in ``kernels/ref.py``, and only there.  On meta tensors they allocate
their outputs and launch nothing; on the card and on meta they declare
their work to an active ``launch.accounting.Account``.
``quantize.launches`` and
``dequantize.launches`` count the kernels' launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.launch import accounting
from repro_torch.kernels.dsc_update import aligned, check_scalars
from repro_torch.kernels.ref import QBLOCK, dequantize_ref, quantize_ref

_QUANT_ARGS = ([ctypes.c_void_p] * 3
               + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_ulonglong,
                  ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
_DEQUANT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]


def padded(n: int, unit: int = QBLOCK) -> int:
    """n rounded up to whole units: whole quant blocks by default, the
    wire layout's length."""
    return -(-n // unit) * unit


def wire_payload_bytes(n: int, *, block: int = QBLOCK) -> int:
    """Exact bytes of the quantized wire payload for an n-coordinate
    vector: one int8 per (block-padded) coordinate plus one f32 scale per
    block."""
    padded_n = padded(n, block)
    return padded_n + 4 * (padded_n // block)


def quantize(x: torch.Tensor, seed: int, *, index_base: int = 0):
    """x: (n,) f32 or bf16; seed: uint32.  A ragged n zero-pads to whole
    blocks (zeros quantize to 0 and never move a scale).  Draws are keyed
    on ``index_base + i``: a caller that quantizes client k of a padded
    (K, n_pad) block alone passes ``k * n_pad``.  Returns (q int8
    (n_pad,), scales f32 (n_pad / 256,))."""
    check_scalars("quantize", 1.0, index_base, seed)
    if x.device.type == "cpu":
        return quantize_ref(x, int(seed), index_base=index_base)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"quantize: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"quantize: x must be a contiguous vector, got "
                         f"{tuple(x.shape)}")
    n = x.numel()
    nb = padded(n) // QBLOCK
    q = torch.empty(nb * QBLOCK, dtype=torch.int8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    if nb == 0:
        return q, scales
    accounting.declare("quantize", (x,), (q, scales))
    if x.device.type == "meta":
        return q, scales
    with torch.cuda.device(x.device):
        err = _build.bind("quantize", "quantize_launch", _QUANT_ARGS)(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), n, nb,
            index_base, int(seed), int(x.dtype == torch.bfloat16),
            int(aligned(x)), torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error("quantize", err)
    quantize.launches += 1
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: (n_pad,) int8 with n_pad a multiple of 256; scales: (n_pad /
    256,) f32.  Returns q * scale, f32 (n_pad,)."""
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize: want int8 codes and float32 scales, "
                        f"got {q.dtype} and {scales.dtype}")
    if (q.dim() != 1 or q.numel() % QBLOCK
            or scales.shape != (q.numel() // QBLOCK,)):
        raise ValueError(f"dequantize: want codes (256 * nb,) and scales "
                         f"(nb,), got {tuple(q.shape)} and "
                         f"{tuple(scales.shape)}")
    if q.device.type == "cpu":
        return dequantize_ref(q, scales)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"dequantize: no kernel for {q.device}")
    if scales.device != q.device:
        raise ValueError(f"dequantize: scales on {scales.device}, codes on "
                         f"{q.device}")
    if not (q.is_contiguous() and scales.is_contiguous()
            and q.data_ptr() % 8 == 0):  # meta tensors' pointers are 0
        raise ValueError("dequantize: codes must be contiguous and 8-byte "
                         "aligned, scales contiguous")
    out = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    nb = scales.numel()
    if nb == 0:
        return out
    accounting.declare("dequantize", (q, scales), (out,))
    if q.device.type == "meta":
        return out
    with torch.cuda.device(q.device):
        err = _build.bind("quantize", "dequantize_launch", _DEQUANT_ARGS)(
            q.data_ptr(), scales.data_ptr(), out.data_ptr(), nb,
            torch.cuda.current_stream().cuda_stream)
    _build.raise_on_error("quantize", err)
    dequantize.launches += 1
    return out


quantize.launches = 0
dequantize.launches = 0
