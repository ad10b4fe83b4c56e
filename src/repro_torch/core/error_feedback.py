"""Error feedback (EF21-style) for BIASED compressors
(``repro/core/error_feedback.py``).

DSC needs unbiased omega-compressors (Def. 3.1); top-k is biased and does
not converge alone.  Error feedback keeps each client's compression
residual e_k and transmits C(g_k + e_k) (Karimireddy et al. 2019).  It
changes only the vector that FSA shards, so it composes with FSA as DSC
does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random
from repro_torch.core.compressors import Compressor, Int8RoundTrip
from repro_torch.kernels import quantize as q_kernel
from repro_torch.kernels.ref import fma_f32


class EFState(NamedTuple):
    e: torch.Tensor     # (K, n) per-client residual memory


def init_state(K: int, n: int, device=None) -> EFState:
    return EFState(torch.zeros((K, n), dtype=torch.float32, device=device))


def compress_client(e: torch.Tensor, g: torch.Tensor,
                    compressor: Compressor, key: torch.Tensor
                    ) -> torch.Tensor:
    """One client: v = C(g + e) with the client's key; e <- g + e - v IN
    PLACE.  Returns v.  On the int8 wire the reference's jitted round
    fuses the dequantizing multiply into the residual, e = target -
    q * scale rounded once, and so does this."""
    target = g.float() + e
    if not isinstance(compressor, Int8RoundTrip):
        v = compressor(key, target)
        e.copy_(target - v)
        return v
    n = target.numel()
    q, scales = compressor.codes(key, target)
    v = q_kernel.dequantize(q, scales)[:n]
    step = scales.repeat_interleave(q_kernel.QBLOCK)[:n]
    e.copy_(fma_f32(-step, q[:n].float(), target))
    return v


def client_compress(state: EFState, grads: torch.Tensor,
                    compressor: Compressor, key: torch.Tensor
                    ) -> tuple[torch.Tensor, EFState]:
    """All clients, as the reference: client k compresses with
    ``split(key, K)[k]``.  Returns (v (K, n), the state, its residuals
    updated in place)."""
    K = grads.shape[0]
    keys = random.split(key, K)
    v = torch.stack([compress_client(state.e[k], grads[k], compressor,
                                     keys[k]) for k in range(K)])
    return v, state
