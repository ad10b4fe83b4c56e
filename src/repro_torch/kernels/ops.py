"""Public wrappers of the port's kernels (``repro/kernels/ops.py``).

Each launches its CUDA kernel on a CUDA tensor and computes its plain
torch version on a CPU tensor; nothing falls back.  The reference's jit
and interpret-mode plumbing has no counterpart: PyTorch runs eagerly.
"""
from repro_torch.kernels.dsc_quantize import dsc_quantize
from repro_torch.kernels.dsc_update import dsc_update
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.quantize import dequantize, quantize

__all__ = ["dsc_quantize", "dsc_update", "dequantize", "flash_attention",
           "paged_attention", "quantize"]
