"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
torch version: paged decode attention, the four wire kernels (DSC update,
int8 quantize and dequantize, the fused DSC quantize) and flash attention
for training (forward, dq, dk/dv) -- a counterpart for every Pallas
kernel of ``repro/kernels``."""
