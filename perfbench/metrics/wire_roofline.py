"""wire_roofline: the int8 wire kernels' least time (each launch on a
client's n coordinates with an f32 gradient, ``yardstick.wire_bound_s``,
bytes at the HBM rate) over their time in the profiled rounds, in %.
Kernels: csrc/dsc_quantize.cu and the dequantize kernel of
csrc/quantize.cu."""
from perfbench import yardstick

KERNELS = {"dsc_quantize": "dsc_quantize_kernel",
           "dequantize": "dequantize_kernel"}


def read(ctx):
    prof = ctx.get("profile")
    if not prof:
        return None
    bound = spent = 0.0
    for kernel, symbol in KERNELS.items():
        runs = [b - a for name, a, b in prof["device_ops"] if symbol in name]
        bound += len(runs) * yardstick.wire_bound_s(kernel, ctx["n"])
        spent += sum(runs) / 1e9
    return 100.0 * bound / spent if spent else None
