"""flash_roofline: the flash-attention kernels' least time (each launch
at a client's (batch, heads, seq, head_dim), ``yardstick.flash_bound_s``)
over their time in the profiled rounds, in %.  Kernels: csrc/
flash_fwd_sm90.cu and csrc/flash_bwd_sm90.cu (forward, dq, dk/dv)."""
from perfbench import yardstick

KERNELS = {"flash_fwd": "flash_fwd_sm90_kernel",
           "flash_dq": "flash_dq_sm90_kernel",
           "flash_dkv": "flash_dkv_sm90_kernel"}


def read(ctx):
    prof = ctx.get("profile")
    if not prof:
        return None
    m, t = ctx["config"]["model"], ctx["traffic"]
    bound = spent = 0.0
    for kernel, symbol in KERNELS.items():
        runs = [b - a for name, a, b in prof["device_ops"] if symbol in name]
        bound += len(runs) * yardstick.flash_bound_s(kernel, m, t["batch"],
                                                     t["seq"])
        spent += sum(runs) / 1e9
    return 100.0 * bound / spent if spent else None
