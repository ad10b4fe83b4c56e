"""round_mfu: the round's model FLOPs (K clients' gradients, counted
from the configuration's shapes by ``yardstick.gradient_flops``) over
the traced run's mean round time (CUDA events) at the bf16 peak, in %."""
import statistics

from perfbench import yardstick


def read(ctx):
    timed = ctx.get("timed")
    if not timed:
        return None
    t = ctx["traffic"]
    flops = t["round"]["K"] * yardstick.gradient_flops(
        ctx["config"]["model"], t["batch"], t["seq"])
    seconds = statistics.fmean(timed["round"]) / 1e3
    return 100.0 * flops / (seconds * yardstick.BF16_FLOPS)
