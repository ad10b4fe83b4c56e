"""grad_ms: the clients' gradients of a round (CUDA events around each
client's ``FLRun._grad``), summed over the round and averaged over the
traced run's unprofiled rounds."""
import statistics


def read(ctx):
    timed = ctx.get("timed")
    return statistics.fmean(timed["grad"]) if timed else None
