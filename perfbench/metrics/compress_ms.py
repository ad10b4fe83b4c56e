"""compress_ms: the clients' compression of a round (CUDA events around
each compress stage's apply), summed over the round and averaged over
the traced run's unprofiled rounds."""
import statistics


def read(ctx):
    timed = ctx.get("timed")
    return statistics.fmean(timed["compress"]) if timed else None
