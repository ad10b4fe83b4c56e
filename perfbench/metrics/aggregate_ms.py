"""aggregate_ms: a round's event time less its gradients and its
compression: the aggregators' compensated mean and the server, with
whatever else the round does between the stages, averaged over the
traced run's unprofiled rounds."""
import statistics


def read(ctx):
    timed = ctx.get("timed")
    if not timed:
        return None
    return statistics.fmean(r - g - c for r, g, c in zip(
        timed["round"], timed["grad"], timed["compress"]))
