"""idle_pct: the share of the profiled window in which no device
operation ran (the union of the profiler's device intervals over that
same window), in %."""


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
