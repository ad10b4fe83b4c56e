"""round_ms: the window's wall time, from a synchronise before its first
round to one after its last whole round, over the rounds it ran."""


def read(ctx):
    if not ctx.get("rounds") or ctx.get("timed") is not None:
        return None
    return 1e3 * ctx["wall_s"] / ctx["rounds"]
