"""peak_mem_gb: torch.cuda.max_memory_allocated() over the run up to the
window's end, before the reference touches the card, in 1e9 bytes."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx.get("peak_bytes") else None
