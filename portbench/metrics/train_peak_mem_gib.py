"""The run's peak of allocated device memory (`torch.cuda.max_memory_allocated`),
GiB: what bounds the batch."""


def read(ctx):
    if "steps" not in ctx or not ctx.get("memory_peak_bytes"):
        return None
    return ctx["memory_peak_bytes"] / 2 ** 30
