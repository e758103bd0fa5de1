"""The device's idle share over the traced train steps, in %: 1 - (union
of device operations' intervals) / (the traced steps' wall time)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or "steps" not in ctx or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
