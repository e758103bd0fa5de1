"""The device's idle share of the traced sub-window of a serving cell, in
%: 1 - (union of kernel intervals) / (the sub-window's wall time)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
