"""Device time a train step spends in copies and casts (kernels and
transfers whose names say copy, memcpy or memset), ms per traced step."""

import re

COPY = re.compile(r"copy|memcpy|memset", re.IGNORECASE)


def read(ctx):
    trace, n = ctx.get("trace"), ctx.get("trace_steps")
    if trace is None or not n:
        return None
    return sum(k.t1 - k.t0 for k in trace.kernels if COPY.search(k.name)) / 1e3 / n
