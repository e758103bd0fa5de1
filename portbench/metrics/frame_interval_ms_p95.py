"""95th percentile, over requests with at least two frames arriving inside
the window, of (last arrival - first arrival) / (frames - 1) over those
frames, as the client saw them. Real time is 80 ms."""

from portbench.metrics._serve import in_window
from portbench.stats import percentile


def read(ctx):
    per = []
    for r in ctx.get("requests", []):
        t = [a for a in r.arrivals if in_window(ctx, a)]
        if len(t) >= 2:
            per.append((t[-1] - t[0]) / (len(t) - 1) * 1e3)
    return percentile(per, 95) if per else None
