"""95th percentile of the engine's own queue wait (submit to prefill
dispatched, `DecodeEngine.pop_timing()["queue_wait"]`, a program stamp)
over the requests sent inside the window whose wait lies outside any
traced sub-window."""

from portbench.metrics._serve import in_quiet, window_requests
from portbench.stats import percentile


def read(ctx):
    waits = [r.queue_wait * 1e3 for r in window_requests(ctx)
             if r.queue_wait is not None and in_quiet(ctx, r.submit, r.submit + r.queue_wait)]
    return percentile(waits, 95) if waits else None
