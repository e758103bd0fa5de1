"""95th percentile, over every request sent (open loop: due) inside the
window, of the time from then to its first PCM frame at the client; a
request that never got one counts as missing (infinite)."""

import math

from portbench.metrics._serve import window_requests
from portbench.stats import percentile


def read(ctx):
    reqs = window_requests(ctx)
    if not reqs:
        return None
    lat = [(r.first - r.start) * 1e3 if r.first is not None else math.inf for r in reqs]
    return percentile(lat, 95)
