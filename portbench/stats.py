"""Order statistics and interval arithmetic of the benchmark."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile, p in (0, 100]: the smallest value with at
    least p% of the values at or below it. Missing samples are +inf."""
    vals = sorted(values)
    if not vals:
        return math.inf
    rank = max(1, math.ceil(p / 100.0 * len(vals)))
    return vals[rank - 1]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals (overlaps counted
    once)."""
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted(intervals):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for t0, t1 in sorted(intervals):
        if t0 > cursor:
            out.append((cursor, min(t0, hi)))
        cursor = max(cursor, t1)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]
