"""The program's own spans, for the readers of `metrics/`.

The program records coarse host spans where the work happens
(`smoltts_torch.utils.profiling.SPANS`: a bounded ring of (name, t0, t1,
thread id) on the host's `time.perf_counter()` clock, the benchmark's clock
too). The readers run in the run's own process after the driver returns and
read that ring there. A reader takes the spans wholly inside the window's
quiet stretches (or, for device readings, inside the traced sub-window), by
time, and reads nothing (None) where the program records no spans or where
its ring dropped a span that ended inside them.

Device readings. The traced sub-window lies between `ctx["quiet"]`'s
stretches. Each of the benchmark's spans `portbench.advance#i` there (on
the trace's clock) wraps one call whose first statement opens the
program's `engine.advance` span (the engine's `_advance`) or, without an
engine, its `step.stream` span (the library's frame step). The two series
are paired in order, at the shift where the paired starts agree best, and
the median difference of the paired starts is the offset from perf_counter
to the trace's clock; every program span moves by it. A device op belongs
to the program span, on the paired spans' thread, that holds its launch
time (only that thread launches kernels, so containment suffices).
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.stats import union_length

BENCH_ADVANCE = "portbench.advance#"
ANCHORS = ("engine.advance", "step.stream")  # in order of preference
FRAME_PARENTS = ("step.chunk", "step.stream")  # the served frame steps
FRAME_PARTS = ("lm.frame", "codec.step")
SLACK_US = 20.0  # how far a moved program span may pass its benchmark span's ends
MARGIN_S = 2.0  # program spans read around the traced sub-window

Span = Tuple[str, float, float, int]  # (name, t0, t1, thread id)


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from smoltts_torch.utils.profiling import SPANS
    except ImportError:
        return None
    return SPANS


def spans_between(lo: float, hi: float) -> Optional[List[Span]]:
    """The program's spans wholly inside [lo, hi] (perf_counter seconds),
    oldest first; None without a recorder, or when its ring dropped a span
    that ended at or after `lo`."""
    rec = recorder()
    if rec is None:
        return None
    held = rec.snapshot()
    if rec.dropped and (not held or held[0][2] >= lo):
        return None
    return [s for s in held if lo <= s[1] and s[2] <= hi]


def quiet_spans(ctx, names: Sequence[str]) -> Optional[List[Span]]:
    """The spans named `names` wholly inside one of the window's quiet
    stretches (the whole window when nothing was traced)."""
    stretches = ctx.get("quiet") or [(ctx["t_open"], ctx["t_close"])]
    out = []
    for lo, hi in stretches:
        got = spans_between(lo, hi)
        if got is None:
            return None
        out.extend(s for s in got if s[0] in names)
    return out


def nested(children: Sequence[Span], parents: Sequence[Span]) -> List[Span]:
    """The children that lie inside one of the parents, on its thread (the
    parents of one thread do not overlap)."""
    by_tid: Dict[int, List[Span]] = {}
    for p in sorted(parents, key=lambda s: s[1]):
        by_tid.setdefault(p[3], []).append(p)
    starts = {tid: [p[1] for p in ps] for tid, ps in by_tid.items()}
    out = []
    for c in children:
        ps = by_tid.get(c[3])
        if ps:
            i = bisect.bisect_right(starts[c[3]], c[1]) - 1
            if i >= 0 and c[2] <= ps[i][2]:
                out.append(c)
    return out


def frame_parts(spans: Sequence[Span], name: str) -> List[Span]:
    """The `name` spans (an LM frame or a vocoder step) inside a served
    frame step, not a prefill."""
    return nested([s for s in spans if s[0] == name],
                  [s for s in spans if s[0] in FRAME_PARENTS])


def host_ms_per_frame(ctx, name: str) -> Optional[float]:
    """Mean host ms of the `name` spans inside the quiet stretches' frame
    steps."""
    got = quiet_spans(ctx, (name,) + FRAME_PARENTS)
    parts = [] if got is None else frame_parts(got, name)
    return statistics.fmean((s[2] - s[1]) * 1e3 for s in parts) if parts else None


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean host ms of the `name` spans inside the quiet stretches."""
    got = quiet_spans(ctx, (name,))
    return statistics.fmean((s[2] - s[1]) * 1e3 for s in got) if got else None


@dataclasses.dataclass
class Aligned:
    """The program's spans of the traced sub-window on the trace's clock."""

    offset_us: float  # trace us = perf_counter s * 1e6 + offset_us
    residual_us: float  # median |paired start difference - offset|
    bench: int  # the benchmark's advance spans in the sub-window
    enclosed: int  # of them, those enclosing exactly one anchor after the shift
    anchors: List[Tuple[str, float, float]]  # the paired anchors, moved (us)
    spans: List[Tuple[str, float, float]]  # every span of their thread, moved (us)


def align(ctx) -> Optional[Aligned]:
    """Pair the benchmark's advance spans of the traced sub-window with the
    program's anchor spans and move the program's spans onto the trace's
    clock; None when either side has fewer than three such spans."""
    trace, quiet = ctx.get("trace"), ctx.get("quiet") or []
    if trace is None or len(quiet) < 2:
        return None
    bench = sorted((s for s in trace.spans if s[0].startswith(BENCH_ADVANCE)),
                   key=lambda s: s[1])
    prog = spans_between(quiet[0][1] - MARGIN_S, quiet[1][0] + MARGIN_S)
    if prog is None or len(bench) < 3:
        return None
    kind = next((k for k in ANCHORS if any(s[0] == k for s in prog)), None)
    anchors = sorted((s for s in prog if s[0] == kind), key=lambda s: s[1])
    n = len(bench)
    best = None
    for j in range(len(anchors) - n + 1):
        pairs = list(zip(bench, anchors[j:j + n]))
        mid = statistics.median(b[1] - a[1] * 1e6 for b, a in pairs)
        # starts and ends alike: steps of even pace still differ in length
        dev = statistics.median(max(abs(b[1] - a[1] * 1e6 - mid), abs(b[2] - a[2] * 1e6 - mid))
                                for b, a in pairs)
        if best is None or dev < best[0]:
            best = (dev, j, mid)
    if best is None:
        return None
    _, j, offset = best
    residual = statistics.median(abs(b[1] - a[1] * 1e6 - offset)
                                 for b, a in zip(bench, anchors[j:j + n]))
    tid = anchors[j][3]
    moved = sorted(((s[0], s[1] * 1e6 + offset, s[2] * 1e6 + offset) for s in prog
                    if s[3] == tid), key=lambda s: s[1])
    paired = [(a[0], a[1] * 1e6 + offset, a[2] * 1e6 + offset) for a in anchors[j:j + n]]
    all_moved = [(a[0], a[1] * 1e6 + offset, a[2] * 1e6 + offset) for a in anchors]
    enclosed = sum(1 for b in bench if sum(
        1 for a in all_moved if b[1] - SLACK_US <= a[1] and a[2] <= b[2] + SLACK_US) == 1)
    return Aligned(offset_us=offset, residual_us=residual, bench=n, enclosed=enclosed,
                   anchors=paired, spans=moved)


def _within(spans, parents):
    """The (name, t0, t1) spans inside one of the parents (sorted, disjoint)."""
    starts = [p[1] for p in parents]
    out = []
    for s in spans:
        i = bisect.bisect_right(starts, s[1]) - 1
        if i >= 0 and s[2] <= parents[i][2]:
            out.append(s)
    return out


def traced_frames(ctx):
    """(the aligned spans, the LM frame and vocoder step spans of the served
    frame steps inside the paired anchors, on the trace's clock, and the
    trace's kernels by launch time) or None."""
    al = align(ctx)
    if al is None:
        return None
    inside = _within(al.spans, al.anchors)
    steps = [s for s in inside if s[0] in FRAME_PARENTS]
    parts = _within([s for s in inside if s[0] in FRAME_PARTS], steps)
    kernels = sorted((k for k in ctx["trace"].kernels if k.launch is not None),
                     key=lambda k: k.launch)
    return al, parts, kernels


def launched_in(kernels, launches: List[float], span) -> list:
    """The kernels (sorted by launch; `launches` their launch times) that
    were launched inside `span`."""
    lo = bisect.bisect_left(launches, span[1])
    hi = bisect.bisect_right(launches, span[2])
    return kernels[lo:hi]


def device_ms_per_frame(ctx, name: str) -> Optional[float]:
    """Mean, over the `name` spans of the traced sub-window's frame steps,
    of the union of the device intervals of the ops each launched (ms)."""
    got = traced_frames(ctx)
    if got is None:
        return None
    _, parts, kernels = got
    launches = [k.launch for k in kernels]
    per = [[(k.t0, k.t1) for k in launched_in(kernels, launches, s)]
           for s in parts if s[0] == name]
    if not per or not any(per):
        return None
    return statistics.fmean(union_length(p) for p in per) / 1e3


def kernels_per_frame(ctx) -> Optional[float]:
    """Device ops launched in the LM frames and vocoder steps of the
    traced sub-window's frame steps, per frame."""
    got = traced_frames(ctx)
    if got is None:
        return None
    _, parts, kernels = got
    launches = [k.launch for k in kernels]
    frames = sum(1 for s in parts if s[0] == FRAME_PARTS[0])
    ops = sum(len(launched_in(kernels, launches, s)) for s in parts)
    return ops / frames if frames and ops else None


def coverage(ctx) -> Optional[dict]:
    """The alignment's own figures: benchmark spans, those enclosing
    exactly one anchor, the median start residual (us), and the device ops
    launched inside the paired anchors with the share of them launched in
    an LM frame or vocoder step."""
    got = traced_frames(ctx)
    if got is None:
        return None
    al, parts, kernels = got
    launches = [k.launch for k in kernels]
    in_anchors = sum(len(launched_in(kernels, launches, a)) for a in al.anchors)
    in_parts = sum(len(launched_in(kernels, launches, s)) for s in parts)
    return {"bench_spans": al.bench, "enclosed": al.enclosed,
            "enclosed_share": al.enclosed / al.bench, "residual_us": al.residual_us,
            "offset_us": al.offset_us, "ops_in_anchors": in_anchors,
            "ops_in_frames": in_parts,
            "ops_in_frames_share": in_parts / in_anchors if in_anchors else None}
