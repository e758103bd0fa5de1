"""The device trace of a traced sub-window: `torch.profiler` over CPU and
CUDA, read back from its Chrome trace into kernels, the host's launches of
them and the benchmark's own spans (`record_function` labels that start
with "portbench.", recorded around the calls into each layer; those of a
thread the profiler does not follow are recorded on the host's clock and
moved onto the trace's by a span the profiling thread records at its
start).

Device busy time is the union of the kernels' intervals (kernels of one
stream overlap under programmatic dependent launch, so durations are not
added). The CUDA runtime's launch records (CUPTI) cover every thread, so
each kernel is matched to the span of the host call that launched it.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from portbench.stats import gaps, union_length

SPAN_PREFIX = "portbench."
CLOCK = "portbench.clock"
# Chrome-trace categories of work on the device: kernels, copies, fills.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Kernel:
    name: str
    t0: float  # us
    t1: float
    launch: Optional[float]  # host launch time, us (None if the trace lacks it)
    span: Optional[int] = None  # index into Trace.spans of the span that launched it
    op: Optional[str] = None  # the innermost profiled host op around its launch


@dataclasses.dataclass
class Trace:
    kernels: List[Kernel]  # by start time
    spans: List[Tuple[str, float, float]]  # (label, t0 us, t1 us), by start
    window_s: float  # host wall time of the traced window
    busy_s: float  # union of kernel intervals

    def kernels_in(self, kind: str) -> Dict[int, List[Kernel]]:
        """Kernels by the index of the span of `kind` ("portbench.<kind>#i")
        that launched them, in launch order."""
        out: Dict[int, List[Kernel]] = {}
        for k in sorted(self.kernels, key=lambda k: (k.launch is None, k.launch or 0.0)):
            if k.span is None:
                continue
            label = self.spans[k.span][0]
            if label.startswith(f"{SPAN_PREFIX}{kind}#"):
                out.setdefault(int(label.rsplit("#", 1)[1]), []).append(k)
        return out


class Profiler:
    """torch.profiler over CPU and CUDA, started and stopped on one thread."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.trace_bytes = 0  # the size of the exported trace, for the run's notes

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        with record_function(CLOCK):  # ties the trace's clock to the host's
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def read(self, host_spans=()) -> Trace:
        """The trace, with `host_spans` [(label, t0, t1)] on the host's
        perf_counter clock (spans recorded on threads the profiler does not
        follow) moved onto the trace's clock."""
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            self.trace_bytes = path.stat().st_size
            events = json.loads(path.read_text())["traceEvents"]
        clock = next((float(e["ts"]) for e in events if e.get("name") == CLOCK), None)
        moved = [] if clock is None else [
            (label, clock + (a - self.t0) * 1e6, clock + (b - self.t0) * 1e6)
            for label, a, b in host_spans]
        return parse_trace(events, self.t1 - self.t0, moved)


def parse_trace(events: list, window_s: float, extra_spans=()) -> Trace:
    """A Trace from Chrome-trace events: kernels, the runtime calls that
    launched them (matched by correlation id) and the benchmark's spans
    (those in the events and `extra_spans`, already on the trace's clock)."""
    launches: Dict[int, Tuple[float, object]] = {}
    spans = list(extra_spans)
    raw, ops = [], {}
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATEGORIES:
            raw.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
        elif cat == "cpu_op" and "dur" in e:
            ops.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
        elif (str(e.get("name", "")).startswith(SPAN_PREFIX) and "dur" in e
              and e["name"] != CLOCK):
            spans.append((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    spans.sort(key=lambda s: s[1])
    starts = [s[1] for s in spans]
    for tid in ops:
        ops[tid].sort()
    op_starts = {tid: [o[0] for o in v] for tid, v in ops.items()}
    kernels = []
    for e in raw:
        t0 = float(e["ts"])
        launch, tid = launches.get((e.get("args") or {}).get("correlation"), (None, None))
        k = Kernel(e["name"], t0, t0 + float(e["dur"]), launch)
        if launch is not None and spans:
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and spans[i][1] <= launch <= spans[i][2]:
                k.span = i
        if launch is not None and tid in ops:
            k.op = _innermost(ops[tid], op_starts[tid], launch)
        kernels.append(k)
    kernels.sort(key=lambda k: k.t0)
    busy = union_length((k.t0, k.t1) for k in kernels) / 1e6
    return Trace(kernels=kernels, spans=spans, window_s=window_s, busy_s=busy)


def _innermost(ops, starts, t: float, look: int = 64) -> Optional[str]:
    """The latest-starting op (of ops sorted by start) that contains t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - look), -1):
        if ops[j][0] <= t <= ops[j][1]:
            return ops[j][2]
    return None


def call_spans(kernels: List[Kernel], n_calls: int) -> List[float]:
    """Split a span's kernels (in launch order) into `n_calls` equal calls
    and return each call's device time in seconds: its first kernel's start
    to its last kernel's end."""
    if n_calls <= 0 or not kernels or len(kernels) % n_calls:
        return []
    per = len(kernels) // n_calls
    out = []
    for c in range(n_calls):
        group = kernels[c * per: (c + 1) * per]
        out.append((max(k.t1 for k in group) - min(k.t0 for k in group)) / 1e6)
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    gaps summed by what the host was doing: the benchmark's span, else the
    innermost profiled host op, that launched the kernel which ended the
    gap ("between spans" when neither is known)."""
    by_name: Dict[str, float] = {}
    for k in trace.kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + (k.t1 - k.t0) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle: Dict[str, float] = {}
    if trace.kernels:
        lo, hi = trace.kernels[0].t0, max(k.t1 for k in trace.kernels)
        ends = sorted(trace.kernels, key=lambda k: k.t0)
        starts = [k.t0 for k in ends]
        for a, b in gaps(((k.t0, k.t1) for k in trace.kernels), lo, hi):
            nxt = ends[min(bisect.bisect_left(starts, b), len(ends) - 1)]
            if nxt.span is not None:
                label = "host: in " + trace.spans[nxt.span][0].split("#")[0][len(SPAN_PREFIX):]
            elif nxt.op is not None:
                label = "host: in " + nxt.op
            else:
                label = "host: between spans"
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps_out]}
