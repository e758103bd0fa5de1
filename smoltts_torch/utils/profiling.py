"""Profiling and serving metrics.

- `SPANS`: the process's flight recorder of coarse host spans, a bounded
  ring of (name, t0, t1, thread id) on the `time.perf_counter()` clock,
  recorded with `SPANS.span(name)` where the work happens (a few spans per
  engine dispatch or library frame, none per kernel). Always on; setting
  `SPANS.enabled = False` records nothing.
- `TimedLock`: a lock that adds, per caller role, the seconds waited for it,
  the seconds held and the acquisitions to a counter dict
  (`DecodeEngine.stats`).
- `trace(log_dir)`: a `torch.profiler` window (CUDA activity when a card is
  present) that writes a Chrome trace into `log_dir`, with the `SPANS` of
  its window on the trace's clock, one track per thread.
- `device_op_summary(log_dir, top_k)`: device time per kernel name in the
  newest trace of `log_dir`.
- `ServingMetrics`: the counters the HTTP server reports on `/metrics`
  (first-audio latency percentiles, audio-seconds per second) as running
  aggregates.
"""

from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from pathlib import Path
from threading import get_ident
from time import perf_counter as _now
from typing import Dict, List, Optional, Tuple

TRACE_SUFFIX = ".pt.trace.json"
# The profiled range whose end ties the trace's clock to perf_counter (its
# end, read just after the range closes: a range's start is stamped after
# an entry that can take a millisecond).
CLOCK_ANCHOR = "smoltts.clock"
# Chrome-trace thread ids of the merged host-span tracks, one per thread.
SPAN_TRACK_BASE = 1 << 30


class _Span:
    __slots__ = ("_rec", "_name", "_t0")

    def __init__(self, rec: "SpanRecorder", name: str):
        self._rec, self._name, self._t0 = rec, name, None

    def __enter__(self):
        if self._rec.enabled:
            self._t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t0 = self._t0
        if t0 is not None:
            rec = self._rec
            ring = rec._ring
            if len(ring) == ring.maxlen:
                rec.dropped += 1
            ring.append((self._name, t0, _now(), get_ident()))


class SpanRecorder:
    """A bounded ring of host spans (name, t0, t1, thread id): times in
    `time.perf_counter()` seconds, the thread's `threading.get_ident()`,
    appended when a span closes (an outer span after the spans it holds).
    When full, each new span evicts the oldest and counts in `dropped`."""

    def __init__(self, maxlen: int = 65536):
        self._ring: collections.deque = collections.deque(maxlen=maxlen)
        self.dropped = 0
        self.enabled = True

    def span(self, name: str) -> _Span:
        """A context manager recording `name` from entry to exit (nothing
        while `enabled` is False)."""
        return _Span(self, name)

    def snapshot(self) -> List[Tuple[str, float, float, int]]:
        """The spans held, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._ring)


SPANS = SpanRecorder()

LOCK_ROLES = ("dispatch", "fetch", "submit", "other")


def lock_counters() -> Dict[str, float]:
    """Zeroed `TimedLock` counters for every role."""
    out: Dict[str, float] = {}
    for role in LOCK_ROLES:
        out.update({f"lock_wait_s.{role}": 0.0, f"lock_held_s.{role}": 0.0,
                    f"lock_acquires.{role}": 0})
    return out


class _LockRole:
    """One role's view of a `TimedLock`: a lock (acquire, release, context
    manager) that `threading.Condition` can wrap."""

    __slots__ = ("_owner", "_wait", "_held", "_n")

    def __init__(self, owner: "TimedLock", role: str):
        self._owner = owner
        self._wait, self._held, self._n = (f"{kind}.{role}" for kind in
                                           ("lock_wait_s", "lock_held_s", "lock_acquires"))

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        owner = self._owner
        t0 = _now()
        if not owner._lock.acquire(blocking, timeout):
            return False
        t1 = _now()
        counters = owner.counters
        counters[self._wait] += t1 - t0
        counters[self._n] += 1
        owner._since, owner._held_key = t1, self._held
        return True

    def release(self) -> None:
        owner = self._owner
        owner.counters[owner._held_key] += _now() - owner._since
        owner._lock.release()

    def locked(self) -> bool:
        return self._owner._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class TimedLock(_LockRole):
    """A `threading.Lock` that, while held, adds to `counters`
    `lock_wait_s.<role>` (seconds from the call to the lock held),
    `lock_held_s.<role>` and `lock_acquires.<role>`, for the roles of
    `LOCK_ROLES` (`lock_counters()` makes the keys). Used directly it is
    the role "other"; `role(name)` gives another role's view."""

    __slots__ = ("counters", "_lock", "_since", "_held_key", "_roles")

    def __init__(self, counters: Dict[str, float]):
        self.counters = counters
        self._lock = threading.Lock()
        self._since, self._held_key = 0.0, None
        self._roles = {r: self if r == "other" else _LockRole(self, r) for r in LOCK_ROLES}
        super().__init__(self, "other")

    def role(self, name: str) -> _LockRole:
        return self._roles[name]


@contextlib.contextmanager
def trace(log_dir: str = "smoltts_trace"):
    """Profile the block; on exit write `log_dir/smoltts_<ns>.pt.trace.json`
    (a Chrome trace, Perfetto-readable) holding, beside the profiler's
    events, the `SPANS` recorded wholly inside the window by any thread, on
    the trace's clock. Yields `log_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(CLOCK_ANCHOR):
            pass
        anchor = time.perf_counter()
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        end = time.perf_counter()
    path = out / f"smoltts_{time.time_ns()}{TRACE_SUFFIX}"
    prof.export_chrome_trace(str(path))
    _merge_spans(path, anchor, [s for s in SPANS.snapshot() if anchor <= s[1] and s[2] <= end])


def _merge_spans(path: Path, anchor: float, spans) -> None:
    """Add `spans` to the Chrome trace at `path` as complete events, moved
    onto its clock by the end of the `CLOCK_ANCHOR` range (`anchor` on
    perf_counter), one named track per recording thread."""
    doc = json.loads(path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    mark = next((e for e in events if e.get("name") == CLOCK_ANCHOR and "dur" in e), None)
    if mark is None or not spans:
        return
    base, pid = float(mark["ts"]) + float(mark["dur"]), mark.get("pid", 0)
    names = {t.ident: t.name for t in threading.enumerate()}
    tracks: Dict[int, int] = {}
    for name, t0, t1, ident in spans:
        if ident not in tracks:
            tracks[ident] = SPAN_TRACK_BASE + len(tracks)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tracks[ident],
                           "args": {"name": f"spans: {names.get(ident, ident)}"}})
        events.append({"ph": "X", "cat": "host_span", "name": name, "pid": pid,
                       "tid": tracks[ident], "ts": base + (t0 - anchor) * 1e6,
                       "dur": (t1 - t0) * 1e6})
    path.write_text(json.dumps(doc))


def device_op_summary(log_dir: str, top_k: int = 25) -> List[Tuple[str, float, int]]:
    """[(kernel name, total us, count)] over the device kernel events
    (category "kernel") of the newest trace under `log_dir`, the largest
    total first; [] when there is no trace or it holds no kernel."""
    files = sorted(Path(log_dir).rglob(f"*{TRACE_SUFFIX}"), key=lambda p: p.stat().st_mtime)
    if not files:
        return []
    events = json.loads(files[-1].read_text())
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    totals: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            totals[e["name"]] += float(e.get("dur", 0.0))
            counts[e["name"]] += 1
    return [(n, us, counts[n]) for n, us in totals.most_common(top_k)]


class ServingMetrics:
    """Thread-safe serving counters: first-audio latency, throughput."""

    def __init__(self, frame_rate: float = 12.5, window: int = 512):
        self.frame_rate = frame_rate
        self._lock = threading.Lock()
        self._first_audio_ms: collections.deque = collections.deque(maxlen=window)
        self._frames = 0
        self._started = time.monotonic()
        self.requests = 0

    def record_request(self) -> None:
        with self._lock:
            self.requests += 1

    def record_first_audio(self, latency_s: float) -> None:
        with self._lock:
            self._first_audio_ms.append(latency_s * 1e3)

    def record_frames(self, n: int) -> None:
        with self._lock:
            self._frames += n

    @staticmethod
    def _pct(values: List[float], q: float) -> Optional[float]:
        if not values:
            return None
        values = sorted(values)
        idx = min(len(values) - 1, int(q * len(values)))
        return values[idx]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            vals = list(self._first_audio_ms)
            elapsed = max(time.monotonic() - self._started, 1e-9)
            out = {
                "requests": self.requests,
                "frames": self._frames,
                "audio_seconds_per_s": (self._frames / self.frame_rate) / elapsed,
                "uptime_s": elapsed,
            }
        p50 = self._pct(vals, 0.50)
        p99 = self._pct(vals, 0.99)
        if p50 is not None:
            out["first_audio_ms_p50"] = p50
            out["first_audio_ms_p99"] = p99
        return out
