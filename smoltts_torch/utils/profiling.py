"""Profiling and serving metrics.

- `trace(log_dir)`: a `torch.profiler` window (CUDA activity when a card is
  present) that writes a Chrome trace into `log_dir`.
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
from typing import Dict, List, Optional, Tuple

TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "smoltts_trace"):
    """Profile the block; on exit write `log_dir/smoltts_<ns>.pt.trace.json`
    (a Chrome trace, Perfetto-readable). Yields `log_dir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / f"smoltts_{time.time_ns()}{TRACE_SUFFIX}"))


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
