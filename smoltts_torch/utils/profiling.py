"""Serving metrics: `ServingMetrics` keeps the counters the HTTP server
reports on `/metrics` (first-audio latency percentiles, audio-seconds per
second) as running aggregates. The JAX package's `trace` and
`device_op_summary` wrap its profiler; the port's counterparts over
`torch.profiler` are still to come.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional


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
