"""What every driver returns, and the timing helper they share."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class RunResult:
    setup_s: float
    attempted: int
    failed: int
    ctx: dict  # what the metric readers read
    numbers: list  # check.Number: what decides `correct`
    memory_peak_bytes: int
    notes: List[str] = dataclasses.field(default_factory=list)  # printed on standard error


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of `fn` by CUDA events around `iters`
    calls, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
