"""One run of one cell: find its files, check the cards, hand it to its
driver, read its metrics, judge `correct`, print the result line."""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Optional

from portbench import check, registry
from portbench.tracing import breakdown

# Top-level module names that must not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "smoltts_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its CUDA library into build/smoltts_torch/)."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(build / "torch_kernels")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _num(v) -> Optional[float]:
    v = float(v)
    return v if math.isfinite(v) else None


def main(argv, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    cache_env(registry.ROOT)
    try:
        bench = registry.load_benchmark()
        cell = registry.cell(bench, args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as e:
        print(f"portbench: cannot load cell {args.workload!r}: {e!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    drv = registry.driver(cell.traffic["driver"])
    res = drv.run(cell, args.seed, args.seconds, bool(args.trace), t_start)

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run's process loaded {bad}", file=sys.stderr)
        return 3
    metrics, missing = {}, []
    for m in cell.per_layer if args.trace else cell.end_to_end:
        v = registry.reader(m["name"])(res.ctx)
        if v is None or not math.isfinite(v):
            missing.append(m["name"])
            if args.trace:
                continue  # a per-layer reader that finds nothing leaves its metric out
        metrics[m["name"]] = {"value": None if v is None else _num(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    line = {"correct": None, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": device}
    if args.trace and res.ctx.get("trace") is not None:
        tr = res.ctx["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = breakdown(tr)
    for note in res.notes:
        print(f"portbench: {note}", file=sys.stderr)
    if missing:
        print(f"portbench: no reading for {missing}", file=sys.stderr)
    numbers = res.numbers + [check.Number("failed_requests", float(res.failed), 0.0)]
    if not args.trace:
        numbers.append(check.Number("end_to_end_missing", float(len(missing)), 0.0))
    line["correct"] = all(n.ok for n in numbers)
    checks = check.report(numbers)
    line["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]} for k, v in checks.items()}
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0
