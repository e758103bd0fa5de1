"""The program's spans and counters beside the benchmark, one run at a time.

    python3 portbench/span_check.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> \
        [--spans on|off] [--micro]

Runs one cell as `run.py` does (same driver, same readers), with the
program's span recorder on or off (`SPANS.enabled`; a program without the
recorder runs as it is), and prints one JSON line: the card, `correct`,
every metric of the cell that reads a value (end-to-end and per-layer
alike; untraced, the device readings are absent), the program's spans and
timed-lock acquisitions per frame step in the quiet stretches, each
span name's host ms per frame step, the mean frame step and the mean gap
between two, with
`--trace 1` the alignment of the program's spans with the benchmark's
(`program_spans.coverage`), and with `--micro` the host cost of one span
and one timed-lock acquisition (us, the mean of a tight loop of 200,000).
Run it on a machine with the cell's CUDA cards, from the root of a
checkout.
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402

from portbench import harness, program_spans, registry  # noqa: E402

MICRO_N = 200_000


def micro() -> dict:
    """Host us per span and per timed-lock acquisition (and per plain lock
    acquisition, for scale), each the mean of a tight loop."""
    import threading

    from smoltts_torch.utils.profiling import SpanRecorder, TimedLock, lock_counters

    rec, timed, plain = SpanRecorder(), TimedLock(lock_counters()).role("dispatch"), \
        threading.Lock()

    def loop(body):
        t0 = time.perf_counter()
        body()
        return (time.perf_counter() - t0) / MICRO_N * 1e6

    def spans():
        for _ in range(MICRO_N):
            with rec.span("x"):
                pass

    def locks(lock):
        def body():
            for _ in range(MICRO_N):
                with lock:
                    pass
        return body

    def empty():
        for _ in range(MICRO_N):
            pass

    base = loop(empty)
    return {"span_us": loop(spans) - base, "timed_lock_us": loop(locks(timed)) - base,
            "plain_lock_us": loop(locks(plain)) - base}


def per_step(ctx) -> dict:
    """The program's spans and timed-lock acquisitions per frame step in
    the quiet stretches, each span name's host ms per frame step, the mean
    frame step (engine: a dispatch's `engine.advance`, library:
    `step.stream`) and the mean gap from one to the next under 0.5 s (ms)."""
    anchors = sorted(program_spans.quiet_spans(ctx, program_spans.ANCHORS) or [],
                     key=lambda s: s[1])
    kind = next((k for k in program_spans.ANCHORS if any(s[0] == k for s in anchors)), None)
    anchors = [s for s in anchors if s[0] == kind]
    steps = ctx.get("stats", {}).get("frame_steps") or len(anchors)
    if not steps:
        return {}
    spans = [s for a, b in ctx.get("quiet") or [(ctx["t_open"], ctx["t_close"])]
             for s in program_spans.spans_between(a, b) or []]
    ms: dict = {}
    for s in spans:
        ms[s[0]] = ms.get(s[0], 0.0) + (s[2] - s[1]) * 1e3 / steps
    out = {"frame_steps": steps, "spans_per_step": len(spans) / steps, "span_ms_per_step": ms}
    if anchors:
        gaps = [b[1] - a[2] for a, b in zip(anchors, anchors[1:]) if b[1] - a[2] < 0.5]
        out.update(anchor=kind, anchor_ms=statistics.fmean(s[2] - s[1] for s in anchors) * 1e3,
                   gap_ms=statistics.fmean(gaps) * 1e3 if gaps else None)
    stats = ctx.get("stats", {})
    acquires = sum(v for k, v in stats.items() if k.startswith("lock_acquires."))
    if acquires:
        out["lock_acquires_per_step"] = acquires / steps
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--spans", choices=("on", "off"), default="on")
    p.add_argument("--micro", action="store_true")
    args = p.parse_args(argv)
    harness.cache_env(registry.ROOT)
    import torch

    cell = registry.cell(registry.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"span_check: the cell needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    spans = program_spans.recorder()
    if spans is None and (args.spans == "off" or args.micro):
        print("span_check: the program has no span recorder", file=sys.stderr)
        return 2
    if spans is not None:
        spans.enabled = args.spans == "on"
    res = registry.driver(cell.traffic["driver"]).run(cell, args.seed, args.seconds,
                                                      bool(args.trace), T_START)
    metrics = {}
    for m in cell.end_to_end + cell.per_layer:
        v = registry.reader(m["name"])(res.ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = v
    line = {"workload": args.workload, "seed": args.seed, "spans": args.spans,
            "trace": args.trace, "device": torch.cuda.get_device_name(0),
            "correct": all(n.ok for n in res.numbers) and res.failed == 0,
            "metrics": metrics, "per_step": per_step(res.ctx),
            "recorder": None if spans is None else {"dropped": spans.dropped,
                                                     "held": len(spans.snapshot())}}
    if args.trace:
        line["alignment"] = program_spans.coverage(res.ctx)
    if args.micro:
        line["micro"] = micro()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
