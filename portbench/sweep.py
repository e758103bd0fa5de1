"""The highest rate an open-loop serving cell sustains, by a sweep: runs the
cell's driver at each rate in one process and prints, per rate, the
backlog (requests sent but not yet given a first frame) at the window's
open and close and the first-audio percentiles. A rate is sustained when
the backlog does not grow across the window.

    python3 portbench/sweep.py --config smoltts_150m --traffic poisson --rates 10 14 18 \
        --seconds 51
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import registry  # noqa: E402
from portbench.stats import percentile  # noqa: E402


def backlog(reqs, t: float) -> int:
    return sum(1 for r in reqs if r.submit is not None and r.submit <= t
               and (r.first is None or r.first > t))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="a configuration of BENCHMARK.json")
    p.add_argument("--traffic", required=True, help="an open-loop traffic file's name")
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=4_000_000_001)
    args = p.parse_args(argv)
    cell = registry.open_loop_cell(registry.load_benchmark(), args.config, args.traffic)
    drv = registry.driver(cell.traffic["driver"])
    for rate in args.rates:
        cell.traffic["rate"] = rate
        res = drv.run(cell, args.seed, args.seconds, False, time.perf_counter())
        c = res.ctx
        inside = [r for r in c["requests"] if c["t_open"] <= r.start < c["t_close"]]
        lat = [(r.first - r.start) * 1e3 if r.first else float("inf") for r in inside]
        half = [r for r in inside if r.start >= (c["t_open"] + c["t_close"]) / 2]
        print(json.dumps({
            "rate": rate, "sent_in_window": len(inside),
            "backlog_open": backlog(c["requests"], c["t_open"]),
            "backlog_close": backlog(c["requests"], c["t_close"]),
            "first_audio_ms_p50": percentile(lat, 50), "first_audio_ms_p95": percentile(lat, 95),
            "second_half_p95": percentile([(r.first - r.start) * 1e3 if r.first else
                                           float("inf") for r in half], 95),
            "audio_s_per_s": registry.reader("audio_s_per_s")(c),
            "lateness_ms_max": max(c["lateness"], default=0.0) * 1e3,
            "checks": {n.name: n.value for n in res.numbers}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
