"""Readings for the limits of `correct`: runs a cell on many seeds in one
process (the kernels built and loaded once) and prints, per seed, the
numbers the program gives and, on the first seeds, those of the control:
the reference one step below every precision the configuration states
(served: int8 -> int4 weights and caches, bf16 -> fp8 e4m3 dense weights,
read at the same prompts and served tokens; training: every product on fp8
inputs), and for training those of a planted fault (a step that leaves
half the batch out; a state left unchanged reads 1 and needs no run).

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control 3 \
        --seconds 30 [--first-seed N]

Prints one JSON line per seed and a summary line: the largest program
reading and the smallest control reading of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import check, registry  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    args = p.parse_args(argv)
    import torch

    cell = registry.cell(registry.load_benchmark(), args.workload)
    drv = registry.driver(cell.traffic["driver"])
    dev = torch.device("cuda")
    program, control = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        res = drv.run(cell, seed, args.seconds, False, time.perf_counter())
        got = {n.name: n.value for n in res.numbers}
        line = {"seed": seed, "program": got, "attempted": res.attempted, "failed": res.failed}
        for k, v in got.items():
            program[k] = max(program.get(k, v), v)
        if i < args.control and "ref" in res.ctx:
            from portbench import check_train

            c = res.ctx
            args_ = (cell.config, seed, c["pool"], c["step_seeds"], dev)
            line["control"] = check_train.gaps(
                check_train.reference_readings(*args_, lower=True), c["ref"])
            line["half_batch"] = check_train.gaps(
                check_train.reference_readings(*args_, half_batch=True), c["ref"])
            for k, v in line["control"].items():
                control[k] = min(control.get(k, v), v)
        elif i < args.control and "finished" in res.ctx:
            prec = check.stated_precision(cell.config)
            streams = check.sample(res.ctx["finished"], cell.workload["check"]["requests"], seed)
            ref = check.reference_models(cell.config, seed, dev, prec)
            ctl = check.reference_models(cell.config, seed, dev, prec.lower())
            c = check.readings(*ref, streams, control=ctl)
            line["control"] = c
            for k, v in c.items():
                control[k] = min(control.get(k, v), v)
            del ref, ctl
        print(json.dumps(line), flush=True)
        del res
        torch.cuda.empty_cache()
    print(json.dumps({"summary": {"program_max": program, "control_min": control}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
