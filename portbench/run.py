"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout holding the program (`smoltts_torch`) on a
machine with as many CUDA cards as the cell asks for. Prints, as its last
line of standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), `device`, with --trace 1 `breakdown`, and last `checks`, the
numbers that decide `correct` beside their limits (also the last lines of
standard error). See portbench/README.md.
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, is the import root
sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
