#!/usr/bin/env python3
"""Compile CUDA sources the way `smoltts_torch/ops/_build.py` does (same
nvcc flags, `-Xptxas -v`), all at once, and print for each its nvcc wall
seconds, its kernel count and the kernels that spill registers.

    python3 scripts/torch_k2_build.py smoltts_torch/csrc/decode_attention.cu other.cu ...

Each source compiles in its own temporary directory with `common.cuh` from
the source's directory (or, if absent there, from smoltts_torch/csrc/), so
two versions of one kernel file compare side by side. Needs nvcc; builds
nothing into build/smoltts_torch/.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_report  # noqa: E402
from smoltts_torch.ops import _build  # noqa: E402


def main(paths) -> int:
    nvcc = _build._nvcc()
    results, threads = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for i, p in enumerate(paths):
            src = Path(p).resolve()
            work = Path(tmp) / str(i)
            work.mkdir()
            shutil.copy(src, work / src.name)
            common = src.parent / "common.cuh"
            shutil.copy(common if common.exists() else _build.CSRC / "common.cuh", work)

            def run(key=p, work=work, name=src.name):
                t0 = time.perf_counter()
                r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", name, "-o",
                                    "out.o"], cwd=work, capture_output=True, text=True)
                results[key] = (time.perf_counter() - t0, r.returncode, r.stdout + r.stderr)

            threads.append(threading.Thread(target=run))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    failed = 0
    for p in paths:
        seconds, code, log = results[p]
        if code != 0:
            failed += 1
            print(f"{p}: nvcc failed ({code})\n{log[-3000:]}")
            continue
        rows = ptxas_report(log)
        spilling = [r for r in rows if r[3] or r[4]]
        print(f"{p}: nvcc {seconds:.1f} s, {len(rows)} kernels, {len(spilling)} spilling")
        for name, regs, stack, st, ld in spilling:
            print(f"  spills {st} B stored / {ld} B loaded, {regs} registers, {stack} B stack: "
                  f"{name[:150]}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [str(_build.CSRC / "decode_attention.cu")]))
