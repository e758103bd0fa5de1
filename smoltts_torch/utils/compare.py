"""Golden-tensor dump/compare harness: load two tensor dumps, report
allclose at a tolerance and the largest absolute difference per key, exit
non-zero on a mismatch. Reads `.npy`, `.npz` (key-wise) and `.safetensors`
(with the port's own reader; bf16 tensors are compared as f32, which holds
them exactly).

    python -m smoltts_torch.utils.compare a.npy b.npy [--rtol 1e-3] [--atol 1e-3]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch


def load_dump(path: str) -> Dict[str, np.ndarray]:
    p = Path(path)
    if p.suffix == ".npy":
        return {"": np.load(p)}
    if p.suffix == ".npz":
        with np.load(p) as z:
            return {k: z[k] for k in z.files}
    if p.suffix == ".safetensors":
        from smoltts_torch.io.safetensors import load_file

        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in load_file(p).items()}
    raise ValueError(f"unsupported dump format: {p.suffix}")


def compare(
    a: Dict[str, np.ndarray],
    b: Dict[str, np.ndarray],
    rtol: float = 1e-3,
    atol: float = 1e-3,
) -> bool:
    ok = True
    keys_a, keys_b = set(a), set(b)
    for k in sorted(keys_a ^ keys_b):
        print(f"MISSING  {k!r}: only in {'first' if k in keys_a else 'second'} dump")
        ok = False
    for k in sorted(keys_a & keys_b):
        x, y = a[k], b[k]
        if x.shape != y.shape:
            print(f"SHAPE    {k!r}: {x.shape} vs {y.shape}")
            ok = False
            continue
        x64, y64 = x.astype(np.float64), y.astype(np.float64)
        close = np.allclose(x64, y64, rtol=rtol, atol=atol)
        max_abs = float(np.max(np.abs(x64 - y64))) if x.size else 0.0
        tag = "OK     " if close else "DIFF   "
        print(f"{tag}  {k!r}: shape={x.shape} max_abs_diff={max_abs:.3e}")
        ok = ok and close
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Compare two tensor dumps key by key.")
    p.add_argument("first")
    p.add_argument("second")
    p.add_argument("--rtol", type=float, default=1e-3)
    p.add_argument("--atol", type=float, default=1e-3)
    args = p.parse_args(argv)
    ok = compare(load_dump(args.first), load_dump(args.second), args.rtol, args.atol)
    print("allclose" if ok else "NOT allclose")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
