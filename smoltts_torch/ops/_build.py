"""Build the CUDA sources under `smoltts_torch/csrc/` into one shared library
with a plain C interface, and load it with ctypes.

The build runs at first use, never at import: one `nvcc -c` per source, all
started together, then one link. Output goes to `build/smoltts_torch/` at the
repository root, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "smoltts_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-lineinfo",
]

_lib = None
_lock = threading.Lock()
BUILD_SECONDS = None  # wall time of the last build (None when loaded from disk)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if needed) and return the path of the shared library."""
    global BUILD_SECONDS
    out = BUILD_DIR / f"libsmoltts_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    cus, _ = _sources()
    tag = f"{os.getpid()}"
    procs = []
    for src in cus:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, errors = [], []
    for src, obj, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
        elif verbose:
            print(f"[nvcc {src.name}]\n{log}", flush=True)
        objs.append(obj)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build(verbose)))
            _declare(handle)
            _lib = handle
    return _lib


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def _declare(h: ctypes.CDLL) -> None:
    h.smoltts_decode_attention.restype = I
    h.smoltts_decode_attention.argtypes = [
        P,  # q [B, H, hd]
        P, P, P, P,  # k_hist, v_hist, k_scale, v_scale (scales may be null)
        ctypes.c_longlong, ctypes.c_longlong,  # hist stride b, stride h (elements)
        ctypes.c_longlong, ctypes.c_longlong,  # scale stride b, stride h
        P, P,  # k_tail, v_tail [B, n_kv, W, hd] contiguous
        P, P, P,  # pos [B], flushed [B], tail_pos [B, W]
        P,  # out [B, H*hd]
        I, I, I, I, I, I,  # B, H, n_kv, hd, lim, W
        I, I,  # dtype code (0 f32, 1 bf16), hist code (0 same, 1 int8)
        P,  # stream
    ]
    h.smoltts_sample_categorical.restype = I
    h.smoltts_sample_categorical.argtypes = [
        P, I, I, I,  # logits, B, V, row stride
        F, F, I,  # temperature, log(min_p), use min_p
        P,  # philox seed/offset [2] int64 on the device
        P,  # out [B] int32
        P,  # stream
    ]
    h.smoltts_fast_loop.restype = I
    h.smoltts_fast_loop.argtypes = [P, P]  # &FastLoopArgs, stream
    h.smoltts_fast_loop_part_floats.restype = ctypes.c_longlong
    h.smoltts_fast_loop_part_floats.argtypes = [I, I, I, I, I]  # B, D, F, CB, Nq


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")
