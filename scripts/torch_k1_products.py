#!/usr/bin/env python3
"""Where one frame of the port's fast micro-loop kernel (K1,
smoltts_torch/csrc/fast_loop.cu) spends its device time, product by product.

    python3 scripts/torch_k1_products.py            # needs one CUDA card
    python3 scripts/torch_k1_products.py --no-pdl   # launches without programmatic dependent launch

Drives the fused fast micro-loop at the 150M widths, B=64, bf16, sampled
(temperature 0.7, min-p 0.05) on seeded random int8 weights, profiles three
frames and prints, for the middle one: its span (first kernel start to last
kernel end), the sum of its kernels' durations, and for each kind of kernel
(init, qkv, attention, wo, w13, w2, head, sample) the count, the mean
duration and the grid. Under programmatic dependent launch a kernel's
duration includes the time it waits for its predecessor, so durations add
up to more than the span; with --no-pdl (a copy of fast_loop.cu whose
launches drop that attribute, built into build/k1_products/) each duration
is the kernel's own. Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _no_pdl_library():
    from smoltts_torch.ops import _build

    out = ROOT / "build" / "k1_products"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fast_loop.cu").read_text()
    attr = "programmaticStreamSerializationAllowed = 1;"
    if attr not in src:
        raise RuntimeError("fast_loop.cu no longer sets the programmatic-serialization attribute")
    (out / "fast_loop.cu").write_text(src.replace(attr, attr.replace("1", "0")))
    nvcc, flags = _build._nvcc(), _build.NVCC_FLAGS + ["-I", str(_build.CSRC)]
    sources = [out / "fast_loop.cu", _build.CSRC / "decode_attention.cu", _build.CSRC / "sampling.cu"]
    procs = [subprocess.Popen([nvcc, *flags, "-c", str(s), "-o", str(out / f"{s.stem}.o")])
             for s in sources]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("nvcc failed")
    lib = out / "libk1_no_pdl.so"
    subprocess.check_call([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                           *(str(out / f"{s.stem}.o") for s in sources), "-o", str(lib)])
    handle = ctypes.CDLL(str(lib))
    _build._declare(handle)
    _build.check(handle.smoltts_fast_loop_setup(), "fast_loop setup")
    _build._lib = handle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-pdl", action="store_true",
                    help="build a copy that launches without programmatic dependent launch")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", flush=True)
        return 2
    from smoltts_torch.config import smoltts_byte_150m
    from smoltts_torch.lm.samplers import GenerationSettings
    from smoltts_torch.models.dual_ar import init_params
    from smoltts_torch.ops import _build
    from smoltts_torch.ops import fast_loop as FL
    from smoltts_torch.ops.quant import fuse_decode_params, quantize_decode_params

    if args.no_pdl:
        _no_pdl_library()
    else:
        _build.lib()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = smoltts_byte_150m().replace(dropout=0.0, use_gradient_checkpointing=False)
    params = quantize_decode_params(fuse_decode_params(
        init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16, device=dev)))
    settings = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05)
    gen = torch.Generator(device=dev).manual_seed(3)
    hidden = torch.randn((64, cfg.dim), generator=gen, device=dev).bfloat16()
    frame = lambda: FL.fused_fast_micro_loop(params, cfg, hidden, gen, settings)
    for _ in range(5):
        frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            frame()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    own = sorted((e for e in events if e.get("cat") == "kernel" and any(
        k in e["name"] for k in ("gemm_i8", "fast_attn", "fast_sample", "init_h"))),
        key=lambda e: e["ts"])
    per_level = ["qkv", "attention", "wo", "w13", "w2"] * cfg.n_fast_layer + ["head", "sample"]
    names = ["init"] + per_level * cfg.max_fast_seqlen
    if len(own) != 3 * len(names):
        raise RuntimeError(f"{len(own)} K1 kernels in 3 frames, expected {3 * len(names)}")
    one = own[len(names):2 * len(names)]
    total, count, grid = collections.defaultdict(float), collections.Counter(), {}
    for name, e in zip(names, one):
        total[name] += e["dur"]
        count[name] += 1
        grid[name] = e["args"].get("grid")
    span = one[-1]["ts"] + one[-1]["dur"] - one[0]["ts"]
    print(f"K1 frame, 150M B=64 bf16 sampled, {'without' if args.no_pdl else 'with'} programmatic "
          f"dependent launch, on {smi}: span {span:.1f} us, kernel durations sum to "
          f"{sum(total.values()):.1f} us, {len(one)} kernels", flush=True)
    for name in dict.fromkeys(names):
        print(f"  {name:9s} x{count[name]:<3d} {total[name]:8.1f} us, {total[name] / count[name]:6.2f} us "
              f"each, grid {grid[name]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
