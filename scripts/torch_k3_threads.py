#!/usr/bin/env python3
"""The slow-token sampler kernel (K3, smoltts_torch/csrc/sampling.cu) built
with different numbers of threads per block, side by side.

    python3 scripts/torch_k3_threads.py                   # needs one CUDA card
    python3 scripts/torch_k3_threads.py --threads 256,320 # the block sizes to compare

Compiles sampling.cu alone once per block size into build/k3_threads/
(-DSMOLTTS_K3_THREADS=128, 256, 320 and 512 by default, the nvcc runs at
once) and drives the slow-token site (`sample_slow_token`) through each
build in turns (128, 256, 320, 512, 512, 320, 256, 128) on the same
inputs: logits of the 150M vocabulary (V=2368) at B=1 and 64, bf16 and
f32, T 0.7 and min-p 0.05, and greedy at B=64 bf16. Prints K3's own device
time per call (profiler, by kernel name) and whether the builds' ids agree
on one seed. Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _libraries(threads):
    from smoltts_torch.ops import _build

    out = ROOT / "build" / "k3_threads"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for t in threads:
        lib = out / f"libk3_{t}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-DSMOLTTS_K3_THREADS={t}",
               str(_build.CSRC / "sampling.cu"), "-o", str(lib)]
        procs[t] = (lib, subprocess.Popen(cmd))
    handles = {}
    for t, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {t} threads")
        h = ctypes.CDLL(str(lib))
        h.smoltts_sample_tokens.restype = ctypes.c_int
        h.smoltts_sample_tokens.argtypes = _build.SAMPLE_TOKENS_ARGTYPES
        handles[t] = h
    return handles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="128,256,320,512", help="comma-separated block sizes")
    threads = tuple(int(t) for t in ap.parse_args(argv).threads.split(","))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", flush=True)
        return 2
    from chip_smoke import K3_KERNEL, device_by_name, nvidia_smi
    from smoltts_torch.config import smoltts_byte_150m
    from smoltts_torch.lm.samplers import GenerationSettings
    from smoltts_torch.ops import _build
    from smoltts_torch.ops import sampling as SP
    from smoltts_torch.tokenizer import TokenConfig

    handles = _libraries(threads)
    dev = torch.device("cuda")
    cfg = smoltts_byte_150m()
    tok = TokenConfig.smoltts_v0(cfg.codebook_size)
    sampled = GenerationSettings(default_temp=0.7, min_p=0.05)
    greedy = GenerationSettings(default_temp=0.0)
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, B, dtype, settings in (("B=64 bf16", 64, torch.bfloat16, sampled),
                                      ("B=64 f32", 64, torch.float32, sampled),
                                      ("B=1 bf16", 1, torch.bfloat16, sampled),
                                      ("B=1 f32", 1, torch.float32, sampled),
                                      ("B=64 bf16 greedy", 64, torch.bfloat16, greedy)):
        logits = (torch.randn((B, cfg.vocab_size), generator=g, device=dev) * 2.0).to(dtype)
        cases.append((label, logits, settings, torch.zeros(B, dtype=torch.bool, device=dev)))
    times = collections.defaultdict(list)
    ids = {}
    for t in threads + threads[::-1]:
        with mock.patch.object(_build, "lib", lambda h=handles[t]: h):
            for label, logits, settings, fin in cases:
                gen = torch.Generator(device=dev).manual_seed(1)
                ids[t, label] = SP.sample_slow_token(logits, gen, settings, tok, fin)
                site = lambda: SP.sample_slow_token(logits, gen, settings, tok, fin)
                times[t, label].append(device_by_name(site, K3_KERNEL)[0])
    print(f"K3 device ms per call by threads per block (passes {threads + threads[::-1]}), "
          f"on {nvidia_smi()}:", flush=True)
    for label, *_ in cases:
        same = all(bool((ids[threads[0], label] == ids[t, label]).all()) for t in threads)
        row = ", ".join(f"{t}: {times[t, label]}" for t in threads)
        print(f"  {label:18s} {row}; ids equal across builds {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
