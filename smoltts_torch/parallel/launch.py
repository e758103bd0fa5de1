"""Run a function on N ranks of a local process group, with a wall-clock limit.

`run_ranks(fn, n, *args, timeout=..., backend=..., device=...)` spawns n
processes (the `spawn` start method), joins them to one process group over
`tcp://127.0.0.1:<free port>`, calls `fn(rank, *args)` in each and returns
the ranks' return values in rank order. A rank that raises, dies, or is
still running when the limit passes fails the whole call: the parent kills
every rank that is left (one that raised may leave the others blocked in a
collective) and raises with the failing rank's traceback. `fn` and its
arguments and results must pickle; `fn` must be importable by name.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Callable, List, Optional

from smoltts_torch import resolve_device


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, backend, device, threads, args, results):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n)
    try:
        import torch
        import torch.distributed as dist

        from smoltts_torch.parallel.mesh import init_distributed

        if threads:
            torch.set_num_threads(threads)
        init_distributed(f"127.0.0.1:{port}", n, rank, backend=backend, device=device)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, n: int, *args, timeout: float = 300.0,
              backend: Optional[str] = None, device=None, threads: int = 0) -> List:
    """fn(rank, *args) on n ranks -> [result of rank 0, ..., rank n-1].
    `backend` and `device` go to `init_distributed` (None: NCCL on CUDA,
    gloo on the CPU); `threads` > 0 sets each rank's torch thread count."""
    resolve_device(device)  # no CUDA card: raise here, before any rank starts
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, port, backend, device, threads, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"ranks {sorted(set(range(n)) - set(got))} still running after {timeout} s"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} raised:\n{out}"
        for p in procs:
            p.join(timeout=max(0.0, min(30.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if failure is None:
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            failure = f"ranks exited with codes {bad}"
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, {n}): {failure}")
    return [got[r] for r in range(n)]
