"""Training through the program's train step (`make_train_step` over the
port's AdamW) at the published job's settings, one batch of packed
synthetic ChatML rows a step.

Set-up (setup_s) builds one train state from the seed's weights, then
drives it through its first three steps with the window's own call and
feed (distinct rows), recording what the reference then checks: each
step's loss, the first gradient as the optimizer got it, the change of the
parameters over the three. The same state goes on into the window, which
counts the steps completed in it (a synchronize at the close). The traced
run profiles a few steps in the middle of the window.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

import numpy as np
import torch

from portbench import check_train, data, weights
from portbench.check import Number
from portbench.drivers.common import RunResult
from portbench.tracing import Profiler

CHECK_STEPS = 3
POOL = 32  # distinct batches, cycled through the window
TRUNK_LEAVES = {"wqkv": "attention.wqkv.weight", "wo": "attention.wo.weight",
                "w1": "feed_forward.w1.weight", "w2": "feed_forward.w2.weight",
                "w3": "feed_forward.w3.weight", "attention_norm": "attention_norm.weight",
                "ffn_norm": "ffn_norm.weight"}


def leaf_names(params) -> list:
    """The program's leaves in its optimizer's order (dict keys sorted), by
    the release names of the reference's leaf groups."""
    out = []
    for key in sorted(params):
        if isinstance(params[key], dict):
            out += [f"{key}.{TRUNK_LEAVES[k]}" for k in sorted(params[key])]
        else:
            out.append(f"{key}.weight")
    return out


def step_seeds(seed: int, n: int) -> list:
    return [int(s) for s in np.random.default_rng([int(seed), 0x57E9]).integers(0, 2**62, n)]


def build(cell, seed: int, device):
    from smoltts_torch.config import DualARConfig, TrainingConfig
    from smoltts_torch.io.checkpoint import params_from_state_dict
    from smoltts_torch.train.trainer import init_train_state, make_train_step

    model, job = cell.config["model"], cell.config["training"]
    cfg = DualARConfig.from_dict(model)
    tc = TrainingConfig.from_dict({k: v for k, v in job.items() if k != "source"})
    state = weights.make_state(weights.dual_ar_specs(model), seed, device)
    params = params_from_state_dict({k: v.clone() for k, v in state.items()}, cfg)
    del state
    ts, tx = init_train_state(params, tc)
    return cfg, tc, ts, tx, make_train_step(cfg, tc, tx)


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device=None) -> RunResult:
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    job = cell.config["training"]
    B, T = job["batch_size"], job["max_sequence_length"]
    cfg, tc, ts, tx, step = build(cell, seed, device)
    pool = data.batches(POOL, B, T, cell.config["model"], cell.config["vocab"], seed)
    seeds = step_seeds(seed, 100_000)
    names = leaf_names(ts.params)
    leaves = tx.param_groups[0]["params"]
    start = [p.detach().clone() for p in leaves]
    b1 = tc.betas[0]
    prog: Dict[str, object] = {"losses": []}
    for i in range(CHECK_STEPS):
        ts, m = step(ts, pool[i], seeds[i])
        prog["losses"].append(float(m["loss"]))
        if i == 0:
            prog["grad"] = {n: float(torch.linalg.vector_norm(tx.state[p]["mu"].float()) / (1 - b1))
                            for n, p in zip(names, leaves)}
    prog["update"] = {n: float(torch.linalg.vector_norm(p.detach().float() - s.float()))
                      for n, p, s in zip(names, leaves, start)}
    del start
    if trace:  # the profiler's one-time start-up belongs to set-up
        warm = Profiler()
        warm.start()
        warm.stop()
    sync()
    setup_s = time.perf_counter() - t_start

    i = CHECK_STEPS
    prof, traced = None, None
    t_open = time.perf_counter()
    t_close = t_open + seconds
    trace_at = t_open + max(0.0, (seconds - cell.traffic["trace_s"]) / 2)
    marks = {}
    while time.perf_counter() < t_close:
        if trace and prof is None and time.perf_counter() >= trace_at:
            sync()
            prof = Profiler()
            prof.start()
            marks["trace"] = (time.perf_counter(), i)
        if prof is not None and traced is None and i - marks["trace"][1] >= cell.traffic["trace_steps"]:
            prof.stop()
            traced = prof.read()
            marks["trace_end"] = (time.perf_counter(), i)
        ts, _ = step(ts, pool[i % POOL], seeds[i])
        i += 1
    sync()
    t_end = time.perf_counter()
    steps = i - CHECK_STEPS
    ctx = {"window_s": t_end - t_open, "steps": steps, "batch": B, "seq": T,
           "model": cell.config["model"], "setup_s": setup_s}
    if "trace_end" in marks:
        ctx.update(trace=traced, trace_steps=marks["trace_end"][1] - marks["trace"][1],
                   quiet_s=ctx["window_s"] - (marks["trace_end"][0] - marks["trace"][0]),
                   quiet_steps=steps - (marks["trace_end"][1] - marks["trace"][1]))
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx["memory_peak_bytes"] = memory_peak
    del ts, tx, step, leaves
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    ref = check_train.reference_readings(cell.config, seed, pool[:CHECK_STEPS],
                                         seeds[:CHECK_STEPS], device)
    t_check = time.perf_counter() - t_check
    ctx.update(prog=prog, ref=ref, pool=pool[:CHECK_STEPS], step_seeds=seeds[:CHECK_STEPS])
    limits = cell.workload.get("check", {}).get("limits", {})
    got = check_train.gaps(prog, ref)
    numbers = [Number(k, v, limits.get(k)) for k, v in got.items()]
    return RunResult(setup_s=setup_s, attempted=steps, failed=0, ctx=ctx, numbers=numbers,
                     memory_peak_bytes=memory_peak,
                     notes=[f"set-up {setup_s} s; window {ctx['window_s']} s; {steps} steps "
                            f"of {B} x {T}; losses {prog['losses']} (reference {ref['losses']}); "
                            f"median leaf grad norm {statistics.median(ref['grad'].values())}; "
                            f"the reference check took {t_check} s"]
                     + ([f"trace: {prof.trace_bytes} bytes"] if prof is not None else []))
