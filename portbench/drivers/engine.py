"""Serving through the continuous-batching engine: `EngineLoop.submit`
over a `DecodeEngine` with the Mimi vocoder attached, driven by one client
thread in a closed loop (a fixed number of clients, each sending its next
request when its last one ends) or an open loop (requests sent when due,
on a Poisson schedule).

Set-up (timed as setup_s): the seeded weights on the device, the program's
own int8 trees from them, the engine at the traffic's settings, and a warm
pass over every admission size at every prompt bucket the traffic can
produce and every attend bucket. Then a lead-in, the measured window, and
after its close a wait (at most 60 s) for the first frame of every request
sent inside it. The traced run profiles a steady sub-window in the middle
of the window, and after the window times the LM frame and the vocoder step
alone at the engine's batch.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from portbench import check, traffic as traffic_gen, weights
from portbench.drivers.common import RunResult, time_ms
from portbench.tracing import Profiler

LATE_S = 60.0  # how long after the close a first frame is waited for


def token_config(vocab: dict, model: dict):
    from smoltts_torch.tokenizer import TokenConfig

    return TokenConfig(im_end_id=vocab["im_end"], pad_id=vocab["semantic_pad"],
                       semantic_start_id=vocab["semantic_start"],
                       semantic_end_id=vocab["semantic_start"] + model["codebook_size"] - 1)


def settings(traffic: dict):
    from smoltts_torch.lm.samplers import GenerationSettings

    s = traffic["sampling"]
    return GenerationSettings(default_temp=s["temp"], default_fast_temp=s["fast_temp"],
                              min_p=s.get("min_p"))


def program_trees(config: dict, seed: int, device):
    """The program's serving trees from the seed's weights, as its loaders
    build them: the LM fused and (int8) quantized, the Mimi tree fused."""
    from smoltts_torch.codec.config import MimiConfig
    from smoltts_torch.codec.mimi import params_from_hf_state_dict
    from smoltts_torch.config import DualARConfig
    from smoltts_torch.io.checkpoint import params_from_state_dict
    from smoltts_torch.ops.quant import (
        fuse_decode_params, fuse_mimi_decode_params, quantize_decode_params,
        quantize_mimi_params,
    )

    model, codec, serving = config["model"], config["codec"], config["serving"]
    cfg = DualARConfig.from_dict(model)
    params = fuse_decode_params(params_from_state_dict(
        weights.make_state(weights.dual_ar_specs(model), seed, device), cfg))
    if serving["lm_weights"] == "int8":
        params = quantize_decode_params(params)
    mcfg = MimiConfig(**{k: v for k, v in codec.items() if k in MimiConfig.__dataclass_fields__})
    mimi = fuse_mimi_decode_params(params_from_hf_state_dict(
        weights.make_state(weights.mimi_specs(codec), seed, device, stream=1), mcfg))
    if codec.get("int8_linears"):
        mimi = quantize_mimi_params(mimi)
    return cfg, params, mcfg, mimi


class Probe:
    """Benchmark-side instrumentation of one engine: spans (host clock)
    around its admissions, frame steps and flushes while `tracing` is set,
    and a host mirror of every slot's cache position and flushed length (for
    K2's bytes). Wraps only what the engine has."""

    def __init__(self, eng):
        self.pos = np.zeros(eng.num_slots, np.int64)
        self.flushed = np.zeros(eng.num_slots, np.int64)
        self.log: List[tuple] = []  # span metadata, by span index
        self.spans: List[tuple] = []  # (label, t0, t1) on perf_counter
        self.tracing = False
        for name in ("_admit", "_advance", "_flush"):
            if callable(getattr(eng, name, None)):
                setattr(eng, name, getattr(self, "_wrap" + name)(getattr(eng, name)))

    def _call(self, kind: str, meta: tuple, fn, *args):
        if not self.tracing:
            return fn(*args)
        idx = len(self.log)
        self.log.append((kind, *meta))
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.spans.append((f"portbench.{kind}#{idx}", t0, time.perf_counter()))

    def _wrap_admit(self, fn):
        def _admit(state, mstate, slots, prompt, lens, generator):
            self.pos[slots] = lens
            self.flushed[slots] = lens
            return self._call("admit", (len(slots),), fn, state, mstate, slots, prompt, lens,
                              generator)
        return _admit

    def _wrap_advance(self, fn):
        def _advance(state, mstate, K, lim, generator):
            frames = [(int(np.minimum(self.flushed, lim).sum()),
                       int((self.pos + j - self.flushed + 1).sum())) for j in range(K)]
            self.pos += K
            return self._call("advance", (K, lim, frames), fn, state, mstate, K, lim, generator)
        return _advance

    def _wrap_flush(self, fn):
        def _flush(state, mstate):
            self.flushed[:] = self.pos
            return self._call("flush", (), fn, state, mstate)
        return _flush


def prompt_buckets(traffic: dict, bucket: int) -> List[int]:
    """Every padded prompt length the traffic's requests can take."""
    longest = traffic["text_bytes"]["max"] + traffic_gen.CHATML_TOKENS
    return list(range(bucket, -(-longest // bucket) * bucket + 1, bucket))


def build(cell, seed: int, device):
    from smoltts_torch.lm.engine import DecodeEngine, EngineLoop

    t, e = cell.traffic, cell.traffic["engine"]
    cfg, params, mcfg, mimi = program_trees(cell.config, seed, device)
    kv = {"int8": torch.int8, "bf16": torch.bfloat16}[cell.config["serving"]["kv_cache"]]
    eng = DecodeEngine(params, cfg, token_config(cell.config["vocab"], cell.config["model"]),
                       settings(t), num_slots=e["num_slots"], max_seq_len=e["max_seq_len"],
                       kv_dtype=kv, generator=torch.Generator(device=device).manual_seed(seed),
                       prompt_bucket=e["prompt_bucket"], mimi_params=mimi, mimi_cfg=mcfg,
                       attend_buckets=e["attend_buckets"], inflight=e["inflight"],
                       fetch_every=e["fetch_every"], emit_format=e["emit_format"],
                       chunk_frames=e["chunk_frames"], device=device)
    del params, mimi
    for i, T in enumerate(prompt_buckets(t, e["prompt_bucket"])):
        eng.warm(prompt_len=T, buckets=None if i == 0 else [])
    return eng, EngineLoop(eng, max_ahead=e["max_ahead"], fetchers=e["fetchers"])


class Clients:
    """The client side, through the engine's public API only: in a closed
    loop one thread per client, each sending a request (`EngineLoop.submit`,
    which waits for the engine's lock), reading its frames as they arrive
    and sending the next when it ends; in an open loop one thread that sends
    each request when it is due, on a thread of its own. Each frame is
    stamped when its client takes it."""

    def __init__(self, loop, eng, traffic: dict, reqs, seed: int):
        self.loop, self.eng, self.traffic = loop, eng, traffic
        self.pending = iter(reqs)
        self.sent: List = []
        self.closed = threading.Event()  # the window has closed: send no more
        self.stop = threading.Event()  # the run is over: stop reading
        self.lateness = []  # open loop: how late each request was sent, s
        self.seed = seed
        self.threads: List[threading.Thread] = []
        self._lock = threading.Lock()

    def _next(self):
        with self._lock:
            req = None if self.closed.is_set() else next(self.pending, None)
            if req is not None:
                self.sent.append(req)
            return req

    def serve(self, req) -> None:
        """One request, from its sending to its end."""
        req.submit = time.perf_counter()
        q = self.loop.submit(req.prompt, max_frames=req.budget)
        while not self.stop.is_set():
            try:
                frame = q.get(timeout=0.25)
            except queue.Empty:
                continue
            now = time.perf_counter()
            if frame is None:  # its end, unless the run's stop cut it short
                if not self.stop.is_set():
                    req.ended = now
                return
            if req.first is None:
                req.first = now
                t = self.eng.pop_timing(q.sid)
                if t is not None:
                    req.queue_wait = t["queue_wait"]
            req.arrivals.append(now)
            req.frames.append(frame)

    def _client(self, req) -> None:
        while req is not None and not self.stop.is_set():
            self.serve(req)
            req = self._next()

    def _spawn(self, fn, *args) -> None:
        th = threading.Thread(target=fn, args=args, daemon=True)
        self.threads.append(th)
        th.start()

    def start(self, t0: float) -> None:
        if self.traffic["loop"] == "closed":
            first = [self._next() for _ in range(self.traffic["clients"])]
            traffic_gen.residual_budgets(first, self.seed)
            for r in first:
                self._spawn(self._client, r)
        else:
            self._spawn(self._schedule, t0)

    def _schedule(self, t0: float) -> None:
        reqs = list(self.pending)
        for due, req in zip(t0 + traffic_gen.poisson_arrivals(self.traffic, len(reqs), self.seed),
                            reqs):
            while not self.closed.is_set() and time.perf_counter() < due:
                time.sleep(min(0.002, max(0.0, due - time.perf_counter())))
            if self.closed.is_set():
                return
            req.due = due
            self.lateness.append(time.perf_counter() - due)
            self.sent.append(req)
            self._spawn(self.serve, req)

    def finish(self, timeout: float) -> None:
        """After the close: wait until every request sent before it has its
        first frame (at most `timeout`), then stop reading."""
        self.closed.set()
        end = time.perf_counter() + timeout
        while time.perf_counter() < end and any(
                r.first is None and r.ended is None for r in list(self.sent)):
            time.sleep(0.01)
        self.stop.set()


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device=None) -> RunResult:
    """One run of a serving cell; `device` is CUDA unless a test drives the
    program's plain path on the CPU (no trace there)."""
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    eng, loop = build(cell, seed, device)
    if trace:  # the profiler's one-time start-up (CUPTI) belongs to set-up
        warm = Profiler()
        warm.start()
        warm.stop()
        del warm
    probe = Probe(eng)
    setup_s = time.perf_counter() - t_start
    t = cell.traffic
    reqs = traffic_gen.requests(t, cell.config["vocab"], eng.cfg.num_rows, seed)
    clients = Clients(loop, eng, t, reqs, seed)
    t0 = time.perf_counter()
    t_open = t0 + t["lead_in_s"]
    t_close = t_open + seconds
    marks = {}
    clients.start(t0)
    trace_at = t_open + max(0.0, (seconds - t["trace_s"]) / 2)
    prof = Profiler() if trace else None
    for name, at in (("open", t_open), ("trace", trace_at), ("trace_end", None),
                     ("close", t_close)):
        if name.startswith("trace") and not trace:
            continue
        if at is not None:
            time.sleep(max(0.0, at - time.perf_counter()))
        if name == "trace":
            prof.start()
            probe.tracing = True
        elif name == "trace_end":
            time.sleep(t["trace_s"])
            probe.tracing = False
            prof.stop()
        elif name == "close":
            clients.closed.set()
        with loop._lock:
            marks[name] = (time.perf_counter(), dict(eng.stats))
    clients.finish(LATE_S)
    loop.stop()
    for th in clients.threads:
        th.join(timeout=5)

    # The stretches of the window the profiler did not slow: the whole window,
    # or in a traced run the window less the traced sub-window.
    bounds = [marks[k] for k in ("open", "trace", "trace_end", "close") if k in marks]
    quiet = [(a, b) for a, b in zip(bounds[0::2], bounds[1::2])]
    ctx = {"window_s": marks["close"][0] - marks["open"][0], "t_open": marks["open"][0],
           "t_close": marks["close"][0], "requests": clients.sent, "setup_s": setup_s,
           "model": cell.config["model"], "codec": cell.config["codec"],
           "num_slots": eng.num_slots, "lateness": clients.lateness,
           "quiet": [(a[0], b[0]) for a, b in quiet],
           "stats": {k: sum(b[1][k] - a[1][k] for a, b in quiet) for k in marks["open"][1]}}
    notes = []
    if clients.lateness:
        notes.append(f"open loop: requests sent at most {max(clients.lateness) * 1e3} ms "
                     f"after they were due")
    if trace:
        tr = prof.read(probe.spans)
        ctx.update(trace=tr, probe_log=probe.log, tail_len=eng.tail_len)
        notes.append(f"trace: {prof.trace_bytes} bytes, {len(tr.kernels)} device operations, "
                     f"{sum(k.launch is not None for k in tr.kernels)} matched to their launch, "
                     f"{sum(k.span is not None for k in tr.kernels)} to one of "
                     f"{len(tr.spans)} spans")
        lims = Counter(m[2] for m in probe.log if m[0] == "advance")
        ctx.update(after_window_timings(eng, lims.most_common(1)[0][0] if lims else None))
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finished = [r for r in clients.sent if r.ended is not None and r.frames]
    in_window = [r for r in clients.sent
                 if r.start is not None and ctx["t_open"] <= r.start < ctx["t_close"]]
    failed = sum(1 for r in in_window if r.first is None)
    del eng, loop, probe, clients
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.served(cell.config, cell.workload, seed, finished, device)
    t_check = time.perf_counter() - t_check
    ctx["finished"] = finished
    return RunResult(setup_s=setup_s, attempted=len(in_window), failed=failed, ctx=ctx,
                     numbers=numbers, memory_peak_bytes=memory_peak,
                     notes=notes + [f"set-up {setup_s} s; window {ctx['window_s']} s; sent "
                            f"{len(ctx['requests'])}, {len(in_window)} in the window; engine "
                            f"counters in the window {ctx['stats']}",
                            f"the reference check took {t_check} s; streams ended early on <|im_end|>: "
                            f"{sum(1 for r in finished if len(r.frames) < r.budget)} of "
                            f"{len(finished)} finished"])


@torch.no_grad()
def after_window_timings(eng, lim: Optional[int]) -> dict:
    """The LM frame and the vocoder step each alone at the engine's batch,
    on its state after the window (CUDA events; nothing advances)."""
    if lim is None:
        return {}
    from smoltts_torch.codec.mimi import mimi_decode_step
    from smoltts_torch.lm.decode import decode_frame

    gen = torch.Generator(device=eng.device).manual_seed(0)
    codes = torch.zeros((eng.num_slots, eng.cfg.num_codebooks, 1), dtype=torch.int32,
                        device=eng.device)
    state, mstate = eng._flush(eng.state, eng.mimi_state)
    lm = time_ms(lambda: decode_frame(eng.params, eng.cfg, eng.token_cfg, eng.settings, state,
                                      gen, attend_limit=lim))
    voc = time_ms(lambda: mimi_decode_step(eng.mimi_params, eng.mimi_cfg, mstate, codes))
    return {"lm_frame_ms": lm, "vocoder_step_ms": voc, "lm_frame_lim": lim}
