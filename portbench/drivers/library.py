"""Streaming through the library at B=1: `SmolTTS(dir, quantize).stream(
text, voice)`, one client sending its requests back to back, each chunk
stamped as the generator yields it (the PCM is on the host then).

Set-up (setup_s) writes a seeded checkpoint into a temporary directory
(portbench/checkpoint.py) and loads it with `SmolTTS`, then streams one
short request at every prompt bucket the traffic can produce. The
library's own steps are wrapped, on the benchmark's side, to keep the
served tokens of each stream (what the reference checks) and, in the
traced run, the spans of its prefill, frame and flush steps.
"""

from __future__ import annotations

import dataclasses
import gc
import tempfile
import time
from pathlib import Path
from typing import List

import torch

from portbench import check, checkpoint, traffic as traffic_gen, weights
from portbench.drivers.common import RunResult, time_ms
from portbench.drivers.engine import settings
from portbench.tracing import Profiler


class StepTap:
    """Wraps the library's step factories: each step it makes records the
    frame it produced (slow token, codes) into `frames`, keeps a host mirror
    of the stream's cache position, and, while `tracing`, its span."""

    def __init__(self, pipeline, attend_limit: int):
        self.pipeline, self.lim = pipeline, attend_limit
        self.frames: List[tuple] = []
        self.log: List[tuple] = []
        self.spans: List[tuple] = []
        self.tracing = False
        self.pos = self.flushed = 0
        self.prompt_len = 0  # the next stream's true prompt length
        self._orig = {n: getattr(pipeline, n) for n in
                      ("make_prefill_step", "make_stream_step", "make_flush_step")}
        for name, fn in self._orig.items():
            setattr(pipeline, name, self._factory(name, fn))

    def restore(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.pipeline, name, fn)

    def _span(self, kind, meta, fn, *args):
        if not self.tracing:
            return fn(*args)
        idx = len(self.log)
        self.log.append((kind, *meta))
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.spans.append((f"portbench.{kind}#{idx}", t0, time.perf_counter()))

    def _factory(self, name, make):
        def factory(*a, **kw):
            step = make(*a, **kw)
            if name == "make_flush_step":
                def flush(state, mstate):
                    self.flushed = self.pos
                    return self._span("flush", (), step, state, mstate)
                return flush
            if name == "make_prefill_step":
                def prefill(params, mimi, state, mstate, prompt, lens, gen):
                    self.pos = self.flushed = self.prompt_len
                    out = self._span("admit", (1,), step, params, mimi, state, mstate, prompt,
                                     lens, gen)
                    self.frames.append((out[3].slow_token, out[3].audio_codes))
                    return out
                return prefill

            def stream(params, mimi, state, mstate, gen):
                meta = (1, self.lim, [(min(self.flushed, self.lim), self.pos - self.flushed + 1)])
                self.pos += 1
                out = self._span("advance", meta, step, params, mimi, state, mstate, gen)
                self.frames.append((out[3].slow_token, out[3].audio_codes))
                return out
            return stream
        return factory

    def take(self) -> List[tuple]:
        """The frames recorded since the last call, on the host."""
        out = [(int(s[0]), c[0].cpu().numpy()) for s, c in self.frames]
        self.frames = []
        return out


def build(cell, seed: int, device):
    from smoltts_torch import SmolTTS

    config = cell.config
    lm = weights.make_state(weights.dual_ar_specs(config["model"]), seed, device)
    mimi = weights.make_state(weights.mimi_specs(config["codec"]), seed, device, stream=1)
    with tempfile.TemporaryDirectory() as d:
        ckpt = checkpoint.write(Path(d) / "checkpoint", config, lm, mimi)
        del lm, mimi
        return SmolTTS(ckpt, quantize=config["serving"]["library_quantize"],
                       generation_settings=settings(cell.traffic), device=device, seed=seed)


def serve_one(tts, tap, req, voice: str, t_close=None, clock=time.perf_counter):
    """Stream one request; stop early once past `t_close` (it then counts as
    far as it got). Returns whether it finished."""
    tts.generation_settings = dataclasses.replace(tts.generation_settings,
                                                  max_new_tokens=req.budget)
    tap.prompt_len = req.prompt.shape[1]
    req.submit = clock()
    gen = tts.stream(req.text, voice)
    finished = True
    for pcm in gen:
        now = clock()
        if req.first is None:
            req.first = now
        req.arrivals.append(now)
        req.frames.append({"pcm": pcm})
        if t_close is not None and now >= t_close:
            finished = False
            gen.close()
            break
    for f, (slow, codes) in zip(req.frames, tap.take()):
        f.update(slow_token=slow, audio_codes=codes)
    if finished:
        req.ended = clock()
    return finished


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device=None) -> RunResult:
    import smoltts_torch.lm.pipeline as pipeline

    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t, config = cell.traffic, cell.config
    tts = build(cell, seed, device)
    tap = StepTap(pipeline, tts.config.max_seq_len)
    voices = config["vocab"]["voices"]
    reqs = traffic_gen.requests(t, config["vocab"], tts.config.num_rows, seed)
    try:
        warm = traffic_gen.warm_requests(t, config["vocab"], tts.config.num_rows)
        for r in warm:
            serve_one(tts, tap, r, voices[r.speaker])
        if trace:  # the profiler's one-time start-up belongs to set-up
            p = Profiler()
            p.start()
            p.stop()
        setup_s = time.perf_counter() - t_start

        t0 = time.perf_counter()
        t_open, t_close = t0 + t["lead_in_s"], t0 + t["lead_in_s"] + seconds
        trace_at = t_open + max(0.0, (seconds - t["trace_s"]) / 2)
        prof, sent = (Profiler() if trace else None), []
        for r in reqs:
            now = time.perf_counter()
            if now >= t_close:
                break
            if prof is not None and prof.t0 is None and now >= trace_at:
                prof.start()
                tap.tracing = True
            if prof is not None and prof.t1 is None and prof.t0 is not None \
                    and now >= prof.t0 + t["trace_s"]:
                tap.tracing = False
                prof.stop()
            sent.append(r)
            serve_one(tts, tap, r, voices[r.speaker], t_close)
        if prof is not None and prof.t0 is not None and prof.t1 is None:
            tap.tracing = False
            prof.stop()
        ctx = {"window_s": t_close - t_open, "t_open": t_open, "t_close": t_close,
               "requests": sent, "setup_s": setup_s, "model": config["model"],
               "codec": config["codec"], "num_slots": 1, "tail_len": 128}
        if prof is not None and prof.t1 is not None:
            ctx.update(trace=prof.read(tap.spans), probe_log=tap.log,
                       quiet=[(t_open, prof.t0), (prof.t1, t_close)])
            ctx.update(after_window_timings(tts, reqs[0], settings(t)))
    finally:
        tap.restore()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finished = [r for r in sent if r.ended is not None and r.frames]
    in_window = [r for r in sent if t_open <= r.submit < t_close]
    failed = sum(1 for r in in_window if r.first is None)
    del tts, tap
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.served(config, cell.workload, seed, finished, device)
    t_check = time.perf_counter() - t_check
    ctx["finished"] = finished
    early = sum(1 for r in finished if len(r.frames) < r.budget)
    return RunResult(setup_s=setup_s, attempted=len(in_window), failed=failed, ctx=ctx,
                     numbers=numbers, memory_peak_bytes=memory_peak,
                     notes=([f"trace: {prof.trace_bytes} bytes"] if prof is not None else [])
                     + [f"set-up {setup_s} s; window {ctx['window_s']} s; sent {len(sent)}, "
                            f"{len(in_window)} in the window, {len(finished)} finished",
                            f"the reference check took {t_check} s; streams ended early on <|im_end|>: {early} of {len(finished)}"])


@torch.no_grad()
def after_window_timings(tts, req, gen_settings) -> dict:
    """The LM frame and the vocoder step each alone at B=1 on a stream's
    state after its prefill (CUDA events; nothing advances)."""
    from smoltts_torch.codec.mimi import decode_stream_init, mimi_decode_step
    from smoltts_torch.lm.decode import decode_frame, init_decode_state, prefill

    dev, cfg = tts.device, tts.config
    state = init_decode_state(cfg, 1, cfg.max_seq_len, dtype=tts.kv_dtype, device=dev)
    prompt = torch.from_numpy(req.prompt[None]).to(dev)
    lens = torch.tensor([req.prompt.shape[1]], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = prefill(tts.params, cfg, tts.token_config, gen_settings, state, prompt, lens, gen)
    mstate = decode_stream_init(tts.codec_config, 1, kv_dtype=torch.int8, device=dev)
    codes = torch.zeros((1, cfg.num_codebooks, 1), dtype=torch.int32, device=dev)
    lm = time_ms(lambda: decode_frame(tts.params, cfg, tts.token_config, gen_settings, state, gen))
    voc = time_ms(lambda: mimi_decode_step(tts.codec_params, tts.codec_config, mstate, codes))
    return {"lm_frame_ms": lm, "vocoder_step_ms": voc}
