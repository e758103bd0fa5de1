"""PyTorch port, the server with continuous batching on the CPU: concurrent
/stream requests share the engine's slots and /metrics counts them (the case
of tests/test_server_engine.py); blocking requests run beside engine streams
without corrupting either; the /stream executor does not starve fast streams
behind blocked ones (tests/test_server_concurrency.py, with a stub engine);
stopping the loop ends open streams."""

import http.client
import json
import queue as _queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smoltts_torch.codec.mimi import decode_stream_init
from smoltts_torch.codec.transformer import flush_transformer_ring
from smoltts_torch.io.wav import pcm_to_int16
from smoltts_torch.lm.decode import init_decode_state
from smoltts_torch.lm.generate import pad_prompts
from smoltts_torch.lm.pipeline import make_flush_step, make_prefill_step, make_stream_step
from smoltts_torch.server.app import build_app, build_engine_loop
from smoltts_torch.server.tts_core import TTSCore
from tests.test_torch_server import HOP, make_tts, post, serve, shut, write_checkpoint
from tests import torch_threads  # noqa: F401  (one intra-op thread)

TEXTS = ["request number 0", "request number 1", "a third request"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    write_checkpoint(d)
    core = TTSCore(make_tts(d, default_temp=0.0, default_fast_temp=0.0, max_new_tokens=5,
                            audio_only_constraint=True))
    loop = build_engine_loop(core, num_slots=2)
    app = build_app(core, engine_loop=loop)
    port, th = serve(app)
    yield port, core, loop
    shut(app, th)
    loop.stop()
    assert not any(t.is_alive() for t in [loop._dispatcher, *loop._fetchers])


def _stream(port, text):
    r = post(port, "/v1/text-to-speech/0/stream", {"text": text}, timeout=180)
    return r.status, r.read()


def _run_all(jobs):
    results, threads = {}, []
    for key, fn in jobs.items():
        threads.append(threading.Thread(target=lambda k=key, f=fn: results.__setitem__(k, f())))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return results


def test_concurrent_streams_and_metrics(served):
    port = served[0]
    results = _run_all({i: (lambda i=i: _stream(port, TEXTS[i])) for i in range(3)})
    for i, (status, body) in results.items():
        assert status == 200, i
        assert len(body) % (HOP * 2) == 0
        assert len(body) > 0

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/metrics")
    m = json.loads(conn.getresponse().read())
    assert m["requests"] == 3
    assert m["frames"] >= 3
    assert "first_audio_ms_p50" in m
    # the engine's counters, the lock's by role among them
    eng = m["engine"]
    assert eng["lock_acquires.submit"] == 3 and eng["frame_steps"] > 0
    for role in ("dispatch", "fetch", "submit", "other"):
        assert eng[f"lock_held_s.{role}"] >= 0 and eng[f"lock_wait_s.{role}"] >= 0
    assert eng["dispatch_s"] > 0


def single_stream(core, engine, prompt, n_frames, flush_before=()):
    """The prompt alone at B=1 through the prefill and stream steps, with the
    engine's KV and vocoder-state dtype, prompt bucket and attend limit, and
    its schedule: the admission's ring flush (`scatter_stream_state`) after
    the first frame, and an engine flush before each frame in
    `flush_before`. Returns (codes [n, 8], int16 PCM)."""
    m = core.model
    args = (m.config, m.token_config, m.generation_settings, m.codec_config)
    state = init_decode_state(m.config, 1, engine.S, dtype=engine.kv_dtype, device="cpu")
    ms = decode_stream_init(m.codec_config, 1, dtype=engine.kv_dtype, device="cpu")
    padded, lens = pad_prompts([prompt], pad_to_multiple=engine.prompt_bucket)
    state, ms, _, out = make_prefill_step(*args, device="cpu")(
        m.params, m.codec_params, state, ms, torch.from_numpy(padded), torch.from_numpy(lens), None)
    ms = ms._replace(transformer=flush_transformer_ring(ms.transformer))
    step = make_stream_step(*args, attend_limit=engine.attend_buckets[0], device="cpu")
    flush = make_flush_step(device="cpu")
    outs = [out]
    for f in range(1, n_frames):
        if f in flush_before:
            state, ms = flush(state, ms)
        state, ms, _, out = step(m.params, m.codec_params, state, ms, None)
        outs.append(out)
    codes = torch.stack([o.audio_codes[0] for o in outs]).numpy()
    return codes, pcm_to_int16(torch.cat([o.pcm[0, :, 0] for o in outs]).float().numpy())


def tap(loop):
    """Record what the loop serves: each stream's prompt, the frames it
    emitted in emission order, and the frame indices before which the
    engine flushed while the stream was live."""
    eng, rec = loop.engine, SimpleNamespace(prompts={}, frames={}, flushes={})
    submit, emit, flush = loop.submit, loop._emit, eng._flush

    def tapped_submit(prompt, max_frames=None):
        q = submit(prompt, max_frames)
        rec.prompts[q.sid] = np.asarray(prompt)
        return q

    def tapped_emit(frames):
        for sid, frame in frames:
            rec.frames.setdefault(sid, []).append(frame)
        emit(frames)

    def tapped_flush(state, mstate):
        for sid, h in eng._streams.items():
            if h.slot >= 0:
                rec.flushes.setdefault(sid, []).append(1 + h.frames_dispatched)
        return flush(state, mstate)

    loop.submit, loop._emit, eng._flush = tapped_submit, tapped_emit, tapped_flush
    return rec


def test_blocking_requests_beside_engine_streams(tmp_path):
    """Two blocking requests and two engine streams at once (greedy, the
    engine's bf16 KV and vocoder state): each blocking body equals the model
    called alone, byte for byte; each stream body is the int16 frames the
    engine emitted for it, whose codes equal the prompt's B=1 single stream
    in order and whose PCM is within 1 LSB of it."""
    write_checkpoint(tmp_path)
    core = TTSCore(make_tts(tmp_path, default_temp=0.0, default_fast_temp=0.0, max_new_tokens=5,
                            audio_only_constraint=True))
    loop = build_engine_loop(core, num_slots=2)
    rec = tap(loop)
    app = build_app(core, engine_loop=loop)
    port, th = serve(app)
    try:
        jobs = {("stream", t): (lambda t=t: _stream(port, t)) for t in TEXTS[:2]}
        for t in TEXTS[1:]:
            jobs[("pcm", t)] = lambda t=t: (lambda r: (r.status, r.read()))(
                post(port, "/v1/text-to-speech/0?output_format=pcm_24000", {"text": t}))
        results = _run_all(jobs)
    finally:
        shut(app, th)
        loop.stop()
    assert len(rec.prompts) == 2
    for (kind, text), (status, body) in results.items():
        assert status == 200, (kind, text)
        got = np.frombuffer(body, np.int16)
        assert got.size > 0 and got.size % HOP == 0
        if kind == "pcm":
            assert body == pcm_to_int16(core.model(text, "0")).tobytes()
            continue
        prompt = core.model._get_prompt(text, "0")
        sid = next(s for s, p in rec.prompts.items() if np.array_equal(p, prompt))
        frames = rec.frames[sid]
        assert body == b"".join(f["pcm"].tobytes() for f in frames)
        codes, want = single_stream(core, loop.engine, prompt, len(frames), rec.flushes.get(sid, ()))
        np.testing.assert_array_equal(np.stack([f["audio_codes"] for f in frames]), codes)
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


class _StubEngineLoop:
    """EngineLoop facade: submit() -> Queue; the test injects the frames."""

    def __init__(self, num_slots=64):
        self.engine = SimpleNamespace(num_slots=num_slots, pop_timing=lambda sid: None)
        self.queues = []
        self._lock = threading.Lock()

    def submit(self, prompt, max_frames=None):
        q = _queue.Queue()
        q.sid = len(self.queues)
        with self._lock:
            self.queues.append(q)
        return q


class _StubCore:
    def __init__(self):
        self.model = SimpleNamespace(
            _get_prompt=lambda text, voice: np.zeros((9, 4), np.int32), sampling_rate=24_000)


def test_fast_streams_not_starved_by_blocked_slow_streams():
    """36 streams whose queues stay empty each park one q.get (more than the
    default executor's 32 threads on any host); then 16 streams whose first
    frames are already queued must get them in well under a second."""
    N_SLOW, N_FAST, T_SLOW = 36, 16, 8.0
    loop = _StubEngineLoop(num_slots=64)
    app = build_app(_StubCore(), engine_loop=loop)
    port, th = serve(app)
    frame = {"pcm": np.zeros(64, np.float32), "finished": False}
    firsts, lock = {}, threading.Lock()

    def client(i):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        t0 = time.perf_counter()
        conn.request("POST", "/v1/text-to-speech/0/stream", '{"text": "x"}',
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        resp.read(64)  # blocks until the first PCM chunk
        with lock:
            firsts[i] = time.perf_counter() - t0
        resp.read()
        conn.close()

    try:
        slow = [threading.Thread(target=client, args=(i,)) for i in range(N_SLOW)]
        for t in slow:
            t.start()
        deadline = time.time() + 10
        while len(loop.queues) < N_SLOW and time.time() < deadline:
            time.sleep(0.02)
        assert len(loop.queues) >= N_SLOW
        time.sleep(0.3)  # let the q.get executor tasks park
        t_fast = time.perf_counter()
        fast = [threading.Thread(target=client, args=(N_SLOW + i,)) for i in range(N_FAST)]
        for t in fast:
            t.start()
        while len(loop.queues) < N_SLOW + N_FAST and time.perf_counter() - t_fast < 10:
            time.sleep(0.01)
        for q in loop.queues[N_SLOW:]:
            q.put(dict(frame))
            q.put(dict(frame, finished=True))
            q.put(None)
        for t in fast:
            t.join(timeout=30)
        for q in loop.queues[:N_SLOW]:
            q.put(dict(frame, finished=True))
            q.put(None)
        for t in slow:
            t.join(timeout=30)
    finally:
        shut(app, th)
    fast_firsts = sorted(firsts.get(N_SLOW + i, float("inf")) for i in range(N_FAST))
    p50, worst = fast_firsts[len(fast_firsts) // 2], fast_firsts[-1]
    assert p50 < 2.0, f"fast-stream first-chunk p50 {p50:.2f}s (starved executor?)"
    assert worst < min(T_SLOW * 0.75, 6.0), f"worst fast first-chunk {worst:.2f}s"


def test_a_slow_submit_does_not_stall_other_streams():
    """EngineLoop.submit waits for the engine lock, which the dispatch thread
    holds through a whole dispatch: a stream whose submit waits 3 s must not
    hold up another stream whose frames are ready (the event loop keeps
    serving while the submit waits)."""
    class SlowSubmitLoop(_StubEngineLoop):
        def submit(self, prompt, max_frames=None):
            if prompt[0, 0] == 1:  # the slow request's prompt
                time.sleep(3.0)
            q = super().submit(prompt, max_frames)
            q.slow = bool(prompt[0, 0] == 1)
            return q

    def queue_of(slow):
        deadline = time.time() + 10
        while time.time() < deadline:
            found = [q for q in list(loop.queues) if q.slow == slow]
            if found:
                return found[0]
            time.sleep(0.01)
        raise AssertionError("the stream was never submitted")

    loop = SlowSubmitLoop(num_slots=4)
    core = _StubCore()
    core.model._get_prompt = lambda text, voice: np.full((9, 4), int(text == "slow"), np.int32)
    app = build_app(core, engine_loop=loop)
    port, th = serve(app)
    frame = {"pcm": np.zeros(64, np.float32), "finished": False}
    try:
        slow = threading.Thread(target=_stream, args=(port, "slow"))
        slow.start()
        time.sleep(0.3)  # the slow submit is waiting
        t0 = time.perf_counter()
        fast = threading.Thread(target=_stream, args=(port, "fast"))
        fast.start()
        for f in (dict(frame), dict(frame, finished=True), None):
            queue_of(False).put(f)
        fast.join(timeout=30)
        t_fast = time.perf_counter() - t0
        for f in (dict(frame, finished=True), None):
            queue_of(True).put(f)
        slow.join(timeout=30)
    finally:
        shut(app, th)
    assert not fast.is_alive() and t_fast < 2.0, f"fast stream took {t_fast:.2f} s"


def test_stopping_the_loop_ends_open_streams(served):
    """A stream still open when its loop stops gets its end-of-stream, so a
    consumer blocked on the queue (a /stream executor thread) wakes."""
    _, core, _ = served
    loop = build_engine_loop(core, num_slots=1)
    loop.stop()  # no dispatch thread: the stream stays queued
    q = loop.submit(core.model._get_prompt("never served", "0"))
    loop.stop()
    assert q.get(timeout=5) is None
