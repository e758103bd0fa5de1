"""PyTorch port, the program's own tracing on the CPU: the span recorder
(`utils/profiling.py` SPANS: nesting, the ring's bound and `dropped`, the
off switch, thread ids), the timed engine lock under a condition and under
thread stress, the spans and counters of a `DecodeEngine` + `EngineLoop`
run with the vocoder, `SmolTTS.stream`'s wait for its PCM, and greedy
outputs bit-identical with the recorder on and off."""

import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.config import ModelType, tiny_debug_config
from smoltts_torch.lm.decode import init_decode_state
from smoltts_torch.lm.engine import DecodeEngine, EngineLoop
from smoltts_torch.lm.generate import pad_prompts
from smoltts_torch.lm.pipeline import make_chunk_step, make_prefill_step, make_stream_step
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig
from smoltts_torch.utils.profiling import (
    LOCK_ROLES, SPANS, SpanRecorder, TimedLock, lock_counters,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_graph_stand_in import stand_in_graphs

CB = 32
MIMI = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)
GREEDY = dict(default_temp=0.0, default_fast_temp=0.0)
TIMEOUT = 60  # seconds a test waits for any one frame
K = 2  # the engine's chunk


def setup():
    cfg = tiny_debug_config(codebook_size=CB, vocab_size=256 + 64 + CB)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mcfg = MimiConfig(**MIMI)
    return cfg, tok, params, mcfg, tm.init_mimi_params(mcfg, seed=1, device="cpu")


def audio_prompt(cfg, tok, T, seed):
    rng = np.random.default_rng(seed)
    p = np.zeros((cfg.num_rows, T), np.int32)
    c0 = rng.integers(0, cfg.codebook_size, T)
    p[0] = tok.semantic_start_id + c0
    p[1] = c0
    p[2:] = rng.integers(0, cfg.codebook_size, (cfg.num_rows - 2, T))
    return p


def spans_since(t0, names=None):
    return [s for s in SPANS.snapshot() if s[1] >= t0 and (names is None or s[0] in names)]


def inside(inner, outer):
    return inner[3] == outer[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


# ---- the recorder --------------------------------------------------------------


def test_nested_spans_close_inner_first_inside_the_outer():
    rec = SpanRecorder()
    with rec.span("outer"):
        with rec.span("inner"):
            time.sleep(0.001)
        with rec.span("inner"):
            pass
    got = rec.snapshot()
    assert [s[0] for s in got] == ["inner", "inner", "outer"]
    assert all(inside(s, got[2]) for s in got[:2])
    assert got[0][2] <= got[1][1] and got[0][2] - got[0][1] >= 0.001
    assert all(s[3] == threading.get_ident() for s in got)


@pytest.mark.parametrize("maxlen,n", [(4, 3), (4, 4), (4, 9), (1, 5)])
def test_the_ring_keeps_the_newest_and_counts_what_it_dropped(maxlen, n):
    rec = SpanRecorder(maxlen=maxlen)
    for i in range(n):
        with rec.span(f"s{i}"):
            pass
    assert len(rec) == min(n, maxlen)
    assert rec.dropped == max(0, n - maxlen)
    assert [s[0] for s in rec.snapshot()] == [f"s{i}" for i in range(max(0, n - maxlen), n)]
    rec.clear()
    assert len(rec) == 0 and rec.dropped == 0


def test_disabled_records_nothing_and_exceptions_still_close_spans():
    rec = SpanRecorder()
    rec.enabled = False
    with rec.span("off"):
        pass
    assert rec.snapshot() == []
    rec.enabled = True
    with pytest.raises(ValueError):
        with rec.span("raised"):
            raise ValueError("x")
    assert [s[0] for s in rec.snapshot()] == ["raised"]


def test_each_span_carries_its_threads_id():
    rec, ids = SpanRecorder(), {}
    barrier = threading.Barrier(4)

    def work(i):
        ids[i] = threading.get_ident()
        barrier.wait(timeout=10)
        for _ in range(50):
            with rec.span(f"t{i}"):
                pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    got = rec.snapshot()
    assert len(got) == 200 and rec.dropped == 0
    assert all(s[3] == ids[int(s[0][1:])] for s in got)


# ---- the timed lock ------------------------------------------------------------


def test_the_timed_lock_counts_each_role_and_serves_a_condition():
    counters = lock_counters()
    assert set(counters) == {f"{k}.{r}" for r in LOCK_ROLES
                             for k in ("lock_wait_s", "lock_held_s", "lock_acquires")}
    lock = TimedLock(counters)
    cv = threading.Condition(lock.role("fetch"))
    ready, waiting = [], threading.Event()

    def waiter():
        with cv:
            waiting.set()
            while not ready:
                cv.wait(1.0)

    th = threading.Thread(target=waiter)
    t0 = time.perf_counter()
    th.start()
    assert waiting.wait(10)
    with lock.role("dispatch"):  # taken once the waiter waits
        time.sleep(0.02)
    with lock:  # "other"
        ready.append(1)
        cv.notify_all()
    th.join(timeout=10)
    wall = time.perf_counter() - t0
    assert not th.is_alive()
    assert counters["lock_acquires.dispatch"] == 1 and counters["lock_acquires.other"] == 1
    assert counters["lock_acquires.fetch"] >= 2  # entered, then re-taken after each wait
    assert counters["lock_held_s.dispatch"] >= 0.02
    assert counters["lock_acquires.submit"] == 0 and counters["lock_held_s.submit"] == 0
    # held excludes the condition's waits: the waiter held the lock briefly
    assert counters["lock_held_s.fetch"] < 0.02
    assert sum(counters[f"lock_held_s.{r}"] for r in LOCK_ROLES) <= wall
    assert not lock.locked() and lock.acquire(blocking=False)
    lock.release()


def test_the_timed_lock_under_thread_stress_loses_no_count():
    """Eight threads, a 10 us switch interval: every acquisition is counted
    under its role, holds never overlap, and the guarded counter is exact."""
    counters = lock_counters()
    lock = TimedLock(counters)
    box, n, roles = [0], 400, ("dispatch", "fetch", "submit", "other")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work(role):
        view = lock.role(role)
        for _ in range(n):
            with view:
                v = box[0]
                box[0] = v + 1

    threads = [threading.Thread(target=work, args=(roles[i % 4],)) for i in range(8)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads)
    assert box[0] == 8 * n
    assert all(counters[f"lock_acquires.{r}"] == 2 * n for r in roles)
    assert sum(counters[f"lock_held_s.{r}"] for r in roles) <= wall


# ---- the engine ----------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_run():
    """Three streams through an EngineLoop over a 2-slot engine with the
    vocoder and chunks of K frames: (engine, counters at __init__, counters
    after, the run's spans, wall seconds, submits)."""
    cfg, tok, params, mcfg, mimi = setup()
    eng = DecodeEngine(params, cfg, tok, GenerationSettings(**GREEDY, max_new_tokens=64),
                       num_slots=2, max_seq_len=64, kv_dtype=torch.float32, prompt_bucket=8,
                       mimi_params=mimi, mimi_cfg=mcfg, chunk_frames=K, inflight=1,
                       fetch_every=1, device="cpu")
    at_init = dict(eng.stats)
    t0 = time.perf_counter()
    loop = EngineLoop(eng, max_ahead=2, fetchers=2)
    try:
        qs = [loop.submit(audio_prompt(cfg, tok, 6, s), max_frames=6 + 2 * s) for s in range(3)]
        for q in qs:
            while q.get(timeout=TIMEOUT) is not None:
                pass
    finally:
        loop.stop()
    wall = time.perf_counter() - t0
    return eng, at_init, dict(eng.stats), spans_since(t0), wall, len(qs)


def test_engine_spans_nest_k_frames_and_vocoder_steps_in_each_chunk(engine_run):
    eng, _, stats, spans, _, submits = engine_run
    named = lambda n: [s for s in spans if s[0] == n]  # noqa: E731
    advances, chunks = named("engine.advance"), named("step.chunk")
    assert len(advances) == stats["dispatches"] > 0
    assert len(named("engine.admit")) >= 2  # two slots, three streams
    for adv in advances:
        (chunk,) = [c for c in chunks if inside(c, adv)]
        inner = sorted((s for s in spans if s[0] in ("lm.frame", "codec.step")
                        and inside(s, chunk)), key=lambda s: s[1])
        assert [s[0] for s in inner] == ["lm.frame", "codec.step"] * K
    # every frame and vocoder step of the run lies in a chunk
    assert len(named("lm.frame")) == len(named("codec.step")) == K * len(chunks)
    waits = named("engine.submit_wait")
    assert len(waits) == submits
    assert {s[3] for s in waits} == {threading.get_ident()}


def test_engine_counters_exist_from_init_and_grow(engine_run):
    _, at_init, stats, _, wall, submits = engine_run
    new = ["dispatch_s", "gate_wait_s"] + [f"{k}.{r}" for r in LOCK_ROLES
                                           for k in ("lock_wait_s", "lock_held_s",
                                                     "lock_acquires")]
    assert all(at_init[k] == 0 for k in new)
    assert stats["lock_acquires.submit"] == submits
    assert stats["lock_acquires.dispatch"] > stats["dispatches"]  # it also polls
    assert stats["lock_acquires.fetch"] >= stats["records_fetched"]
    assert stats["lock_acquires.other"] >= 1  # stop()
    assert 0 < stats["dispatch_s"] <= stats["lock_held_s.dispatch"]
    for r in LOCK_ROLES:
        assert stats[f"lock_wait_s.{r}"] >= 0 and stats[f"lock_held_s.{r}"] >= 0
    assert sum(stats[f"lock_held_s.{r}"] for r in LOCK_ROLES) <= wall
    assert 0 <= stats["gate_wait_s"] <= wall


# ---- the library -----------------------------------------------------------------


def test_stream_records_one_pcm_wait_per_chunk(tmp_path):
    from smoltts_torch import SmolTTS
    from smoltts_torch.io.checkpoint import save_params
    from smoltts_torch.tokenizer import save_byte_level_tokenizer

    cfg, _, params, mcfg, mimi = setup()
    save_params(params, cfg, tmp_path)
    save_byte_level_tokenizer(tmp_path, CB)
    tts = SmolTTS(tmp_path, device="cpu", generation_settings=GenerationSettings(
        **GREEDY, max_new_tokens=6, audio_only_constraint=True))
    tts.codec_config, tts.codec_params = mcfg, mimi
    t0 = time.perf_counter()
    chunks = list(tts.stream("Hi."))
    waits = spans_since(t0, {"stream.to_host"})
    assert len(chunks) == len(waits) == 6
    steps = spans_since(t0, {"step.prefill", "step.stream"})
    assert [s[0] for s in steps] == ["step.prefill"] + ["step.stream"] * 5
    # each chunk's wait follows the step that made it
    assert all(w[1] >= s[2] for w, s in zip(waits, steps))


# ---- the vocoder's graphs ----------------------------------------------------------


@pytest.mark.parametrize("graphs", ["stand-in", "cpu"])
def test_vocoder_captures_and_replays_nest_in_its_steps(graphs):
    """A graph's capture and its replays lie inside the `codec.step` that
    made them (the stand-in: a graph whose replay is the eager step); on the
    CPU the steps are eager and record neither."""
    with stand_in_graphs() if graphs == "stand-in" else contextlib.nullcontext():
        check_vocoder_spans(graphs)


def check_vocoder_spans(graphs):
    from smoltts_torch.codec.graph import VocoderGraphs

    cfg, tok, params, mcfg, mimi = setup()
    settings = GenerationSettings(**GREEDY, max_new_tokens=16)
    vocoder = VocoderGraphs()
    state = init_decode_state(cfg, 2, 64, dtype=torch.float32, device="cpu")
    ms = tm.decode_stream_init(mcfg, 2, device="cpu")
    padded, lens = pad_prompts([audio_prompt(cfg, tok, 6, s) for s in range(2)],
                               pad_to_multiple=8)
    t0 = time.perf_counter()
    state, ms, _, _ = make_prefill_step(cfg, tok, settings, mcfg, device="cpu", vocoder=vocoder)(
        params, mimi, state, ms, torch.from_numpy(padded), torch.from_numpy(lens), None)
    for step in (make_stream_step(cfg, tok, settings, mcfg, device="cpu", vocoder=vocoder),
                 make_chunk_step(cfg, tok, settings, mcfg, 2, device="cpu", vocoder=vocoder)):
        state, ms, _, _ = step(params, mimi, state, ms, None)
    mine = threading.get_ident()
    got = [s for s in spans_since(t0, {"codec.step", "codec.replay", "codec.capture"})
           if s[3] == mine]
    steps = [s for s in got if s[0] == "codec.step"]
    replays = [s for s in got if s[0] == "codec.replay"]
    captures = [s for s in got if s[0] == "codec.capture"]
    assert len(steps) == 4
    if graphs == "cpu":
        assert not replays and not captures
        return
    assert len(replays) == 4 and len(captures) == 1
    assert all(sum(inside(r, s) for s in steps) == 1 for r in replays + captures)
    assert inside(captures[0], steps[0]) and captures[0][2] <= replays[0][1]


# ---- the recorder changes nothing it records ------------------------------------


def _greedy_outputs(kind):
    cfg, tok, params, mcfg, mimi = setup()
    settings = GenerationSettings(**GREEDY, max_new_tokens=16)
    state = init_decode_state(cfg, 2, 64, dtype=torch.float32, device="cpu")
    ms = tm.decode_stream_init(mcfg, 2, device="cpu")
    padded, lens = pad_prompts([audio_prompt(cfg, tok, 6, s) for s in range(2)],
                               pad_to_multiple=8)
    state, ms, _, out = make_prefill_step(cfg, tok, settings, mcfg, device="cpu")(
        params, mimi, state, ms, torch.from_numpy(padded), torch.from_numpy(lens), None)
    outs = [out]
    step = (make_chunk_step(cfg, tok, settings, mcfg, 3, device="cpu") if kind == "chunk"
            else make_stream_step(cfg, tok, settings, mcfg, device="cpu"))
    for _ in range(3):
        state, ms, _, out = step(params, mimi, state, ms, None)
        outs.append(out)
    return [(o.audio_codes.numpy(), o.pcm.numpy()) for o in outs]


@pytest.mark.parametrize("kind", ["stream", "chunk"])
def test_greedy_codes_and_pcm_are_bit_identical_with_the_recorder_off(kind):
    t0 = time.perf_counter()
    SPANS.enabled = False
    try:
        off = _greedy_outputs(kind)
    finally:
        SPANS.enabled = True
    mine = threading.get_ident()
    assert not [s for s in spans_since(t0) if s[3] == mine]  # nothing recorded while off
    on = _greedy_outputs(kind)
    assert [s for s in spans_since(t0, {"step.prefill"}) if s[3] == mine]
    for (c0, p0), (c1, p1) in zip(off, on):
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(p0, p1)
