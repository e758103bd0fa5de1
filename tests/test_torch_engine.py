"""PyTorch port, the continuous-batching engine on the CPU with the tiny
config (greedy): the cases of the JAX package's tests/test_engine.py,
test_engine_vocoder.py and test_engine_economics.py, by name, against the
port's own single-stream paths; the slot scatters of the Mimi streaming
state against the JAX package's, bit for bit; and a long-lived engine whose
idle slots run past S and flush. EngineLoop waits are bounded and every
loop stops in `finally`."""

import os
import queue
import sys
import time

import numpy as np
import pytest
import torch

from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.config import ModelType, tiny_debug_config
from smoltts_torch.lm.decode import init_decode_state
from smoltts_torch.lm.engine import DecodeEngine, EngineLoop
from smoltts_torch.lm.generate import FrameGenerator, pad_prompts
from smoltts_torch.lm.pipeline import make_prefill_step, make_stream_step
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig
from tests import torch_threads  # noqa: F401  (one intra-op thread)

CB = 32
MIMI = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)
GREEDY = dict(default_temp=0.0, default_fast_temp=0.0)
TIMEOUT = 60  # seconds an EngineLoop test waits for any one frame


def setup(vocoder=False):
    cfg = tiny_debug_config(codebook_size=CB, vocab_size=256 + 64 + CB)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    if not vocoder:
        return cfg, tok, params
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


def engine(cfg, tok, params, settings, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("kv_dtype", torch.float32)
    kw.setdefault("prompt_bucket", 8)
    return DecodeEngine(params, cfg, tok, settings, device="cpu", **kw)


def drain(eng, collected, max_steps=200):
    for _ in range(max_steps):
        for sid, frame in eng.step():
            collected.setdefault(sid, []).append(frame)
        if not eng.has_work():
            return collected
    raise AssertionError("engine did not drain")


def single_stream_codes(cfg, tok, params, settings, prompt):
    gen = FrameGenerator(params, cfg, tok, settings, [prompt], max_seq_len=64,
                         kv_dtype=torch.float32, device="cpu")
    return [f.audio_codes[0].numpy() for f in gen]


def single_stream_pcm(cfg, tok, params, mcfg, mimi, prompt, n_frames, settings):
    prefill = make_prefill_step(cfg, tok, settings, mcfg, device="cpu")
    step = make_stream_step(cfg, tok, settings, mcfg, device="cpu")
    state = init_decode_state(cfg, 1, 64, dtype=torch.float32, device="cpu")
    ms = tm.decode_stream_init(mcfg, 1, device="cpu")
    padded, lens = pad_prompts([prompt], pad_to_multiple=8)
    state, ms, _, out = prefill(params, mimi, state, ms, torch.from_numpy(padded),
                                torch.from_numpy(lens), None)
    codes, pcm = [out.audio_codes[0].numpy()], [out.pcm[0, :, 0].numpy()]
    for _ in range(n_frames - 1):
        state, ms, _, out = step(params, mimi, state, ms, None)
        codes.append(out.audio_codes[0].numpy())
        pcm.append(out.pcm[0, :, 0].numpy())
    return codes, pcm


# ---- tests/test_engine.py ----------------------------------------------------


def test_staggered_admission_matches_single_stream():
    cfg, tok, params = setup()
    settings = GenerationSettings(**GREEDY, max_new_tokens=5)
    prompts = [audio_prompt(cfg, tok, 6, s) for s in range(3)]
    singles = [single_stream_codes(cfg, tok, params, settings, p) for p in prompts]
    eng = engine(cfg, tok, params, settings)
    sids = [eng.submit(prompts[0]), eng.submit(prompts[1])]
    collected = {sid: [] for sid in sids}
    for step in range(20):
        if step == 2:  # the third stream waits for a slot to free
            sids.append(eng.submit(prompts[2]))
            collected[sids[-1]] = []
        for sid, frame in eng.step():
            collected[sid].append(frame)
        if not eng.has_work():
            break
    assert not eng.has_work()
    for sid, ref in zip(sids, singles):
        got = [f["audio_codes"] for f in collected[sid]]
        assert len(got) == len(ref), f"stream {sid}: {len(got)} vs {len(ref)}"
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_slot_reuse_and_eviction():
    cfg, tok, params = setup()
    eng = engine(cfg, tok, params, GenerationSettings(**GREEDY, max_new_tokens=2), num_slots=1)
    p = audio_prompt(cfg, tok, 4, 9)
    s1, s2 = eng.submit(p), eng.submit(p)  # the second waits for slot 0
    frames = drain(eng, {})
    assert len(frames[s1]) == 2 and len(frames[s2]) == 2
    assert eng._free == [0]
    eng.dispatch_step()  # nothing to admit or advance: marks the freed slot on the device
    assert bool(eng.state.finished.all()) and not eng._to_mark


def test_engine_loop_thread():
    cfg, tok, params = setup()
    eng = engine(cfg, tok, params, GenerationSettings(default_temp=0.7, default_fast_temp=0.7,
                                                      max_new_tokens=3),
                 generator=torch.Generator().manual_seed(5))
    loop = EngineLoop(eng)
    try:
        q = loop.submit(audio_prompt(cfg, tok, 4, 3))
        frames = []
        while True:
            item = q.get(timeout=TIMEOUT)
            if item is None:
                break
            frames.append(item)
        assert 1 <= len(frames) <= 3
        assert frames[-1]["finished"]
    finally:
        loop.stop()


def test_attend_bucket_switching_is_exact():
    """The engine walks through tiny attend buckets as live positions grow and
    gives exactly the frames of an unbucketed engine."""
    cfg, tok, params = setup()
    settings = GenerationSettings(**GREEDY, max_new_tokens=12)

    def run(buckets):
        eng = engine(cfg, tok, params, settings, prompt_bucket=4, attend_buckets=buckets)
        sids = [eng.submit(audio_prompt(cfg, tok, 4, 1)),
                eng.submit(audio_prompt(cfg, tok, 20, 2), 16)]
        out, limits = {sid: [] for sid in sids}, []
        for _ in range(40):
            for sid, f in eng.step():
                out[sid].append(f["audio_codes"])
            if eng.last_attend_limit is not None:
                limits.append(eng.last_attend_limit)
            if not eng.has_work():
                break
        return out, limits

    ref, ref_limits = run([64])
    got, limits = run([8, 16, 32])
    assert set(ref_limits) == {64}
    # the long prompt (20) starts in bucket 32 and crosses into 64 (= S)
    assert limits[0] == 32 and 64 in limits
    for (_, rf), (_, gf) in zip(sorted(ref.items()), sorted(got.items())):
        assert len(rf) == len(gf)
        for a, b in zip(rf, gf):
            np.testing.assert_array_equal(a, b)


def test_attend_bucket_with_vocoder():
    cfg, tok, params, mcfg, mimi = setup(vocoder=True)
    eng = engine(cfg, tok, params, GenerationSettings(**GREEDY, max_new_tokens=6),
                 prompt_bucket=4, attend_buckets=[16], mimi_params=mimi, mimi_cfg=mcfg)
    sid = eng.submit(audio_prompt(cfg, tok, 5, 7))
    pcm = [f["pcm"] for f in drain(eng, {})[sid]]
    assert len(pcm) == 6 and all(p.ndim == 1 and p.shape == (mcfg.samples_per_frame,) for p in pcm)
    assert eng.last_attend_limit in (16, 64)


def test_chunked_dispatch_matches_single_frame():
    """chunk_frames > 1 emits the same greedy frames as single-frame
    dispatch, PCM and a mid-chunk budget end included."""
    cfg, tok, params, mcfg, mimi = setup(vocoder=True)
    settings = GenerationSettings(**GREEDY, max_new_tokens=7)
    prompts = [audio_prompt(cfg, tok, 6, s) for s in range(2)]

    def run(chunk):
        eng = engine(cfg, tok, params, settings, mimi_params=mimi, mimi_cfg=mcfg,
                     chunk_frames=chunk)
        sids = [eng.submit(p) for p in prompts]
        got = drain(eng, {})
        return [got[s] for s in sids]

    for ref, chunked in zip(run(1), run(4)):
        assert len(ref) == len(chunked)
        for a, b in zip(ref, chunked):
            np.testing.assert_array_equal(a["audio_codes"], b["audio_codes"])
            assert a["finished"] == b["finished"] and a["slow_token"] == b["slow_token"]
            np.testing.assert_allclose(a["pcm"], b["pcm"], rtol=2e-4, atol=1e-5)


# ---- tests/test_engine_vocoder.py --------------------------------------------


def test_engine_pcm_matches_single_stream():
    cfg, tok, params, mcfg, mimi = setup(vocoder=True)
    settings = GenerationSettings(**GREEDY, max_new_tokens=4)
    prompts = [audio_prompt(cfg, tok, 6, s) for s in range(3)]
    refs = [single_stream_pcm(cfg, tok, params, mcfg, mimi, p, 4, settings) for p in prompts]
    eng = engine(cfg, tok, params, settings, mimi_params=mimi, mimi_cfg=mcfg)
    sids = [eng.submit(p) for p in prompts]  # 3 streams on 2 slots
    got = drain(eng, {})
    for sid, (rcodes, rpcm) in zip(sids, refs):
        assert len(got[sid]) == len(rpcm)
        for f, c, p in zip(got[sid], rcodes, rpcm):
            np.testing.assert_array_equal(f["audio_codes"], c)
            np.testing.assert_allclose(f["pcm"], p, rtol=2e-4, atol=1e-5)


def test_engine_emit_int16():
    """int16 frames are clip(pcm) * 32767 truncated toward zero, on the
    device: equal to the host conversion of the single stream's PCM."""
    cfg, tok, params, mcfg, mimi = setup(vocoder=True)
    settings = GenerationSettings(**GREEDY, max_new_tokens=3)
    prompt = audio_prompt(cfg, tok, 6, 0)
    _, ref = single_stream_pcm(cfg, tok, params, mcfg, mimi, prompt, 3, settings)
    eng = engine(cfg, tok, params, settings, num_slots=1, mimi_params=mimi, mimi_cfg=mcfg,
                 emit_format="int16")
    sid = eng.submit(prompt)
    got = [f["pcm"] for f in drain(eng, {})[sid]]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.int16
        np.testing.assert_array_equal(g, (np.clip(r, -1, 1) * 32767.0).astype(np.int16))


# ---- tests/test_engine_economics.py ------------------------------------------


def econ_engine(**kw):
    cfg, tok, params, mcfg, mimi = setup(vocoder=True)
    kw.setdefault("num_slots", 4)
    eng = engine(cfg, tok, params, GenerationSettings(**GREEDY, max_new_tokens=64),
                 mimi_params=mimi, mimi_cfg=mcfg, **kw)
    return eng, lambda s: audio_prompt(cfg, tok, 6, s)


def test_steady_state_fetch_economics():
    K, n_frames = 4, 24
    eng, prompt = econ_engine(chunk_frames=K, inflight=1, fetch_every=1)
    for s in range(4):
        eng.submit(prompt(s), max_frames=n_frames)
    collected = drain(eng, {})
    assert all(len(v) == n_frames for v in collected.values())
    s = eng.stats
    assert s["dispatches"] <= n_frames // K + 2, s
    n_records = s["dispatches"] + 1  # + one admission record (a batch of 4)
    assert s["records_fetched"] == n_records, s
    assert s["fetch_calls"] <= n_records, s
    frames_emitted = sum(len(v) for v in collected.values())
    assert s["fetch_calls"] / frames_emitted <= 1.0 / K + 0.05, s


def test_admission_first_frame_is_urgent():
    eng, prompt = econ_engine(chunk_frames=4, inflight=2, fetch_every=2)
    for s in range(2):
        eng.submit(prompt(s), max_frames=40)
    for _ in range(3):
        eng.step()
    sid = eng.submit(prompt(9), max_frames=40)
    emitted = eng.step()
    assert any(s == sid for s, _ in emitted), [s for s, _ in emitted]
    assert eng.stats["urgent_fetched"] >= 1
    drain(eng, {})


def test_proactive_slot_release_admits_before_fetch():
    eng, prompt = econ_engine(num_slots=2, chunk_frames=2, inflight=4, fetch_every=4)
    short = [eng.submit(prompt(s), max_frames=4) for s in range(2)]
    waiting = eng.submit(prompt(7), max_frames=4)
    for _ in range(3):
        eng.dispatch_step()
    assert eng._streams[waiting].slot >= 0, "the waiting stream was not admitted proactively"
    assert eng.stats["fetch_calls"] <= 1, eng.stats
    collected = drain(eng, {})
    assert all(len(collected[s]) == 4 for s in short + [waiting])
    for s in short + [waiting]:
        assert collected[s][-1]["finished"]


def _drain_loop(qs):
    got = 0
    for q in qs:
        while True:
            try:
                fr = q.get(timeout=TIMEOUT)
            except queue.Empty:
                raise AssertionError(f"stream wedged: no frame within {TIMEOUT} s")
            if fr is None:
                break
            got += 1
    return got


def test_shallow_max_ahead_never_wedges():
    eng, prompt = econ_engine(inflight=1, fetch_every=8, chunk_frames=2)
    loop = EngineLoop(eng, max_ahead=2, fetchers=3)
    try:
        assert eng.fetch_every == 1  # clamped to the drain invariant
        assert _drain_loop([loop.submit(prompt(0), max_frames=4) for _ in range(4)]) == 16
    finally:
        loop.stop()


def test_first_audio_latency_decomposition():
    eng, prompt = econ_engine(inflight=1, fetch_every=1, chunk_frames=2)
    loop = EngineLoop(eng, max_ahead=3, fetchers=3)
    try:
        qs = [loop.submit(prompt(0), max_frames=6) for _ in range(3)]
        _drain_loop(qs)
        for q in qs:
            t = eng.pop_timing(q.sid)
            assert t is not None
            for k in ("queue_wait", "dispatch_wait", "fetch", "deliver", "total"):
                assert t[k] >= 0.0, (k, t)
            parts = t["queue_wait"] + t["dispatch_wait"] + t["fetch"] + t["deliver"]
            assert abs(parts - t["total"]) < 1e-6, t
            assert eng.pop_timing(q.sid) is None
    finally:
        loop.stop()


def test_max_ahead_at_or_below_inflight_never_wedges():
    eng, prompt = econ_engine(inflight=2, fetch_every=1, chunk_frames=1)
    loop = EngineLoop(eng, max_ahead=2, fetchers=3)
    try:
        assert eng.inflight + eng.fetch_every <= 2  # the drain invariant restored
        assert _drain_loop([loop.submit(prompt(0), max_frames=8) for _ in range(2)]) == 16
    finally:
        loop.stop()


# ---- the port's own properties ------------------------------------------------


def test_engine_loop_under_thread_stress():
    """More fetch threads than cores and a 10 us switch interval: every
    stream still receives exactly its frames, in order, equal to a
    single-threaded run of the same schedule (greedy), so no frame is lost,
    duplicated or reordered across threads."""
    cfg, tok, params = setup()
    settings = GenerationSettings(**GREEDY, max_new_tokens=64)
    prompts = [audio_prompt(cfg, tok, 4 + s % 3, s) for s in range(10)]
    budgets = [3 + s % 4 for s in range(10)]
    eng = engine(cfg, tok, params, settings, num_slots=4)
    sids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    got = drain(eng, {})
    ref = [[f["audio_codes"] for f in got[s]] for s in sids]
    eng = engine(cfg, tok, params, settings, num_slots=4)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    loop = EngineLoop(eng, max_ahead=3, fetchers=min((os.cpu_count() or 1) + 1, 33))
    try:
        qs = [loop.submit(p, b) for p, b in zip(prompts, budgets)]
        for q, want in zip(qs, ref):
            frames = []
            while (f := q.get(timeout=TIMEOUT)) is not None:
                frames.append(f["audio_codes"])
            assert len(frames) == len(want)
            for a, b in zip(frames, want):
                np.testing.assert_array_equal(a, b)
    finally:
        loop.stop()
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in [loop._dispatcher, *loop._fetchers])


def test_engine_loop_keeps_frame_order_behind_a_late_urgent_fetch():
    """The urgent fetcher lands every admission record 0.3 s late while the
    bulk fetchers run on: each stream's frames still equal the single-
    threaded run of the same schedule, in order (a later record never
    overtakes the one that carries a stream's first frame)."""
    cfg, tok, params = setup()
    settings = GenerationSettings(**GREEDY, max_new_tokens=64)
    prompts = [audio_prompt(cfg, tok, 4 + s % 3, s) for s in range(6)]
    budgets = [4 + s % 3 for s in range(6)]
    eng = engine(cfg, tok, params, settings, num_slots=4)
    sids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    got = drain(eng, {})
    ref = [[f["audio_codes"] for f in got[s]] for s in sids]
    eng = engine(cfg, tok, params, settings, num_slots=4)
    fetch = eng.fetch

    def late_urgent_fetch(records):
        if records and all(r.urgent for r in records):
            time.sleep(0.3)
        return fetch(records)

    eng.fetch = late_urgent_fetch
    loop = EngineLoop(eng, max_ahead=3, fetchers=3)
    try:
        qs = [loop.submit(p, b) for p, b in zip(prompts, budgets)]
        for q, want in zip(qs, ref):
            frames = []
            while (f := q.get(timeout=TIMEOUT)) is not None:
                frames.append(f["audio_codes"])
            assert len(frames) == len(want)
            for i, (a, b) in enumerate(zip(frames, want)):
                np.testing.assert_array_equal(a, b, err_msg=f"stream {q.sid} frame {i}")
    finally:
        loop.stop()
    assert not any(t.is_alive() for t in [loop._dispatcher, *loop._fetchers])


def test_idle_slots_past_S_flush_without_error():
    """A freed slot keeps advancing on the device (its output is masked):
    with a long prompt it passes S while another stream runs on, and the
    flushes that follow drop its tail entries past S instead of failing;
    the live stream's frames equal its single-stream run."""
    cfg, tok, params = setup()
    S = 64
    settings = GenerationSettings(**GREEDY, max_new_tokens=20)
    eng = engine(cfg, tok, params, settings, max_seq_len=S, tail_len=4, prompt_bucket=4)
    long_prompt, prompt = audio_prompt(cfg, tok, 56, 4), audio_prompt(cfg, tok, 4, 5)
    idle = eng.submit(long_prompt, max_frames=2)
    live = eng.submit(prompt, max_frames=20)
    got = drain(eng, {})
    assert len(got[idle]) == 2 and len(got[live]) == 20
    assert int(eng.state.pos.max()) > S  # the freed slot ran past S
    gen = FrameGenerator(params, cfg, tok, settings, [prompt], max_seq_len=S,
                         kv_dtype=torch.float32, device="cpu")
    ref = [f.audio_codes[0].numpy() for f in gen]
    for f, r in zip(got[live], ref):
        np.testing.assert_array_equal(f["audio_codes"], r)


def test_records_do_not_alias_the_state():
    """A record's payload is a snapshot: freeing a slot and later steps
    write the state in place without changing frames dispatched before."""
    cfg, tok, params = setup()
    eng = engine(cfg, tok, params, GenerationSettings(**GREEDY, max_new_tokens=3), inflight=4)
    sid = eng.submit(audio_prompt(cfg, tok, 4, 1))
    for _ in range(3):
        eng.dispatch_step()
    rec = [r for r in eng._queue if not r.urgent][-1]  # the frame that ended the budget
    eng._mark_freed()  # in place on the state's finished flags
    assert not bool(rec.payload[2][0, 0]) and bool(eng.state.finished[0])
    assert all(t.data_ptr() != s.data_ptr() for t in rec.payload if t is not None
               for s in (eng.state.finished, eng.state.prev_tokens))
    assert len(drain(eng, {})[sid]) == 3


def test_warm_leaves_the_engine_state_alone():
    cfg, tok, params, mcfg, mimi = setup(vocoder=True)
    eng = engine(cfg, tok, params, GenerationSettings(**GREEDY), mimi_params=mimi, mimi_cfg=mcfg,
                 chunk_frames=2, attend_buckets=[16, 32])
    before = [t.clone() for t in eng.state if t is not None]
    before_m = [t.clone() for t in tm.stream_state_leaves(eng.mimi_state)]
    eng.warm(progress=lambda s: None)
    after = [t for t in eng.state if t is not None]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    after_m = tm.stream_state_leaves(eng.mimi_state)
    assert len(after_m) == len(before_m)
    assert all(torch.equal(a, b) for a, b in zip(before_m, after_m))
    assert eng.stats["dispatches"] == 0 and not eng.has_work()


def test_engine_refuses_the_cpu_unless_asked(monkeypatch):
    cfg, tok, params = setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(params, cfg, tok, GenerationSettings(), num_slots=1, max_seq_len=16)
