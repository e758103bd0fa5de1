"""PyTorch port, the LM frame over a decode state that stays in place
(lm/graph.py) on the CPU: the in-place frame over frames and flushes leaves
the given state holding what the chain of `decode_frame` gives, bf16 and
kv8; the flush writes in place the values it wrote out of place; the RoPE
tables keep their bits; the engine's state keeps every leaf's storage
across frames, flushes, admissions and freed slots; `LMFrameGraphs` takes
the eager path on the CPU and, with the stand-in recorder
(tests/torch_graph_stand_in.py), holds one graph per state and attend
limit, adds the recorded frame's launches per replay and returns outputs
that later frames do not change; the static seeds draw
what the eager calls draw; and the `lm_graph_share` reader."""

import contextlib
import dataclasses
import importlib.util
import time

import numpy as np
import pytest
import torch

from portbench import program_spans, registry
from smoltts_torch import ops
from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.config import ModelType, tiny_debug_config
from smoltts_torch.lm import decode as td
from smoltts_torch.lm.engine import DecodeEngine
from smoltts_torch.lm.generate import pad_prompts
from smoltts_torch.lm import graph as lm_graph
from smoltts_torch.lm.graph import LMFrameGraphs, frame_in_place, map_decode_state
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.models.layers import rope_cos_sin
from smoltts_torch.ops.quant import quantize_kv
from smoltts_torch.ops.sampling import StaticSeeds, philox_seed
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig
from smoltts_torch.utils.graphs import WARMUP
from smoltts_torch.utils.profiling import SPANS
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_graph_stand_in import stand_in_graphs

CB = 32
MIMI = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)
GREEDY = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
KV = pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8], ids=["bf16", "kv8"])


def setup():
    cfg = tiny_debug_config(codebook_size=CB, vocab_size=256 + 64 + CB)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    return cfg, tok, init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def audio_prompt(cfg, tok, T, seed):
    rng = np.random.default_rng(seed)
    p = np.zeros((cfg.num_rows, T), np.int32)
    c0 = rng.integers(0, cfg.codebook_size, T)
    p[0] = tok.semantic_start_id + c0
    p[1] = c0
    p[2:] = rng.integers(0, cfg.codebook_size, (cfg.num_rows - 2, T))
    return p


def prefilled(cfg, tok, params, kv, B=2, tail_len=4):
    state = td.init_decode_state(cfg, B, 32, dtype=kv, tail_len=tail_len, device="cpu")
    prompt, lens = pad_prompts([audio_prompt(cfg, tok, 5 + i, i) for i in range(B)],
                               pad_to_multiple=8)
    state, _ = td.prefill(params, cfg, tok, GREEDY, state, torch.from_numpy(prompt),
                          torch.from_numpy(lens), None)
    return state


def clone(state):
    return map_decode_state(torch.clone, state)


def ptrs(state):
    return [None if t is None else t.data_ptr() for t in state]


def assert_states_equal(a, b):
    for f in td.DecodeState._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), f


def assert_outputs_equal(a, b):
    for f in td.FrameOutput._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@KV
@pytest.mark.parametrize("entry", ["frame_in_place", "StandInGraphs"])
def test_the_in_place_frame_gives_the_chain_of_decode_frames(kv, entry):
    """`StandInGraphs`: `LMFrameGraphs` with the stand-in recorder."""
    cfg, tok, params = setup()
    graphed = entry == "StandInGraphs"
    with stand_in_graphs() if graphed else contextlib.nullcontext():
        step = LMFrameGraphs() if graphed else frame_in_place
        check_the_chain(cfg, tok, params, kv, step)


def check_the_chain(cfg, tok, params, kv, step):
    ref = prefilled(cfg, tok, params, kv)
    state = clone(ref)
    owned, held = ptrs(state), []
    for t in range(7):
        if t and t % 3 == 0:  # tail 4: flush before the ring wraps
            ref, state = td.flush_kv(ref), td.flush_kv(state)
        ref, want = td.decode_frame(params, cfg, tok, GREEDY, ref, None, attend_limit=16)
        got_state, out = step(params, cfg, tok, GREEDY, state, None, attend_limit=16)
        assert got_state is state and ptrs(state) == owned
        assert_states_equal(state, ref)
        assert_outputs_equal(out, want)
        held.append((out, td.FrameOutput(*(t.clone() for t in want))))
    for out, want in held:  # no later frame wrote an output returned before
        assert_outputs_equal(out, want)


def flush_out_of_place(state):
    """The flush as it was before it wrote its small leaves in place: new
    tail_pos, flushed and phase tensors."""
    S = state.k.shape[3]
    valid = ((state.tail_pos >= 0) & (state.tail_pos >= state.flushed[:, None])
             & (state.tail_pos < state.pos[:, None]) & (state.tail_pos < S))
    b_idx, w_idx = valid.nonzero(as_tuple=True)
    dst = state.tail_pos[b_idx, w_idx].long()
    state = clone(state)
    if state.k_scale is not None:
        kq, ks = quantize_kv(state.k_tail)
        vq, vs = quantize_kv(state.v_tail)
        state.k[:, b_idx, :, dst] = kq[:, b_idx, :, w_idx]
        state.v[:, b_idx, :, dst] = vq[:, b_idx, :, w_idx]
        state.k_scale[:, b_idx, :, dst] = ks[:, b_idx, :, w_idx]
        state.v_scale[:, b_idx, :, dst] = vs[:, b_idx, :, w_idx]
    else:
        state.k[:, b_idx, :, dst] = state.k_tail[:, b_idx, :, w_idx].to(state.k.dtype)
        state.v[:, b_idx, :, dst] = state.v_tail[:, b_idx, :, w_idx].to(state.v.dtype)
    return state._replace(tail_pos=torch.full_like(state.tail_pos, -1),
                          flushed=state.pos.clone(), phase=torch.zeros_like(state.phase))


@KV
def test_flush_writes_in_place_the_values_it_wrote_out_of_place(kv):
    cfg, tok, params = setup()
    state = prefilled(cfg, tok, params, kv)
    for _ in range(3):
        state, _ = frame_in_place(params, cfg, tok, GREEDY, state, None)
    want = flush_out_of_place(state)
    owned = ptrs(state)
    got = td.flush_kv(state)
    assert ptrs(got) == owned
    assert_states_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_tables_keep_their_bits(dtype):
    positions = torch.arange(0, 4096, 7)[:, None] + torch.arange(3)[None, :]
    for hd, base in ((64, 100_000), (16, 10_000.0), (128, 500_000)):
        exponent = torch.arange(0, hd, 2, dtype=torch.float32) / hd
        inv_freq = 1.0 / torch.pow(torch.tensor(float(base), dtype=torch.float32), exponent)
        angles = positions.float()[..., None] * inv_freq
        cos, sin = rope_cos_sin(positions, hd, base, dtype)
        assert torch.equal(cos, torch.cos(angles).to(dtype))
        assert torch.equal(sin, torch.sin(angles).to(dtype))


def test_the_engine_state_keeps_its_storage():
    """Frames (chunks of 2), flushes, admissions into reused slots and slots
    freed at their budget: every leaf of the engine's state stays put."""
    cfg, tok, params = setup()
    mcfg = MimiConfig(**MIMI)
    eng = DecodeEngine(params, cfg, tok, GREEDY, num_slots=2, max_seq_len=48,
                       kv_dtype=torch.int8, prompt_bucket=8, tail_len=4, chunk_frames=2,
                       mimi_params=tm.init_mimi_params(mcfg, seed=1, device="cpu"),
                       mimi_cfg=mcfg, admit_sizes=[1, 2], device="cpu")
    owned = ptrs(eng.state)
    for i in range(3):
        eng.submit(audio_prompt(cfg, tok, 5 + i, i), max_frames=3 + 2 * i)
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        assert ptrs(eng.state) == owned
    flushes = [s for s in SPANS.snapshot() if s[0] == "engine.flush" and s[1] >= t0]
    assert eng.stats["admissions"] >= 2 and flushes


def test_lm_frame_graphs_take_the_eager_path_on_the_cpu():
    cfg, tok, params = setup()
    graphs = LMFrameGraphs()
    ref = prefilled(cfg, tok, params, torch.int8)
    state = clone(ref)
    assert not graphs.graphed(params, cfg, GREEDY, state)
    ref, want = td.decode_frame(params, cfg, tok, GREEDY, ref, None)
    got, out = graphs(params, cfg, tok, GREEDY, state, None)
    assert got is state and not graphs._graphs
    assert_states_equal(state, ref)
    assert_outputs_equal(out, want)
    graphs.capture(params, cfg, tok, GREEDY, state)
    assert not graphs._graphs


def test_graphs_are_held_per_state_and_attend_limit(monkeypatch):
    cfg, tok, params = setup()
    frame = lm_graph.decode_frame

    def launching_frame(*a, **kw):  # one K1 launch a frame, as on the card
        ops.LAUNCHES["fast_loop"] += 1
        return frame(*a, **kw)

    monkeypatch.setattr(lm_graph, "decode_frame", launching_frame)
    with stand_in_graphs() as recorder:
        graphs = LMFrameGraphs(max_graphs=2)
        states = [prefilled(cfg, tok, params, torch.int8), prefilled(cfg, tok, params, torch.int8)]
        ref = clone(states[0])
        graphs.capture(params, cfg, tok, GREEDY, states[0], attend_limit=16)
        assert_states_equal(states[0], ref)  # a capture does not advance the state
        before = ops.LAUNCHES["fast_loop"]
        for state in states:
            graphs(params, cfg, tok, GREEDY, state, None, attend_limit=16)
        # another budget, the same sampling: the same graph
        graphs(params, cfg, tok, dataclasses.replace(GREEDY, max_new_tokens=3), states[0], None,
               attend_limit=16)
        assert recorder.records == 2 and len(graphs._graphs) == 2
        # the recorded frame's launch, per replay, and the second capture's warm-up passes
        assert ops.LAUNCHES["fast_loop"] - before == 3 + WARMUP
        graphs(params, cfg, tok, GREEDY, states[1], None, attend_limit=32)
        assert recorder.records == 3 and len(graphs._graphs) == 2  # the oldest dropped


def test_static_seeds_draw_what_the_eager_calls_draw():
    seeds = StaticSeeds()
    with seeds.hold():
        a, b = philox_seed(None, "cpu"), philox_seed(None, "cpu")
    assert len(seeds.buffers) == 2 and a is seeds.buffers[0] and b is seeds.buffers[1]
    with seeds.hold():  # a second pass takes the same buffers
        assert philox_seed(None, "cpu") is a and philox_seed(None, "cpu") is b
    seeds.draw(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    want = [philox_seed(gen, "cpu"), philox_seed(gen, "cpu")]
    assert torch.equal(a, want[0]) and torch.equal(b, want[1])
    assert not torch.equal(a, b)


# ---- the lm_graph_share reader ------------------------------------------------

QUIET = [(10.0, 20.0), (30.0, 40.0)]
TID = 7


class Ring:
    def __init__(self, spans):
        self.spans, self.dropped = sorted(spans, key=lambda s: s[1]), 0

    def snapshot(self):
        return list(self.spans)


def served_spans(replays_every: int, frames_per_step: int):
    """Frame steps across both quiet stretches, each LM frame replaying a
    graph when its index is a multiple of `replays_every` (0: never), with
    a prefill (its LM frame replaying too, which is not counted) before
    every third. Returns (ctx, spans, the share the construction gives)."""
    spans, t, n, held = [], 10.5, 0, 0
    while t < 39.0:
        if QUIET[0][1] - 1.0 < t < QUIET[1][0] + 0.5:
            t = QUIET[1][0] + 0.5
        if n % 3 == 0:
            spans += [("step.prefill", t, t + 0.05, TID), ("lm.frame", t + 0.01, t + 0.03, TID),
                      ("lm.replay", t + 0.012, t + 0.02, TID)]
            t += 0.06
        name = "step.chunk" if frames_per_step > 1 else "step.stream"
        spans.append((name, t, t + 0.03 * frames_per_step, TID))
        for f in range(frames_per_step):
            f0 = t + 0.03 * f
            spans.append(("lm.frame", f0 + 0.001, f0 + 0.012, TID))
            if replays_every and n % replays_every == 0:
                spans.append(("lm.replay", f0 + 0.002, f0 + 0.01, TID))
                held += 1
            n += 1
        t += 0.03 * frames_per_step + 0.01
    ctx = {"quiet": QUIET, "t_open": QUIET[0][0], "t_close": QUIET[1][1]}
    return ctx, spans, 100.0 * held / n


@pytest.mark.parametrize("frames_per_step", [1, 4], ids=["stream", "chunk"])
@pytest.mark.parametrize("every, want", [(1, 100.0), (3, 33.3), (0, 0.0)])
def test_lm_graph_share_reads_the_served_frames_that_replay(monkeypatch, frames_per_step,
                                                            every, want):
    ctx, spans, exact = served_spans(every, frames_per_step)
    monkeypatch.setattr(program_spans, "recorder", lambda: Ring(spans))
    assert registry.reader("lm_graph_share")(ctx) == pytest.approx(exact)
    assert abs(exact - want) < 0.5


def test_lm_graph_share_reads_none_without_frames_or_graphs(monkeypatch):
    read = registry.reader("lm_graph_share")
    ctx, spans, _ = served_spans(1, 4)
    monkeypatch.setattr(program_spans, "recorder",
                        lambda: Ring([s for s in spans if s[0] != "lm.frame"]))
    assert read(ctx) is None
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert read(ctx) is None
    monkeypatch.setattr(program_spans, "recorder", lambda: Ring(spans))
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "smoltts_torch.lm.graph" else real(name, *a)))
    assert read(ctx) is None
