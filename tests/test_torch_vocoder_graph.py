"""PyTorch port, the vocoder step over a streaming state that stays in place
(codec/graph.py) on the CPU: the ring flush keeps every leaf's storage and
gives the values of an out-of-place flush; the in-place step, over steps
and flushes, leaves the given state holding what the chain of
`mimi_decode_step` gives, and returns PCM that later steps do not change;
`VocoderGraphs` with the stand-in recorder (tests/torch_graph_stand_in.py)
holds one graph per state and codes shape; and the callers
that keep their states in place: interleaved `SmolTTS.stream` generators on
one instance (the LM's B=1 state kept too), and the engine's admissions on
its reused sub-states."""

import numpy as np
import pytest
import torch

from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.graph import VocoderGraphs, step_in_place
from smoltts_torch.codec.transformer import TransformerRingState, flush_transformer_ring
from smoltts_torch.config import ModelType, tiny_debug_config
from smoltts_torch.lm.engine import DecodeEngine
from smoltts_torch.lm.generate import pad_prompts
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.ops.quant import quantize_kv
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_graph_stand_in import stand_in_graphs

CB = 32
MIMI = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)
GREEDY = dict(default_temp=0.0, default_fast_temp=0.0)
KV8 = pytest.mark.parametrize("kv8", [False, True], ids=["f32", "kv8"])


def random_codes(rng, batch, steps=1):
    return torch.from_numpy(rng.integers(0, CB, (batch, 8, steps)).astype(np.int32))


def stepped_state(mcfg, params, batch, kv8, steps, seed, tail_len=8):
    rng = np.random.default_rng(seed)
    state = tm.decode_stream_init(mcfg, batch, tail_len=tail_len,
                                  kv_dtype=torch.int8 if kv8 else None, device="cpu")
    for _ in range(steps):
        state, _ = tm.mimi_decode_step(params, mcfg, state, random_codes(rng, batch))
    return state


def clone_state(state):
    return tm.map_stream_state(torch.clone, state)


def assert_states_equal(a, b):
    la, lb = tm.stream_state_leaves(a), tm.stream_state_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def flush_out_of_place(state: TransformerRingState) -> TransformerRingState:
    """The ring flush as it was before it wrote every leaf in place: new
    slot_pos, tail_abs and t_phase tensors."""
    W = state.k.shape[2]
    b_idx, w_idx = (state.tail_abs >= 0).nonzero(as_tuple=True)
    absp = state.tail_abs[b_idx, w_idx]
    slots = (absp % W).long()
    k, v = state.k.clone(), state.v.clone()
    ks = None if state.k_scale is None else state.k_scale.clone()
    vs = None if state.v_scale is None else state.v_scale.clone()
    if ks is not None:
        kq, kscale = quantize_kv(state.k_tail)
        vq, vscale = quantize_kv(state.v_tail)
        k[:, b_idx, slots] = kq[:, b_idx, w_idx]
        v[:, b_idx, slots] = vq[:, b_idx, w_idx]
        ks[:, b_idx, slots] = kscale[:, b_idx, w_idx]
        vs[:, b_idx, slots] = vscale[:, b_idx, w_idx]
    else:
        k[:, b_idx, slots] = state.k_tail[:, b_idx, w_idx].to(k.dtype)
        v[:, b_idx, slots] = state.v_tail[:, b_idx, w_idx].to(v.dtype)
    slot_pos = state.slot_pos.clone()
    slot_pos[b_idx, slots] = absp
    return state._replace(k=k, v=v, k_scale=ks, v_scale=vs, slot_pos=slot_pos,
                          tail_abs=torch.full_like(state.tail_abs, -1),
                          t_phase=torch.zeros_like(state.t_phase))


@KV8
def test_flush_keeps_every_leafs_storage_and_the_out_of_place_values(kv8):
    mcfg = MimiConfig(**MIMI)
    params = tm.init_mimi_params(mcfg, seed=1, device="cpu")
    state = stepped_state(mcfg, params, 3, kv8, steps=3, seed=0)
    want = flush_out_of_place(clone_state(state).transformer)
    ptrs = [None if a is None else a.data_ptr() for a in state.transformer]
    got = flush_transformer_ring(state.transformer)
    assert got is state.transformer
    assert [None if a is None else a.data_ptr() for a in got] == ptrs
    for f in TransformerRingState._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    flushed = tm.flush_mimi_state(state)
    assert all(x is y for x, y in zip(tm.stream_state_leaves(flushed),
                                      tm.stream_state_leaves(state)))


@KV8
@pytest.mark.parametrize("entry", ["step_in_place", "VocoderGraphs"])
def test_the_in_place_step_gives_the_chain_of_decode_steps(kv8, entry):
    mcfg = MimiConfig(**MIMI)
    params = tm.init_mimi_params(mcfg, seed=1, device="cpu")
    step = step_in_place if entry == "step_in_place" else VocoderGraphs()
    B, rng = 2, np.random.default_rng(4)
    kv = torch.int8 if kv8 else None
    ref = tm.decode_stream_init(mcfg, B, tail_len=8, kv_dtype=kv, device="cpu")
    state = tm.decode_stream_init(mcfg, B, tail_len=8, kv_dtype=kv, device="cpu")
    ptrs = [t.data_ptr() for t in tm.stream_state_leaves(state)]
    held = []
    for t in range(9):
        if t and t % 3 == 0:  # 2 tokens per step, tail 8: flush before it wraps
            ref, state = tm.flush_mimi_state(ref), tm.flush_mimi_state(state)
        codes = random_codes(rng, B)
        ref, want = tm.mimi_decode_step(params, mcfg, ref, codes)
        out, pcm = step(params, mcfg, state, codes)
        assert out is state
        assert [t.data_ptr() for t in tm.stream_state_leaves(state)] == ptrs
        assert_states_equal(state, ref)
        assert torch.equal(pcm, want)
        held.append((pcm, want.clone()))
    for pcm, want in held:  # no later step wrote a PCM returned before
        assert torch.equal(pcm, want)


def test_graphs_are_held_per_state_and_codes_shape_and_give_fresh_pcm():
    with stand_in_graphs() as recorder:
        check_graphs_are_held(recorder)


def check_graphs_are_held(recorder):
    mcfg = MimiConfig(**MIMI)
    params = tm.init_mimi_params(mcfg, seed=1, device="cpu")
    graphs, rng = VocoderGraphs(max_graphs=2), np.random.default_rng(5)
    states = [tm.decode_stream_init(mcfg, n, tail_len=8, device="cpu") for n in (2, 1)]
    refs = [clone_state(s) for s in states]
    graphs.capture(params, mcfg, states[0], random_codes(rng, 2))
    assert_states_equal(states[0], refs[0])  # a capture does not advance the state
    outs = []
    for t in range(3):
        for i, n in enumerate((2, 1)):
            if t == 2:  # a flush in place keeps the state's graph
                states[i], refs[i] = tm.flush_mimi_state(states[i]), tm.flush_mimi_state(refs[i])
            codes = random_codes(rng, n)
            refs[i], want = tm.mimi_decode_step(params, mcfg, refs[i], codes)
            _, pcm = graphs(params, mcfg, states[i], codes)
            outs.append((pcm, want))
            assert_states_equal(states[i], refs[i])
    assert recorder.records == 2 and len(graphs._graphs) == 2
    for pcm, want in outs:  # each call's PCM is its own
        assert torch.equal(pcm, want)
    graphs(params, mcfg, tm.decode_stream_init(mcfg, 3, tail_len=8, device="cpu"),
           random_codes(rng, 3))
    assert recorder.records == 3 and len(graphs._graphs) == 2  # the oldest dropped


# ---- the callers ---------------------------------------------------------------


def tiny_tts(tmp_path, max_new_tokens=40):
    from smoltts_torch import SmolTTS
    from smoltts_torch.io.checkpoint import save_params
    from smoltts_torch.tokenizer import save_byte_level_tokenizer

    cfg = tiny_debug_config(codebook_size=CB, vocab_size=256 + 64 + CB)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    save_params(params, cfg, tmp_path)
    save_byte_level_tokenizer(tmp_path, CB)
    tts = SmolTTS(tmp_path, device="cpu", generation_settings=GenerationSettings(
        **GREEDY, max_new_tokens=max_new_tokens, audio_only_constraint=True))
    mcfg = MimiConfig(**MIMI)
    tts.codec_config, tts.codec_params = mcfg, tm.init_mimi_params(mcfg, seed=1, device="cpu")
    return tts


def test_interleaved_library_streams_each_give_what_they_give_alone(tmp_path):
    tts = tiny_tts(tmp_path)  # 40 frames: the codec ring flushes on the way
    texts = ["Hi.", "Hello there, friend."]
    alone = [list(tts.stream(t)) for t in texts]
    assert len(alone[0]) > 32 and all(len(c) > 0 for c in alone)
    owned = [t.data_ptr() for t in tm.stream_state_leaves(tts._stream_mimi)]
    owned_lm = [t.data_ptr() for t in tts._stream_lm if t is not None]
    for first in (0, 1):
        gens = {i: tts.stream(texts[i]) for i in (first, 1 - first)}
        got = {i: [] for i in gens}
        while gens:
            for i in list(gens):
                chunk = next(gens[i], None)
                if chunk is None:
                    del gens[i]
                else:
                    got[i].append(chunk)
        for i in (0, 1):
            assert len(got[i]) == len(alone[i])
            for a, b in zip(got[i], alone[i]):
                np.testing.assert_array_equal(a, b)
    assert not tts._stream_states_taken
    assert [t.data_ptr() for t in tm.stream_state_leaves(tts._stream_mimi)] == owned
    assert [t.data_ptr() for t in tts._stream_lm if t is not None] == owned_lm
    gen = tts.stream(texts[0])  # closed early: the state is given back
    next(gen)
    assert tts._stream_states_taken
    gen.close()
    assert not tts._stream_states_taken


def audio_prompt(cfg, tok, T, seed):
    rng = np.random.default_rng(seed)
    p = np.zeros((cfg.num_rows, T), np.int32)
    c0 = rng.integers(0, cfg.codebook_size, T)
    p[0] = tok.semantic_start_id + c0
    p[1] = c0
    p[2:] = rng.integers(0, cfg.codebook_size, (cfg.num_rows - 2, T))
    return p


@KV8
def test_admissions_on_the_reused_sub_state_match_a_fresh_one(kv8):
    cfg = tiny_debug_config(codebook_size=CB, vocab_size=256 + 64 + CB)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mcfg = MimiConfig(**MIMI)
    eng = DecodeEngine(params, cfg, tok, GenerationSettings(**GREEDY), num_slots=4,
                       max_seq_len=64, kv_dtype=torch.int8 if kv8 else torch.float32,
                       prompt_bucket=8, mimi_params=tm.init_mimi_params(mcfg, seed=1, device="cpu"),
                       mimi_cfg=mcfg, admit_sizes=[1, 2], device="cpu")
    ref = clone_state(eng.mimi_state)
    ms = eng.mimi_state
    gen, ptrs = torch.Generator().manual_seed(0), None
    for k, slots in enumerate(([0, 1], [3, 2])):
        prompt, lens = pad_prompts([audio_prompt(cfg, tok, 5 + k + i, 10 * k + i)
                                    for i in range(2)], pad_to_multiple=8)
        eng.state, out, pcm = eng._admit(eng.state, ms, slots, prompt, lens, gen)
        sub = eng._admit_mimi[2]
        if ptrs is None:
            ptrs = [t.data_ptr() for t in tm.stream_state_leaves(sub)]
        assert [t.data_ptr() for t in tm.stream_state_leaves(sub)] == ptrs
        fresh = tm.decode_stream_init(mcfg, 2, dtype=ms.upsample_tail.dtype,
                                      kv_dtype=torch.int8 if kv8 else None, device="cpu")
        fresh, want = tm.mimi_decode_step(eng.mimi_params, mcfg, fresh,
                                          out.audio_codes[:, :, None])
        idx = torch.tensor(slots)
        tm.reset_stream_slots(ref, idx)
        tm.scatter_stream_state(ref, fresh, idx)
        assert torch.equal(pcm, eng._emit_pcm(want))
        assert_states_equal(sub, fresh)  # both flushed by the scatter
        assert_states_equal(ms, ref)
