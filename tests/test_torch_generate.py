"""PyTorch port, the generation loops against the JAX package on a tiny
config, greedy: `generate_blocking` (codes, n_frames, the stop on
finished), `make_device_generator`, and `make_chunk_step` with flushes
between chunks, kv8 and the small Mimi (codes equal, PCM allclose)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.codec import mimi as jm
from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
from smoltts_tpu.config import ModelType as JaxModelType
from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.lm import generate as jgen
from smoltts_tpu.lm import pipeline as jpipe
from smoltts_tpu.lm.decode import init_decode_state as jax_init_state
from smoltts_tpu.lm.samplers import GenerationSettings as JaxSettings
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.ops import quant as jq
from smoltts_tpu.tokenizer import ByteTokenizer as JaxTok
from smoltts_tpu.tokenizer import TokenConfig as JaxTokenConfig
from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.config import ModelType, tiny_debug_config
from smoltts_torch.interop import params_from_jax_numpy
from smoltts_torch.lm import generate as tgen
from smoltts_torch.lm import pipeline as tpipe
from smoltts_torch.lm.decode import init_decode_state
from smoltts_torch.lm.prompt import PromptEncoder
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig
from tests import torch_threads  # noqa: F401  (one intra-op thread)

CB = 32
MIMI = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)
GREEDY = dict(default_temp=0.0, default_fast_temp=0.0)


def _setup(quantized=False, seed=0):
    kw = dict(codebook_size=CB, vocab_size=256 + 64 + CB)
    jcfg, cfg = jax_tiny(**kw), tiny_debug_config(**kw)
    jtok = JaxTokenConfig.from_tokenizer(JaxModelType.smoltts_v0(), JaxTok(CB), jcfg)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    jparams = jq.fuse_decode_params(jax_init(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    if quantized:
        jparams = jq.quantize_decode_params(jparams)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    pe = PromptEncoder.from_config(ByteTokenizer(CB), cfg, tok)
    prompts = [np.concatenate([pe.encode_text_turn("system", f"<|speaker:{i}|>"),
                               pe.encode_text_turn("user", text),
                               pe.encode_text_turn("assistant")], axis=1)
               for i, text in enumerate(("Hi.", "Hello there, friend."))]
    return jcfg, cfg, jtok, tok, jparams, params, prompts


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_generate_blocking_matches_jax(quantized):
    jcfg, cfg, jtok, tok, jparams, params, prompts = _setup(quantized)
    js, settings = JaxSettings(max_new_tokens=9, **GREEDY), GenerationSettings(max_new_tokens=9, **GREEDY)
    jcodes, jn, _ = jgen.generate_blocking(jparams, jcfg, jtok, js, prompts, rng=jax.random.PRNGKey(1))
    codes, n, metrics = tgen.generate_blocking(params, cfg, tok, settings, prompts,
                                               generator=torch.Generator().manual_seed(1),
                                               device="cpu")
    assert codes.shape == jcodes.shape == (2, cfg.num_codebooks, 9) and metrics.frames == 9
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(n, jn)
    assert metrics.prefill_ms > 0 and metrics.frames_per_s > 0


def test_generate_blocking_stops_when_all_finished():
    """A zero final norm gives all-zero logits; under the audio window the
    lowest id in it, <|im_end|>, wins, so every row finishes at the first
    frame and both packages stop there."""
    jcfg, cfg, jtok, tok, jparams, params, prompts = _setup()
    jparams = dict(jparams, norm=jnp.zeros_like(jparams["norm"]))
    params = dict(params, norm=torch.zeros_like(params["norm"]))
    kw = dict(max_new_tokens=9, audio_only_constraint=True, **GREEDY)
    jcodes, jn, _ = jgen.generate_blocking(jparams, jcfg, jtok, JaxSettings(**kw), prompts)
    codes, n, metrics = tgen.generate_blocking(params, cfg, tok, GenerationSettings(**kw), prompts,
                                               device="cpu")
    assert metrics.frames == 1 and codes.shape == jcodes.shape == (2, cfg.num_codebooks, 1)
    np.testing.assert_array_equal(codes, jcodes)
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(n, [0, 0])


def test_device_generator_matches_generate_blocking_and_jax():
    jcfg, cfg, jtok, tok, jparams, params, prompts = _setup(quantized=True)
    F = 7
    settings = GenerationSettings(max_new_tokens=F, **GREEDY)
    codes, n, _ = tgen.generate_blocking(params, cfg, tok, settings, prompts, device="cpu")
    padded, lens = tgen.pad_prompts(prompts)
    run = tgen.make_device_generator(cfg, tok, settings, F, device="cpu")
    state = init_decode_state(cfg, 2, dtype=torch.bfloat16, tail_len=8, device="cpu")
    dcodes, valid, finished = run(params, state, torch.from_numpy(padded), torch.from_numpy(lens),
                                  torch.Generator().manual_seed(0))
    assert dcodes.shape == (2, cfg.num_codebooks, F) and valid.shape == (2, F)
    np.testing.assert_array_equal((dcodes * valid[:, None]).numpy(), codes)
    np.testing.assert_array_equal(valid.sum(-1).numpy(), n)

    jrun = jgen.make_device_generator(jcfg, jtok, JaxSettings(max_new_tokens=F, **GREEDY), F)
    jstate = jax_init_state(jcfg, 2, jcfg.max_seq_len, dtype=jnp.bfloat16, tail_len=8)
    jcodes, jvalid, jfin = jrun(jparams, jstate, jnp.asarray(padded), jnp.asarray(lens),
                                jax.random.PRNGKey(0))
    np.testing.assert_array_equal(dcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(finished.numpy(), np.asarray(jfin))
    with pytest.raises(ValueError, match="tail_len"):
        run(params, init_decode_state(cfg, 2, tail_len=4, device="cpu"), torch.from_numpy(padded),
            torch.from_numpy(lens), torch.Generator())


def test_chunk_step_matches_jax():
    """Three chunks of K = 3 frames after the prefill step, a flush between
    chunks, kv8 for the LM history and the codec ring, fused int8 trees."""
    jcfg, cfg, jtok, tok, jparams, params, prompts = _setup(quantized=True)
    jmcfg, mcfg = JaxMimiConfig(**MIMI), MimiConfig(**MIMI)
    jmimi = jq.quantize_mimi_params(jq.fuse_mimi_decode_params(jm.init_mimi_params(jmcfg, seed=2)))
    mimi = params_from_jax_numpy(jax.tree.map(np.asarray, jmimi))
    padded, lens = tgen.pad_prompts(prompts)
    B, S, W, MW, K, chunks = 2, 64, 8, 8, 3, 3

    js = JaxSettings(**GREEDY)
    jstate = jax_init_state(jcfg, B, S, dtype=jnp.int8, tail_len=W)
    jms = jm.decode_stream_init(jmcfg, B, tail_len=MW, kv_dtype=jnp.int8)
    assert jpipe.flush_cadence(jstate, jms) == K
    jprefill = jpipe.make_prefill_step(jcfg, jtok, js, jmcfg)
    jchunk = jpipe.make_chunk_step(jcfg, jtok, js, jmcfg, K, attend_limit=48)
    jflush = jpipe.make_flush_step()
    key = jax.random.PRNGKey(1)
    jstate, jms, key, _ = jprefill(jparams, jmimi, jstate, jms, jnp.asarray(padded),
                                   jnp.asarray(lens), key)
    ref = []
    for _ in range(chunks):
        jstate, jms = jflush(jstate, jms)
        jstate, jms, key, o = jchunk(jparams, jmimi, jstate, jms, key)
        ref.append(jax.tree.map(np.asarray, o))

    settings = GenerationSettings(**GREEDY)
    state = init_decode_state(cfg, B, S, dtype=torch.int8, tail_len=W, device="cpu")
    ms = tm.decode_stream_init(mcfg, B, tail_len=MW, kv_dtype=torch.int8, device="cpu")
    prefill_step = tpipe.make_prefill_step(cfg, tok, settings, mcfg, device="cpu")
    chunk_step = tpipe.make_chunk_step(cfg, tok, settings, mcfg, K, attend_limit=48, device="cpu")
    flush_step = tpipe.make_flush_step(device="cpu")
    gen = torch.Generator().manual_seed(1)
    state, ms, gen, _ = prefill_step(params, mimi, state, ms, torch.from_numpy(padded),
                                     torch.from_numpy(lens), gen)
    for r in ref:
        state, ms = flush_step(state, ms)
        state, ms, gen, o = chunk_step(params, mimi, state, ms, gen)
        assert o.pcm.shape == (B, K * mcfg.samples_per_frame, 1)
        assert o.audio_codes.shape == (B, cfg.num_codebooks, K) and o.is_audio.shape == (B, K)
        np.testing.assert_array_equal(o.audio_codes.numpy(), r.audio_codes)
        np.testing.assert_array_equal(o.is_audio.numpy(), r.is_audio)
        np.testing.assert_array_equal(o.finished.numpy(), r.finished)
        np.testing.assert_allclose(o.pcm.numpy(), r.pcm, rtol=1e-4, atol=1e-5)


def test_chunk_step_equals_stream_steps():
    """In the port, one chunk of K frames equals K stream steps."""
    _, cfg, _, tok, _, params, prompts = _setup(quantized=True, seed=3)
    mcfg = MimiConfig(**MIMI)
    mimi = tm.init_mimi_params(mcfg, seed=4, device="cpu")
    padded, lens = tgen.pad_prompts(prompts)
    settings = GenerationSettings(**GREEDY)
    K = 4

    def start():
        state = init_decode_state(cfg, 2, 64, dtype=torch.int8, tail_len=8, device="cpu")
        ms = tm.decode_stream_init(mcfg, 2, tail_len=16, kv_dtype=torch.int8, device="cpu")
        prefill = tpipe.make_prefill_step(cfg, tok, settings, mcfg, device="cpu")
        return prefill(params, mimi, state, ms, torch.from_numpy(padded), torch.from_numpy(lens),
                       torch.Generator())[:3]

    state, ms, gen = start()
    _, _, _, chunk = tpipe.make_chunk_step(cfg, tok, settings, mcfg, K, device="cpu")(
        params, mimi, state, ms, gen)
    state, ms, gen = start()
    step = tpipe.make_stream_step(cfg, tok, settings, mcfg, device="cpu")
    outs = []
    for _ in range(K):
        state, ms, gen, o = step(params, mimi, state, ms, gen)
        outs.append(o)
    np.testing.assert_array_equal(chunk.audio_codes.numpy(),
                                  torch.stack([o.audio_codes for o in outs], -1).numpy())
    np.testing.assert_array_equal(chunk.pcm.numpy(), torch.cat([o.pcm for o in outs], 1).numpy())
