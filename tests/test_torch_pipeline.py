"""PyTorch port, the slice as a whole: make_prefill_step + make_stream_step
with make_flush_step at flush_cadence, on a tiny config with a fused int8
tree and kv8 (LM history and codec ring), greedy. Codes equal and PCM
allclose (1e-4) to the JAX pipeline fed the same bridged weights."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from smoltts_tpu.codec import mimi as jm
from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
from smoltts_tpu.config import ModelType as JaxModelType
from smoltts_tpu.config import tiny_debug_config as jax_tiny
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
from smoltts_torch.lm import pipeline as tpipe
from smoltts_torch.lm.decode import init_decode_state
from smoltts_torch.lm.prompt import PromptEncoder
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig

CB = 32
MIMI = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)


def test_stream_pipeline_matches_jax():
    kw = dict(codebook_size=CB, vocab_size=256 + 64 + CB)
    jcfg, cfg = jax_tiny(**kw), tiny_debug_config(**kw)
    jtok = JaxTokenConfig.from_tokenizer(JaxModelType.smoltts_v0(), JaxTok(CB), jcfg)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    jmcfg, mcfg = JaxMimiConfig(**MIMI), MimiConfig(**MIMI)
    jparams = jq.quantize_decode_params(
        jq.fuse_decode_params(jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)))
    jmimi = jq.quantize_mimi_params(jq.fuse_mimi_decode_params(jm.init_mimi_params(jmcfg, seed=1)))
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    mimi = params_from_jax_numpy(jax.tree.map(np.asarray, jmimi))

    # Two ChatML prompts from the port's encoder, right-padded to a common length.
    pe = PromptEncoder.from_config(ByteTokenizer(CB), cfg, tok)
    turns = [np.concatenate([pe.encode_text_turn("system", "<|speaker:0|>"),
                             pe.encode_text_turn("user", text),
                             pe.encode_text_turn("assistant")], axis=1)
             for text in ("Hi.", "Hello there.")]
    T = max(t.shape[1] for t in turns)
    prompt = np.zeros((2, cfg.num_rows, T), np.int32)
    for b, t in enumerate(turns):
        prompt[b, :, : t.shape[1]] = t
    plen = np.asarray([t.shape[1] for t in turns], np.int32)
    B, S, W, MW, steps = 2, 64, 8, 8, 7

    js = JaxSettings(default_temp=0.0, default_fast_temp=0.0)
    jstate = jax_init_state(jcfg, B, S, dtype=jnp.int8, tail_len=W)
    jms = jm.decode_stream_init(jmcfg, B, tail_len=MW, kv_dtype=jnp.int8)
    jprefill = jpipe.make_prefill_step(jcfg, jtok, js, jmcfg)
    jstream = jpipe.make_stream_step(jcfg, jtok, js, jmcfg, attend_limit=32)
    jflush = jpipe.make_flush_step()
    cadence = jpipe.flush_cadence(jstate, jms)
    key = jax.random.PRNGKey(1)
    jstate, jms, key, o = jprefill(jparams, jmimi, jstate, jms, jnp.asarray(prompt), jnp.asarray(plen), key)
    ref = [(np.asarray(o.audio_codes), np.asarray(o.pcm))]
    since = 0
    for _ in range(steps):
        if since >= cadence:
            (jstate, jms), since = jflush(jstate, jms), 0
        jstate, jms, key, o = jstream(jparams, jmimi, jstate, jms, key)
        since += 1
        ref.append((np.asarray(o.audio_codes), np.asarray(o.pcm)))

    settings = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
    state = init_decode_state(cfg, B, S, dtype=torch.int8, tail_len=W, device="cpu")
    ms = tm.decode_stream_init(mcfg, B, tail_len=MW, kv_dtype=torch.int8, device="cpu")
    prefill_step = tpipe.make_prefill_step(cfg, tok, settings, mcfg, device="cpu")
    stream_step = tpipe.make_stream_step(cfg, tok, settings, mcfg, attend_limit=32, device="cpu")
    flush_step = tpipe.make_flush_step(device="cpu")
    assert tpipe.flush_cadence(state, ms) == cadence == 3
    gen = torch.Generator().manual_seed(1)
    state, ms, gen, o = prefill_step(params, mimi, state, ms, torch.from_numpy(prompt),
                                     torch.from_numpy(plen), gen)
    got = [(o.audio_codes.numpy(), o.pcm.numpy())]
    since = 0
    for _ in range(steps):
        if since >= cadence:
            (state, ms), since = flush_step(state, ms), 0
        state, ms, gen, o = stream_step(params, mimi, state, ms, gen)
        since += 1
        got.append((o.audio_codes.numpy(), o.pcm.numpy()))

    for (jc, jpcm), (tc, tpcm) in zip(ref, got):
        np.testing.assert_array_equal(tc, jc)
        assert tpcm.shape == (B, mcfg.samples_per_frame, 1) and np.isfinite(tpcm).all()
        np.testing.assert_allclose(tpcm, jpcm, rtol=1e-4, atol=1e-4)
