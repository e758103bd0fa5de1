"""PyTorch port, LM decode: prefill + decode_frame greedy frames equal the JAX
package's, frame for frame, across ring flushes and a change of
attend_limit, with f32 caches and with kv8 (int8 history; both sides round
half-to-even, so the codes are exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.config import ModelType as JaxModelType
from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.lm import decode as jd
from smoltts_tpu.lm.samplers import GenerationSettings as JaxSettings
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.ops.quant import fuse_decode_params, quantize_decode_params
from smoltts_tpu.tokenizer import ByteTokenizer as JaxTok
from smoltts_tpu.tokenizer import TokenConfig as JaxTokenConfig
from smoltts_torch.config import ModelType, tiny_debug_config
from smoltts_torch.interop import params_from_jax_numpy
from smoltts_torch.lm import decode as td
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig

CB = 32


def audio_prompt(cfg, token_cfg, T, seed):
    rng = np.random.default_rng(seed)
    p = np.zeros((cfg.num_rows, T), np.int32)
    c0 = rng.integers(0, cfg.codebook_size, T)
    p[0] = token_cfg.semantic_start_id + c0
    p[1] = c0
    p[2:] = rng.integers(0, cfg.codebook_size, (cfg.num_rows - 2, T))
    return p


def setup(quantized: bool):
    kw = dict(codebook_size=CB, vocab_size=256 + 64 + CB)
    jcfg, cfg = jax_tiny(**kw), tiny_debug_config(**kw)
    jtok = JaxTokenConfig.from_tokenizer(JaxModelType.smoltts_v0(), JaxTok(CB), jcfg)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    assert tok == TokenConfig(**jtok.model_dump())
    jparams = jax_init(jcfg, jax.random.PRNGKey(9), dtype=jnp.float32)
    if quantized:
        jparams = quantize_decode_params(fuse_decode_params(jparams))
    return jcfg, cfg, jtok, tok, jparams, params_from_jax_numpy(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "kv8"])
def test_greedy_frames_match_jax(kv8):
    jcfg, cfg, jtok, tok, jparams, params = setup(quantized=kv8)
    B, T, S, W, N = 2, 6, 64, 4, 9
    prompts = np.stack([audio_prompt(cfg, tok, T, s) for s in (1, 2)])
    plen = np.full((B,), T, np.int32)
    limits = [16] * 4 + [None] * 5  # attend_limit switches mid-run

    jstate = jd.init_decode_state(jcfg, B, S, dtype=jnp.int8 if kv8 else jnp.float32, tail_len=W)
    jstate, jout = jd.prefill(jparams, jcfg, jtok, JaxSettings(0.0, 0.0), jstate,
                              jnp.asarray(prompts), jnp.asarray(plen), jax.random.PRNGKey(3))
    ref = [np.asarray(jout.tokens)]
    since = 0
    for i in range(N):
        if since >= W - 1:
            jstate, since = jd.flush_kv(jstate), 0
        jstate, jout = jd.decode_frame(jparams, jcfg, jtok, JaxSettings(0.0, 0.0), jstate,
                                       jax.random.PRNGKey(10 + i), attend_limit=limits[i])
        since += 1
        ref.append(np.asarray(jout.tokens))

    settings = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
    state = td.init_decode_state(cfg, B, S, dtype=torch.int8 if kv8 else torch.float32,
                                 tail_len=W, device="cpu")
    state, out = td.prefill(params, cfg, tok, settings, state, torch.from_numpy(prompts),
                            torch.from_numpy(plen), None)
    got = [out.tokens.numpy()]
    since = 0
    for i in range(N):
        if since >= W - 1:
            state, since = td.flush_kv(state), 0
        state, out = td.decode_frame(params, cfg, tok, settings, state, None,
                                     attend_limit=limits[i])
        since += 1
        got.append(out.tokens.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(state.flushed.numpy(), np.asarray(jstate.flushed))
    if kv8:
        # The quantized history written at prefill and flush agrees: the
        # scales are amax/127 of k/v vectors whose sums were taken in another
        # order, so they agree to an f32 ulp or two.
        assert (state.k.numpy() == np.asarray(jstate.k)).mean() > 0.999
        np.testing.assert_allclose(state.v_scale.numpy(), np.asarray(jstate.v_scale), rtol=1e-6)


def test_entry_points_take_an_explicit_device():
    cfg = tiny_debug_config()
    state = td.init_decode_state(cfg, 1, 16, device="cpu")
    assert state.k.device.type == "cpu" and state.k.dtype == torch.bfloat16
    assert state.tail_pos.dtype == torch.int32 and int(state.tail_pos.min()) == -1


def test_config_tokenizer_and_prompt_match_jax():
    """The port's dataclass configs, byte tokenizer and ChatML encoder equal
    the JAX package's pydantic / Python ones."""
    from smoltts_tpu.config import smoltts_byte_150m as jax_150m
    from smoltts_tpu.config import smoltts_byte_70m as jax_70m
    from smoltts_tpu.lm.prompt import PromptEncoder as JaxPromptEncoder
    from smoltts_torch.config import smoltts_byte_150m, smoltts_byte_70m
    from smoltts_torch.lm.prompt import PromptEncoder

    for jc, tc in ((jax_150m(), smoltts_byte_150m()), (jax_70m(), smoltts_byte_70m()),
                   (jax_tiny(codebook_size=CB), tiny_debug_config(codebook_size=CB))):
        jd_ = jc.model_dump()
        for key, value in jd_.items():
            assert getattr(tc, key) == value, key
        for prop in ("num_rows", "max_fast_seqlen", "fast_embedding_rows"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
    text = "<|im_start|>user\nHéllo, wörld → ok<|speaker:3|><|semantic:7|><|im_end|>"
    assert ByteTokenizer().encode(text) == JaxTok().encode(text)
    assert ByteTokenizer().decode(ByteTokenizer().encode(text)) == JaxTok().decode(JaxTok().encode(text))
    assert TokenConfig.smoltts_v0() == TokenConfig(**JaxTokenConfig.smoltts_v0().model_dump())
    jcfg, cfg = jax_tiny(codebook_size=CB), tiny_debug_config(codebook_size=CB)
    jpe = JaxPromptEncoder.from_config(JaxTok(CB), jcfg, JaxTokenConfig.from_tokenizer(
        JaxModelType.smoltts_v0(), JaxTok(CB), jcfg))
    pe = PromptEncoder.from_config(ByteTokenizer(CB), cfg, TokenConfig.from_tokenizer(
        ModelType.smoltts_v0(), ByteTokenizer(CB), cfg))
    codes = np.random.default_rng(0).integers(0, CB, (cfg.num_codebooks, 5))
    for jturn, tturn in ((jpe.encode_text_turn("system", "<|speaker:1|>"),
                          pe.encode_text_turn("system", "<|speaker:1|>")),
                         (jpe.encode_text_turn("assistant"), pe.encode_text_turn("assistant")),
                         (jpe.encode_vq(codes), pe.encode_vq(codes))):
        np.testing.assert_array_equal(tturn, jturn)
