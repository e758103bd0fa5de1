"""PyTorch port, the engine against the JAX package: the port's DecodeEngine
and the JAX DecodeEngine run one staggered schedule on the same bridged
weights with the vocoder attached (greedy: equal codes, PCM within the
continuous-batching tolerance of PARITY.md), and the Mimi streaming-state
slot operations the admission uses (`reset_stream_slots`,
`scatter_stream_state`) equal the JAX package's bit for bit, in f32 and
kv8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.codec import mimi as jm
from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
from smoltts_tpu.config import ModelType as JaxModelType
from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.lm.engine import DecodeEngine as JaxDecodeEngine
from smoltts_tpu.lm.samplers import GenerationSettings as JaxSettings
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.tokenizer import ByteTokenizer as JaxTok
from smoltts_tpu.tokenizer import TokenConfig as JaxTokenConfig
from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.transformer import TransformerRingState
from smoltts_torch.config import ModelType, tiny_debug_config
from smoltts_torch.interop import params_from_jax_numpy
from smoltts_torch.lm.engine import DecodeEngine
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig
from tests import torch_threads  # noqa: F401  (one intra-op thread)

CB = 32
MIMI = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)
PCM_TOL = dict(rtol=2e-4, atol=1e-5)  # PARITY.md, continuous batching


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def audio_prompt(num_rows, semantic_start_id, T, seed):
    rng = np.random.default_rng(seed)
    p = np.zeros((num_rows, T), np.int32)
    c0 = rng.integers(0, CB, T)
    p[0] = semantic_start_id + c0
    p[1] = c0
    p[2:] = rng.integers(0, CB, (num_rows - 2, T))
    return p


def test_engine_matches_jax_decode_engine():
    kw = dict(codebook_size=CB, vocab_size=256 + 64 + CB)
    jcfg, cfg = jax_tiny(**kw), tiny_debug_config(**kw)
    jtok = JaxTokenConfig.from_tokenizer(JaxModelType.smoltts_v0(), JaxTok(CB), jcfg)
    tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    jparams = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jmcfg, mcfg = JaxMimiConfig(**MIMI), MimiConfig(**MIMI)
    jmimi = jm.init_mimi_params(jmcfg, seed=1)
    params = params_from_jax_numpy(jax.tree.map(np.asarray, jparams))
    mimi = params_from_jax_numpy(jax.tree.map(np.asarray, jmimi))
    prompts = [audio_prompt(cfg.num_rows, tok.semantic_start_id, 6, s) for s in range(3)]
    common = dict(num_slots=2, max_seq_len=64, prompt_bucket=8, attend_buckets=[64],
                  admit_sizes=[1])

    def run(eng):
        sids = [eng.submit(prompts[0]), eng.submit(prompts[1])]
        got = {sid: [] for sid in sids}
        for step in range(30):
            if step == 2:  # the third stream waits for a slot
                sids.append(eng.submit(prompts[2]))
                got[sids[-1]] = []
            for sid, frame in eng.step():
                got[sid].append(frame)
            if step >= 2 and not eng.has_work():
                break
        assert not eng.has_work()
        return [got[s] for s in sids]

    ref = run(JaxDecodeEngine(
        jparams, jcfg, jtok, JaxSettings(default_temp=0.0, default_fast_temp=0.0, max_new_tokens=5),
        kv_dtype=jnp.float32, mimi_params=jmimi, mimi_cfg=jmcfg, **common))
    got = run(DecodeEngine(
        params, cfg, tok, GenerationSettings(default_temp=0.0, default_fast_temp=0.0,
                                             max_new_tokens=5),
        kv_dtype=torch.float32, mimi_params=mimi, mimi_cfg=mcfg, device="cpu", **common))
    for rs, gs in zip(ref, got):
        assert len(gs) == len(rs) == 5
        for r, g in zip(rs, gs):
            np.testing.assert_array_equal(g["audio_codes"], np.asarray(r["audio_codes"]))
            assert (g["is_audio"], g["finished"], g["slow_token"]) == (
                r["is_audio"], r["finished"], r["slow_token"])
            np.testing.assert_allclose(g["pcm"], np.asarray(r["pcm"], np.float32), **PCM_TOL)


def _stream_state(mcfg, batch, kv8, steps, seed):
    """A streaming state after `steps` vocoder steps of the port on random
    codes (its ring, tail and conv buffers all hold data)."""
    rng = np.random.default_rng(seed)
    params = tm.init_mimi_params(mcfg, seed=2, device="cpu")
    state = tm.decode_stream_init(mcfg, batch, tail_len=8, kv_dtype=torch.int8 if kv8 else None,
                                  device="cpu")
    for _ in range(steps):
        codes = torch.from_numpy(rng.integers(0, CB, (batch, mcfg.num_quantizers, 1)))
        state, _ = tm.mimi_decode_step(params, mcfg, state, codes)
    return state


def _j(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _to_jax(ts):
    tt = ts.transformer
    fields = {f: (None if getattr(tt, f) is None else _j(getattr(tt, f).clone()))
              for f in TransformerRingState._fields}
    fields["t_phase"] = fields["t_phase"].astype(jnp.int32)
    dec = [None if d is None else ({k: _j(v.clone()) for k, v in d.items()} if isinstance(d, dict)
                                   else _j(d.clone()))
           for d in ts.decoder]
    return jm.MimiStreamState(_j(ts.upsample_tail.clone()),
                              jm.TransformerRingState(**fields), dec)


def _assert_states_equal(ts, js):
    np.testing.assert_array_equal(_np(ts.upsample_tail), np.asarray(js.upsample_tail, np.float32))
    for f in TransformerRingState._fields:
        a, b = getattr(ts.transformer, f), getattr(js.transformer, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_np(a), np.asarray(b).astype(_np(a).dtype), err_msg=f)
    tl = jax.tree.leaves(js.decoder)
    pl = [t for d in ts.decoder if d is not None for t in (d.values() if isinstance(d, dict) else [d])]
    assert len(tl) == len(pl)
    for a, b in zip(pl, tl):
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "kv8"])
def test_reset_stream_slots_matches_jax(kv8):
    ts = _stream_state(MimiConfig(**MIMI), 4, kv8, steps=3, seed=0)
    slots = np.asarray([2, 0], np.int64)
    want = jm.reset_stream_slots(_to_jax(ts), jnp.asarray(slots, jnp.int32))
    got = tm.reset_stream_slots(ts, torch.from_numpy(slots))
    _assert_states_equal(got, want)


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "kv8"])
def test_scatter_stream_state_matches_jax(kv8):
    mcfg = MimiConfig(**MIMI)
    big = _stream_state(mcfg, 4, kv8, steps=3, seed=1)
    small = _stream_state(mcfg, 2, kv8, steps=1, seed=2)
    slots = np.asarray([3, 1], np.int64)
    want = jm.scatter_stream_state(_to_jax(big), _to_jax(small), jnp.asarray(slots, jnp.int32))
    got = tm.scatter_stream_state(big, small, torch.from_numpy(slots))
    _assert_states_equal(got, want)
