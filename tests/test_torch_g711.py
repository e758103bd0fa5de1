"""PyTorch port, G.711 mu-law: the port's host codec equals the JAX
package's on every int16 value, the cases of the JAX package's
tests/test_g711.py by name (round trip, extremes, the published wire bytes,
the device encoder bit-exact against the host, the engine's ulaw emit), and
the torch encoder bit-exact against the JAX device encoder."""

import jax.numpy as jnp
import numpy as np
import torch

from smoltts_tpu.io.g711 import ulaw_decode_np as jax_decode_np
from smoltts_tpu.io.g711 import ulaw_encode_jnp
from smoltts_tpu.io.g711 import ulaw_encode_np as jax_encode_np
from smoltts_torch.io.g711 import ulaw_decode_np, ulaw_encode, ulaw_encode_np
from tests import torch_threads  # noqa: F401  (one intra-op thread)


def _host(x: np.ndarray) -> np.ndarray:
    """The host path of float PCM: round(clip(x) * 32767) in float64."""
    return ulaw_encode_np(np.round(np.clip(x.astype(np.float64), -1, 1) * 32767).astype(np.int16))


def test_host_codec_matches_jax_on_every_int16():
    pcm = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)
    enc = ulaw_encode_np(pcm)
    np.testing.assert_array_equal(enc, jax_encode_np(pcm))
    byte = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(ulaw_decode_np(byte), jax_decode_np(byte))


def test_roundtrip_snr_speechlike():
    rng = np.random.default_rng(0)
    x = np.convolve(rng.standard_normal(24_000), np.ones(8) / 8.0, mode="same") * 0.4
    pcm16 = np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)
    y = ulaw_decode_np(ulaw_encode_np(pcm16)).astype(np.float64)
    ref = pcm16.astype(np.float64)
    assert 10 * np.log10((ref**2).mean() / ((ref - y) ** 2).mean()) > 30.0


def test_extremes_and_zero():
    pcm = np.array([0, 1, -1, 32767, -32768, 1000, -1000], np.int16)
    dec = ulaw_decode_np(ulaw_encode_np(pcm))
    assert abs(int(dec[0])) <= 8
    assert dec[3] > 31000 and dec[4] < -31000
    assert np.all(np.sign(dec[5:]) == np.sign(pcm[5:]))


def test_known_wire_vectors_g711():
    """+0 is the silence byte 0xFF, -1 the negative zero segment 0x7F (Sun
    g711.c / ffmpeg)."""
    enc = ulaw_encode_np(np.array([0, -1, 8, -8], np.int16))
    assert enc[0] == 0xFF and enc[1] == 0x7F
    assert list(ulaw_decode_np(np.array([0xFF, 0x7F, 0xFE, 0x7E], np.uint8))) == [0, 0, 8, -8]
    assert ulaw_encode_np(np.array([32767], np.int16))[0] & 0x80
    assert not (ulaw_encode_np(np.array([-32768], np.int16))[0] & 0x80)
    t = torch.tensor([0.0, -1 / 32767, 8 / 32767, -8 / 32767])
    np.testing.assert_array_equal(ulaw_encode(t).numpy(), enc)


def test_device_encoder_bit_exact_vs_host():
    rng = np.random.default_rng(1)
    x = np.clip(rng.standard_normal(4096) * 0.3, -1, 1).astype(np.float32)
    np.testing.assert_array_equal(ulaw_encode(torch.from_numpy(x)).numpy(), _host(x))
    # every segment boundary, both signs, half-way points and out-of-range input
    k = np.concatenate([np.arange(0, 32768, 7), [127.5, 255.5, 32766.5, 40000.0]])
    x = (np.concatenate([k, -k]) / 32767).astype(np.float32)
    got = ulaw_encode(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _host(x))


def test_device_encoder_matches_jax_device_encoder():
    """Equal to ulaw_encode_jnp wherever float32 gives the two paths the same
    product (the port takes it in float64 to equal the host bit for bit)."""
    x = np.clip(np.random.default_rng(2).standard_normal(8192) * 0.3, -1, 1).astype(np.float32)
    same = np.round(x * np.float32(32767)) == np.round(x.astype(np.float64) * 32767)
    got = ulaw_encode(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[same], np.asarray(ulaw_encode_jnp(jnp.asarray(x)))[same])


def test_engine_ulaw_emit():
    from smoltts_torch.codec.config import MimiConfig
    from smoltts_torch.codec.mimi import init_mimi_params
    from smoltts_torch.config import ModelType, tiny_debug_config
    from smoltts_torch.lm.engine import DecodeEngine
    from smoltts_torch.lm.samplers import GenerationSettings
    from smoltts_torch.models.dual_ar import init_params
    from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig

    CB = 32
    cfg = tiny_debug_config(codebook_size=CB, vocab_size=256 + 64 + CB)
    token_cfg = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), ByteTokenizer(CB), cfg)
    mimi_cfg = MimiConfig(num_filters=8, hidden_size=32, num_hidden_layers=1,
                          num_attention_heads=2, head_dim=16, intermediate_size=64,
                          num_quantizers=8, codebook_size=CB, codebook_dim=16,
                          sliding_window=16, upsample_groups=32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mimi_params = init_mimi_params(mimi_cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompt = np.zeros((cfg.num_rows, 6), np.int32)
    prompt[0] = token_cfg.semantic_start_id + rng.integers(0, CB, 6)
    prompt[1:] = rng.integers(0, CB, (cfg.num_rows - 1, 6))

    def frames_with(emit_format):
        eng = DecodeEngine(params, cfg, token_cfg,
                           GenerationSettings(default_temp=0.0, default_fast_temp=0.0),
                           num_slots=2, max_seq_len=64, kv_dtype=torch.float32, prompt_bucket=8,
                           mimi_params=mimi_params, mimi_cfg=mimi_cfg, emit_format=emit_format,
                           device="cpu")
        eng.submit(prompt, max_frames=3)
        out = []
        while eng.has_work():
            out.extend(eng.step())
        return [fr["pcm"] for _, fr in out if "pcm" in fr]

    f32, ul = frames_with("f32"), frames_with("ulaw")
    assert len(f32) == len(ul) == 3
    assert ul[0].dtype == np.uint8 and f32[0].dtype == np.float32
    for a, b in zip(f32, ul):
        np.testing.assert_array_equal(b, _host(a))  # same greedy PCM -> same bytes
