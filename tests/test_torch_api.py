"""PyTorch port, the library API against the JAX package's `SmolTTS` on one
checkpoint dir (written by the JAX package: tiny config, byte-level
tokenizer), the small Mimi injected into both, greedy with the audio window
so frames are audio: `__call__` PCM, `stream` chunks, `create_speaker`
prompts, the speaker store and voices.json, quantize modes and the device
rule."""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from smoltts_tpu import SmolTTS as JaxSmolTTS
from smoltts_tpu.codec import mimi as jm
from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.io.checkpoint_interop import save_params as jax_save_params
from smoltts_tpu.lm.samplers import GenerationSettings as JaxSettings
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.tokenizer import save_byte_level_tokenizer as jax_save_tokenizer
from smoltts_torch import SmolTTS
from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.ops.quant import QTensor
from tests import torch_threads  # noqa: F401  (one intra-op thread)

CB = 32
MIMI = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)
SETTINGS = dict(default_temp=0.0, default_fast_temp=0.0, max_new_tokens=6,
                audio_only_constraint=True)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    cfg = jax_tiny(codebook_size=CB, vocab_size=256 + 64 + CB)
    jax_save_params(jax.tree.map(np.asarray, jax_init(cfg, jax.random.PRNGKey(0))), cfg, d)
    jax_save_tokenizer(d, CB)
    return d


@pytest.fixture
def ckpt_copy(ckpt, tmp_path):
    d = tmp_path / "ckpt"
    shutil.copytree(ckpt, d)
    return d


def make_pair(d, quantize=None):
    jtts = JaxSmolTTS(d, generation_settings=JaxSettings(**SETTINGS), quantize=quantize)
    jtts.codec_config = JaxMimiConfig(**MIMI)
    jtts.codec_params = jm.init_mimi_params(jtts.codec_config, seed=0)
    tts = SmolTTS(d, generation_settings=GenerationSettings(**SETTINGS), quantize=quantize,
                  device="cpu")
    tts.codec_config = MimiConfig(**MIMI)
    tts.codec_params = tm.init_mimi_params(tts.codec_config, seed=0, device="cpu")
    return jtts, tts


@pytest.mark.parametrize("quantize", [None, "int8+kv8"])
def test_call_matches_jax(ckpt, quantize):
    jtts, tts = make_pair(ckpt, quantize)
    ref = jtts("Hello world.", voice="bella")
    got = tts("Hello world.", voice="bella")
    hop = tts.codec_config.samples_per_frame
    assert got.dtype == np.float32 and got.ndim == 1 and got.size % hop == 0 and got.size > 0
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert tts.sampling_rate == 24_000


@pytest.mark.parametrize("quantize", ["int8", "int8+kv8"])
def test_stream_matches_jax(ckpt, quantize):
    jtts, tts = make_pair(ckpt, quantize)
    ref = list(jtts.stream("Hi."))
    got = list(tts.stream("Hi."))
    assert len(got) == len(ref) == SETTINGS["max_new_tokens"]
    for a, b in zip(got, ref):
        assert a.shape == (tts.codec_config.samples_per_frame,)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_create_speaker_equals_jax(ckpt_copy):
    jtts, tts = make_pair(ckpt_copy)
    hop = tts.codec_config.samples_per_frame
    rng = np.random.default_rng(0)
    samples = [{"text": "ref text", "audio": rng.standard_normal(hop * 3 + 11).astype(np.float32) * 0.2},
               {"text": "more", "audio": rng.standard_normal(hop * 2).astype(np.float32) * 0.2}]
    ref = jtts.create_speaker(samples, system_prompt="clone this voice")
    got = tts.create_speaker(samples, system_prompt="clone this voice")
    assert got.shape[0] == tts.config.num_rows
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="text"):
        tts.create_speaker([{"audio": samples[0]["audio"]}])

    # the speaker store: saved under the checkpoint, found by a new instance
    tts.save_speaker("alice", got)
    again = SmolTTS(ckpt_copy, generation_settings=GenerationSettings(**SETTINGS), device="cpu")
    np.testing.assert_array_equal(again.get_speaker("alice"), got)
    assert again.get_speaker("nobody") is None
    prompt = again._get_prompt("Hi.", "alice")
    np.testing.assert_array_equal(prompt, jtts._get_prompt("Hi.", "x", sysprompt=got))


def test_voices_json(ckpt_copy):
    (ckpt_copy / "voices.json").write_text(json.dumps(["ann", "bob", "cy"]))
    jtts, tts = make_pair(ckpt_copy)
    assert tts.voices == jtts.voices == ["ann", "bob", "cy"]
    for voice in ("bob", "unknown"):
        np.testing.assert_array_equal(tts._get_prompt("Hey.", voice), jtts._get_prompt("Hey.", voice))


def test_quantize_modes_and_device_rule(ckpt, monkeypatch, tmp_path):
    tts = SmolTTS(ckpt, quantize="int8", device="cpu")
    assert isinstance(tts.params["layers"]["wqkv"], QTensor)
    assert tts.params["layers"]["wqkv"].q.dtype == torch.int8 and "w13" in tts.params["layers"]
    assert tts.kv_dtype == torch.bfloat16
    assert SmolTTS(ckpt, quantize="int8+kv8", device="cpu").kv_dtype == torch.int8
    assert tts.codec_params is None
    with pytest.raises(RuntimeError, match="Mimi"):
        next(tts.stream("Hi."))
    with pytest.raises(ValueError, match="int4"):
        SmolTTS(tmp_path / "does-not-exist", quantize="int4", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SmolTTS(ckpt)


def test_generator_advances_across_calls(ckpt):
    """Sampled calls draw from one generator: two calls differ, and a fresh
    instance with the same seed repeats the first."""
    kw = dict(SETTINGS, default_temp=1.0, default_fast_temp=1.0)

    def make():
        tts = SmolTTS(ckpt, generation_settings=GenerationSettings(**kw), device="cpu", seed=5)
        tts.codec_config = MimiConfig(**MIMI)
        tts.codec_params = tm.init_mimi_params(tts.codec_config, seed=0, device="cpu")
        return tts

    tts = make()
    first, second = tts("Hello."), tts("Hello.")
    assert not (first.shape == second.shape and np.array_equal(first, second))
    np.testing.assert_array_equal(make()("Hello."), first)
