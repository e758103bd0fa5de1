"""PyTorch port, the HTTP server against the JAX package's: one checkpoint
(written by the JAX package) loaded into the JAX `SmolTTS` and the port's
`SmolTTS(device="cpu")`, both greedy f32 with the small Mimi, each behind its
own `build_app` on its own port. Blocking bodies have equal length and int16
samples within 1 LSB (the port's PCM is within atol 1e-5 of JAX's,
tests/test_torch_api.py), and equal content type, disposition and sample-rate
headers."""

import jax
import numpy as np
import pytest

from smoltts_tpu import SmolTTS as JaxSmolTTS
from smoltts_tpu.codec import mimi as jm
from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.io.checkpoint_interop import save_params as jax_save_params
from smoltts_tpu.lm.samplers import GenerationSettings as JaxSettings
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.server.app import build_app as jax_build_app
from smoltts_tpu.server.tts_core import TTSCore as JaxTTSCore
from smoltts_tpu.tokenizer import save_byte_level_tokenizer as jax_save_tokenizer
from smoltts_torch.server.app import build_app
from smoltts_torch.server.tts_core import TTSCore
from tests.test_torch_server import CB, HOP, MIMI, make_tts, post, serve, shut
from tests import torch_threads  # noqa: F401  (one intra-op thread)

SETTINGS = dict(default_temp=0.0, default_fast_temp=0.0, max_new_tokens=6,
                audio_only_constraint=True)


@pytest.fixture(scope="module")
def ports(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    cfg = jax_tiny(codebook_size=CB, vocab_size=256 + 64 + CB)
    jax_save_params(jax.tree.map(np.asarray, jax_init(cfg, jax.random.PRNGKey(0))), cfg, d)
    jax_save_tokenizer(d, CB)
    jtts = JaxSmolTTS(d, generation_settings=JaxSettings(**SETTINGS))
    jtts.codec_config = JaxMimiConfig(**MIMI)
    jtts.codec_params = jm.init_mimi_params(jtts.codec_config, seed=0)
    jax_port, _ = serve(jax_build_app(JaxTTSCore(jtts)))
    app = build_app(TTSCore(make_tts(d, **SETTINGS)))
    port, th = serve(app)
    yield jax_port, port
    shut(app, th)


HEADERS = ("Content-Type", "Content-Disposition", "X-Sample-Rate")


@pytest.mark.parametrize("path,body,header_bytes", [
    ("/v1/audio/speech", {"input": "Hello world.", "voice": "bella"}, 44),
    ("/v1/text-to-speech/bella?output_format=pcm_24000", {"text": "Hello world."}, 0),
    ("/v1/text-to-speech/bella?output_format=wav_16000", {"text": "Hello world."}, 44),
])
def test_blocking_bodies_match_jax(ports, path, body, header_bytes):
    jax_port, port = ports
    rj, r = post(jax_port, path, body), post(port, path, body)
    ref, got = rj.read(), r.read()
    assert r.status == rj.status == 200
    for h in HEADERS:
        assert r.getheader(h) == rj.getheader(h), h
    assert len(got) == len(ref) > header_bytes
    assert got[:header_bytes] == ref[:header_bytes]  # the WAV header
    a = np.frombuffer(got[header_bytes:], np.int16).astype(np.int32)
    b = np.frombuffer(ref[header_bytes:], np.int16).astype(np.int32)
    assert np.abs(a - b).max() <= 1
    if "16000" not in path:
        assert a.size % HOP == 0


def test_errors_match_jax(ports):
    jax_port, port = ports
    for path, body in (("/v1/audio/speech", {"voice": "0"}),
                       ("/v1/audio/speech", {"input": "x", "response_format": "ogg"}),
                       ("/v1/text-to-speech/0", {"input": "no text field"}),
                       ("/v1/text-to-speech/0?output_format=opus_48000", {"text": "x"})):
        rj, r = post(jax_port, path, body), post(port, path, body)
        assert (r.status, r.read()) == (rj.status, rj.read()), path
