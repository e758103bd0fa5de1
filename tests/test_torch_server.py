"""PyTorch port, the HTTP server: boot the port's asyncio server on a free
port over a tiny random SmolTTS on the CPU and exercise the OpenAI and
ElevenLabs routes over a socket (the cases of tests/test_server.py, plus
every blocking format, /metrics and a clean stop); the settings against the
JAX package's, with a temporary XDG_CACHE_HOME."""

import http.client
import json
import socket
import sys
import threading
import time

import pytest
import torch

from smoltts_torch import SmolTTS
from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.config import ModelType, tiny_debug_config
from smoltts_torch.io.checkpoint import save_params
from smoltts_torch.io.mp3 import mpeg_header_info
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.server import settings as torch_settings
from smoltts_torch.server.app import build_app
from smoltts_torch.server.settings import DEFAULT_SETTINGS, ServerSettings
from smoltts_torch.server.tts_core import TTSCore
from smoltts_torch.tokenizer import save_byte_level_tokenizer
from smoltts_tpu.server.settings import ServerSettings as JaxServerSettings
from tests import torch_threads  # noqa: F401  (one intra-op thread)

CB = 32
MIMI = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=CB,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)
HOP = 48  # samples per frame of the small codec (hop 24 * 2)


def write_checkpoint(d):
    cfg = tiny_debug_config(codebook_size=CB, vocab_size=256 + 64 + CB)
    save_params(init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg, d)
    save_byte_level_tokenizer(d, CB)


def make_tts(d, **settings):
    tts = SmolTTS(d, generation_settings=GenerationSettings(**settings), device="cpu")
    tts.codec_config = MimiConfig(**MIMI)
    tts.codec_params = tm.init_mimi_params(tts.codec_config, seed=0, device="cpu")
    return tts


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve(app):
    """Run `app` on a free port in a thread; returns (port, thread)."""
    port = free_port()
    th = threading.Thread(target=app.run, args=("127.0.0.1", port), daemon=True)
    th.start()
    for _ in range(200):
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=0.2):
                break
        except OSError:
            time.sleep(0.05)
    return port, th


def shut(app, th):
    app.stop()
    th.join(timeout=30)
    assert not th.is_alive(), "the server thread did not stop"


def post(port, path, body, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    return conn.getresponse()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    write_checkpoint(d)
    tts = make_tts(d, default_temp=0.7, default_fast_temp=0.7, max_new_tokens=4,
                   audio_only_constraint=True)
    app = build_app(TTSCore(tts))
    port, th = serve(app)
    yield port
    shut(app, th)


def test_health_and_index(server):
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=30)
    conn.request("GET", "/health")
    r = conn.getresponse()
    assert r.status == 200
    assert json.loads(r.read())["sampling_rate"] == 24_000
    conn.request("GET", "/")
    r = conn.getresponse()
    assert r.status == 200
    assert b"smoltts" in r.read()


def test_openai_route(server):
    r = post(server, "/v1/audio/speech", {"input": "Hello.", "voice": "0"})
    assert r.status == 200
    assert r.getheader("Content-Type") == "audio/wav"
    assert r.getheader("Content-Disposition") == 'attachment; filename="speech.wav"'
    body = r.read()
    assert body[:4] == b"RIFF" and (len(body) - 44) % (2 * HOP) == 0


def test_openai_validation(server):
    r = post(server, "/v1/audio/speech", {"voice": "0"})
    assert r.status == 422
    r.read()
    r = post(server, "/v1/audio/speech", {"input": "x", "response_format": "ogg"})
    assert r.status == 422


def test_elevenlabs_blocking_pcm(server):
    r = post(server, "/v1/text-to-speech/0?output_format=pcm_24000", {"text": "Hi"})
    assert r.status == 200
    assert r.getheader("X-Sample-Rate") == "24000"
    body = r.read()
    assert len(body) % (2 * HOP) == 0 and len(body) > 0  # whole int16 frames


def test_elevenlabs_wav_resampled(server):
    r = post(server, "/v1/text-to-speech/0?output_format=wav_16000", {"text": "Hi"})
    assert r.status == 200
    assert r.getheader("Content-Type") == "audio/wav"
    assert r.getheader("X-Sample-Rate") == "16000"
    r.read()


@pytest.mark.parametrize("fmt,media,disposition", [
    ("ulaw_8000", "audio/basic", "ulaw"), ("mp3_44100_128", "audio/mpeg", "mp3"),
    ("opus_48000", None, None)])
def test_elevenlabs_other_formats(server, fmt, media, disposition):
    r = post(server, f"/v1/text-to-speech/0?output_format={fmt}", {"text": "Hi"})
    body = r.read()
    if media is None:  # not a format the server knows
        assert r.status == 501 and b"not yet supported" in body
        return
    assert r.status == 200 and r.getheader("Content-Type") == media
    assert r.getheader("Content-Disposition") == (
        f'attachment; filename="elevenlabs_speech.{disposition}"')
    assert r.getheader("X-Sample-Rate") == fmt.split("_")[1]
    if fmt.startswith("ulaw"):
        assert len(body) > 0 and len(body) % (HOP // 3) == 0  # 8 kHz, one byte a sample
    else:
        assert mpeg_header_info(body)["layer"] in (2, 3)


def test_elevenlabs_stream(server):
    r = post(server, "/v1/text-to-speech/0/stream", {"text": "Hi"})
    assert r.status == 200
    assert r.getheader("X-Sample-Rate") == "24000"
    assert r.getheader("Content-Type") == "audio/x-pcm"
    body = r.read()  # http.client reassembles chunked encoding
    assert len(body) > 0 and len(body) % (2 * HOP) == 0


def test_unknown_route_and_method(server):
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=30)
    conn.request("GET", "/nope")
    r = conn.getresponse()
    assert r.status == 404
    r.read()  # drain before reusing the connection
    conn.request("GET", "/v1/audio/speech")
    r = conn.getresponse()
    assert r.status == 405
    r.read()
    conn.request("POST", "/v1/audio/speech", "{not json", {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 400
    r.read()


def test_metrics_count_stream_requests(server):
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=30)
    conn.request("GET", "/metrics")
    before = json.loads(conn.getresponse().read())
    post(server, "/v1/text-to-speech/0/stream", {"text": "Count me."}).read()
    conn.request("GET", "/metrics")
    m = json.loads(conn.getresponse().read())
    assert m["requests"] == before["requests"] + 1
    assert m["frames"] > before["frames"]
    assert m["first_audio_ms_p50"] >= 0 and m["uptime_s"] > 0


def test_settings_validation(tmp_path):
    for cls in (ServerSettings, JaxServerSettings):
        with pytest.raises(ValueError, match="Cannot specify both model_id and checkpoint_dir"):
            cls(model_id="a", checkpoint_dir="b")
        with pytest.raises(ValueError, match="Must specify either model_id or checkpoint_dir"):
            cls()
    s = ServerSettings(checkpoint_dir=str(tmp_path))
    assert s.get_checkpoint_dir() == tmp_path
    assert s.generation.to_settings().max_new_tokens == 1024
    assert s.model_type == ModelType.smoltts_v0()


def _fields(s):
    g = s.generation.to_settings()
    return (s.model_id, s.checkpoint_dir, s.mimi_path, s.model_type.family, s.model_type.codec,
            s.model_type.version, g.default_temp, g.default_fast_temp, g.min_p, g.max_new_tokens,
            g.audio_only_constraint)


def test_settings_bootstrap_and_config_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    s = ServerSettings.get_settings()
    path = tmp_path / "cache" / "smoltts" / "settings" / "config.json"
    assert json.loads(path.read_text()) == DEFAULT_SETTINGS
    assert _fields(s) == _fields(JaxServerSettings.get_settings())
    assert s.model_id == "jkeisling/smoltts_v0" and s.generation.default_temp == 0.5
    # a config naming a checkpoint, with keys the settings do not know
    cfg = {"checkpoint_dir": str(tmp_path), "mimi_path": "m.safetensors", "unknown": 1,
           "generation": {"default_temp": 0.0, "min_p": None, "max_new_tokens": 24, "x": 2},
           "model_type": {"family": "dual_ar", "codec": "mimi", "version": "v1"}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    s = ServerSettings.get_settings(str(cfg_path))
    assert _fields(s) == _fields(JaxServerSettings.get_settings(str(cfg_path)))
    assert s.generation.to_settings() == GenerationSettings(
        default_temp=0.0, default_fast_temp=0.0, min_p=None, max_new_tokens=24)
    # the bootstrapped file is read back on the next call
    path.write_text(json.dumps(dict(DEFAULT_SETTINGS, model_id="someone/else")))
    assert ServerSettings.get_settings().model_id == "someone/else"


def test_checkpoint_dir_without_hub_access_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # no hub, so no network
    with pytest.raises(RuntimeError, match="no hub access.*set checkpoint_dir"):
        ServerSettings(model_id="jkeisling/smoltts_v0").get_checkpoint_dir()
    assert torch_settings._cache_config_path().name == "config.json"
