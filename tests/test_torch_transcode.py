"""PyTorch port, the server's host audio: `transcode` byte for byte against
the JAX package's on the same PCM for every listed format, the native
float->int16 and resampler against the JAX package's native ones, the
G.711 route, and the MPEG Layer I/II encoder's round trips (the cases of
tests/test_mpeg.py) on the port's own copy."""

import numpy as np
import pytest

from smoltts_torch.io import mpeg
from smoltts_torch.io.g711 import resample_to_8k, ulaw_decode_np
from smoltts_torch.io.mp3 import decode_mpeg_mpg123, mpeg_header_info
from smoltts_torch.io.wav import pcm_to_int16
from smoltts_torch.native import audio_io
from smoltts_torch.server.tts_core import resample_pcm, transcode
from smoltts_tpu.io.g711 import resample_to_8k as jax_resample_to_8k
from smoltts_tpu.io.wav import pcm_to_int16 as jax_pcm_to_int16
from smoltts_tpu.native import audio_io as jax_audio_io
from smoltts_tpu.server.tts_core import transcode as jax_transcode
from tests import torch_threads  # noqa: F401  (one intra-op thread)


def speechlike(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(n)
    return np.convolve(w, np.ones(8) / 8.0, mode="same") * 0.4


def tone(freq, rate, seconds=0.5, amp=0.5):
    t = np.arange(int(rate * seconds)) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float64)


def snr_db(ref, got):
    err = ref - got
    return 10 * np.log10((ref**2).mean() / max((err**2).mean(), 1e-20))


PCM = np.concatenate([speechlike(1920 * 5, 0), [1.5, -1.5, 1.0, -1.0, 0.0]]).astype(np.float32)


@pytest.mark.parametrize("fmt", ["pcm_24000", "wav_16000", "wav_44100", "ulaw_8000",
                                 "mp3_22050_64", "mp3_44100_128", "mp3_48000_192"])
def test_transcode_equals_jax(fmt, monkeypatch):
    monkeypatch.setenv("SMOLTTS_MP3_ENCODER", "layer2")
    got, media = transcode(PCM, fmt)
    ref, ref_media = jax_transcode(PCM, fmt)
    assert media == ref_media
    assert len(got) > 0 and got == ref
    if fmt.startswith("mp3"):
        assert mpeg_header_info(got)["layer"] == 2


def test_transcode_rejects_unknown_formats():
    for fmt in ("ogg_24000", "pcm", "opus_48000_64"):
        with pytest.raises(NotImplementedError):
            transcode(PCM, fmt)


def test_native_audio_equals_jax():
    assert audio_io.native_audio_available() and jax_audio_io.native_audio_available()
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-1.5, 1.5, 4096), [0.0, 1.0, -1.0, 2.0, -2.0]]).astype(np.float32)
    i16 = audio_io.f32_to_i16(x)
    np.testing.assert_array_equal(i16, jax_audio_io.f32_to_i16(x))
    np.testing.assert_array_equal(i16, (np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16))
    np.testing.assert_array_equal(audio_io.i16_to_f32(i16), jax_audio_io.i16_to_f32(i16))
    for rate in (8000, 16_000, 22_050, 44_100, 48_000):
        np.testing.assert_array_equal(audio_io.resample(x, 24_000, rate),
                                      jax_audio_io.resample(x, 24_000, rate))
        np.testing.assert_array_equal(resample_pcm(x, 24_000, rate), audio_io.resample(x, 24_000, rate))
    np.testing.assert_array_equal(audio_io.resample(x, 24_000, 24_000), x)
    np.testing.assert_array_equal(resample_to_8k(x, 24_000), jax_resample_to_8k(x, 24_000))
    # the native path of pcm_to_int16 keeps the shape; int16 passes through
    x2 = x[:4096].reshape(64, 64)
    np.testing.assert_array_equal(pcm_to_int16(x2), jax_pcm_to_int16(x2))
    assert pcm_to_int16(i16) is i16


def test_pcm_to_int16_without_the_native_build(monkeypatch):
    monkeypatch.setattr(audio_io, "native_audio_available", lambda: False)
    np.testing.assert_array_equal(pcm_to_int16(PCM), jax_pcm_to_int16(PCM))


def test_resample_without_the_native_build_takes_scipy(monkeypatch):
    from scipy import signal

    monkeypatch.setattr(audio_io, "native_audio_available", lambda: False)
    np.testing.assert_array_equal(resample_pcm(PCM, 24_000, 16_000),
                                  signal.resample(PCM, int(len(PCM) * 16_000 / 24_000)))


def test_server_ulaw_8000_route():
    t = np.arange(4800) / 24000.0
    pcm = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    data, media = transcode(pcm, "ulaw_8000")
    assert media == "audio/basic"
    assert len(data) == 1600  # 0.2 s at 8 kHz, 1 byte per sample
    dec = ulaw_decode_np(np.frombuffer(data, np.uint8)).astype(np.float64) / 32767
    spec = np.abs(np.fft.rfft(dec * np.hanning(len(dec))))
    assert abs(np.argmax(spec) * 8000 / len(dec) - 440) < 15


def test_lame_default_and_layer2_fallback(monkeypatch):
    monkeypatch.delenv("SMOLTTS_MP3_ENCODER", raising=False)
    pcm = tone(440, 24_000).astype(np.float32)
    data, media = transcode(pcm, "mp3_44100_128")
    assert media == "audio/mpeg"
    layer = mpeg_header_info(data)["layer"]
    assert data == jax_transcode(pcm, "mp3_44100_128")[0]
    assert layer in (2, 3)  # 3 where libmp3lame is installed
    monkeypatch.setenv("SMOLTTS_MP3_ENCODER", "layer2")
    data2, _ = transcode(pcm, "mp3_44100_128")
    assert mpeg_header_info(data2)["layer"] == 2
    out = decode_mpeg_mpg123(data2)
    if out is not None:  # mpg123, a decoder this repo did not write, where installed
        assert out[1] == 44_100 and len(out[0]) > 44_100 // 2


@pytest.mark.parametrize("rate,kbps,layer,data_at", [
    (24_000, 128, None, 768), (44_100, 128, 1, 4 * (12 * 128000 // 44100)),
    (44_100, 128, None, 144 * 128000 // 44100)])
def test_mpeg_header_fields_and_frame_size(rate, kbps, layer, data_at):
    data = mpeg.encode_mpeg_audio(tone(1000, rate), rate, bitrate_kbps=kbps, layer=layer)
    assert data[0] == 0xFF and (data[1] & 0xE0) == 0xE0
    version = 0b10 if rate < 32_000 else 0b11  # MPEG-2 LSF below 32 kHz
    assert (data[1] >> 3) & 0b11 == version
    assert (data[1] >> 1) & 0b11 == (0b11 if layer == 1 else 0b10)
    assert data[data_at] == 0xFF and (data[data_at + 1] & 0xE0) == 0xE0


# (rate, kbps, layer, signal, SNR floor in dB): tests/test_mpeg.py's cases
ROUNDTRIPS = [
    (44_100, 128, None, "tone", 30.0), (44_100, 64, None, "tone", 30.0),
    (48_000, 128, None, "tone", 30.0), (32_000, 96, None, "tone", 30.0),
    (48_000, 320, None, "tone", 30.0), (44_100, 128, None, "speech", 18.0),
    (16_000, 96, None, "tone", 30.0), (22_050, 128, None, "tone", 30.0),
    (24_000, 128, None, "tone", 30.0), (24_000, 160, None, "speech", 22.0),
    (16_000, 192, None, "tone", 30.0), (24_000, 192, None, "tone", 30.0),
    (44_100, 320, 1, "tone", 30.0), (24_000, 256, None, "speech", 20.0),
]


@pytest.mark.parametrize("rate,kbps,layer,kind,floor", ROUNDTRIPS)
def test_mpeg_roundtrip(rate, kbps, layer, kind, floor):
    if kind == "tone":
        x = tone(440 if rate < 32_000 else 1000, rate)
    else:
        x = speechlike(rate, {44_100: 5, 24_000: 3}[rate] if kbps != 256 else 1)
    data = mpeg.encode_mpeg_audio(x, rate, bitrate_kbps=kbps, layer=layer)
    y, got_rate = mpeg.decode_mpeg_audio(data)
    assert got_rate == rate
    n = min(len(x), len(y)) - 600
    assert snr_db(x[:n], y[:n]) > floor


def test_mpeg_filterbank_and_bitrate_scaling():
    x = np.random.default_rng(0).standard_normal(mpeg._FRAME_SAMPLES * 20) * 0.3
    y = mpeg.synthesize(mpeg.analyze(x))
    assert snr_db(x[: len(x) - 600], y[: len(x) - 600]) > 40.0
    t = tone(523, 24_000)
    snrs = []
    for kbps in (48, 96, 160):
        y, _ = mpeg.decode_mpeg_audio(mpeg.encode_mpeg_audio(t, 24_000, bitrate_kbps=kbps))
        n = min(len(t), len(y)) - 600
        snrs.append(snr_db(t[:n], y[:n]))
    assert snrs[0] < snrs[-1] and snrs[-1] > 40.0
    with pytest.raises(NotImplementedError):
        mpeg.encode_mpeg_audio(np.zeros(384), 11_025)
