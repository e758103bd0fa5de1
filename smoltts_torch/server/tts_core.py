"""Audio transcoding + model glue behind the HTTP routes (the JAX package's
`smoltts_tpu/server/tts_core.py` over the port's SmolTTS).

Blocking generation to pcm/wav/mp3/ulaw at a requested sample rate, and raw
PCM16 streaming. Transcoding is a table of pure functions over float32 PCM;
resampling prefers the native C sinc resampler and takes scipy's FFT
resample (the reference server's) when no C toolchain exists; MP3 is LAME's
Layer III where the library is installed, else the numpy Layer II encoder
(io/mpeg.py).

Format strings follow the ElevenLabs convention ``<codec>_<rate>[_<kbps>]``,
e.g. ``pcm_24000``, ``wav_16000``, ``mp3_44100_128``, ``ulaw_8000``.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple, Union

import numpy as np

from smoltts_torch.io.wav import pcm_to_int16, pcm_to_wav_bytes

NATIVE_RATE = 24_000


def resample_pcm(pcm: np.ndarray, rate_in: int, rate_out: int) -> np.ndarray:
    """Sample-rate conversion: native windowed-sinc when the C extension
    builds, scipy FFT resample otherwise."""
    from smoltts_torch.native.audio_io import native_audio_available, resample

    if rate_in == rate_out or pcm.size == 0:
        return pcm
    if native_audio_available():
        return resample(pcm, rate_in, rate_out)
    from scipy import signal

    return signal.resample(pcm, int(len(pcm) * rate_out / rate_in))


def _as_pcm(pcm: np.ndarray, rate: int, _spec: Tuple[str, ...]) -> Tuple[bytes, str]:
    return pcm_to_int16(pcm).tobytes(), "audio/x-pcm"


def _as_wav(pcm: np.ndarray, rate: int, _spec: Tuple[str, ...]) -> Tuple[bytes, str]:
    return pcm_to_wav_bytes(pcm, sample_rate=rate), "audio/wav"


def _as_mp3(pcm: np.ndarray, rate: int, spec: Tuple[str, ...]) -> Tuple[bytes, str]:
    """mp3_{rate}_{kbps}: MPEG-1/2 Layer III through the system LAME library
    when present, else the numpy Layer II encoder (io/mpeg.py).
    SMOLTTS_MP3_ENCODER=layer2 forces the Layer II encoder."""
    from smoltts_torch.io.mp3 import encode_mp3_lame
    from smoltts_torch.io.mpeg import encode_mpeg_audio

    kbps = int(spec[2]) if len(spec) > 2 else 128
    if os.environ.get("SMOLTTS_MP3_ENCODER") != "layer2":
        data = encode_mp3_lame(pcm, rate, bitrate_kbps=kbps)
        if data is not None:
            return data, "audio/mpeg"
    return encode_mpeg_audio(pcm, rate, bitrate_kbps=kbps), "audio/mpeg"


def _as_ulaw(pcm: np.ndarray, rate: int, _spec: Tuple[str, ...]) -> Tuple[bytes, str]:
    """G.711 mu-law (the ElevenLabs `ulaw_8000` output format family)."""
    from smoltts_torch.io.g711 import ulaw_encode_np

    return ulaw_encode_np(pcm_to_int16(pcm)).tobytes(), "audio/basic"


_TRANSCODERS = {"pcm": _as_pcm, "wav": _as_wav, "mp3": _as_mp3, "ulaw": _as_ulaw}


def transcode(pcm: np.ndarray, output_format: str) -> Tuple[bytes, str]:
    """float32 PCM @ 24 kHz -> (encoded bytes, media type) per format spec."""
    spec = tuple(output_format.split("_"))
    encode = _TRANSCODERS.get(spec[0])
    if encode is None or len(spec) < 2:
        raise NotImplementedError(f"Format {output_format} not yet supported")
    rate = int(spec[1])
    mono = resample_pcm(np.asarray(pcm, np.float32).reshape(-1), NATIVE_RATE, rate)
    return encode(mono, rate, spec)


class TTSCore:
    """Binds a loaded SmolTTS model to the transcoding table for the routes."""

    def __init__(self, model, settings=None):
        self.model = model
        self.settings = settings

    def generate_audio(
        self,
        input_text: str,
        voice: Union[str, int],
        response_format: str = "wav_24000",
    ) -> Tuple[bytes, str]:
        pcm = self.model(input_text, str(voice))
        return transcode(pcm, response_format or "pcm_24000")

    def stream_audio(self, input_text: str, voice: Union[str, int]) -> Iterator[bytes]:
        for chunk in self.model.stream(input_text, str(voice)):
            if chunk is not None:
                yield pcm_to_int16(chunk).tobytes()
