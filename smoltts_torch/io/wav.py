"""WAV (RIFF) output: float PCM to 16-bit WAV bytes."""

from __future__ import annotations

import struct

import numpy as np


def pcm_to_int16(pcm: np.ndarray) -> np.ndarray:
    """float PCM -> int16 (clip, scale by 32767, truncate), through the native
    converter when it builds; int16 (the engine's frames) passes through."""
    from smoltts_torch.native.audio_io import f32_to_i16, native_audio_available

    pcm = np.asarray(pcm)
    if pcm.dtype == np.int16:
        return pcm
    if native_audio_available():
        return f32_to_i16(pcm).reshape(pcm.shape)
    x = np.clip(pcm.astype(np.float32), -1.0, 1.0)
    return (x * 32767.0).astype(np.int16)


def _fmt(sample_rate: int, num_channels: int) -> bytes:
    byte_rate = sample_rate * num_channels * 2
    return b"fmt " + struct.pack("<IHHIIHH", 16, 1, num_channels, sample_rate, byte_rate,
                                 num_channels * 2, 16)


def pcm_to_wav_bytes(pcm: np.ndarray, sample_rate: int = 24_000, num_channels: int = 1) -> bytes:
    data = pcm_to_int16(pcm).tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + _fmt(sample_rate, num_channels)
            + b"data" + struct.pack("<I", len(data)) + data)


def wav_header(sample_rate: int = 24_000, num_channels: int = 1,
               data_size: int = 0xFFFFFFFF - 100) -> bytes:
    """A WAV header alone (for streaming responses of unknown length)."""
    return (b"RIFF" + struct.pack("<I", 36 + data_size) + b"WAVE" + _fmt(sample_rate, num_channels)
            + b"data" + struct.pack("<I", data_size))
