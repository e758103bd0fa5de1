"""G.711 mu-law: the host (numpy) encoder and decoder, and the encoder in
PyTorch that runs where the PCM is (the engine's `emit_format="ulaw"`).

The integer algorithm is the standard G.711 segment encoding (bias 0x84,
clip 32635, 8 exponent segments, 4-bit mantissa, ones-complement output),
so the bytes decode in any telephony stack: +0 is the silence byte 0xFF.
"""

from __future__ import annotations

import numpy as np
import torch

_BIAS = 0x84
_CLIP = 32635


def ulaw_encode_np(pcm16: np.ndarray) -> np.ndarray:
    """int16 PCM -> uint8 mu-law (G.711)."""
    x = pcm16.astype(np.int32)
    neg = x < 0
    a = np.clip(np.where(neg, -x, x), 0, _CLIP) + _BIAS
    # exponent: position of the highest set bit above bit 7 (a >= 0x84 > 0)
    exp = (np.floor(np.log2(a)).astype(np.int32) - 7).clip(0, 7)
    mant = (a >> (exp + 3)) & 0x0F
    # The pre-complement sign bit is set for NEGATIVE samples, so on the wire
    # (ones complement) positives carry the sign bit (Sun g711.c, ffmpeg).
    byte = (np.where(neg, 0x80, 0x00) | (exp << 4) | mant).astype(np.uint8)
    return np.invert(byte)


def ulaw_decode_np(b: np.ndarray) -> np.ndarray:
    """uint8 mu-law -> int16 PCM (G.711 inverse)."""
    u = np.invert(b.astype(np.uint8)).astype(np.int32)
    sign = u & 0x80  # pre-complement sign: set = negative
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    mag = (((mant << 3) + _BIAS) << exp) - _BIAS
    return np.where(sign != 0, -mag, mag).astype(np.int16)


def ulaw_encode(pcm: torch.Tensor) -> torch.Tensor:
    """float PCM in [-1, 1] -> uint8 mu-law, on the tensor's device. Bit-exact
    against the host path `ulaw_encode_np(round(clip(pcm) * 32767))` in
    float64: the product is taken in float64 (in float32 a sample such as
    27.49999997 / 32767 rounds to 27.5 and then to 28), `torch.round` rounds
    half to even as numpy does, and the exponent is counted with integer
    compares (the segment boundaries 256 << k) rather than a float log2."""
    x = torch.round(torch.clamp(pcm.double(), -1.0, 1.0) * 32767.0).to(torch.int32)
    neg = x < 0
    a = torch.clamp(torch.where(neg, -x, x), 0, _CLIP) + _BIAS
    exp = torch.zeros_like(a)
    for k in range(7):  # floor(log2(a)) - 7, clipped to [0, 7]
        exp += (a >= (256 << k)).to(torch.int32)
    mant = torch.bitwise_right_shift(a, exp + 3) & 0x0F
    byte = (neg.to(torch.int32) << 7) | (exp << 4) | mant
    return (~byte & 0xFF).to(torch.uint8)


def resample_to_8k(pcm: np.ndarray, rate: int) -> np.ndarray:
    """Windowed-sinc resample to 8 kHz through the native audio helper."""
    from smoltts_torch.native.audio_io import resample

    return resample(pcm, rate, 8000)
