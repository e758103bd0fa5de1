"""Native audio host kernels (ctypes over native/audio.c).

Float<->PCM16 conversion and windowed-sinc resampling for the serving
transcode path; the JAX package's `smoltts_tpu/native/audio_io.py` with its
own build. io/wav.py and server/tts_core.py take numpy / scipy when no C
toolchain is present.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from smoltts_torch.native import build_native_lib

_SRC = Path(__file__).parent / "audio.c"


def _lib() -> Optional[ctypes.CDLL]:
    lib = build_native_lib(_SRC, "audio", extra_flags=("-lm",))
    if lib is None or getattr(lib, "_audio_bound", False):
        return lib
    lib.audio_f32_to_i16.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
    ]
    lib.audio_f32_to_i16.restype = None
    lib.audio_i16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.audio_i16_to_f32.restype = None
    lib.audio_resample.restype = ctypes.c_int64
    lib.audio_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib._audio_bound = True
    return lib


def native_audio_available() -> bool:
    return _lib() is not None


def f32_to_i16(pcm: np.ndarray) -> np.ndarray:
    """float PCM -> int16, flattened: clip to [-1, 1], scale by 32767,
    truncate (numpy's clip + astype)."""
    lib = _lib()
    x = np.ascontiguousarray(pcm, dtype=np.float32).ravel()
    out = np.empty(x.size, dtype=np.int16)
    lib.audio_f32_to_i16(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        x.size,
    )
    return out


def i16_to_f32(pcm: np.ndarray) -> np.ndarray:
    lib = _lib()
    x = np.ascontiguousarray(pcm, dtype=np.int16).ravel()
    out = np.empty(x.size, dtype=np.float32)
    lib.audio_i16_to_f32(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size,
    )
    return out


def resample(pcm: np.ndarray, in_rate: int, out_rate: int, zeros: int = 16) -> np.ndarray:
    """Resample float PCM to `int(n * out_rate / in_rate)` samples."""
    lib = _lib()
    x = np.ascontiguousarray(pcm, dtype=np.float32).ravel()
    n_out = int(x.size * out_rate / in_rate)
    out = np.empty(max(n_out, 0), dtype=np.float32)
    if n_out > 0 and x.size > 0:
        lib.audio_resample(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            x.size,
            in_rate,
            out_rate,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_out,
            zeros,
        )
    return out
