"""True MPEG-1 Layer III via the system LAME library, plus an independent
MPEG audio decoder via mpg123 — both bound with ctypes (no pip deps). The
port's copy of `smoltts_tpu/io/mp3.py`.

The reference serves MP3 through pydub, which shells out to LAME
(mlx_inference/src/smoltts_mlx/server/tts_core.py:69-82). This module
closes the last format-fidelity delta the same way the reference does:
`libmp3lame` produces genuine Layer III frames for the `mp3_*` response
formats (server/tts_core.py prefers it when present), with the from-scratch
Layer II encoder (io/mpeg.py) as the no-native-libs fallback.

`libmpg123` doubles as the INDEPENDENT decoder for validating the
from-scratch Layer II bitstreams (tests/test_mpeg.py round-tripped only
through this repo's own decoder before — semi-independent at best).

Both libraries are optional: every entry point degrades to None/False when
the shared object is absent, and callers fall back to io/mpeg.py.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

# LAME MPEG_mode enum: STEREO=0, JOINT_STEREO=1, DUAL_CHANNEL=2, MONO=3
_LAME_MONO = 3

# mpg123 return codes (mpg123.h enum mpg123_errors)
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_NEED_MORE = -10
_MPG123_OK = 0

# lame_encode_buffer is not documented thread-safe per-handle; handles are
# per-call here, but serialize library init for safety.
_LOCK = threading.Lock()


@lru_cache(maxsize=1)
def _lame() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL("libmp3lame.so.0")
    except OSError:
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for fn in (
        "lame_set_in_samplerate", "lame_set_out_samplerate",
        "lame_set_num_channels", "lame_set_brate", "lame_set_mode",
        "lame_set_quality", "lame_set_bWriteVbrTag",
    ):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lame_init_params.argtypes = [ctypes.c_void_p]
    lib.lame_encode_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ]
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.lame_close.argtypes = [ctypes.c_void_p]
    return lib


@lru_cache(maxsize=1)
def _mpg123() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL("libmpg123.so.0")
    except OSError:
        return None
    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    return lib


def lame_available() -> bool:
    return _lame() is not None


def mpg123_available() -> bool:
    return _mpg123() is not None


def encode_mp3_lame(
    pcm: np.ndarray, rate: int, bitrate_kbps: int = 128
) -> Optional[bytes]:
    """float [-1,1] (or int16) mono PCM -> MPEG-1/2 Layer III bytes via
    libmp3lame (CBR, mono, VBR tag off). None if the library is absent."""
    lib = _lame()
    if lib is None:
        return None
    if pcm.dtype != np.int16:
        pcm = (np.clip(pcm.astype(np.float64), -1.0, 1.0) * 32767.0).astype(np.int16)
    pcm = np.ascontiguousarray(pcm)
    with _LOCK:
        gf = lib.lame_init()
        try:
            lib.lame_set_in_samplerate(gf, int(rate))
            lib.lame_set_out_samplerate(gf, int(rate))
            lib.lame_set_num_channels(gf, 1)
            lib.lame_set_mode(gf, _LAME_MONO)
            lib.lame_set_brate(gf, int(bitrate_kbps))
            lib.lame_set_quality(gf, 2)
            lib.lame_set_bWriteVbrTag(gf, 0)
            if lib.lame_init_params(gf) != 0:
                return None
            buf = ctypes.create_string_buffer(pcm.nbytes + 7200)
            n = lib.lame_encode_buffer(
                gf, pcm.ctypes.data_as(ctypes.c_void_p), None,
                len(pcm), buf, len(buf),
            )
            if n < 0:
                return None
            tail = ctypes.create_string_buffer(7200)
            n2 = lib.lame_encode_flush(gf, tail, len(tail))
            return buf.raw[:n] + tail.raw[: max(n2, 0)]
        finally:
            lib.lame_close(gf)


def decode_mpeg_mpg123(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """MPEG audio bytes (Layer I/II/III) -> (int16 mono-or-interleaved PCM,
    rate) via libmpg123 — the independent-decoder oracle for both the LAME
    path and the from-scratch io/mpeg.py encoder. None if absent."""
    lib = _mpg123()
    if lib is None:
        return None
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        return None
    try:
        if lib.mpg123_open_feed(h) != _MPG123_OK:
            return None
        if lib.mpg123_feed(h, data, len(data)) != _MPG123_OK:
            return None
        out = ctypes.create_string_buffer(1 << 20)
        done = ctypes.c_size_t(0)
        pcm = bytearray()
        rate = 0
        for _ in range(1 << 16):  # bounded; feed-mode read loop
            rc = lib.mpg123_read(h, out, len(out), ctypes.byref(done))
            pcm += out.raw[: done.value]
            if rc == _MPG123_NEW_FORMAT:
                r = ctypes.c_long(0)
                ch = ctypes.c_int(0)
                enc = ctypes.c_int(0)
                lib.mpg123_getformat(h, ctypes.byref(r), ctypes.byref(ch), ctypes.byref(enc))
                rate = int(r.value)
                continue
            if rc in (_MPG123_NEED_MORE, _MPG123_DONE):
                break
            if rc != _MPG123_OK:
                return None
            if done.value == 0:
                break
        if not pcm or rate == 0:
            return None
        return np.frombuffer(bytes(pcm), np.int16), rate
    finally:
        lib.mpg123_delete(h)


def mpeg_header_info(data: bytes) -> Optional[dict]:
    """Parse the first MPEG audio frame header: version, layer, bitrate
    index, samplerate index. For tests asserting what the route serves."""
    i = data.find(b"\xff")
    while i >= 0 and i + 4 <= len(data):
        b = data[i : i + 4]
        if b[0] == 0xFF and (b[1] & 0xE0) == 0xE0:
            version = (b[1] >> 3) & 0b11  # 3 = MPEG-1, 2 = MPEG-2 LSF
            layer_bits = (b[1] >> 1) & 0b11  # 1 = III, 2 = II, 3 = I
            return {
                "version": {3: 1, 2: 2}.get(version, version),
                "layer": {1: 3, 2: 2, 3: 1}.get(layer_bits, 0),
                "bitrate_index": (b[2] >> 4) & 0xF,
                "samplerate_index": (b[2] >> 2) & 0b11,
            }
        i = data.find(b"\xff", i + 1)
    return None
