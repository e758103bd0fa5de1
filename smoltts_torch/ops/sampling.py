"""The slow-token site: temperature, min-p and Gumbel-max over each row of
logits, with the audio-only window and finished rows forced to <|im_end|>.

`sample_slow_token` computes the whole site of a frame, as the JAX
package's `lm/decode.py::_frame_from_hidden` does it (cast to f32, optional
`constrain_logits_to_audio`, `sample_token`, `where(finished, im_end, .)`).
For a CPU tensor it takes `sample_slow_token_plain`, that composition
itself; for a CUDA tensor it launches the kernel (csrc/sampling.cu) once,
greedy included, or raises. `sample_categorical` is the same kernel without
the window and the finished rows.

The kernel draws its Gumbel noise from Philox, keyed by a (seed, offset)
pair drawn from the caller's generator (`philox_seed`, also K1's; a
captured CUDA graph takes the pairs as static inputs, `StaticSeeds`), so it
matches the plain version in distribution, not draw for draw; min_p = 1,
one-hot logits and temperature 0 are exact. `philox_gumbel_plain` is the
kernel's noise draw for draw, and `sample_slow_token_emulated` the plain
math fed that noise: the kernel's ids, up to near ties.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

from smoltts_torch import ops
from smoltts_torch.lm.samplers import constrain_logits_to_audio, min_p_mask, sample_token
from smoltts_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SAMPLER_STREAM = 0x53414D50  # "SAMP": the third word of the kernel's Philox counter
_M32 = 0xFFFFFFFF


def philox_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """{seed, offset} as two int64 on `device`, drawn from `generator`; while
    a `StaticSeeds` holds the thread, its next buffer instead."""
    held = getattr(_HELD, "seeds", None)
    if held is not None:
        return held._take(device)
    gdev = generator.device if generator is not None else torch.device("cpu")
    seed = torch.randint(0, 2**62, (2,), generator=generator, device=gdev, dtype=torch.int64)
    return seed.to(device, non_blocking=True)


_HELD = threading.local()


class StaticSeeds:
    """The (seed, offset) pairs of a captured program as static inputs.
    Inside `hold()` each `philox_seed` call of this thread takes the next
    buffer (made, zeroed, by the first pass; later passes reuse them) and
    draws nothing. `draw(generator)` fills the buffers by the same calls in
    the same order, so a replay draws what the eager calls would."""

    def __init__(self):
        self.buffers: list = []
        self._next = 0

    @contextlib.contextmanager
    def hold(self):
        self._next, _HELD.seeds = 0, self
        try:
            yield self
        finally:
            _HELD.seeds = None

    def _take(self, device) -> torch.Tensor:
        if self._next == len(self.buffers):
            self.buffers.append(torch.zeros(2, dtype=torch.int64, device=device))
        buf = self.buffers[self._next]
        self._next += 1
        return buf

    def draw(self, generator: Optional[torch.Generator]) -> None:
        for buf in self.buffers:
            buf.copy_(philox_seed(generator, buf.device))


# The plain version is the LM sampler itself.
sample_categorical_plain = sample_token


def _semantic_end(token_cfg) -> int:
    return token_cfg.semantic_end_id or token_cfg.semantic_start_id


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sample_tokens kernel: {msg}")


def _kernel(logits: torch.Tensor, generator, temperature: Optional[float], min_p: Optional[float],
            im_end_id: int = 0, semantic: Optional[tuple] = None,
            finished: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch: [B, V] f32 or bf16 logits -> [B] int32 ids. `semantic`
    = (start, end) turns the window {im_end_id} U [start, end] on; rows
    where `finished` holds give `im_end_id`."""
    _require(logits.dim() == 2 and logits.dtype in _DTYPE_CODE,
             f"need [B, V] f32 or bf16 logits, got {tuple(logits.shape)} {logits.dtype}")
    B, V = logits.shape
    _require(logits.stride(1) == 1 or V == 1, f"columns must have unit stride, got {logits.stride()}")
    _require(0 < V < 2**31 - 64 and B < 2**31, f"shape {tuple(logits.shape)}")
    greedy = temperature is None or temperature <= 0.0
    _require(greedy or math.isfinite(temperature), f"temperature {temperature}")
    _require(min_p is None or 0.0 < min_p <= 1.0, f"min_p must be in (0, 1], got {min_p}")
    dev = logits.device
    if finished is not None:
        _require(finished.dtype == torch.bool and tuple(finished.shape) == (B,)
                 and finished.is_contiguous() and finished.device == dev,
                 f"finished must be contiguous bool [{B}] on {dev}")
    lo, hi = semantic if semantic is not None else (0, 0)
    _require(all(0 <= i < 2**31 for i in (im_end_id, lo, hi)), "token ids out of int32 range")
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    seed = None if greedy else philox_seed(generator, dev)
    code = _build.lib().smoltts_sample_tokens(
        logits.data_ptr(), _DTYPE_CODE[logits.dtype], B, V, logits.stride(0),
        0.0 if greedy else float(temperature),
        math.log(min_p) if min_p is not None else 0.0, int(min_p is not None),
        int(semantic is not None), lo, hi, im_end_id,
        finished.data_ptr() if finished is not None else None,
        seed.data_ptr() if seed is not None else None,
        out.data_ptr(), _build.stream_ptr(dev),
    )
    _build.check(code, "sample_tokens")
    ops.LAUNCHES["sample_categorical"] += 1
    return out


def sample_categorical(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    temperature: Optional[float],
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """[B, V] logits -> [B] int32 ids; argmax at temperature 0."""
    if not logits.is_cuda:
        return sample_categorical_plain(logits, generator, temperature=temperature, min_p=min_p)
    return _kernel(logits, generator, temperature, min_p)


def sample_slow_token_plain(logits, generator, settings, token_cfg, finished) -> torch.Tensor:
    """The slow-token site as plain PyTorch: [B, V] logits -> [B] int32."""
    logits = logits.float()
    if settings.audio_only_constraint:
        logits = constrain_logits_to_audio(
            logits, token_cfg.im_end_id, token_cfg.semantic_start_id, _semantic_end(token_cfg)
        )
    token = sample_token(logits, generator, temperature=settings.default_temp, min_p=settings.min_p)
    return torch.where(finished, torch.full_like(token, token_cfg.im_end_id), token)


def sample_slow_token(logits, generator, settings, token_cfg, finished) -> torch.Tensor:
    """The slow-token site: one kernel launch for a CUDA tensor (the bf16
    logits of the token head are read as they are), the plain version for a
    CPU tensor."""
    if not logits.is_cuda:
        return sample_slow_token_plain(logits, generator, settings, token_cfg, finished)
    semantic = ((token_cfg.semantic_start_id, _semantic_end(token_cfg))
                if settings.audio_only_constraint else None)
    return _kernel(logits, generator, settings.default_temp, settings.min_p,
                   token_cfg.im_end_id, semantic, finished)


# ---- the kernel's arithmetic, in plain PyTorch ----------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of m * b for m, b < 2^32, in int64 without
    overflow: m is split into 16-bit halves."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    low = m_lo * b  # < 2^48
    t = m_hi * b + (low >> 16)  # m * b = t * 2^16 + (low mod 2^16)
    return t >> 16, ((t & 0xFFFF) << 16) | (low & 0xFFFF)


def philox4x32_10(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    words: `ctr` four words, `key` two; returns the four output words."""
    x, y, z, w = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], x)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], z)
        x, y, z, w = hi1 ^ y ^ k0, lo1, hi0 ^ w ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return x, y, z, w


def philox_gumbel_plain(seed, offset, rows: int, cols: int) -> torch.Tensor:
    """[rows, cols] f32 Gumbel noise, draw for draw the kernel's: element
    (r, c) is word c % 4 of Philox4x32-10 with counter {c / 4, r, "SAMP",
    offset} and key seed, mapped to u = (top 23 bits + 0.5) / 2^23 and
    -log(-log(u)). `seed` and `offset` are ints or int64 scalar tensors; the
    noise lies on their device."""
    dev = seed.device if torch.is_tensor(seed) else torch.device("cpu")
    i64 = dict(dtype=torch.int64, device=dev)
    seed = torch.as_tensor(seed, **i64)
    offset = torch.as_tensor(offset, **i64)
    groups = -(-cols // 4)
    c0 = torch.arange(groups, **i64)[None, :].expand(rows, groups)
    c1 = torch.arange(rows, **i64)[:, None].expand(rows, groups)
    c2 = torch.full((rows, groups), _SAMPLER_STREAM, **i64)
    c3 = (offset & _M32).expand(rows, groups)
    words = philox4x32_10((c0, c1, c2, c3), (seed & _M32, (seed >> 32) & _M32))
    words = torch.stack(words, dim=-1).reshape(rows, 4 * groups)[:, :cols]
    u = ((words >> 9).to(torch.float32) + 0.5) * (1.0 / 8388608.0)
    return -torch.log(-torch.log(u))


def slow_token_scores(logits, settings, token_cfg) -> torch.Tensor:
    """The kernel's scores before the noise, in f32: the window, l / T by
    IEEE division (a tensor divisor: PyTorch's CUDA division by a Python
    scalar multiplies by the reciprocal) and -inf below the min-p
    threshold."""
    x = logits.float()
    if settings.audio_only_constraint:
        x = constrain_logits_to_audio(
            x, token_cfg.im_end_id, token_cfg.semantic_start_id, _semantic_end(token_cfg)
        )
    temp = torch.tensor(settings.default_temp, dtype=torch.float32, device=x.device)
    return min_p_mask(x / temp, settings.min_p)


def sample_slow_token_emulated(logits, generator, settings, token_cfg, finished) -> torch.Tensor:
    """The kernel's method in plain PyTorch: the seed pair drawn as the
    kernel's wrapper draws it, `philox_gumbel_plain` noise, argmax of the
    noisy scores (greedy as the plain version)."""
    temp = settings.default_temp
    if temp is None or temp <= 0.0:
        return sample_slow_token_plain(logits, generator, settings, token_cfg, finished)
    seed = philox_seed(generator, logits.device)
    noise = philox_gumbel_plain(seed[0], seed[1], *logits.shape)
    token = torch.argmax(slow_token_scores(logits, settings, token_cfg) + noise, dim=-1)
    token = token.to(torch.int32)
    return torch.where(finished, torch.full_like(token, token_cfg.im_end_id), token)
