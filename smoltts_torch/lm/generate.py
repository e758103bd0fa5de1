"""Generation loops over the prefill and frame steps, batched over B
streams, with the JAX package's semantics:

- `FrameGenerator`: a host iterator yielding one FrameOutput per 80 ms
  frame, flushing the ring tail before it wraps;
- `generate_blocking`: drains it into stacked audio codes plus wall-clock
  metrics (prefill ms, frames/s, x-realtime at 12.5 Hz);
- `make_device_generator`: prefill and a fixed number of frames with no
  host read between frames.

The sampling state is an explicit `torch.Generator` on the device, in the
place of the JAX PRNG key; it advances with every frame.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig
from smoltts_torch.lm.decode import (
    FrameOutput,
    decode_frame,
    flush_kv,
    init_decode_state,
    make_decode_fns,
    prefill,
)
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.tokenizer import TokenConfig

FRAME_RATE = 12.5  # Mimi frames/s


@dataclass
class GenerationMetrics:
    prefill_ms: float = 0.0
    decode_s: float = 0.0
    frames: int = 0

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def x_realtime(self) -> float:
        return self.frames_per_s / FRAME_RATE


def pad_prompts(prompts: List[np.ndarray], pad_to_multiple: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad [R, T_i] prompts to a common bucketed length -> ([B, R, T], [B])."""
    lens = np.array([p.shape[-1] for p in prompts], dtype=np.int32)
    T = int(max(lens))
    T = ((T + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
    out = np.zeros((len(prompts), prompts[0].shape[0], T), dtype=np.int32)
    for i, p in enumerate(prompts):
        out[i, :, : p.shape[-1]] = p
    return out, lens


def _sync(t: torch.Tensor) -> None:
    """Wait for the work that produces `t` (JAX's block_until_ready)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class FrameGenerator:
    """Batched, KV-cached frame generator (a host loop over the steps)."""

    def __init__(self, params, cfg: DualARConfig, token_cfg: TokenConfig,
                 settings: GenerationSettings, prompts: List[np.ndarray],
                 generator: Optional[torch.Generator] = None, max_seq_len: Optional[int] = None,
                 kv_dtype=torch.bfloat16, device=None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.settings = settings
        self.params = params
        self.metrics = GenerationMetrics()
        self._prefill_fn, self._decode_fn = make_decode_fns(cfg, token_cfg, settings)
        self.generator = generator if generator is not None else torch.Generator(dev).manual_seed(0)

        prompt, prompt_len = pad_prompts(prompts)
        B = prompt.shape[0]
        state = init_decode_state(cfg, B, max_seq_len or cfg.max_seq_len, dtype=kv_dtype,
                                  device=dev)
        t0 = time.perf_counter()
        self.state, first = self._prefill_fn(params, state, torch.from_numpy(prompt).to(dev),
                                             torch.from_numpy(prompt_len).to(dev), self.generator)
        _sync(first.tokens)
        self.metrics.prefill_ms = (time.perf_counter() - t0) * 1e3
        self._first: Optional[FrameOutput] = first
        self._emitted = 0
        self._since_flush = 0
        self._tail_len = self.state.tail_len

    def __iter__(self) -> Iterator[FrameOutput]:
        return self

    def __next__(self) -> FrameOutput:
        if self._first is not None:
            out, self._first = self._first, None
            self._emitted += 1
            return out
        if self._emitted >= self.settings.max_new_tokens:
            raise StopIteration
        if bool(self.state.finished.all()):
            raise StopIteration
        if self._since_flush >= self._tail_len - 1:
            with torch.no_grad():
                self.state = flush_kv(self.state)
            self._since_flush = 0
        self.state, out = self._decode_fn(self.params, self.state, self.generator)
        self._since_flush += 1
        self._emitted += 1
        return out


def generate_blocking(params, cfg: DualARConfig, token_cfg: TokenConfig,
                      settings: GenerationSettings, prompts: List[np.ndarray],
                      generator: Optional[torch.Generator] = None, verbose: bool = False,
                      device=None) -> Tuple[np.ndarray, np.ndarray, GenerationMetrics]:
    """Generate to completion. Returns (audio_codes [B, ncb, T], n_frames
    [B], metrics); frames after a stream finishes are zero-filled."""
    gen = FrameGenerator(params, cfg, token_cfg, settings, prompts, generator=generator,
                         device=device)
    frames: List[torch.Tensor] = []
    valid: List[torch.Tensor] = []
    t0 = time.perf_counter()
    for out in gen:
        frames.append(out.audio_codes)
        valid.append(out.is_audio)
    if frames:
        _sync(frames[-1])
    gen.metrics.decode_s = time.perf_counter() - t0
    gen.metrics.frames = len(frames)

    codes = torch.stack(frames, dim=-1).cpu().numpy()  # [B, ncb, T]
    valid_arr = torch.stack(valid, dim=-1).cpu().numpy()  # [B, T]
    codes = codes * valid_arr[:, None, :]
    n_frames = valid_arr.sum(axis=-1).astype(np.int32)
    if verbose:
        m = gen.metrics
        print(f"prefill {m.prefill_ms:.1f}ms | {m.frames} frames in {m.decode_s:.2f}s "
              f"({m.frames_per_s:.1f} frames/s, {m.x_realtime:.1f}x realtime/stream)")
    return codes, n_frames, gen.metrics


def make_device_generator(cfg: DualARConfig, token_cfg: TokenConfig, settings: GenerationSettings,
                          num_frames: int, device=None):
    """Prefill and `num_frames - 1` frames with no host read in between and
    no flush, so the state's ring tail must hold them all. Returns a
    callable (params, state, prompt, prompt_len, generator) ->
    (audio_codes [B, ncb, num_frames], is_audio [B, num_frames], finished)."""
    resolve_device(device)

    @torch.no_grad()
    def run(params, state, prompt, prompt_len, generator):
        if state.tail_len < num_frames:
            raise ValueError(f"device generator needs tail_len >= num_frames "
                             f"({state.tail_len} < {num_frames})")
        state, first = prefill(params, cfg, token_cfg, settings, state, prompt, prompt_len,
                               generator)
        codes, valid = [first.audio_codes], [first.is_audio]
        for _ in range(num_frames - 1):
            state, out = decode_frame(params, cfg, token_cfg, settings, state, generator)
            codes.append(out.audio_codes)
            valid.append(out.is_audio)
        return torch.stack(codes, dim=-1), torch.stack(valid, dim=-1), state.finished

    return run
