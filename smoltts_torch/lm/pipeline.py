"""Serving pipeline: one LM frame step followed by the Mimi vocoder step.

`make_prefill_step` (prompt -> first frame -> first PCM chunk),
`make_stream_step` (one frame -> 1920 PCM samples per stream) and
`make_flush_step` (consolidate the LM and codec ring tails) return plain
callables with the JAX package's signatures: state in, state out, with the
generator in the place of the PRNG key. Large buffers are updated in place
(see lm/decode.py), so a state passed to a step must not be reused.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from smoltts_torch import resolve_device
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.mimi import MimiStreamState, flush_mimi_state, mimi_decode_step
from smoltts_torch.config import DualARConfig
from smoltts_torch.lm.decode import DecodeState, decode_frame, flush_kv, prefill
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.tokenizer import TokenConfig


class StreamStepOutput(NamedTuple):
    pcm: torch.Tensor  # [B, samples, 1]
    audio_codes: torch.Tensor  # [B, ncb]
    is_audio: torch.Tensor  # [B]
    finished: torch.Tensor  # [B]


def make_stream_step(cfg: DualARConfig, token_cfg: TokenConfig, settings: GenerationSettings,
                     mimi_cfg: MimiConfig, attend_limit: Optional[int] = None, device=None):
    """(lm_params, mimi_params, state, mimi_state, generator) ->
    (state', mimi_state', generator, StreamStepOutput). `attend_limit`
    bounds slow-trunk attention reads (length bucketing)."""
    resolve_device(device)

    @torch.no_grad()
    def step(lm_params, mimi_params, state: DecodeState, mimi_state: MimiStreamState, generator):
        state, out = decode_frame(lm_params, cfg, token_cfg, settings, state, generator,
                                  attend_limit=attend_limit)
        mimi_state, pcm = mimi_decode_step(mimi_params, mimi_cfg, mimi_state,
                                           out.audio_codes[:, :, None])
        return state, mimi_state, generator, StreamStepOutput(
            pcm=pcm, audio_codes=out.audio_codes, is_audio=out.is_audio, finished=out.finished
        )

    return step


def make_prefill_step(cfg: DualARConfig, token_cfg: TokenConfig, settings: GenerationSettings,
                      mimi_cfg: MimiConfig, device=None):
    """(lm_params, mimi_params, state, mimi_state, prompt, prompt_len,
    generator) -> (state', mimi_state', generator, StreamStepOutput)."""
    resolve_device(device)

    @torch.no_grad()
    def step(lm_params, mimi_params, state, mimi_state, prompt, prompt_len, generator):
        state, out = prefill(lm_params, cfg, token_cfg, settings, state, prompt, prompt_len,
                             generator)
        mimi_state, pcm = mimi_decode_step(mimi_params, mimi_cfg, mimi_state,
                                           out.audio_codes[:, :, None])
        return state, mimi_state, generator, StreamStepOutput(
            pcm=pcm, audio_codes=out.audio_codes, is_audio=out.is_audio, finished=out.finished
        )

    return step


def make_flush_step(device=None):
    """(state, mimi_state or None) -> (state', mimi_state'): flush both ring
    tails. Call every `flush_cadence` frames."""
    resolve_device(device)

    @torch.no_grad()
    def step(state: DecodeState, mimi_state: Optional[MimiStreamState]):
        state = flush_kv(state)
        if mimi_state is not None:
            mimi_state = flush_mimi_state(mimi_state)
        return state, mimi_state

    return step


def flush_cadence(state: DecodeState, mimi_state: Optional[MimiStreamState]) -> int:
    """Max frames between flushes for the given state shapes."""
    frames = int(state.tail_len) - 1
    if mimi_state is not None:
        frames = min(frames, int(mimi_state.transformer.tail_len) // 2 - 1)
    return max(frames, 1)
