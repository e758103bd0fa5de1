"""Serving pipeline: one LM frame step followed by the Mimi vocoder step.

`make_prefill_step` (prompt -> first frame -> first PCM chunk),
`make_stream_step` (one frame -> 1920 PCM samples per stream),
`make_chunk_step` (K frames -> K * 1920 samples per stream per call, the
throughput mode) and `make_flush_step` (consolidate the LM and codec ring
tails) return plain callables with the JAX package's signatures: state in,
state out, with the generator in the place of the PRNG key. Large buffers
are updated in place (see lm/decode.py), so a state passed to a step must
not be reused. The stream and chunk steps run one loop over their frames
(`frame_loop`, which the engine runs too). It steps the LM state wholly in
place, by `lm_frame` (lm/graph.py: an `LMFrameGraphs`, which replays the
frame as a CUDA graph, or by default `_frame_in_place`, the eager
`decode_frame` that this module imports, each renewed leaf copied back), and
every step steps the vocoder state wholly in place, by `vocoder`
(codec/graph.py: a `VocoderGraphs`, which replays the step as a CUDA
graph, or by default the eager `step_in_place`).

Each call records its span (`step.prefill`, `step.stream`, `step.chunk`,
`step.flush`; utils/profiling.py `SPANS`), and inside it each LM frame
(`lm.frame`, the prefill included) and each vocoder step (`codec.step`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from smoltts_torch import resolve_device
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.graph import step_in_place
from smoltts_torch.codec.mimi import MimiStreamState, flush_mimi_state
from smoltts_torch.config import DualARConfig
from smoltts_torch.lm.decode import DecodeState, FrameOutput, decode_frame, flush_kv, prefill
from smoltts_torch.lm.graph import keep_in_place
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.tokenizer import TokenConfig
from smoltts_torch.utils.profiling import SPANS


class StreamStepOutput(NamedTuple):
    pcm: torch.Tensor  # [B, samples, 1]
    audio_codes: torch.Tensor  # [B, ncb] ([B, ncb, K] chunked)
    is_audio: torch.Tensor  # [B] ([B, K] chunked)
    finished: torch.Tensor  # [B], after the last frame
    # The port's additions, which the engine accounts frame by frame:
    slow_token: Optional[torch.Tensor] = None  # [B] ([B, K] chunked)
    finished_frames: Optional[torch.Tensor] = None  # [B, K] after each frame (chunked)


def _vocoded(vocode, mimi_params, mimi_cfg, mimi_state, out: FrameOutput):
    """One frame's codes vocoded (`codec.step`) -> (mimi_state',
    StreamStepOutput)."""
    with SPANS.span("codec.step"):
        mimi_state, pcm = vocode(mimi_params, mimi_cfg, mimi_state, out.audio_codes[:, :, None])
    return mimi_state, StreamStepOutput(pcm=pcm, audio_codes=out.audio_codes,
                                        is_audio=out.is_audio, finished=out.finished,
                                        slow_token=out.slow_token)


def _frame_in_place(params, cfg, token_cfg, settings, state, generator, attend_limit=None,
                    mesh=None):
    """lm/graph.py `frame_in_place` over the `decode_frame` of this module,
    the name that the benchmark's fault tests patch."""
    new, out = decode_frame(params, cfg, token_cfg, settings, state, generator,
                            attend_limit=attend_limit, mesh=mesh)
    return keep_in_place(state, new), out


def frame_loop(cfg: DualARConfig, token_cfg: TokenConfig, settings: GenerationSettings,
               mimi_cfg: MimiConfig, frames: int, attend_limit: Optional[int] = None,
               mesh=None, vocoder=None, lm_frame=None):
    """The frame steps' loop: (lm_params, mimi_params, state, mimi_state,
    generator) -> (state', mimi_state', [StreamStepOutput] one per frame),
    `frames` LM frames (`lm.frame`), each vocoded (`codec.step`). Arguments
    as in `make_stream_step`; the caller opens its step's span."""
    vocode = step_in_place if vocoder is None else vocoder
    advance = _frame_in_place if lm_frame is None else lm_frame

    def loop(lm_params, mimi_params, state: DecodeState, mimi_state: MimiStreamState, generator):
        outs = []
        for _ in range(frames):
            with SPANS.span("lm.frame"):
                state, out = advance(lm_params, cfg, token_cfg, settings, state, generator,
                                     attend_limit=attend_limit, mesh=mesh)
            mimi_state, out = _vocoded(vocode, mimi_params, mimi_cfg, mimi_state, out)
            outs.append(out)
        return state, mimi_state, outs

    return loop


def make_stream_step(cfg: DualARConfig, token_cfg: TokenConfig, settings: GenerationSettings,
                     mimi_cfg: MimiConfig, attend_limit: Optional[int] = None, device=None,
                     mesh=None, vocoder=None, lm_frame=None):
    """(lm_params, mimi_params, state, mimi_state, generator) ->
    (state', mimi_state', generator, StreamStepOutput). `attend_limit`
    bounds slow-trunk attention reads (length bucketing). `mesh`: the
    parallel/mesh.py mesh of trees laid out by parallel/serving.py (each
    rank steps its own slots); None for whole trees. `vocoder` and
    `lm_frame`: the vocoder step and the LM frame (module docstring)."""
    resolve_device(device)
    loop = frame_loop(cfg, token_cfg, settings, mimi_cfg, 1, attend_limit, mesh, vocoder,
                      lm_frame)

    @torch.no_grad()
    def step(lm_params, mimi_params, state: DecodeState, mimi_state: MimiStreamState, generator):
        with SPANS.span("step.stream"):
            state, mimi_state, (out,) = loop(lm_params, mimi_params, state, mimi_state, generator)
            return state, mimi_state, generator, out

    return step


def make_prefill_step(cfg: DualARConfig, token_cfg: TokenConfig, settings: GenerationSettings,
                      mimi_cfg: MimiConfig, device=None, mesh=None, vocoder=None):
    """(lm_params, mimi_params, state, mimi_state, prompt, prompt_len,
    generator) -> (state', mimi_state', generator, StreamStepOutput). On a
    `mesh` the prompt and lengths are this rank's slots'. `vocoder` as in
    `make_stream_step`."""
    resolve_device(device)
    vocode = step_in_place if vocoder is None else vocoder

    @torch.no_grad()
    def step(lm_params, mimi_params, state, mimi_state, prompt, prompt_len, generator):
        with SPANS.span("step.prefill"):
            with SPANS.span("lm.frame"):
                state, out = prefill(lm_params, cfg, token_cfg, settings, state, prompt,
                                     prompt_len, generator, mesh=mesh)
            mimi_state, out = _vocoded(vocode, mimi_params, mimi_cfg, mimi_state, out)
            return state, mimi_state, generator, out

    return step


def make_chunk_step(cfg: DualARConfig, token_cfg: TokenConfig, settings: GenerationSettings,
                    mimi_cfg: MimiConfig, frames_per_chunk: int,
                    attend_limit: Optional[int] = None, device=None, mesh=None,
                    vocoder=None, lm_frame=None):
    """(lm_params, mimi_params, state, mimi_state, generator) ->
    (state', mimi_state', generator, StreamStepOutput) over K =
    `frames_per_chunk` frames: PCM [B, K * 1920, 1], codes [B, ncb, K],
    is_audio, slow tokens and finished flags [B, K]. With `attend_limit` the
    caller guarantees max(pos) + K <= attend_limit, and flushes between calls
    so the K frames fit the tails. `mesh`, `vocoder` and `lm_frame` as in
    `make_stream_step`."""
    resolve_device(device)
    loop = frame_loop(cfg, token_cfg, settings, mimi_cfg, frames_per_chunk, attend_limit, mesh,
                      vocoder, lm_frame)

    @torch.no_grad()
    def step(lm_params, mimi_params, state: DecodeState, mimi_state: MimiStreamState, generator):
        with SPANS.span("step.chunk"):
            state, mimi_state, outs = loop(lm_params, mimi_params, state, mimi_state, generator)
            frames = StreamStepOutput(*zip(*outs))
            return state, mimi_state, generator, StreamStepOutput(
                pcm=torch.cat(frames.pcm, dim=1),
                audio_codes=torch.stack(frames.audio_codes, dim=-1),
                is_audio=torch.stack(frames.is_audio, dim=-1), finished=frames.finished[-1],
                slow_token=torch.stack(frames.slow_token, dim=-1),
                finished_frames=torch.stack(frames.finished, dim=-1),
            )

    return step


def make_flush_step(device=None):
    """(state, mimi_state or None) -> (state', mimi_state'): flush both ring
    tails. Call every `flush_cadence` frames."""
    resolve_device(device)

    @torch.no_grad()
    def step(state: DecodeState, mimi_state: Optional[MimiStreamState]):
        with SPANS.span("step.flush"):
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
