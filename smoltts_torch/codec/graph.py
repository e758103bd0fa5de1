"""The Mimi vocoder step over a streaming state that stays in place, replayed
as a CUDA graph on the card (utils/graphs.py).

`mimi_decode_step` is plain PyTorch: the RVQ gather, the upsampling
transposed conv, the codec transformer over its ring and the SEANet stack,
hundreds of small launches a frame. Its state is stepped in place: every
leaf keeps its storage across steps, flushes (`flush_mimi_state`) and
resets (`reset_stream_state`, `reset_stream_slots`, `scatter_stream_state`).

- `step_in_place`: the eager step, each new leaf copied into the given
  state's leaf. The CPU path, and any state stepped without graphs.
- `VocoderGraphs`: on CUDA, one graph per (state, codes shape), captured on
  first use and replayed after. A graph holds the state and parameters it
  captured, so their addresses stay theirs. The same kernels in the same
  dtypes as the eager step, plus the codes' copy into the graph's input
  and the PCM's clone out of its output.

Spans: `codec.capture` and `codec.replay` (utils/graphs.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.mimi import (
    MimiParams,
    MimiStreamState,
    map_stream_state,
    mimi_decode_step,
    stream_state_leaves,
)
from smoltts_torch.utils.graphs import GraphCache, copy_back


def step_in_place(params: MimiParams, cfg: MimiConfig, state: MimiStreamState,
                  codes: torch.Tensor):
    """codes [B, K, T] -> (state, PCM [B, T * 1920, 1]): `mimi_decode_step`,
    then each new leaf copied into `state`'s, so `state` is advanced."""
    new, pcm = mimi_decode_step(params, cfg, state, codes)
    copy_back(stream_state_leaves(state), stream_state_leaves(new))
    return state, pcm


class _Graph(NamedTuple):
    replay: object  # -> the static PCM
    codes: torch.Tensor  # the static input
    held: tuple  # (params, state): the graph reads and writes their addresses


def _key(params, state: MimiStreamState, codes: torch.Tensor) -> tuple:
    leaves = tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                   for t in stream_state_leaves(state))
    return (id(params), codes.shape, codes.dtype, codes.device) + leaves


class VocoderGraphs:
    """The vocoder step of `step_in_place`, replayed as CUDA graphs: call it
    as `(params, cfg, state, codes) -> (state, PCM)`. The PCM is a fresh
    tensor each call. Not for concurrent use from two threads."""

    def __init__(self, max_graphs: int = 4):
        self._graphs = GraphCache("codec", max_graphs)

    @staticmethod
    def graphed(codes: torch.Tensor) -> bool:
        """Whether a step on `codes`' device replays a graph: on CUDA."""
        return codes.device.type == "cuda"

    @torch.no_grad()
    def __call__(self, params: MimiParams, cfg: MimiConfig, state: MimiStreamState,
                 codes: torch.Tensor):
        if not self.graphed(codes):
            return step_in_place(params, cfg, state, codes)
        g = self._get(params, cfg, state, codes)
        g.codes.copy_(codes)
        return state, self._graphs.replay(g.replay).clone()

    @torch.no_grad()
    def capture(self, params: MimiParams, cfg: MimiConfig, state: MimiStreamState,
                codes: torch.Tensor) -> None:
        """Capture the graph for `state` and codes shaped as `codes` unless
        it is held. `state` is not advanced (a capture runs nothing)."""
        if self.graphed(codes):
            self._get(params, cfg, state, codes)

    def _get(self, params, cfg, state, codes) -> _Graph:
        return self._graphs.get(_key(params, state, codes),
                                lambda: self._capture(params, cfg, state, codes))

    def _capture(self, params, cfg, state, codes) -> _Graph:
        static = torch.zeros_like(codes)
        replay = self._graphs.capture(lambda st: step_in_place(params, cfg, st, static)[1],
                                      state, map_stream_state, codes.device)
        return _Graph(replay, static, (params, state))
