"""The Mimi vocoder step over a streaming state that stays in place, replayed
as a CUDA graph on the card.

`mimi_decode_step` is plain PyTorch: the RVQ gather, the upsampling
transposed conv, the codec transformer over its ring and the SEANet stack,
hundreds of small launches a frame that cost the host far more time
than the card's work. A graph replays them in one launch. It replays fixed
addresses, so the state is stepped in place: every leaf keeps its storage
across steps, flushes (`flush_mimi_state`) and resets
(`reset_stream_state`, `reset_stream_slots`, `scatter_stream_state`).

- `step_in_place`: the eager step, each new leaf copied into the given
  state's leaf. The CPU path, and any state stepped without graphs.
- `VocoderGraphs`: on CUDA, one graph per (state, codes shape), captured on
  first use and replayed after; a few at most, the least recently used
  dropped first. A graph holds the state and parameters it captured, so
  their addresses stay theirs. The same kernels in the same dtypes as the
  eager step, plus the codes' copy into the graph's input and the PCM's
  clone out of its output.

Spans (utils/profiling.py `SPANS`): `codec.capture` around each capture
(its eager warm-up passes included), `codec.replay` around each replay.
"""

from __future__ import annotations

import collections
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
from smoltts_torch.utils.profiling import SPANS

# Eager passes on a scratch state before a capture: cuBLAS and cuDNN make
# their handles, workspaces and plans on the capture stream.
WARMUP_STEPS = 2


def step_in_place(params: MimiParams, cfg: MimiConfig, state: MimiStreamState,
                  codes: torch.Tensor):
    """codes [B, K, T] -> (state, PCM [B, T * 1920, 1]): `mimi_decode_step`,
    then each new leaf copied into `state`'s, so `state` is advanced."""
    new, pcm = mimi_decode_step(params, cfg, state, codes)
    for old, leaf in zip(stream_state_leaves(state), stream_state_leaves(new)):
        if leaf is not old:
            old.copy_(leaf)
    return state, pcm


class _Graph(NamedTuple):
    graph: object  # torch.cuda.CUDAGraph
    codes: torch.Tensor  # the static input
    pcm: torch.Tensor  # the static output
    state: MimiStreamState  # held: the graph writes these addresses
    params: MimiParams


def _key(params, state: MimiStreamState, codes: torch.Tensor) -> tuple:
    leaves = tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                   for t in stream_state_leaves(state))
    return (id(params), codes.shape, codes.dtype, codes.device) + leaves


class VocoderGraphs:
    """The vocoder step of `step_in_place`, replayed as CUDA graphs: call it
    as `(params, cfg, state, codes) -> (state, PCM)`. The PCM is a fresh
    tensor each call. Not for concurrent use from two threads."""

    def __init__(self, max_graphs: int = 4):
        self.max_graphs = max(1, int(max_graphs))
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
        self._stream = None  # the capture stream, made at the first capture

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
        with SPANS.span("codec.replay"):
            g.graph.replay()
        return state, g.pcm.clone()

    @torch.no_grad()
    def capture(self, params: MimiParams, cfg: MimiConfig, state: MimiStreamState,
                codes: torch.Tensor) -> None:
        """Capture the graph for `state` and codes shaped as `codes` unless
        it is held. `state` is not advanced (a capture runs nothing)."""
        if self.graphed(codes):
            self._get(params, cfg, state, codes)

    def _get(self, params, cfg, state, codes) -> _Graph:
        key = _key(params, state, codes)
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
            return g
        with SPANS.span("codec.capture"):
            g = self._capture(params, cfg, state, codes)
        self._graphs[key] = g
        while len(self._graphs) > self.max_graphs:
            self._graphs.popitem(last=False)
        return g

    def _capture(self, params, cfg, state, codes) -> _Graph:
        dev = codes.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream, current = self._stream, torch.cuda.current_stream(dev)
        static_codes = torch.zeros_like(codes)
        scratch = map_stream_state(torch.zeros_like, state)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                step_in_place(params, cfg, scratch, static_codes)
        current.wait_stream(stream)
        del scratch
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (the engine's fetchers) record events
        # and copy to the host while this one captures.
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            _, pcm = step_in_place(params, cfg, state, static_codes)
        return _Graph(graph, static_codes, pcm, state, params)
