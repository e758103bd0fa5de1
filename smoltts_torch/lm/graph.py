"""The LM frame over a decode state that stays in place, replayed as a CUDA
graph on the card.

`decode_frame` issues the slow trunk's products and glue, K2 in every
layer, K3 and K1: hundreds of launches a frame that cost the host far more
time than the card's work. A graph replays them in one launch. It replays
fixed addresses, so the state is stepped in place: every leaf keeps its
storage across frames, flushes (`flush_kv`), resets (`reset_decode_state`)
and the engine's admissions and freed slots (`index_copy_`, `index_fill_`).

- `frame_in_place`: `decode_frame`, then each small leaf it renewed
  (`tail_pos`, `phase`, `pos`, `prev_tokens`, `finished`) copied into the
  given state's leaf. The CPU path, and any state stepped without graphs.
- `LMFrameGraphs`: on CUDA, one graph per (parameters, the state's leaves,
  attend limit, sampling settings), captured on first use and replayed
  after; a few at most, the least recently used dropped first. A graph
  holds the state and parameters it captured, so their addresses stay
  theirs. It replays the eager frame's kernels; K1's and K3's Philox seeds
  are its static inputs (`ops/sampling.py::StaticSeeds`), drawn before
  each replay by the eager calls in the eager order, so a sampled replay
  equals the eager frame draw for draw. The frame's outputs come back as
  two fresh tensors (the int32 tokens and codes, the bool flags) viewed as
  a `FrameOutput`. A frame that reduces over a mesh (collectives go
  through the host) or samples its codebook levels from the generator in
  plain PyTorch (a tree K1 does not take, at a fast temperature above 0)
  stays eager.

Spans (utils/profiling.py `SPANS`): `lm.capture` around each capture (its
eager warm-up passes included), `lm.replay` around each replay.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import torch

from smoltts_torch import ops
from smoltts_torch.lm.decode import DecodeState, FrameOutput, decode_frame
from smoltts_torch.ops import attention as attn_ops
from smoltts_torch.ops.fast_loop import supports_fused_fast
from smoltts_torch.ops.sampling import StaticSeeds
from smoltts_torch.utils.profiling import SPANS

# Eager passes on a scratch state before a capture: cuBLAS makes its
# handles and workspaces, and the kernels' tables are cached, on the
# capture stream.
WARMUP_FRAMES = 2
# The leaves a frame or a prefill renews; the rest they write in place.
SMALL_LEAVES = ("tail_pos", "flushed", "phase", "pos", "prev_tokens", "finished")


def keep_in_place(state: DecodeState, new: DecodeState) -> DecodeState:
    """Copy each small leaf of `new` that is not `state`'s own into
    `state`'s; returns `state`, now holding `new`'s values."""
    for name in SMALL_LEAVES:
        old, leaf = getattr(state, name), getattr(new, name)
        if leaf is not old:
            old.copy_(leaf)
    return state


def frame_in_place(params, cfg, token_cfg, settings, state: DecodeState, generator,
                   attend_limit: Optional[int] = None, mesh=None, frame=decode_frame):
    """`frame` (`decode_frame`'s signature), then its renewed leaves copied
    into `state`: -> (state, FrameOutput), `state` advanced."""
    new, out = frame(params, cfg, token_cfg, settings, state, generator,
                     attend_limit=attend_limit, mesh=mesh)
    return keep_in_place(state, new), out


def map_decode_state(fn, state: DecodeState) -> DecodeState:
    return DecodeState(*(None if t is None else fn(t) for t in state))


def _launch_counts() -> dict:
    return {**{("ops", k): v for k, v in ops.LAUNCHES.items()},
            **{("route", k): v for k, v in attn_ops.ROUTE_LAUNCHES.items()}}


def _add_launches(counts: dict) -> None:
    for (table, k), n in counts.items():
        (ops.LAUNCHES if table == "ops" else attn_ops.ROUTE_LAUNCHES)[k] += n


def _packed(out: FrameOutput):
    """The frame's outputs as two tensors: int32 [B, rows + codebooks] (the
    next frame's tokens, then the audio codes) and bool [B, 2] (is_audio,
    finished)."""
    return (torch.cat([out.tokens, out.audio_codes], dim=1),
            torch.stack([out.is_audio, out.finished], dim=1))


def _unpacked(ints: torch.Tensor, flags: torch.Tensor, rows: int) -> FrameOutput:
    return FrameOutput(tokens=ints[:, :rows], audio_codes=ints[:, rows:],
                       slow_token=ints[:, 0], is_audio=flags[:, 0], finished=flags[:, 1])


class _Graph(NamedTuple):
    graph: object  # torch.cuda.CUDAGraph
    seeds: StaticSeeds  # the static inputs
    ints: torch.Tensor  # the static outputs (`_packed`)
    flags: torch.Tensor
    launches: dict  # the kernel launches a replay makes, by counter
    held: tuple  # (params, state, ...): the graph reads and writes their addresses


def _key(params, cfg, token_cfg, settings, state: DecodeState, attend_limit, frame) -> tuple:
    leaves = tuple(None if t is None else (t.data_ptr(), t.shape, t.stride(), t.dtype)
                   for t in state)
    sampling = (settings.default_temp, settings.default_fast_temp, settings.min_p,
                settings.audio_only_constraint)
    return (id(params), id(cfg), id(token_cfg), id(frame), attend_limit, sampling) + leaves


class LMFrameGraphs:
    """The LM frame of `frame_in_place`, replayed as CUDA graphs: call it as
    `frame_in_place` is called. Not for concurrent use from two threads."""

    def __init__(self, max_graphs: int = 4):
        self.max_graphs = max(1, int(max_graphs))
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
        self._stream = None  # the capture stream, made at the first capture

    @staticmethod
    def graphed(params, cfg, settings, state: DecodeState, mesh=None) -> bool:
        """Whether a frame replays a graph: on CUDA, without a mesh, and
        with every random draw through `philox_seed`."""
        fast_temp = settings.default_fast_temp
        return (state.pos.device.type == "cuda" and mesh is None
                and (fast_temp is None or fast_temp <= 0 or supports_fused_fast(cfg, params)))

    @torch.no_grad()
    def __call__(self, params, cfg, token_cfg, settings, state: DecodeState, generator,
                 attend_limit: Optional[int] = None, mesh=None, frame=decode_frame):
        if not self.graphed(params, cfg, settings, state, mesh):
            return frame_in_place(params, cfg, token_cfg, settings, state, generator,
                                  attend_limit=attend_limit, mesh=mesh, frame=frame)
        g = self._get(params, cfg, token_cfg, settings, state, attend_limit, frame)
        g.seeds.draw(generator)
        with SPANS.span("lm.replay"):
            g.graph.replay()
        _add_launches(g.launches)
        return state, _unpacked(g.ints.clone(), g.flags.clone(), cfg.num_rows)

    @torch.no_grad()
    def capture(self, params, cfg, token_cfg, settings, state: DecodeState,
                attend_limit: Optional[int] = None, mesh=None, frame=decode_frame) -> None:
        """Capture the graph for these arguments unless it is held. `state`
        is not advanced (a capture runs nothing) and no seed is drawn."""
        if self.graphed(params, cfg, settings, state, mesh):
            self._get(params, cfg, token_cfg, settings, state, attend_limit, frame)

    def _get(self, params, cfg, token_cfg, settings, state, attend_limit, frame) -> _Graph:
        key = _key(params, cfg, token_cfg, settings, state, attend_limit, frame)
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
            return g
        with SPANS.span("lm.capture"):
            g = self._capture(params, cfg, token_cfg, settings, state, attend_limit, frame)
        self._graphs[key] = g
        while len(self._graphs) > self.max_graphs:
            self._graphs.popitem(last=False)
        return g

    def _capture(self, params, cfg, token_cfg, settings, state, attend_limit, frame) -> _Graph:
        dev = state.pos.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream, current = self._stream, torch.cuda.current_stream(dev)
        seeds = StaticSeeds()

        def run(st):
            with seeds.hold():
                _, out = frame_in_place(params, cfg, token_cfg, settings, st, None,
                                        attend_limit=attend_limit, frame=frame)
            return _packed(out)

        scratch = map_decode_state(torch.zeros_like, state)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_FRAMES):
                run(scratch)
        current.wait_stream(stream)
        del scratch
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (the engine's fetchers) record events
        # and copy to the host while this one captures.
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            ints, flags = run(state)
        after = _launch_counts()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        return _Graph(graph, seeds, ints, flags, launches,
                      (params, state, cfg, token_cfg, frame))
