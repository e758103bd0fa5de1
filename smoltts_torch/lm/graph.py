"""The LM frame over a decode state that stays in place, replayed as a CUDA
graph on the card (utils/graphs.py).

`decode_frame` issues the slow trunk's products and glue, K2 in every
layer, K3 and K1: hundreds of launches a frame. Its state is stepped in
place: every leaf keeps its storage across frames, flushes (`flush_kv`),
resets (`reset_decode_state`) and the engine's admissions and freed slots
(`scatter_decode_state`, `index_fill_`).

- `frame_in_place`: `decode_frame`, then each leaf it renewed
  (lm/decode.py `RENEWED_LEAVES`) copied into the given state's leaf. The
  CPU path, and any state stepped without graphs.
- `LMFrameGraphs`: on CUDA, one graph per (parameters, the state's leaves,
  attend limit, sampling settings), captured on first use and replayed
  after. A graph holds the state and parameters it captured, so their
  addresses stay theirs. It replays the eager frame's kernels; K1's and
  K3's Philox seeds are its static inputs (`ops/sampling.py::StaticSeeds`),
  drawn before each replay by the eager calls in the eager order, so a
  sampled replay equals the eager frame draw for draw. The frame's outputs
  come back as two fresh tensors (the int32 tokens and codes, the bool
  flags) viewed as a `FrameOutput`. A frame that reduces over a mesh
  (collectives go through the host) or samples its codebook levels from
  the generator in plain PyTorch (a tree K1 does not take, at a fast
  temperature above 0) stays eager.

Spans: `lm.capture` and `lm.replay` (utils/graphs.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from smoltts_torch import ops
from smoltts_torch.lm.decode import RENEWED_LEAVES, DecodeState, FrameOutput, decode_frame
from smoltts_torch.ops import attention as attn_ops
from smoltts_torch.ops.fast_loop import supports_fused_fast
from smoltts_torch.ops.sampling import StaticSeeds
from smoltts_torch.utils.graphs import GraphCache, copy_back


def keep_in_place(state: DecodeState, new: DecodeState) -> DecodeState:
    """Copy each renewed leaf of `new` that is not `state`'s own into
    `state`'s; returns `state`, now holding `new`'s values."""
    copy_back([getattr(state, n) for n in RENEWED_LEAVES],
              [getattr(new, n) for n in RENEWED_LEAVES])
    return state


def frame_in_place(params, cfg, token_cfg, settings, state: DecodeState, generator,
                   attend_limit: Optional[int] = None, mesh=None):
    """`decode_frame`, then its renewed leaves copied into `state`: ->
    (state, FrameOutput), `state` advanced."""
    new, out = decode_frame(params, cfg, token_cfg, settings, state, generator,
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
    replay: object  # -> the static outputs (`_packed`)
    seeds: StaticSeeds  # the static inputs
    launches: dict  # the kernel launches a frame makes, by counter
    held: tuple  # (params, state, ...): the graph reads and writes their addresses


def _key(params, cfg, token_cfg, settings, state: DecodeState, attend_limit) -> tuple:
    leaves = tuple(None if t is None else (t.data_ptr(), t.shape, t.stride(), t.dtype)
                   for t in state)
    sampling = (settings.default_temp, settings.default_fast_temp, settings.min_p,
                settings.audio_only_constraint)
    return (id(params), id(cfg), id(token_cfg), attend_limit, sampling) + leaves


class LMFrameGraphs:
    """The LM frame of `frame_in_place`, replayed as CUDA graphs: call it as
    `frame_in_place` is called. Not for concurrent use from two threads."""

    def __init__(self, max_graphs: int = 4):
        self._graphs = GraphCache("lm", max_graphs)

    @staticmethod
    def graphed(params, cfg, settings, state: DecodeState, mesh=None) -> bool:
        """Whether a frame replays a graph: on CUDA, without a mesh, and
        with every random draw through `philox_seed`."""
        fast_temp = settings.default_fast_temp
        return (state.pos.device.type == "cuda" and mesh is None
                and (fast_temp is None or fast_temp <= 0 or supports_fused_fast(cfg, params)))

    @torch.no_grad()
    def __call__(self, params, cfg, token_cfg, settings, state: DecodeState, generator,
                 attend_limit: Optional[int] = None, mesh=None):
        if not self.graphed(params, cfg, settings, state, mesh):
            return frame_in_place(params, cfg, token_cfg, settings, state, generator,
                                  attend_limit=attend_limit, mesh=mesh)
        g = self._get(params, cfg, token_cfg, settings, state, attend_limit)
        g.seeds.draw(generator)
        ints, flags = self._graphs.replay(g.replay)
        _add_launches(g.launches)
        return state, _unpacked(ints.clone(), flags.clone(), cfg.num_rows)

    @torch.no_grad()
    def capture(self, params, cfg, token_cfg, settings, state: DecodeState,
                attend_limit: Optional[int] = None, mesh=None) -> None:
        """Capture the graph for these arguments unless it is held. `state`
        is not advanced (a capture runs nothing) and no seed is drawn."""
        if self.graphed(params, cfg, settings, state, mesh):
            self._get(params, cfg, token_cfg, settings, state, attend_limit)

    def _get(self, params, cfg, token_cfg, settings, state, attend_limit) -> _Graph:
        return self._graphs.get(
            _key(params, cfg, token_cfg, settings, state, attend_limit),
            lambda: self._capture(params, cfg, token_cfg, settings, state, attend_limit))

    def _capture(self, params, cfg, token_cfg, settings, state, attend_limit) -> _Graph:
        seeds, passes = StaticSeeds(), []

        def body(st):
            passes.append(None)
            with seeds.hold():
                _, out = frame_in_place(params, cfg, token_cfg, settings, st, None,
                                        attend_limit=attend_limit)
            return _packed(out)

        before = _launch_counts()
        replay = self._graphs.capture(body, state, map_decode_state, state.pos.device)
        after = _launch_counts()
        # Every pass, the warm-ups' and the recorded one, issues the same
        # launches: the host's path does not depend on the state's values.
        launches = {k: (after[k] - before[k]) // len(passes)
                    for k in after if after[k] != before[k]}
        return _Graph(replay, seeds, launches, (params, state, cfg, token_cfg))
