"""CUDA graphs over state that stays in place: the cache under the LM frame
(lm/graph.py) and the vocoder step (codec/graph.py).

A step over a state of many small tensors issues hundreds of launches that
cost the host far more time than the card's work; a graph replays them in
one launch. A graph replays fixed addresses, so its body steps the state in
place: every leaf keeps its storage, and a leaf the body computes anew is
copied back into the held one (`copy_back`).

- `GraphCache`: the captured graphs under keys the caller makes, a few at
  most, the least recently used dropped first. A capture runs `WARMUP`
  eager passes of the body on a zeroed scratch copy of the state, so that
  cuBLAS and cuDNN make their handles, workspaces and plans on the capture
  stream; then it records one pass over the live state, which it does not
  advance.
- `GraphCache.record`: the capture stream (made at the first capture), the
  warm-up on it and the recording: the only CUDA code here, and the seam a
  test replaces to run a cache on the CPU.

Spans (utils/profiling.py `SPANS`): `<name>.capture` around each capture
(its warm-up passes included), `<name>.replay` around each replay.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable

import torch

from smoltts_torch.utils.profiling import SPANS

WARMUP = 2


def copy_back(held: Iterable[torch.Tensor], new: Iterable[torch.Tensor]) -> None:
    """Copy each leaf of `new` that is not the held leaf in its place into
    that leaf."""
    for old, leaf in zip(held, new):
        if leaf is not old:
            old.copy_(leaf)


class GraphCache:
    """The graphs of one step, held by key; spans named `name`. Not for
    concurrent use from two threads."""

    def __init__(self, name: str, max_graphs: int):
        self.name = name
        self.max_graphs = max(1, int(max_graphs))
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._stream = None  # the capture stream, made at the first capture

    def __len__(self) -> int:
        return len(self._graphs)

    def get(self, key, make: Callable[[], object]):
        """The entry held under `key`, now the most recently used, else
        `make()`'s (which captures), held from now on."""
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            return entry
        with SPANS.span(f"{self.name}.capture"):
            entry = self._graphs[key] = make()
        while len(self._graphs) > self.max_graphs:
            self._graphs.popitem(last=False)
        return entry

    def capture(self, body, state, map_state, device: torch.device):
        """`body(state)` recorded -> its replay (see `record`), after the
        warm-up passes of `body` on `map_state(torch.zeros_like, state)`.
        `state` is not advanced."""

        def warm():
            scratch = map_state(torch.zeros_like, state)
            for _ in range(WARMUP):
                body(scratch)

        return self.record(warm, lambda: body(state), device)

    def record(self, warm: Callable[[], None], fn: Callable[[], object],
               device: torch.device) -> Callable[[], object]:
        """`warm()` run, then `fn()` recorded as a CUDA graph, both on the
        capture stream -> the replay, which runs the graph and returns what
        `fn` returned: the same tensors each time, rewritten by each replay."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream, current = self._stream, torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            warm()
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads (the engine's fetchers) record events and
        # copy to the host while this one captures.
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            outputs = fn()

        def replay():
            graph.replay()
            return outputs

        return replay

    def replay(self, replay: Callable[[], object]):
        """`replay()` under the replay span -> the graph's outputs."""
        with SPANS.span(f"{self.name}.replay"):
            return replay()
