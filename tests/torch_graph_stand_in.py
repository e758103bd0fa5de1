"""A stand-in for the CUDA graph recorder (`smoltts_torch/utils/graphs.py`
`GraphCache.record`), so that the graph caches under the LM frame and the
vocoder step run on the CPU: it runs the warm-up passes, and its replay
re-runs the recorded body and copies what it returns into the outputs of the
first replay, which it returns each time, as a graph's replay rewrites its
static outputs. A graph's replay runs no kernel wrapper, so the stand-in's
counts no launch."""

import contextlib

import pytest
import torch

from smoltts_torch import ops
from smoltts_torch.codec.graph import VocoderGraphs
from smoltts_torch.lm.graph import LMFrameGraphs
from smoltts_torch.ops import attention as attn_ops
from smoltts_torch.utils import graphs


def _tensors(x):
    return (x,) if isinstance(x, torch.Tensor) else tuple(x)


class StandIn:
    """`GraphCache.record(cache, warm, fn, device) -> replay`; `records`
    counts the graphs it recorded."""

    def __init__(self):
        self.records = 0

    def __call__(self, cache, warm, fn, device):
        self.records += 1
        warm()
        static = []

        def replay():
            counts = dict(ops.LAUNCHES), dict(attn_ops.ROUTE_LAUNCHES)
            got = fn()
            ops.LAUNCHES.update(counts[0])
            attn_ops.ROUTE_LAUNCHES.update(counts[1])
            if not static:
                static.append(got)
            for held, new in zip(_tensors(static[0]), _tensors(got)):
                held.copy_(new)
            return static[0]

        return replay


@contextlib.contextmanager
def stand_in_graphs():
    """Within: every graph cache records with a `StandIn` (yielded), and
    `LMFrameGraphs` and `VocoderGraphs` replay graphs on the CPU."""
    recorder = StandIn()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs.GraphCache, "record",
                   lambda cache, warm, fn, device: recorder(cache, warm, fn, device))
        mp.setattr(LMFrameGraphs, "graphed", staticmethod(lambda *a, **k: True))
        mp.setattr(VocoderGraphs, "graphed", staticmethod(lambda *a, **k: True))
        yield recorder
