"""PyTorch port, the CUDA-graph cache under the LM frame and the vocoder step
(utils/graphs.py) on the CPU, with the stand-in recorder: a capture's
warm-up passes step a zeroed copy of the state and never the live state,
which only a replay advances."""

import torch

from smoltts_torch.utils.graphs import WARMUP, GraphCache
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.torch_graph_stand_in import stand_in_graphs


def test_the_warm_up_passes_step_a_zeroed_copy_and_never_the_live_state():
    state = [torch.arange(1.0, 5.0), torch.full((2, 3), 7, dtype=torch.int32)]
    live, ptrs = [t.clone() for t in state], [t.data_ptr() for t in state]
    passes = []

    def body(st):
        passes.append(([t.data_ptr() for t in st], [t.clone() for t in st]))
        for t in st:
            t.add_(1)
        return st[0] * 2

    with stand_in_graphs() as recorder:
        replay = GraphCache("test", 1).capture(body, state, lambda fn, s: [fn(t) for t in s],
                                                torch.device("cpu"))
        assert recorder.records == 1 and len(passes) == WARMUP
        for t, want in zip(state, live):
            assert torch.equal(t, want)  # a capture does not advance the state
        for i, (seen, values) in enumerate(passes):
            assert not set(seen) & set(ptrs)
            assert all(torch.equal(v, torch.full_like(v, i)) for v in values)
        out = replay()
        assert [t.data_ptr() for t in state] == ptrs
        assert torch.equal(state[0], live[0] + 1) and torch.equal(state[1], live[1] + 1)
        assert torch.equal(out, (live[0] + 1) * 2)

