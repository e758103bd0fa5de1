"""PyTorch port, `DecodeEngine.shard` (leader and followers on gloo ranks,
device="cpu") against the JAX package's single-device engine:
tests/test_parallel_serving.py::_run_engine's episode (6 streams on 4
slots, staggered budgets, a late submit, attend buckets [16, 64], chunk 2,
tails of 8) over 2 x 1 (data parallel) and 2 x 2 (with tensor parallelism):
each stream's codes equal and its PCM within rtol=atol=1e-5 (the tolerance
of tests/test_parallel_serving.py:163); and an `EngineLoop` on the leader
over 2 x 1 delivering each stream's frames, in order.

The ranks import the port alone (tests/torch_parallel_workers.py); JAX runs
in this process."""

import pickle

import jax
import numpy as np
import pytest

from smoltts_torch.parallel.launch import run_ranks
from tests import torch_parallel_workers as W
from tests.test_parallel_serving import _run_engine, _setup
from tests import torch_threads  # noqa: F401  (one intra-op thread)

SPAWN_TIMEOUT = 240.0
TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_parallel_serving.py:163


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    setup = _setup()
    frames, pcms = _run_engine(*setup)
    path = tmp_path_factory.mktemp("engine") / "weights.pkl"
    with open(path, "wb") as f:
        pickle.dump({"lm": jax.tree.map(np.asarray, setup[4]),
                     "mimi": jax.tree.map(np.asarray, setup[5])}, f)
    return str(path), frames, pcms


@pytest.mark.parametrize("n_data,n_model,loop", [(2, 1, False), (2, 2, False), (2, 1, True)],
                         ids=["dp2x1", "dp-tp2x2", "engine-loop-2x1"])
def test_sharded_engine_matches_jax_single_device(reference, n_data, n_model, loop):
    path, ref_frames, ref_pcms = reference
    outs = run_ranks(W.engine_rank, n_data * n_model, n_data, n_model, n_model > 1, path, loop,
                     timeout=SPAWN_TIMEOUT, device="cpu", threads=1)
    assert all(o is None for o in outs[1:])  # followers return nothing
    got = outs[0]
    assert sorted(got) == sorted(ref_frames) == list(range(6))
    for sid in ref_frames:
        codes, pcm = got[sid]
        np.testing.assert_array_equal(codes, np.asarray(ref_frames[sid]))
        np.testing.assert_allclose(pcm, np.asarray(ref_pcms[sid]), **TOL)
