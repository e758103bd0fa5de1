"""PyTorch port, mesh serving (smoltts_torch/parallel/serving.py) on gloo
ranks with device="cpu", against the JAX package's single-device run:

- tests/test_parallel_serving.py::_run (prefill + 3 stream steps, B=8, T=6,
  S=64, tails of 8, greedy f32) over 2 x 1 (data parallel), 1 x 2 and
  2 x 2 (tensor parallel): codes equal, PCM within rtol=atol=1e-5, the
  tolerance that test holds the JAX mesh run to; sampled on 2 x 2, the
  model-axis ranks draw the same tokens;
- tests/test_tp_scale.py::test_backbone_sharded_150m_decode_matches_replicated
  at 150M widths and heads (12 query over 4 kv heads), TP 4 with the tables
  split: codes equal. Its depth is cut to 2 slow layers and 1 fast layer to
  keep the test cheap; the widths, heads and splits are the released ones.
  The same on the tiny config with an untied head, whose vocab-split
  logits are gathered over the model axis.

The ranks import the port alone (tests/torch_parallel_workers.py); JAX runs
in this process."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smoltts_tpu.lm.decode import decode_frame as jax_decode_frame
from smoltts_tpu.lm.decode import init_decode_state as jax_init_state
from smoltts_tpu.lm.decode import prefill as jax_prefill
from smoltts_tpu.lm.samplers import GenerationSettings as JaxSettings
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.tokenizer import TokenConfig as JaxTokenConfig
from smoltts_torch.parallel.launch import run_ranks
from tests import torch_parallel_workers as W
from tests.test_parallel_serving import _run, _setup
from tests import torch_threads  # noqa: F401  (one intra-op thread)

SPAWN_TIMEOUT = 180.0
TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_parallel_serving.py:87


def _dump(path, **trees):
    with open(path, "wb") as f:
        pickle.dump({k: jax.tree.map(np.asarray, v) for k, v in trees.items()}, f)
    return str(path)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    setup = _setup()
    frames, pcm = _run(*setup)
    path = _dump(tmp_path_factory.mktemp("tiny") / "weights.pkl", lm=setup[4], mimi=setup[5])
    return path, frames, pcm


def _by_data(outs, key):
    """The model-0 ranks' `key`, concatenated over the data axis on the slot
    axis (axis 1 of frames and PCM); every model rank equal to its row's."""
    rows = {}
    for o in outs:
        d, m = o["coords"]
        rows.setdefault(d, {})[m] = o[key]
    for d, ranks in rows.items():
        for m, got in ranks.items():
            assert got.tobytes() == ranks[0].tobytes(), f"{key}: rank ({d}, {m}) != ({d}, 0)"
    return np.concatenate([rows[d][0] for d in sorted(rows)], axis=1)


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2), (2, 2)],
                         ids=["dp2x1", "tp1x2", "dp-tp2x2"])
def test_sharded_pipeline_matches_jax_single_device(tiny, n_data, n_model):
    path, ref_frames, ref_pcm = tiny
    tp = n_model > 1
    outs = run_ranks(W.pipeline_rank, n_data * n_model, n_data, n_model, tp, path,
                     timeout=SPAWN_TIMEOUT, device="cpu", threads=1)
    for o in outs:
        assert o["slots"] == 8 // n_data
        assert o["kv_heads"] == 1  # tiny: 1 kv head, held whole by both model ranks
    np.testing.assert_array_equal(_by_data(outs, "frames"), ref_frames)
    pcm = _by_data([{**o, "pcm": o["pcm"][None]} for o in outs], "pcm")[0]
    np.testing.assert_allclose(pcm, ref_pcm, **TOL)


def test_sharded_sampling_agrees_across_the_model_axis(tiny):
    path = tiny[0]
    sampled = dict(default_temp=0.9, default_fast_temp=0.9, min_p=0.05)
    outs = run_ranks(W.pipeline_rank, 4, 2, 2, True, path, sampled,
                     timeout=SPAWN_TIMEOUT, device="cpu", threads=1)
    for key in ("frames", "slow", "pcm"):
        _by_data(outs, key)  # each model rank == its row's model-0 rank, bit for bit
    a, b = (o["frames"] for o in outs if o["coords"][1] == 0)
    assert a.shape == b.shape and not np.array_equal(a, b)  # data rows draw apart


@pytest.mark.parametrize("preset,n_model,cut", [
    # 150M widths and heads, depth cut to 2 slow layers and 1 fast layer
    ("smoltts_byte_150m", 4, dict(n_layer=2, n_fast_layer=1, dropout=0.0,
                                  use_gradient_checkpointing=False)),
    # an untied, vocab-split token head: the logits gathered over the model axis
    ("tiny_debug_config", 2, dict(codebook_size=32, vocab_size=352, tie_word_embeddings=False)),
], ids=["150m-tp4", "tiny-untied-tp2"])
def test_tensor_parallel_decode_matches_jax(tmp_path, preset, n_model, cut):
    from smoltts_tpu import config as jconfig

    cfg = getattr(jconfig, preset)().model_copy(update=cut)
    token_cfg = JaxTokenConfig.smoltts_v0()
    settings = JaxSettings(default_temp=0.0, default_fast_temp=0.0)
    params = jax_init(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    B, T, S = 2, 8, 64
    rng = np.random.default_rng(0)
    prompt = np.zeros((B, cfg.num_rows, T), np.int32)
    codes0 = rng.integers(0, cfg.codebook_size, (B, T))
    prompt[:, 0] = token_cfg.semantic_start_id + codes0
    prompt[:, 1] = codes0
    prompt[:, 2:] = rng.integers(0, cfg.codebook_size, (B, cfg.num_rows - 2, T))

    state = jax_init_state(cfg, B, S, dtype=jnp.float32, tail_len=8)
    state, out = jax_prefill(params, cfg, token_cfg, settings, state, jnp.asarray(prompt),
                             jnp.full((B,), T, jnp.int32), jax.random.PRNGKey(1))
    ref = [np.asarray(out.tokens)]
    for i in range(2):
        state, out = jax_decode_frame(params=params, cfg=cfg, token_cfg=token_cfg,
                                      settings=settings, state=state,
                                      rng=jax.random.PRNGKey(2 + i))
        ref.append(np.asarray(out.tokens))

    path = _dump(tmp_path / "weights.pkl", lm=params)
    del params
    outs = run_ranks(W.backbone_rank, n_model, n_model, path, prompt, preset, cut,
                     timeout=SPAWN_TIMEOUT, device="cpu", threads=2)
    rows = cfg.codebook_size * cfg.num_codebooks // n_model
    for o in outs:  # the big tensors really are split
        assert o["widths"]["codebook_embeddings"] == (rows, cfg.dim)
        if not cfg.tie_word_embeddings:
            assert o["widths"]["output"] == (cfg.dim, cfg.vocab_size // n_model)
        assert o["w1"] == cfg.intermediate_size // n_model
        np.testing.assert_array_equal(o["frames"], np.stack(ref))
