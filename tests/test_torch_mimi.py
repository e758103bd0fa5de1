"""PyTorch port, Mimi streaming decode: same-seed weights equal the JAX
package's draw for draw, and mimi_decode_step PCM is allclose (rtol 1e-4,
atol 1e-5) to JAX across ring flushes, with the kv8 ring on and off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.codec import mimi as jm
from smoltts_tpu.codec.config import MimiConfig as JaxMimiConfig
from smoltts_tpu.ops.quant import fuse_mimi_decode_params, quantize_mimi_params
from smoltts_torch.codec import mimi as tm
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.interop import params_from_jax_numpy, tree_map
from tests import torch_threads  # noqa: F401  (one intra-op thread)

TINY = dict(
    num_filters=8, upsampling_ratios=[4, 3, 2], hidden_size=32, num_hidden_layers=2,
    num_attention_heads=2, head_dim=16, intermediate_size=64, codebook_size=32,
    codebook_dim=16, num_quantizers=8, upsample_groups=32, frame_rate=500.0,
)


def test_init_mimi_params_equal_draws():
    jp = jm.init_mimi_params(JaxMimiConfig(**TINY), seed=1)
    tp = tm.init_mimi_params(MimiConfig(**TINY), seed=1, device="cpu")
    a = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jp))
    b = jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), tp))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "kv8"])
def test_stream_pcm_matches_jax_across_flush(kv8):
    jcfg, cfg = JaxMimiConfig(**TINY), MimiConfig(**TINY)
    jp = quantize_mimi_params(fuse_mimi_decode_params(jm.init_mimi_params(jcfg, seed=1)))
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, jp))
    B, steps, tail = 2, 9, 8
    codes = np.random.default_rng(0).integers(0, cfg.codebook_size, (B, cfg.num_quantizers, steps))
    js = jm.decode_stream_init(jcfg, B, tail_len=tail, kv_dtype=jnp.int8 if kv8 else None)
    ts = tm.decode_stream_init(cfg, B, tail_len=tail, kv_dtype=torch.int8 if kv8 else None,
                               device="cpu")
    for t in range(steps):
        if t and t % 3 == 0:  # 2 tokens per step, tail 8: flush before it wraps
            js, ts = jm.flush_mimi_state(js), tm.flush_mimi_state(ts)
        c = codes[:, :, t : t + 1]
        js, jpcm = jm.mimi_decode_step(jp, jcfg, js, jnp.asarray(c))
        ts, tpcm = tm.mimi_decode_step(tp, cfg, ts, torch.from_numpy(c))
        assert tuple(tpcm.shape) == (B, cfg.samples_per_frame, 1)
        np.testing.assert_allclose(tpcm.numpy(), np.asarray(jpcm), rtol=1e-4, atol=1e-5)
