"""PyTorch port, decode attention: the plain versions (which the CPU
dispatch takes) against the JAX package's XLA reference and its Pallas
kernel in interpret mode, with bf16/f32 and kv8 histories. Tolerance
rtol = atol = 1e-5 in f32 (summation order is the only difference)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from smoltts_tpu.ops.attention import (
    decode_attention_pallas,
    decode_attention_tailed as jax_tailed,
    decode_attention_xla,
)
from smoltts_tpu.ops.quant import quantize_kv as jax_quantize_kv
from smoltts_torch.interop import params_from_jax_numpy
from smoltts_torch.ops.attention import (
    decode_attention,
    decode_attention_plain,
    decode_attention_tailed,
    decode_attention_tailed_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return params_from_jax_numpy({"x": np.asarray(a)})["x"]


@pytest.mark.parametrize("B,H,n_kv,S,hd", [(2, 8, 4, 64, 64), (3, 12, 4, 128, 64), (1, 8, 8, 32, 64)])
def test_contiguous_matches_xla_and_pallas(B, H, n_kv, S, hd):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    pos = rng.integers(0, S, (B,)).astype(np.int32)
    ref = np.asarray(decode_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)))
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(decode_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)))
    got = decode_attention_plain(_t(q), _t(k), _t(v), _t(pos)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pal, **TOL)
    # the CPU dispatch is the plain version
    np.testing.assert_array_equal(decode_attention(_t(q), _t(k), _t(v), _t(pos)).numpy(), got)


def test_pos_zero_attends_only_first():
    B, H, n_kv, S, hd = 1, 4, 2, 16, 64
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    pos = np.zeros((B,), np.int32)
    got = decode_attention_plain(_t(q), _t(k), _t(v), _t(pos)).numpy()
    expect = np.broadcast_to(v[:, :, 0].reshape(B, n_kv, 1, hd), (B, n_kv, H // n_kv, hd))
    np.testing.assert_allclose(got, expect.reshape(B, H * hd), **TOL)


def test_contiguous_bf16_matches_xla():
    rng = np.random.default_rng(1)
    B, H, n_kv, S, hd = 2, 12, 4, 64, 64
    arrs = [jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
            for s in ((B, H, hd), (B, n_kv, S, hd), (B, n_kv, S, hd))]
    pos = np.asarray([5, 63], np.int32)
    ref = np.asarray(decode_attention_xla(*arrs, jnp.asarray(pos)), np.float32)
    q, k, v = (_t(a) for a in arrs)
    got = decode_attention_plain(q, k, v, _t(pos)).float().numpy()
    # bf16 output: one bf16 ulp at the outputs' magnitude
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


def _tailed_case(seed, kv8, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    B, H, n_kv, Sh, W, hd = 3, 12, 4, 48, 8, 64
    q = rng.standard_normal((B, H, hd))
    kh = rng.standard_normal((B, n_kv, Sh, hd)).astype(np.float32)
    vh = rng.standard_normal((B, n_kv, Sh, hd)).astype(np.float32)
    kt = rng.standard_normal((B, n_kv, W, hd))
    vt = rng.standard_normal((B, n_kv, W, hd))
    flushed = np.asarray([10, 0, 40], np.int32)
    pos = np.asarray([14, 3, 40], np.int32)
    tail_pos = np.full((B, W), -1, np.int32)
    for b in range(B):
        n_new = pos[b] - flushed[b] + 1
        tail_pos[b, :n_new] = np.arange(flushed[b], pos[b] + 1)
    tail_pos[0, 6] = 2  # stale column below flushed: masked out
    jargs = dict(q=jnp.asarray(q, dtype), k_tail=jnp.asarray(kt, dtype), v_tail=jnp.asarray(vt, dtype),
                 pos=jnp.asarray(pos), flushed=jnp.asarray(flushed), tail_pos=jnp.asarray(tail_pos))
    if kv8:
        kq, ks = jax_quantize_kv(jnp.asarray(kh))
        vq, vs = jax_quantize_kv(jnp.asarray(vh))
        jargs.update(k_hist=kq, v_hist=vq, k_scale=ks, v_scale=vs)
    else:
        jargs.update(k_hist=jnp.asarray(kh, dtype), v_hist=jnp.asarray(vh, dtype))
    targs = {k: _t(v) for k, v in jargs.items()}
    return jargs, targs


@pytest.mark.parametrize("kv8", [False, True])
def test_tailed_matches_jax(kv8):
    jargs, targs = _tailed_case(3, kv8)
    ref = np.asarray(jax_tailed(**jargs))
    got = decode_attention_tailed_plain(**targs).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(decode_attention_tailed(**targs).numpy(), got)


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16_history", "kv8_history"])
def test_tailed_bf16_matches_jax(kv8):
    """The main path's dtypes: bf16 q and tail, bf16 or int8 history. Both
    sides round the probabilities and the two partial outputs to bf16, so
    the tolerance is a bf16 ulp at the outputs' magnitude."""
    jargs, targs = _tailed_case(6, kv8, dtype=jnp.bfloat16)
    ref = np.asarray(jax_tailed(**jargs), np.float32)
    got = decode_attention_tailed_plain(**targs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2, atol=2e-2)


def test_tailed_history_view_matches_contiguous():
    """A strided `k[:, :, :lim]` view gives the same answer as a copy (the
    attend-limit slice the decode step passes)."""
    jargs, targs = _tailed_case(4, True)
    lim = 44
    sliced = dict(targs)
    for key in ("k_hist", "v_hist", "k_scale", "v_scale"):
        sliced[key] = targs[key][:, :, :lim]
    copied = {k: (v.contiguous() if torch.is_tensor(v) else v) for k, v in sliced.items()}
    a = decode_attention_tailed_plain(**sliced).numpy()
    b = decode_attention_tailed_plain(**copied).numpy()
    np.testing.assert_array_equal(a, b)
    jsl = dict(jargs)
    for key in ("k_hist", "v_hist", "k_scale", "v_scale"):
        jsl[key] = jargs[key][:, :, :lim]
    np.testing.assert_allclose(a, np.asarray(jax_tailed(**jsl)), **TOL)
