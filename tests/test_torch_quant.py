"""PyTorch port, int8 quantization: bit-exact against smoltts_tpu/ops/quant.py
(power-of-two scales make every step exact), and the weight bridge keeps
QTensor leaves and fused keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.ops import quant as jq
from smoltts_torch.interop import params_from_jax_numpy, tree_map
from smoltts_torch.ops import quant as tq


def _pot_matrix(rng, shape, axis=-2):
    """int8-representable values with a per-column power-of-two amax."""
    ints = rng.integers(-127, 128, shape).astype(np.float32)
    idx = [slice(None)] * len(shape)
    idx[axis] = 0
    ints[tuple(idx)] = 127.0
    exps = rng.integers(-6, 2, tuple(1 if i == (axis % len(shape)) else s for i, s in enumerate(shape)))
    return ints * np.exp2(exps).astype(np.float32)


def test_quantize_q8_matches_jax_bit_exact():
    rng = np.random.default_rng(0)
    for w in (rng.standard_normal((3, 48, 40)).astype(np.float32), _pot_matrix(rng, (2, 32, 24))):
        jqt = jq.quantize_q8(jnp.asarray(w))
        tqt = tq.quantize_q8(torch.from_numpy(w))
        np.testing.assert_array_equal(np.asarray(jqt.q), tqt.q.numpy())
        np.testing.assert_array_equal(np.asarray(jqt.scale), tqt.scale.numpy())


def test_quantize_kv_power_of_two_exact():
    rng = np.random.default_rng(0)
    ints = rng.integers(-127, 128, (4, 6, 16)).astype(np.float32)
    ints[..., 0] = 127.0
    x = ints * 0.25
    q, s = tq.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(s.shape) == x.shape[:-1]
    np.testing.assert_array_equal((q.float() * s[..., None]).numpy(), x)
    x2 = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3
    jqv, jsv = jq.quantize_kv(jnp.asarray(x2))
    tqv, tsv = tq.quantize_kv(torch.from_numpy(x2))
    np.testing.assert_array_equal(np.asarray(jqv), tqv.numpy())
    np.testing.assert_array_equal(np.asarray(jsv), tsv.numpy())


def test_mm_power_of_two_exact():
    """(x @ q) * scale equals x @ dequantized weight bit for bit, and the
    port's mm equals the JAX package's."""
    rng = np.random.default_rng(1)
    w = _pot_matrix(rng, (32, 24))
    x = (rng.integers(-8, 9, (5, 32)) * 0.5).astype(np.float32)
    tqt = tq.quantize_q8(torch.from_numpy(w))
    got = tq.mm(torch.from_numpy(x), tqt)
    np.testing.assert_array_equal(got.numpy(), x @ w)
    ref = jq.mm(jnp.asarray(x), jq.quantize_q8(jnp.asarray(w)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        tq.mm(torch.from_numpy(x), tq.quantize_q8(torch.from_numpy(_pot_matrix(rng, (2, 32, 24)))))


def _fake_tree(rng):
    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    trunk = lambda: {"attention_norm": r(2, 16), "wqkv": r(2, 16, 32), "wo": r(2, 16, 16),
                     "w1": r(2, 16, 24), "w3": r(2, 16, 24), "w2": r(2, 24, 16)}
    return {"embeddings": r(10, 16), "layers": trunk(), "fast_layers": trunk(),
            "fast_output": r(4, 16, 8), "fast_project_in": {"kernel": r(16, 12), "bias": r(12)}}


def test_fuse_and_quantize_decode_params_match_jax():
    rng = np.random.default_rng(2)
    tree = _fake_tree(rng)
    jt = jq.quantize_decode_params(jq.fuse_decode_params(jax.tree.map(jnp.asarray, tree)))
    tt = tq.quantize_decode_params(tq.fuse_decode_params(tree_map(torch.from_numpy, tree)))
    bridged = params_from_jax_numpy(jax.tree.map(np.asarray, jt))
    assert "w13" in tt["layers"] and "w1" not in tt["layers"]
    assert isinstance(bridged["layers"]["w13"], tq.QTensor)
    flat_t = jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), tt))
    flat_b = jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), bridged))
    assert len(flat_t) == len(flat_b)
    for a, b in zip(flat_t, flat_b):
        np.testing.assert_array_equal(a, b)


def test_mimi_fuse_and_quantize_match_jax():
    rng = np.random.default_rng(3)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    layers = {k: r(2, 16, 16) for k in ("wq", "wk", "wv", "wo")}
    layers.update(fc1=r(2, 16, 32), fc2=r(2, 32, 16), ln1_w=r(2, 16))
    tree = {"decoder_transformer": {"layers": layers}}
    jt = jq.quantize_mimi_params(jq.fuse_mimi_decode_params(jax.tree.map(jnp.asarray, tree)))
    tt = tq.quantize_mimi_params(tq.fuse_mimi_decode_params(tree_map(torch.from_numpy, tree)))
    for key in ("wqkv", "wo", "fc1", "fc2"):
        np.testing.assert_array_equal(np.asarray(jt["decoder_transformer"]["layers"][key].q),
                                      tt["decoder_transformer"]["layers"][key].q.numpy())
        np.testing.assert_array_equal(np.asarray(jt["decoder_transformer"]["layers"][key].scale),
                                      tt["decoder_transformer"]["layers"][key].scale.numpy())


def test_bridge_carries_bf16_bits():
    x = jnp.asarray(np.random.default_rng(4).standard_normal((3, 5)), jnp.bfloat16)
    t = params_from_jax_numpy({"a": np.asarray(x)})["a"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))


def test_dequantize_matches_jax():
    w = np.random.default_rng(5).standard_normal((2, 16, 8)).astype(np.float32)
    ref = np.asarray(jq.dequantize(jq.quantize_q8(jnp.asarray(w)), jnp.float32))
    got = tq.dequantize(tq.quantize_q8(torch.from_numpy(w)), torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_module_containers_round_trip():
    """DualARDecoder / MimiDecoder register a tree's tensors (QTensor leaves
    and None entries included) and rebuild the same tree."""
    from smoltts_torch.codec.config import MimiConfig
    from smoltts_torch.codec.mimi import MimiDecoder, init_mimi_params
    from smoltts_torch.config import tiny_debug_config
    from smoltts_torch.models.dual_ar import DualARDecoder, init_params

    cfg = tiny_debug_config(codebook_size=32, vocab_size=352)
    params = tq.quantize_decode_params(tq.fuse_decode_params(init_params(cfg, device="cpu")))
    mimi = init_mimi_params(MimiConfig(num_filters=4, upsampling_ratios=[2, 2], hidden_size=8,
                                       num_hidden_layers=1, num_attention_heads=2, head_dim=4,
                                       intermediate_size=8, codebook_size=8, codebook_dim=4,
                                       num_quantizers=2, upsample_groups=8), device="cpu")
    for module_cls, tree in ((DualARDecoder, params), (MimiDecoder, mimi)):
        module = module_cls(tree)
        assert len(module.state_dict()) == len(jax.tree_util.tree_leaves(tree_map(lambda t: 0, tree)))
        rebuilt = module.to(torch.float64).tree()
        a = jax.tree_util.tree_leaves(tree_map(lambda t: t.double().numpy(), tree))
        b = jax.tree_util.tree_leaves(tree_map(lambda t: t.double().numpy(), rebuilt))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert isinstance(DualARDecoder(params).tree()["layers"]["w13"], tq.QTensor)
