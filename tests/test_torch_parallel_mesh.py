"""PyTorch port, the parallel layer's specs, slicing and collectives
(smoltts_torch/parallel/mesh.py): `param_partition_specs` equals the JAX
package's leaf for leaf; the 150M tree's specs partition every large tensor
(the counterpart of tests/test_tp_scale.py); `shard_params` at every
coordinate of a 2 x 2 mesh puts back together into the tree, bit for bit
(through the package's `assemble_leaf`);
and on four gloo ranks (device="cpu"), `make_mesh` / `make_multihost_mesh`
refuse what JAX refuses, and the collectives give every rank the same bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from smoltts_tpu.config import smoltts_byte_150m as jax_150m
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.ops import quant as jq
from smoltts_tpu.parallel import mesh as jmesh
from smoltts_torch.config import smoltts_byte_150m, tiny_debug_config
from smoltts_torch.models.dual_ar import init_params
from smoltts_torch.ops.quant import QTensor, fuse_decode_params, quantize_decode_params
from smoltts_torch.parallel.launch import run_ranks
from smoltts_torch.parallel.mesh import (
    MODEL_AXIS,
    Mesh,
    assemble_leaf,
    head_range,
    param_partition_specs,
    shard_params,
)
from tests import torch_parallel_workers as W
from tests import torch_threads  # noqa: F401  (one intra-op thread)

SPAWN_TIMEOUT = 120.0


def _named(tree, prefix=""):
    """(path, leaf) pairs; a QTensor (or a spec tuple) is one leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _meta(tree):
    """A JAX shape tree as meta tensors (QTensor leaves kept)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if getattr(tree, "_fields", None) == ("q", "scale"):
        return QTensor(q=_meta(tree.q), scale=_meta(tree.scale))
    return torch.empty(tree.shape, device="meta")


def _jax_150m_shapes(int8: bool):
    cfg = jax_150m()

    def build(key):
        p = jax_init(cfg, key, dtype=jnp.bfloat16)
        return jq.quantize_decode_params(jq.fuse_decode_params(p)) if int8 else p

    return jax.eval_shape(build, jax.random.PRNGKey(0))


@pytest.mark.parametrize("shard_tables,int8", [(False, False), (True, False), (True, True)],
                         ids=["plain", "tables", "fused-int8"])
def test_param_partition_specs_equal_jax_leaf_for_leaf(shard_tables, int8):
    shapes = _jax_150m_shapes(int8)
    jspecs = jmesh.param_partition_specs(shapes, shard_tables=shard_tables)
    want = dict(_named(jax.tree.map(tuple, jspecs, is_leaf=lambda x: isinstance(x, P))))
    got = dict(_named(param_partition_specs(_meta(shapes), shard_tables=shard_tables)))
    assert got == want


def test_150m_specs_partition_every_large_tensor():
    """tests/test_tp_scale.py::test_150m_shardings_partition_every_large_tensor
    on the port's specs and the port's 150M shapes (bf16 bytes)."""
    budget, n_model = 4 * 2**20, 4
    shapes = _meta(_jax_150m_shapes(False))
    assert {n: tuple(t.shape) for n, t in _named(shapes)} == {
        n: tuple(t.shape) for n, t in _named(init_params(
            smoltts_byte_150m(), dtype=torch.bfloat16, device="meta"))}
    specs = dict(_named(param_partition_specs(shapes, shard_tables=True)))
    big = []
    for name, leaf in _named(shapes):
        if leaf.numel() * 2 <= budget:
            continue
        big.append(name)
        dims = [i for i, a in enumerate(specs[name]) if a == MODEL_AXIS]
        assert dims, f"{name} is {leaf.numel() * 2 / 2**20:.1f} MB but replicated"
        assert leaf.shape[dims[0]] % n_model == 0, name
    for expect in ["layers.wqkv", "layers.wo", "layers.w1", "layers.w2", "layers.w3",
                   "fast_layers.wqkv", "fast_output", "codebook_embeddings", "fast_embeddings"]:
        assert any(n.startswith(expect) for n in big), (expect, big)


def _tree(kind):
    if kind == "gqa-shared":  # 2 query heads over 1 kv head: both ranks hold it
        cfg = tiny_debug_config(codebook_size=32, vocab_size=352)
    else:
        cfg = tiny_debug_config(codebook_size=32, vocab_size=352, n_head=4, n_local_heads=2,
                                fast_n_head=4, fast_n_local_heads=2, attention_qkv_bias=True,
                                tie_word_embeddings=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    if "wqkv_bias" in params["layers"]:  # zeros at init; make the split visible
        params["layers"]["wqkv_bias"] = torch.randn(params["layers"]["wqkv_bias"].shape)
    if kind == "fused-int8":
        params = quantize_decode_params(fuse_decode_params(params))
    return cfg, params


def _assemble(name, spec, parts, heads):
    """The package's assemble_leaf, each kv head that several ranks share
    checked to be the same bits on every holder first."""
    if name in ("wqkv", "wqkv_bias"):
        n_head, n_kv, hd = heads
        axis, seen = spec.index(MODEL_AXIS), {}
        for m, t in enumerate(parts):
            q0, q1, kv0, kv1 = head_range(n_head, n_kv, len(parts), m)
            kv = t.narrow(axis, (q1 - q0) * hd, 2 * (kv1 - kv0) * hd)
            assert torch.equal(seen.setdefault((kv0, kv1), kv), kv)
    return assemble_leaf(name, spec, parts, heads)


@pytest.mark.parametrize("kind", ["plain", "fused-int8", "gqa-shared"])
def test_shard_params_put_back_together_bit_for_bit(kind):
    cfg, params = _tree(kind)
    specs = dict(_named(param_partition_specs(params, shard_tables=True)))
    whole = dict(_named(params))
    local = {(d, m): dict(_named(shard_params(params, Mesh(2, 2, d, m), shard_tables=True,
                                              cfg=cfg)))
             for d in range(2) for m in range(2)}
    heads = {"layers": (cfg.n_head, cfg.n_local_heads, cfg.head_dim),
             "fast_layers": (cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim)}
    split = 0
    for name, w in whole.items():
        spec, leaf = specs[name], name.split(".")[-1]
        for m in range(2):  # the data axis never splits a parameter
            a, b = local[(0, m)][name], local[(1, m)][name]
            assert all(torch.equal(x, y) for x, y in zip(
                a if isinstance(a, QTensor) else [a], b if isinstance(b, QTensor) else [b]))
        parts = [local[(0, m)][name] for m in range(2)]
        if MODEL_AXIS not in spec:
            assert all(p is w or torch.equal(p, w) for p in parts), name
            continue
        split += 1
        h = heads.get(name.split(".")[0])
        if isinstance(w, QTensor):
            assert torch.equal(_assemble(leaf, spec, [p.q for p in parts], h), w.q), name
            axis = spec.index(MODEL_AXIS)
            if w.scale.shape[axis] == 1:  # a row split keeps the per-column scale whole
                assert all(torch.equal(p.scale, w.scale) for p in parts), name
            else:
                assert torch.equal(_assemble(leaf, spec, [p.scale for p in parts], h),
                                   w.scale), name
            assert all(p.q.is_contiguous() and p.scale.is_contiguous() for p in parts)
        else:
            assert torch.equal(_assemble(leaf, spec, parts, h), w), name
            assert all(p.is_contiguous() and p.numel() < w.numel() for p in parts), name
    assert split >= 10


def test_head_ranges_refuse_what_cannot_split():
    assert head_range(12, 4, 4, 3) == (9, 12, 3, 4)  # 150M at TP 4: 3 q heads over 1 kv
    assert head_range(9, 3, 3, 1) == (3, 6, 1, 2)  # 70M at TP 3
    assert head_range(2, 1, 2, 1) == (1, 2, 0, 1)  # tiny at TP 2: the kv head shared
    with pytest.raises(ValueError, match="12 query heads"):
        head_range(12, 4, 5, 0)
    with pytest.raises(ValueError, match="6 kv heads"):
        head_range(12, 6, 4, 0)


def test_meshes_and_collectives_on_four_ranks():
    with pytest.raises(AssertionError, match=r"mesh 3x1 != 4 devices"):
        jmesh.make_mesh(3, 1, devices=jax.devices()[:4])
    outs = run_ranks(W.mesh_rank, 4, timeout=SPAWN_TIMEOUT, device="cpu", threads=1)
    multihost = ("model axis 4 must divide the 2 local devices: TP collectives must not "
                 "cross DCN")
    for r, o in enumerate(outs):
        assert o["refusals"] == {"3x1": "mesh 3x1 != 4 devices",
                                 "-1x3": "mesh 1x3 != 4 devices", "multihost 4": multihost}
        assert o["coords"] == divmod(r, 2)  # row-major: hosts outermost, model within a host
        assert o["plan"]["rank"] == 0 and list(o["plan"]["arr"]) == [0, 1, 2]
    for m in range(2):
        col = [outs[d * 2 + m] for d in range(2)]  # one data group
        for i, want in enumerate(col[0]["parts"]):
            if want is None:
                assert all(o["data_gathered"][i] is None for o in col)
                continue
            full = np.concatenate([o["parts"][i] for o in col])
            for o in col:  # the same bits on every rank, -0.0 and NaN included
                got = o["data_gathered"][i]
                assert got.dtype == full.dtype and got.tobytes() == full.tobytes()
        assert col[0]["chunk"].shape == (2, 6, 4)
        assert col[0]["chunk"].tobytes() == col[1]["chunk"].tobytes()
    for d in range(2):
        row = outs[2 * d : 2 * d + 2]
        want = (np.full(4, 2 * d + 1, np.float32) / 3 + np.full(4, 2 * d + 2, np.float32) / 3)
        for o in row:
            np.testing.assert_allclose(o["summed"], want, rtol=1e-6)
            assert o["summed"].tobytes() == row[0]["summed"].tobytes()
            np.testing.assert_array_equal(
                o["logits"], np.concatenate([np.arange(6.0).reshape(2, 3),
                                             np.arange(6.0).reshape(2, 3) + 10], -1))


def test_fast_loop_refuses_a_split_fast_trunk():
    """K1 has no collective inside: under the training specs (fast trunk
    split) the fast loop raises; the serving layout keeps it whole."""
    from smoltts_torch.lm.samplers import GenerationSettings
    from smoltts_torch.ops.fast_loop import fast_micro_loop_plain, fused_fast_micro_loop
    from smoltts_torch.parallel.mesh import shard_by_specs
    from smoltts_torch.parallel.serving import serving_partition_specs

    cfg, params = _tree("gqa-shared")
    params = quantize_decode_params(fuse_decode_params(params))
    hidden = torch.randn((2, cfg.dim), generator=torch.Generator().manual_seed(0))
    greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
    split = shard_params(params, Mesh(1, 2, 0, 1), cfg=cfg)
    for loop in (fast_micro_loop_plain, fused_fast_micro_loop):
        with pytest.raises(ValueError, match="must be whole on every rank"):
            loop(split, cfg, hidden, None, greedy)
    served = shard_by_specs(params, serving_partition_specs(params), Mesh(1, 2, 0, 1), cfg)
    assert served["layers"]["w13"].q.shape[-1] == params["layers"]["w13"].q.shape[-1] // 2
    assert torch.equal(fused_fast_micro_loop(served, cfg, hidden, None, greedy),
                       fast_micro_loop_plain(params, cfg, hidden, None, greedy))
