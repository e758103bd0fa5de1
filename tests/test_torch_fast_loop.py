"""PyTorch port, fast micro-loop: greedy codes of the plain loop (what the
fused-loop wrapper runs on the CPU) equal the JAX package's XLA loop and its
Pallas kernel in interpret mode exactly, on the tiny config of
tests/test_fast_loop.py, for the w1/w3 and the fused w13 trees. Also the
CUDA kernel's host side that runs without a card: the ctypes argument
struct against the C source, and the widths the wrapper refuses."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoltts_tpu.config import tiny_debug_config as jax_tiny
from smoltts_tpu.lm.decode import _fast_micro_loop as jax_loop
from smoltts_tpu.lm.samplers import GenerationSettings as JaxSettings
from smoltts_tpu.models.dual_ar import init_params as jax_init
from smoltts_tpu.ops.fast_loop import fused_fast_micro_loop as jax_fused
from smoltts_tpu.ops.fast_loop import supports_fused_fast as jax_supports
from smoltts_tpu.ops.quant import fuse_decode_params as jax_fuse
from smoltts_tpu.ops.quant import quantize_decode_params as jax_quantize
from smoltts_torch.config import tiny_debug_config
from smoltts_torch.interop import params_from_jax_numpy
from smoltts_torch.lm.decode import _fast_micro_loop
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.ops import fast_loop as FL
from smoltts_torch.ops.fast_loop import (
    _FastLoopArgs,
    fast_micro_loop_plain,
    fused_fast_micro_loop,
    supports_fused_fast,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

CB = 64
GREEDY_J = JaxSettings(default_temp=0.0, default_fast_temp=0.0)
GREEDY = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)


def _trees(fused: bool, **kw):
    jcfg = jax_tiny(codebook_size=CB, vocab_size=256 + 64 + CB, **kw)
    cfg = tiny_debug_config(codebook_size=CB, vocab_size=256 + 64 + CB, **kw)
    dense = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jparams = jax_quantize(jax_fuse(dense) if fused else dense)
    return jcfg, cfg, jparams, params_from_jax_numpy(jax.tree.map(np.asarray, jparams))


def _hidden(B, dim, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, dim)) * 2.0).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True], ids=["w1w3", "w13"])
def test_greedy_matches_jax_xla_loop(fused):
    jcfg, cfg, jparams, params = _trees(fused)
    hidden = _hidden(16, cfg.dim)
    ref = np.asarray(jax_loop(jparams, jcfg, jnp.asarray(hidden), jax.random.PRNGKey(3), GREEDY_J))
    got = fused_fast_micro_loop(params, cfg, torch.from_numpy(hidden), None, GREEDY).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and got.shape == (16, cfg.max_fast_seqlen)


def test_greedy_matches_pallas_interpret():
    """One interpret-mode case (each costs ~20 s of CPU compile)."""
    jcfg, cfg, jparams, params = _trees(True)
    hidden = _hidden(4, cfg.dim, seed=5)
    ref = np.asarray(
        jax_fused(jparams, jcfg, jnp.asarray(hidden), jax.random.PRNGKey(2), GREEDY_J, interpret=True)
    )
    got = fused_fast_micro_loop(params, cfg, torch.from_numpy(hidden), None, GREEDY).numpy()
    np.testing.assert_array_equal(got, ref)


def test_supports_gating_matches_jax():
    jcfg, cfg, jparams, params = _trees(False)
    assert supports_fused_fast(cfg, params) and jax_supports(jcfg, jparams)
    dense_j = jax_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    dense = params_from_jax_numpy(jax.tree.map(np.asarray, dense_j))
    assert not supports_fused_fast(cfg, dense) and not jax_supports(jcfg, dense_j)
    jcfg2, cfg2, jparams2, params2 = _trees(False, duplicate_code_0=False)
    assert not supports_fused_fast(cfg2, params2) and not jax_supports(jcfg2, jparams2)
    with pytest.raises(ValueError):
        fused_fast_micro_loop(dense, cfg, torch.zeros(1, cfg.dim), None, GREEDY)
    # An unsupported tree takes the plain loop, as in JAX: same greedy codes.
    hidden = _hidden(8, cfg.dim, seed=7)
    ref = np.asarray(jax_loop(dense_j, jcfg, jnp.asarray(hidden), jax.random.PRNGKey(0), GREEDY_J))
    got = _fast_micro_loop(dense, cfg, torch.from_numpy(hidden), None, GREEDY).numpy()
    np.testing.assert_array_equal(got, ref)


def test_sampled_codes_in_range():
    _, cfg, _, params = _trees(True)
    settings = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05)
    gen = torch.Generator().manual_seed(0)
    codes = fast_micro_loop_plain(params, cfg, torch.from_numpy(_hidden(8, cfg.dim)), gen, settings)
    assert codes.shape == (8, cfg.max_fast_seqlen)
    assert int(codes.min()) >= 0 and int(codes.max()) < CB


def _c_struct_fields(source: str, name: str):
    """(field, ctypes type) of `struct name { ... };` in a C source: int and
    float fields map to c_int / c_float, every pointer to c_void_p."""
    body = re.search(r"struct\s+" + name + r"\s*\{(.*?)\};", source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        first, *rest = decl.split(",")
        ctype, var = re.match(r"(.*?)(\w+)$", first.strip(), re.S).groups()
        pointer = "*" in ctype
        base = ctype.replace("const", "").replace("*", "").strip()
        for v in [var] + [r.strip() for r in rest]:
            fields.append((v, ctypes.c_void_p if pointer else
                           {"int": ctypes.c_int, "float": ctypes.c_float}[base]))
    return fields


def test_args_struct_mirrors_c():
    """A mismatch between the ctypes mirror and the C struct is silent on the
    card (every later field is read at the wrong offset)."""
    src = (Path(__file__).resolve().parents[1] / "smoltts_torch" / "csrc" / "fast_loop.cu").read_text()
    want = _c_struct_fields(src, "FastLoopArgs")
    got = [(f, t) for f, t in _FastLoopArgs._fields_]
    assert got == want
    assert len(want) > 40 and want[-1] == ("codes", ctypes.c_void_p)


def test_kernel_refuses_widths_it_cannot_take():
    """The CUDA kernel moves 16-byte chunks: a width that is not a multiple of
    16 is refused by the wrapper before anything is launched."""
    _, cfg, _, params = _trees(True, fast_dim=72, dim=72)
    assert supports_fused_fast(cfg, params)
    with pytest.raises(ValueError, match="multiple of 16"):
        FL._kernel(params, cfg, torch.zeros(2, 72), None, GREEDY)
