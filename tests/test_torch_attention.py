"""PyTorch port, decode attention: the plain versions (which the CPU
dispatch takes) against the JAX package's XLA reference and its Pallas
kernel in interpret mode, with bf16/f32 and kv8 histories; plain-torch
emulations of the CUDA kernel's two methods (the tuned route's chunked
online softmax, the split route's statistics and products passes, each with
its fixed-order combine) against the JAX reference; and the kernel's host
side that runs without a card (ctypes declarations, refused shapes, routes).
Tolerance rtol = atol = 1e-5 in f32 (summation order is the only
difference); over a bf16 tail, see `test_split_method_matches_jax`."""

import ctypes
import math
import re
import types
from pathlib import Path

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
from smoltts_torch.ops import _build
from smoltts_torch.ops import attention as A
from smoltts_torch.ops.attention import (
    decode_attention,
    decode_attention_plain,
    decode_attention_tailed,
    decode_attention_tailed_plain,
)
from tests import torch_threads  # noqa: F401  (one intra-op thread)

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


# ---- the method of the CUDA kernel (csrc/decode_attention.cu), emulated ----
# The kernel cannot run on the CPU. Its method is held here against the JAX
# reference: the valid positions of each (row, kv head) (history rows, then
# the tail columns that pass the mask in column order) are cut into
# `splits * WARPS` equal contiguous chunks; each chunk runs an online softmax
# over tiles of `tile` rows; the chunks' (max, sum, acc) meet in a fixed
# order, the 8 warps of a block first, then the blocks of a cluster.

WARPS = 8


def _online_chunk(qg, keys, vals, ks, vs, scale, tile):
    G, hd = qg.shape
    m = torch.full((G,), -math.inf)
    l = torch.zeros(G)
    acc = torch.zeros(G, hd)
    for t0 in range(0, keys.shape[0], tile):
        sl = slice(t0, t0 + tile)
        lg = (qg @ keys[sl].T) * scale * ks[sl]  # [G, t]
        mn = torch.maximum(m, lg.max(1).values)
        alpha = torch.where(mn == -math.inf, torch.ones(G), torch.exp(m - mn))
        p = torch.exp(lg - mn[:, None])
        l = l * alpha + p.sum(1)
        acc = acc * alpha[:, None] + (p * vs[sl]) @ vals[sl]
        m = mn
    return m, l, acc


def _combine(parts):
    M = torch.stack([p[0] for p in parts]).max(0).values
    L, A = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:  # fixed order
        s = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp(m - M))
        L = L + l * s
        A = A + acc * s[:, None]
    return M, L, A


def _kernel_method(q, k_hist, v_hist, k_tail, v_tail, pos, flushed, tail_pos, k_scale=None,
                   v_scale=None, *, tile, splits):
    B, H, hd = q.shape
    n_kv, lim = k_hist.shape[1], k_hist.shape[2]
    G = H // n_kv
    out = torch.zeros(B, H, hd)
    for b in range(B):
        f, p = int(flushed[b]), int(pos[b])
        n_h = max(0, min(f, lim))
        cols = [c for c in range(tail_pos.shape[1]) if 0 <= f <= int(tail_pos[b, c]) <= p]
        for h in range(n_kv):
            keys = torch.cat([k_hist[b, h, :n_h].float(), k_tail[b, h, cols].float()])
            vals = torch.cat([v_hist[b, h, :n_h].float(), v_tail[b, h, cols].float()])
            ones = torch.ones(len(cols))
            ks = torch.cat([k_scale[b, h, :n_h] if k_scale is not None else torch.ones(n_h), ones])
            vs = torch.cat([v_scale[b, h, :n_h] if v_scale is not None else torch.ones(n_h), ones])
            qg = q[b, h * G:(h + 1) * G].float()
            n, nw = keys.shape[0], splits * WARPS
            chunks = []
            for w in range(nw):
                sl = slice(w * n // nw, (w + 1) * n // nw)
                chunks.append(_online_chunk(qg, keys[sl], vals[sl], ks[sl], vs[sl], hd**-0.5, tile))
            blocks = [_combine(chunks[s * WARPS:(s + 1) * WARPS]) for s in range(splits)]
            _, L, A = _combine(blocks)
            out[b, h * G:(h + 1) * G] = A / L[:, None]
    return out.reshape(B, H * hd)


def _edge_case(seed, kv8, H=8, n_kv=2, hd=64, store=jnp.float32):
    """Rows: one valid position (flushed = pos = 0); a full history with an
    empty tail; flushed past the history (clipped); a stale tail column.
    f32 q; the tail (and a history that is not int8) in `store`."""
    rng = np.random.default_rng(seed)
    B, Sh, W = 4, 40, 16
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kh, vh = (rng.standard_normal((B, n_kv, Sh, hd)).astype(np.float32) for _ in "kv")
    kt, vt = (rng.standard_normal((B, n_kv, W, hd)).astype(np.float32) for _ in "kv")
    flushed = np.asarray([0, Sh, Sh + 2, 10], np.int32)
    pos = np.asarray([0, Sh - 1, Sh + 5, 17], np.int32)
    tail_pos = np.full((B, W), -1, np.int32)
    for b in range(B):
        cols = rng.permutation(W)[: max(0, pos[b] - flushed[b] + 1)]
        tail_pos[b, cols] = np.arange(flushed[b], pos[b] + 1)
    tail_pos[1, 3] = Sh - 2  # stale: below flushed
    tail_pos[3, np.flatnonzero(tail_pos[3] < 0)[0]] = 4  # stale
    jargs = dict(q=jnp.asarray(q), k_tail=jnp.asarray(kt, store), v_tail=jnp.asarray(vt, store),
                 pos=jnp.asarray(pos), flushed=jnp.asarray(flushed), tail_pos=jnp.asarray(tail_pos))
    if kv8:
        kq, ks = jax_quantize_kv(jnp.asarray(kh))
        vq, vs = jax_quantize_kv(jnp.asarray(vh))
        jargs.update(k_hist=kq, v_hist=vq, k_scale=ks, v_scale=vs)
    else:
        jargs.update(k_hist=jnp.asarray(kh, store), v_hist=jnp.asarray(vh, store))
    return jargs, {k: _t(v) for k, v in jargs.items()}


_CASES = {
    "tailed": lambda kv8: _tailed_case(3, kv8),
    "edges": lambda kv8: _edge_case(8, kv8),
    "hd128_g8": lambda kv8: _edge_case(9, kv8, H=16, n_kv=2, hd=128),
}


@pytest.mark.parametrize("tile,splits", [(1, 1), (16, 2), (64, 8)], ids=["tile1", "tile16", "tile64"])
@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("kv8", [False, True], ids=["f32_history", "kv8_history"])
def test_kernel_method_matches_jax(kv8, case, tile, splits):
    """The chunked online softmax and its fixed-order combine equal the JAX
    tailed attention to 1e-5 in f32 (summation order is the only
    difference), whatever the tile and the number of chunks."""
    jargs, targs = _CASES[case](kv8)
    ref = np.asarray(jax_tailed(**jargs))
    got = _kernel_method(**targs, tile=tile, splits=splits).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)


# ---- the split route's method (f32 compute over a bf16 cache, any head_dim),
# emulated. The same chunks as above. Pass 1: each chunk's online (max, sum)
# over tiles, combined warps first, then blocks. Pass 2: the normalized
# probabilities (the history's times v_scale, the tail's rounded to bf16
# when a bf16 tail serves f32 compute), summed per chunk into separate
# history and tail accumulators, the chunks combined in the same order; the
# tail's sum is rounded to bf16 once, after the combine, then added to the
# history's (the plain version's and the JAX package's roundings).


def _split_method(q, k_hist, v_hist, k_tail, v_tail, pos, flushed, tail_pos, k_scale=None,
                  v_scale=None, *, tile, splits):
    B, H, hd = q.shape
    n_kv, lim = k_hist.shape[1], k_hist.shape[2]
    G = H // n_kv
    rnd = q.dtype == torch.float32 and k_tail.dtype == torch.bfloat16
    bf16 = lambda t: t.bfloat16().float() if rnd else t
    out = torch.zeros(B, H, hd)
    for b in range(B):
        f, p = int(flushed[b]), int(pos[b])
        n_h = max(0, min(f, lim))
        cols = [c for c in range(tail_pos.shape[1]) if 0 <= f <= int(tail_pos[b, c]) <= p]
        for h in range(n_kv):
            keys = torch.cat([k_hist[b, h, :n_h].float(), k_tail[b, h, cols].float()])
            vals = torch.cat([v_hist[b, h, :n_h].float(), v_tail[b, h, cols].float()])
            ones = torch.ones(len(cols))
            ks = torch.cat([k_scale[b, h, :n_h] if k_scale is not None else torch.ones(n_h), ones])
            vs = torch.cat([v_scale[b, h, :n_h] if v_scale is not None else torch.ones(n_h), ones])
            qg = q[b, h * G:(h + 1) * G].float()
            n, nw = keys.shape[0], splits * WARPS
            bounds = [(w * n // nw, (w + 1) * n // nw) for w in range(nw)]
            stats = [_online_chunk(qg, keys[lo:hi], vals[lo:hi], ks[lo:hi], vs[lo:hi], hd**-0.5, tile)
                     for lo, hi in bounds]
            blocks = [_combine(stats[s * WARPS:(s + 1) * WARPS]) for s in range(splits)]
            M, L, _ = _combine(blocks)
            logits = (qg @ keys.T) * hd**-0.5 * ks  # [G, n]: the same logits again
            probs = torch.exp(logits - M[:, None]) / L[:, None]
            is_hist = torch.arange(n) < n_h
            probs = torch.where(is_hist, probs * vs, bf16(probs))
            acc = torch.zeros(2, G, hd)  # history, tail
            for s in range(splits):
                blk = torch.zeros(2, G, hd)
                for lo, hi in bounds[s * WARPS:(s + 1) * WARPS]:
                    pc, vc, hc = probs[:, lo:hi], vals[lo:hi], is_hist[lo:hi]
                    blk = blk + torch.stack([pc[:, hc] @ vc[hc], pc[:, ~hc] @ vc[~hc]])
                acc = acc + blk
            out[b, h * G:(h + 1) * G] = acc[0] + bf16(acc[1])
    return out.reshape(B, H * hd)


def _tail_mass(targs):
    """Sum over the valid tail columns of p |v| for every output, in f64
    (the plain version with the history's values zeroed and |v_tail|)."""
    f64 = {k: v.double() if torch.is_tensor(v) and (v.is_floating_point() or v.dtype == torch.int8)
           else v for k, v in targs.items()}
    f64["v_hist"] = torch.zeros_like(f64["v_hist"])
    f64["v_tail"] = f64["v_tail"].abs()
    return decode_attention_tailed_plain(**f64).numpy()


_SPLIT_CASES = {
    "edges": lambda kv8, store: _edge_case(8, kv8, store=store),
    "hd96": lambda kv8, store: _edge_case(10, kv8, H=12, n_kv=4, hd=96, store=store),
    "hd128_g8": lambda kv8, store: _edge_case(9, kv8, H=16, n_kv=2, hd=128, store=store),
}


@pytest.mark.parametrize("tile,splits", [(1, 1), (16, 2), (64, 8)], ids=["tile1", "tile16", "tile64"])
@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
@pytest.mark.parametrize("kv8", [False, True], ids=["same_history", "kv8_history"])
@pytest.mark.parametrize("store", ["f32", "bf16"], ids=["f32_cache", "f32_over_bf16"])
def test_split_method_matches_jax(store, kv8, case, tile, splits):
    """The split route's two passes equal JAX's decode_attention_tailed with
    f32 q, whatever the tile and the number of chunks. Over an f32 cache
    to TOL (summation order only). Over a bf16 cache (bf16 history or int8
    history, bf16 tail) to TOL plus the tail term's two bf16 roundings: the
    method and JAX agree before them to TOL, so a rounding can differ only
    where the two values straddle a rounding boundary, by one bf16 spacing,
    at most 2**-7 of the value (8 significant bits). A tail probability p
    rounded the other way moves the output by at most 2**-7 p |v|, so all of
    them together by 2**-7 times the tail's mass sum(p |v|); the tail sum,
    whose magnitude is at most that mass, by at most 2**-7 of it when
    rounded. Bound per output: TOL + 2**-6 sum(p |v|). That bound alone
    would also pass a method that does not round (its misses reach about
    0.4 of it), so the outputs beyond TOL must also be rare: a rounding
    differs only within f32 noise of a boundary (~1e-7 / 2**-8, about 3e-5
    of the roundings), and one that differs moves one head's outputs; an
    unrounded method misses TOL on about 45% of them."""
    sdt = jnp.float32 if store == "f32" else jnp.bfloat16
    jargs, targs = _SPLIT_CASES[case](kv8, sdt)
    ref = np.asarray(jax_tailed(**jargs))
    got = _split_method(**targs, tile=tile, splits=splits).numpy()
    assert np.isfinite(got).all()
    if store == "f32":
        np.testing.assert_allclose(got, ref, **TOL)
        return
    assert A.kernel_plan(**targs).route == "split"
    tol = TOL["atol"] + TOL["rtol"] * np.abs(ref)
    excess = np.abs(got - ref) - (tol + 2.0**-6 * _tail_mass(targs))
    assert (excess <= 0).all(), f"max excess over the bound {excess.max()}"
    assert (np.abs(got - ref) > tol).mean() <= 0.01


def _c_functions(source: str):
    """{name: [ctypes type per parameter]} of the `extern "C" int name(...)`
    functions of a C source: pointers and cudaStream_t map to c_void_p."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source):
        argtypes = []
        for decl in filter(None, (d.strip() for d in params.split(","))):
            ctype = re.match(r"(.*?)\w+$", decl, re.S).group(1)
            if "*" in ctype or "cudaStream_t" in ctype:
                argtypes.append(ctypes.c_void_p)
            else:
                argtypes.append({"int": ctypes.c_int, "long long": ctypes.c_longlong,
                                 "float": ctypes.c_float}[ctype.strip()])
        out[name] = argtypes
    return out


def test_declared_argtypes_mirror_c():
    """A mismatch between the ctypes declaration and the C signature is silent
    on the card (arguments are passed at the wrong width)."""
    src = (Path(__file__).resolve().parents[1] / "smoltts_torch" / "csrc"
           / "decode_attention.cu").read_text()
    want = _c_functions(src)
    assert set(want) == {"smoltts_decode_attention", "smoltts_decode_attention_setup"}

    class Handle(dict):
        def __getattr__(self, name):
            return self.setdefault(name, types.SimpleNamespace())

    h = Handle()
    _build._declare(h)
    for name, argtypes in want.items():
        assert h[name].argtypes == argtypes, name
        assert h[name].restype is ctypes.c_int
    assert len(want["smoltts_decode_attention"]) == 24


def _plan_args(B, H, n_kv, hd, lim, W, dtype=torch.float32, kv8=False, store=None):
    """Zero inputs of one kernel call on the CPU (the checks need no card)."""
    store = store or dtype
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    hist = torch.zeros(B, n_kv, lim, hd, dtype=torch.int8 if kv8 else store)
    tail = torch.zeros(B, n_kv, W, hd, dtype=store)
    scale = torch.ones(B, n_kv, lim) if kv8 else None
    return dict(q=torch.zeros(B, H, hd, dtype=dtype), k_hist=hist, v_hist=hist.clone(),
                k_tail=tail, v_tail=tail.clone(), pos=i32(B), flushed=i32(B),
                tail_pos=i32(B, W), k_scale=scale, v_scale=None if scale is None else scale.clone())


@pytest.mark.parametrize("H,n_kv,hd,W,route", [
    (12, 4, 72, 8, "split"),
    (18, 2, 64, 8, "tuned"),
    (12, 4, 64, 1040, "tuned"),
], ids=["hd72", "group9", "tail1040"])
def test_kernel_wrapper_refuses_what_the_kernel_cannot_take(H, n_kv, hd, W, route):
    """Checked before anything is built or launched. The kernel serves these
    shapes (a head_dim without a template, a group above 8, a tail above
    1024 columns); at them it still refuses a dtype it has no variant for,
    rows that are not contiguous, index tensors that are not int32, and on
    the tuned route data off 16-byte alignment."""
    args = _plan_args(2, H, n_kv, hd, 16, W)
    assert A.kernel_plan(**args).route == route
    refused = [
        ({"q": args["q"].half()}, "q dtype"),
        ({"k_tail": args["k_tail"].bfloat16(), "v_tail": args["v_tail"].bfloat16(),
          "q": args["q"].bfloat16(), "k_hist": args["k_hist"].half(),
          "v_hist": args["v_hist"].half()}, "k_hist dtype"),
        ({"k_hist": args["k_hist"].transpose(2, 3).contiguous().transpose(2, 3),
          "v_hist": args["v_hist"].transpose(2, 3).contiguous().transpose(2, 3)},
         "rows must be contiguous"),
        ({"tail_pos": args["tail_pos"].long()}, "tail_pos must be contiguous int32"),
        ({"k_scale": torch.ones(2, n_kv, 16)}, "k_scale and v_scale come together"),
    ]
    if route == "tuned":
        off = torch.zeros(args["q"].numel() + 1)[1:].view(args["q"].shape)  # 4 bytes off
        refused.append(({"q": off}, "16-byte aligned"))
    for change, match in refused:
        with pytest.raises(ValueError, match=match):
            A._kernel(**{**args, **change})


@pytest.mark.parametrize("dtype,kv8,store", [
    (torch.bfloat16, True, None), (torch.bfloat16, False, None), (torch.float32, True, None),
    (torch.float32, False, None), (torch.float32, False, torch.bfloat16),
    (torch.float32, True, torch.bfloat16),
], ids=["bf16_kv8", "bf16", "f32_kv8", "f32", "f32_over_bf16", "f32_over_bf16_kv8"])
@pytest.mark.parametrize("B,H,n_kv,hd,lim,W", [
    (8, 12, 4, 64, 64, 2048), (8, 12, 1, 64, 32, 128), (2, 12, 4, 32, 32, 16),
    (2, 2, 1, 32, 32, 16), (2, 12, 4, 96, 32, 16), (1, 12, 1, 96, 32, 2048),
    (1, 64, 1, 256, 8, 4), (1, 3, 3, 8, 8, 4), (1, 4, 2, 33, 8, 3), (1, 4, 1, 64, 8, 40000),
    (1, 12, 4, 64, 2048, 128),
], ids=["W2048", "G12", "hd32", "hd32_tiny", "hd96", "hd96_G12_W2048", "G64_hd256",
        "hd8_G1", "hd33", "W40000", "blocking_B1"])
def test_kernel_plan_accepts_every_shape_jax_takes(B, H, n_kv, hd, lim, W, dtype, kv8, store):
    """No shape that JAX's decode_attention_tailed takes is refused: the
    tuned kernel takes hd 32/64/128 over a history of the compute dtype or
    int8 (any group, via tiles of 8 heads; a tail of up to MAX_TUNED_W
    columns, compacted in shared memory), the split route every other
    head_dim, longer tails and f32 compute over a bf16 cache: the blocking
    generator's attention (B=1, H 12/4, hd 64, lim 2048, W 128, f32 over the
    bf16 cache it keeps for an f32 model) takes the split route."""
    plan = A.kernel_plan(**_plan_args(B, H, n_kv, hd, lim, W, dtype, kv8, store))
    tuned = hd in (32, 64, 128) and store is None and W <= A.MAX_TUNED_W
    assert plan.route == ("tuned" if tuned else "split")
    assert (plan.B, plan.H, plan.n_kv, plan.hd, plan.lim, plan.W) == (B, H, n_kv, hd, lim, W)
    assert plan.hist == (1 if kv8 else 0) + (2 if store is not None else 0)


@pytest.mark.parametrize("kv8", [False, True], ids=["f32_history", "kv8_history"])
@pytest.mark.parametrize("shape", ["W2048", "G12", "hd32", "hd96"])
def test_tailed_wide_shapes_match_jax(shape, kv8):
    """The plain version (the kernel's yardstick on the card) equals JAX's
    decode_attention_tailed at a tail of 2048 columns, a group of 12 over one
    kv head, and head dims 32 and 96."""
    B, H, n_kv, hd, Sh, W = {"W2048": (2, 12, 4, 64, 16, 2048), "G12": (2, 12, 1, 64, 48, 16),
                             "hd32": (2, 12, 4, 32, 48, 16), "hd96": (2, 12, 4, 96, 48, 16)}[shape]
    rng = np.random.default_rng(11)
    q, kt, vt = (rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, hd), (B, n_kv, W, hd), (B, n_kv, W, hd)))
    kh, vh = (rng.standard_normal((B, n_kv, Sh, hd)).astype(np.float32) for _ in "kv")
    flushed = np.asarray([Sh // 2, Sh], np.int32)
    pos = flushed + np.asarray([W // 2, W - 3], np.int32)
    tail_pos = np.full((B, W), -1, np.int32)
    for b in range(B):
        cols = rng.permutation(W)[: pos[b] - flushed[b] + 1]  # both sides of 1024 at W 2048
        tail_pos[b, cols] = np.arange(flushed[b], pos[b] + 1)
    jargs = dict(q=jnp.asarray(q), k_tail=jnp.asarray(kt), v_tail=jnp.asarray(vt),
                 pos=jnp.asarray(pos), flushed=jnp.asarray(flushed), tail_pos=jnp.asarray(tail_pos))
    if kv8:
        kq, ks = jax_quantize_kv(jnp.asarray(kh))
        vq, vs = jax_quantize_kv(jnp.asarray(vh))
        jargs.update(k_hist=kq, v_hist=vq, k_scale=ks, v_scale=vs)
    else:
        jargs.update(k_hist=jnp.asarray(kh), v_hist=jnp.asarray(vh))
    targs = {k: _t(v) for k, v in jargs.items()}
    ref = np.asarray(jax_tailed(**jargs))
    np.testing.assert_allclose(decode_attention_tailed_plain(**targs).numpy(), ref, **TOL)
    assert A.kernel_plan(**targs).route == ("split" if hd == 96 else "tuned")
