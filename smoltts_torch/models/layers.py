"""Transformer building blocks: RMSNorm in f32, traditional
(interleaved-pair) RoPE with bf16-rounded cos/sin tables, fused-qkv split,
SwiGLU; and the training attention (`sdpa`, `sdpa_blockwise`) with
attention-probability dropout, and the pre-norm blocks built on it. Linear
weights are [in, out] (x @ W); projections go through `ops.quant.mm`, so int8
QTensor trees run here too.

The attention math is plain PyTorch, as the JAX package computes it with
XLA einsums outside any Pallas kernel; logits and P@V are taken in f32
(JAX's `preferred_element_type=f32`: products of bf16 values are exact in
f32, so only the summation order differs).

Dropout randomness is an integer seed per site, never a generator carried
through the forward: `torch.utils.checkpoint` restores only the global RNG
state on recompute, so each site derives its mask from a seed the forward
passes in (`fold_in`, as JAX folds a key per block) and a recompute draws the
same bits. The bit stream differs from JAX's by contract (see
`smoltts_tpu/models/layers.py::dropout_keep`); the keep distribution, the
1/(1-p) scale after P@V and the `dropout_cols` draws are the same.

On a mesh (parallel/mesh.py) the blocks take a `Shard`: which of the
block's weights are this rank's Megatron share, and whether the residual
stream holds this rank's share of the sequence. The collectives that carry
gradients are parallel/collectives.py's. A rank draws each dropout mask at
the global shape and takes its window (`KeepWindow`), so the masks, and the
step, do not depend on the mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from smoltts_torch.ops.quant import mm
from smoltts_torch.parallel.collectives import (
    copy_model,
    gather_model_rs,
    reduce_model,
    reduce_scatter_model,
)


@dataclasses.dataclass(frozen=True)
class AttnDims:
    """Static attention dimensions for one trunk."""

    n_head: int
    n_kv_head: int
    head_dim: int
    dim: int

    @property
    def q_size(self) -> int:
        return self.n_head * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.n_kv_head * self.head_dim


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm computed in f32, cast back to x's dtype, then scaled."""
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return normed.to(x.dtype) * weight


def swiglu(x: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """w2(silu(x w1) * (x w3)); weights plain or int8 QTensors."""
    return mm(F.silu(mm(x, w1)) * mm(x, w3), w2)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, base: float, dtype=torch.bfloat16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [*positions.shape, head_dim//2], computed in f32 and
    rounded to `dtype` (bf16 by default, as the reference caches them)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    # a fill, not a host-to-device copy, so a CUDA graph can capture it
    base = torch.full((), float(base), dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / torch.pow(base, exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Traditional RoPE on interleaved pairs. x [..., T, H, hd]; cos/sin
    [..., T, hd//2]. Math in f32, result in x's dtype."""
    xf = x.float()
    pairs = xf.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x0, x1 = pairs[..., 0], pairs[..., 1]
    c = cos.float()[..., :, None, :]
    s = sin.float()[..., :, None, :]
    out = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def split_qkv(qkv: torch.Tensor, dims: AttnDims):
    """[..., T, q+2kv] -> q [..., T, H, hd], k/v [..., T, KV, hd]."""
    q, k, v = torch.split(qkv, [dims.q_size, dims.kv_size, dims.kv_size], dim=-1)
    q = q.reshape(*q.shape[:-1], dims.n_head, dims.head_dim)
    k = k.reshape(*k.shape[:-1], dims.n_kv_head, dims.head_dim)
    v = v.reshape(*v.shape[:-1], dims.n_kv_head, dims.head_dim)
    return q, k, v


# ---- dropout seeds and masks ----------------------------------------------

_U64 = (1 << 64) - 1
_SPLIT_TAG = 0x5EED5EED5EED5EED


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 64-bit seed from `seed` and an integer (jax.random.fold_in's role)."""
    return _splitmix64((seed & _U64) ^ _splitmix64(data & _U64))


def split_seed(seed: int, num: int = 2) -> Tuple[int, ...]:
    """`num` independent seeds from one (jax.random.split's role)."""
    return tuple(fold_in(seed ^ _SPLIT_TAG, i) for i in range(num))


def dropout_keep(seed: int, rate: float, shape, device=None) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask, a pure function of (seed, shape, device):
    uniform draws from a Philox generator seeded with `seed`, kept where
    u >= rate."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed & ((1 << 63) - 1))
    u = torch.rand(tuple(shape), generator=gen, device=device)
    return u >= rate


@dataclasses.dataclass(frozen=True)
class KeepWindow:
    """A rank's window on a dropout mask drawn at the global shape [B, KV,
    H / KV, T, C]: batch rows [b0, b0 + b) of B and query heads [q0, q0 + h)
    of H over KV kv heads, b and h the local shape's; sdpa names the query
    rows [t0, t0 + Tq) of T."""

    b0: int
    B: int
    q0: int
    H: int
    KV: int

    def keep(self, seed: int, rate: float, shape, t0: int, T: int, device) -> torch.Tensor:
        b, kv, g, tq, c = shape
        full = dropout_keep(seed, rate, (self.B, self.KV, self.H // self.KV, T, c), device)
        full = full[self.b0 : self.b0 + b].reshape(b, self.H, T, c)
        return full[:, self.q0 : self.q0 + kv * g, t0 : t0 + tq].reshape(shape)


@dataclasses.dataclass(frozen=True)
class FoldWindow(KeepWindow):
    """The window of the folded fast trunk: b0 and B count frames, the
    global draw folds F frames of n tokens into one sequence
    ([B / F, KV, H / KV, F * n, n], a bit per row and column class), and the
    local shape folds its own count of frames (F_l = Tq / n)."""

    F: int = 1
    n: int = 1

    def keep(self, seed: int, rate: float, shape, t0: int, T: int, device) -> torch.Tensor:
        b, kv, g, tq, c = shape
        F, n, fl = self.F, self.n, tq // self.n
        full = dropout_keep(seed, rate, (self.B // F, self.KV, self.H // self.KV, F * n, c),
                            device)
        frames = full.reshape(self.B // F, self.H, F, n, c).transpose(1, 2)
        mine = frames.reshape(self.B, self.H, n, c)[self.b0 : self.b0 + b * fl,
                                                    self.q0 : self.q0 + kv * g]
        return mine.reshape(b, fl, kv * g, n, c).transpose(1, 2).reshape(shape)


def _keep(window: Optional[KeepWindow], seed: int, rate: float, shape, t0: int, T: int,
          device) -> torch.Tensor:
    if window is None:
        if (t0, T) != (0, shape[3]):
            raise ValueError("a mask over some of the query rows needs a KeepWindow")
        return dropout_keep(seed, rate, shape, device)
    return window.keep(seed, rate, shape, t0, T, device)


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a block's tensors lie on `mesh`.

    split: the weights are this rank's Megatron share over the model axis
      (wqkv/w1/w3/w13 by columns, wo/w2 by rows): the input of each column
      product is copied to the axis, each row product's output summed over it.
    seq: the residual stream holds this rank's 1/n_model of the sequence.
      With split weights the sequence is gathered before each column product
      and reduce-scattered after each row product (Megatron-SP); with whole
      weights a rank attends from its rows over the gathered K/V, and every
      weight's gradient (then partial) is summed over the model axis.
      Under either, the norms' gradients are.
    window: the rank's window on the attention dropout masks.
    `WHOLE` (no mesh) is one process.
    """

    mesh: object = None
    split: bool = False
    seq: bool = False
    window: Optional[KeepWindow] = None

    def weights(self, lp: dict) -> dict:
        if not self.seq:
            return lp
        whole = () if self.split else tuple(lp)
        return {k: copy_model(w, self.mesh) if k in whole or k.endswith("norm") else w
                for k, w in lp.items()}

    def column_input(self, h: torch.Tensor) -> torch.Tensor:
        if not self.split:
            return h
        return gather_model_rs(h, self.mesh, 1) if self.seq else copy_model(h, self.mesh)

    def row_output(self, y: torch.Tensor) -> torch.Tensor:
        if not self.split:
            return y
        return reduce_scatter_model(y, self.mesh, 1) if self.seq else reduce_model(y, self.mesh)


WHOLE = Shard()


def _dot32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with f32 operands and result (JAX's preferred_element_type=f32)."""
    return torch.einsum(eq, a.float(), b.float())


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    # JAX's dots_with_no_batch_dims_saveable: keep the projections' outputs
    # (x @ W lowers to aten.mm), recompute attention's batched products and
    # every elementwise op.
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, *args, remat_policy: str = "none"):
    """fn(*args) under activation checkpointing (torch.utils.checkpoint,
    use_reentrant=False) when grads flow: "none" saves only the inputs,
    "dots" also the projections' outputs."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _dots_policy))
    if remat_policy != "none":
        raise ValueError(f"unknown remat_policy {remat_policy!r} (none | dots)")
    return checkpoint(fn, *args, use_reentrant=False)


# ---- training attention ---------------------------------------------------


def sdpa_blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    block_q: int = 256,
    block_k: int = 256,
    q_start: int = 0,
    window: Optional[KeepWindow] = None,
) -> torch.Tensor:
    """Causal GQA attention with an online softmax over K blocks: never
    builds the [B, H, T, T] logits. Each q-block is checkpointed, so backward
    recomputes its block logits. Dropout per block from
    fold_in(seed, qi * NK + kj); the normalizer uses undropped probabilities
    and the 1/(1-p) scale applies to the block output.

    The queries are rows [q_start, q_start + Tq) of the T keys' sequence (a
    sequence-parallel rank's share): the blocks, their causal extents and
    their dropout seeds are the whole sequence's, each cut to these rows."""
    B, Tq, H, hd = q.shape
    T, n_kv = k.shape[1], k.shape[2]
    group = H // n_kv
    scale = hd**-0.5
    NK = T // block_k
    qg = q.reshape(B, Tq, n_kv, group, hd)
    use_dropout = dropout_rate > 0.0 and dropout_seed is not None
    dev = q.device

    def one_q_block(qi, r0, qb, k, v):
        rows = qb.shape[1]
        m = torch.full((B, n_kv, group, rows), -float("inf"), device=dev)
        l = torch.zeros((B, n_kv, group, rows), device=dev)
        acc = torch.zeros((B, n_kv, group, rows, hd), device=dev)
        n_kb = (qi * block_q) // block_k + (block_q + block_k - 1) // block_k
        q_idx = qi * block_q + r0 + torch.arange(rows, device=dev)
        for kj in range(min(n_kb, NK)):
            kb = k[:, kj * block_k : (kj + 1) * block_k]
            vb = v[:, kj * block_k : (kj + 1) * block_k]
            logits = _dot32("bqhgd,bkhd->bhgqk", qb, kb) * scale
            k_idx = kj * block_k + torch.arange(block_k, device=dev)
            causal = q_idx[:, None] >= k_idx[None, :]
            logits = logits.masked_fill(~causal, -float("inf"))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            p16 = p.to(v.dtype)
            if use_dropout:
                keep = _keep(window, fold_in(dropout_seed, qi * NK + kj), dropout_rate,
                             p.shape, r0, block_q, dev)
                p16 = p16.masked_fill(~keep, 0)
            acc = acc * corr[..., None] + _dot32("bhgqk,bkhd->bhgqd", p16, vb)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        if use_dropout:
            out = out * (1.0 / (1.0 - dropout_rate))
        return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # [B, bq, n_kv, g, hd]

    outs, r = [], q_start
    while r < q_start + Tq:
        qi = r // block_q
        r1 = min((qi + 1) * block_q, q_start + Tq)
        qb = qg[:, r - q_start : r1 - q_start]
        outs.append(remat_call(lambda qb, k, v, qi=qi, r0=r - qi * block_q:
                               one_q_block(qi, r0, qb, k, v), qb, k, v))
        r = r1
    return torch.cat(outs, dim=1).reshape(B, Tq, H * hd)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    *,
    is_causal: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    dropout_cols: Optional[int] = None,
    q_start: Optional[int] = None,
    window: Optional[KeepWindow] = None,
) -> torch.Tensor:
    """GQA attention. q [B, Tq, H, hd]; k/v [B, Tk, n_kv, hd]; mask bool
    [*, Tq, Tk] (True = attend). Softmax in f32, fully masked rows give 0.

    dropout_cols: when every attendable key of a row sits at a distinct
    column class mod `dropout_cols` (the folded fast trunk), draw keep bits
    for that many columns and expand them by col % dropout_cols.

    q_start: the queries are rows [q_start, q_start + Tq) of the keys'
    sequence (causal self-attention from a sequence-parallel rank's share);
    None is the whole sequence when Tq == Tk. `window`: this rank's window
    on masks drawn at the global shape.

    Long causal self-attention with no mask (causal, T >= 512, T % 256 == 0)
    takes `sdpa_blockwise`, under exactly the JAX package's condition on the
    whole sequence's T, since the two forms round differently."""
    B, Tq, n_head, hd = q.shape
    n_kv, Tk = k.shape[2], k.shape[1]
    self_attn = q_start is not None or Tq == Tk
    if is_causal and mask is None and self_attn and Tk >= 512 and Tk % 256 == 0:
        return sdpa_blockwise(q, k, v, dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                              q_start=q_start or 0, window=window)
    qg = q.reshape(B, Tq, n_kv, n_head // n_kv, hd)
    logits = _dot32("bqhgd,bkhd->bhgqk", qg, k) * (hd**-0.5)  # [B, n_kv, g, Tq, Tk]
    if is_causal:
        offset = Tk - Tq if q_start is None else q_start
        causal = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device).tril(offset)
        mask = causal if mask is None else (mask & causal)
    if mask is not None:
        if mask.dim() <= 2:
            mask_b = mask.expand(B, 1, 1, Tq, Tk)
        else:
            mask_b = mask
            while mask_b.dim() < 5:
                mask_b = mask_b[:, None]
        logits = logits.masked_fill(~mask_b, -float("inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully masked rows
    probs = probs.to(v.dtype)
    use_dropout = dropout_rate > 0.0 and dropout_seed is not None
    if use_dropout:
        t0, T = (0, Tq) if q_start is None else (q_start, Tk)
        if dropout_cols is not None and dropout_cols < Tk:
            keep = _keep(window, dropout_seed, dropout_rate, probs.shape[:-1] + (dropout_cols,),
                         t0, T, q.device)
            keep = keep[..., torch.arange(Tk, device=q.device) % dropout_cols]
        else:
            keep = _keep(window, dropout_seed, dropout_rate, probs.shape, t0, T, q.device)
        probs = probs.masked_fill(~keep, 0)
    out = _dot32("bhgqk,bkhd->bqhgd", probs, v)
    if use_dropout:
        out = out * (1.0 / (1.0 - dropout_rate))
    return out.to(v.dtype).reshape(B, Tq, n_head * hd)


def attention_block(x, lp: dict, dims: AttnDims, cos, sin, *, mask=None, is_causal: bool = True,
                    dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                    dropout_cols: Optional[int] = None, norm_eps: float = 1e-5,
                    shard: Shard = WHOLE) -> torch.Tensor:
    """One pre-norm attention sublayer: x + wo(attn(norm(x))). On a mesh,
    `dims` are this rank's heads when the weights are split, and cos/sin
    cover the rows its queries come from."""
    lp = shard.weights(lp)
    h = shard.column_input(rms_norm(x, lp["attention_norm"], norm_eps))
    qkv = mm(h, lp["wqkv"])
    if "wqkv_bias" in lp:
        qkv = qkv + lp["wqkv_bias"]
    q, k, v = split_qkv(qkv, dims)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q_start = None
    if shard.seq and not shard.split:
        q_start = shard.mesh.model * q.shape[1]
        k, v = gather_model_rs(k, shard.mesh, 1), gather_model_rs(v, shard.mesh, 1)
    att = sdpa(q, k, v, mask, is_causal=is_causal, dropout_rate=dropout_rate,
               dropout_seed=dropout_seed, dropout_cols=dropout_cols, q_start=q_start,
               window=shard.window)
    return x + shard.row_output(mm(att, lp["wo"]))


def ffn_block(x, lp: dict, norm_eps: float, shard: Shard = WHOLE) -> torch.Tensor:
    """One pre-norm FFN sublayer: x + swiglu(norm(x)), with separate w1/w3 or
    the fused w13 (ops/quant.py::fuse_decode_params); on a `shard` with split
    weights, this rank's half of the hidden width."""
    lp = shard.weights(lp)
    h = shard.column_input(rms_norm(x, lp["ffn_norm"], norm_eps))
    if "w13" in lp:
        a, b = mm(h, lp["w13"]).chunk(2, dim=-1)
        out = mm(F.silu(a) * b, lp["w2"])
    else:
        out = swiglu(h, lp["w1"], lp["w3"], lp["w2"])
    return x + shard.row_output(out)


def transformer_block(x, lp: dict, dims: AttnDims, cos, sin, *, mask=None,
                      is_causal: bool = True, dropout_rate: float = 0.0,
                      dropout_seed: Optional[int] = None, dropout_cols: Optional[int] = None,
                      norm_eps: float = 1e-5, shard: Shard = WHOLE) -> torch.Tensor:
    x = attention_block(x, lp, dims, cos, sin, mask=mask, is_causal=is_causal,
                        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                        dropout_cols=dropout_cols, norm_eps=norm_eps, shard=shard)
    return ffn_block(x, lp, norm_eps, shard=shard)
