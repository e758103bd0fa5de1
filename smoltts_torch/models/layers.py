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
    inv_freq = 1.0 / torch.pow(torch.tensor(float(base), dtype=torch.float32, device=positions.device), exponent)
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
) -> torch.Tensor:
    """Causal GQA attention with an online softmax over K blocks: never
    builds the [B, H, T, T] logits. Each q-block is checkpointed, so backward
    recomputes its block logits. Dropout per block from
    fold_in(seed, qi * NK + kj); the normalizer uses undropped probabilities
    and the 1/(1-p) scale applies to the block output."""
    B, T, H, hd = q.shape
    n_kv = k.shape[2]
    group = H // n_kv
    scale = hd**-0.5
    NQ, NK = T // block_q, T // block_k
    qg = q.reshape(B, T, n_kv, group, hd)
    use_dropout = dropout_rate > 0.0 and dropout_seed is not None
    dev = q.device

    def one_q_block(qi, qb, k, v):
        m = torch.full((B, n_kv, group, block_q), -float("inf"), device=dev)
        l = torch.zeros((B, n_kv, group, block_q), device=dev)
        acc = torch.zeros((B, n_kv, group, block_q, hd), device=dev)
        n_kb = (qi * block_q) // block_k + (block_q + block_k - 1) // block_k
        q_idx = qi * block_q + torch.arange(block_q, device=dev)
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
                keep = dropout_keep(fold_in(dropout_seed, qi * NK + kj), dropout_rate,
                                    p.shape, dev)
                p16 = p16.masked_fill(~keep, 0)
            acc = acc * corr[..., None] + _dot32("bhgqk,bkhd->bhgqd", p16, vb)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        if use_dropout:
            out = out * (1.0 / (1.0 - dropout_rate))
        return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # [B, bq, n_kv, g, hd]

    outs = []
    for qi in range(NQ):
        qb = qg[:, qi * block_q : (qi + 1) * block_q]
        outs.append(remat_call(lambda qb, k, v, qi=qi: one_q_block(qi, qb, k, v), qb, k, v))
    return torch.cat(outs, dim=1).reshape(B, T, H * hd)


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
) -> torch.Tensor:
    """GQA attention. q [B, Tq, H, hd]; k/v [B, Tk, n_kv, hd]; mask bool
    [*, Tq, Tk] (True = attend). Softmax in f32, fully masked rows give 0.

    dropout_cols: when every attendable key of a row sits at a distinct
    column class mod `dropout_cols` (the folded fast trunk), draw keep bits
    for that many columns and expand them by col % dropout_cols.

    Long causal self-attention with no mask (causal, T >= 512, T % 256 == 0)
    takes `sdpa_blockwise`, under exactly the JAX package's condition, since
    the two forms round differently."""
    if (
        is_causal
        and mask is None
        and q.shape[1] == k.shape[1]
        and q.shape[1] >= 512
        and q.shape[1] % 256 == 0
    ):
        return sdpa_blockwise(q, k, v, dropout_rate=dropout_rate, dropout_seed=dropout_seed)
    B, Tq, n_head, hd = q.shape
    n_kv, Tk = k.shape[2], k.shape[1]
    qg = q.reshape(B, Tq, n_kv, n_head // n_kv, hd)
    logits = _dot32("bqhgd,bkhd->bhgqk", qg, k) * (hd**-0.5)  # [B, n_kv, g, Tq, Tk]
    if is_causal:
        causal = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device).tril(Tk - Tq)
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
        if dropout_cols is not None and dropout_cols < Tk:
            keep = dropout_keep(dropout_seed, dropout_rate, probs.shape[:-1] + (dropout_cols,),
                                q.device)
            keep = keep[..., torch.arange(Tk, device=q.device) % dropout_cols]
        else:
            keep = dropout_keep(dropout_seed, dropout_rate, probs.shape, q.device)
        probs = probs.masked_fill(~keep, 0)
    out = _dot32("bhgqk,bkhd->bqhgd", probs, v)
    if use_dropout:
        out = out * (1.0 / (1.0 - dropout_rate))
    return out.to(v.dtype).reshape(B, Tq, n_head * hd)


def attention_block(x, lp: dict, dims: AttnDims, cos, sin, *, mask=None, is_causal: bool = True,
                    dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                    dropout_cols: Optional[int] = None, norm_eps: float = 1e-5) -> torch.Tensor:
    """One pre-norm attention sublayer: x + wo(attn(norm(x)))."""
    h = rms_norm(x, lp["attention_norm"], norm_eps)
    qkv = mm(h, lp["wqkv"])
    if "wqkv_bias" in lp:
        qkv = qkv + lp["wqkv_bias"]
    q, k, v = split_qkv(qkv, dims)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    att = sdpa(q, k, v, mask, is_causal=is_causal, dropout_rate=dropout_rate,
               dropout_seed=dropout_seed, dropout_cols=dropout_cols)
    return x + mm(att, lp["wo"])


def ffn_block(x, lp: dict, norm_eps: float) -> torch.Tensor:
    """One pre-norm FFN sublayer: x + swiglu(norm(x)), with separate w1/w3 or
    the fused w13 (ops/quant.py::fuse_decode_params)."""
    h = rms_norm(x, lp["ffn_norm"], norm_eps)
    if "w13" in lp:
        a, b = mm(h, lp["w13"]).chunk(2, dim=-1)
        return x + mm(F.silu(a) * b, lp["w2"])
    return x + swiglu(h, lp["w1"], lp["w3"], lp["w2"])


def transformer_block(x, lp: dict, dims: AttnDims, cos, sin, *, mask=None,
                      is_causal: bool = True, dropout_rate: float = 0.0,
                      dropout_seed: Optional[int] = None, dropout_cols: Optional[int] = None,
                      norm_eps: float = 1e-5) -> torch.Tensor:
    x = attention_block(x, lp, dims, cos, sin, mask=mask, is_causal=is_causal,
                        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                        dropout_cols=dropout_cols, norm_eps=norm_eps)
    return ffn_block(x, lp, norm_eps)
