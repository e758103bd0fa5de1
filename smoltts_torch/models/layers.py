"""Transformer building blocks for decode: RMSNorm in f32, traditional
(interleaved-pair) RoPE with bf16-rounded cos/sin tables, fused-qkv split,
SwiGLU. Linear weights are [in, out] (x @ W)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

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
