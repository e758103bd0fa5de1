"""Mimi codec transformer, streaming: 8 pre-LayerNorm blocks with LayerScale,
split-half RoPE, exact GELU MLP, causal attention over a 250-slot sliding
window kept as a ring with per-slot absolute positions.

New tokens go to a small ring TAIL at a shared column; the ring is read-only
during a step and `flush_transformer_ring` scatters the tail into it (in
place). In kv8 mode the ring is int8 with per-vector scales: keys dequantize
through the logits, values through the probabilities. This attention is
plain PyTorch, as the JAX package computes it with XLA einsums.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.ops.quant import mm, qindex, quantize_kv


class TransformerRingState(NamedTuple):
    k: torch.Tensor  # [L, B, W, H, hd] post-RoPE keys (ring)
    v: torch.Tensor
    slot_pos: torch.Tensor  # [B, W] int32 absolute position per ring slot, -1 empty
    k_tail: torch.Tensor  # [L, B, Wt, H, hd]
    v_tail: torch.Tensor
    tail_abs: torch.Tensor  # [B, Wt] int32 absolute position per tail column, -1 empty
    t_phase: torch.Tensor  # [] int64 next tail write column
    pos: torch.Tensor  # [B] int32 next absolute position
    k_scale: Optional[torch.Tensor] = None  # [L, B, W, H] f32 (kv8)
    v_scale: Optional[torch.Tensor] = None

    @property
    def tail_len(self) -> int:
        return self.k_tail.shape[2]


def ring_state_init(cfg: MimiConfig, batch: int, dtype=torch.float32, tail_len: int = 64,
                    device=None) -> TransformerRingState:
    """`dtype=torch.int8` selects kv8 (int8 ring, bf16 tails)."""
    W = cfg.sliding_window
    H, hd, L = cfg.num_attention_heads, cfg.head_dim, cfg.num_hidden_layers
    kv8 = dtype == torch.int8
    tail_dtype = torch.bfloat16 if kv8 else dtype
    i32 = dict(dtype=torch.int32, device=device)
    return TransformerRingState(
        k=torch.zeros((L, batch, W, H, hd), dtype=dtype, device=device),
        v=torch.zeros((L, batch, W, H, hd), dtype=dtype, device=device),
        slot_pos=torch.full((batch, W), -1, **i32),
        k_tail=torch.zeros((L, batch, tail_len, H, hd), dtype=tail_dtype, device=device),
        v_tail=torch.zeros((L, batch, tail_len, H, hd), dtype=tail_dtype, device=device),
        tail_abs=torch.full((batch, tail_len), -1, **i32),
        t_phase=torch.zeros((), dtype=torch.int64, device=device),
        pos=torch.zeros((batch,), **i32),
        k_scale=torch.ones((L, batch, W, H), dtype=torch.float32, device=device) if kv8 else None,
        v_scale=torch.ones((L, batch, W, H), dtype=torch.float32, device=device) if kv8 else None,
    )


def flush_transformer_ring(state: TransformerRingState) -> TransformerRingState:
    """Scatter every valid tail entry into the ring (slot = abs_pos mod W),
    in place, and reset the tail."""
    W = state.k.shape[2]
    b_idx, w_idx = (state.tail_abs >= 0).nonzero(as_tuple=True)
    absp = state.tail_abs[b_idx, w_idx]
    slots = (absp % W).long()
    if state.k_scale is not None:
        kq, ks = quantize_kv(state.k_tail)
        vq, vs = quantize_kv(state.v_tail)
        state.k[:, b_idx, slots] = kq[:, b_idx, w_idx]
        state.v[:, b_idx, slots] = vq[:, b_idx, w_idx]
        state.k_scale[:, b_idx, slots] = ks[:, b_idx, w_idx]
        state.v_scale[:, b_idx, slots] = vs[:, b_idx, w_idx]
    else:
        state.k[:, b_idx, slots] = state.k_tail[:, b_idx, w_idx].to(state.k.dtype)
        state.v[:, b_idx, slots] = state.v_tail[:, b_idx, w_idx].to(state.v.dtype)
    slot_pos = state.slot_pos.clone()
    slot_pos[b_idx, slots] = absp
    return state._replace(
        slot_pos=slot_pos,
        tail_abs=torch.full_like(state.tail_abs, -1),
        t_phase=torch.zeros_like(state.t_phase),
    )


def _rope_half_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """Split-half RoPE tables [..., head_dim] in f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(float(theta), device=positions.device), exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_rope_half(x, cos, sin):
    """x [..., T, H, hd]; cos/sin [..., T, hd]."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[..., :, None, :] + rot * sin[..., :, None, :]).to(x.dtype)


def _layer_norm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w + b


def _qkv(h, lp, B, T, H, hd):
    if "wqkv" in lp:
        qkv = mm(h, lp["wqkv"])
        D = H * hd
        q, k, v = qkv[..., :D], qkv[..., D : 2 * D], qkv[..., 2 * D :]
    else:
        q, k, v = mm(h, lp["wq"]), mm(h, lp["wk"]), mm(h, lp["wv"])
    return q.reshape(B, T, H, hd), k.reshape(B, T, H, hd), v.reshape(B, T, H, hd)


def transformer_stream_step(params: dict, cfg: MimiConfig, state: TransformerRingState,
                            x: torch.Tensor):
    """x [B, T, d] (2 new tokens per 80 ms frame) -> (state', y [B, T, d]).
    Writes the tail in place."""
    B, T, _ = x.shape
    H, hd, W = cfg.num_attention_heads, cfg.head_dim, cfg.sliding_window
    scale = hd**-0.5
    abs_pos = state.pos[:, None] + torch.arange(T, device=x.device, dtype=torch.int32)[None, :]
    cos, sin = _rope_half_cos_sin(abs_pos, hd, cfg.rope_theta)
    cols = state.t_phase + torch.arange(T, device=x.device)
    tail_abs = state.tail_abs.clone()
    tail_abs.index_copy_(1, cols, abs_pos)
    q_abs = abs_pos[:, :, None]
    sp = state.slot_pos[:, None, :]
    ring_mask = ((sp >= 0) & (sp <= q_abs) & (sp > q_abs - W))[:, None]  # [B, 1, T, W]
    ta = tail_abs[:, None, :]
    tail_mask = ((ta >= 0) & (ta <= q_abs) & (ta > q_abs - W))[:, None]  # [B, 1, T, Wt]
    neg = -math.inf
    L = state.k.shape[0]
    h = x
    for l in range(L):
        lp = {k: qindex(v, l) for k, v in params["layers"].items()}
        hn = _layer_norm(h, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
        q, k, v = _qkv(hn, lp, B, T, H, hd)
        q = _apply_rope_half(q, cos, sin)
        k = _apply_rope_half(k, cos, sin)
        state.k_tail[l].index_copy_(1, cols, k.to(state.k_tail.dtype))
        state.v_tail[l].index_copy_(1, cols, v.to(state.v_tail.dtype))
        lr = torch.einsum("bqhd,bkhd->bhqk", q.float(), state.k[l].to(h.dtype).float()) * scale
        if state.k_scale is not None:
            lr = lr * state.k_scale[l].transpose(1, 2)[:, :, None, :]
        lt = torch.einsum("bqhd,bkhd->bhqk", q.float(), state.k_tail[l].float()) * scale
        logits = torch.cat([lr.masked_fill(~ring_mask, neg), lt.masked_fill(~tail_mask, neg)], dim=-1)
        probs = torch.softmax(logits, dim=-1)
        pr = probs[..., :W]
        if state.v_scale is not None:
            pr = pr * state.v_scale[l].transpose(1, 2)[:, :, None, :]
        pr = pr.to(h.dtype)
        pt = probs[..., W:].to(state.v_tail.dtype)
        att = torch.einsum("bhqk,bkhd->bqhd", pr, state.v[l].to(h.dtype)) + torch.einsum(
            "bhqk,bkhd->bqhd", pt, state.v_tail[l]
        )
        att = mm(att.reshape(B, T, H * hd).to(h.dtype), lp["wo"])
        h = h + att * lp["scale_attn"]
        hn = _layer_norm(h, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
        mlp = mm(F.gelu(mm(hn, lp["fc1"])), lp["fc2"])
        h = h + mlp * lp["scale_mlp"]
    new_state = state._replace(tail_abs=tail_abs, t_phase=state.t_phase + T, pos=state.pos + T)
    return new_state, h
