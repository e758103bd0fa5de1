"""KV-cached DualAR decoding: prefill and the per-frame step.

The KV cache is split into a large HISTORY (`k`/`v`, int8 with per-vector
scales in kv8 mode) and a small ring TAIL (`k_tail`/`v_tail`) that the frame
step writes at a shared column `phase`; `flush_kv` consolidates the tail into
the history at most every W frames. Unlike the JAX package, the port writes
the tail and, at flush, the whole state IN PLACE: the state passed to a
step is consumed and the returned state shares its large buffers
(lm/graph.py steps every leaf in place, for a CUDA graph).

Per frame, the slow trunk runs the decode-attention kernel in every layer
(ops/attention.py), the slow-token site (window, sampling, finished rows)
is one launch of the sampling kernel (ops/sampling.py), and the codebook
levels go through the fast-loop kernel (ops/fast_loop.py); on the CPU each
takes its plain version.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig
from smoltts_torch.lm.samplers import GenerationSettings
from smoltts_torch.models.dual_ar import embed_merge, slow_dims, token_head
from smoltts_torch.models.layers import AttnDims, apply_rope, rms_norm, rope_cos_sin, split_qkv
from smoltts_torch.ops import attention as attn_ops
from smoltts_torch.ops import fast_loop as fast_ops
from smoltts_torch.ops import sampling as sampling_ops
from smoltts_torch.ops.fast_loop import layer_slices, mlp
from smoltts_torch.ops.quant import mm, quantize_kv
from smoltts_torch.parallel.mesh import chunk_ranges, kv_head_range
from smoltts_torch.tokenizer import TokenConfig


class DecodeState(NamedTuple):
    """Per-slot decoding state for B concurrent streams (field names as in
    the JAX package)."""

    k: torch.Tensor  # [n_layer, B, n_kv_head, S, head_dim] history
    v: torch.Tensor
    k_tail: torch.Tensor  # [n_layer, B, n_kv_head, W, head_dim] ring tail
    v_tail: torch.Tensor
    tail_pos: torch.Tensor  # [B, W] int32, cache position per tail column (-1 empty)
    flushed: torch.Tensor  # [B] int32, history valid length
    phase: torch.Tensor  # [] int64, next tail write column
    pos: torch.Tensor  # [B] int32, number of cached tokens
    prev_tokens: torch.Tensor  # [B, num_rows] int32, frame fed to the next step
    finished: torch.Tensor  # [B] bool
    k_scale: Optional[torch.Tensor] = None  # [n_layer, B, n_kv_head, S] f32 (kv8)
    v_scale: Optional[torch.Tensor] = None

    @property
    def tail_len(self) -> int:
        return self.k_tail.shape[3]


# The leaves `prefill` and `decode_frame` give anew (they write the history
# and the ring tails in place): each slot's history length, position, next
# input frame and finished flag, then the ring's column map and write column.
SLOT_LEAVES = ("flushed", "pos", "prev_tokens", "finished")
RENEWED_LEAVES = SLOT_LEAVES + ("tail_pos", "phase")


class FrameOutput(NamedTuple):
    tokens: torch.Tensor  # [B, num_rows] int32, next slow-model input frame
    audio_codes: torch.Tensor  # [B, num_codebooks] int32
    slow_token: torch.Tensor  # [B] int32
    is_audio: torch.Tensor  # [B] bool
    finished: torch.Tensor  # [B] bool


def init_decode_state(
    cfg: DualARConfig,
    batch_size: int,
    max_seq_len: Optional[int] = None,
    dtype=torch.bfloat16,
    tail_len: int = 128,
    device=None,
    mesh=None,
) -> DecodeState:
    """`dtype=torch.int8` selects kv8: int8 history + f32 per-vector scales,
    bf16 tails. `device=None` means CUDA. On a `mesh` (parallel/mesh.py) it
    is this rank's state: batch_size / n_data slots and the kv heads of its
    model coordinate."""
    dev = resolve_device(device)
    S = max_seq_len or cfg.max_seq_len
    kv8 = dtype == torch.int8
    tail_dtype = torch.bfloat16 if kv8 else dtype
    n_kv = cfg.n_local_heads
    if mesh is not None:
        (b0, b1), = chunk_ranges(batch_size, mesh.n_data, mesh.data, "slots")
        kv0, kv1 = kv_head_range(n_kv, mesh.n_model, mesh.model)
        batch_size, n_kv = b1 - b0, kv1 - kv0
    kv_shape = (cfg.n_layer, batch_size, n_kv, S, cfg.head_dim)
    tail_shape = (cfg.n_layer, batch_size, n_kv, tail_len, cfg.head_dim)
    i32 = dict(dtype=torch.int32, device=dev)
    return DecodeState(
        k=torch.zeros(kv_shape, dtype=dtype, device=dev),
        v=torch.zeros(kv_shape, dtype=dtype, device=dev),
        k_tail=torch.zeros(tail_shape, dtype=tail_dtype, device=dev),
        v_tail=torch.zeros(tail_shape, dtype=tail_dtype, device=dev),
        tail_pos=torch.full((batch_size, tail_len), -1, **i32),
        flushed=torch.zeros((batch_size,), **i32),
        phase=torch.zeros((), dtype=torch.int64, device=dev),
        pos=torch.zeros((batch_size,), **i32),
        prev_tokens=torch.zeros((batch_size, cfg.num_rows), **i32),
        finished=torch.zeros((batch_size,), dtype=torch.bool, device=dev),
        k_scale=torch.ones(kv_shape[:-1], dtype=torch.float32, device=dev) if kv8 else None,
        v_scale=torch.ones(kv_shape[:-1], dtype=torch.float32, device=dev) if kv8 else None,
    )


def reset_decode_state(state: DecodeState) -> DecodeState:
    """Every slot back to `init_decode_state`'s values, in place; returns
    `state`."""
    for t in (state.k, state.v, state.k_tail, state.v_tail, state.flushed, state.phase,
              state.pos, state.prev_tokens, state.finished):
        t.zero_()
    state.tail_pos.fill_(-1)
    for t in (state.k_scale, state.v_scale):
        if t is not None:
            t.fill_(1.0)
    return state


def scatter_decode_state(big: DecodeState, small: DecodeState,
                         idx: torch.Tensor) -> DecodeState:
    """Write an n-slot state fresh from `prefill` into the slots `idx` (an
    index tensor on the state's device) of a B-slot state, in place on
    `big`: the history and each slot's leaves. The slots' ring-tail entries
    are emptied: the prompt's K/V went straight to the history."""
    for b, s in ((big.k, small.k), (big.v, small.v), (big.k_scale, small.k_scale),
                 (big.v_scale, small.v_scale)):
        if b is not None:
            b.index_copy_(1, idx, s)
    big.tail_pos.index_fill_(0, idx, -1)
    for name in SLOT_LEAVES:
        getattr(big, name).index_copy_(0, idx, getattr(small, name))
    return big


def flush_kv(state: DecodeState) -> DecodeState:
    """Scatter every valid tail entry to its cache position (quantizing in
    kv8 mode) and reset the ring, all in place: the returned state holds
    `state`'s own tensors. An entry whose position is S or more is dropped,
    as the JAX package's scatter drops it (a freed engine slot keeps
    advancing past S)."""
    S = state.k.shape[3]
    valid = (
        (state.tail_pos >= 0)
        & (state.tail_pos >= state.flushed[:, None])
        & (state.tail_pos < state.pos[:, None])
        & (state.tail_pos < S)
    )
    b_idx, w_idx = valid.nonzero(as_tuple=True)
    dst = state.tail_pos[b_idx, w_idx].long()
    if state.k_scale is not None:
        kq, ks = quantize_kv(state.k_tail)
        vq, vs = quantize_kv(state.v_tail)
        state.k[:, b_idx, :, dst] = kq[:, b_idx, :, w_idx]
        state.v[:, b_idx, :, dst] = vq[:, b_idx, :, w_idx]
        state.k_scale[:, b_idx, :, dst] = ks[:, b_idx, :, w_idx]
        state.v_scale[:, b_idx, :, dst] = vs[:, b_idx, :, w_idx]
    else:
        state.k[:, b_idx, :, dst] = state.k_tail[:, b_idx, :, w_idx].to(state.k.dtype)
        state.v[:, b_idx, :, dst] = state.v_tail[:, b_idx, :, w_idx].to(state.v.dtype)
    state.tail_pos.fill_(-1)
    state.flushed.copy_(state.pos)
    state.phase.zero_()
    return state


def _write_kv(cache, new, pos, scale_cache=None):
    """Write new [B, T, H, hd] into cache [B, H, S, hd] at positions
    pos[b]..pos[b]+T-1 (quantized per vector when `scale_cache` is given).
    In place. Past the cache's end it does what the JAX package does: a
    single token at position S or more is dropped (`.at[].set`), a block of
    T > 1 starts at most at S - T (`dynamic_update_slice` clamps)."""
    B, T = new.shape[:2]
    S = cache.shape[2]
    if T > S:
        raise ValueError(f"{T} new positions do not fit a cache of {S}")
    pos = pos.long()
    rows = torch.arange(B, device=new.device)[:, None]
    start = pos.clamp(0, S - T) if T > 1 else pos.clamp(max=S - 1)
    cols = start[:, None] + torch.arange(T, device=new.device)[None, :]
    if scale_cache is not None:
        q, s = quantize_kv(new)  # [B, T, H, hd], [B, T, H]
    else:
        q, s = new.to(cache.dtype), None
    if T == 1:  # a dropped row writes back what its last column holds
        keep = (pos < S)[:, None, None]
        q = torch.where(keep[..., None], q, cache[rows, :, cols])
        if s is not None:
            s = torch.where(keep, s, scale_cache[rows, :, cols])
    cache[rows, :, cols] = q
    if s is not None:
        scale_cache[rows, :, cols] = s


def _cached_sdpa_multi(q, k, v, valid_bqk):
    """Multi-query attention over head-major k/v [B, n_kv, Tk, hd] with a
    per-query mask [B, Tq, Tk] (prefill)."""
    B, Tq, n_head, hd = q.shape
    n_kv = k.shape[1]
    qg = q.reshape(B, Tq, n_kv, n_head // n_kv, hd)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), k.float()) * (hd**-0.5)
    logits = logits.masked_fill(~valid_bqk[:, None, None], -math.inf)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs, v)
    return out.reshape(B, Tq, n_head * hd)


def _row_parallel(y, mesh):
    """A row-parallel product's partial sum completed over the model axis."""
    return y if mesh is None else mesh.model_sum(y)


def _decode_trunk(layer_params, x, k_cache, v_cache, pos, dims: AttnDims, cos, sin, *,
                  norm_eps, k_scale=None, v_scale=None, mesh=None):
    """Prefill trunk over T new tokens on fresh slots: writes k/v at
    pos..pos+T-1 and attends causally over the T tokens themselves (T = 1
    attends over the cache through the decode-attention kernel). On a
    tensor-parallel `mesh` the model axis sums after wo and after w2."""
    B, T, _ = x.shape
    h = x
    for l, lp in enumerate(layer_slices(layer_params, k_cache.shape[0])):
        hn = rms_norm(h, lp["attention_norm"], norm_eps)
        qkv = mm(hn, lp["wqkv"])
        if "wqkv_bias" in lp:
            qkv = qkv + lp["wqkv_bias"]
        q, k, v = split_qkv(qkv, dims)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        ksc = None if k_scale is None else k_scale[l]
        vsc = None if v_scale is None else v_scale[l]
        _write_kv(k_cache[l], k, pos, ksc)
        _write_kv(v_cache[l], v, pos, vsc)
        if T > 1:
            t = torch.arange(T, device=x.device)
            causal = (t[:, None] >= t[None, :]).expand(B, T, T)
            att = _cached_sdpa_multi(q, k.transpose(1, 2), v.transpose(1, 2), causal)
        else:
            att = attn_ops.decode_attention(
                q[:, 0].contiguous(), k_cache[l], v_cache[l], pos, k_scale=ksc, v_scale=vsc
            )[:, None, :]
        h = h + _row_parallel(mm(att, lp["wo"]), mesh)
        hn = rms_norm(h, lp["ffn_norm"], norm_eps)
        h = h + _row_parallel(mlp(hn, lp), mesh)
    return h


def _decode_trunk_tailed(layer_params, x, state: DecodeState, tail_pos, dims: AttnDims, cos,
                         sin, *, norm_eps, attend_limit=None, mesh=None):
    """Single-token trunk over the split cache: the history is read-only,
    each layer's k/v go to the tail at column `state.phase` (in place)."""
    L, S = state.k.shape[0], state.k.shape[3]
    lim = S if attend_limit is None else min(attend_limit, S)
    col = state.phase.reshape(1)
    h = x
    for l, lp in enumerate(layer_slices(layer_params, L)):
        hn = rms_norm(h, lp["attention_norm"], norm_eps)
        qkv = mm(hn, lp["wqkv"])
        if "wqkv_bias" in lp:
            qkv = qkv + lp["wqkv_bias"]
        q, k, v = split_qkv(qkv, dims)  # [B, 1, H, hd]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        state.k_tail[l].index_copy_(2, col, k.transpose(1, 2).to(state.k_tail.dtype))
        state.v_tail[l].index_copy_(2, col, v.transpose(1, 2).to(state.v_tail.dtype))
        att = attn_ops.decode_attention_tailed(
            q[:, 0].contiguous(),
            state.k[l, :, :, :lim],
            state.v[l, :, :, :lim],
            state.k_tail[l],
            state.v_tail[l],
            state.pos,
            state.flushed,
            tail_pos,
            k_scale=None if state.k_scale is None else state.k_scale[l, :, :, :lim],
            v_scale=None if state.v_scale is None else state.v_scale[l, :, :, :lim],
        )[:, None, :]
        h = h + _row_parallel(mm(att, lp["wo"]), mesh)
        hn = rms_norm(h, lp["ffn_norm"], norm_eps)
        h = h + _row_parallel(mlp(hn, lp), mesh)
    return h


def _fast_micro_loop(params, cfg: DualARConfig, hidden, generator, settings) -> torch.Tensor:
    """[B, n] codes: the fused fast loop for supported trees (a kernel on
    the card), the plain loop otherwise."""
    if fast_ops.supports_fused_fast(cfg, params):
        return fast_ops.fused_fast_micro_loop(params, cfg, hidden, generator, settings)
    return fast_ops.fast_micro_loop_plain(params, cfg, hidden, generator, settings)


def _frame_from_hidden(params, cfg: DualARConfig, token_cfg: TokenConfig, hidden,
                       token_logits, finished, generator, settings: GenerationSettings):
    """Sample the semantic token and the codebook levels; assemble the next
    frame."""
    sem_end = token_cfg.semantic_end_id or token_cfg.semantic_start_id
    slow_token = sampling_ops.sample_slow_token(token_logits, generator, settings, token_cfg,
                                                finished)
    codes = _fast_micro_loop(params, cfg, hidden, generator, settings)
    frame = torch.cat([slow_token[:, None], codes], dim=1)
    is_semantic = (slow_token >= token_cfg.semantic_start_id) & (slow_token <= sem_end)
    if cfg.duplicate_code_0:
        audio_codes = codes
    else:
        sem_code = slow_token - token_cfg.semantic_start_id
        audio_codes = torch.cat([sem_code[:, None], codes], dim=1)
    return FrameOutput(
        tokens=frame,
        audio_codes=audio_codes,
        slow_token=slow_token,
        is_audio=is_semantic & ~finished,
        finished=finished | (slow_token == token_cfg.im_end_id),
    )


def prefill(params, cfg: DualARConfig, token_cfg: TokenConfig, settings, state: DecodeState,
            prompt: torch.Tensor, prompt_len: torch.Tensor, generator, mesh=None):
    """Process the prompt [B, num_rows, T] (right-padded; true lengths
    `prompt_len`), fill the history, and emit the first frame. Requires
    fresh slots (pos == 0). `mesh`: the parallel/mesh.py mesh whose model
    axis splits `params` and the state's kv heads (parallel/serving.py);
    None for a whole tree."""
    B, R, T = prompt.shape
    sem_end = token_cfg.semantic_end_id or token_cfg.semantic_start_id
    x = embed_merge(params, cfg, prompt, embed_mask_mode="semantic_range",
                    semantic_start_id=token_cfg.semantic_start_id, semantic_end_id=sem_end,
                    mesh=mesh)
    positions = state.pos[:, None] + torch.arange(T, device=prompt.device)[None, :]
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_base)
    h = _decode_trunk(params["layers"], x, state.k, state.v, state.pos, slow_dims(cfg, mesh), cos,
                      sin, norm_eps=cfg.norm_eps, k_scale=state.k_scale, v_scale=state.v_scale,
                      mesh=mesh)
    prompt_len = prompt_len.to(torch.int32)
    h_last = h[torch.arange(B, device=h.device), (prompt_len - 1).long()]
    token_logits = token_head(params, cfg, h_last[:, None, :], mesh)[:, 0]
    out = _frame_from_hidden(params, cfg, token_cfg, h_last, token_logits, state.finished,
                             generator, settings)
    new_state = state._replace(
        tail_pos=torch.full_like(state.tail_pos, -1),
        flushed=state.pos + prompt_len,
        phase=torch.zeros_like(state.phase),
        pos=state.pos + prompt_len,
        prev_tokens=out.tokens,
        finished=out.finished,
    )
    return new_state, out


def decode_frame(params, cfg: DualARConfig, token_cfg: TokenConfig, settings,
                 state: DecodeState, generator, attend_limit: Optional[int] = None, mesh=None):
    """One 80 ms frame for every slot: slow step + fast micro-loop.
    `attend_limit` bounds attention reads; requires max(pos) < attend_limit.
    `mesh` as in `prefill`."""
    sem_end = token_cfg.semantic_end_id or token_cfg.semantic_start_id
    x = embed_merge(params, cfg, state.prev_tokens[:, :, None], embed_mask_mode="semantic_range",
                    semantic_start_id=token_cfg.semantic_start_id, semantic_end_id=sem_end,
                    mesh=mesh)
    cos, sin = rope_cos_sin(state.pos[:, None], cfg.head_dim, cfg.rope_base)
    tail_pos = state.tail_pos.clone()
    tail_pos.index_copy_(1, state.phase.reshape(1), state.pos[:, None])
    state = state._replace(tail_pos=tail_pos)
    h = _decode_trunk_tailed(params["layers"], x, state, tail_pos, slow_dims(cfg, mesh), cos, sin,
                             norm_eps=cfg.norm_eps, attend_limit=attend_limit, mesh=mesh)
    h_last = h[:, 0]
    token_logits = token_head(params, cfg, h_last[:, None, :], mesh)[:, 0]
    out = _frame_from_hidden(params, cfg, token_cfg, h_last, token_logits, state.finished,
                             generator, settings)
    new_state = state._replace(
        phase=(state.phase + 1) % state.tail_len,
        pos=state.pos + 1,
        prev_tokens=out.tokens,
        finished=out.finished,
    )
    return new_state, out


def make_decode_fns(cfg: DualARConfig, token_cfg: TokenConfig, settings: GenerationSettings):
    """(prefill_fn, decode_fn) closures over the config, as `FrameGenerator`
    takes them: prefill_fn(params, state, prompt, prompt_len, generator) and
    decode_fn(params, state, generator), each -> (state', FrameOutput)."""

    @torch.no_grad()
    def prefill_fn(params, state, prompt, prompt_len, generator):
        return prefill(params, cfg, token_cfg, settings, state, prompt, prompt_len, generator)

    @torch.no_grad()
    def decode_fn(params, state, generator):
        return decode_frame(params, cfg, token_cfg, settings, state, generator)

    return prefill_fn, decode_fn
