"""Single-query GQA decode attention: plain PyTorch versions and the CUDA
kernel (csrc/decode_attention.cu) behind one dispatch rule: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

Layouts are head-major, as the JAX package keeps them: q [B, H, hd], caches
[B, n_kv, S, hd], kv8 scales [B, n_kv, S].
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from smoltts_torch import ops
from smoltts_torch.ops import _build


def decode_attention_plain(
    q: torch.Tensor,  # [B, H, hd]
    k: torch.Tensor,  # [B, n_kv, S, hd] (compute dtype or int8)
    v: torch.Tensor,
    pos: torch.Tensor,  # [B] index of the newest valid cache entry
    k_scale: Optional[torch.Tensor] = None,  # [B, n_kv, S] kv8 scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Contiguous-cache attention masked to positions <= pos[b]. Returns
    [B, H*hd] in q's dtype."""
    B, H, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, n_kv, H // n_kv, hd).float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, k.to(q.dtype).float()) * (hd**-0.5)
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None]
    logits = logits.masked_fill(~valid[:, None, None, :], -math.inf)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, :]
    out = torch.einsum("bhgk,bhkd->bhgd", probs.to(q.dtype), v.to(q.dtype))
    return out.reshape(B, H * hd).to(q.dtype)


def decode_attention_tailed_plain(
    q: torch.Tensor,  # [B, H, hd]
    k_hist: torch.Tensor,  # [B, n_kv, Sh, hd] (compute dtype or int8)
    v_hist: torch.Tensor,
    k_tail: torch.Tensor,  # [B, n_kv, W, hd]
    v_tail: torch.Tensor,
    pos: torch.Tensor,  # [B]
    flushed: torch.Tensor,  # [B] history valid length
    tail_pos: torch.Tensor,  # [B, W] cache position per tail column (-1 empty)
    k_scale: Optional[torch.Tensor] = None,  # [B, n_kv, Sh]
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over history positions [0, flushed[b]) plus tail columns
    whose position lies in [flushed[b], pos[b]]. Returns [B, H*hd]."""
    B, H, hd = q.shape
    n_kv, Sh = k_hist.shape[1], k_hist.shape[2]
    qg = q.reshape(B, n_kv, H // n_kv, hd)
    scale = hd**-0.5
    lh = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_hist.to(q.dtype).float()) * scale
    if k_scale is not None:
        lh = lh * k_scale[:, :, None, :]
    lt = torch.einsum("bhgd,bhkd->bhgk", qg.float(), k_tail.float()) * scale
    mask_h = torch.arange(Sh, device=q.device)[None, :] < flushed[:, None]
    mask_t = (tail_pos >= flushed[:, None]) & (tail_pos <= pos[:, None]) & (tail_pos >= 0)
    lh = lh.masked_fill(~mask_h[:, None, None, :], -math.inf)
    lt = lt.masked_fill(~mask_t[:, None, None, :], -math.inf)
    probs = torch.softmax(torch.cat([lh, lt], dim=-1), dim=-1)
    ph = probs[..., :Sh]
    if v_scale is not None:
        ph = ph * v_scale[:, :, None, :]
    ph = ph.to(q.dtype)
    pt = probs[..., Sh:].to(v_tail.dtype)
    out = torch.einsum("bhgk,bhkd->bhgd", ph, v_hist.to(q.dtype)) + torch.einsum(
        "bhgk,bhkd->bhgd", pt, v_tail
    )
    return out.reshape(B, H * hd).to(q.dtype)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention kernel: {msg}")


def _kernel(q, k_hist, v_hist, k_tail, v_tail, pos, flushed, tail_pos, k_scale, v_scale):
    B, H, hd = q.shape
    _, n_kv, lim, _ = k_hist.shape
    W = k_tail.shape[2]
    dev = q.device
    _require(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype}")
    kv8 = k_scale is not None
    _require(kv8 == (v_scale is not None), "k_scale and v_scale come together")
    hist_dtype = torch.int8 if kv8 else q.dtype
    for name, t in (("k_hist", k_hist), ("v_hist", v_hist)):
        _require(t.dtype == hist_dtype, f"{name} dtype {t.dtype}, expected {hist_dtype}")
        _require(t.device == dev, f"{name} on {t.device}")
        _require(t.stride(3) == 1 and t.stride(2) == hd, f"{name} rows must be contiguous")
        _require(t.data_ptr() % 16 == 0 and (t.stride(0) * t.element_size()) % 16 == 0
                 and (t.stride(1) * t.element_size()) % 16 == 0, f"{name} not 16-byte aligned")
    _require(k_hist.stride() == v_hist.stride(), "k_hist and v_hist strides differ")
    for name, t in (("k_tail", k_tail), ("v_tail", v_tail)):
        _require(t.dtype == q.dtype and t.is_contiguous() and t.device == dev,
                 f"{name} must be contiguous {q.dtype} on {dev}")
        _require(t.shape == (B, n_kv, W, hd), f"{name} shape {tuple(t.shape)}")
    for name, t, shape in (("pos", pos, (B,)), ("flushed", flushed, (B,)),
                           ("tail_pos", tail_pos, (B, W))):
        _require(t.dtype == torch.int32 and t.is_contiguous() and t.device == dev
                 and tuple(t.shape) == shape, f"{name} must be contiguous int32 {shape} on {dev}")
    _require(tuple(k_hist.shape) == tuple(v_hist.shape) == (B, n_kv, lim, hd),
             f"history shape {tuple(k_hist.shape)}")
    _require(q.is_contiguous() and H % n_kv == 0 and H // n_kv <= 8, "q layout / group size")
    _require(hd % 16 == 0 and hd in (64, 128), f"head_dim {hd}")
    ssb = ssh = 0
    if kv8:
        _require(tuple(k_scale.shape) == tuple(v_scale.shape) == (B, n_kv, lim)
                 and k_scale.device == dev and v_scale.device == dev
                 and k_scale.stride() == v_scale.stride() and k_scale.stride(2) == 1
                 and k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32,
                 "kv8 scales must be f32 with unit stride over positions")
        ssb, ssh = k_scale.stride(0), k_scale.stride(1)
    out = torch.empty((B, H * hd), dtype=q.dtype, device=dev)
    lib = _build.lib()
    code = lib.smoltts_decode_attention(
        q.data_ptr(), k_hist.data_ptr(), v_hist.data_ptr(),
        k_scale.data_ptr() if kv8 else None, v_scale.data_ptr() if kv8 else None,
        k_hist.stride(0), k_hist.stride(1), ssb, ssh,
        k_tail.data_ptr(), v_tail.data_ptr(),
        pos.data_ptr(), flushed.data_ptr(), tail_pos.data_ptr(), out.data_ptr(),
        B, H, n_kv, hd, lim, W, _DTYPE_CODE[q.dtype], 1 if kv8 else 0,
        _build.stream_ptr(dev),
    )
    _build.check(code, "decode_attention")
    ops.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_tailed(
    q, k_hist, v_hist, k_tail, v_tail, pos, flushed, tail_pos, k_scale=None, v_scale=None
) -> torch.Tensor:
    """Tailed decode attention (see `decode_attention_tailed_plain`). The
    history may be a strided view such as `k[l, :, :, :lim]`; it is never
    copied."""
    if not q.is_cuda:
        return decode_attention_tailed_plain(
            q, k_hist, v_hist, k_tail, v_tail, pos, flushed, tail_pos, k_scale, v_scale
        )
    return _kernel(q, k_hist, v_hist, k_tail, v_tail, pos, flushed, tail_pos, k_scale, v_scale)


def decode_attention(q, k, v, pos, k_scale=None, v_scale=None) -> torch.Tensor:
    """Contiguous-cache attention (see `decode_attention_plain`); on the card
    the tailed kernel with an empty tail and flushed = pos + 1."""
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, pos, k_scale, v_scale)
    B, H, hd = q.shape
    n_kv = k.shape[1]
    empty = torch.empty((B, n_kv, 0, hd), dtype=q.dtype, device=q.device)
    pos32 = pos.to(torch.int32).contiguous()
    no_tail = torch.empty((B, 0), dtype=torch.int32, device=q.device)
    return _kernel(q, k, v, empty, empty, pos32, pos32 + 1, no_tail, k_scale, v_scale)
