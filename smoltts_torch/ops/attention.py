"""Single-query GQA decode attention: plain PyTorch versions and the CUDA
kernel (csrc/decode_attention.cu) behind one dispatch rule: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

Layouts are head-major, as the JAX package keeps them: q [B, H, hd], caches
[B, n_kv, S, hd], kv8 scales [B, n_kv, S].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

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
TUNED_HEAD_DIMS = (32, 64, 128)  # the tuned kernel's templates; any other head_dim takes the split route
MAX_TUNED_W = 32768  # tail columns compacted in shared memory; longer tails take the split route, masked
MAX_HEAD_DIM = 8192  # the split route keeps one head of q in shared memory
MAX_BATCH = 65535  # rows are a grid axis
ROUTE_LAUNCHES = {"tuned": 0, "split": 0}  # the kernel's launches by route (LAUNCHES counts them all)


class KernelPlan(NamedTuple):
    """What one call of the CUDA kernel is given: sizes, the dtype and
    history codes of `smoltts_decode_attention`, and which kernel serves it
    ("tuned": hd 32/64/128 over a history of the compute dtype or int8 and a
    tail of at most MAX_TUNED_W columns, one online-softmax pass; "split":
    the rest, f32 compute over a bf16 cache included, a statistics pass and a
    products pass that round as the plain version, with 16-byte loads where
    the rows allow them)."""

    B: int
    H: int
    n_kv: int
    hd: int
    lim: int
    W: int
    dtype: int
    hist: int
    route: str


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_attention kernel: {msg}")


def _aligned(t: torch.Tensor, *dims: int) -> bool:
    """The base pointer and the strides of `dims` are whole 16-byte units."""
    return t.data_ptr() % 16 == 0 and all((t.stride(d) * t.element_size()) % 16 == 0 for d in dims)


def kernel_plan(q, k_hist, v_hist, k_tail, v_tail, pos, flushed, tail_pos, k_scale=None,
                v_scale=None) -> KernelPlan:
    """Check the inputs of one kernel call and plan it, without a card (the
    CPU tests call it). Every shape `decode_attention_tailed_plain` takes is
    accepted: any batch, group size, tail length and head_dim (up to
    MAX_HEAD_DIM). Refused with ValueError: dtypes the kernel has no variant
    for, tensors on another device, rows that are not contiguous, and, on the
    tuned route, data that is not 16-byte aligned."""
    _require(q.dim() == 3, f"q shape {tuple(q.shape)}")
    B, H, hd = q.shape
    _require(k_hist.dim() == 4 and k_tail.dim() == 4, "caches must be [B, n_kv, S, hd]")
    n_kv, lim, W = k_hist.shape[1], k_hist.shape[2], k_tail.shape[2]
    dev = q.device
    _require(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype}")
    kv8 = k_scale is not None
    _require(kv8 == (v_scale is not None), "k_scale and v_scale come together")
    # the storage dtype (tail, same-dtype history): q's, or bf16 under f32 q
    store = k_tail.dtype
    _require(store == q.dtype or (q.dtype == torch.float32 and store == torch.bfloat16),
             f"tail dtype {store} under {q.dtype} compute")
    hist_dtype = torch.int8 if kv8 else store
    hist = (1 if kv8 else 0) + (0 if store == q.dtype else 2)
    route = "tuned" if hd in TUNED_HEAD_DIMS and hist <= 1 and W <= MAX_TUNED_W else "split"
    tuned = route == "tuned"
    _require(n_kv > 0 and H % n_kv == 0, f"{H} query heads over {n_kv} kv heads")
    _require(0 < hd <= MAX_HEAD_DIM, f"head_dim {hd} (at most {MAX_HEAD_DIM})")
    _require(B <= MAX_BATCH, f"batch {B} above {MAX_BATCH}")
    _require(q.is_contiguous() and (not tuned or _aligned(q)), "q must be contiguous"
             + (" and 16-byte aligned" if tuned else ""))
    for name, t in (("k_hist", k_hist), ("v_hist", v_hist)):
        _require(t.dtype == hist_dtype, f"{name} dtype {t.dtype}, expected {hist_dtype}")
        _require(t.device == dev, f"{name} on {t.device}")
        _require(t.stride(3) == 1 and t.stride(2) == hd, f"{name} rows must be contiguous")
        _require(not tuned or _aligned(t, 0, 1), f"{name} not 16-byte aligned")
    _require(k_hist.stride() == v_hist.stride(), "k_hist and v_hist strides differ")
    _require(tuple(k_hist.shape) == tuple(v_hist.shape) == (B, n_kv, lim, hd),
             f"history shape {tuple(k_hist.shape)}")
    for name, t in (("k_tail", k_tail), ("v_tail", v_tail)):
        _require(t.dtype == store and t.is_contiguous() and t.device == dev,
                 f"{name} must be contiguous {store} on {dev}")
        _require(t.shape == (B, n_kv, W, hd), f"{name} shape {tuple(t.shape)}")
        _require(not tuned or _aligned(t), f"{name} not 16-byte aligned")
    for name, t, shape in (("pos", pos, (B,)), ("flushed", flushed, (B,)),
                           ("tail_pos", tail_pos, (B, W))):
        _require(t.dtype == torch.int32 and t.is_contiguous() and t.device == dev
                 and tuple(t.shape) == shape, f"{name} must be contiguous int32 {shape} on {dev}")
    if kv8:
        _require(tuple(k_scale.shape) == tuple(v_scale.shape) == (B, n_kv, lim)
                 and k_scale.device == dev and v_scale.device == dev
                 and k_scale.stride() == v_scale.stride() and k_scale.stride(2) == 1
                 and k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32,
                 "kv8 scales must be f32 with unit stride over positions")
    return KernelPlan(B, H, n_kv, hd, lim, W, _DTYPE_CODE[q.dtype], hist, route)


def _kernel(q, k_hist, v_hist, k_tail, v_tail, pos, flushed, tail_pos, k_scale, v_scale):
    plan = kernel_plan(q, k_hist, v_hist, k_tail, v_tail, pos, flushed, tail_pos, k_scale,
                       v_scale)
    kv8 = k_scale is not None
    ssb, ssh = (k_scale.stride(0), k_scale.stride(1)) if kv8 else (0, 0)
    out = torch.empty((plan.B, plan.H * plan.hd), dtype=q.dtype, device=q.device)
    lib = _build.lib()
    code = lib.smoltts_decode_attention(
        q.data_ptr(), k_hist.data_ptr(), v_hist.data_ptr(),
        k_scale.data_ptr() if kv8 else None, v_scale.data_ptr() if kv8 else None,
        k_hist.stride(0), k_hist.stride(1), ssb, ssh,
        k_tail.data_ptr(), v_tail.data_ptr(),
        pos.data_ptr(), flushed.data_ptr(), tail_pos.data_ptr(), out.data_ptr(),
        plan.B, plan.H, plan.n_kv, plan.hd, plan.lim, plan.W, plan.dtype, plan.hist,
        _build.stream_ptr(q.device),
    )
    _build.check(code, "decode_attention")
    ops.LAUNCHES["decode_attention"] += 1
    ROUTE_LAUNCHES[plan.route] += 1
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
    store = q.dtype if k.dtype == torch.int8 else k.dtype
    empty = torch.empty((B, n_kv, 0, hd), dtype=store, device=q.device)
    pos32 = pos.to(torch.int32).contiguous()
    no_tail = torch.empty((B, 0), dtype=torch.int32, device=q.device)
    return _kernel(q, k, v, empty, empty, pos32, pos32 + 1, no_tail, k_scale, v_scale)
