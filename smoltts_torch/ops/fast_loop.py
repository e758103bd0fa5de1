"""The fast (depth) transformer micro-loop: one frame's codebook levels.

`fast_micro_loop_plain` is the contract (the JAX package's
`lm/decode.py::_fast_micro_loop`) in plain PyTorch. `fused_fast_micro_loop`
runs it as the CUDA kernel sequence of csrc/fast_loop.cu for a CUDA tensor
and as the plain loop for a CPU tensor; it takes the trees that
`supports_fused_fast` accepts: the released DualAR family (depthwise_wte,
depthwise_output, duplicate_code_0, no fast qkv bias) with an int8 fast
trunk and head, w1/w3 or fused w13. The kernel also needs every width
(dim, intermediate, codebook, qkv) to be a multiple of 16, and raises
otherwise.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch
import torch.nn.functional as F

from smoltts_torch import ops
from smoltts_torch.config import DualARConfig
from smoltts_torch.lm.samplers import sample_token
from smoltts_torch.models.dual_ar import fast_dims, project_fast_in
from smoltts_torch.models.layers import apply_rope, rms_norm, rope_cos_sin, split_qkv, swiglu
from smoltts_torch.ops import _build
from smoltts_torch.ops.quant import QTensor, mm, qindex
from smoltts_torch.ops.sampling import philox_seed


def supports_fused_fast(cfg: DualARConfig, params: dict) -> bool:
    lp = params.get("fast_layers", {})
    ffn_ok = ("w1" in lp and isinstance(lp["w1"], QTensor)) or (
        "w13" in lp and isinstance(lp["w13"], QTensor)
    )
    return bool(
        cfg.depthwise_wte
        and cfg.depthwise_output
        and cfg.duplicate_code_0
        and not cfg.fast_attention_qkv_bias
        and isinstance(lp.get("wqkv"), QTensor)
        and ffn_ok
        and isinstance(params.get("fast_output"), QTensor)
        and cfg.fast_n_head % cfg.fast_n_local_heads == 0
        and cfg.fast_head_dim % 2 == 0
    )


def mlp(hn: torch.Tensor, lp: dict) -> torch.Tensor:
    """SwiGLU that takes the fused gate/up weight when present."""
    if "w13" in lp:
        a, b = torch.chunk(mm(hn, lp["w13"]), 2, dim=-1)
        return mm(F.silu(a) * b, lp["w2"])
    return swiglu(hn, lp["w1"], lp["w3"], lp["w2"])


def layer_slices(stacked: dict, n_layer: int):
    """Per-layer views of a stacked trunk (QTensor leaves included)."""
    return [{k: qindex(v, l) for k, v in stacked.items()} for l in range(n_layer)]


def require_whole_fast_trunk(params, cfg: DualARConfig) -> None:
    """Raise unless the fast trunk, its head and its table are as wide as
    `cfg` says. The fast loop has no collective inside it, so a trunk split
    over a model axis would give partial sums silently; the serving layout
    (parallel/serving.py) keeps these leaves whole on every rank."""
    lp = params["fast_layers"]
    hd = cfg.fast_head_dim
    widths = [("wqkv", lp["wqkv"], -1, (cfg.fast_n_head + 2 * cfg.fast_n_local_heads) * hd),
              ("wo", lp["wo"], -2, cfg.fast_n_head * hd),
              ("w2", lp["w2"], -2, cfg.fast_intermediate_size),
              ("fast_output", params["fast_output"], -1, cfg.codebook_size),
              ("fast_embeddings", params["fast_embeddings"], 0, cfg.fast_embedding_rows)]
    if "w13" in lp:
        widths.append(("w13", lp["w13"], -1, 2 * cfg.fast_intermediate_size))
    else:
        widths += [(k, lp[k], -1, cfg.fast_intermediate_size) for k in ("w1", "w3")]
    for name, w, axis, want in widths:
        got = (w.q if isinstance(w, QTensor) else w).shape[axis]
        if got != want:
            raise ValueError(f"fast micro-loop: {name} is {got} wide on axis {axis}, the config "
                             f"says {want}; the fast trunk must be whole on every rank")


def fast_micro_loop_plain(params, cfg: DualARConfig, hidden, generator, settings) -> torch.Tensor:
    """Autoregressively pick the codebook levels for one frame. hidden is
    [B, dim] (pre-norm slow output); returns [B, n] int32 codes."""
    require_whole_fast_trunk(params, cfg)
    B = hidden.shape[0]
    n = cfg.max_fast_seqlen
    fdims = fast_dims(cfg)
    fcos, fsin = rope_cos_sin(torch.arange(n, device=hidden.device), cfg.fast_head_dim, cfg.rope_base)
    x = project_fast_in(params, cfg, hidden)[:, None, :]
    kv_shape = (cfg.n_fast_layer, B, cfg.fast_n_local_heads, n, cfg.fast_head_dim)
    kc = torch.zeros(kv_shape, dtype=x.dtype, device=x.device)
    vc = torch.zeros(kv_shape, dtype=x.dtype, device=x.device)
    group = fdims.n_head // fdims.n_kv_head
    layers = layer_slices(params["fast_layers"], cfg.n_fast_layer)
    fast_temp = settings.default_fast_temp
    codes = []
    for i in range(n):
        cos_i, sin_i = fcos[i][None, None], fsin[i][None, None]
        h = x
        for l, lp in enumerate(layers):
            hn = rms_norm(h, lp["attention_norm"], cfg.norm_eps)
            qkv = mm(hn, lp["wqkv"])
            if "wqkv_bias" in lp:
                qkv = qkv + lp["wqkv_bias"]
            q, k, v = split_qkv(qkv, fdims)  # [B, 1, H, hd]
            q = apply_rope(q, cos_i, sin_i)
            k = apply_rope(k, cos_i, sin_i)
            kc[l, :, :, i] = k[:, 0].to(kc.dtype)
            vc[l, :, :, i] = v[:, 0].to(vc.dtype)
            kcl, vcl = kc[l, :, :, : i + 1], vc[l, :, :, : i + 1]
            qg = q[:, 0].reshape(B, fdims.n_kv_head, group, fdims.head_dim)
            logits = torch.einsum("bhgd,bhkd->bhgk", qg.float(), kcl.float()) * (fdims.head_dim**-0.5)
            probs = torch.softmax(logits, dim=-1).to(vcl.dtype)
            att = torch.einsum("bhgk,bhkd->bhgd", probs, vcl)
            att = att.reshape(B, 1, fdims.n_head * fdims.head_dim)
            h = h + mm(att, lp["wo"])
            hn = rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
            h = h + mlp(hn, lp)
        fast_out = rms_norm(h[:, 0], params["fast_norm"], cfg.norm_eps)
        w_i = qindex(params["fast_output"], i) if cfg.depthwise_output else params["fast_output"]
        logits = mm(fast_out, w_i).float()
        if fast_temp is not None and fast_temp > 0:
            code = sample_token(logits, generator, temperature=fast_temp, min_p=settings.min_p)
        else:
            code = torch.argmax(logits, dim=-1).to(torch.int32)
        codes.append(code)
        if i + 1 < n:
            if cfg.depthwise_wte:
                offset = (i if cfg.duplicate_code_0 else i + 1) * cfg.codebook_size
            else:
                offset = 0
            x = params["fast_embeddings"][code.long() + offset][:, None, :]
    return torch.stack(codes, dim=1)


class _FastLoopArgs(ctypes.Structure):
    """Mirror of `struct FastLoopArgs` in csrc/fast_loop.cu."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "B", "D", "H", "KV", "hd", "F", "CB", "L", "n", "cdt", "et",
            "greedy", "use_min_p", "ld13")]
        + [(n, ctypes.c_float) for n in ("eps", "temp", "log_min_p")]
        + [(n, ctypes.c_void_p) for n in (
            "hidden", "wqkv", "wqkv_s", "wo", "wo_s", "w1", "w1_s", "w3", "w3_s",
            "w2", "w2_s", "anorm", "fnorm", "fast_norm", "wte", "head", "head_s",
            "cos", "sin", "seed", "h", "ssq", "qkv", "att", "act", "kc", "vc",
            "logits", "codes")]
    )


_CODE = {torch.float32: 0, torch.bfloat16: 1}


@lru_cache(maxsize=8)
def _rope_tables(n: int, hd: int, base: float, device: torch.device):
    cos, sin = rope_cos_sin(torch.arange(n, device=device), hd, base)  # bf16-rounded
    return cos.float().contiguous(), sin.float().contiguous()


def _contig(t: torch.Tensor, dtype, name: str) -> torch.Tensor:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"fast_loop kernel: {name} must be contiguous {dtype}, got "
                         f"{t.dtype} contiguous={t.is_contiguous()}")
    return t


def _kernel(params, cfg: DualARConfig, x0: torch.Tensor, generator, settings) -> torch.Tensor:
    dev = x0.device
    B, D = x0.shape
    L, n, CB = cfg.n_fast_layer, cfg.max_fast_seqlen, cfg.codebook_size
    H, KV, hd, Fi = cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim, cfg.fast_intermediate_size
    if x0.dtype not in _CODE or not x0.is_contiguous():
        raise ValueError(f"fast_loop kernel: hidden must be contiguous f32/bf16, got {x0.dtype}")
    lp = params["fast_layers"]
    et = lp["attention_norm"].dtype
    if et not in _CODE:
        raise ValueError(f"fast_loop kernel: norm/embedding dtype {et}")
    if "w13" in lp:
        w1 = w3 = lp["w13"]
        ld13, off3 = 2 * Fi, Fi
    else:
        w1, w3 = lp["w1"], lp["w3"]
        ld13, off3 = Fi, 0
        if w1.q.stride() != w3.q.stride():
            raise ValueError("fast_loop kernel: w1 and w3 layouts differ")
    head = params["fast_output"]
    Nq = D + 2 * KV * hd
    for name, width in (("dim", D), ("intermediate", Fi), ("codebook", CB), ("qkv", Nq)):
        if width % 16:
            raise ValueError(f"fast_loop kernel: {name} width {width} is not a multiple of 16")
    checks = [
        (lp["wqkv"].q, torch.int8, (L, D, Nq)), (lp["wqkv"].scale, torch.float32, (L, 1, Nq)),
        (lp["wo"].q, torch.int8, (L, D, D)), (lp["wo"].scale, torch.float32, (L, 1, D)),
        (w1.q, torch.int8, (L, D, ld13)), (w1.scale, torch.float32, (L, 1, ld13)),
        (w3.q, torch.int8, (L, D, ld13)), (w3.scale, torch.float32, (L, 1, ld13)),
        (lp["w2"].q, torch.int8, (L, Fi, D)), (lp["w2"].scale, torch.float32, (L, 1, D)),
        (lp["attention_norm"], et, (L, D)), (lp["ffn_norm"], et, (L, D)),
        (params["fast_norm"], et, (D,)), (params["fast_embeddings"], et, ((n - 1) * CB, D)),
        (head.q, torch.int8, (n, D, CB)), (head.scale, torch.float32, (n, 1, CB)),
    ]
    for t, dtype, shape in checks:
        _contig(t, dtype, str(shape))
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"fast_loop kernel: tensor {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {dev}")
    temp = float(settings.default_fast_temp or 0.0)
    greedy = temp <= 0.0
    min_p = settings.min_p
    cos, sin = _rope_tables(n, hd, float(cfg.rope_base), dev)
    seed = (torch.zeros(2, dtype=torch.int64, device=dev) if greedy
            else philox_seed(generator, dev))
    f32 = dict(dtype=torch.float32, device=dev)
    lib = _build.lib()
    scratch = dict(
        h=torch.empty((B, D), **f32), ssq=torch.empty((-(-D // 128), B), **f32),
        qkv=torch.empty((B, Nq), **f32), att=torch.empty((B, D), dtype=x0.dtype, device=dev),
        act=torch.empty((B, Fi), dtype=x0.dtype, device=dev), kc=torch.empty((L, n, B, KV * hd), **f32),
        vc=torch.empty((L, n, B, KV * hd), **f32), logits=torch.empty((B, CB), **f32),
    )
    codes = torch.empty((B, n), dtype=torch.int32, device=dev)
    esz = 4  # the scale tensors are f32
    args = _FastLoopArgs(
        B=B, D=D, H=H, KV=KV, hd=hd, F=Fi, CB=CB, L=L, n=n,
        cdt=_CODE[x0.dtype], et=_CODE[et], greedy=int(greedy),
        use_min_p=int(min_p is not None), ld13=ld13,
        eps=float(cfg.norm_eps), temp=temp,
        log_min_p=math.log(min_p) if min_p is not None else 0.0,
        hidden=x0.data_ptr(),
        wqkv=lp["wqkv"].q.data_ptr(), wqkv_s=lp["wqkv"].scale.data_ptr(),
        wo=lp["wo"].q.data_ptr(), wo_s=lp["wo"].scale.data_ptr(),
        w1=w1.q.data_ptr(), w1_s=w1.scale.data_ptr(),
        w3=w3.q.data_ptr() + off3, w3_s=w3.scale.data_ptr() + off3 * esz,
        w2=lp["w2"].q.data_ptr(), w2_s=lp["w2"].scale.data_ptr(),
        anorm=lp["attention_norm"].data_ptr(), fnorm=lp["ffn_norm"].data_ptr(),
        fast_norm=params["fast_norm"].data_ptr(), wte=params["fast_embeddings"].data_ptr(),
        head=head.q.data_ptr(), head_s=head.scale.data_ptr(),
        cos=cos.data_ptr(), sin=sin.data_ptr(), seed=seed.data_ptr(),
        codes=codes.data_ptr(),
        **{k: v.data_ptr() for k, v in scratch.items()},
    )
    code = lib.smoltts_fast_loop(ctypes.addressof(args), _build.stream_ptr(dev))
    _build.check(code, "fast_loop")
    ops.LAUNCHES["fast_loop"] += 1
    return codes


def fused_fast_micro_loop(params, cfg: DualARConfig, hidden, generator, settings) -> torch.Tensor:
    """One frame's [B, n] codes: the CUDA kernel sequence for a CUDA tensor,
    the plain loop for a CPU tensor. The tree must pass `supports_fused_fast`."""
    if not supports_fused_fast(cfg, params):
        raise ValueError("fused_fast_micro_loop: unsupported config or tree")
    require_whole_fast_trunk(params, cfg)
    if not hidden.is_cuda:
        return fast_micro_loop_plain(params, cfg, hidden, generator, settings)
    x0 = project_fast_in(params, cfg, hidden).contiguous()
    return _kernel(params, cfg, x0, generator, settings)
