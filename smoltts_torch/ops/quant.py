"""Int8 weight-only quantization for the decode path.

`QTensor(q, scale)` is shaped exactly like the weight it replaces (stacked
layer axes included); `scale` keeps the contraction axis as size 1. `mm`
applies the scale after the product: `(x @ q.to(x.dtype)) * scale`, which is
bit-exact against `x @ (q * scale)` when the scale is a power of two.
Rounding is half-to-even (`torch.round`), as `jnp.round` rounds.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


class QTensor(NamedTuple):
    """Symmetric per-channel int8 weight: w ~= q * scale."""

    q: torch.Tensor  # int8
    scale: torch.Tensor  # float32, contraction axis kept as 1


Weight = Union[torch.Tensor, QTensor]


def quantize_q8(w: torch.Tensor, contract_axis: int = -2) -> QTensor:
    """Per-output-channel symmetric int8 over the contraction axis."""
    wf = w.float()
    amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(w: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (w.q.float() * w.scale).to(dtype)


def mm(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x @ w for plain or int8-quantized weights (a plain large product, as
    the JAX package leaves it to XLA)."""
    if isinstance(w, QTensor):
        if any(d != 1 for d in w.scale.shape[:-1]):
            raise ValueError(
                f"mm() got a QTensor with stacked leading axes (scale shape "
                f"{tuple(w.scale.shape)}); index the layer out first"
            )
        y = x @ w.q.to(x.dtype)
        return y * w.scale.reshape(w.scale.shape[-1]).to(y.dtype)
    return x @ w


def qindex(w: Weight, i) -> Weight:
    """w[i] for both plain tensors and QTensor leaves."""
    if isinstance(w, QTensor):
        return QTensor(q=w.q[i], scale=w.scale[i])
    return w[i]


def quantize_kv(x: torch.Tensor):
    """Symmetric per-vector int8 over the trailing head_dim axis. Returns
    (q int8 shaped like x, scale float32 with the trailing axis removed)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


_TRUNK_KEYS = ("wqkv", "wo", "w1", "w2", "w3", "w13")


def quantize_decode_params(params: dict) -> dict:
    """Quantize the matmul weights of a DualAR tree: trunk projections, the
    fast output head, the fast input projection and an untied output head.
    Embeddings, norms and biases stay as they are."""
    out = dict(params)
    for trunk in ("layers", "fast_layers"):
        lp = dict(params[trunk])
        for key in _TRUNK_KEYS:
            if key in lp and not isinstance(lp[key], QTensor):
                lp[key] = quantize_q8(lp[key], contract_axis=-2)
        out[trunk] = lp
    out["fast_output"] = quantize_q8(params["fast_output"], contract_axis=-2)
    if "fast_project_in" in params:
        fpi = dict(params["fast_project_in"])
        fpi["kernel"] = quantize_q8(fpi["kernel"], contract_axis=-2)
        out["fast_project_in"] = fpi
    if "output" in params:
        out["output"] = quantize_q8(params["output"], contract_axis=-2)
    return out


def _concat_w(ws, dim=-1):
    """Concatenate along the output axis: exact for plain tensors and for
    per-output-channel QTensors."""
    if isinstance(ws[0], QTensor):
        return QTensor(
            q=torch.cat([w.q for w in ws], dim=dim),
            scale=torch.cat([w.scale for w in ws], dim=dim),
        )
    return torch.cat(ws, dim=dim)


def fuse_decode_params(params: dict) -> dict:
    """Fuse the SwiGLU gate/up projections (w1, w3 -> w13). Bit-exact;
    idempotent."""
    out = dict(params)
    for trunk in ("layers", "fast_layers"):
        if trunk not in params or "w13" in params[trunk]:
            continue
        lp = dict(params[trunk])
        lp["w13"] = _concat_w([lp.pop("w1"), lp.pop("w3")])
        out[trunk] = lp
    return out


def fuse_mimi_decode_params(params: dict) -> dict:
    """Fuse the codec transformers' q/k/v projections into one wqkv."""
    out = dict(params)
    for trunk in ("encoder_transformer", "decoder_transformer"):
        if trunk not in params or "wqkv" in params[trunk]["layers"]:
            continue
        lp = dict(params[trunk]["layers"])
        lp["wqkv"] = _concat_w([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")])
        out[trunk] = {**params[trunk], "layers": lp}
    return out


_MIMI_LINEARS = ("wq", "wk", "wv", "wo", "fc1", "fc2", "wqkv")


def quantize_mimi_params(params: dict) -> dict:
    """Quantize the codec transformers' linear weights; convs, codebooks,
    norms and LayerScale stay dense."""
    out = dict(params)
    for trunk in ("encoder_transformer", "decoder_transformer"):
        if trunk not in params:
            continue
        lp = dict(params[trunk]["layers"])
        for key in _MIMI_LINEARS:
            if key in lp and not isinstance(lp[key], QTensor):
                lp[key] = quantize_q8(lp[key], contract_axis=-2)
        out[trunk] = {**params[trunk], "layers": lp}
    return out
