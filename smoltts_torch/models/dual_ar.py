"""DualAR / RQ-Transformer, decode side: dimensions, random init, the
embedding merge, the tied token head and the fast input projection.

Parameters are a nested dict with the JAX package's key names; per-trunk
layer weights are stacked along a leading layer axis. `DualARDecoder` holds
such a tree as registered buffers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig
from smoltts_torch.interop import TensorTree, tree_map
from smoltts_torch.models.layers import AttnDims, rms_norm
from smoltts_torch.ops.quant import mm

DualARParams = Dict[str, Any]


def slow_dims(cfg: DualARConfig) -> AttnDims:
    return AttnDims(cfg.n_head, cfg.n_local_heads, cfg.head_dim, cfg.dim)


def fast_dims(cfg: DualARConfig) -> AttnDims:
    return AttnDims(cfg.fast_n_head, cfg.fast_n_local_heads, cfg.fast_head_dim, cfg.fast_dim)


def semantic_offsets(cfg: DualARConfig, device=None) -> torch.Tensor:
    """Per-level offsets into the shared codebook embedding table [num_rows-1]."""
    offs = torch.arange(cfg.num_codebooks, dtype=torch.int64, device=device) * cfg.codebook_size
    return offs if cfg.duplicate_code_0 else offs[1:]


def _init_trunk(gen, n_layer, dims: AttnDims, intermediate, std, qkv_bias, dtype):
    total_qkv = dims.q_size + 2 * dims.kv_size

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32) * std).to(dtype)

    lp = {
        "attention_norm": torch.ones((n_layer, dims.dim), dtype=dtype),
        "ffn_norm": torch.ones((n_layer, dims.dim), dtype=dtype),
        "wqkv": normal((n_layer, dims.dim, total_qkv)),
        "wo": normal((n_layer, dims.dim, dims.dim)),
        "w1": normal((n_layer, dims.dim, intermediate)),
        "w3": normal((n_layer, dims.dim, intermediate)),
        "w2": normal((n_layer, intermediate, dims.dim)),
    }
    if qkv_bias:
        lp["wqkv_bias"] = torch.zeros((n_layer, total_qkv), dtype=dtype)
    return lp


def init_params(
    cfg: DualARConfig,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
    device=None,
) -> DualARParams:
    """Random init: normal(0, initializer_range) weights, ones for norms,
    zero biases, the same shapes as the JAX package's `init_params`. The
    draws run on a CPU generator (seed 0 unless given), then move to
    `device` (None means CUDA)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    std = cfg.initializer_range

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32) * std).to(dtype)

    params: DualARParams = {
        "embeddings": normal((cfg.vocab_size, cfg.dim)),
        "codebook_embeddings": normal((cfg.codebook_size * cfg.num_codebooks, cfg.dim)),
        "layers": _init_trunk(
            gen, cfg.n_layer, slow_dims(cfg), cfg.intermediate_size, std,
            cfg.attention_qkv_bias, dtype,
        ),
        "norm": torch.ones((cfg.dim,), dtype=dtype),
        "fast_embeddings": normal((cfg.fast_embedding_rows, cfg.fast_dim)),
        "fast_layers": _init_trunk(
            gen, cfg.n_fast_layer, fast_dims(cfg), cfg.fast_intermediate_size, std,
            bool(cfg.fast_attention_qkv_bias), dtype,
        ),
        "fast_norm": torch.ones((cfg.fast_dim,), dtype=dtype),
    }
    if not cfg.tie_word_embeddings:
        params["output"] = normal((cfg.dim, cfg.vocab_size))
    if cfg.fast_dim != cfg.dim:
        params["fast_project_in"] = {
            "kernel": normal((cfg.dim, cfg.fast_dim)),
            "bias": torch.zeros((cfg.fast_dim,), dtype=dtype),
        }
    if cfg.depthwise_output:
        params["fast_output"] = normal((cfg.max_fast_seqlen, cfg.fast_dim, cfg.codebook_size))
    else:
        params["fast_output"] = normal((cfg.fast_dim, cfg.codebook_size))
    return tree_map(lambda t: t.to(dev), params)


class DualARDecoder(TensorTree):
    """The DualAR parameter tree as an `nn.Module` (`.to(device)`,
    `state_dict()`); `.tree()` gives the dict the decode functions take."""


def embed_merge(
    params: DualARParams,
    cfg: DualARConfig,
    tokens: torch.Tensor,  # [B, num_rows, T]
    *,
    embed_mask_mode: str = "row1_zero",
    semantic_start_id: int = 0,
    semantic_end_id: int = 0,
) -> torch.Tensor:
    """Row-0 text embedding plus the sum of per-level codebook embeddings,
    the latter zeroed on positions the mask mode excludes. Returns [B, T, dim]."""
    tokens = tokens.long()
    text_tokens = tokens[:, 0, :]
    text_embeds = params["embeddings"][text_tokens]
    offs = semantic_offsets(cfg, tokens.device)
    cb_tokens = tokens[:, 1:, :] + offs[None, :, None]
    cb_sum = params["codebook_embeddings"][cb_tokens].sum(dim=1)
    if embed_mask_mode == "row1_zero":
        keep = tokens[:, 1, :] != 0
    elif embed_mask_mode == "semantic_range":
        keep = (text_tokens >= semantic_start_id) & (text_tokens <= semantic_end_id)
    else:
        raise ValueError(f"unknown embed_mask_mode: {embed_mask_mode}")
    cb_sum = torch.where(keep[..., None], cb_sum, torch.zeros_like(cb_sum))
    return text_embeds + cb_sum


def token_head(params: DualARParams, cfg: DualARConfig, x: torch.Tensor) -> torch.Tensor:
    """Vocab logits from the normed slow output (tied or separate head)."""
    slow_out = rms_norm(x, params["norm"], cfg.norm_eps)
    if cfg.tie_word_embeddings:
        return slow_out @ params["embeddings"].T
    return mm(slow_out, params["output"])


def project_fast_in(params: DualARParams, cfg: DualARConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.fast_dim != cfg.dim:
        p = params["fast_project_in"]
        return mm(x, p["kernel"]) + p["bias"]
    return x
