"""Split residual vector quantizer: codes <-> embeddings.

Codes are [B, K, T]; level 0 is the semantic side, the rest the acoustic
side, each with its own input/output projection. Encoding quantizes the
running residual level by level (the acoustic side starts from the original
embedding, not the semantic residual); decoding sums each side's codebook
lookups and applies its output projection.
"""

from __future__ import annotations

from typing import Optional

import torch

from smoltts_torch.codec.config import MimiConfig


def _nearest(residual: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """argmin_j ||r - e_j||^2 as argmax_j (r . e_j - ||e_j||^2 / 2), in f32;
    ties go to the lowest index. residual [..., D], embed [C, D]."""
    rf, ef = residual.float(), embed.float()
    scores = rf @ ef.T - 0.5 * (ef * ef).sum(dim=-1)
    return torch.argmax(scores, dim=-1).to(torch.int32)


def rvq_encode_side(x: torch.Tensor, side: dict, num_quantizers: int) -> torch.Tensor:
    """x [B, T, hidden] -> codes [B, num_quantizers, T]."""
    residual = x.float() @ side["in_proj"].float()
    codes = []
    for embed in side["embed"][:num_quantizers]:
        idx = _nearest(residual, embed)
        residual = residual - embed.float()[idx.long()]
        codes.append(idx)
    return torch.stack(codes, dim=1)


def split_rvq_encode(x: torch.Tensor, quantizer: dict, cfg: MimiConfig,
                     num_quantizers: Optional[int] = None) -> torch.Tensor:
    """x [B, T, hidden] -> codes [B, nq, T] (level 0 semantic)."""
    nq = num_quantizers or cfg.num_quantizers
    if nq > cfg.num_quantizers or nq < cfg.num_semantic_quantizers:
        raise ValueError(f"num_quantizers {nq} out of range")
    sem = rvq_encode_side(x, quantizer["semantic"], cfg.num_semantic_quantizers)
    n_ac = nq - cfg.num_semantic_quantizers
    if n_ac == 0:
        return sem
    return torch.cat([sem, rvq_encode_side(x, quantizer["acoustic"], n_ac)], dim=1)


def rvq_decode_side(codes: torch.Tensor, side: dict) -> torch.Tensor:
    """codes [B, K, T] -> [B, T, hidden]."""
    B, K, T = codes.shape
    embed = side["embed"]
    acc = torch.zeros((B, T, embed.shape[-1]), dtype=embed.dtype, device=codes.device)
    for k in range(K):
        acc = acc + embed[k][codes[:, k].long()]
    return acc @ side["out_proj"]


def split_rvq_decode(codes: torch.Tensor, quantizer: dict, cfg: MimiConfig) -> torch.Tensor:
    """codes [B, K, T] -> embeddings [B, T, hidden]."""
    ns = cfg.num_semantic_quantizers
    out = rvq_decode_side(codes[:, :ns], quantizer["semantic"])
    if codes.shape[1] > ns:
        out = out + rvq_decode_side(codes[:, ns:], quantizer["acoustic"])
    return out
