"""Split residual vector quantizer, decode side: codes -> embeddings.

Codes are [B, K, T]; each side sums its codebook lookups and applies its
output projection; level 0 is the semantic side."""

from __future__ import annotations

import torch

from smoltts_torch.codec.config import MimiConfig


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
