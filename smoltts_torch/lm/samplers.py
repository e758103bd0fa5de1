"""Token samplers over an explicit `torch.Generator`.

Greedy argmax at temperature 0; otherwise temperature-scaled categorical
sampling by the Gumbel-max trick, with the sort-free min-p filter (keep
logits within log(min_p) of the max). Argmax ties go to the lowest index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class GenerationSettings:
    """Static sampling settings."""

    default_temp: float = 0.7
    default_fast_temp: Optional[float] = 0.7
    min_p: Optional[float] = None
    max_new_tokens: int = 1024
    audio_only_constraint: bool = False


def min_p_mask(scaled: torch.Tensor, min_p: Optional[float]) -> torch.Tensor:
    """Set entries below max + log(min_p) to -inf (none when min_p is None)."""
    if min_p is None:
        return scaled
    if not (0.0 <= min_p <= 1.0):
        raise ValueError(f"min_p must be in [0, 1], got {min_p}")
    top = scaled.amax(dim=-1, keepdim=True)
    return torch.where(scaled >= top + math.log(min_p), scaled, torch.full_like(scaled, -math.inf))


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)) with u uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    u = u.clamp_min(1e-12).to(device)
    return -torch.log(-torch.log(u))


def sample_token(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    temperature: Optional[float],
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """Sample ids from [..., vocab] logits; temperature 0 (or None) is argmax."""
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = min_p_mask(logits.float() / temperature, min_p)
    noisy = scaled + gumbel_noise(scaled.shape, generator, scaled.device)
    return torch.argmax(noisy, dim=-1).to(torch.int32)


def constrain_logits_to_audio(
    logits: torch.Tensor, im_end_id: int, semantic_start_id: int, semantic_end_id: int
) -> torch.Tensor:
    """Mask slow-head logits outside {im_end} U [semantic_start, semantic_end]."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    allowed = (ids == im_end_id) | ((ids >= semantic_start_id) & (ids <= semantic_end_id))
    return torch.where(allowed, logits, torch.full_like(logits, -math.inf))
