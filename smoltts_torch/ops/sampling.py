"""Categorical sampling: temperature + min-p + Gumbel-max over each row.

`sample_categorical` is argmax at temperature 0; otherwise it takes the plain
version for a CPU tensor and launches the CUDA kernel (csrc/sampling.cu) for
a CUDA tensor. The kernel draws its Gumbel noise from Philox, keyed by a
(seed, offset) pair drawn from the caller's generator, so it matches the
plain version in distribution, not draw for draw; min_p = 1 and one-hot
logits are exact.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from smoltts_torch import ops
from smoltts_torch.lm.samplers import sample_token
from smoltts_torch.ops import _build


def philox_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """{seed, offset} as two int64 on `device`, drawn from `generator`."""
    gdev = generator.device if generator is not None else torch.device("cpu")
    seed = torch.randint(0, 2**62, (2,), generator=generator, device=gdev, dtype=torch.int64)
    return seed.to(device, non_blocking=True)


# The plain version is the LM sampler itself.
sample_categorical_plain = sample_token


def _kernel(logits: torch.Tensor, generator, temperature: float, min_p: Optional[float]):
    if logits.dim() != 2 or logits.dtype != torch.float32 or logits.stride(1) != 1:
        raise ValueError(
            f"sample_categorical kernel: need [B, V] f32 rows with unit stride, got "
            f"{tuple(logits.shape)} {logits.dtype} strides {logits.stride()}"
        )
    if min_p is not None and not (0.0 < min_p <= 1.0):
        raise ValueError(f"min_p must be in (0, 1], got {min_p}")
    B, V = logits.shape
    out = torch.empty((B,), dtype=torch.int32, device=logits.device)
    seed = philox_seed(generator, logits.device)
    code = _build.lib().smoltts_sample_categorical(
        logits.data_ptr(), B, V, logits.stride(0),
        float(temperature), math.log(min_p) if min_p is not None else 0.0,
        1 if min_p is not None else 0,
        seed.data_ptr(), out.data_ptr(), _build.stream_ptr(logits.device),
    )
    _build.check(code, "sample_categorical")
    ops.LAUNCHES["sample_categorical"] += 1
    return out


def sample_categorical(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    temperature: Optional[float],
    min_p: Optional[float] = None,
) -> torch.Tensor:
    """[B, V] logits -> [B] int32 ids."""
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if not logits.is_cuda:
        return sample_categorical_plain(logits, generator, temperature=temperature, min_p=min_p)
    return _kernel(logits, generator, temperature, min_p)
