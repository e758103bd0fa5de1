"""Weight and cache precisions of the plain reference, in float32 math.

A precision names how each stored quantity is rounded before the float32
arithmetic uses it:

- `matrix_bits`: symmetric per-output-channel integers over the contraction
  axis (8 for the served int8 weights, 4 for the control, None for dense);
- `kv_bits`: symmetric per-vector integers over head_dim for the attention
  caches (8 for kv8, 4 for the control, None for dense);
- `table`: the rounding of the weights stored dense (embeddings, tied head,
  norms, convolutions, codebooks): "bf16" as served, "fp8" (e4m3) for the
  control, None for float32.

The integer arithmetic is the published int8 scheme: scale = amax / qmax
(1 where amax is 0), q = clamp(round_half_even(w / scale), -qmax, qmax).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    matrix_bits: Optional[int] = 8
    kv_bits: Optional[int] = 8
    table: Optional[str] = "bf16"

    def lower(self) -> "Precision":
        """One step below every stated precision: the control."""
        return Precision(matrix_bits=4 if self.matrix_bits else None,
                         kv_bits=4 if self.kv_bits else None,
                         table="fp8" if self.table else None)


DENSE = Precision(matrix_bits=None, kv_bits=None, table=None)


def fake_quant(w: torch.Tensor, bits: Optional[int], axis: int) -> torch.Tensor:
    """w rounded to `bits`-bit symmetric integers per slice along `axis`
    (the reduced axis), returned dequantized in float32."""
    wf = w.float()
    if bits is None:
        return wf
    qmax = float(2 ** (bits - 1) - 1)
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


def round_table(w: torch.Tensor, table: Optional[str]) -> torch.Tensor:
    """A dense weight as stored, in float32."""
    if table is None:
        return w.float()
    if table == "bf16":
        return w.to(torch.bfloat16).float()
    if table == "fp8":
        return w.float().to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown table precision {table!r}")
