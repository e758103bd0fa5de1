"""Streaming causal 1-D convolutions for the Mimi decoder.

Activations are [B, L, C] and kernels [K, C_in/groups, C_out] at the public
functions, as in the JAX package; each call converts to torch's [B, C, L] and
[C_out, C_in/groups, K]. Transpose-conv kernels arrive pre-flipped.

- causal conv: a rolling input buffer of `eff_k - stride` samples,
  zero-initialised and refreshed with the last inputs each step;
- transpose conv: a bias-free overlap-add tail of `kernel - stride` samples.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def effective_kernel(kernel: int, dilation: int) -> int:
    return (kernel - 1) * dilation + 1


def conv1d_raw(x, w, b, *, stride=1, dilation=1, groups=1) -> torch.Tensor:
    """VALID conv. x [B, L, Cin], w [K, Cin/groups, Cout] -> [B, L', Cout]."""
    y = F.conv1d(x.transpose(1, 2), w.to(x.dtype).permute(2, 1, 0), None,
                 stride=stride, dilation=dilation, groups=groups)
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def conv_transpose1d_raw(x, w_flipped, b, *, stride, groups=1) -> torch.Tensor:
    """Transposed conv with a pre-flipped kernel w_flipped[k, i, o] =
    w_torch[i, o, K-1-k]. Output length (L-1)*stride + K."""
    K, cin_g, cout = w_flipped.shape
    cout_g = cout // groups
    w = w_flipped.to(x.dtype).flip(0).reshape(K, cin_g, groups, cout_g)
    w = w.permute(2, 1, 3, 0).reshape(groups * cin_g, cout_g, K)
    y = F.conv_transpose1d(x.transpose(1, 2), w, None, stride=stride, groups=groups)
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def conv_stream_init(batch, in_channels, kernel, stride, dilation, dtype, device) -> torch.Tensor:
    """Zero rolling buffer [B, eff_k - stride, Cin]."""
    eff_k = effective_kernel(kernel, dilation)
    return torch.zeros((batch, eff_k - stride, in_channels), dtype=dtype, device=device)


def conv_stream_step(state, x, w, b: Optional[torch.Tensor], *, stride=1, dilation=1,
                     groups=1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, Cin] with L % stride == 0 -> (state', y [B, L//stride, Cout])."""
    L = x.shape[1]
    assert L % stride == 0, "streaming conv requires chunk % stride == 0"
    x_long = torch.cat([state, x.to(state.dtype)], dim=1)
    y = conv1d_raw(x_long, w, b, stride=stride, dilation=dilation, groups=groups)
    new_state = x_long[:, L:] if state.shape[1] > 0 else state
    return new_state, y


def convtr_stream_init(batch, out_channels, kernel, stride, dtype, device) -> torch.Tensor:
    """Zero overlap tail [B, kernel - stride, Cout] (bias-free)."""
    return torch.zeros((batch, kernel - stride, out_channels), dtype=dtype, device=device)


def convtr_stream_step(state, x, w_flipped, b: Optional[torch.Tensor], *, stride,
                       groups=1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, Cin] -> (state', y [B, L*stride, Cout])."""
    K = w_flipped.shape[0]
    L = x.shape[1]
    ys = conv_transpose1d_raw(x, w_flipped, b, stride=stride, groups=groups)
    overlap = K - stride
    if overlap > 0:
        ys = torch.cat([ys[:, :overlap] + state.to(ys.dtype), ys[:, overlap:]], dim=1)
    out = ys[:, : L * stride]
    tail = ys[:, L * stride :]
    if b is not None:
        tail = tail - b.to(tail.dtype)
    return tail.to(state.dtype), out
