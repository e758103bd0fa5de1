"""SEANet encoder and decoder for Mimi: static layer plans, the batch stack
and the decoder's streaming step.

A plan is a list of `ConvSpec`s; parameters and streaming state are lists
aligned with it (None for ELU entries).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.conv import (
    causal_conv1d,
    causal_conv_transpose1d,
    conv_stream_init,
    conv_stream_step,
    convtr_stream_init,
    convtr_stream_step,
)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    kind: str  # "conv" | "convtr" | "elu" | "resnet"
    in_ch: int = 0
    out_ch: int = 0
    kernel: int = 0
    stride: int = 1
    dilation: int = 1
    bias: bool = True
    res_dilations: Tuple[int, int] = (1, 1)
    res_hidden: int = 0
    res_kernel: int = 3


def build_encoder_plan(cfg: MimiConfig) -> List[ConvSpec]:
    plan = [ConvSpec("conv", cfg.audio_channels, cfg.num_filters, cfg.kernel_size)]
    scaling = 1
    for ratio in reversed(cfg.upsampling_ratios):
        current = scaling * cfg.num_filters
        for j in range(cfg.num_residual_layers):
            plan.append(ConvSpec("resnet", in_ch=current, out_ch=current,
                                 res_dilations=(cfg.dilation_growth_rate**j, 1),
                                 res_hidden=current // cfg.compress,
                                 res_kernel=cfg.residual_kernel_size))
        plan.append(ConvSpec("elu"))
        plan.append(ConvSpec("conv", current, current * 2, ratio * 2, stride=ratio))
        scaling *= 2
    plan.append(ConvSpec("elu"))
    plan.append(ConvSpec("conv", scaling * cfg.num_filters, cfg.hidden_size, cfg.last_kernel_size))
    return plan


def build_decoder_plan(cfg: MimiConfig) -> List[ConvSpec]:
    scaling = int(2 ** len(cfg.upsampling_ratios))
    plan = [ConvSpec("conv", cfg.hidden_size, scaling * cfg.num_filters, cfg.kernel_size)]
    for ratio in cfg.upsampling_ratios:
        current = scaling * cfg.num_filters
        plan.append(ConvSpec("elu"))
        plan.append(ConvSpec("convtr", current, current // 2, ratio * 2, stride=ratio))
        for j in range(cfg.num_residual_layers):
            plan.append(ConvSpec("resnet", in_ch=current // 2, out_ch=current // 2,
                                 res_dilations=(cfg.dilation_growth_rate**j, 1),
                                 res_hidden=(current // 2) // cfg.compress,
                                 res_kernel=cfg.residual_kernel_size))
        scaling //= 2
    plan.append(ConvSpec("elu"))
    plan.append(ConvSpec("conv", cfg.num_filters, cfg.audio_channels, cfg.last_kernel_size))
    return plan


def _elu(x):
    return F.elu(x)


def _resnet_apply(spec: ConvSpec, p: dict, x: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """ELU, conv (k, dilation), ELU, conv (1), plus the residual."""
    h = causal_conv1d(_elu(x), p["conv1"]["w"], p["conv1"].get("b"),
                      dilation=spec.res_dilations[0], pad_mode=pad_mode)
    h = causal_conv1d(_elu(h), p["conv2"]["w"], p["conv2"].get("b"),
                      dilation=spec.res_dilations[1], pad_mode=pad_mode)
    return x + h


def seanet_apply(plan: List[ConvSpec], params: List, x: torch.Tensor, cfg: MimiConfig,
                 trim_right_ratio: Optional[float] = None) -> torch.Tensor:
    """The whole stack over x [B, L, C] at once."""
    trr = cfg.trim_right_ratio if trim_right_ratio is None else trim_right_ratio
    for spec, p in zip(plan, params):
        if spec.kind == "elu":
            x = _elu(x)
        elif spec.kind == "conv":
            x = causal_conv1d(x, p["w"], p.get("b"), stride=spec.stride, dilation=spec.dilation,
                              pad_mode=cfg.pad_mode)
        elif spec.kind == "convtr":
            x = causal_conv_transpose1d(x, p["w"], p.get("b"), stride=spec.stride,
                                        trim_right_ratio=trr)
        elif spec.kind == "resnet":
            x = _resnet_apply(spec, p, x, cfg.pad_mode)
        else:
            raise ValueError(spec.kind)
    return x


def seanet_stream_init(plan: List[ConvSpec], batch: int, dtype=torch.float32, device=None) -> List:
    state: List = []
    for spec in plan:
        if spec.kind == "conv":
            state.append(conv_stream_init(batch, spec.in_ch, spec.kernel, spec.stride,
                                          spec.dilation, dtype, device))
        elif spec.kind == "convtr":
            state.append(convtr_stream_init(batch, spec.out_ch, spec.kernel, spec.stride,
                                            dtype, device))
        elif spec.kind == "resnet":
            state.append({
                "conv1": conv_stream_init(batch, spec.in_ch, spec.res_kernel, 1,
                                          spec.res_dilations[0], dtype, device),
                "conv2": conv_stream_init(batch, spec.res_hidden, 1, 1,
                                          spec.res_dilations[1], dtype, device),
            })
        else:
            state.append(None)
    return state


def seanet_stream_step(plan: List[ConvSpec], params: List, state: List, x: torch.Tensor):
    """One streaming step through the whole stack -> (state', y)."""
    new_state: List = []
    for spec, p, s in zip(plan, params, state):
        if spec.kind == "elu":
            x = F.elu(x)
            new_state.append(None)
        elif spec.kind == "conv":
            s, x = conv_stream_step(s, x, p["w"], p.get("b"), stride=spec.stride,
                                    dilation=spec.dilation)
            new_state.append(s)
        elif spec.kind == "convtr":
            s, x = convtr_stream_step(s, x, p["w"], p.get("b"), stride=spec.stride)
            new_state.append(s)
        elif spec.kind == "resnet":
            s1, h = conv_stream_step(s["conv1"], F.elu(x), p["conv1"]["w"], p["conv1"].get("b"),
                                     dilation=spec.res_dilations[0])
            s2, h = conv_stream_step(s["conv2"], F.elu(h), p["conv2"]["w"], p["conv2"].get("b"),
                                     dilation=spec.res_dilations[1])
            x = x + h
            new_state.append({"conv1": s1, "conv2": s2})
        else:
            raise ValueError(spec.kind)
    return new_state, x
