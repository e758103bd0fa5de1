"""Mimi codec configuration (kyutai/mimi release defaults) as a dataclass."""

from __future__ import annotations

import dataclasses
import math
from typing import List


@dataclasses.dataclass
class MimiConfig:
    # SEANet
    sampling_rate: int = 24_000
    audio_channels: int = 1
    num_filters: int = 64
    num_residual_layers: int = 1
    upsampling_ratios: List[int] = dataclasses.field(default_factory=lambda: [8, 6, 5, 4])
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    compress: int = 2
    trim_right_ratio: float = 1.0
    use_causal_conv: bool = True
    pad_mode: str = "constant"
    hidden_size: int = 512

    # Codec transformer
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    head_dim: int = 64
    intermediate_size: int = 2048
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    sliding_window: int = 250
    layer_scale_initial_scale: float = 0.01

    # RVQ
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    frame_rate: float = 12.5
    upsample_groups: int = 512

    @property
    def hop_length(self) -> int:
        return int(math.prod(self.upsampling_ratios))  # 960

    @property
    def encodec_frame_rate(self) -> float:
        return math.ceil(self.sampling_rate / self.hop_length)  # 25 Hz

    @property
    def downsample_stride(self) -> int:
        return 2

    @property
    def downsample_kernel(self) -> int:
        return 2 * int(self.encodec_frame_rate / self.frame_rate)  # 4

    @property
    def samples_per_frame(self) -> int:
        return self.hop_length * self.downsample_stride  # 1920 (80 ms)
