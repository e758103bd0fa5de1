"""Mimi codec, streaming decode side: random init, streaming state and the
per-frame step codes -> RVQ decode -> depthwise transpose-conv upsample ->
decoder transformer -> SEANet decoder -> PCM (1920 samples per frame).

`init_mimi_params` draws with `np.random.default_rng(seed)` in the JAX
package's order, draw for draw, so equal seeds give equal weights in both
packages with no bridge.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch

from smoltts_torch import resolve_device
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.conv import convtr_stream_init, convtr_stream_step
from smoltts_torch.codec.rvq import split_rvq_decode
from smoltts_torch.codec.seanet import (
    build_decoder_plan,
    build_encoder_plan,
    seanet_stream_init,
    seanet_stream_step,
)
from smoltts_torch.codec.transformer import (
    TransformerRingState,
    flush_transformer_ring,
    ring_state_init,
    transformer_stream_step,
)
from smoltts_torch.interop import TensorTree, tree_map

MimiParams = Dict[str, object]


def init_mimi_params(cfg: MimiConfig, seed: int = 0, dtype=torch.float32, device=None) -> MimiParams:
    """Random-init Mimi params with the release shapes (encoder side
    included, as the draws interleave)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def conv_p(spec_in, spec_out, k, bias=True, scale=None):
        scale = scale or (1.0 / np.sqrt(max(spec_in * k, 1)))
        p = {"w": rng.standard_normal((k, spec_in, spec_out)).astype(np.float32) * scale}
        if bias:
            p["b"] = np.zeros((spec_out,), np.float32)
        return p

    def seanet_p(plan):
        out = []
        for spec in plan:
            if spec.kind == "elu":
                out.append(None)
            elif spec.kind in ("conv", "convtr"):
                out.append(conv_p(spec.in_ch, spec.out_ch, spec.kernel))
            else:
                out.append({
                    "conv1": conv_p(spec.in_ch, spec.res_hidden, spec.res_kernel),
                    "conv2": conv_p(spec.res_hidden, spec.out_ch, 1),
                })
        return out

    d, ff = cfg.hidden_size, cfg.intermediate_size
    L = cfg.num_hidden_layers
    s = 1.0 / np.sqrt(d)

    def tf_p():
        return {"layers": {
            "ln1_w": np.ones((L, d), np.float32),
            "ln1_b": np.zeros((L, d), np.float32),
            "ln2_w": np.ones((L, d), np.float32),
            "ln2_b": np.zeros((L, d), np.float32),
            "wq": rng.standard_normal((L, d, d)).astype(np.float32) * s,
            "wk": rng.standard_normal((L, d, d)).astype(np.float32) * s,
            "wv": rng.standard_normal((L, d, d)).astype(np.float32) * s,
            "wo": rng.standard_normal((L, d, d)).astype(np.float32) * s,
            "fc1": rng.standard_normal((L, d, ff)).astype(np.float32) * s,
            "fc2": rng.standard_normal((L, ff, d)).astype(np.float32) / np.sqrt(ff),
            "scale_attn": np.full((L, d), cfg.layer_scale_initial_scale, np.float32),
            "scale_mlp": np.full((L, d), cfg.layer_scale_initial_scale, np.float32),
        }}

    def rvq_side(n):
        return {
            "in_proj": rng.standard_normal((d, cfg.codebook_dim)).astype(np.float32) * s,
            "out_proj": rng.standard_normal((cfg.codebook_dim, d)).astype(np.float32)
            / np.sqrt(cfg.codebook_dim),
            "embed": rng.standard_normal((n, cfg.codebook_size, cfg.codebook_dim)).astype(np.float32),
        }

    K = cfg.downsample_kernel
    params: MimiParams = {
        "encoder": seanet_p(build_encoder_plan(cfg)),
        "encoder_transformer": tf_p(),
        "downsample": conv_p(d, d, K, bias=False),
        "upsample": {"w": rng.standard_normal((K, 1, d)).astype(np.float32) * 0.5},
        "decoder_transformer": tf_p(),
        "decoder": seanet_p(build_decoder_plan(cfg)),
        "quantizer": {
            "semantic": rvq_side(cfg.num_semantic_quantizers),
            "acoustic": rvq_side(cfg.num_quantizers - cfg.num_semantic_quantizers),
        },
    }
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype), params)


class MimiDecoder(TensorTree):
    """The Mimi parameter tree as an `nn.Module`; `.tree()` gives the dict
    `mimi_decode_step` takes."""


class MimiStreamState(NamedTuple):
    upsample_tail: torch.Tensor
    transformer: TransformerRingState
    decoder: List


def decode_stream_init(cfg: MimiConfig, batch: int, dtype=torch.float32, tail_len: int = 64,
                       kv_dtype=None, device=None) -> MimiStreamState:
    """`kv_dtype=torch.int8` puts the codec transformer's ring in kv8 mode.
    `device=None` means CUDA."""
    dev = resolve_device(device)
    K = cfg.downsample_kernel
    return MimiStreamState(
        upsample_tail=convtr_stream_init(batch, cfg.hidden_size, K, cfg.downsample_stride, dtype, dev),
        transformer=ring_state_init(cfg, batch, kv_dtype or dtype, tail_len=tail_len, device=dev),
        decoder=seanet_stream_init(build_decoder_plan(cfg), batch, dtype, dev),
    )


def flush_mimi_state(state: MimiStreamState) -> MimiStreamState:
    """Consolidate the codec transformer's ring tail (in place)."""
    return state._replace(transformer=flush_transformer_ring(state.transformer))


def mimi_decode_step(params: MimiParams, cfg: MimiConfig, state: MimiStreamState,
                     codes: torch.Tensor):
    """codes [B, K, T_frames] -> (state', PCM [B, T_frames * 1920, 1])."""
    emb = split_rvq_decode(codes, params["quantizer"], cfg)
    up_tail, emb = convtr_stream_step(
        state.upsample_tail, emb, params["upsample"]["w"], params["upsample"].get("b"),
        stride=cfg.downsample_stride, groups=cfg.upsample_groups,
    )
    tstate, emb = transformer_stream_step(params["decoder_transformer"], cfg, state.transformer, emb)
    dec_state, pcm = seanet_stream_step(build_decoder_plan(cfg), params["decoder"], state.decoder, emb)
    return MimiStreamState(up_tail, tstate, dec_state), pcm
