"""Mimi codec: weight import, random init, batch encode and decode, and the
streaming decode step.

  encode: audio [B, L, 1] -> SEANet encoder -> encoder transformer ->
          stride-2 downsample -> split-RVQ encode -> codes [B, nq, T]
  decode: codes [B, K, T] -> RVQ decode -> depthwise transpose-conv upsample
          -> decoder transformer -> SEANet decoder -> PCM [B, T * 1920, 1]

Weights load from the kyutai/mimi safetensors release or any HF
`MimiModel` state dict (one key schema): convs become [K, I/groups, O],
transpose-conv kernels are pre-flipped, codebooks are materialized as
`embed_sum / max(cluster_usage, 1e-5)`.

`init_mimi_params` draws with `np.random.default_rng(seed)` in the JAX
package's order, draw for draw, so equal seeds give equal weights in both
packages with no bridge.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from smoltts_torch import resolve_device
from smoltts_torch.codec.config import MimiConfig
from smoltts_torch.codec.conv import (
    causal_conv1d,
    causal_conv_transpose1d,
    convtr_stream_init,
    convtr_stream_step,
)
from smoltts_torch.codec.rvq import split_rvq_decode, split_rvq_encode
from smoltts_torch.codec.seanet import (
    ConvSpec,
    build_decoder_plan,
    build_encoder_plan,
    seanet_apply,
    seanet_stream_init,
    seanet_stream_step,
)
from smoltts_torch.codec.transformer import (
    TransformerRingState,
    flush_transformer_ring,
    ring_state_init,
    transformer_forward,
    transformer_stream_step,
)
from smoltts_torch.interop import TensorTree, tree_map
from smoltts_torch.io.safetensors import load_file
from smoltts_torch.parallel.mesh import chunk_ranges

MimiParams = Dict[str, object]


# ---- weight import ---------------------------------------------------------


def _conv_w(state, key, bias_key=None) -> dict:
    """torch Conv1d weight [O, I/groups, K] -> [K, I/groups, O]."""
    p = {"w": state[key].permute(2, 1, 0).contiguous()}
    if bias_key and bias_key in state:
        p["b"] = state[bias_key]
    return p


def _convtr_w(state, key, bias_key, groups: int) -> dict:
    """torch ConvTranspose1d weight [I, O/groups, K] -> flipped [K, I/groups, O]:
    [I, O, K] -> [K, I, O] for groups == 1, [I, 1, K] -> [K, 1, I] for the
    depthwise upsample (groups == I)."""
    wf = state[key].flip(-1)
    if groups == 1:
        p = {"w": wf.permute(2, 0, 1).contiguous()}
    elif groups == wf.shape[0] and wf.shape[1] == 1:
        p = {"w": wf.permute(2, 1, 0).contiguous()}
    else:
        raise NotImplementedError(f"grouped convtr groups={groups} shape={tuple(wf.shape)}")
    if bias_key and bias_key in state:
        p["b"] = state[bias_key]
    return p


def _seanet_params(state, plan: List[ConvSpec], prefix: str) -> List:
    params: List = []
    for i, spec in enumerate(plan):
        base = f"{prefix}.layers.{i}"
        if spec.kind == "elu":
            params.append(None)
        elif spec.kind == "conv":
            params.append(_conv_w(state, f"{base}.conv.weight", f"{base}.conv.bias"))
        elif spec.kind == "convtr":
            params.append(_convtr_w(state, f"{base}.conv.weight", f"{base}.conv.bias", groups=1))
        elif spec.kind == "resnet":
            params.append({
                "conv1": _conv_w(state, f"{base}.block.1.conv.weight", f"{base}.block.1.conv.bias"),
                "conv2": _conv_w(state, f"{base}.block.3.conv.weight", f"{base}.block.3.conv.bias"),
            })
    return params


_TRANSFORMER_KEYS = {  # leaf -> (HF key under `{prefix}.layers.{i}.`, transposed)
    "ln1_w": ("input_layernorm.weight", False),
    "ln1_b": ("input_layernorm.bias", False),
    "ln2_w": ("post_attention_layernorm.weight", False),
    "ln2_b": ("post_attention_layernorm.bias", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "fc1": ("mlp.fc1.weight", True),
    "fc2": ("mlp.fc2.weight", True),
    "scale_attn": ("self_attn_layer_scale.scale", False),
    "scale_mlp": ("mlp_layer_scale.scale", False),
}


def _transformer_params(state, prefix: str, n_layers: int) -> dict:
    layers = {}
    for name, (key, transpose) in _TRANSFORMER_KEYS.items():
        a = torch.stack([state[f"{prefix}.layers.{i}.{key}"] for i in range(n_layers)], dim=0)
        layers[name] = a.transpose(1, 2).contiguous() if transpose else a
    return {"layers": layers}


def _rvq_side(state, prefix: str, n_layers: int, eps: float = 1e-5) -> dict:
    embeds = []
    for i in range(n_layers):
        es = state[f"{prefix}.layers.{i}.codebook.embed_sum"]
        cu = state[f"{prefix}.layers.{i}.codebook.cluster_usage"]
        embeds.append(es / torch.clamp_min(cu, eps)[:, None])
    return {
        "in_proj": state[f"{prefix}.input_proj.weight"][:, :, 0].T.contiguous(),
        "out_proj": state[f"{prefix}.output_proj.weight"][:, :, 0].T.contiguous(),
        "embed": torch.stack(embeds, dim=0),  # [K, codebook_size, dim]
    }


def params_from_hf_state_dict(state: Dict[str, torch.Tensor], cfg: MimiConfig) -> MimiParams:
    """The parameter tree from a kyutai/HF Mimi state dict (tensor-valued)."""
    q = "quantizer"
    return {
        "encoder": _seanet_params(state, build_encoder_plan(cfg), "encoder"),
        "encoder_transformer": _transformer_params(state, "encoder_transformer",
                                                   cfg.num_hidden_layers),
        "downsample": _conv_w(state, "downsample.conv.weight", "downsample.conv.bias"),
        "upsample": _convtr_w(state, "upsample.conv.weight", "upsample.conv.bias",
                              groups=cfg.upsample_groups),
        "decoder_transformer": _transformer_params(state, "decoder_transformer",
                                                   cfg.num_hidden_layers),
        "decoder": _seanet_params(state, build_decoder_plan(cfg), "decoder"),
        "quantizer": {
            "semantic": _rvq_side(state, f"{q}.semantic_residual_vector_quantizer",
                                  cfg.num_semantic_quantizers),
            "acoustic": _rvq_side(state, f"{q}.acoustic_residual_vector_quantizer",
                                  cfg.num_quantizers - cfg.num_semantic_quantizers),
        },
    }


def load_mimi(path: Union[str, Path], cfg: Optional[MimiConfig] = None, dtype=None,
              device=None) -> Tuple[MimiParams, MimiConfig]:
    """Mimi weights from a safetensors file in the kyutai/HF key schema.
    Leaves keep the file's dtype unless `dtype` is given. `device=None` means
    CUDA (checked before the file is read)."""
    dev = resolve_device(device)
    cfg = cfg or MimiConfig()
    params = params_from_hf_state_dict(load_file(path), cfg)
    return tree_map(lambda t: t.to(device=dev, dtype=dtype or t.dtype), params), cfg


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


# ---- batch encode / decode -------------------------------------------------


@torch.no_grad()
def mimi_encode(params: MimiParams, cfg: MimiConfig, audio: torch.Tensor,
                num_quantizers: Optional[int] = None) -> torch.Tensor:
    """audio [B, L] or [B, L, 1] -> codes [B, nq, ceil(L / 1920)] int32."""
    if audio.dim() == 2:
        audio = audio[..., None]
    x = seanet_apply(build_encoder_plan(cfg), params["encoder"], audio, cfg)
    x = transformer_forward(params["encoder_transformer"], cfg, x)
    x = causal_conv1d(x, params["downsample"]["w"], params["downsample"].get("b"),
                      stride=cfg.downsample_stride, pad_mode="replicate")
    return split_rvq_encode(x, params["quantizer"], cfg, num_quantizers)


@torch.no_grad()
def mimi_decode(params: MimiParams, cfg: MimiConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, K, T] -> PCM [B, T * 1920, 1], the whole sequence at once."""
    emb = split_rvq_decode(codes, params["quantizer"], cfg)
    emb = causal_conv_transpose1d(emb, params["upsample"]["w"], params["upsample"].get("b"),
                                  stride=cfg.downsample_stride, groups=cfg.upsample_groups,
                                  trim_right_ratio=cfg.trim_right_ratio)
    emb = transformer_forward(params["decoder_transformer"], cfg, emb)
    return seanet_apply(build_decoder_plan(cfg), params["decoder"], emb, cfg)


class MimiDecoder(TensorTree):
    """The Mimi parameter tree as an `nn.Module`; `.tree()` gives the dict
    `mimi_decode_step` takes."""


class MimiStreamState(NamedTuple):
    upsample_tail: torch.Tensor
    transformer: TransformerRingState
    decoder: List


def decode_stream_init(cfg: MimiConfig, batch: int, dtype=torch.float32, tail_len: int = 64,
                       kv_dtype=None, device=None, mesh=None) -> MimiStreamState:
    """`kv_dtype=torch.int8` puts the codec transformer's ring in kv8 mode.
    `device=None` means CUDA. On a `mesh` (parallel/mesh.py) it is this
    rank's state, batch / n_data slots."""
    dev = resolve_device(device)
    if mesh is not None:
        (b0, b1), = chunk_ranges(batch, mesh.n_data, mesh.data, "slots")
        batch = b1 - b0
    K = cfg.downsample_kernel
    return MimiStreamState(
        upsample_tail=convtr_stream_init(batch, cfg.hidden_size, K, cfg.downsample_stride, dtype, dev),
        transformer=ring_state_init(cfg, batch, kv_dtype or dtype, tail_len=tail_len, device=dev),
        decoder=seanet_stream_init(build_decoder_plan(cfg), batch, dtype, dev),
    )


def reset_stream_slots(state: MimiStreamState, slots: torch.Tensor) -> MimiStreamState:
    """Zero the streaming state of the given batch slots (a new stream
    admitted into a reused decode slot), in place. `slots` is an index tensor
    on the state's device. The slot axis is 0 for the conv buffers and the
    ring bookkeeping, 1 for the ring KV; kv8 scales reset to 1.0."""
    for leaf in _leaves(state.decoder):
        leaf.index_fill_(0, slots, 0)
    state.upsample_tail.index_fill_(0, slots, 0)
    t = state.transformer
    for a in (t.k, t.v):
        a.index_fill_(1, slots, 0)
    t.slot_pos.index_fill_(0, slots, -1)
    t.tail_abs.index_fill_(0, slots, -1)
    t.pos.index_fill_(0, slots, 0)
    for a in (t.k_scale, t.v_scale):
        if a is not None:
            a.index_fill_(1, slots, 1.0)
    return state


def reset_stream_state(state: MimiStreamState) -> MimiStreamState:
    """Every slot of a streaming state back to `decode_stream_init`'s values,
    in place (the ring tails and their write column too), so one state
    serves stream after stream at the same addresses."""
    t = state.transformer
    reset_stream_slots(state, torch.arange(t.pos.shape[0], device=t.pos.device))
    for a in (t.k_tail, t.v_tail, t.t_phase):
        a.zero_()
    return state


def scatter_stream_state(big: MimiStreamState, small: MimiStreamState,
                         slots: torch.Tensor) -> MimiStreamState:
    """Write an n-slot streaming state into the given slots of a B-slot
    state, in place on `big`. The small state's ring tail is flushed first
    (its tail phase may differ from the big state's), so everything it
    carries lives in its ring, and the scattered slots' tail columns are
    emptied."""
    for b, s in zip(_leaves(big.decoder), _leaves(small.decoder)):
        b.index_copy_(0, slots, s)
    big.upsample_tail.index_copy_(0, slots, small.upsample_tail)
    bt, st = big.transformer, flush_transformer_ring(small.transformer)
    for b, s in ((bt.k, st.k), (bt.v, st.v), (bt.k_scale, st.k_scale), (bt.v_scale, st.v_scale)):
        if b is not None:
            b.index_copy_(1, slots, s)
    bt.slot_pos.index_copy_(0, slots, st.slot_pos)
    bt.tail_abs.index_fill_(0, slots, -1)
    bt.pos.index_copy_(0, slots, st.pos)
    return big


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    tree_map(out.append, tree)
    return out


def stream_state_leaves(state: MimiStreamState) -> List[torch.Tensor]:
    """Every tensor of a streaming state, in a fixed order."""
    return [state.upsample_tail, *(a for a in state.transformer if a is not None),
            *_leaves(state.decoder)]


def map_stream_state(fn, state: MimiStreamState) -> MimiStreamState:
    """A streaming state of `fn(leaf)` for every leaf."""
    return MimiStreamState(
        upsample_tail=fn(state.upsample_tail),
        transformer=TransformerRingState(*(None if a is None else fn(a)
                                           for a in state.transformer)),
        decoder=tree_map(fn, state.decoder),
    )


def flush_mimi_state(state: MimiStreamState) -> MimiStreamState:
    """Consolidate the codec transformer's ring tail, in place (every leaf
    keeps its storage)."""
    return state._replace(transformer=flush_transformer_ring(state.transformer))


def mimi_decode_step(params: MimiParams, cfg: MimiConfig, state: MimiStreamState,
                     codes: torch.Tensor):
    """codes [B, K, T_frames] -> (state', PCM [B, T_frames * 1920, 1]). The
    eager reference step: the ring tails are written in place, every other
    leaf of `state'` is new (codec/graph.py steps a state wholly in place)."""
    emb = split_rvq_decode(codes, params["quantizer"], cfg)
    up_tail, emb = convtr_stream_step(
        state.upsample_tail, emb, params["upsample"]["w"], params["upsample"].get("b"),
        stride=cfg.downsample_stride, groups=cfg.upsample_groups,
    )
    tstate, emb = transformer_stream_step(params["decoder_transformer"], cfg, state.transformer, emb)
    dec_state, pcm = seanet_stream_step(build_decoder_plan(cfg), params["decoder"], state.decoder, emb)
    return MimiStreamState(up_tail, tstate, dec_state), pcm
