"""Release-format DualAR checkpoints: torch state dicts (`model.pth`, possibly
with legacy separate wq/wk/wv and a 3-D depthwise `fast_output.weight`) and
the flattened safetensors export, to and from the parameter tree of
`models/dual_ar.py`:

- linear kernels [in, out] (the state dict stores [out, in]);
- per-trunk layer weights stacked on a leading layer axis;
- the depthwise fast head [position, fast_dim, codebook_size] (exported 2-D
  as [position * codebook_size, fast_dim]).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig
from smoltts_torch.interop import tree_map
from smoltts_torch.io.safetensors import load_file, save_file

_TRUNK_LINEARS = {
    "attention.wqkv.weight": ("wqkv", True),
    "attention.wo.weight": ("wo", True),
    "feed_forward.w1.weight": ("w1", True),
    "feed_forward.w2.weight": ("w2", True),
    "feed_forward.w3.weight": ("w3", True),
    "attention_norm.weight": ("attention_norm", False),
    "ffn_norm.weight": ("ffn_norm", False),
    "attention.wqkv.bias": ("wqkv_bias", False),
}


def _normalize_torch_keys(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip torch.compile's `_orig_mod.` prefix and fuse legacy wq/wk/wv
    into wqkv."""
    state = {k.replace("_orig_mod.", ""): v for k, v in state.items()}
    out = dict(state)
    for key in list(state):
        if key.endswith("attention.wq.weight"):
            prefix = key[: -len("wq.weight")]
            parts = [out.pop(prefix + f"{n}.weight") for n in ("wq", "wk", "wv")]
            out[prefix + "wqkv.weight"] = torch.cat(parts, dim=0)
    return out


def _stack_trunk(state: Dict[str, torch.Tensor], prefix: str, n_layer: int) -> dict:
    trunk: dict = {}
    for suffix, (name, transpose) in _TRUNK_LINEARS.items():
        if f"{prefix}.0.{suffix}" not in state:
            continue
        arr = torch.stack([state[f"{prefix}.{i}.{suffix}"] for i in range(n_layer)], dim=0)
        trunk[name] = arr.transpose(1, 2).contiguous() if transpose else arr
    return trunk


def params_from_state_dict(state: Dict[str, torch.Tensor], cfg: DualARConfig) -> dict:
    """A reference state dict (tensor-valued) -> the parameter tree."""
    state = _normalize_torch_keys(state)
    params: dict = {
        "embeddings": state["embeddings.weight"],
        "codebook_embeddings": state["codebook_embeddings.weight"],
        "layers": _stack_trunk(state, "layers", cfg.n_layer),
        "norm": state["norm.weight"],
        "fast_embeddings": state["fast_embeddings.weight"],
        "fast_layers": _stack_trunk(state, "fast_layers", cfg.n_fast_layer),
        "fast_norm": state["fast_norm.weight"],
    }
    if "output.weight" in state:
        params["output"] = state["output.weight"].T.contiguous()
    if "fast_project_in.weight" in state and cfg.fast_dim != cfg.dim:
        params["fast_project_in"] = {
            "kernel": state["fast_project_in.weight"].T.contiguous(),
            "bias": state["fast_project_in.bias"],
        }
    w = state["fast_output.weight"]
    n, cb = cfg.max_fast_seqlen, cfg.codebook_size
    if not cfg.depthwise_output:
        params["fast_output"] = w.T.contiguous()  # [cb, fast_dim] -> [fast_dim, cb]
    elif w.dim() == 3:  # DepthwiseLinear [n, fast_dim, cb]
        params["fast_output"] = w
    else:  # flattened export [n * cb, fast_dim]
        if tuple(w.shape) != (n * cb, cfg.fast_dim):
            raise ValueError(f"fast_output.weight shape {tuple(w.shape)}, expected "
                             f"{(n * cb, cfg.fast_dim)}")
        params["fast_output"] = w.reshape(n, cb, cfg.fast_dim).transpose(1, 2).contiguous()
    return params


def state_dict_from_params(params: dict, cfg: DualARConfig) -> Dict[str, torch.Tensor]:
    """The parameter tree -> the reference safetensors schema (flattened
    depthwise head)."""
    state: Dict[str, torch.Tensor] = {
        "embeddings.weight": params["embeddings"],
        "codebook_embeddings.weight": params["codebook_embeddings"],
        "norm.weight": params["norm"],
        "fast_embeddings.weight": params["fast_embeddings"],
        "fast_norm.weight": params["fast_norm"],
    }
    for trunk, prefix, n_layer in (("layers", "layers", cfg.n_layer),
                                   ("fast_layers", "fast_layers", cfg.n_fast_layer)):
        for suffix, (name, transpose) in _TRUNK_LINEARS.items():
            if name not in params[trunk]:
                continue
            arr = params[trunk][name]
            for i in range(n_layer):
                state[f"{prefix}.{i}.{suffix}"] = arr[i].T if transpose else arr[i]
    if "output" in params:
        state["output.weight"] = params["output"].T
    if "fast_project_in" in params:
        state["fast_project_in.weight"] = params["fast_project_in"]["kernel"].T
        state["fast_project_in.bias"] = params["fast_project_in"]["bias"]
    w = params["fast_output"]
    if cfg.depthwise_output:
        n, fd, cb = w.shape
        state["fast_output.weight"] = w.permute(1, 0, 2).reshape(fd, n * cb).T
    else:
        state["fast_output.weight"] = w.T
    return {k: v.contiguous() for k, v in state.items()}


def load_params(checkpoint_dir: Union[str, Path], cfg: DualARConfig, dtype=None,
                device=None) -> dict:
    """LM params from a checkpoint dir holding `model.safetensors`
    (preferred) or `model.pth` (a torch train checkpoint, read as f32).
    Leaves keep the file's dtype unless `dtype` is given. `device=None`
    means CUDA (checked before any file is read)."""
    dev = resolve_device(device)
    d = Path(checkpoint_dir)
    st_path = d / "model.safetensors"
    if st_path.exists():
        state = load_file(st_path)
    else:
        raw = torch.load(d / "model.pth", map_location="cpu", weights_only=True)
        if "model_state_dict" in raw:
            raw = raw["model_state_dict"]
        state = {k: v.to(torch.float32) for k, v in raw.items()}
    params = params_from_state_dict(state, cfg)
    return tree_map(lambda t: t.to(device=dev, dtype=dtype or t.dtype), params)


def save_params(params: dict, cfg: DualARConfig, checkpoint_dir: Union[str, Path]) -> None:
    """Write `model.safetensors` + `config.json` in the reference schema."""
    d = Path(checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    save_file(state_dict_from_params(params, cfg), d / "model.safetensors")
    cfg.save(d / "config.json")
