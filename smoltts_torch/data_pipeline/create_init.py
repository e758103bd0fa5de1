"""Model inits, as the JAX package's `data_pipeline/create_init.py`.

1. `create_bytelevel_init`: a fresh byte-level init dir, `tokenizer.json`
   + `config.json` + random weights (`model.safetensors`), ready for
   `smoltts_torch.train.main` with `use_pretrained` true or false.

2. `convert_lm_init`: a warm start from a Llama-style HF LM state dict (the
   SmolLM2-135M recipe): embedding, attention and MLP keys renamed to the
   DualAR schema, q/k/v fused into wqkv, and the embedding table EXTENDED to
   `vocab_size` with rows set to the mean of the existing ones.

    python -m smoltts_torch.data_pipeline.create_init -o init_dir [--size 70m|150m]
        [--config config.json] [--seed N] [--no-weights] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from smoltts_torch import resolve_device
from smoltts_torch.config import DualARConfig, smoltts_byte_150m, smoltts_byte_70m


def create_bytelevel_init(out_dir, cfg: DualARConfig, seed: int = 0,
                          save_weights: bool = True, device=None) -> None:
    """Weights are drawn by `init_params` from `torch.Generator` seeded with
    `seed`, on `device` (None means CUDA, checked before anything is
    written)."""
    from smoltts_torch.io.checkpoint import save_params
    from smoltts_torch.models.dual_ar import init_params
    from smoltts_torch.tokenizer import save_byte_level_tokenizer

    dev = resolve_device(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_byte_level_tokenizer(out, cfg.codebook_size)
    if save_weights:
        params = init_params(cfg, torch.Generator().manual_seed(seed), device=dev)
        save_params(params, cfg, out)
    else:
        cfg.save(out / "config.json")
    print(f"Wrote init to {out}")


_HF_RENAMES = [
    ("model.embed_tokens.weight", "embeddings.weight"),
    ("model.norm.weight", "norm.weight"),
    ("lm_head.weight", "output.weight"),
]
_LAYER_RENAMES = [
    ("self_attn.o_proj.weight", "attention.wo.weight"),
    ("mlp.gate_proj.weight", "feed_forward.w1.weight"),
    ("mlp.down_proj.weight", "feed_forward.w2.weight"),
    ("mlp.up_proj.weight", "feed_forward.w3.weight"),
    ("input_layernorm.weight", "attention_norm.weight"),
    ("post_attention_layernorm.weight", "ffn_norm.weight"),
]


def convert_lm_init(
    hf_state: Dict[str, np.ndarray], cfg: DualARConfig, n_layers: int
) -> Dict[str, np.ndarray]:
    """HF Llama-style state dict -> DualAR slow-trunk state dict (numpy).

    Fast-trunk weights are NOT produced (random-init those); the returned
    dict uses the reference checkpoint schema, so it merges with
    `io.checkpoint.params_from_state_dict`.
    """
    out: Dict[str, np.ndarray] = {}
    for src, dst in _HF_RENAMES:
        if src in hf_state:
            out[dst] = np.asarray(hf_state[src])
    for i in range(n_layers):
        pre = f"model.layers.{i}."
        q = hf_state[pre + "self_attn.q_proj.weight"]
        k = hf_state[pre + "self_attn.k_proj.weight"]
        v = hf_state[pre + "self_attn.v_proj.weight"]
        out[f"layers.{i}.attention.wqkv.weight"] = np.concatenate([q, k, v], axis=0)
        for src, dst in _LAYER_RENAMES:
            out[f"layers.{i}.{dst}"] = np.asarray(hf_state[pre + src])

    # Extend the embedding table with rows set to the mean embedding.
    emb = np.asarray(out["embeddings.weight"])
    if emb.shape[0] < cfg.vocab_size:
        mean = emb.mean(axis=0, keepdims=True)
        extra = np.repeat(mean, cfg.vocab_size - emb.shape[0], axis=0)
        out["embeddings.weight"] = np.concatenate([emb, extra], axis=0)
        if "output.weight" in out and not cfg.tie_word_embeddings:
            o = np.asarray(out["output.weight"])
            out["output.weight"] = np.concatenate(
                [o, np.repeat(o.mean(axis=0, keepdims=True), cfg.vocab_size - o.shape[0], axis=0)],
                axis=0,
            )
        elif cfg.tie_word_embeddings:
            out.pop("output.weight", None)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Create a byte-level model init")
    parser.add_argument("-o", "--out-dir", required=True)
    parser.add_argument(
        "--size", choices=["70m", "150m"], default="150m", help="released model sizes"
    )
    parser.add_argument("--config", type=str, help="explicit model config.json")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-weights", action="store_true")
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    args = parser.parse_args(argv)

    if args.config:
        cfg = DualARConfig.from_json_file(args.config)
    else:
        cfg = smoltts_byte_150m() if args.size == "150m" else smoltts_byte_70m()
    create_bytelevel_init(args.out_dir, cfg, args.seed, save_weights=not args.no_weights,
                          device=args.device)


if __name__ == "__main__":
    main()
