"""Seeded random weights in the release checkpoint layouts, made on the
device: the DualAR state dict as the released `model.safetensors` names
it, and the kyutai/HF Mimi state dict.

Every matrix and table is a view of one buffer of standard normal draws
from a `torch.Generator` seeded with the run's seed, scaled as the model's
initializers scale it (DualAR: `initializer_range`; Mimi: 1 / sqrt(fan-in),
codebooks N(0, 1)); norms, biases and LayerScale are constants. The same
seed on the same device gives the same bits, so the program and the
reference are each handed an identical copy, made anew.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.mimi import decoder_plan, encoder_plan

Spec = Tuple[str, tuple, object]  # (key, shape, std for draws or ("const", value))


def dual_ar_specs(cfg: dict) -> List[Spec]:
    """(key, shape, init) of every tensor of the released DualAR layout."""
    std = cfg["initializer_range"]
    dim, fd = cfg["dim"], cfg.get("fast_dim") or cfg["dim"]
    hd = dim // cfg["n_head"]
    fhd = fd // (cfg.get("fast_n_head") or cfg["n_head"])
    cb, ncb = cfg["codebook_size"], cfg["num_codebooks"]
    specs: List[Spec] = [
        ("embeddings.weight", (cfg["vocab_size"], dim), std),
        ("codebook_embeddings.weight", (cb * ncb, dim), std),
        ("norm.weight", (dim,), ("const", 1.0)),
        ("fast_embeddings.weight", (cb * (ncb - 1), fd), std),
        ("fast_norm.weight", (fd,), ("const", 1.0)),
        ("fast_output.weight", (ncb * cb, fd), std),
    ]
    trunks = (("layers", cfg["n_layer"], dim, cfg["n_head"], cfg["n_local_heads"], hd,
               cfg["intermediate_size"]),
              ("fast_layers", cfg["n_fast_layer"], fd, cfg.get("fast_n_head") or cfg["n_head"],
               cfg.get("fast_n_local_heads") or cfg["n_local_heads"], fhd,
               cfg.get("fast_intermediate_size") or cfg["intermediate_size"]))
    for prefix, n_layer, d, h, kv, head_dim, ff in trunks:
        for i in range(n_layer):
            p = f"{prefix}.{i}."
            specs += [
                (p + "attention.wqkv.weight", ((h + 2 * kv) * head_dim, d), std),
                (p + "attention.wo.weight", (d, h * head_dim), std),
                (p + "feed_forward.w1.weight", (ff, d), std),
                (p + "feed_forward.w3.weight", (ff, d), std),
                (p + "feed_forward.w2.weight", (d, ff), std),
                (p + "attention_norm.weight", (d,), ("const", 1.0)),
                (p + "ffn_norm.weight", (d,), ("const", 1.0)),
            ]
    return specs


def _conv_specs(prefix: str, plan: List[dict], transposed_kind: str = "convtr") -> List[Spec]:
    out: List[Spec] = []
    for i, spec in enumerate(plan):
        base = f"{prefix}.layers.{i}"
        if spec["kind"] == "conv":
            out += [(base + ".conv.weight", (spec["cout"], spec["cin"], spec["k"]),
                     (spec["cin"] * spec["k"]) ** -0.5),
                    (base + ".conv.bias", (spec["cout"],), ("const", 0.0))]
        elif spec["kind"] == transposed_kind:
            out += [(base + ".conv.weight", (spec["cin"], spec["cout"], spec["k"]),
                     (spec["cin"] * spec["k"]) ** -0.5),
                    (base + ".conv.bias", (spec["cout"],), ("const", 0.0))]
        elif spec["kind"] == "resnet":
            ch, hid, k = spec["ch"], spec["hidden"], spec["k"]
            out += [(base + ".block.1.conv.weight", (hid, ch, k), (ch * k) ** -0.5),
                    (base + ".block.1.conv.bias", (hid,), ("const", 0.0)),
                    (base + ".block.3.conv.weight", (ch, hid, 1), hid ** -0.5),
                    (base + ".block.3.conv.bias", (ch,), ("const", 0.0))]
    return out


def mimi_specs(cfg: dict) -> List[Spec]:
    """(key, shape, init) of every tensor of the kyutai/HF Mimi layout."""
    d, ff, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    cdim, cbs = cfg["codebook_dim"], cfg["codebook_size"]
    K = 4  # the stride-2 down/upsample kernel
    specs = _conv_specs("encoder", encoder_plan(cfg)) + _conv_specs("decoder", decoder_plan(cfg))
    for name in ("encoder_transformer", "decoder_transformer"):
        for i in range(L):
            p = f"{name}.layers.{i}."
            specs += [(p + f"self_attn.{k}_proj.weight", (d, d), d ** -0.5) for k in "qkvo"]
            specs += [(p + "mlp.fc1.weight", (ff, d), d ** -0.5),
                      (p + "mlp.fc2.weight", (d, ff), ff ** -0.5)]
            for ln in ("input_layernorm", "post_attention_layernorm"):
                specs += [(p + ln + ".weight", (d,), ("const", 1.0)),
                          (p + ln + ".bias", (d,), ("const", 0.0))]
            specs += [(p + "self_attn_layer_scale.scale", (d,),
                       ("const", cfg["layer_scale_initial_scale"])),
                      (p + "mlp_layer_scale.scale", (d,),
                       ("const", cfg["layer_scale_initial_scale"]))]
    specs += [("downsample.conv.weight", (d, d, K), (d * K) ** -0.5),
              ("upsample.conv.weight", (d, 1, K), 0.5)]
    ns = cfg["num_semantic_quantizers"]
    for side, n in (("semantic", ns), ("acoustic", cfg["num_quantizers"] - ns)):
        p = f"quantizer.{side}_residual_vector_quantizer."
        specs += [(p + "input_proj.weight", (cdim, d, 1), d ** -0.5),
                  (p + "output_proj.weight", (d, cdim, 1), cdim ** -0.5)]
        for i in range(n):
            specs += [(p + f"layers.{i}.codebook.embed_sum", (cbs, cdim), 1.0),
                      (p + f"layers.{i}.codebook.cluster_usage", (cbs,), ("const", 1.0))]
    return specs


def make_state(specs: List[Spec], seed: int, device, dtype=torch.bfloat16,
               stream: int = 0) -> Dict[str, torch.Tensor]:
    """The state dict of `specs` from `seed`: one call draws every random
    tensor at once; `stream` separates two state dicts of one seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2 + stream) % (1 << 63))
    drawn = [(k, s, v) for k, s, v in specs if not isinstance(v, tuple)]
    total = sum(_numel(s) for _, s, _ in drawn)
    buf = torch.randn((total,), generator=gen, dtype=dtype, device=device)
    out, off = {}, 0
    for key, shape, std in drawn:
        n = _numel(shape)
        out[key] = buf[off: off + n].view(shape).mul_(std)
        off += n
    for key, shape, init in specs:
        if isinstance(init, tuple):
            out[key] = torch.full(shape, init[1], dtype=dtype, device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
