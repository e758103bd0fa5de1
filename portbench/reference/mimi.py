"""Plain float32 Mimi decoder over a kyutai/HF `MimiModel` state dict.

codes [K, T] -> split RVQ decode (semantic level 0, acoustic levels 1..)
-> depthwise transposed-conv upsample (x2) -> decoder transformer (pre-norm
LayerNorm blocks, split-half RoPE, causal attention in a sliding window,
LayerScale, GELU MLP) -> SEANet decoder (causal convolutions, transposed
convolutions trimmed on the right, residual blocks, ELU) -> PCM
[T * 1920]. The whole sequence is decoded at once; the causal padding makes
this equal to decoding it frame by frame. The encoder side, which the
decoder does not read, is listed only so that a state dict can be made.

`cfg` is the configuration file's `codec` dict (kyutai/mimi's published
values). Imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.quant import Precision, fake_quant, round_table


def decoder_plan(cfg: dict) -> List[dict]:
    """The SEANet decoder's layers, in the state dict's index order."""
    ratios, nf = cfg["upsampling_ratios"], cfg["num_filters"]
    scale = 2 ** len(ratios)
    plan = [dict(kind="conv", cin=cfg["hidden_size"], cout=scale * nf, k=cfg["kernel_size"])]
    for r in ratios:
        cur = scale * nf
        plan.append(dict(kind="elu"))
        plan.append(dict(kind="convtr", cin=cur, cout=cur // 2, k=2 * r, stride=r))
        for j in range(cfg["num_residual_layers"]):
            plan.append(dict(kind="resnet", ch=cur // 2, hidden=cur // 2 // cfg["compress"],
                             k=cfg["residual_kernel_size"], dilation=cfg["dilation_growth_rate"] ** j))
        scale //= 2
    plan.append(dict(kind="elu"))
    plan.append(dict(kind="conv", cin=nf, cout=cfg["audio_channels"], k=cfg["last_kernel_size"]))
    return plan


def encoder_plan(cfg: dict) -> List[dict]:
    """The SEANet encoder's layers, in the state dict's index order."""
    nf = cfg["num_filters"]
    plan = [dict(kind="conv", cin=cfg["audio_channels"], cout=nf, k=cfg["kernel_size"])]
    scale = 1
    for r in reversed(cfg["upsampling_ratios"]):
        cur = scale * nf
        for j in range(cfg["num_residual_layers"]):
            plan.append(dict(kind="resnet", ch=cur, hidden=cur // cfg["compress"],
                             k=cfg["residual_kernel_size"], dilation=cfg["dilation_growth_rate"] ** j))
        plan.append(dict(kind="elu"))
        plan.append(dict(kind="conv", cin=cur, cout=2 * cur, k=2 * r, stride=r))
        scale *= 2
    plan.append(dict(kind="elu"))
    plan.append(dict(kind="conv", cin=scale * nf, cout=cfg["hidden_size"], k=cfg["last_kernel_size"]))
    return plan


def samples_per_frame(cfg: dict) -> int:
    return math.prod(cfg["upsampling_ratios"]) * 2


_TRANSFORMER_LINEARS = ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                        "self_attn.v_proj.weight", "self_attn.o_proj.weight",
                        "mlp.fc1.weight", "mlp.fc2.weight")


class MimiDecoder:
    """The decoder at one precision: the transformer's linear weights at
    `matrix_bits` when the configuration quantizes them (`cfg["int8_linears"]`),
    its ring at `kv_bits` when the configuration keeps an int8 ring
    (`cfg["kv8_ring"]`), every other weight at `table`."""

    def __init__(self, state: Dict[str, torch.Tensor], cfg: dict, prec: Precision, device):
        self.cfg, self.device = cfg, device
        self.kv_bits = prec.kv_bits if cfg.get("kv8_ring") else None

        def table(key):
            return round_table(state[key].to(device), prec.table)

        def linear(key):  # [out, in] -> [in, out]
            w = state[key].to(device)
            if cfg.get("int8_linears") and prec.matrix_bits is not None:
                return fake_quant(w, prec.matrix_bits, axis=1).T.contiguous()
            return round_table(w, prec.table).T.contiguous()

        self.table = table
        q = "quantizer."
        self.rvq = []
        for side, n in (("semantic", cfg["num_semantic_quantizers"]),
                        ("acoustic", cfg["num_quantizers"] - cfg["num_semantic_quantizers"])):
            p = f"{q}{side}_residual_vector_quantizer."
            embeds = torch.stack([
                table(f"{p}layers.{i}.codebook.embed_sum")
                / torch.clamp_min(state[f"{p}layers.{i}.codebook.cluster_usage"].to(device).float(),
                                  1e-5)[:, None]
                for i in range(n)])
            self.rvq.append((embeds, table(p + "output_proj.weight")[:, :, 0].T))
        self.upsample = table("upsample.conv.weight")  # [C, 1, K] depthwise
        L = cfg["num_hidden_layers"]
        self.layers = []
        for i in range(L):
            p = f"decoder_transformer.layers.{i}."
            lp = {k: linear(p + k) for k in _TRANSFORMER_LINEARS}
            for k in ("input_layernorm.weight", "input_layernorm.bias",
                      "post_attention_layernorm.weight", "post_attention_layernorm.bias",
                      "self_attn_layer_scale.scale", "mlp_layer_scale.scale"):
                lp[k] = table(p + k)
            self.layers.append(lp)
        self.plan = decoder_plan(cfg)

    # ---- stages ----------------------------------------------------------

    def _rvq(self, codes):  # [K, T] -> [T, hidden]
        out = 0
        ns = self.cfg["num_semantic_quantizers"]
        for (embeds, out_proj), part in zip(self.rvq, (codes[:ns], codes[ns:])):
            if part.shape[0] == 0:
                continue
            acc = sum(embeds[i][part[i].long()] for i in range(part.shape[0]))
            out = out + acc @ out_proj
        return out

    def _transformer(self, x):  # [T, d]
        cfg = self.cfg
        T, d = x.shape
        H, hd = cfg["num_attention_heads"], cfg["head_dim"]
        exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
        inv_freq = 1.0 / torch.pow(torch.tensor(float(cfg["rope_theta"]), device=x.device), exponent)
        freqs = torch.arange(T, device=x.device).float()[:, None] * inv_freq
        emb = torch.cat([freqs, freqs], dim=-1)
        cos, sin = torch.cos(emb)[:, None], torch.sin(emb)[:, None]
        t = torch.arange(T, device=x.device)
        mask = (t[:, None] >= t[None, :]) & (t[:, None] - t[None, :] < cfg["sliding_window"])

        def rope(z):
            rot = torch.cat([-z[..., hd // 2:], z[..., : hd // 2]], dim=-1)
            return z * cos + rot * sin

        def ln(z, w, b):
            mu = z.mean(dim=-1, keepdim=True)
            var = ((z - mu) ** 2).mean(dim=-1, keepdim=True)
            return (z - mu) * torch.rsqrt(var + cfg["norm_eps"]) * w + b

        for lp in self.layers:
            h = ln(x, lp["input_layernorm.weight"], lp["input_layernorm.bias"])
            q = rope((h @ lp["self_attn.q_proj.weight"]).reshape(T, H, hd))
            k = rope((h @ lp["self_attn.k_proj.weight"]).reshape(T, H, hd))
            v = (h @ lp["self_attn.v_proj.weight"]).reshape(T, H, hd)
            k, v = fake_quant(k, self.kv_bits, axis=-1), fake_quant(v, self.kv_bits, axis=-1)
            logits = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
            probs = torch.softmax(logits.masked_fill(~mask, -math.inf), dim=-1)
            att = torch.einsum("hqk,khd->qhd", probs, v).reshape(T, H * hd)
            x = x + (att @ lp["self_attn.o_proj.weight"]) * lp["self_attn_layer_scale.scale"]
            h = ln(x, lp["post_attention_layernorm.weight"], lp["post_attention_layernorm.bias"])
            mlp = F.gelu(h @ lp["mlp.fc1.weight"]) @ lp["mlp.fc2.weight"]
            x = x + mlp * lp["mlp_layer_scale.scale"]
        return x

    def _conv(self, x, key, dilation=1, stride=1):  # x [1, C, L], causal, zero left pad
        w = self.table(key + ".weight")
        eff = (w.shape[-1] - 1) * dilation + 1
        length = x.shape[-1]
        n_frames = (length - eff + eff - stride) / stride + 1
        extra = (math.ceil(n_frames) - 1) * stride + eff - (eff - stride) - length
        x = F.pad(x, (eff - stride, extra))
        return F.conv1d(x, w, self.table(key + ".bias"), stride=stride, dilation=dilation)

    def _convtr(self, x, key, stride):  # trimmed on the right (trim_right_ratio 1)
        w = self.table(key + ".weight")
        y = F.conv_transpose1d(x, w, self.table(key + ".bias"), stride=stride)
        return y[..., : y.shape[-1] - (w.shape[-1] - stride)]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [K, T] -> PCM [T * samples_per_frame] float32."""
        codes = codes.to(self.device)
        x = self._rvq(codes)  # [T, d]
        K = self.upsample.shape[-1]
        y = F.conv_transpose1d(x.T[None], self.upsample, stride=2, groups=self.upsample.shape[0])
        x = y[0, :, : y.shape[-1] - (K - 2)].T  # [2T, d]
        x = self._transformer(x).T[None]  # [1, d, 2T]
        for i, spec in enumerate(self.plan):
            base = f"decoder.layers.{i}"
            if spec["kind"] == "elu":
                x = F.elu(x)
            elif spec["kind"] == "conv":
                x = self._conv(x, base + ".conv")
            elif spec["kind"] == "convtr":
                x = self._convtr(x, base + ".conv", spec["stride"])
            else:
                h = self._conv(F.elu(x), base + ".block.1.conv", dilation=spec["dilation"])
                x = x + self._conv(F.elu(h), base + ".block.3.conv")
        return x[0, 0]
