"""Plain float32 DualAR (RQ-Transformer) over a release-format state dict.

The slow transformer reads one ChatML grid of token rows [R, T] (row 0 text
or semantic ids, rows 1.. the codebook ids of the frame the column carries)
and predicts the next slow token; the fast transformer reads, per frame, the
slow hidden state and the embeddings of the frame's codes, and predicts the
codebook levels one by one. Both are pre-norm Llama blocks: RMSNorm, GQA
attention with interleaved-pair RoPE (tables rounded to bfloat16, as the
published model caches them), SwiGLU. The token head is tied to the text
embeddings; the fast head is one [fast_dim, codebook] projection per level
(`depthwise_output`); the fast input table is offset per level
(`depthwise_wte`); code 0 rides both the slow token and row 1
(`duplicate_code_0`).

Everything is computed teacher-forced over whole sequences in float32, with
no cache and no batching across requests; the stored precision of weights
and caches is applied by `quant.Precision`. Imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.quant import Precision, fake_quant, round_table

_LINEARS = ("attention.wqkv.weight", "attention.wo.weight", "feed_forward.w1.weight",
            "feed_forward.w2.weight", "feed_forward.w3.weight")


class DualAR:
    """The model at one precision. `cfg` is the configuration file's
    `model` dict; `vocab` gives `semantic_start` (the id of semantic code 0)."""

    def __init__(self, state: Dict[str, torch.Tensor], cfg: dict, vocab: dict,
                 prec: Precision, device):
        self.cfg, self.prec, self.device = cfg, prec, device
        self.dim, self.n_head, self.n_kv = cfg["dim"], cfg["n_head"], cfg["n_local_heads"]
        self.fast_dim = cfg.get("fast_dim") or self.dim
        self.fast_n_head = cfg.get("fast_n_head") or self.n_head
        self.fast_n_kv = cfg.get("fast_n_local_heads") or self.n_kv
        self.cb = cfg["codebook_size"]
        self.ncb = cfg["num_codebooks"]
        self.eps = cfg.get("norm_eps", 1e-5)
        self.base = float(cfg.get("rope_base", 10_000.0))
        self.sem_start = vocab["semantic_start"]
        self.sem_end = vocab["semantic_start"] + self.cb - 1
        if not (cfg.get("depthwise_wte") and cfg.get("depthwise_output")
                and cfg.get("duplicate_code_0", True) and cfg.get("tie_word_embeddings", True)
                and self.fast_dim == self.dim):
            raise ValueError("the reference covers the released layout: depthwise input and "
                             "output, duplicated code 0, tied head, fast_dim == dim")

        def table(key):
            return round_table(state[key].to(device), prec.table)

        def matrix(key):  # [out, in] as stored -> [in, out] float32
            w = state[key].to(device)
            if prec.matrix_bits is None:
                return round_table(w, prec.table).T.contiguous()
            return fake_quant(w, prec.matrix_bits, axis=1).T.contiguous()

        def trunk(prefix, n_layer):
            out = []
            for i in range(n_layer):
                p = f"{prefix}.{i}."
                layer = {k: matrix(p + k) for k in _LINEARS}
                layer["attention_norm"] = table(p + "attention_norm.weight")
                layer["ffn_norm"] = table(p + "ffn_norm.weight")
                out.append(layer)
            return out

        self.emb = table("embeddings.weight")
        self.cb_emb = table("codebook_embeddings.weight")
        self.norm = table("norm.weight")
        self.layers = trunk("layers", cfg["n_layer"])
        self.fast_emb = table("fast_embeddings.weight")
        self.fast_norm = table("fast_norm.weight")
        self.fast_layers = trunk("fast_layers", cfg["n_fast_layer"])
        head = state["fast_output.weight"].to(device)  # [n * cb, fast_dim], level-major
        if prec.matrix_bits is None:
            head = round_table(head, prec.table)
        else:
            head = fake_quant(head, prec.matrix_bits, axis=1)
        self.fast_head = head.reshape(self.ncb, self.cb, self.fast_dim).transpose(1, 2)

    # ---- blocks --------------------------------------------------------

    def _rms(self, x, w):
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.eps) * w

    def _rope(self, positions, hd):
        exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=self.device) / hd
        inv_freq = 1.0 / torch.pow(torch.tensor(self.base, dtype=torch.float32,
                                                device=self.device), exponent)
        angles = positions.float()[:, None] * inv_freq
        return (torch.cos(angles).to(torch.bfloat16).float(),
                torch.sin(angles).to(torch.bfloat16).float())

    @staticmethod
    def _apply_rope(x, cos, sin):  # x [N, T, H, hd]; cos/sin [T, hd/2]
        pairs = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
        x0, x1 = pairs[..., 0], pairs[..., 1]
        c, s = cos[:, None, :], sin[:, None, :]
        return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).reshape(x.shape)

    def _trunk(self, layers, x, n_head, n_kv, cos, sin, kv_bits):
        """Causal pre-norm blocks over x [N, T, D]."""
        N, T, D = x.shape
        hd = D // n_head
        g = n_head // n_kv
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        for lp in layers:
            h = self._rms(x, lp["attention_norm"])
            qkv = h @ lp["attention.wqkv.weight"]
            q, k, v = torch.split(qkv, [n_head * hd, n_kv * hd, n_kv * hd], dim=-1)
            q = self._apply_rope(q.reshape(N, T, n_head, hd), cos, sin)
            k = self._apply_rope(k.reshape(N, T, n_kv, hd), cos, sin)
            v = v.reshape(N, T, n_kv, hd)
            k, v = fake_quant(k, kv_bits, axis=-1), fake_quant(v, kv_bits, axis=-1)
            qg = q.reshape(N, T, n_kv, g, hd)
            logits = torch.einsum("nqhgd,nkhd->nhgqk", qg, k) * (hd ** -0.5)
            logits = logits.masked_fill(~causal, -math.inf)
            att = torch.einsum("nhgqk,nkhd->nqhgd", torch.softmax(logits, dim=-1), v)
            x = x + att.reshape(N, T, D) @ lp["attention.wo.weight"]
            h = self._rms(x, lp["ffn_norm"])
            a = F.silu(h @ lp["feed_forward.w1.weight"]) * (h @ lp["feed_forward.w3.weight"])
            x = x + a @ lp["feed_forward.w2.weight"]
        return x

    # ---- model ---------------------------------------------------------

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [R, T] -> [T, D]: the text embedding, plus the sum of the
        frame's codebook embeddings where row 0 is a semantic id."""
        tokens = tokens.long().to(self.device)
        x = self.emb[tokens[0]]
        offs = torch.arange(self.ncb, device=self.device)[:, None] * self.cb
        cb = self.cb_emb[tokens[1:] + offs].sum(dim=0)
        semantic = (tokens[0] >= self.sem_start) & (tokens[0] <= self.sem_end)
        return x + torch.where(semantic[:, None], cb, torch.zeros_like(cb))

    def slow(self, tokens: torch.Tensor) -> torch.Tensor:
        """Pre-norm hidden states [T, D] of the slow trunk over tokens [R, T]."""
        x = self.embed(tokens)[None]
        T = x.shape[1]
        cos, sin = self._rope(torch.arange(T, device=self.device), self.dim // self.n_head)
        return self._trunk(self.layers, x, self.n_head, self.n_kv, cos, sin,
                           self.prec.kv_bits)[0]

    def token_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[N, D] pre-norm hidden -> [N, vocab] (the tied head)."""
        return self._rms(hidden, self.norm) @ self.emb.T

    def code_logits(self, hidden: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """Teacher-forced fast trunk: hidden [N, D] of the predicting
        positions and the frames' codes [N, ncb] -> logits [N, ncb, cb]
        (level i sees the hidden and codes 0..i-1)."""
        codes = codes.long().to(self.device)
        n = self.ncb
        offs = torch.arange(n - 1, device=self.device) * self.cb
        x = torch.cat([hidden[:, None], self.fast_emb[codes[:, : n - 1] + offs]], dim=1)
        cos, sin = self._rope(torch.arange(n, device=self.device), self.fast_dim // self.fast_n_head)
        # the fast trunk's cache holds float32 (no kv8)
        x = self._trunk(self.fast_layers, x, self.fast_n_head, self.fast_n_kv, cos, sin, None)
        out = self._rms(x, self.fast_norm)  # [N, n, D]
        return torch.einsum("nid,idc->nic", out, self.fast_head)

    def served_logits(self, prompt: torch.Tensor, frames: torch.Tensor):
        """The logits behind each served token of one stream: prompt [R, T0]
        and its served frames [n, R] (slow token, then the codes) ->
        (slow logits [n, vocab], code logits [n, ncb, cb]). Frame j is
        predicted at position T0 - 1 + j, having read frames 0..j-1."""
        prompt = prompt.to(self.device)
        frames = frames.to(self.device)
        seq = torch.cat([prompt, frames[:-1].T.to(prompt.dtype)], dim=1)
        h = self.slow(seq)[prompt.shape[1] - 1:]
        return self.token_logits(h), self.code_logits(h, frames[:, 1:])
