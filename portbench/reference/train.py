"""Plain float32 training step of the DualAR over a release-format state
dict: the teacher-forced forward (slow trunk, tied token head, the fast
trunk dense over every frame on the next frame's codes, the depthwise
head), the masked cross-entropies (slow head against row 0; all codebook
levels together), autograd, and AdamW with global-norm clipping in optax's
arithmetic (the first moment in float32; weight decay added to the Adam
update before the learning rate; no decay on norms; a linear warm-up from
`lr_start`). Parameters are stored at the configuration's precision
(bfloat16 for `use_bf16`) after every update.

Attention dropout draws its keep masks as the published recipe does: a
64-bit seed per step, split (SplitMix64) into one seed for the slow trunk
and one for the fast trunk, folded with the layer index, and with the
(query block, key block) index where the slow trunk attends in 256-wide
blocks (sequences of 512 or more, a multiple of 256); each mask is
uniform draws of a `torch.Generator` seeded with that seed, kept where
u >= rate. The fast trunk draws per group of F frames (F the largest of
16, 8, 4, 2 that divides the frame count with F * 8 a multiple of 128),
one bit per query row and key position.

`lower=True` is the control, one step below the stated bfloat16: the
parameters stored in fp8 (e4m3) and every product computed on fp8 inputs.
Imports nothing but torch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

U64 = (1 << 64) - 1
SPLIT_TAG = 0x5EED5EED5EED5EED
IGNORE = -100
NO_DECAY = ("attention_norm.weight", "ffn_norm.weight", "norm.weight", "fast_norm.weight",
            "bias")


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & U64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    return splitmix64((seed & U64) ^ splitmix64(data & U64))


def split_seed(seed: int, num: int = 2) -> Tuple[int, ...]:
    return tuple(fold_in(seed ^ SPLIT_TAG, i) for i in range(num))


def keep(seed: int, rate: float, shape, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    return torch.rand(tuple(shape), generator=gen, device=device) >= rate


def fast_fold(N: int, n: int) -> int:
    for cand in (16, 8, 4, 2):
        if N % cand == 0 and (cand * n) % 128 == 0:
            return cand
    return 1


class Trainer:
    """The model's parameters (float32 values of the stored precision),
    their Adam moments, and the step."""

    def __init__(self, state: Dict[str, torch.Tensor], model: dict, training: dict, device,
                 lower: bool = False):
        self.m, self.t, self.device, self.lower = model, training, device, lower
        self.store = torch.bfloat16 if training.get("use_bf16", True) else torch.float32
        if lower:
            self.store = torch.float8_e4m3fn
        self.p = {k: v.to(device).to(self.store).float().requires_grad_(True)
                  for k, v in state.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0

    # ---- pieces -------------------------------------------------------

    def _r(self, x):
        """A product's input as the computation stores it."""
        if not self.lower:
            return x
        return x + (x.to(torch.float8_e4m3fn).float() - x).detach()

    def _mm(self, x, w):  # w as stored [out, in]
        return self._r(x) @ self._r(w).T

    def _rms(self, x, w):
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + self.m.get("norm_eps", 1e-5)) * w

    def _rope(self, T, hd):
        base = float(self.m.get("rope_base", 10_000.0))
        exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=self.device) / hd
        inv = 1.0 / torch.pow(torch.tensor(base, device=self.device), exponent)
        ang = torch.arange(T, device=self.device).float()[:, None] * inv
        return (torch.cos(ang).to(torch.bfloat16).float(),
                torch.sin(ang).to(torch.bfloat16).float())

    @staticmethod
    def _apply_rope(x, cos, sin):  # x [N, T, H, hd]
        pairs = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
        x0, x1 = pairs[..., 0], pairs[..., 1]
        c, s = cos[:, None, :], sin[:, None, :]
        return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1).reshape(x.shape)

    def _slow_masks(self, seed: Optional[int], B, KV, G, T):
        rate = self.m.get("dropout", 0.0)
        if seed is None or rate <= 0:
            return None
        if T >= 512 and T % 256 == 0:  # attended in 256 x 256 blocks, one seed each
            nb = T // 256
            mask = torch.zeros((B, KV, G, T, T), dtype=torch.bool, device=self.device)
            for qi in range(nb):
                for kj in range(qi + 1):
                    mask[..., qi * 256:(qi + 1) * 256, kj * 256:(kj + 1) * 256] = keep(
                        fold_in(seed, qi * nb + kj), rate, (B, KV, G, 256, 256), self.device)
            return mask
        return keep(seed, rate, (B, KV, G, T, T), self.device)

    def _fast_masks(self, seed: Optional[int], N, KV, G, n):
        rate = self.m.get("dropout", 0.0)
        if seed is None or rate <= 0:
            return None
        Fd = fast_fold(N, n)
        if Fd == 1:
            return keep(seed, rate, (N, KV, G, n, n), self.device)
        k = keep(seed, rate, (N // Fd, KV, G, Fd * n, n), self.device)
        k = k.reshape(N // Fd, KV, G, Fd, n, n).permute(0, 3, 1, 2, 4, 5)
        return k.reshape(N, KV, G, n, n)

    def _trunk(self, prefix, n_layer, x, n_head, n_kv, seed, masks_fn):
        N, T, D = x.shape
        hd, g = D // n_head, n_head // n_kv
        cos, sin = self._rope(T, hd)
        causal = torch.ones((T, T), dtype=torch.bool, device=self.device).tril()
        rate = self.m.get("dropout", 0.0)
        for i in range(n_layer):
            p = lambda k: self.p[f"{prefix}.{i}.{k}"]  # noqa: E731
            h = self._rms(x, p("attention_norm.weight"))
            qkv = self._mm(h, p("attention.wqkv.weight"))
            q, k, v = torch.split(qkv, [n_head * hd, n_kv * hd, n_kv * hd], dim=-1)
            q = self._apply_rope(q.reshape(N, T, n_head, hd), cos, sin)
            k = self._apply_rope(k.reshape(N, T, n_kv, hd), cos, sin)
            v = v.reshape(N, T, n_kv, hd)
            qg = q.reshape(N, T, n_kv, g, hd)
            logits = torch.einsum("nqhgd,nkhd->nhgqk", self._r(qg), self._r(k)) * hd ** -0.5
            probs = torch.softmax(logits.masked_fill(~causal, -math.inf), dim=-1)
            mask = masks_fn(None if seed is None else fold_in(seed, i), N, n_kv, g, T)
            if mask is not None:
                probs = probs.masked_fill(~mask, 0.0) / (1.0 - rate)
            att = torch.einsum("nhgqk,nkhd->nqhgd", self._r(probs), self._r(v)).reshape(N, T, D)
            x = x + self._mm(att, p("attention.wo.weight"))
            h = self._rms(x, p("ffn_norm.weight"))
            a = F.silu(self._mm(h, p("feed_forward.w1.weight"))) * self._mm(
                h, p("feed_forward.w3.weight"))
            x = x + self._mm(a, p("feed_forward.w2.weight"))
        return x

    @staticmethod
    def _ce(logits, labels):
        valid = labels != IGNORE
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, safe[..., None])[..., 0]
        return (nll * valid).sum() / valid.sum().clamp(min=1)

    # ---- forward, loss, step -------------------------------------------

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor, seed: Optional[int]) -> torch.Tensor:
        m = self.m
        tokens, labels = tokens.long().to(self.device), labels.long().to(self.device)
        B, R, T = tokens.shape
        cb, n = m["codebook_size"], m["num_codebooks"]
        seeds = split_seed(seed) if (seed is not None and m.get("dropout", 0.0) > 0) else (None, None)
        offs = torch.arange(n, device=self.device)[None, :, None] * cb
        cb_sum = self.p["codebook_embeddings.weight"][tokens[:, 1:] + offs].sum(dim=1)
        x = self.p["embeddings.weight"][tokens[:, 0]]
        x = x + torch.where((tokens[:, 1] != 0)[..., None], cb_sum, torch.zeros_like(cb_sum))
        x = self._trunk("layers", m["n_layer"], x, m["n_head"], m["n_local_heads"], seeds[0],
                        self._slow_masks)
        token_logits = self._mm(self._rms(x, self.p["norm.weight"]), self.p["embeddings.weight"])
        base = self._ce(token_logits, labels[:, 0])
        nxt = F.pad(tokens[:, 1:-1, 1:], (0, 1)) + (torch.arange(n - 1, device=self.device)
                                                     * cb)[None, :, None]
        fast_in = torch.cat([x[:, :, None], self.p["fast_embeddings.weight"][nxt.transpose(1, 2)]],
                            dim=2)
        fd = fast_in.shape[-1]
        fx = self._trunk("fast_layers", m["n_fast_layer"], fast_in.reshape(B * T, n, fd),
                         m.get("fast_n_head") or m["n_head"],
                         m.get("fast_n_local_heads") or m["n_local_heads"], seeds[1],
                         lambda s, N, KV, G, _T: self._fast_masks(s, N, KV, G, n))
        out = self._rms(fx, self.p["fast_norm.weight"])  # [BT, n, fd]
        head = self.p["fast_output.weight"].reshape(n, cb, fd)
        code_logits = torch.einsum("tid,icd->tic", self._r(out), self._r(head))
        semantic = self._ce(code_logits.reshape(B, T, n, cb),
                            labels[:, 1:].transpose(1, 2))
        return base + semantic

    def _lr(self) -> float:
        t = self.t
        progress = min(self.count / max(1, t["lr_warmup_steps"]), 1.0)
        return t["lr_start"] + (t["learning_rate"] - t["lr_start"]) * progress

    def step(self, tokens, labels, seed) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One step: (loss, the clipped gradient as the optimizer gets it)."""
        total = self.loss(tokens, labels, seed)
        names = list(self.p)
        grads = torch.autograd.grad(total, [self.p[k] for k in names])
        t = self.t
        b1, b2 = t["betas"]
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            clip = t["gradient_clip"]
            if clip > 0 and float(norm) >= clip:
                grads = [g / norm * clip for g in grads]
            lr = self._lr()
            self.count += 1
            bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
            for k, g in zip(names, grads):
                self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
                self.nu[k] = (1 - b2) * g * g + b2 * self.nu[k]
                upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + t["eps"])
                if not k.endswith(NO_DECAY):
                    upd = upd + t["weight_decay"] * self.p[k]
                self.p[k].copy_((self.p[k] - lr * upd).to(self.store).float())
        return float(total.detach()), dict(zip(names, grads))


def leaf_groups(state_keys: List[str]) -> Dict[str, List[str]]:
    """Release keys grouped as the program stacks them: a trunk's per-layer
    tensors of one name form one leaf ("layers.attention.wqkv.weight")."""
    out: Dict[str, List[str]] = {}
    for k in state_keys:
        parts = k.split(".")
        name = ".".join([parts[0]] + parts[2:]) if parts[0] in ("layers", "fast_layers") else k
        out.setdefault(name, []).append(k)
    return out


def group_norms(tensors: Dict[str, torch.Tensor], groups: Dict[str, List[str]]) -> Dict[str, float]:
    return {g: math.sqrt(sum(float((tensors[k].float() ** 2).sum()) for k in ks))
            for g, ks in groups.items()}
