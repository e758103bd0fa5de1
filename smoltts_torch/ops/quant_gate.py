"""Quality gates for the quantized decode configurations (int8 weights, int8
KV history), the JAX package's gates (`smoltts_tpu/ops/quant_gate.py`) on the
port's trees, with the same thresholds and seeds:

1. int8 LM: teacher-forced CE delta < 2% and mean token and codebook KL
   < 0.02 on a synthetic labeled batch;
2. int8 LM sampling distribution: Jensen-Shannon divergence of the serving
   distributions (audio window, temperature, min-p) < 0.05, support-flip mass
   < 0.10;
3. int8 vocoder: PCM SNR > 25 dB decoding codes GENERATED greedily by the
   dense LM (K3 serves the slow-token site on the card) through the dense
   vs the quantized Mimi;
4. kv8: per-vector int8 round-trip SNR > 30 dB on real prefill K/V, and the
   relative error of the kv8 attention read (K2 over an int8 history on the
   card) against the bf16 history < 2%.

A failing gate raises QuantGateError. The gates' own draws (the kv8 query)
are arguments, so a test can hand both packages the same arrays. The limits
were set for f32 math over the trees' values (bench.py runs the JAX gates on
the CPU with bf16 leaves cast to f32); `*_metrics` measure any two trees, so
a caller can also read the metrics in bf16 and the bf16 rounding floor.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from smoltts_torch import resolve_device
from smoltts_torch.interop import tree_map


class QuantGateError(AssertionError):
    """A quantized configuration failed its quality gate."""


# metric -> (limit, True when the metric must stay below it, False above)
LIMITS = {
    "int8_ce_delta": (0.02, True), "int8_kl_token": (0.02, True),
    "int8_kl_codebook": (0.02, True), "int8_js_sampling": (0.05, True),
    "int8_sampling_flip_mass": (0.10, True), "int8_vocoder_snr_db": (25.0, False),
    "kv8_roundtrip_snr_db": (30.0, False), "kv8_attention_rel_err": (0.02, True),
}


def failing(metrics: Dict[str, float]):
    """The metrics outside their limits."""
    return [k for k, v in metrics.items()
            if (v >= LIMITS[k][0] if LIMITS[k][1] else v <= LIMITS[k][0])]


def _mean_kl(ref_logits, got_logits) -> float:
    ref = torch.log_softmax(ref_logits.float(), dim=-1)
    got = torch.log_softmax(got_logits.float(), dim=-1)
    return float(torch.mean(torch.sum(torch.exp(ref) * (ref - got), dim=-1)))


def _sampling_dist(logits, token_cfg, temperature: float, min_p: float):
    """The serving-time sampling distribution: audio-constrained,
    temperature-scaled, min-p filtered, renormalized."""
    from smoltts_torch.lm.samplers import constrain_logits_to_audio

    x = constrain_logits_to_audio(
        logits.float(), token_cfg.im_end_id, token_cfg.semantic_start_id,
        token_cfg.semantic_end_id or token_cfg.semantic_start_id)
    x = x / max(temperature, 1e-6)
    p = torch.softmax(x, dim=-1)
    keep = p >= min_p * p.amax(dim=-1, keepdim=True)
    p = torch.where(keep, p, torch.zeros_like(p))
    return p / p.sum(dim=-1, keepdim=True)


@torch.no_grad()
def int8_lm_metrics(cfg, token_cfg, params, qparams, *, temperature: float = 0.7,
                    min_p: float = 0.05, batch: int = 4, seq: int = 64,
                    seed: int = 0) -> Dict[str, float]:
    """Checks 1 + 2's metrics of `qparams` against `params` (any two trees)."""
    from smoltts_torch.models.dual_ar import forward_train
    from smoltts_torch.train.data import batch_iterator, synthetic_dataset
    from smoltts_torch.train.loss import compute_losses

    dev = params["embeddings"].device
    ds = synthetic_dataset(batch, cfg, token_cfg, seq_len=seq, seed=seed)
    b = next(batch_iterator(
        ds, batch_size=batch, semantic_pad_id=token_cfg.pad_id, max_len=seq,
        duplicate_code_0=cfg.duplicate_code_0, num_codebooks=cfg.num_codebooks))
    tokens = torch.from_numpy(b["tokens"]).to(dev)
    labels = torch.from_numpy(b["labels"]).to(dev)

    def fwd(p):
        return forward_train(p, cfg, tokens, embed_mask_mode="semantic_range",
                             semantic_start_id=token_cfg.semantic_start_id,
                             semantic_end_id=token_cfg.semantic_end_id or token_cfg.semantic_start_id)

    ref, got = fwd(params), fwd(qparams)
    ce_ref = float(compute_losses(ref.token_logits, ref.codebook_logits, labels).total)
    ce_got = float(compute_losses(got.token_logits, got.codebook_logits, labels).total)
    ce_delta = abs(ce_got - ce_ref) / max(abs(ce_ref), 1e-9)
    kl_tok = _mean_kl(ref.token_logits, got.token_logits)
    kl_cb = _mean_kl(ref.codebook_logits, got.codebook_logits)

    p_ref = _sampling_dist(ref.token_logits[:, -1], token_cfg, temperature, min_p)
    p_got = _sampling_dist(got.token_logits[:, -1], token_cfg, temperature, min_p)
    # Jensen-Shannon and support-flip mass, not hard-support KL: at flat
    # distributions min-p keep-set membership is knife-edge, and a token
    # flipping out of one support would make KL diverge on an artifact.
    eps = 1e-12
    m = 0.5 * (p_ref + p_got)

    def _kl(a, b):
        t = a * (torch.log(a + eps) - torch.log(b + eps))
        return torch.where(a > 0, t, torch.zeros_like(t)).sum(dim=-1)

    js_sample = float(torch.mean(0.5 * _kl(p_ref, m) + 0.5 * _kl(p_got, m)))
    zero = torch.zeros_like(p_ref)
    flip_mass = float(torch.mean(torch.where(p_got <= 0, p_ref, zero).sum(dim=-1)
                                 + torch.where(p_ref <= 0, p_got, zero).sum(dim=-1)))
    return {
        "int8_ce_delta": ce_delta, "int8_kl_token": kl_tok,
        "int8_kl_codebook": kl_cb, "int8_js_sampling": js_sample,
        "int8_sampling_flip_mass": flip_mass,
    }


def gate_int8_lm(cfg, token_cfg, params, qparams, **kw) -> Dict[str, float]:
    """Checks 1 + 2. Returns metrics; raises QuantGateError on failure."""
    metrics = int8_lm_metrics(cfg, token_cfg, params, qparams, **kw)
    if failing(metrics):
        raise QuantGateError(f"int8 LM gate failed: {metrics}")
    return metrics


def vocoder_gate_prompt(cfg, token_cfg, seed: int = 0, T: int = 12) -> np.ndarray:
    """The vocoder gate's audio prompt [num_rows, T] (numpy draws as in JAX)."""
    rng = np.random.default_rng(seed)
    prompt = np.zeros((cfg.num_rows, T), np.int32)
    c0 = rng.integers(1, cfg.codebook_size, T)
    prompt[0] = token_cfg.semantic_start_id + c0
    prompt[1] = c0 if cfg.duplicate_code_0 else rng.integers(1, cfg.codebook_size, T)
    prompt[2:] = rng.integers(0, cfg.codebook_size, (cfg.num_rows - 2, T))
    return prompt


@torch.no_grad()
def int8_vocoder_metrics(cfg, token_cfg, settings, mimi_cfg, params, mimi_params, qmimi, *,
                         n_frames: int = 12, seed: int = 0) -> Dict[str, float]:
    """Check 3's metric: PCM SNR on codes generated greedily by the LM."""
    from smoltts_torch.codec.mimi import mimi_decode
    from smoltts_torch.lm.generate import FrameGenerator
    from smoltts_torch.lm.samplers import GenerationSettings

    dev = params["embeddings"].device
    greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0,
                                max_new_tokens=n_frames, audio_only_constraint=True)
    prompt = vocoder_gate_prompt(cfg, token_cfg, seed)
    T = prompt.shape[1]
    gen = FrameGenerator(params, cfg, token_cfg, greedy, [prompt],
                         generator=torch.Generator(dev).manual_seed(seed),
                         max_seq_len=max(64, T + n_frames + 2), device=dev)
    codes = torch.stack([f.audio_codes[0] for f in gen], dim=1)[None]  # [1, ncb, frames]
    ref = mimi_decode(mimi_params, mimi_cfg, codes).float().cpu().numpy()
    got = mimi_decode(qmimi, mimi_cfg, codes).float().cpu().numpy()
    err = ref - got
    snr = float(10.0 * np.log10(float((ref**2).mean()) / max(float((err**2).mean()), 1e-12)))
    return {"int8_vocoder_snr_db": snr}


def gate_int8_vocoder(cfg, token_cfg, settings, mimi_cfg, params, mimi_params, qmimi,
                      **kw) -> Dict[str, float]:
    """Check 3. Returns the metric; raises QuantGateError on failure."""
    m = int8_vocoder_metrics(cfg, token_cfg, settings, mimi_cfg, params, mimi_params, qmimi, **kw)
    if failing(m):
        raise QuantGateError(
            f"int8 vocoder gate failed: generated-codes SNR {m['int8_vocoder_snr_db']:.1f} dB")
    return m


def kv8_gate_prompt(cfg, token_cfg, batch: int = 2, T: int = 48, seed: int = 0) -> np.ndarray:
    """The kv8 gate's prompt [batch, num_rows, T] (numpy draws as in JAX)."""
    rng = np.random.default_rng(seed)
    prompt = np.zeros((batch, cfg.num_rows, T), np.int32)
    c0 = rng.integers(1, cfg.codebook_size, (batch, T))
    prompt[:, 0] = token_cfg.semantic_start_id + c0
    prompt[:, 1] = c0
    return prompt


def kv8_gate_query(batch: int, n_head: int, head_dim: int, device=None) -> torch.Tensor:
    """The kv8 gate's random query [batch, n_head, head_dim] bf16 (the JAX
    gate draws it from PRNGKey(1); the port from a generator seeded 1)."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((batch, n_head, head_dim), generator=gen, dtype=torch.float32)
    return q.to(device=device, dtype=torch.bfloat16)


@torch.no_grad()
def kv8_metrics(cfg, token_cfg, params, *, batch: int = 2, T: int = 48, seed: int = 0,
                query: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Check 4's metrics: int8 KV fidelity on real prefill tensors, and the
    kv8 attention read against the bf16 one (`decode_attention_tailed`: K2
    on the card, its plain version on the CPU)."""
    from smoltts_torch.lm.decode import init_decode_state, prefill
    from smoltts_torch.lm.samplers import GenerationSettings
    from smoltts_torch.ops.attention import decode_attention_tailed
    from smoltts_torch.ops.quant import quantize_kv

    dev = params["embeddings"].device
    settings = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
    prompt = torch.from_numpy(kv8_gate_prompt(cfg, token_cfg, batch, T, seed)).to(dev)
    S = max(64, 2 * T)
    state = init_decode_state(cfg, batch, S, dtype=torch.bfloat16, device=dev)
    state, _ = prefill(params, cfg, token_cfg, settings, state, prompt,
                       torch.full((batch,), T, dtype=torch.int32, device=dev),
                       torch.Generator(dev).manual_seed(0))

    k, v = state.k, state.v  # [L, B, H, S, hd] bf16, positions < T valid
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    deq = kq.float() * ks[..., None]
    valid = k.float()[:, :, :, :T]
    err = valid - deq[:, :, :, :T]
    snr = float(10.0 * np.log10(float(torch.mean(valid**2)) / max(float(torch.mean(err**2)), 1e-12)))

    q = query if query is not None else kv8_gate_query(batch, cfg.n_head, cfg.head_dim)
    q = q.to(device=dev, dtype=torch.bfloat16).contiguous()
    W = 8
    k_tail = torch.zeros((batch, cfg.n_local_heads, W, cfg.head_dim), dtype=torch.bfloat16,
                         device=dev)
    v_tail = torch.zeros_like(k_tail)
    i32 = dict(dtype=torch.int32, device=dev)
    tail_pos = torch.full((batch, W), -1, **i32)
    pos = torch.full((batch,), T - 1, **i32)
    flushed = torch.full((batch,), T, **i32)
    out_ref = decode_attention_tailed(q, k[0], v[0], k_tail, v_tail, pos, flushed, tail_pos)
    out_q = decode_attention_tailed(q, kq[0], vq[0], k_tail, v_tail, pos, flushed, tail_pos,
                                    k_scale=ks[0], v_scale=vs[0])
    rel = float(torch.linalg.norm((out_ref - out_q).float())
                / torch.clamp(torch.linalg.norm(out_ref.float()), min=1e-9))
    return {"kv8_roundtrip_snr_db": snr, "kv8_attention_rel_err": rel}


def gate_kv8(cfg, token_cfg, params, **kw) -> Dict[str, float]:
    """Check 4. Returns metrics; raises QuantGateError on failure."""
    m = kv8_metrics(cfg, token_cfg, params, **kw)
    if failing(m):
        raise QuantGateError(f"kv8 gate failed: {m}")
    return m


def run_quant_gates(cfg, token_cfg, settings, mimi_cfg, params_dense, params_q, mimi_dense,
                    mimi_q, *, int8: bool, kv8: bool, device=None) -> Dict[str, float]:
    """The gates of the enabled quantized modes, on `device` (None means
    CUDA; the trees are moved there). Raises QuantGateError if any fails;
    returns the pooled metrics."""
    dev = resolve_device(device)
    params_dense, params_q, mimi_dense, mimi_q = (
        tree_map(lambda t: t.to(dev), t) for t in (params_dense, params_q, mimi_dense, mimi_q))
    metrics: Dict[str, float] = {}
    if int8:
        metrics.update(gate_int8_lm(cfg, token_cfg, params_dense, params_q))
        metrics.update(gate_int8_vocoder(cfg, token_cfg, settings, mimi_cfg, params_dense,
                                         mimi_dense, mimi_q))
    if kv8:
        metrics.update(gate_kv8(cfg, token_cfg, params_dense))
    return metrics


def _gate_cache_key(cfg, mimi_cfg, settings, int8: bool, kv8: bool, dev: torch.device) -> str:
    """A hash of everything a verdict depends on: the port's sources (the
    gates run its forward, decode, sampling, kernels and codec), the configs,
    the sampler settings, the modes, the torch and CUDA versions and the
    device's name."""
    h = hashlib.sha256()
    root = Path(__file__).resolve().parent.parent  # smoltts_torch/
    for p in sorted(root.rglob("*")):
        if p.suffix in (".py", ".cu", ".cuh", ".c") and p.is_file():
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    h.update(json.dumps(cfg.to_dict(), sort_keys=True).encode())
    h.update(repr(sorted(vars(mimi_cfg).items())).encode())
    h.update(repr(settings).encode())
    h.update(f"int8={int8} kv8={kv8}".encode())
    h.update(f"torch={torch.__version__} cuda={torch.version.cuda}".encode())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    h.update(f"device={name}".encode())
    return h.hexdigest()


def run_quant_gates_cached(cfg, token_cfg, settings, mimi_cfg, params_dense, params_q,
                           mimi_dense, mimi_q, *, int8: bool, kv8: bool,
                           cache_path: Optional[str] = None, device=None) -> Dict[str, float]:
    """`run_quant_gates` with the verdict cached in `cache_path` (only that
    file is written; a failed gate is never cached, it raises every run).
    SMOLTTS_GATE_NO_CACHE=1 forces a fresh run. On the CPU the gates run in
    f32 (bf16 leaves are cast; int8 payloads are untouched), as the JAX
    package runs them there."""
    dev = resolve_device(device)
    key = None
    if cache_path is not None and os.environ.get("SMOLTTS_GATE_NO_CACHE") != "1":
        key = _gate_cache_key(cfg, mimi_cfg, settings, int8, kv8, dev)
        p = Path(cache_path)
        if p.exists():
            try:
                blob = json.loads(p.read_text())
                if blob.get("key") == key:
                    return dict(blob["metrics"], gate_cached=1.0)
            except (ValueError, KeyError):
                pass
    trees = (params_dense, params_q, mimi_dense, mimi_q)
    if dev.type == "cpu":
        trees = tuple(tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, t)
                      for t in trees)
    metrics = run_quant_gates(cfg, token_cfg, settings, mimi_cfg, *trees, int8=int8, kv8=kv8,
                              device=dev)
    metrics = {k: float(v) for k, v in metrics.items()}
    if cache_path is not None:
        Path(cache_path).write_text(json.dumps({"key": key, "metrics": metrics}, indent=1))
    return metrics
