#!/usr/bin/env python3
"""Drive the PyTorch port (smoltts_torch) on one NVIDIA card and hold every
hand-written CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py    # needs one CUDA card

Phases:
  0  card name and power limit; require CUDA; TF32 off for matmul and cuDNN
  1  build the kernels (nvcc into build/smoltts_torch/) and time the build
  2  decode attention (K2) vs its plain version at the main path's shapes
  3  fast micro-loop (K1) vs its plain version at 150M widths, B=64
  4  sampler (K3) vs its plain version
  5  the main path as bench.py runs it: 150M int8 weights, kv8, B=64
     ChatML prompts, S=1024, attend bucket 256, temp 0.7 / 0.7 / min-p 0.05,
     prefill + 63 stream steps with flushes; launch counts per kernel
  6  greedy end to end at B=4 in f32: kernel path == all-plain path

Prints one line per phase, then the kernels' JSON line, the card's name and
power limit, and as the last line {"ok": true, "device": {...}}. Any failed
phase exits non-zero without that last line. No JAX is imported.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
K2_GATE = 1e-2  # bf16 kernel vs the plain version's f32 math on the same inputs
K1_BF16_LEVEL0_GATE = 0.9  # see phase 3
REPEATS = 3  # measured passes of the main path (phase 5)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what) -> None:
    """A gate: raises (unlike `assert`, also under `python -O`)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(fn, iters=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3) -> float:
    """The card's own time per call: the sum of the CUDA kernels' device
    times in a profiler window, over the calls (host dispatch excluded, so a
    microsecond kernel is not timed as its Python wrapper). CUDA-event time
    if the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_self_device_ms(e) for e in prof.key_averages())
    return total / iters if total > 0 else time_ms(fn, iters, warmup=0)


def _self_device_ms(event) -> float:
    return getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0)) / 1e3


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tv_gate(p: np.ndarray, n: int, seed: int, reps: int = 200) -> float:
    """1.2 x the 99.9th percentile of the total-variation distance between p
    and the histogram of n exact draws from p (the sampling noise alone)."""
    rng = np.random.default_rng(seed)
    tvs = [0.5 * np.abs(rng.multinomial(n, p) / n - p).sum() for _ in range(reps)]
    return 1.2 * float(np.quantile(tvs, 0.999))


def masked_softmax(logits: np.ndarray, temp: float, min_p: float) -> np.ndarray:
    s = logits.astype(np.float64) / temp
    keep = s >= s.max() + math.log(min_p)
    p = np.where(keep, np.exp(s - s.max()), 0.0)
    return p / p.sum()


class Smoke:
    K1_DRAWS = 8192  # level-0 draws of one hidden row (phase 3)
    K3_DRAWS = 131072  # draws of one logits row (phase 4)

    def __init__(self):
        import torch

        self.torch = torch
        self.dev = torch.device("cuda")
        self.kernels = {}  # name -> record for the JSON line
        self.failures = []
        self._lm = None

    # ---- shared state -------------------------------------------------------

    def lm(self):
        """150M config, bf16 random weights from a seeded generator, fused and
        int8-quantized; the Mimi tree likewise."""
        if self._lm is None:
            from smoltts_torch.codec.config import MimiConfig
            from smoltts_torch.codec.mimi import init_mimi_params
            from smoltts_torch.config import smoltts_byte_150m
            from smoltts_torch.models.dual_ar import init_params
            from smoltts_torch.ops.quant import (
                fuse_decode_params, fuse_mimi_decode_params, quantize_decode_params,
                quantize_mimi_params,
            )

            torch = self.torch
            cfg = smoltts_byte_150m().replace(dropout=0.0, use_gradient_checkpointing=False)
            t0 = time.perf_counter()
            dense = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                                device=self.dev)
            params = quantize_decode_params(fuse_decode_params(dense))
            del dense
            mcfg = MimiConfig()
            mimi = quantize_mimi_params(fuse_mimi_decode_params(
                init_mimi_params(mcfg, seed=0, dtype=torch.bfloat16, device=self.dev)))
            torch.cuda.synchronize()
            log(f"[setup] 150M int8 tree + Mimi int8 tree ready in {time.perf_counter() - t0:.1f} s")
            self._lm = (cfg, params, mcfg, mimi)
        return self._lm

    def record(self, name, **kw):
        self.kernels[name] = {"name": name, "route": "cuda", **kw}

    # ---- phases -------------------------------------------------------------

    def phase1_build(self):
        from smoltts_torch.ops import _build

        t0 = time.perf_counter()
        _build.lib(verbose=True)
        log(f"[1 build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
            f"(nvcc wall {_build.BUILD_SECONDS})")

    def phase2_attention(self):
        import torch.nn.functional as F

        from smoltts_torch.ops import attention as A
        from smoltts_torch.ops.quant import quantize_kv

        torch, dev = self.torch, self.dev
        B, H, KV, hd, S, W = 64, 12, 4, 64, 1024, 128
        g = torch.Generator(device=dev).manual_seed(2)
        rnd = lambda *s: torch.randn(s, generator=g, device=dev)
        worst = 0.0
        timing = None
        for lim in (256, 1024):
            kf, vf = rnd(1, B, KV, S, hd), rnd(1, B, KV, S, hd)
            kq, ks = quantize_kv(kf)
            vq, vs = quantize_kv(vf)
            q = rnd(B, H, hd).bfloat16()
            kt, vt = rnd(B, KV, W, hd).bfloat16(), rnd(B, KV, W, hd).bfloat16()
            rng = np.random.default_rng(lim)
            flushed = rng.integers(lim // 2, lim - W // 2, B)
            n_new = rng.integers(1, W // 2, B)
            pos = np.minimum(flushed + n_new - 1, lim - 1)
            tail_pos = np.full((B, W), -1, np.int64)
            for b in range(B):
                cols = rng.permutation(W)[: pos[b] - flushed[b] + 1]
                tail_pos[b, cols] = np.arange(flushed[b], pos[b] + 1)
                tail_pos[b, rng.integers(0, W)] = max(flushed[b] - 3, 0)  # stale column
                tail_pos[b, cols[:1]] = flushed[b]
            t32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
            posd, fl, tp = t32(pos), t32(flushed), t32(tail_pos)
            view = lambda t: t[0, :, :, :lim]
            for kv8 in (True, False):
                if kv8:
                    hist = dict(k_hist=view(kq), v_hist=view(vq), k_scale=view(ks), v_scale=view(vs))
                    hist32 = dict(hist)
                else:
                    hist = dict(k_hist=view(kf.bfloat16()), v_hist=view(vf.bfloat16()))
                    hist32 = {k: v.float() for k, v in hist.items()}
                got = A.decode_attention_tailed(q, k_tail=kt, v_tail=vt, pos=posd, flushed=fl,
                                                tail_pos=tp, **hist)
                ref = A.decode_attention_tailed_plain(
                    q.float(), k_tail=kt.float(), v_tail=vt.float(), pos=posd, flushed=fl,
                    tail_pos=tp, **hist32)
                err = (got.float() - ref).abs().max().item()
                worst = max(worst, err)
                log(f"[2 K2] tailed lim={lim} {'kv8' if kv8 else 'bf16'} history: "
                    f"max_abs_err {err:.3e} (gate {K2_GATE})")
                if lim == 256 and kv8:
                    timing = (q, hist, kt, vt, posd, fl, tp, flushed, pos, tail_pos)
        # contiguous form (W = 0, flushed = pos + 1)
        kc, vc = rnd(B, KV, 256, hd).bfloat16(), rnd(B, KV, 256, hd).bfloat16()
        q = rnd(B, H, hd).bfloat16()
        pos = torch.from_numpy(np.random.default_rng(5).integers(0, 256, B).astype(np.int32)).to(dev)
        err = (A.decode_attention(q, kc, vc, pos).float()
               - A.decode_attention_plain(q.float(), kc.float(), vc.float(), pos)).abs().max().item()
        worst = max(worst, err)
        log(f"[2 K2] contiguous S=256 bf16: max_abs_err {err:.3e}")
        check(worst <= K2_GATE, f"K2 error {worst} above {K2_GATE}")

        # times at the main path's shape: lim 256, kv8 history, W 128
        q, hist, kt, vt, posd, fl, tp, flushed, pos, tail_pos = timing
        args = dict(k_tail=kt, v_tail=vt, pos=posd, flushed=fl, tail_pos=tp, **hist)
        kernel = lambda: A.decode_attention_tailed(q, **args)
        ms, wall_ms = device_ms(kernel, iters=50), time_ms(kernel, iters=50)
        plain_ms = device_ms(lambda: A.decode_attention_tailed_plain(q, **args), iters=20)
        # library yardstick: SDPA over the dequantized, concatenated cache
        kd = (hist["k_hist"].float() * hist["k_scale"][..., None]).bfloat16()
        vd = (hist["v_hist"].float() * hist["v_scale"][..., None]).bfloat16()
        kcat = torch.cat([kd, kt], 2).repeat_interleave(H // KV, 1)
        vcat = torch.cat([vd, vt], 2).repeat_interleave(H // KV, 1)
        lim = kd.shape[2]
        mh = torch.arange(lim, device=dev)[None] < fl[:, None]
        mt = (tp >= fl[:, None]) & (tp <= posd[:, None]) & (tp >= 0)
        mask = torch.cat([mh, mt], 1)[:, None, None, :]
        q4 = q[:, :, None, :]
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q4, kcat, vcat, attn_mask=mask),
                               iters=50)
        n_hist = int(np.minimum(flushed, lim).sum())
        n_tail = int(((tail_pos >= flushed[:, None]) & (tail_pos <= pos[:, None])).sum())
        nbytes = (q.numel() * 2 + n_hist * KV * (2 * hd + 2 * 4) + n_tail * KV * 2 * hd * 2
                  + tp.numel() * 4 + 2 * B * 4 + B * H * hd * 2)
        flops = 4 * H * hd * (n_hist + n_tail)
        bms, by = bound(nbytes, flops)
        log(f"[2 K2] B=64 lim=256 W=128 kv8, device time per call: kernel {ms} ms, plain "
            f"{plain_ms} ms, SDPA {library_ms} ms, bound {bms} ms ({by}, {nbytes / 1e6:.2f} MB); "
            f"kernel wall per call with host dispatch {wall_ms} ms")
        self.record("decode_attention", source="smoltts_torch/csrc/decode_attention.cu",
                    replaces="smoltts_tpu/ops/attention.py:53", max_abs_err=worst, ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)

    def _fast_f32_tree(self, params):
        tree = dict(params)
        fl = dict(params["fast_layers"])
        for k in ("attention_norm", "ffn_norm"):
            fl[k] = fl[k].float()
        tree["fast_layers"] = fl
        tree["fast_norm"] = params["fast_norm"].float()
        tree["fast_embeddings"] = params["fast_embeddings"].float()
        return tree

    def phase3_fast_loop(self):
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.ops import fast_loop as FL

        torch, dev = self.torch, self.dev
        cfg, params, _, _ = self.lm()
        B = 64
        greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
        sampled = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05)
        g = torch.Generator(device=dev).manual_seed(3)
        hidden = torch.randn((B, cfg.dim), generator=g, device=dev)
        p32 = self._fast_f32_tree(params)

        got = FL.fused_fast_micro_loop(p32, cfg, hidden, None, greedy)
        ref = FL.fast_micro_loop_plain(p32, cfg, hidden, None, greedy)
        f32_err = int((got.long() - ref.long()).abs().max().item())
        log(f"[3 K1] f32 greedy: codes equal {bool((got == ref).all())} "
            f"(max code difference {f32_err})")
        check(f32_err == 0, "K1 f32 greedy codes differ from the plain version")

        # bf16: the kernel rounds each matmul input to bf16 and keeps f32
        # between stages; the reference is the plain version's f32 math on the
        # same bf16-valued inputs. Rounding flips near-tied argmaxes, and a
        # flipped level changes the input of every later level, so whole rows
        # drift apart (row agreement ~0.84 in a CPU emulation of the kernel's
        # rounding on these random weights); level 0 sees no cascade and is
        # the gated share.
        hb = hidden.bfloat16()
        got = FL.fused_fast_micro_loop(params, cfg, hb, None, greedy)
        ref = FL.fast_micro_loop_plain(p32, cfg, hb.float(), None, greedy)
        ref16 = FL.fast_micro_loop_plain(params, cfg, hb, None, greedy)
        rows = (got == ref).all(1).float().mean().item()
        codes = (got == ref).float().mean().item()
        lvl0 = (got[:, 0] == ref[:, 0]).float().mean().item()
        rows16 = (got == ref16).all(1).float().mean().item()
        log(f"[3 K1] bf16 greedy vs plain f32 math: level-0 agreement {lvl0:.4f} "
            f"(gate {K1_BF16_LEVEL0_GATE}), row agreement {rows:.4f}, code agreement "
            f"{codes:.4f}; row agreement vs the plain bf16 path {rows16:.4f}")
        check(lvl0 >= K1_BF16_LEVEL0_GATE, f"K1 bf16 level-0 agreement {lvl0}")

        # sampled: level-0 histogram of one hidden row against the masked softmax
        N = self.K1_DRAWS
        row = hidden[:1].expand(N, -1).contiguous()
        gen = torch.Generator(device=dev).manual_seed(4)
        codes_s = FL.fused_fast_micro_loop(p32, cfg, row, gen, sampled)
        check(0 <= int(codes_s.min()) and int(codes_s.max()) < cfg.codebook_size,
              "K1 sampled codes out of range")
        captured = []

        def capture(logits, generator, *, temperature, min_p=None):
            captured.append(logits.detach().double().cpu().numpy())
            return logits.argmax(-1).to(torch.int32)

        with mock.patch.object(FL, "sample_token", capture):
            FL.fast_micro_loop_plain(p32, cfg, hidden[:1], None, sampled)
        p = masked_softmax(captured[0][0], 0.7, 0.05)
        freq = np.bincount(codes_s[:, 0].cpu().numpy(), minlength=cfg.codebook_size) / N
        tv = 0.5 * np.abs(freq - p).sum()
        gate = tv_gate(p, N, seed=5)
        outside = float(freq[p == 0].sum())
        log(f"[3 K1] sampled T=0.7 min-p 0.05: level-0 TV {tv:.4f} over {N} draws "
            f"(gate {gate:.4f} = 1.2 x the 99.9th percentile of exact-sampling TV; "
            f"{int((p > 0).sum())} tokens kept), mass outside min-p {outside:.2e}")
        check(tv <= gate and outside == 0.0, "K1 sampled distribution off")

        gen = torch.Generator(device=dev).manual_seed(6)
        kernel = lambda: FL.fused_fast_micro_loop(params, cfg, hb, gen, sampled)
        ms, wall_ms = device_ms(kernel, iters=20), time_ms(kernel, iters=20)
        plain_ms = device_ms(lambda: FL.fast_micro_loop_plain(params, cfg, hb, gen, sampled), iters=5)
        lp = params["fast_layers"]
        D, Fi, CB, n, L = cfg.fast_dim, cfg.fast_intermediate_size, cfg.codebook_size, cfg.max_fast_seqlen, cfg.n_fast_layer
        Nq = D + 2 * cfg.fast_n_local_heads * cfg.fast_head_dim
        weight_bytes = sum(t.numel() * t.element_size() for k in ("wqkv", "wo", "w13", "w2")
                           for t in lp[k]) + sum(t.numel() * t.element_size() for t in params["fast_output"])
        nbytes = (weight_bytes + B * D * 2 + B * (n - 1) * D * 2 + 2 * L * D * 2 + D * 2
                  + B * n * 4)
        flops = n * (L * 2 * B * (D * Nq + D * D + D * 2 * Fi + Fi * D) + 2 * B * D * CB)
        bms, by = bound(nbytes, flops)
        log(f"[3 K1] B=64 bf16 sampled frame, device time per call: kernel {ms} ms, plain "
            f"{plain_ms} ms, bound {bms} ms ({by}: {nbytes / 1e6:.1f} MB read once, "
            f"{flops / 1e9:.1f} GFLOP); kernel wall per call with host dispatch {wall_ms} ms")
        self.record("fast_loop", source="smoltts_torch/csrc/fast_loop.cu",
                    replaces="smoltts_tpu/ops/fast_loop.py:105", max_abs_err=float(f32_err),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)

    def phase4_sampler(self):
        from smoltts_torch.ops import sampling as SP

        torch, dev = self.torch, self.dev
        B, V, T, min_p = 64, 2368, 0.7, 0.05
        g = torch.Generator(device=dev).manual_seed(7)
        logits = torch.randn((B, V), generator=g, device=dev) * 2.0
        gen = torch.Generator(device=dev).manual_seed(8)
        a = SP.sample_categorical(logits, gen, temperature=0.8, min_p=1.0)
        exact1 = int((a.long() != logits.argmax(-1)).sum().item())
        hot = torch.full((B, V), -100.0, device=dev)
        idx = torch.randint(0, V, (B,), generator=g, device=dev)
        hot[torch.arange(B, device=dev), idx] = 100.0
        exact2 = int((SP.sample_categorical(hot, gen, temperature=1.0).long() != idx).sum().item())
        log(f"[4 K3] min_p=1 mismatches vs argmax: {exact1}; one-hot mismatches: {exact2}")
        check(exact1 == 0 and exact2 == 0, "K3 exact cases")

        N = self.K3_DRAWS
        row = logits[:1]
        draws = SP.sample_categorical(row.expand(N, -1).contiguous(), gen, temperature=T, min_p=min_p)
        p = masked_softmax(row[0].double().cpu().numpy(), T, min_p)
        freq = np.bincount(draws.cpu().numpy(), minlength=V) / N
        tv = 0.5 * np.abs(freq - p).sum()
        gate = tv_gate(p, N, seed=9)
        outside = float(freq[p == 0].sum())
        log(f"[4 K3] TV over {N} draws of one row: {tv:.5f} (gate {gate:.5f} = 1.2 x the 99.9th "
            f"percentile of exact-sampling TV; {int((p > 0).sum())} tokens kept), "
            f"mass outside min-p {outside:.2e}")
        check(tv <= gate and outside == 0.0, "K3 sampled distribution off")

        kernel = lambda: SP.sample_categorical(logits, gen, temperature=T, min_p=min_p)
        ms, wall_ms = device_ms(kernel, iters=100), time_ms(kernel, iters=100)
        plain_ms = device_ms(lambda: SP.sample_categorical_plain(logits, gen, temperature=T, min_p=min_p),
                             iters=50)
        from smoltts_torch.lm.samplers import min_p_mask

        probs = torch.softmax(min_p_mask(logits / T, min_p), -1)
        library_ms = device_ms(lambda: torch.multinomial(probs, 1, generator=gen), iters=100)
        bms, by = bound(B * V * 4 + B * 4 + 16, 6 * B * V)
        log(f"[4 K3] B=64 V=2368, device time per call: kernel {ms} ms, plain {plain_ms} ms, "
            f"multinomial {library_ms} ms, bound {bms} ms ({by}); kernel wall per call with "
            f"host dispatch {wall_ms} ms")
        self.record("sample_categorical", source="smoltts_torch/csrc/sampling.cu",
                    replaces="smoltts_tpu/ops/sampling.py:36", max_abs_err=float(exact1 + exact2),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)

    def _prompts(self, cfg, B, T):
        from smoltts_torch.lm.prompt import PromptEncoder
        from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig

        tok = ByteTokenizer(cfg.codebook_size)
        token_cfg = TokenConfig.smoltts_v0(cfg.codebook_size)
        pe = PromptEncoder.from_config(tok, cfg, token_cfg)
        texts = [
            "Hello there, how are you today?", "The quick brown fox jumps.",
            "Streaming speech, one frame at a time.", "It is a fine day for a walk.",
            "Numbers: one, two, three, four.", "Please read this sentence aloud.",
        ]
        prompt = np.zeros((B, cfg.num_rows, T), np.int32)
        lens = np.zeros((B,), np.int32)
        for b in range(B):
            turn = np.concatenate([
                pe.encode_text_turn("system", f"<|speaker:{b % 49}|>"),
                pe.encode_text_turn("user", texts[b % len(texts)][: 8 + (b * 7) % 40]),
                pe.encode_text_turn("assistant"),
            ], axis=1)
            check(turn.shape[1] <= T, "prompt longer than the prompt bucket")
            prompt[b, :, : turn.shape[1]] = turn
            lens[b] = turn.shape[1]
        return token_cfg, prompt, lens

    def _run_stream(self, cfg, params, mcfg, mimi, token_cfg, settings, prompt, lens, n_frames,
                    kv_dtype, act_dtype, check_output=None):
        from smoltts_torch.codec.mimi import decode_stream_init
        from smoltts_torch.lm.decode import init_decode_state
        from smoltts_torch.lm.pipeline import (
            flush_cadence, make_flush_step, make_prefill_step, make_stream_step,
        )

        torch, dev = self.torch, self.dev
        B = prompt.shape[0]
        state = init_decode_state(cfg, B, 1024, dtype=kv_dtype, tail_len=128, device=dev)
        ms = decode_stream_init(mcfg, B, dtype=act_dtype, tail_len=64,
                                kv_dtype=torch.int8 if kv_dtype == torch.int8 else None, device=dev)
        prefill_step = make_prefill_step(cfg, token_cfg, settings, mcfg, device=dev)
        stream_step = make_stream_step(cfg, token_cfg, settings, mcfg, attend_limit=256, device=dev)
        flush_step = make_flush_step(device=dev)
        cadence = flush_cadence(state, ms)
        gen = torch.Generator(device=dev).manual_seed(1)
        prompt_t = torch.from_numpy(prompt).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, ms, gen, out = prefill_step(params, mimi, state, ms, prompt_t, lens_t, gen)
        out.pcm[0, :4, 0].cpu()
        t_first = time.perf_counter() - t0
        outs = [out]
        since = 0
        for _ in range(n_frames - 1):
            if since >= cadence:
                state, ms = flush_step(state, ms)
                since = 0
            state, ms, gen, out = stream_step(params, mimi, state, ms, gen)
            since += 1
            outs.append(out)
        out.pcm.cpu()
        total = time.perf_counter() - t0
        if check_output:
            for o in outs:
                check_output(o)
        return t_first, total, outs, (state, ms, gen)

    def phase5_main_path(self):
        from smoltts_torch import ops
        from smoltts_torch.lm.samplers import GenerationSettings

        torch = self.torch
        cfg, params, mcfg, mimi = self.lm()
        B, T, n_frames = 64, 64, 64
        token_cfg, prompt, lens = self._prompts(cfg, B, T)
        settings = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05)

        def check_output(o):
            check(tuple(o.pcm.shape) == (B, mcfg.samples_per_frame, 1), f"PCM shape {tuple(o.pcm.shape)}")
            check(bool(torch.isfinite(o.pcm).all()), "non-finite PCM")
            check(0 <= int(o.audio_codes.min()) and int(o.audio_codes.max()) < cfg.codebook_size,
                  "audio codes out of range")

        # warm-up pass (cuDNN plans, allocator), then the measured pass
        self._run_stream(cfg, params, mcfg, mimi, token_cfg, settings, prompt, lens, 4,
                         torch.int8, torch.bfloat16)
        steps = n_frames - 1
        expect = {"fast_loop": n_frames, "decode_attention": cfg.n_layer * steps,
                  "sample_categorical": n_frames}
        smi = nvidia_smi()
        firsts, rates = [], []
        for rep in range(REPEATS):  # each repeat drives the path from fresh states
            ops.reset_launch_counts()
            t_first, total, outs, (state, mstate, gen) = self._run_stream(
                cfg, params, mcfg, mimi, token_cfg, settings, prompt, lens, n_frames,
                torch.int8, torch.bfloat16, check_output)
            counts = dict(ops.LAUNCHES)
            firsts.append(t_first * 1e3)
            rates.append(B * n_frames * 0.08 / total)
            log(f"[5 main] repeat {rep}: 150M int8+kv8 B=64 S=1024 bucket 256, {n_frames} "
                f"frames on {smi}: first audio {t_first * 1e3} ms, {n_frames / total} "
                f"frame-steps/s, {B * n_frames / total} stream-frames/s, {rates[-1]} audio-s/s "
                f"(wall {total} s); launches {counts}")
            check(counts == expect, f"launch counts {counts}, expected {expect}")
        log(f"[5 main] median of {REPEATS} on {smi}: first audio {float(np.median(firsts))} ms, "
            f"{float(np.median(rates))} audio-s/s")
        for name in self.kernels:
            self.kernels[name]["launches"] = counts[name]
        self._breakdown(cfg, params, mcfg, mimi, token_cfg, settings, state, mstate, gen,
                        outs[-1].audio_codes[:, :, None])

    def _breakdown(self, cfg, params, mcfg, mimi, token_cfg, settings, state, mstate, gen, codes):
        """Where a stream step's time goes: the LM frame and the vocoder step
        timed alone (each call reuses one state, so nothing advances), then a
        profiler window over stream steps for the device's busy share."""
        from smoltts_torch.codec.mimi import mimi_decode_step
        from smoltts_torch.lm.decode import decode_frame
        from smoltts_torch.lm.pipeline import make_flush_step, make_stream_step

        torch = self.torch
        state, mstate = make_flush_step(device=self.dev)(state, mstate)
        with torch.no_grad():
            lm_ms = time_ms(lambda: decode_frame(params, cfg, token_cfg, settings, state, gen,
                                                 attend_limit=256), iters=10)
            voc_ms = time_ms(lambda: mimi_decode_step(mimi, mcfg, mstate, codes), iters=10)
        step = make_stream_step(cfg, token_cfg, settings, mcfg, attend_limit=256, device=self.dev)
        step_ms = time_ms(lambda: step(params, mimi, state, mstate, gen), iters=10)
        log(f"[5 main] per step: stream step {step_ms:.3f} ms = LM frame {lm_ms:.3f} ms "
            f"+ vocoder {voc_ms:.3f} ms (CUDA events, each timed alone)")
        try:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(5):
                    step(params, mimi, state, mstate, gen)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            ev = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
            dev_time = _self_device_ms
            busy = sum(dev_time(e) for e in ev)
            top = sorted(ev, key=dev_time, reverse=True)[:8]
            log(f"[5 main] profiler, 5 stream steps: wall {wall:.2f} ms, device busy "
                f"{busy:.2f} ms ({busy / wall:.3f} busy share, {1 - busy / wall:.3f} idle), "
                f"{sum(e.count for e in ev)} kernel launches")
            for e in top:
                log(f"[5 main]   {dev_time(e):9.3f} ms  x{e.count:<5d} {e.key[:90]}")
        except Exception as e:  # the profiler is a diagnostic: its absence fails nothing
            log(f"[5 main] profiler: not measured ({e!r})")

    def phase6_greedy_e2e(self):
        from smoltts_torch.codec.mimi import init_mimi_params
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.models.dual_ar import init_params
        from smoltts_torch.ops import attention as A
        from smoltts_torch.ops import fast_loop as FL
        from smoltts_torch.ops.quant import (
            fuse_decode_params, fuse_mimi_decode_params, quantize_decode_params,
            quantize_mimi_params,
        )

        torch, dev = self.torch, self.dev
        cfg, _, mcfg, _ = self.lm()
        params = quantize_decode_params(fuse_decode_params(
            init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32, device=dev)))
        mimi = quantize_mimi_params(fuse_mimi_decode_params(
            init_mimi_params(mcfg, seed=0, dtype=torch.float32, device=dev)))
        token_cfg, prompt, lens = self._prompts(cfg, 4, 64)
        greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
        run = lambda: self._run_stream(cfg, params, mcfg, mimi, token_cfg, greedy, prompt, lens,
                                       16, torch.float32, torch.float32)[2]
        kern = run()
        with mock.patch.object(A, "decode_attention_tailed", A.decode_attention_tailed_plain), \
                mock.patch.object(A, "decode_attention", A.decode_attention_plain), \
                mock.patch.object(FL, "fused_fast_micro_loop", FL.fast_micro_loop_plain):
            plain = run()
        codes_k = torch.stack([o.audio_codes for o in kern])
        codes_p = torch.stack([o.audio_codes for o in plain])
        pcm_err = max((a.pcm - b.pcm).abs().max().item() for a, b in zip(kern, plain))
        equal = bool((codes_k == codes_p).all())
        log(f"[6 greedy] B=4 f32 16 frames: codes equal {equal}, PCM max abs diff {pcm_err:.3e} "
            f"(gate 1e-3)")
        check(equal and pcm_err <= 1e-3, "kernel path and plain path differ")

    def run(self):
        table = [
            (1, self.phase1_build), (2, self.phase2_attention), (3, self.phase3_fast_loop),
            (4, self.phase4_sampler), (5, self.phase5_main_path), (6, self.phase6_greedy_e2e),
        ]
        for num, fn in table:
            t0 = time.perf_counter()
            try:
                fn()
                log(f"[phase {num}] ok in {time.perf_counter() - t0:.1f} s")
            except Exception as e:  # every phase runs; any failure fails the run
                self.failures.append(num)
                log(f"[phase {num}] FAILED: {e!r}")
                traceback.print_exc()
                if num == 1:
                    break


def main() -> int:
    smi = nvidia_smi()
    log(f"[0 card] {smi}")
    import torch

    if not torch.cuda.is_available():
        log("[0 card] FAILED: torch.cuda.is_available() is false; this script needs a CUDA card")
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import smoltts_torch  # noqa: F401
    except ImportError as e:
        log(f"[0 card] FAILED: the smoltts_torch package is not beside this script ({e})")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[0 card] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    smoke = Smoke()
    smoke.run()
    if smoke.failures:
        log(f"FAILED phases: {smoke.failures}")
        return 1
    kernels = []
    for rec in smoke.kernels.values():
        rec.setdefault("launches", None)
        kernels.append({k: rec[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
