#!/usr/bin/env python3
"""Drive the PyTorch port (smoltts_torch) on one NVIDIA card and hold every
hand-written CUDA kernel against its plain PyTorch version.

    python3 chip_smoke.py                # needs one CUDA card
    python3 chip_smoke.py --phases 2     # the build and the listed phases only

Phases:
  0  card name and power limit; require CUDA; TF32 off for matmul and cuDNN
  1  build the kernels (nvcc into build/smoltts_torch/) and time the build
  1  also: registers and spills of every kernel variant (ptxas -v)
  2  decode attention (K2) vs its plain version: the main path's shapes,
     lim 256/1024/2048, kv8 and same-dtype histories, bf16 and f32, ragged
     B=1 and 7, edge rows, the 70M heads, hd 128 with G=8, the contiguous
     form; a tail of 2048 columns, a group of 12, hd 32 and 96, f32 over a
     bf16 cache, each timed; device and wall time per call, warm and cold
     (rotating over 10 layer-sized caches), at lim 256 and 2048, beside
     SDPA; make_device_generator at B=1 for 1100 frames with a tail of 1152
  3  fast micro-loop (K1) vs its plain version at 150M widths: B=64, the
     ragged row counts 1, 7, 65, 130, and 8192 sampled draws; 70M widths at
     B=64; identical codes
     from two calls with one seed; device time, device kernels and wall time
     per frame; the frame's products as cuBLAS bf16 matmuls (yardstick)
  4  the slow-token site (K3), f32 and bf16 logits: exact cases (min-p 1,
     one-hot, greedy with ties, finished rows, the audio window over 131k
     draws), TV gates, ids call for call against the kernel's emulation
     (Philox noise in plain PyTorch) at the main shape, ragged V, unaligned
     rows and long rows; K3's own device time by name and the site's device
     and wall time at B=1 and 64, beside a one-element kernel (the floor),
     the plain site, torch.multinomial and the bound
  5  the main path as bench.py runs it: 150M int8 weights, kv8, B=64
     ChatML prompts, S=1024, attend bucket 256, temp 0.7 / 0.7 / min-p 0.05,
     prefill + 63 stream steps with flushes; launch counts per kernel
  6  greedy end to end at B=4 in f32: kernel path (K3 once per frame) ==
     all-plain path
  7  SmolTTS at 150M from a release-format checkpoint written in the run
     (bf16 model.safetensors + config.json, tokenizer.json, a full-size
     mimi.safetensors in the kyutai/HF key schema): loaded trees equal the
     written ones; int8+kv8, sampled with the audio window: __call__, stream
     and create_speaker with launch counts; greedy f32 int8: kernel path ==
     all-plain path for generate_blocking, __call__ and stream; the chunk
     step at B=64, chunk 8, bucket 256 beside phase 5's streaming rate, and
     chunk-step codes == stream-step codes greedy at B=4 in f32
  8  the continuous-batching engine (DecodeEngine, EngineLoop): greedy f32
     at 8 slots with 12 prompts in three waves, codes == the B=1 single-
     stream pipeline and PCM within 1e-3, chunked == single-frame, int16 and
     ulaw frames == the host encoders; then bench.py's served operating
     point (64 slots, 128 streams closed-loop, int8+kv8, chunk 8) with
     audio-s/s, first-audio percentiles, the pop_timing breakdown and
     K1-K3 launches per frame step
  9  the HTTP server (smoltts_torch.server) on phase 7's kind of checkpoint,
     on 127.0.0.1: (i) greedy f32 int8 with build_engine_loop(core, 8):
     /health, /, /metrics, /v1/audio/speech, ElevenLabs pcm_24000,
     wav_16000, ulaw_8000 and mp3_44100_128; 4 concurrent /stream requests
     beside 2 blocking ones: each stream body is the engine's int16 frames
     for it, in order, with the codes of the prompt's B=1 single stream and
     its PCM; each blocking body == pcm_to_int16(model(text)); the server
     started as `main` starts it (a subprocess, load_core from a settings
     JSON) answers /health; (ii) int8+kv8 sampled, build_engine_loop(core,
     64): closed loops of 64 HTTP /stream clients and 128 requests, alone
     (the card's idle share over a 2 s window) and with 4 blocking requests:
     audio-s/s at the socket, client first-chunk p50 / p95, /metrics, K1-K3
     launches per frame step, beside phase 8 (ii)'s rate
  10 the quant gates (smoltts_torch.ops.quant_gate) on phase 5's trees,
     gated in f32 math over the trees' values as bench.py runs the JAX
     gates: int8 LM (CE delta, KL token and codebook, JS and flip mass of
     the sampling distribution), int8 vocoder SNR on greedy codes (K3 at the
     slow-token site), kv8 round-trip SNR and the kv8 read (K2 over an int8
     history, 2 launches); each metric beside its bf16 value, bf16's own
     rounding floor and the JAX value in QUANT_GATE_CACHE.json; a corrupted
     int8 tree must raise QuantGateError
  11 training: (i) tiny f32 forward_train, losses and gradients on the card
     == the CPU; gradients with remat == without at dropout 0.1 (T=512);
     fast_chunk_t losses == dense; (ii) bench_train.py's operating point
     (150M, 16 x 768, bf16, remat and dropout 0.1 as released): 10 steps on
     one batch (2 warm, 5 timed), step ms, tokens/s, MFU, peak memory, the
     loss falls; one profiled step (busy share, top kernels); (iii)
     train_loop with a CheckpointManager, resume from its newest step,
     convert to the release layout, SmolTTS(dir, "int8+kv8") gives finite
     PCM
  12 the data pipeline (smoltts_torch.data_pipeline) at full width: (i)
     MimiCodec.encode_batch on the card == the CPU for 6 ragged utterances
     (f32, TF32 off; a differing code must be a near tie); (ii) 192
     synthetic utterances of 2-17 s through encode_dataset_rows at batch
     24: audio-s/s, the busy share and top kernels of one batch from
     utils.profiling (trace, device_op_summary, held against the profiler's
     own rows); (iii) filter, tokenize and pack with
     config/pipeline/project_gutenberg_v2.json, create_bytelevel_init at
     150M, 3 train steps at 16 x 768 on the packed rows, SmolTTS on the init
     dir; (iv) convert_lm_init at SmolLM2-135M's widths loads bit for bit, a
     finite forward_train; (v) the BPE fixture's HF ids without
     `tokenizers`; (vi) serve_preview's /random WAV

Prints one line per phase, then the kernels' JSON line, the card's name and
power limit, and as the last line {"ok": true, "device": {...}}. Any failed
phase exits non-zero without that last line. No JAX is imported.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
K2_GATE = 1e-2  # bf16 kernel vs the plain version's f32 math on the same inputs
K2_F32_GATE = 1e-5  # f32 kernel vs the plain version: summation order only
K2_COLD = 10  # layer-sized caches K2's cold timing rotates over (the main path's 10 layers)
K1_BF16_LEVEL0_GATE = 0.9  # see phase 3
K3_NEAR_TIE = 1e-5  # kernel vs emulation: a differing id's noisy score, relative (phase 4)
K3_MS_GATE = 0.005  # K3's own device ms per call at B=64, V=2368, bf16, sampled
REPEATS = 3  # measured passes of the main path (phase 5)
TRAIN_BATCH, TRAIN_SEQ = 16, 768  # bench_train.py's operating point (phase 11)
PIPE_UTTS, PIPE_BATCH = 192, 24  # phase 12: utterances, encode_audio's CLI batch size
# Phase 12 (i): a code that differs card vs CPU, scored on the CPU's residual,
# within this fraction of the codebook's score range below the CPU's code.
RVQ_NEAR_TIE = 1e-3
# SmolLM2-135M's published widths (its HF config.json), phase 12 (iv)
SMOLLM2_135M = dict(hidden_size=576, num_hidden_layers=30, num_attention_heads=9,
                    num_key_value_heads=3, intermediate_size=1536, vocab_size=49152,
                    tie_word_embeddings=True)
# Phase 9 (i): a /stream body against the prompt's B=1 single stream. The
# server's engine keeps its vocoder state, and so its PCM, in bf16 (8
# significant bits, 48 dB for one rounding), and the card's kernels round it
# differently at the engine's shapes than at B=1; one misplaced or corrupted
# frame of 24 brings a stream to ~14 dB.
STREAM_SNR_GATE = 30.0
K1_KERNELS = re.compile(r"\b(gemm_i8|fast_attn|fast_sample|init_h)\b")  # csrc/fast_loop.cu
K3_KERNEL = re.compile(r"\bsample_tokens_kernel\b")  # csrc/sampling.cu
PORT_KERNELS = re.compile(r"\b(decode_attn_kernel|sample_tokens_kernel)\b")  # K2, K3


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
    return device_profile(fn, iters, warmup)[0]


def device_profile(fn, iters=20, warmup=3):
    """(device ms per call, device kernels per call, {kernel name: count per
    call}) from one profiler window."""
    rows = _kernel_rows(fn, iters, warmup)
    total = sum(_self_device_ms(e) for e in rows)
    kernels = {e.key: e.count / iters for e in rows}
    if total <= 0:
        return time_ms(fn, iters, warmup=0), None, {}
    return total / iters, sum(kernels.values()), kernels


def device_by_name(fn, pattern, iters=100, warmup=5):
    """(device ms per call of the kernels whose names match `pattern`,
    device ms per call of all kernels, device kernels per call) from one
    profiler window."""
    rows = _kernel_rows(fn, iters, warmup)
    own = sum(_self_device_ms(e) for e in rows if pattern.search(e.key)) / iters
    check(own > 0, f"no device time for {pattern.pattern} in the profiler window")
    return own, sum(_self_device_ms(e) for e in rows) / iters, sum(e.count for e in rows) / iters


def _kernel_rows(fn, iters, warmup):
    """The profiler window's rows of device kernels. Only these count: the
    row of the PyTorch op that launched a kernel repeats that kernel's time
    (summing every row counted such kernels twice)."""
    return [e for e in _profile(fn, iters, warmup).key_averages() if _on_device(e)]


def _profile(fn, iters, warmup):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof


def trace_events(prof) -> list:
    """The window's events as its Chrome trace holds them."""
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def trace_kernels(prof):
    """The window's device kernels as (name, start us, end us), by start."""
    return kernel_intervals(trace_events(prof))


def kernel_intervals(events) -> list:
    """The device kernels of Chrome-trace events as (name, start us, end us),
    by start."""
    ks = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for e in events if e.get("cat") == "kernel"]
    return sorted(ks, key=lambda k: k[1])


def trace_categories(prof) -> dict:
    """How many events of each category the window's trace holds."""
    cats = {}
    for e in trace_events(prof):
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    return cats


def busy_us(kernels) -> float:
    """Time the device runs at least one kernel (kernels of one stream may
    overlap under programmatic dependent launch)."""
    busy, end = 0.0, -math.inf
    for _, t0, t1 in kernels:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


def k1_span(fn, iters=20, warmup=3):
    """K1's device time per call: the median span from its first kernel's
    start to its last kernel's end (its kernels overlap their neighbours under
    programmatic dependent launch, so their durations do not add up), and
    the device kernels per call: K1's own and all."""
    kernels = trace_kernels(_profile(fn, iters, warmup))
    own = [k for k in kernels if K1_KERNELS.search(k[0])]
    per = len(own) // iters
    spans = [own[i * per + per - 1][2] - own[i * per][1] for i in range(iters)]
    return float(np.median(spans)) / 1e3, per, len(kernels) / iters


def _self_device_ms(event) -> float:
    return getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0)) / 1e3


def _on_device(event) -> bool:
    return getattr(event, "device_type", None) is not None and "CUDA" in str(event.device_type)


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step (forward + 2x backward), each component
    at the token count it processes: the fast trunk runs max_fast_seqlen
    tokens per slow token, the depthwise head n [fast_dim, cb] products per
    frame; causal attention halved; remat recompute excluded. A copy of
    bench_train.py::model_flops_per_step (which imports JAX)."""

    def trunk_params(n_layer, dim, q, kv, ffn):
        return n_layer * (dim * (q + 2 * kv) + q * dim + 3 * dim * ffn)

    n_slow = trunk_params(cfg.n_layer, cfg.dim, cfg.n_head * cfg.head_dim,
                          cfg.n_local_heads * cfg.head_dim, cfg.intermediate_size)
    n_fast = trunk_params(cfg.n_fast_layer, cfg.fast_dim, cfg.fast_n_head * cfg.fast_head_dim,
                          cfg.fast_n_local_heads * cfg.fast_head_dim, cfg.fast_intermediate_size)
    BT = batch * seq
    n = cfg.max_fast_seqlen
    fwd = 2.0 * n_slow * BT + 2.0 * n_fast * BT * n + 2.0 * cfg.dim * cfg.vocab_size * BT
    if cfg.depthwise_output:
        fwd += 2.0 * n * cfg.fast_dim * cfg.codebook_size * BT
    else:
        fwd += 2.0 * cfg.fast_dim * cfg.codebook_size * BT * n
    if cfg.fast_dim != cfg.dim:
        fwd += 2.0 * cfg.dim * cfg.fast_dim * BT
    fwd += cfg.n_layer * 2.0 * batch * seq * seq * cfg.dim
    fwd += cfg.n_fast_layer * 2.0 * BT * n * n * cfg.fast_dim
    return 3.0 * fwd


def bound(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(text: str):
    """[(kernel, registers, stack bytes, spill store bytes, spill load bytes)]
    from nvcc's `-Xptxas -v` output, names demangled by cu++filt where the
    toolkit has it."""
    rows, current, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            rows.setdefault(current, [0, 0, 0, 0])
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props in rows:
            rows[props][1:] = [int(g) for g in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and current in rows:
            rows[current][0] = int(m.group(1))
    names = list(rows)
    try:
        filt = Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc").parent / "cu++filt"
        out = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True,
                             timeout=30).stdout.splitlines()
        pretty = out if len(out) == len(names) else names
    except (OSError, subprocess.SubprocessError):
        pretty = names
    return [(p, *rows[n]) for p, n in zip(pretty, names)]


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


def trees_equal(a, b) -> bool:
    """Two parameter trees hold the same leaves bit for bit (dtype and shape
    included)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and bool((a.to(b.device) == b).all())


# (leaf of a codec transformer layer) -> (HF key under `{prefix}.layers.{i}.`, transposed)
HF_TRANSFORMER_KEYS = {
    "ln1_w": ("input_layernorm.weight", False), "ln1_b": ("input_layernorm.bias", False),
    "ln2_w": ("post_attention_layernorm.weight", False),
    "ln2_b": ("post_attention_layernorm.bias", False),
    "wq": ("self_attn.q_proj.weight", True), "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True), "wo": ("self_attn.o_proj.weight", True),
    "fc1": ("mlp.fc1.weight", True), "fc2": ("mlp.fc2.weight", True),
    "scale_attn": ("self_attn_layer_scale.scale", False),
    "scale_mlp": ("mlp_layer_scale.scale", False),
}


def mimi_hf_state(params, cfg) -> dict:
    """A Mimi tree as a kyutai/HF state dict: the inverse of
    `smoltts_torch.codec.mimi.params_from_hf_state_dict`, with each codebook
    stored as embed_sum = embed and cluster_usage = 1."""
    import torch

    from smoltts_torch.codec.seanet import build_decoder_plan, build_encoder_plan

    st = {}

    def conv(key, p):  # [K, I/groups, O] -> [O, I/groups, K]
        st[key + ".weight"] = p["w"].permute(2, 1, 0)
        if "b" in p:
            st[key + ".bias"] = p["b"]

    def convtr(key, p, depthwise):  # flipped [K, I/groups, O] -> [I, O/groups, K]
        w = p["w"].permute(2, 1, 0) if depthwise else p["w"].permute(1, 2, 0)
        st[key + ".weight"] = w.flip(-1)
        if "b" in p:
            st[key + ".bias"] = p["b"]

    for side, plan in (("encoder", build_encoder_plan(cfg)), ("decoder", build_decoder_plan(cfg))):
        for i, (spec, p) in enumerate(zip(plan, params[side])):
            base = f"{side}.layers.{i}"
            if spec.kind == "conv":
                conv(base + ".conv", p)
            elif spec.kind == "convtr":
                convtr(base + ".conv", p, depthwise=False)
            elif spec.kind == "resnet":
                conv(base + ".block.1.conv", p["conv1"])
                conv(base + ".block.3.conv", p["conv2"])
    for name in ("encoder_transformer", "decoder_transformer"):
        for leaf, (key, transpose) in HF_TRANSFORMER_KEYS.items():
            stacked = params[name]["layers"][leaf]
            for i in range(stacked.shape[0]):
                st[f"{name}.layers.{i}.{key}"] = stacked[i].T if transpose else stacked[i]
    conv("downsample.conv", params["downsample"])
    convtr("upsample.conv", params["upsample"], depthwise=True)
    for side in ("semantic", "acoustic"):
        q, prefix = params["quantizer"][side], f"quantizer.{side}_residual_vector_quantizer"
        st[prefix + ".input_proj.weight"] = q["in_proj"].T[:, :, None]
        st[prefix + ".output_proj.weight"] = q["out_proj"].T[:, :, None]
        for i, embed in enumerate(q["embed"]):
            st[f"{prefix}.layers.{i}.codebook.embed_sum"] = embed
            st[f"{prefix}.layers.{i}.codebook.cluster_usage"] = torch.ones(embed.shape[0])
            st[f"{prefix}.layers.{i}.codebook.initialized"] = torch.ones(1)
    return {k: v.contiguous() for k, v in st.items()}


# ---- the HTTP server (phase 9) ----------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_open(port: int) -> bool:
    import socket

    try:
        with socket.create_connection(("127.0.0.1", port), timeout=0.2):
            return True
    except OSError:
        return False


def serve_app(app):
    """Run an HttpServer on a free 127.0.0.1 port in a thread: (port, thread)."""
    import threading

    port = free_port()
    th = threading.Thread(target=app.run, args=("127.0.0.1", port), daemon=True)
    th.start()
    deadline = time.time() + 60
    while not port_open(port):
        check(time.time() < deadline and th.is_alive(), "the server did not start")
        time.sleep(0.05)
    return port, th


def stop_app(app, th) -> None:
    app.stop()
    th.join(timeout=30)
    check(not th.is_alive(), "the server thread did not stop")


def request(port, method, path, body=None, timeout=600):
    """(status, {header: value}, body bytes) of one HTTP request."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


def run_threads(jobs: dict, timeout=600) -> dict:
    """Run each callable of `jobs` on its own thread at once: {key: result}."""
    import threading

    results, errors = {}, []

    def run(key, fn):
        try:
            results[key] = fn()
        except Exception as e:  # reported below: a failed request fails the phase
            errors.append((key, repr(e)))

    threads = [threading.Thread(target=run, args=kv, daemon=True) for kv in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    check(not any(t.is_alive() for t in threads), "a request thread hung")
    check(not errors, f"requests failed: {errors[:3]}")
    return results


def tap_loop(loop):
    """Record what an EngineLoop serves: each stream's prompt, the frames it
    emitted in emission order, and the frame indices before which the
    engine flushed while the stream was live."""
    from types import SimpleNamespace

    eng, rec = loop.engine, SimpleNamespace(prompts={}, frames={}, flushes={})
    submit, emit, flush = loop.submit, loop._emit, eng._flush

    def tapped_submit(prompt, max_frames=None):
        q = submit(prompt, max_frames)
        rec.prompts[q.sid] = np.asarray(prompt)
        return q

    def tapped_emit(frames):
        for sid, frame in frames:
            rec.frames.setdefault(sid, []).append(frame)
        emit(frames)

    def tapped_flush(state, mstate):
        for sid, h in eng._streams.items():
            if h.slot >= 0:
                rec.flushes.setdefault(sid, []).append(1 + h.frames_dispatched)
        return flush(state, mstate)

    loop.submit, loop._emit, eng._flush = tapped_submit, tapped_emit, tapped_flush
    return rec


# ---- the data pipeline (phase 12) -------------------------------------------


def pipe_mimi_config():
    """Phase 12's Mimi: the full-size release config."""
    from smoltts_torch.codec.config import MimiConfig

    return MimiConfig()


def pipe_lm_config():
    """Phase 12's model: the released 150M byte preset as create_init makes it."""
    from smoltts_torch.config import smoltts_byte_150m

    return smoltts_byte_150m()


def warm_start_config():
    """(DualAR config, HF widths) of the SmolLM2-135M warm start: the 70M
    preset's widths are SmolLM2-135M's; 30 layers, and the LM's 49152 ids
    followed by the 64 control and speaker ids and the 2048 semantic ids."""
    from smoltts_torch.config import smoltts_byte_70m

    hf = SMOLLM2_135M
    cfg = smoltts_byte_70m().replace(n_layer=hf["num_hidden_layers"],
                                     vocab_size=hf["vocab_size"] + 64 + 2048, dropout=0.0)
    check((cfg.dim, cfg.n_head, cfg.n_local_heads, cfg.intermediate_size, cfg.tie_word_embeddings)
          == (hf["hidden_size"], hf["num_attention_heads"], hf["num_key_value_heads"],
              hf["intermediate_size"], hf["tie_word_embeddings"]), "SmolLM2-135M widths")
    return cfg, hf


def mimi_encoder_flops(cfg, num_quantizers: int = 8) -> float:
    """FLOPs of the Mimi encoder per audio-second (2 per multiply-add): the
    SEANet convs and residual blocks at their sample rates, the transformer's
    products and windowed attention at its frame rate, the downsample conv,
    and the RVQ's input projections and distances."""
    from smoltts_torch.codec.seanet import build_encoder_plan

    rate, macs = float(cfg.sampling_rate), 0.0
    for s in build_encoder_plan(cfg):
        if s.kind == "conv":
            rate /= s.stride
            macs += rate * s.in_ch * s.out_ch * s.kernel
        elif s.kind == "resnet":
            macs += rate * (s.in_ch * s.res_hidden * s.res_kernel + s.res_hidden * s.out_ch)
    d, L = cfg.hidden_size, cfg.num_hidden_layers
    macs += rate * L * (4 * d * d + 2 * d * cfg.intermediate_size + 2 * d * cfg.sliding_window)
    frames = cfg.frame_rate
    macs += frames * d * d * cfg.downsample_kernel
    macs += frames * (2 * d * cfg.codebook_dim + num_quantizers * cfg.codebook_size * cfg.codebook_dim)
    return 2.0 * macs


def smollm_state(hf: dict, seed: int) -> dict:
    """A seeded Llama-style HF state dict (numpy f32) at the widths of `hf`,
    tied embeddings (no lm_head)."""
    rng = np.random.default_rng(seed)
    D, F = hf["hidden_size"], hf["intermediate_size"]
    kv = hf["num_key_value_heads"] * (D // hf["num_attention_heads"])

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    st = {"model.embed_tokens.weight": w(hf["vocab_size"], D),
          "model.norm.weight": np.ones(D, np.float32)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        st.update({p + "self_attn.q_proj.weight": w(D, D), p + "self_attn.k_proj.weight": w(kv, D),
                   p + "self_attn.v_proj.weight": w(kv, D), p + "self_attn.o_proj.weight": w(D, D),
                   p + "mlp.gate_proj.weight": w(F, D), p + "mlp.up_proj.weight": w(F, D),
                   p + "mlp.down_proj.weight": w(D, F),
                   p + "input_layernorm.weight": np.ones(D, np.float32),
                   p + "post_attention_layernorm.weight": np.ones(D, np.float32)})
    return st


def synth_audio(rng, n: int, sr: int) -> np.ndarray:
    """n samples of seeded speech-band audio: three sines under a slow
    envelope, plus noise."""
    t = np.arange(n, dtype=np.float32) / np.float32(sr)
    f, ph = rng.uniform(90, 400, 3), rng.uniform(0, 2 * np.pi, 3)
    x = sum(np.sin(np.float32(2 * np.pi * fi) * t + np.float32(p)) for fi, p in zip(f, ph)) / 3
    env = 0.5 + 0.5 * np.sin(np.float32(2 * np.pi * rng.uniform(0.5, 3.0)) * t)
    return (0.3 * env * x + 0.02 * rng.standard_normal(n, dtype=np.float32)).astype(np.float32)


def pipeline_utterances(n: int, sr: int, speakers, seed: int) -> list:
    """n rows as an audio dataset holds them: durations uniform in 2-17 s,
    synthetic audio, seeded words at about 15 characters per audio second,
    a speaker from `speakers`."""
    rng = np.random.default_rng(seed)
    rows = []
    for dur in rng.uniform(2.0, 17.0, n):
        words, chars = [], 0
        while chars < 15 * dur:
            words.append("".join(chr(c) for c in rng.integers(97, 123, int(rng.integers(2, 9)))))
            chars += len(words[-1]) + 1
        rows.append({"audio": {"array": synth_audio(rng, int(dur * sr), sr), "sampling_rate": sr},
                     "text_normalized": " ".join(words).capitalize() + ".",
                     "speaker_id": speakers[int(rng.integers(0, len(speakers)))]})
    return rows


SERVER_TEXTS = [
    "Hello there, this is the server speaking on the card.",
    "Streaming speech over HTTP, one frame at a time.",
    "The quick brown fox jumps over the lazy dog.",
    "Numbers: one, two, three, four, five.",
]


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
        self.stream_rate = None  # phase 5's median audio-s/s, shown beside phase 7's chunk step
        self.served_rates = []  # phase 8 (ii)'s audio-s/s per rep, shown beside phase 9 (ii)

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
        _build.lib()
        log(f"[1 build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
            f"(nvcc wall {_build.BUILD_SECONDS})")
        if not _build.BUILD_LOGS:
            return
        full = _build.BUILD_DIR / "nvcc.log"
        full.write_text("\n".join(f"[nvcc {k}]\n{v}" for k, v in _build.BUILD_LOGS.items()))
        for src, text in sorted(_build.BUILD_LOGS.items()):
            rows = ptxas_report(text)
            spilling = [r for r in rows if r[3] or r[4]]
            log(f"[1 build] {src}: nvcc {_build.BUILD_TIMES.get(src)} s, {len(rows)} kernels, "
                f"{len(spilling)} with register spills (ptxas -v; full log "
                f"{full.relative_to(ROOT)})")
            for name, regs, stack, st, ld in spilling:
                log(f"[1 build]   spills {st} B stored / {ld} B loaded, {regs} registers, "
                    f"{stack} B stack: {name[:160]}")

    def _k2_case(self, B, H, KV, hd, S, lim, W, kv8, dtype, seed, copies=1, store=None):
        """Inputs of one tailed K2 call: the history as the decode step passes
        it (a [:lim] view of an S-long cache), a tail in the storage dtype
        (`store`, default the compute dtype) with permuted columns and one
        stale column per row. With B >= 8 rows 0-2 are edge
        rows: tail only (flushed = 0), a full history with an empty tail
        (flushed = lim, pos = lim - 1), and flushed past lim (history clipped).
        Returns (kernel kwargs for each of `copies` caches, reference kwargs
        of the first in f32, (flushed, pos, tail_pos) as numpy)."""
        from smoltts_torch.ops.quant import quantize_kv

        torch, dev = self.torch, self.dev
        g = torch.Generator(device=dev).manual_seed(seed)
        rnd = lambda *s: torch.randn(s, generator=g, device=dev)
        rng = np.random.default_rng(seed)
        flushed = rng.integers(lim // 2, lim - W // 2, B)
        n_new = rng.integers(1, W // 2, B)
        pos = np.minimum(flushed + n_new - 1, lim - 1)
        if B >= 8:
            flushed[0], pos[0] = 0, n_new[0] - 1
            flushed[1], pos[1] = lim, lim - 1
            flushed[2], pos[2] = lim + 5, lim + 10
        tail_pos = np.full((B, W), -1, np.int64)
        for b in range(B):
            cols = rng.permutation(W)[: pos[b] - flushed[b] + 1]
            tail_pos[b, cols] = np.arange(flushed[b], pos[b] + 1)
            tail_pos[b, rng.integers(0, W)] = flushed[b] - 3 if flushed[b] >= 3 else -1  # stale
            tail_pos[b, cols[:1]] = flushed[b]
        t32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
        q = rnd(B, H, hd).to(dtype)
        common = dict(pos=t32(pos), flushed=t32(flushed), tail_pos=t32(tail_pos))
        view = lambda t: t[0, :, :, :lim]
        args, ref = [], None
        for _ in range(copies):
            kf, vf = rnd(1, B, KV, S, hd), rnd(1, B, KV, S, hd)
            kt, vt = rnd(B, KV, W, hd).to(store or dtype), rnd(B, KV, W, hd).to(store or dtype)
            if kv8:
                kq, ks = quantize_kv(kf)
                vq, vs = quantize_kv(vf)
                hist = dict(k_hist=view(kq), v_hist=view(vq), k_scale=view(ks), v_scale=view(vs))
                hist32 = dict(hist)
            else:
                hist = dict(k_hist=view(kf.to(store or dtype)), v_hist=view(vf.to(store or dtype)))
                hist32 = {k: v.float() for k, v in hist.items()}
            args.append(dict(q=q, k_tail=kt, v_tail=vt, **common, **hist))
            if ref is None:
                ref = dict(q=q.float(), k_tail=kt.float(), v_tail=vt.float(), **common, **hist32)
            del kf, vf
        return args, ref, (flushed, pos, tail_pos)

    def _k2_sdpa(self, a):
        """SDPA over the dequantized, concatenated cache of one call (the
        library yardstick's inputs, built once)."""
        torch = self.torch
        H, KV = a["q"].shape[1], a["k_hist"].shape[1]
        if "k_scale" in a:
            kd = (a["k_hist"].float() * a["k_scale"][..., None]).to(a["q"].dtype)
            vd = (a["v_hist"].float() * a["v_scale"][..., None]).to(a["q"].dtype)
        else:
            kd, vd = a["k_hist"], a["v_hist"]
        kcat = torch.cat([kd, a["k_tail"]], 2).repeat_interleave(H // KV, 1)
        vcat = torch.cat([vd, a["v_tail"]], 2).repeat_interleave(H // KV, 1)
        lim = kd.shape[2]
        fl, tp, posd = a["flushed"], a["tail_pos"], a["pos"]
        mh = torch.arange(lim, device=self.dev)[None] < fl[:, None]
        mt = (tp >= fl[:, None]) & (tp <= posd[:, None]) & (tp >= 0)
        mask = torch.cat([mh, mt], 1)[:, None, None, :]
        return a["q"][:, :, None, :], kcat, vcat, mask

    def phase2_attention(self):
        import torch.nn.functional as F

        from smoltts_torch.ops import attention as A

        torch, dev = self.torch, self.dev
        bf16, f32 = torch.bfloat16, torch.float32
        # (label, B, H, n_kv, hd, S, lim, W, kv8, dtype); gate 1e-2 in bf16
        # against the plain f32 math on the same inputs, 1e-5 in f32 (the
        # summation order is the only difference)
        cases = [
            ("main lim 256 kv8", 64, 12, 4, 64, 1024, 256, 128, True, bf16),
            ("main lim 256 bf16 history", 64, 12, 4, 64, 1024, 256, 128, False, bf16),
            ("lim 1024 kv8", 64, 12, 4, 64, 1024, 1024, 128, True, bf16),
            ("lim 1024 bf16 history", 64, 12, 4, 64, 1024, 1024, 128, False, bf16),
            ("f32 lim 256 kv8", 64, 12, 4, 64, 1024, 256, 128, True, f32),
            ("f32 lim 256 f32 history", 64, 12, 4, 64, 1024, 256, 128, False, f32),
            ("B=1 lim 256 kv8", 1, 12, 4, 64, 1024, 256, 128, True, bf16),
            ("B=7 lim 256 kv8", 7, 12, 4, 64, 1024, 256, 128, True, bf16),
            ("f32 B=7 lim 256 kv8", 7, 12, 4, 64, 1024, 256, 128, True, f32),
            ("B=1 lim 2048 kv8", 1, 12, 4, 64, 2048, 2048, 128, True, bf16),
            ("70M heads 9/3 kv8", 64, 9, 3, 64, 1024, 256, 128, True, bf16),
            ("hd 128 G=8 kv8", 64, 32, 4, 128, 1024, 256, 128, True, bf16),
            ("f32 hd 128 G=8 f32 history", 16, 32, 4, 128, 1024, 256, 128, False, f32),
            ("lim 2048 kv8", 64, 12, 4, 64, 2048, 2048, 128, True, bf16),
        ]
        # every compiled variant (dtype, history, hd, group of <= 3 or <= 8)
        # with a partial group: G = 2 and 5 over 2 kv heads
        cases += [(f"variant {str(dtype)[6:]} {'kv8' if kv8 else 'same-dtype'} hd {hd} G={G}",
                   8, 2 * G, 2, hd, 256, 256, 128, kv8, dtype)
                  for dtype in (bf16, f32) for kv8 in (True, False) for hd in (64, 128)
                  for G in (2, 5)]
        # f32 compute over a bf16 tail (and bf16 or int8 history): the bf16
        # cache an f32 model keeps in the blocking generator. That kernel
        # places the plain version's bf16 roundings, so it is held against the
        # plain version on the same inputs, at the bf16 gate (a probability
        # that rounds the other way moves an output by up to ~1e-3)
        cases = [c + (None,) for c in cases] + [
            (f"f32 over bf16 tail, {'kv8' if kv8 else 'bf16'} history B={B} hd {hd} G={H // KV}",
             B, H, KV, hd, 2048, 2048, 128, kv8, f32, bf16)
            for kv8 in (False, True) for B, H, KV, hd in ((1, 12, 4, 64), (7, 12, 3, 128))]
        worst = {bf16: 0.0, f32: 0.0}
        for i, (label, B, H, KV, hd, S, lim, W, kv8, dtype, store) in enumerate(cases):
            (args,), ref, _ = self._k2_case(B, H, KV, hd, S, lim, W, kv8, dtype, seed=20 + i,
                                            store=store)
            got = A.decode_attention_tailed(**args)
            want = A.decode_attention_tailed_plain(**(args if store else ref))
            err = (got.float() - want).abs().max().item()
            gate = bf16 if store else dtype
            worst[gate] = max(worst[gate], err)
            extra = f", {int(((got - want).abs() > 1e-5).sum())} of {got.numel()} above 1e-5" if store else ""
            log(f"[2 K2] {label}: B={B} H={H}/{KV} hd={hd} lim={lim} W={W}: max_abs_err {err:.3e} "
                f"(gate {K2_GATE if gate == bf16 else K2_F32_GATE}){extra}")
        self._k2_wide_shapes(worst)
        for dtype in (bf16, f32):  # contiguous form (W = 0, flushed = pos + 1)
            g = torch.Generator(device=dev).manual_seed(5)
            kc, vc = (torch.randn((64, 4, 256, 64), generator=g, device=dev).to(dtype) for _ in "kv")
            q = torch.randn((64, 12, 64), generator=g, device=dev).to(dtype)
            pos = torch.from_numpy(np.random.default_rng(5).integers(0, 256, 64).astype(np.int32)).to(dev)
            err = (A.decode_attention(q, kc, vc, pos).float()
                   - A.decode_attention_plain(q.float(), kc.float(), vc.float(), pos)).abs().max().item()
            worst[dtype] = max(worst[dtype], err)
            log(f"[2 K2] contiguous S=256 {str(dtype)[6:]}: max_abs_err {err:.3e}")
        check(worst[bf16] <= K2_GATE, f"K2 bf16 error {worst[bf16]} above {K2_GATE}")
        check(worst[f32] <= K2_F32_GATE, f"K2 f32 error {worst[f32]} above {K2_F32_GATE}")

        # Times: warm (one input, repeated: it stays in the 50 MB L2) and cold
        # (calls rotate over K2_COLD layer-sized caches, more than the L2
        # holds, as the main path's 10 layers do).
        rec = None
        for label, S, lim in (("main path lim 256", 1024, 256), ("lim 2048", 2048, 2048)):
            B, H, KV, hd, W = 64, 12, 4, 64, 128
            args, _, (flushed, pos, tail_pos) = self._k2_case(
                B, H, KV, hd, S, lim, W, True, bf16, seed=7, copies=K2_COLD)
            n_hist = int(np.minimum(flushed, lim).sum())
            n_tail = int(((tail_pos >= flushed[:, None]) & (tail_pos <= pos[:, None])).sum())
            nbytes = (B * H * hd * 2 + n_hist * KV * (2 * hd + 2 * 4) + n_tail * KV * 2 * hd * 2
                      + tail_pos.size * 4 + 2 * B * 4 + B * H * hd * 2)
            bms, by = bound(nbytes, 4 * H * hd * (n_hist + n_tail))
            warm = lambda: A.decode_attention_tailed(**args[0])
            rotation = itertools.cycle(args)
            cold = lambda: A.decode_attention_tailed(**next(rotation))
            ms, per_call, _ = device_profile(warm, iters=50)
            cold_ms = device_ms(cold, iters=50)
            wall_ms, cold_wall_ms = time_ms(warm, iters=50), time_ms(cold, iters=50)
            sd = [self._k2_sdpa(a) for a in args]
            sdpa = lambda q4, k, v, mask: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask)
            lib_ms = device_ms(lambda: sdpa(*sd[0]), iters=50)
            sd_rotation = itertools.cycle(sd)
            lib_cold_ms = device_ms(lambda: sdpa(*next(sd_rotation)), iters=50)
            del sd, sd_rotation
            log(f"[2 K2] {label} (B=64 H=12/4 hd=64 W=128 kv8 bf16, {n_hist} history rows + "
                f"{n_tail} tail columns valid), device ms per call: warm {ms}, cold {cold_ms} "
                f"(over {K2_COLD} caches, {K2_COLD * nbytes / 1e6:.0f} MB read); wall per call "
                f"with host dispatch: warm {wall_ms}, cold {cold_wall_ms}; bound {bms} ({by}, "
                f"{nbytes / 1e6:.2f} MB); SDPA warm {lib_ms}, cold {lib_cold_ms}; device "
                f"kernels per call {per_call}")
            check(ms < lib_ms, f"K2 {label} warm {ms} ms not below SDPA {lib_ms} ms")
            if rec is None:
                plain_ms = device_ms(lambda: A.decode_attention_tailed_plain(**args[0]), iters=20)
                log(f"[2 K2] {label}: plain version {plain_ms} ms")
                rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
            del args, rotation
        self.record("decode_attention", source="smoltts_torch/csrc/decode_attention.cu",
                    replaces="smoltts_tpu/ops/attention.py:53",
                    max_abs_err=max(worst.values()), **rec)
        self._long_device_generator()

    def _k2_wide_shapes(self, worst):
        """Shapes past the tuned kernel's first limits, all served in-kernel:
        a tail of 2048 columns (valid columns on both sides of 1024, the
        old limit), a group of 12 over one kv head (two group tiles),
        head_dim 32 (a tuned template) and 96 (the generic kernel), in bf16
        and f32 over kv8 and same-dtype histories; then f32 compute over a
        bf16 cache (the generic kernel's rounding mode) at these shapes and
        at the blocking generator's. Each against the plain version, with
        device ms per call beside the plain version's."""
        from smoltts_torch.ops import attention as A

        torch = self.torch
        bf16, f32 = torch.bfloat16, torch.float32
        shapes = [("W=2048", 8, 12, 4, 64, 4096, 4096, 2048),
                  ("G=12 over 1 kv head", 8, 12, 1, 64, 1024, 256, 128),
                  ("hd 32", 8, 12, 4, 32, 1024, 256, 128),
                  ("hd 32 heads 2/1 (tiny_debug_config)", 8, 2, 1, 32, 1024, 256, 128),
                  ("hd 96", 8, 12, 4, 96, 1024, 256, 128),
                  ("hd 96 G=12 W=2048", 8, 12, 1, 96, 4096, 4096, 2048)]
        cases = [(label, sh, dtype, kv8, None) for label, *sh in shapes
                 for dtype in (bf16, f32) for kv8 in (True, False)]
        cases += [(f"f32 over bf16 cache, {label}", sh, f32, kv8, bf16)
                  for label, *sh in (shapes[0], shapes[5],
                                     ("B=1 lim 2048 (blocking generator)", 1, 12, 4, 64, 2048, 2048, 128),
                                     ("B=64 lim 256", 64, 12, 4, 64, 1024, 256, 128))
                  for kv8 in (False, True)]
        for i, (label, (B, H, KV, hd, S, lim, W), dtype, kv8, store) in enumerate(cases):
            (args,), ref, (fl, ps, tp) = self._k2_case(B, H, KV, hd, S, lim, W, kv8, dtype,
                                                       seed=200 + i, store=store)
            ok = (tp >= fl[:, None]) & (tp <= ps[:, None]) & (tp >= 0)
            sides = ""
            if W > 1024:
                both = int((ok[:, :1024].any(1) & ok[:, 1024:].any(1)).sum())
                check(both > 0, f"K2 {label}: no row with valid columns on both sides of 1024")
                sides = f", {both} of {B} rows with valid columns on both sides of 1024"
            got = A.decode_attention_tailed(**args)
            want = A.decode_attention_tailed_plain(**(args if store else ref))
            err = (got.float() - want).abs().max().item()
            gate = bf16 if store else dtype
            worst[gate] = max(worst[gate], err)
            ms = device_ms(lambda: A.decode_attention_tailed(**args), iters=20)
            plain_ms = device_ms(lambda: A.decode_attention_tailed_plain(**args), iters=5)
            log(f"[2 K2] {label}, {str(dtype)[6:]} {'kv8' if kv8 else 'same-dtype'} history: "
                f"B={B} H={H}/{KV} hd={hd} lim={lim} W={W}, {A.kernel_plan(**args).route} kernel: "
                f"max_abs_err {err:.3e} (gate {K2_GATE if gate == bf16 else K2_F32_GATE}){sides}; "
                f"device ms per call {ms}, plain {plain_ms}")

    def _long_device_generator(self):
        """make_device_generator at B=1 for 1100 frames with a tail of 1152
        columns and no flush: K2 compacts tails of more than 1024 columns."""
        from smoltts_torch import ops
        from smoltts_torch.lm.decode import init_decode_state
        from smoltts_torch.lm.generate import make_device_generator
        from smoltts_torch.lm.samplers import GenerationSettings

        torch, dev = self.torch, self.dev
        cfg, params, _, _ = self.lm()
        token_cfg, prompt, lens = self._prompts(cfg, 1, 64)
        N, W = 1100, 1152
        settings = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05)
        run = make_device_generator(cfg, token_cfg, settings, N, device=dev)
        state = init_decode_state(cfg, 1, cfg.max_seq_len, dtype=torch.int8, tail_len=W, device=dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes, valid, _ = run(params, state, torch.from_numpy(prompt).to(dev),
                              torch.from_numpy(lens).to(dev), gen)
        codes = codes.cpu()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        check(tuple(codes.shape) == (1, cfg.num_codebooks, N), f"device generator codes {tuple(codes.shape)}")
        check(0 <= int(codes.min()) and int(codes.max()) < cfg.codebook_size, "codes out of range")
        check(counts["decode_attention"] == cfg.n_layer * (N - 1), f"K2 launches {counts}")
        log(f"[2 K2] make_device_generator 150M int8+kv8 B=1, {N} frames, tail {W} (S "
            f"{cfg.max_seq_len}): ran to the end in {wall:.2f} s ({N / wall:.1f} frames/s), "
            f"{int(valid.sum())} audio frames; launches {counts}")

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

        # f32 is exact FMAs in another order: greedy codes equal the plain
        # loop's, at B=64 and at row counts that leave the 64-row tiles ragged.
        # bf16: the kernel rounds each matmul input to bf16 and keeps f32
        # between stages; the reference is the plain version's f32 math on the
        # same bf16-valued inputs. Rounding flips near-tied argmaxes, and a
        # flipped level changes the input of every later level, so whole rows
        # drift apart (row agreement ~0.84 in a CPU emulation of the kernel's
        # rounding on these random weights); level 0 sees no cascade and is
        # the gated share, pooled over the ragged row counts.
        f32_err = 0
        pooled = []
        for Bx in (B, 1, 7, 65, 130):
            hx = hidden if Bx == B else torch.randn((Bx, cfg.dim), generator=g, device=dev)
            got = FL.fused_fast_micro_loop(p32, cfg, hx, None, greedy)
            ref = FL.fast_micro_loop_plain(p32, cfg, hx, None, greedy)
            err = int((got.long() - ref.long()).abs().max().item())
            f32_err = max(f32_err, err)
            log(f"[3 K1] f32 greedy B={Bx}: codes equal {bool((got == ref).all())} "
                f"(max code difference {err})")
            if Bx == B:
                continue
            hxb = hx.bfloat16()
            got = FL.fused_fast_micro_loop(params, cfg, hxb, None, greedy)
            ref = FL.fast_micro_loop_plain(p32, cfg, hxb.float(), None, greedy)
            pooled.append((got[:, 0] == ref[:, 0]).float())
        f32_err = max(f32_err, self._k1_70m(greedy))
        check(f32_err == 0, "K1 f32 greedy codes differ from the plain version")

        hb = hidden.bfloat16()
        got = FL.fused_fast_micro_loop(params, cfg, hb, None, greedy)
        ref = FL.fast_micro_loop_plain(p32, cfg, hb.float(), None, greedy)
        ref16 = FL.fast_micro_loop_plain(params, cfg, hb, None, greedy)
        rows = (got == ref).all(1).float().mean().item()
        codes = (got == ref).float().mean().item()
        lvl0 = (got[:, 0] == ref[:, 0]).float().mean().item()
        rows16 = (got == ref16).all(1).float().mean().item()
        ragged0 = torch.cat(pooled).mean().item()
        log(f"[3 K1] bf16 greedy vs plain f32 math: level-0 agreement {lvl0:.4f} at B=64, "
            f"{ragged0:.4f} pooled over B=1,7,65,130 ({sum(len(p) for p in pooled)} rows) "
            f"(gate {K1_BF16_LEVEL0_GATE}); B=64 row agreement {rows:.4f}, code agreement "
            f"{codes:.4f}; row agreement vs the plain bf16 path {rows16:.4f}")
        check(lvl0 >= K1_BF16_LEVEL0_GATE, f"K1 bf16 level-0 agreement {lvl0}")
        check(ragged0 >= K1_BF16_LEVEL0_GATE, f"K1 bf16 ragged level-0 agreement {ragged0}")

        # split-K is reduced in a fixed order: one seed, identical codes
        twice = [FL.fused_fast_micro_loop(params, cfg, hb, torch.Generator(device=dev).manual_seed(11),
                                          sampled) for _ in range(2)]
        same = bool((twice[0] == twice[1]).all())
        log(f"[3 K1] bf16 sampled B=64, two calls with one seed: codes identical {same}")
        check(same, "K1 codes differ between two calls with one seed")

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
        ms, own, per_call = k1_span(kernel, iters=20)
        summed, _, names = device_profile(kernel, iters=20)
        wall_ms = time_ms(kernel, iters=20)
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
        gemm_library_ms = self._k1_gemm_library_ms(cfg, params, B)
        log(f"[3 K1] B=64 bf16 sampled frame, device time per call: kernel {ms} ms (first start "
            f"to last end; its kernels' durations sum to {summed} ms as they overlap), plain "
            f"{plain_ms} ms, bound {bms} ms ({by}: {nbytes / 1e6:.1f} MB read once, "
            f"{flops / 1e9:.1f} GFLOP); kernel wall per call with host dispatch {wall_ms} ms; "
            f"device kernels per call {per_call} ({own} of K1's own); gemm_library_ms "
            f"{gemm_library_ms} (the frame's {n * (4 * L + 1)} products as cuBLAS bf16 matmuls)")
        for name, count in sorted(names.items(), key=lambda kv: -kv[1]):
            log(f"[3 K1]   x{count:<6g} {name[:100]}")
        check(own <= 192, f"K1 launches {own} device kernels per frame")
        self.record("fast_loop", source="smoltts_torch/csrc/fast_loop.cu",
                    replaces="smoltts_tpu/ops/fast_loop.py:105", max_abs_err=float(f32_err),
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)

    def _k1_70m(self, greedy) -> int:
        """The 70M preset's widths (D 576, 9/3 heads, F 1536): f32 greedy
        codes of the kernel against the plain loop at B=64; the largest code
        difference."""
        from smoltts_torch.config import smoltts_byte_70m
        from smoltts_torch.models.dual_ar import init_params
        from smoltts_torch.ops import fast_loop as FL
        from smoltts_torch.ops.quant import fuse_decode_params, quantize_decode_params

        torch, dev = self.torch, self.dev
        cfg = smoltts_byte_70m().replace(dropout=0.0, use_gradient_checkpointing=False)
        params = quantize_decode_params(fuse_decode_params(
            init_params(cfg, torch.Generator().manual_seed(1), dtype=torch.float32, device=dev)))
        hidden = torch.randn((64, cfg.dim), generator=torch.Generator(device=dev).manual_seed(13),
                             device=dev)
        got = FL.fused_fast_micro_loop(params, cfg, hidden, None, greedy)
        ref = FL.fast_micro_loop_plain(params, cfg, hidden, None, greedy)
        err = int((got.long() - ref.long()).abs().max().item())
        log(f"[3 K1] 70M f32 greedy B=64: codes equal {bool((got == ref).all())} "
            f"(max code difference {err})")
        return err

    def _k1_gemm_library_ms(self, cfg, params, B):
        """Device ms of one frame's K1 products (per level: per layer qkv, wo,
        w13 as one [D, 2F] product, w2; then the head slice) as cuBLAS bf16
        matmuls on dequantized weights. A yardstick for the hand GEMMs; the
        port never calls it."""
        from smoltts_torch.ops.quant import dequantize, qindex

        torch, dev = self.torch, self.dev
        lp = params["fast_layers"]
        L, n = cfg.n_fast_layer, cfg.max_fast_seqlen
        trunk = [[dequantize(qindex(lp[k], l)) for k in ("wqkv", "wo", "w13", "w2")] for l in range(L)]
        heads = [dequantize(qindex(params["fast_output"], i)) for i in range(n)]
        g = torch.Generator(device=dev).manual_seed(12)
        x = torch.randn((B, cfg.fast_dim), generator=g, device=dev).bfloat16()
        act = torch.randn((B, cfg.fast_intermediate_size), generator=g, device=dev).bfloat16()

        def frame():
            for i in range(n):
                for wqkv, wo, w13, w2 in trunk:
                    x @ wqkv, x @ wo, x @ w13, act @ w2
                x @ heads[i]

        return device_ms(frame, iters=10)

    def phase4_sampler(self):
        from smoltts_torch.config import smoltts_byte_150m
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.ops import sampling as SP
        from smoltts_torch.tokenizer import TokenConfig

        torch, dev = self.torch, self.dev
        cfg = smoltts_byte_150m()
        tok = TokenConfig.smoltts_v0(cfg.codebook_size)
        B, V, T, min_p = 64, cfg.vocab_size, 0.7, 0.05
        sampled = GenerationSettings(default_temp=T, min_p=min_p)
        greedy = GenerationSettings(default_temp=0.0)
        g = torch.Generator(device=dev).manual_seed(7)
        randn = lambda b, v: torch.randn((b, v), generator=g, device=dev) * 2.0
        base = randn(B, V)
        none = torch.zeros(B, dtype=torch.bool, device=dev)
        ids = torch.arange(V, device=dev)
        allowed = (ids == tok.im_end_id) | ((ids >= tok.semantic_start_id) & (ids <= tok.semantic_end_id))
        exact = 0
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            logits = base.to(dtype)
            x = logits.float()
            gen = torch.Generator(device=dev).manual_seed(8)
            # min_p = 1 keeps only the maxima of l / T (IEEE division): the id is one of them
            s = x / torch.tensor(0.8, device=dev)
            a = SP.sample_categorical(logits, gen, temperature=0.8, min_p=1.0).long()
            bad_minp = int((s.gather(1, a[:, None])[:, 0] != s.amax(1)).sum())
            hot = torch.full((B, V), -100.0, device=dev)
            hot_idx = torch.randint(0, V, (B,), generator=g, device=dev)
            hot[torch.arange(B, device=dev), hot_idx] = 100.0
            bad_hot = int((SP.sample_categorical(hot.to(dtype), gen, temperature=1.0).long()
                           != hot_idx).sum())
            # greedy with built ties: torch.argmax takes the first maximum, so must the kernel
            cols = torch.randint(0, V, (B, 3), generator=g, device=dev)
            tied = x.scatter(1, cols, (x.amax(1, keepdim=True) + 1.0).expand(B, 3)).to(dtype)
            want = torch.argmax(tied.float(), -1)
            bad_greedy = int((SP.sample_categorical(tied, None, temperature=0.0).long() != want).sum())
            bad_greedy += int((SP.sample_slow_token(tied, None, greedy, tok, none).long() != want).sum())
            # finished rows give im_end and leave the other rows' draws alone
            fin = torch.rand((B,), generator=g, device=dev) < 0.5
            g1, g2 = (torch.Generator(device=dev).manual_seed(9) for _ in range(2))
            with_fin = SP.sample_slow_token(logits, g1, sampled, tok, fin)
            without = SP.sample_slow_token(logits, g2, sampled, tok, none)
            bad_fin = int((with_fin[fin] != tok.im_end_id).sum()) + int((with_fin[~fin] != without[~fin]).sum())
            log(f"[4 K3] {name} exact cases, mismatches: min_p=1 {bad_minp}, one-hot {bad_hot}, greedy "
                f"with built ties vs torch.argmax {bad_greedy}, finished rows {bad_fin} "
                f"({int(fin.sum())} finished)")
            exact += bad_minp + bad_hot + bad_greedy + bad_fin
            # distributions over N draws of one row: the main settings against the masked
            # softmax; the audio window at T=1 without min-p (rows of stride 0) against the
            # softmax over the window, with no id outside it
            N, row = self.K3_DRAWS, logits[:1]
            draws = SP.sample_slow_token(row.expand(N, -1).contiguous(), gen, sampled, tok,
                                         torch.zeros(N, dtype=torch.bool, device=dev))
            self._k3_tv(f"{name} T={T} min-p {min_p}", draws, masked_softmax(
                row[0].double().cpu().numpy(), T, min_p), seed=9)
            window = GenerationSettings(default_temp=1.0, audio_only_constraint=True)
            draws = SP.sample_slow_token(row.expand(N, -1), gen, window, tok,
                                         torch.zeros(N, dtype=torch.bool, device=dev))
            outside = int((~allowed[draws.long()]).sum())
            log(f"[4 K3] {name} audio window: {outside} of {N} ids outside "
                f"{{{tok.im_end_id}}} U [{tok.semantic_start_id}, {tok.semantic_end_id}]")
            exact += outside
            lw = np.where(allowed.cpu().numpy(), row[0].double().cpu().numpy(), -np.inf)
            self._k3_tv(f"{name} audio window T=1", draws, masked_softmax(lw, 1.0, 1e-300), seed=10)
        check(exact == 0, f"K3 exact cases: {exact} mismatches")

        # the kernel against its method in plain PyTorch (sample_slow_token_emulated: the
        # same Philox noise), call for call; an id may differ only at a near tie
        fin = torch.rand((B,), generator=g, device=dev) < 0.25
        wide = randn(B, V + 1).bfloat16()
        cases = [
            ("main B=64 bf16", 100, lambda: randn(B, V).bfloat16(), sampled, fin),
            ("B=64 f32", 20, lambda: randn(B, V), sampled, fin),
            ("B=1 bf16", 20, lambda: randn(1, V).bfloat16(), sampled, none[:1]),
            ("no min-p bf16", 20, lambda: randn(B, V).bfloat16(), GenerationSettings(default_temp=T), fin),
            ("audio window bf16", 20, lambda: randn(B, V).bfloat16(),
             GenerationSettings(default_temp=T, min_p=min_p, audio_only_constraint=True), fin),
            ("ragged V=2365 bf16", 10, lambda: randn(B, 2365).bfloat16(), sampled, fin),
            ("ragged V=2365 f32", 10, lambda: randn(B, 2365), sampled, fin),
            ("unaligned rows bf16 (scalar path)", 10, lambda: wide.copy_(randn(B, V + 1))[:, 1:], sampled, fin),
            ("V=50000 bf16 (chunked path)", 10, lambda: randn(B, 50000).bfloat16(), sampled, fin),
            ("V=20000 f32 (chunked path)", 10, lambda: randn(B, 20000), sampled, fin),
        ]
        for i, (label, calls, make, settings, finished) in enumerate(cases):
            rows, diff, worst = self._k3_vs_emulation(make, settings, tok, finished, calls, seed=20 + i)
            log(f"[4 K3] kernel vs emulation, {label}: {diff} of {rows} ids differ over {calls} calls, "
                f"largest relative gap of their noisy scores {worst:.3e} (near-tie gate {K3_NEAR_TIE})")
            check(worst <= K3_NEAR_TIE, f"K3 vs emulation {label}: gap {worst}")

        rec = self._k3_times(cfg, tok, sampled, greedy, randn)
        self.record("sample_categorical", source="smoltts_torch/csrc/sampling.cu",
                    replaces="smoltts_tpu/ops/sampling.py:36", max_abs_err=float(exact), **rec)

    def _k3_tv(self, label, draws, p, seed):
        N = draws.numel()
        freq = np.bincount(draws.cpu().numpy(), minlength=p.size) / N
        tv = 0.5 * np.abs(freq - p).sum()
        gate = tv_gate(p, N, seed=seed)
        outside = float(freq[p == 0].sum())
        log(f"[4 K3] {label}: TV over {N} draws of one row {tv:.5f} (gate {gate:.5f} = 1.2 x the "
            f"99.9th percentile of exact-sampling TV; {int((p > 0).sum())} tokens kept), mass "
            f"outside them {outside:.2e}")
        check(tv <= gate and outside == 0.0, f"K3 distribution off: {label}")

    def _k3_vs_emulation(self, make, settings, tok, finished, calls, seed):
        """(rows, ids that differ, largest relative gap between the f64 noisy
        scores of the kernel's id and the emulation's) over `calls` calls;
        three generators in lockstep give the kernel, the emulation and the
        gap check the same seed pairs."""
        from smoltts_torch.ops import sampling as SP

        torch, dev = self.torch, self.dev
        gk, ge, gs = (torch.Generator(device=dev).manual_seed(seed) for _ in range(3))
        rows = diff = 0
        worst = 0.0
        for _ in range(calls):
            logits = make()
            a = SP.sample_slow_token(logits, gk, settings, tok, finished).long()
            b = SP.sample_slow_token_emulated(logits, ge, settings, tok, finished).long()
            sd = SP.philox_seed(gs, dev)
            rows += a.numel()
            bad = (a != b).nonzero()[:, 0]
            if bad.numel() == 0:
                continue
            diff += bad.numel()
            noise = SP.philox_gumbel_plain(sd[0], sd[1], *logits.shape).double()
            score = SP.slow_token_scores(logits, settings, tok).double() + noise
            va, vb = score[bad, a[bad]], score[bad, b[bad]]
            gap = (va - vb).abs() / torch.maximum(va.abs().maximum(vb.abs()), torch.ones_like(va))
            worst = max(worst, float(gap.nan_to_num(math.inf).max()))
        return rows, diff, worst

    def _k3_times(self, cfg, tok, sampled, greedy, randn):
        """K3's own device time per call (by kernel name) and the whole site's
        (device: all its kernels; wall: CUDA events, host dispatch included),
        at B = 1 and 64, f32 and bf16, beside a one-element kernel (the card's
        floor), the plain site, torch.multinomial and the bound; the record of
        the main path's shape (B=64, bf16, sampled)."""
        from smoltts_torch.lm.samplers import min_p_mask
        from smoltts_torch.ops import sampling as SP

        torch, dev = self.torch, self.dev
        V, T, min_p = cfg.vocab_size, sampled.default_temp, sampled.min_p
        one = torch.zeros(1, device=dev)
        floor_ms = device_ms(lambda: one.add_(1.0), iters=100)
        log(f"[4 K3] floor: a one-element elementwise kernel {floor_ms} ms device time per call")
        rec = None
        gen = torch.Generator(device=dev).manual_seed(30)
        for B, dtype, settings in ((64, torch.bfloat16, sampled), (64, torch.float32, sampled),
                                   (1, torch.bfloat16, sampled), (1, torch.float32, sampled),
                                   (64, torch.bfloat16, greedy)):
            logits = randn(B, V).to(dtype)
            fin = torch.zeros(B, dtype=torch.bool, device=dev)
            site = lambda: SP.sample_slow_token(logits, gen, settings, tok, fin)
            own, total, per_call = device_by_name(site, K3_KERNEL)
            wall = time_ms(site, iters=100)
            kind = "greedy" if settings is greedy else f"T={T} min-p {min_p}"
            log(f"[4 K3] B={B} V={V} {str(dtype)[6:]} {kind}, per call: K3 kernel {own} ms device; "
                f"site {total} ms device over {per_call:g} device kernels, {wall} ms wall with host "
                f"dispatch")
            check(per_call <= (1 if settings is greedy else 2), f"K3 site launches {per_call} kernels")
            if rec is not None:
                continue
            survivors = int((SP.slow_token_scores(logits, settings, tok) > -math.inf).sum())
            esz = logits.element_size()
            nbytes = B * V * esz + B + 16 + B * 4  # logits, finished, seed pair, ids
            bms, by = bound(nbytes, 3 * B * V + 60 * survivors, F32_FLOPS)
            plain_ms = device_ms(lambda: SP.sample_slow_token_plain(logits, gen, settings, tok, fin),
                                 iters=50)
            probs = torch.softmax(min_p_mask(logits.float() / T, min_p), -1)
            library_ms = device_ms(lambda: torch.multinomial(probs, 1, generator=gen), iters=100)
            log(f"[4 K3] B={B} bf16 main shape: bound {bms} ms ({by}: {nbytes} bytes read and "
                f"written once, {survivors} survivors of min-p); plain site {plain_ms} ms, "
                f"torch.multinomial {library_ms} ms; K3 {own / floor_ms:.2f}x the floor")
            check(own <= K3_MS_GATE, f"K3 {own} ms above {K3_MS_GATE} ms")
            rec = dict(ms=own, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)
        return rec

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
        self.stream_rate = float(np.median(rates))
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
            ev = [e for e in prof.key_averages() if _on_device(e)]
            dev_time = _self_device_ms
            busy = busy_us(trace_kernels(prof)) / 1e3
            top = sorted(ev, key=dev_time, reverse=True)[:8]
            log(f"[5 main] profiler, 5 stream steps: wall {wall:.2f} ms, device busy "
                f"{busy:.2f} ms ({busy / wall:.3f} busy share, {1 - busy / wall:.3f} idle; the "
                f"union of kernel intervals), {sum(e.count for e in ev)} kernel launches")
            # the top kernels, then K2 and K3 wherever they rank
            for e in top + [e for e in ev if e not in top and PORT_KERNELS.search(e.key)]:
                log(f"[5 main]   {dev_time(e):9.3f} ms  x{e.count:<5d} {e.key[:90]}")
        except Exception as e:  # the profiler is a diagnostic: its absence fails nothing
            log(f"[5 main] profiler: not measured ({e!r})")

    def phase6_greedy_e2e(self):
        from smoltts_torch import ops
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.ops import attention as A
        from smoltts_torch.ops import fast_loop as FL
        from smoltts_torch.ops import sampling as SP

        torch = self.torch
        cfg, _, mcfg, _ = self.lm()
        params, mimi = self._f32_trees()
        token_cfg, prompt, lens = self._prompts(cfg, 4, 64)
        greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
        n_frames = 16
        run = lambda: self._run_stream(cfg, params, mcfg, mimi, token_cfg, greedy, prompt, lens,
                                       n_frames, torch.float32, torch.float32)[2]
        ops.reset_launch_counts()
        kern = run()
        k3 = ops.LAUNCHES["sample_categorical"]
        with mock.patch.object(A, "decode_attention_tailed", A.decode_attention_tailed_plain), \
                mock.patch.object(A, "decode_attention", A.decode_attention_plain), \
                mock.patch.object(FL, "fused_fast_micro_loop", FL.fast_micro_loop_plain), \
                mock.patch.object(SP, "sample_slow_token", SP.sample_slow_token_plain):
            plain = run()
        codes_k = torch.stack([o.audio_codes for o in kern])
        codes_p = torch.stack([o.audio_codes for o in plain])
        # the slow token shows in is_audio and finished (and feeds the next frame)
        slow_k = torch.stack([torch.stack([o.is_audio, o.finished]) for o in kern])
        slow_p = torch.stack([torch.stack([o.is_audio, o.finished]) for o in plain])
        pcm_err = max((a.pcm - b.pcm).abs().max().item() for a, b in zip(kern, plain))
        equal = bool((codes_k == codes_p).all()) and bool((slow_k == slow_p).all())
        log(f"[6 greedy] B=4 f32 {n_frames} frames: codes, is_audio and finished equal {equal}, PCM max "
            f"abs diff {pcm_err:.3e} (gate 1e-3); K3 launches in the kernel run {k3}")
        check(equal and pcm_err <= 1e-3, "kernel path and plain path differ")
        check(k3 == n_frames, f"K3 launched {k3} times over {n_frames} greedy frames")

    # ---- phase 7: the library API -------------------------------------------

    def _write_checkpoint(self, d: Path, cfg):
        """The 150M bf16 checkpoint, its tokenizer and a full-size Mimi file in
        the HF key schema, all written by the port's own code; returns the
        trees as written."""
        from smoltts_torch.codec.config import MimiConfig
        from smoltts_torch.codec.mimi import init_mimi_params
        from smoltts_torch.io.checkpoint import save_params
        from smoltts_torch.io.safetensors import save_file
        from smoltts_torch.models.dual_ar import init_params
        from smoltts_torch.tokenizer import save_byte_level_tokenizer

        torch = self.torch
        t0 = time.perf_counter()
        dense = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                            device=self.dev)
        save_params(dense, cfg, d)
        save_byte_level_tokenizer(d, cfg.codebook_size)
        mcfg = MimiConfig()
        mimi = init_mimi_params(mcfg, seed=0, device="cpu")
        save_file(mimi_hf_state(mimi, mcfg), d / "mimi.safetensors")
        sizes = {p.name: p.stat().st_size for p in d.iterdir()}
        log(f"[7 api] wrote {sizes} in {time.perf_counter() - t0:.2f} s")
        return dense, mimi

    def phase7_library(self):
        from smoltts_torch import SmolTTS, ops
        from smoltts_torch.codec.mimi import load_mimi
        from smoltts_torch.config import DualARConfig
        from smoltts_torch.io.checkpoint import load_params
        from smoltts_torch.lm import generate as G
        from smoltts_torch.lm.samplers import GenerationSettings

        torch, dev = self.torch, self.dev
        t_phase = time.perf_counter()
        cfg = self.lm()[0]
        smi = nvidia_smi()
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(tmp)
            dense, mimi = self._write_checkpoint(d, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loaded = load_params(d, DualARConfig.from_json_file(d / "config.json"), device=dev)
            torch.cuda.synchronize()
            t_lm = time.perf_counter() - t0
            t0 = time.perf_counter()
            loaded_mimi, _ = load_mimi(d / "mimi.safetensors", device=dev)
            torch.cuda.synchronize()
            t_mimi = time.perf_counter() - t0
            check(trees_equal(loaded, dense), "the loaded LM tree differs from the written one")
            check(trees_equal(loaded_mimi, mimi), "the loaded Mimi tree differs from the written one")
            del loaded, loaded_mimi, dense
            log(f"[7 api] on {smi}: load_params 150M bf16 {t_lm * 1e3:.1f} ms, load_mimi f32 "
                f"{t_mimi * 1e3:.1f} ms; both trees equal the written ones bit for bit")

            sampled = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05,
                                         max_new_tokens=32, audio_only_constraint=True)
            t0 = time.perf_counter()
            tts = SmolTTS(d, generation_settings=sampled, quantize="int8+kv8", seed=1)
            torch.cuda.synchronize()
            log(f"[7 api] SmolTTS(dir, quantize='int8+kv8') ready in {time.perf_counter() - t0:.2f} s")
            self._api_sampled(tts, cfg, smi, G, ops)
            del tts
            self._api_greedy_f32(d, cfg, smi, G)
        self._chunk_step(cfg, smi)
        log(f"[7 api] phase 7 took {time.perf_counter() - t_phase:.1f} s on {smi}")

    def _api_sampled(self, tts, cfg, smi, G, ops):
        torch = self.torch
        hop = tts.codec_config.samples_per_frame
        frames = []
        real = G.generate_blocking

        def counting(*a, **k):
            out = real(*a, **k)
            frames.append(out[2].frames)
            return out

        tts("Warm up the kernels and the codec.")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(G, "generate_blocking", counting):
            pcm = tts("Hello there, this is the library speaking on the card.", voice="bella")
        t_call = time.perf_counter() - t0
        counts, n = dict(ops.LAUNCHES), frames[-1]
        check(pcm.ndim == 1 and pcm.size % hop == 0 and pcm.size > 0, f"__call__ PCM {pcm.shape}")
        check(bool(np.isfinite(pcm).all()), "__call__ PCM not finite")
        expect = {"fast_loop": n, "sample_categorical": n, "decode_attention": cfg.n_layer * (n - 1)}
        check(counts == expect, f"__call__ launches {counts}, expected {expect}")
        log(f"[7 api] __call__ on {smi}: {n} frames, {pcm.size // hop} audio frames, "
            f"{t_call * 1e3:.1f} ms wall (batch mimi_decode included), "
            f"{pcm.size / 24_000 / t_call} audio-s/s; launches {counts}")

        for _ in zip(range(4), tts.stream("Warm up the streaming path.")):
            pass
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunks, t_first = [], None
        for c in tts.stream("Streaming from the library, one frame at a time."):
            if t_first is None:
                t_first = time.perf_counter() - t0
            chunks.append(c)
        t_stream = time.perf_counter() - t0
        counts, n = dict(ops.LAUNCHES), len(chunks)
        check(all(c.shape == (hop,) and np.isfinite(c).all() for c in chunks), "stream chunks")
        expect = {"fast_loop": n, "sample_categorical": n, "decode_attention": cfg.n_layer * (n - 1)}
        check(counts == expect, f"stream launches {counts}, expected {expect}")
        log(f"[7 api] stream B=1 on {smi}: {n} chunks, first chunk {t_first * 1e3:.1f} ms, "
            f"{n * 0.08 / t_stream} audio-s/s ({t_stream:.3f} s wall); launches {counts}")

        audio = (np.random.default_rng(0).standard_normal(72_000) * 0.1).astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prompt = tts.create_speaker([{"text": "A reference sentence.", "audio": audio}],
                                    system_prompt="clone this voice")
        t_spk = time.perf_counter() - t0
        n_audio = int((prompt[0] >= tts.token_config.semantic_start_id).sum())
        check(prompt.ndim == 2 and prompt.shape[0] == cfg.num_rows, f"speaker prompt {prompt.shape}")
        check(n_audio == 38, f"{n_audio} audio columns for 37.5 frames of audio")
        check(int(prompt.min()) >= 0 and int(prompt[0].max()) < cfg.vocab_size
              and int(prompt[1:].max()) < cfg.codebook_size, "speaker codes out of range")
        tts.save_speaker("smoke", prompt)
        tts._speaker_cache.clear()
        check(np.array_equal(tts.get_speaker("smoke"), prompt), "save_speaker / get_speaker")
        log(f"[7 api] create_speaker on 3 s of audio (37.5 frames) on {smi}: prompt "
            f"{prompt.shape} in {t_spk * 1e3:.1f} ms; save_speaker/get_speaker round trip ok")

    def _api_greedy_f32(self, d, cfg, smi, G):
        from smoltts_torch import SmolTTS
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.ops import attention as A
        from smoltts_torch.ops import fast_loop as FL
        from smoltts_torch.ops import sampling as SP

        torch = self.torch
        greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0, max_new_tokens=16,
                                    audio_only_constraint=True)
        tts = SmolTTS(d, dtype=torch.float32, generation_settings=greedy, quantize="int8")
        text = "Greedy and plain, side by side."

        def run():
            prompt = tts._get_prompt(text, "heart")
            codes = G.generate_blocking(tts.params, tts.config, tts.token_config, greedy, [prompt],
                                        device=self.dev)[0]
            return codes, tts(text), list(tts.stream(text))

        kern = run()
        with mock.patch.object(A, "decode_attention_tailed", A.decode_attention_tailed_plain), \
                mock.patch.object(A, "decode_attention", A.decode_attention_plain), \
                mock.patch.object(FL, "fused_fast_micro_loop", FL.fast_micro_loop_plain), \
                mock.patch.object(SP, "sample_slow_token", SP.sample_slow_token_plain):
            plain = run()
        codes_equal = np.array_equal(kern[0], plain[0])
        if not codes_equal:
            diff = np.nonzero((kern[0] != plain[0]).any(axis=(0, 1)))[0]
            log(f"[7 api] greedy f32: codes differ from frame {int(diff[0])} on ({len(diff)} frames)")
        call_err = (float(np.abs(kern[1] - plain[1]).max()) if kern[1].shape == plain[1].shape
                    and kern[1].size else (0.0 if kern[1].shape == plain[1].shape else math.inf))
        stream_err = (max(float(np.abs(a - b).max()) for a, b in zip(kern[2], plain[2]))
                      if len(kern[2]) == len(plain[2]) else math.inf)
        log(f"[7 api] greedy f32 int8 (bf16 KV cache) on {smi}: generate_blocking codes "
            f"{kern[0].shape} equal {codes_equal}; __call__ PCM {kern[1].shape} max abs diff "
            f"{call_err:.3e}, stream {len(kern[2])} chunks max abs diff {stream_err:.3e} (gate 1e-3)")
        check(codes_equal and call_err <= 1e-3 and stream_err <= 1e-3,
              "greedy kernel path and plain path differ")

    def _chunk_step(self, cfg, smi):
        from smoltts_torch import ops
        from smoltts_torch.codec.mimi import decode_stream_init
        from smoltts_torch.lm.decode import init_decode_state
        from smoltts_torch.lm.pipeline import (
            flush_cadence, make_chunk_step, make_flush_step, make_prefill_step, make_stream_step,
        )
        from smoltts_torch.lm.samplers import GenerationSettings

        torch, dev = self.torch, self.dev
        _, params, mcfg, mimi = self.lm()
        K, B, bucket, chunks = 8, 64, 256, 8
        token_cfg, prompt, lens = self._prompts(cfg, B, 64)
        settings = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05)

        def run(params, mimi, settings, prompt, lens, kv_dtype, act_dtype, n_chunks):
            B = prompt.shape[0]
            state = init_decode_state(cfg, B, 1024, dtype=kv_dtype, tail_len=128, device=dev)
            ms = decode_stream_init(mcfg, B, dtype=act_dtype, tail_len=64, device=dev,
                                    kv_dtype=torch.int8 if kv_dtype == torch.int8 else None)
            prefill = make_prefill_step(cfg, token_cfg, settings, mcfg, device=dev)
            chunk = make_chunk_step(cfg, token_cfg, settings, mcfg, K, attend_limit=bucket,
                                    device=dev)
            flush = make_flush_step(device=dev)
            cadence = flush_cadence(state, ms)
            gen = torch.Generator(device=dev).manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, ms, gen, first = prefill(params, mimi, state, ms, torch.from_numpy(prompt).to(dev),
                                            torch.from_numpy(lens).to(dev), gen)
            outs, since, flushes = [], 0, 0
            for _ in range(n_chunks):
                if since + K > cadence:
                    state, ms = flush(state, ms)
                    since, flushes = 0, flushes + 1
                state, ms, gen, out = chunk(params, mimi, state, ms, gen)
                since += K
                outs.append(out)
            outs[-1].pcm.cpu()
            return time.perf_counter() - t0, first, outs, flushes

        run(params, mimi, settings, prompt, lens, torch.int8, torch.bfloat16, 1)  # warm-up
        rates = []
        for rep in range(REPEATS):
            ops.reset_launch_counts()
            wall, _, outs, flushes = run(params, mimi, settings, prompt, lens, torch.int8,
                                         torch.bfloat16, chunks)
            counts, n = dict(ops.LAUNCHES), 1 + K * chunks
            expect = {"fast_loop": n, "sample_categorical": n,
                      "decode_attention": cfg.n_layer * K * chunks}
            check(counts == expect, f"chunk-step launches {counts}, expected {expect}")
            for o in outs:
                check(tuple(o.pcm.shape) == (B, K * mcfg.samples_per_frame, 1), f"PCM {tuple(o.pcm.shape)}")
                check(bool(torch.isfinite(o.pcm).all()), "chunk-step PCM not finite")
                check(tuple(o.audio_codes.shape) == (B, cfg.num_codebooks, K), "chunk codes shape")
            rates.append(B * n * 0.08 / wall)
            log(f"[7 chunk] repeat {rep}: 150M int8+kv8 B={B} chunk {K} bucket {bucket}, {n} frames "
                f"({flushes} flushes) on {smi}: {rates[-1]} audio-s/s (wall {wall} s); launches {counts}")
        stream = "not measured (phase 5 not run)" if self.stream_rate is None else self.stream_rate
        log(f"[7 chunk] median of {REPEATS} on {smi}: chunk step {float(np.median(rates))} audio-s/s; "
            f"phase 5 stream step in this run: {stream} audio-s/s")

        # greedy f32 at B=4: one chunk of K frames == K stream steps (no flush in 16 frames)
        p32, m32 = self._f32_trees()
        greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
        tok4, prompt4, lens4 = self._prompts(cfg, 4, 64)
        _, first, outs, _ = run(p32, m32, greedy, prompt4, lens4, torch.float32, torch.float32, 2)
        chunk_codes = torch.cat([o.audio_codes for o in outs], dim=-1)
        _, _, souts, _ = self._run_stream(cfg, p32, mcfg, m32, tok4, greedy, prompt4, lens4,
                                          1 + 2 * K, torch.float32, torch.float32)
        stream_codes = torch.stack([o.audio_codes for o in souts[1:]], dim=-1)
        equal = bool((chunk_codes == stream_codes).all()) and bool(
            (first.audio_codes == souts[0].audio_codes).all())
        pcm_err = (torch.cat([o.pcm for o in outs], 1) - torch.cat([o.pcm for o in souts[1:]], 1)
                   ).abs().max().item()
        log(f"[7 chunk] greedy f32 B=4, 2 chunks of {K}: chunk-step codes == stream-step codes "
            f"{equal}, PCM max abs diff {pcm_err:.3e}")
        check(equal, "chunk-step codes differ from stream-step codes")

    # ---- phase 8: the continuous-batching engine ---------------------------

    def phase8_engine(self):
        t0 = time.perf_counter()
        smi = nvidia_smi()
        self._engine_parity(smi)
        self._engine_served(smi)
        log(f"[8 engine] phase 8 took {time.perf_counter() - t0:.1f} s on {smi}")

    def _engine_parity(self, smi):
        """Greedy f32 (int8 weights, kernel path), B=8 slots, S=1024, Mimi
        attached, 12 prompts submitted in three waves with budgets of 8-24
        frames: each stream's codes equal the same prompt run alone through
        make_prefill_step + make_stream_step at B=1, its PCM within 1e-3;
        chunked dispatch (8) gives the same codes; int16 and ulaw frames equal
        the host encoders applied to the f32 frames of the same schedule."""
        from smoltts_torch.codec.mimi import decode_stream_init
        from smoltts_torch.io.g711 import ulaw_encode_np
        from smoltts_torch.lm.decode import init_decode_state
        from smoltts_torch.lm.engine import DecodeEngine
        from smoltts_torch.lm.generate import pad_prompts
        from smoltts_torch.lm.pipeline import (
            flush_cadence, make_flush_step, make_prefill_step, make_stream_step,
        )
        from smoltts_torch.lm.samplers import GenerationSettings

        torch, dev = self.torch, self.dev
        cfg, _, mcfg, _ = self.lm()
        params, mimi = self._f32_trees()
        greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0)
        token_cfg, padded, lens = self._prompts(cfg, 12, 64)
        prompts = [padded[i, :, : lens[i]] for i in range(12)]
        budgets = [int(b) for b in np.random.default_rng(8).integers(8, 25, 12)]
        S, bucket = 1024, 256
        waves = {0: range(0, 6), 4: range(6, 9), 10: range(9, 12)}  # step -> prompts
        t0 = time.perf_counter()

        def single(p, n):
            state = init_decode_state(cfg, 1, S, dtype=torch.float32, device=dev)
            ms = decode_stream_init(mcfg, 1, dtype=torch.float32, device=dev)
            prefill = make_prefill_step(cfg, token_cfg, greedy, mcfg, device=dev)
            step = make_stream_step(cfg, token_cfg, greedy, mcfg, attend_limit=bucket, device=dev)
            flush, cadence = make_flush_step(device=dev), flush_cadence(state, ms)
            pp, ll = pad_prompts([p], pad_to_multiple=64)
            state, ms, _, o = prefill(params, mimi, state, ms, torch.from_numpy(pp).to(dev),
                                      torch.from_numpy(ll).to(dev), None)
            outs, since = [o], 0
            for _ in range(n - 1):
                if since >= cadence:
                    (state, ms), since = flush(state, ms), 0
                state, ms, _, o = step(params, mimi, state, ms, None)
                since += 1
                outs.append(o)
            return (torch.stack([o.audio_codes[0] for o in outs]).cpu().numpy(),
                    torch.stack([o.pcm[0, :, 0] for o in outs]).cpu().numpy())

        refs = [single(p, n) for p, n in zip(prompts, budgets)]
        t_single = time.perf_counter() - t0

        def engine_run(chunk, emit):
            eng = DecodeEngine(params, cfg, token_cfg, greedy, num_slots=8, max_seq_len=S,
                               kv_dtype=torch.float32, prompt_bucket=64, mimi_params=mimi,
                               mimi_cfg=mcfg, attend_buckets=[bucket], chunk_frames=chunk,
                               emit_format=emit, device=dev)
            eng.warm()
            sid_of, got = {}, {}
            for step in range(1000):
                for i in waves.get(step, ()):
                    sid_of[i] = eng.submit(prompts[i], max_frames=budgets[i])
                    got[sid_of[i]] = []
                for sid, frame in eng.step():
                    got[sid].append(frame)
                if step > max(waves) and not eng.has_work():
                    break
            check(not eng.has_work(), "engine did not drain")
            return [got[sid_of[i]] for i in range(12)], eng.stats

        torch.backends.cudnn.deterministic = True  # int16/ulaw frames vs the f32 run's
        try:
            runs = {key: engine_run(*key) for key in ((1, "f32"), (8, "f32"), (1, "int16"), (1, "ulaw"))}
        finally:
            torch.backends.cudnn.deterministic = False
        base = runs[(1, "f32")][0]
        bad, pcm_err = [], 0.0
        for key in ((1, "f32"), (8, "f32")):
            for i, (frames, (rc, rp)) in enumerate(zip(runs[key][0], refs)):
                codes = np.stack([f["audio_codes"] for f in frames]) if frames else None
                if codes is None or codes.shape != rc.shape or not np.array_equal(codes, rc):
                    bad.append((key, i))
                    continue
                pcm = np.stack([f["pcm"] for f in frames])
                pcm_err = max(pcm_err, float(np.abs(pcm - rp).max()))
        enc_bad = 0
        for i, frames in enumerate(base):
            for f32f, i16, ul in zip(frames, runs[(1, "int16")][0][i], runs[(1, "ulaw")][0][i]):
                a = f32f["pcm"]
                enc_bad += int(not np.array_equal(i16["pcm"], (np.clip(a, -1, 1) * 32767.0).astype(np.int16)))
                enc_bad += int(not np.array_equal(ul["pcm"], ulaw_encode_np(
                    np.round(np.clip(a.astype(np.float64), -1, 1) * 32767).astype(np.int16))))
        log(f"[8 engine] parity on {smi}: 150M f32 int8 greedy, 8 slots S={S} bucket {bucket}, 12 "
            f"prompts in 3 waves, budgets {budgets}: streams whose codes differ from the B=1 "
            f"single-stream pipeline {bad} (chunk 1 and chunk 8), PCM max abs diff {pcm_err:.3e} "
            f"(gate 1e-3); int16/ulaw frames differing from the host encoders of the f32 frames: "
            f"{enc_bad}; stats chunk 1 {runs[(1, 'f32')][1]}, chunk 8 {runs[(8, 'f32')][1]}; "
            f"{time.perf_counter() - t0:.1f} s ({t_single:.1f} s of it the references)")
        check(not bad and pcm_err <= 1e-3 and enc_bad == 0, "engine differs from the single stream")

    def _engine_served(self, smi):
        """bench.py::run_served's operating point on the port: 150M int8+kv8,
        temp 0.7 / 0.7 / min-p 0.05, 64 slots, S=1024, prompt bucket 64,
        inflight 1, fetch_every 1, chunk 8, admit sizes [1, 4], bucket 256,
        int16 frames, EngineLoop(max_ahead=2, fetchers=3); closed loop with 64
        streams in flight and 128 in all, budgets uniform in [60, 180] frames
        from default_rng(7); a shakedown of 8 / 16 / 24 first, then 2 reps.
        Launch counts per dispatched frame are read around each rep."""
        import queue as _queue
        import threading

        from smoltts_torch import ops
        from smoltts_torch.lm.engine import DecodeEngine, EngineLoop
        from smoltts_torch.lm.samplers import GenerationSettings

        torch, dev = self.torch, self.dev
        cfg, params, mcfg, mimi = self.lm()
        token_cfg, prompt, lens = self._prompts(cfg, 1, 64)
        prompt_np = prompt[0, :, : lens[0]]
        settings = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05)
        B, frames_per_stream = 64, 120
        t0 = time.perf_counter()
        eng = DecodeEngine(params, cfg, token_cfg, settings, num_slots=B, max_seq_len=1024,
                           kv_dtype=torch.int8, prompt_bucket=64, mimi_params=mimi, mimi_cfg=mcfg,
                           inflight=1, fetch_every=1, emit_format="int16", chunk_frames=8,
                           admit_sizes=[1, 4], attend_buckets=[256],
                           generator=torch.Generator(device=dev).manual_seed(7), device=dev)
        eng.warm()
        t_warm = time.perf_counter() - t0
        loop = EngineLoop(eng, max_ahead=2, fetchers=3)

        def pct(vals, p):
            vals = sorted(vals)
            return vals[min(len(vals) - 1, int(p * len(vals)))]

        def run_served(n_streams, total, frames):
            lock = threading.Lock()
            lats, done, failures = [], [0, 0, 0], []  # frames, launched, completed
            all_done = threading.Event()
            len_rng = np.random.default_rng(7)

            def consume(q, t_submit, steady):
                n, first, timing = 0, None, None
                while True:
                    try:
                        frame = q.get(timeout=60)
                    except _queue.Empty:
                        failures.append(f"stream {q.sid}: no frame for 60 s after {n}")
                        all_done.set()
                        return
                    if frame is None:
                        break
                    if first is None and "pcm" in frame:
                        first = time.perf_counter() - t_submit
                        timing = eng.pop_timing(q.sid)
                    if frame["pcm"].dtype != np.int16 or frame["pcm"].shape != (mcfg.samples_per_frame,):
                        failures.append(f"stream {q.sid}: pcm {frame['pcm'].dtype} {frame['pcm'].shape}")
                    n += 1
                launch_next = False
                with lock:
                    done[0] += n
                    if first is not None:
                        lats.append((steady, first * 1e3, timing))
                    done[2] += 1
                    if done[1] < total:
                        done[1] += 1
                        launch_next = True
                    elif done[2] >= total:
                        all_done.set()
                if launch_next:
                    start_one(True)

            def start_one(steady):
                budget = int(len_rng.integers(frames // 2, frames * 3 // 2 + 1))
                t_submit = time.perf_counter()
                q = loop.submit(prompt_np, max_frames=budget)
                threading.Thread(target=consume, args=(q, t_submit, steady), daemon=True).start()

            t_start = time.perf_counter()
            with lock:
                done[1] = n_streams
            for _ in range(n_streams):
                start_one(False)
            check(all_done.wait(timeout=300), f"served run wedged: {done}, queue {len(eng._queue)}")
            check(not failures, f"served run: {failures[:3]}")
            elapsed = time.perf_counter() - t_start
            all_ms = [ms for _, ms, _ in lats]
            steady_ms = [ms for s, ms, _ in lats if s] or all_ms
            timings = [t for s, _, t in lats if s and t] or [t for _, _, t in lats if t]
            breakdown = {ph: {"p50": pct([t[ph] * 1e3 for t in timings], 0.5),
                              "p95": pct([t[ph] * 1e3 for t in timings], 0.95)}
                         for ph in ("queue_wait", "dispatch_wait", "fetch", "deliver", "total")}
            return (done[0] * 0.08 / elapsed, pct(all_ms, 0.5), pct(all_ms, 0.95),
                    pct(steady_ms, 0.5), breakdown, done[0], elapsed)

        try:
            run_served(8, 16, 24)  # shakedown
            eng.drain_timings()
            for rep in range(2):
                with loop._lock:
                    ops.reset_launch_counts()
                    before = dict(eng.stats)
                out = run_served(B, 2 * B, frames_per_stream)
                with loop._lock:
                    counts = dict(ops.LAUNCHES)
                    steps = eng.stats["frame_steps"] - before["frame_steps"]
                    admits = eng.stats["admissions"] - before["admissions"]
                    dispatches = eng.stats["dispatches"] - before["dispatches"]
                rate, p50, p95, steady, bd, frames, elapsed = out
                self.served_rates.append(rate)
                per = {k: round(v / steps, 4) for k, v in counts.items()}
                log(f"[8 served] rep {rep} on {smi}: {rate} audio-s/s ({frames} frames in "
                    f"{elapsed:.2f} s), first audio p50 {p50:.1f} ms, p95 {p95:.1f} ms, steady p50 "
                    f"{steady:.1f} ms; pop_timing ms {json.dumps(bd)}; {dispatches} dispatches, "
                    f"{steps} frame steps, {admits} admissions; launches {counts}, per frame step {per}")
                expect = {"fast_loop": steps + admits, "sample_categorical": steps + admits,
                          "decode_attention": cfg.n_layer * steps}
                check(counts == expect, f"served launches {counts}, expected {expect}")
        finally:
            loop.stop()
        log(f"[8 served] warm {t_warm:.1f} s; served segment {time.perf_counter() - t0:.1f} s")

    # ---- phase 9: the HTTP server ------------------------------------------

    def phase9_server(self):
        t0 = time.perf_counter()
        smi = nvidia_smi()
        cfg = self.lm()[0]
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(tmp)
            self._write_checkpoint(d, cfg)
            self._server_parity(d, smi)
            self._server_main(d, smi)
            self._server_load(d, smi)
        log(f"[9 server] phase 9 took {time.perf_counter() - t0:.1f} s on {smi}")

    def _server_single(self, core, engine, prompt, n_frames, flush_before):
        """A prompt alone at B=1 through make_prefill_step + make_stream_step,
        with the engine's KV and vocoder-state dtype, prompt bucket and attend
        limit, and its schedule: the admission's ring flush after the first
        frame (`scatter_stream_state`), and an engine flush before each frame
        in `flush_before`. Returns (codes [n, 8], int16 PCM)."""
        from smoltts_torch.codec.mimi import decode_stream_init
        from smoltts_torch.codec.transformer import flush_transformer_ring
        from smoltts_torch.io.wav import pcm_to_int16
        from smoltts_torch.lm.decode import init_decode_state
        from smoltts_torch.lm.generate import pad_prompts
        from smoltts_torch.lm.pipeline import make_flush_step, make_prefill_step, make_stream_step

        torch, dev, m = self.torch, self.dev, core.model
        args = (m.config, m.token_config, m.generation_settings, m.codec_config)
        state = init_decode_state(m.config, 1, engine.S, dtype=engine.kv_dtype, device=dev)
        ms = decode_stream_init(m.codec_config, 1, dtype=engine.kv_dtype, device=dev)
        padded, lens = pad_prompts([prompt], pad_to_multiple=engine.prompt_bucket)
        state, ms, _, out = make_prefill_step(*args, device=dev)(
            m.params, m.codec_params, state, ms, torch.from_numpy(padded).to(dev),
            torch.from_numpy(lens).to(dev), None)
        ms = ms._replace(transformer=flush_transformer_ring(ms.transformer))
        step = make_stream_step(*args, attend_limit=engine.attend_buckets[0], device=dev)
        flush = make_flush_step(device=dev)
        outs = [out]
        for f in range(1, n_frames):
            if f in flush_before:
                state, ms = flush(state, ms)
            state, ms, _, out = step(m.params, m.codec_params, state, ms, None)
            outs.append(out)
        codes = torch.stack([o.audio_codes[0] for o in outs]).cpu().numpy()
        pcm = torch.cat([o.pcm[0, :, 0] for o in outs]).float().cpu().numpy()
        return codes, pcm_to_int16(pcm)

    def _server_parity(self, d: Path, smi):
        """(i) Greedy f32 int8 with build_engine_loop(core, 8): every route,
        four ElevenLabs formats, then 4 /stream and 2 blocking requests at
        once, each held against its reference."""
        from smoltts_torch import SmolTTS
        from smoltts_torch.io.mp3 import lame_available
        from smoltts_torch.io.wav import pcm_to_int16
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.server.app import build_app, build_engine_loop
        from smoltts_torch.server.tts_core import TTSCore

        torch = self.torch
        greedy = GenerationSettings(default_temp=0.0, default_fast_temp=0.0, max_new_tokens=24,
                                    audio_only_constraint=True)
        torch.backends.cudnn.deterministic = True  # blocking bodies vs a later direct call
        try:
            core = TTSCore(SmolTTS(d, dtype=torch.float32, quantize="int8", generation_settings=greedy))
            hop = core.model.codec_config.samples_per_frame
            t0 = time.perf_counter()
            loop = build_engine_loop(core, 8)
            t_warm = time.perf_counter() - t0
            rec = tap_loop(loop)
            app = build_app(core, engine_loop=loop)
            port, th = serve_app(app)
            try:
                routes = self._server_routes(port, hop)
                t0 = time.perf_counter()
                jobs = {("stream", t): (lambda t=t: request(
                    port, "POST", "/v1/text-to-speech/bella/stream", {"text": t})) for t in SERVER_TEXTS}
                for t in SERVER_TEXTS[:2]:
                    jobs[("pcm", t)] = lambda t=t: request(
                        port, "POST", "/v1/text-to-speech/bella?output_format=pcm_24000", {"text": t})
                results = run_threads(jobs)
                t_concurrent = time.perf_counter() - t0
            finally:
                stop_app(app, th)
                loop.stop()
            blocking_equal, lsb, snrs, bad = [], 0, [], []
            for (kind, text), (status, headers, body) in results.items():
                check(status == 200, f"{kind} {text!r}: HTTP {status}")
                check(len(body) > 0 and len(body) % (2 * hop) == 0, f"{kind}: {len(body)} bytes")
                if kind == "pcm":
                    blocking_equal.append(body == pcm_to_int16(core.model(text, "bella")).tobytes())
                    continue
                prompt = core.model._get_prompt(text, "bella")
                sid = next(s for s, p in rec.prompts.items() if np.array_equal(p, prompt))
                frames = rec.frames[sid]
                if body != b"".join(f["pcm"].tobytes() for f in frames):
                    bad.append(f"{text!r}: body is not the engine's frames")
                codes, want = self._server_single(core, loop.engine, prompt, len(frames),
                                                  rec.flushes.get(sid, ()))
                if not np.array_equal(np.stack([f["audio_codes"] for f in frames]), codes):
                    bad.append(f"{text!r}: codes differ from the B=1 single stream")
                got = np.frombuffer(body, np.int16).astype(np.float64)
                err = got - want
                lsb = max(lsb, int(np.abs(err).max()))
                snrs.append(round(float(10 * np.log10((want.astype(np.float64) ** 2).sum()
                                                      / max((err ** 2).sum(), 1.0))), 2))
            flushes = {s: f for s, f in rec.flushes.items() if f}
        finally:
            torch.backends.cudnn.deterministic = False
        log(f"[9 server] (i) on {smi}: greedy f32 int8, build_engine_loop(core, 8) warm "
            f"{t_warm:.1f} s; routes {routes}; 4 /stream + 2 blocking pcm_24000 at once in "
            f"{t_concurrent:.2f} s: stream bodies vs the B=1 single stream max {lsb} LSB, SNR dB "
            f"{snrs} (gate {STREAM_SNR_GATE}); failures {bad}; "
            f"engine flushes inside a stream {flushes}; blocking bodies == "
            f"pcm_to_int16(model(text)): {blocking_equal}; MP3 served by "
            f"{'LAME (Layer III)' if lame_available() else 'the Layer II encoder'}")
        check(not bad and len(snrs) == 4 and min(snrs) >= STREAM_SNR_GATE,
              "stream bodies differ from the single stream")
        check(len(blocking_equal) == 2 and all(blocking_equal), "blocking bodies differ")

    def _server_routes(self, port, hop) -> dict:
        """Every route once; returns {route: (status, bytes)} for the log."""
        from smoltts_torch.io.mp3 import lame_available, mpeg_header_info

        out = {}
        status, _, body = request(port, "GET", "/health")
        check(status == 200 and json.loads(body)["sampling_rate"] == 24_000, f"/health {status}")
        out["/health"] = (status, len(body))
        status, _, body = request(port, "GET", "/")
        check(status == 200 and b"smoltts" in body, f"/ {status}")
        out["/"] = (status, len(body))
        status, _, body = request(port, "GET", "/metrics")
        check(status == 200 and "requests" in json.loads(body), f"/metrics {status}")
        out["/metrics"] = (status, len(body))
        status, headers, body = request(port, "POST", "/v1/audio/speech",
                                        {"input": SERVER_TEXTS[0], "voice": "bella"})
        check(status == 200 and headers["content-type"] == "audio/wav" and body[:4] == b"RIFF"
              and len(body) > 44 and (len(body) - 44) % (2 * hop) == 0, f"/v1/audio/speech {status}")
        out["/v1/audio/speech"] = (status, len(body))
        n = None
        for fmt, media in (("pcm_24000", "audio/x-pcm"), ("wav_16000", "audio/wav"),
                           ("ulaw_8000", "audio/basic"), ("mp3_44100_128", "audio/mpeg")):
            status, headers, body = request(port, "POST", f"/v1/text-to-speech/bella?output_format={fmt}",
                                            {"text": SERVER_TEXTS[1]})
            rate = int(fmt.split("_")[1])
            ok = (status == 200 and headers["content-type"] == media
                  and headers["x-sample-rate"] == str(rate))
            if fmt == "pcm_24000":
                n = len(body) // 2
                ok = ok and n > 0 and n % hop == 0
            elif fmt == "wav_16000":
                ok = ok and len(body) == 44 + 2 * int(n * rate / 24_000)
            elif fmt == "ulaw_8000":
                ok = ok and len(body) == int(n * rate / 24_000)
            else:
                layer = mpeg_header_info(body)["layer"]
                ok = ok and layer == (3 if lame_available() else 2)
            check(ok, f"ElevenLabs {fmt}: HTTP {status}, {headers}, {len(body)} bytes")
            out[fmt] = (status, len(body))
        return out

    def _server_main(self, d: Path, smi):
        """The server as `python -m smoltts_torch.server.app` starts it: a
        settings JSON naming the checkpoint, load_core, per-request mode."""
        cfg_path = d / "server.json"
        cfg_path.write_text(json.dumps({"checkpoint_dir": str(d), "generation": {
            "default_temp": 0.0, "default_fast_temp": 0.0, "max_new_tokens": 8}}))
        port = free_port()
        t0 = time.perf_counter()
        with open(d / "server.log", "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "smoltts_torch.server.app", "--config", str(cfg_path),
                 "--host", "127.0.0.1", "--port", str(port)],
                cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT)
            try:
                deadline = time.time() + 240
                while not port_open(port):
                    check(proc.poll() is None and time.time() < deadline,
                          f"the server process did not come up (exit {proc.poll()})")
                    time.sleep(0.2)
                t_up = time.perf_counter() - t0
                status, _, body = request(port, "GET", "/health")
                check(status == 200 and json.loads(body)["sampling_rate"] == 24_000, f"/health {status}")
                status, _, pcm = request(port, "POST", "/v1/text-to-speech/0?output_format=pcm_24000",
                                         {"text": "Hello from main."})
                check(status == 200 and len(pcm) % (2 * 1920) == 0, f"blocking {status} {len(pcm)}")
            finally:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=30)
        log(f"[9 server] main on {smi}: `python -m smoltts_torch.server.app --config` answered "
            f"/health {t_up:.1f} s after start; a blocking pcm_24000 request gave {len(pcm)} bytes; "
            f"server log: {(d / 'server.log').read_text().strip().splitlines()[:2]}")

    def _server_load(self, d: Path, smi):
        """(ii) int8+kv8 sampled (0.7 / 0.7 / min-p 0.05, 96 frames), the
        server's engine at 64 slots: closed loops of 64 HTTP /stream clients,
        128 requests each, after a shakedown of 8 clients / 16 requests;
        first alone (with a 2 s profiler window from its 16th frame step:
        the card's idle share), then with 4 blocking /v1/audio/speech requests starting one
        second in. Launches are read around each run: the blocking requests'
        own frames are what K1 counts beyond the engine's."""
        import http.client
        import threading

        from torch.profiler import ProfilerActivity, profile

        from smoltts_torch import SmolTTS, VOICES, ops
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.server.app import build_app, build_engine_loop
        from smoltts_torch.server.tts_core import TTSCore

        sampled = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05,
                                     max_new_tokens=96, audio_only_constraint=True)
        core = TTSCore(SmolTTS(d, quantize="int8+kv8", generation_settings=sampled, seed=9))
        hop = core.model.codec_config.samples_per_frame
        n_layer = core.model.config.n_layer
        t0 = time.perf_counter()
        loop = build_engine_loop(core, 64)
        t_warm = time.perf_counter() - t0
        eng = loop.engine
        app = build_app(core, engine_loop=loop)
        port, th = serve_app(app)

        def pct(vals, p):
            vals = sorted(vals)
            return vals[min(len(vals) - 1, int(p * len(vals)))]

        def idle_window(at_step):
            """The card's idle share over a 2 s profiler window opened once the
            engine has made `at_step` frame steps: inside the first wave of
            streams whatever the host's speed (a window opened at a fixed time
            can fall between waves). A window that sees no kernel while the
            engine made frame steps is logged with its trace's categories and
            taken again, at most three times in all."""
            deadline = time.perf_counter() + 120.0
            while eng.stats["frame_steps"] < at_step:
                check(time.perf_counter() < deadline,
                      f"the served run made no {at_step}th frame step in 120 s")
                time.sleep(0.02)
            for attempt in range(3):
                s0 = eng.stats["frame_steps"]
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    time.sleep(2.0)
                    window = time.perf_counter() - t
                steps = eng.stats["frame_steps"] - s0
                kernels = trace_kernels(prof)
                if kernels:
                    break
                log(f"[9 server] (ii) profiler window {attempt + 1} from frame step {s0} saw no "
                    f"kernel while the engine made {steps} frame steps; trace categories "
                    f"{trace_categories(prof)}")
            check(kernels, "the profiler window over the served run saw no kernel in 3 windows")
            idle = round(1.0 - busy_us(kernels) / (window * 1e6), 4)
            log(f"[9 server] (ii) profiler window {attempt + 1} from frame step {s0}: {window:.3f} s, "
                f"{steps} frame steps, {len(kernels)} kernels, device idle share {idle}")
            return idle

        def closed(clients, total, blocking=0, profile_after=None):
            lock = threading.Lock()
            issued, firsts, nbytes, failures, walls = [0], [], [0], [], []

            def client():
                while True:
                    with lock:
                        if issued[0] >= total:
                            return
                        i = issued[0]
                        issued[0] += 1
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                    t = time.perf_counter()
                    conn.request("POST", f"/v1/text-to-speech/{VOICES[i % len(VOICES)]}/stream",
                                 json.dumps({"text": SERVER_TEXTS[i % len(SERVER_TEXTS)]}),
                                 {"Content-Type": "application/json"})
                    r = conn.getresponse()
                    head = r.read(2)  # returns once the first chunk is in
                    first = time.perf_counter() - t
                    body = head + r.read()
                    conn.close()
                    with lock:
                        firsts.append((i >= clients, first * 1e3))
                        nbytes[0] += len(body)
                        if r.status != 200 or not body or len(body) % (2 * hop):
                            failures.append(f"stream {i}: HTTP {r.status}, {len(body)} bytes")

            def speech(j):
                time.sleep(1.0)
                t = time.perf_counter()
                status, headers, body = request(port, "POST", "/v1/audio/speech",
                                                {"input": SERVER_TEXTS[j], "voice": VOICES[j]})
                with lock:
                    walls.append(round(time.perf_counter() - t, 2))
                    if (status != 200 or body[:4] != b"RIFF" or len(body) <= 44
                            or (len(body) - 44) % (2 * hop)):
                        failures.append(f"speech {j}: HTTP {status}, {len(body)} bytes")

            with loop._lock:
                ops.reset_launch_counts()
                before = dict(eng.stats)
            threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
            threads += [threading.Thread(target=speech, args=(j,), daemon=True) for j in range(blocking)]
            t_start = time.perf_counter()
            for t in threads:
                t.start()
            idle = "not measured"
            if profile_after is not None:
                idle = idle_window(before["frame_steps"] + profile_after)
            for t in threads:
                t.join(timeout=600)
            elapsed = time.perf_counter() - t_start
            check(not any(t.is_alive() for t in threads), f"served run wedged: {issued}")
            check(not failures, f"served run: {failures[:3]}")
            with loop._lock:
                counts = dict(ops.LAUNCHES)
                steps = eng.stats["frame_steps"] - before["frame_steps"]
                admits = eng.stats["admissions"] - before["admissions"]
            all_ms = [ms for _, ms in firsts]
            steady = [ms for s, ms in firsts if s] or all_ms
            # K1 and K3 run once per frame step and admission, and once per
            # frame of a blocking request; K2 once per layer of each frame
            # step and of each blocking frame after the first.
            extra = counts["fast_loop"] - steps - admits
            expect = {"fast_loop": steps + admits + extra, "sample_categorical": steps + admits + extra,
                      "decode_attention": n_layer * (steps + extra - blocking)}
            log(f"[9 server] (ii) on {smi}: {clients} HTTP /stream clients, {total} requests"
                f"{f' + {blocking} blocking' if blocking else ''}: {nbytes[0] / 2 / 24_000 / elapsed} "
                f"audio-s/s at the socket ({nbytes[0]} bytes in {elapsed:.2f} s); client first chunk "
                f"p50 {pct(all_ms, 0.5):.1f} ms, p95 {pct(all_ms, 0.95):.1f} ms (steady p50 "
                f"{pct(steady, 0.5):.1f}, p95 {pct(steady, 0.95):.1f}); blocking wall s {walls}; "
                f"{steps} frame steps, {admits} admissions, {extra} blocking frames; launches "
                f"{counts}, engine's per frame step "
                f"{round((steps + admits) / max(steps, 1), 4)} (K1, K3) and "
                f"{round(n_layer * steps / max(steps, 1), 4)} (K2); device idle share {idle}")
            check(steps > 0 and (0 < extra <= 96 * blocking if blocking else extra == 0)
                  and counts == expect,
                  f"served launches {counts}, expected {expect} with {extra} blocking frames")

        try:
            closed(8, 16)  # shakedown
            closed(64, 128, profile_after=16)
            closed(64, 128, blocking=4)
            status, _, body = request(port, "GET", "/metrics")
            metrics = json.loads(body)
        finally:
            stop_app(app, th)
            loop.stop()
        direct = [round(r, 2) for r in self.served_rates] or "not measured (phase 8 not run)"
        log(f"[9 server] (ii) int8+kv8 sampled, build_engine_loop(core, 64) warm {t_warm:.1f} s; "
            f"/metrics after both runs {json.dumps(metrics)}; phase 8 (ii) direct EngineLoop in "
            f"this call: {direct} audio-s/s")
        check(metrics["requests"] >= 16 + 2 * 128, f"/metrics requests {metrics['requests']}")

    # ---- phase 10: the quant gates -----------------------------------------

    def phase10_gates(self):
        """The JAX package's int8 and kv8 quality gates on phase 5's trees on
        the card, each metric beside the JAX value. Gated as bench.py gates
        the JAX trees: f32 math over the trees' values (bf16 leaves cast,
        int8 payloads as they are). Beside it, ungated: the metrics in bf16,
        the serving dtype, and bf16's own rounding (dense bf16 against dense
        f32, no int8)."""
        from smoltts_torch import ops
        from smoltts_torch.codec.mimi import init_mimi_params
        from smoltts_torch.interop import tree_map
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.models.dual_ar import init_params
        from smoltts_torch.ops import quant_gate as G
        from smoltts_torch.ops.quant import (
            QTensor, fuse_decode_params, fuse_mimi_decode_params, quantize_decode_params,
            quantize_mimi_params,
        )
        from smoltts_torch.tokenizer import TokenConfig

        torch, dev = self.torch, self.dev
        t_phase = time.perf_counter()
        smi = nvidia_smi()
        cfg, params_q, mcfg, mimi_q = self.lm()
        token_cfg = TokenConfig.smoltts_v0(cfg.codebook_size)
        settings = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05)
        dense = fuse_decode_params(init_params(cfg, torch.Generator().manual_seed(0),
                                               dtype=torch.bfloat16, device=dev))
        mimi = fuse_mimi_decode_params(init_mimi_params(mcfg, seed=0, dtype=torch.bfloat16,
                                                        device=dev))
        check(trees_equal(quantize_decode_params(dense), params_q)
              and trees_equal(quantize_mimi_params(mimi), mimi_q),
              "the gates' int8 trees differ from phase 5's")
        jax_ref = json.loads((ROOT / "QUANT_GATE_CACHE.json").read_text())["metrics"]

        def f32(tree):
            return tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, tree)

        trees32 = [f32(t) for t in (dense, params_q, mimi, mimi_q)]
        metrics, counts = {}, {}
        for mode, kw in (("int8", dict(int8=True, kv8=False)), ("kv8", dict(int8=False, kv8=True))):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.update(G.run_quant_gates(cfg, token_cfg, settings, mcfg, *trees32,
                                             device=dev, **kw))
            torch.cuda.synchronize()
            counts[mode] = dict(ops.LAUNCHES)
            log(f"[10 gates] {mode} gates passed (f32 math) in {time.perf_counter() - t0:.2f} s; "
                f"launches {counts[mode]}")
        check(set(metrics) == set(jax_ref), f"gate metrics {sorted(metrics)}")
        check(counts["kv8"]["decode_attention"] == 2,
              f"K2 launches in gate_kv8 {counts['kv8']['decode_attention']}, expected 2 "
              "(bf16 and int8 history)")
        check(counts["int8"]["sample_categorical"] >= 1, "K3 not launched in the vocoder gate")

        served = G.int8_lm_metrics(cfg, token_cfg, dense, params_q)
        served.update(G.int8_vocoder_metrics(cfg, token_cfg, settings, mcfg, dense, mimi, mimi_q))
        served.update(G.kv8_metrics(cfg, token_cfg, dense))
        floor = G.int8_lm_metrics(cfg, token_cfg, trees32[0], dense)
        floor.update(G.int8_vocoder_metrics(cfg, token_cfg, settings, mcfg, trees32[0],
                                            trees32[2], mimi))
        for k, v in metrics.items():
            limit, below = G.LIMITS[k]
            log(f"[10 gates] {k}: card f32 math {v!r} | card bf16 {served[k]!r} | bf16 rounding "
                f"alone {floor.get(k, 'n/a')!r} | JAX {jax_ref[k]!r} (QUANT_GATE_CACHE.json, "
                f"f32) | limit {'<' if below else '>'} {limit}")
        log(f"[10 gates] 150M on {smi}: f32 math passes every gate; bf16 outside the limits: "
            f"{G.failing(served) or 'none'}; bf16 rounding alone outside: "
            f"{G.failing(floor) or 'none'}")

        bad = dict(trees32[1])
        w = bad["fast_output"]
        bad["fast_output"] = QTensor(q=w.q, scale=w.scale * 4.0)
        try:
            G.gate_int8_lm(cfg, token_cfg, trees32[0], bad)
        except G.QuantGateError as e:
            log(f"[10 gates] a corrupted int8 tree (fast head scales x4) raised QuantGateError: "
                f"{str(e)[:300]}")
        else:
            raise RuntimeError("a corrupted int8 tree passed the int8 LM gate")
        log(f"[10 gates] phase 10 took {time.perf_counter() - t_phase:.1f} s on {smi}")

    # ---- phase 11: training -------------------------------------------------

    def phase11_training(self):
        t_phase = time.perf_counter()
        smi = nvidia_smi()
        self._train_correctness(smi)
        cfg, params = self._train_operating_point(smi)
        self._train_to_serve(cfg, params, smi)
        log(f"[11 train] phase 11 took {time.perf_counter() - t_phase:.1f} s on {smi}")

    def _train_correctness(self, smi):
        """Tiny config in f32: the card's forward, losses and gradients
        against the same port run on the CPU; remat on == off with dropout
        0.1 (T=512, through sdpa_blockwise); the chunked loss == dense."""
        from smoltts_torch.config import tiny_debug_config
        from smoltts_torch.interop import tree_map
        from smoltts_torch.models.dual_ar import forward_train, init_params
        from smoltts_torch.tokenizer import TokenConfig
        from smoltts_torch.train.data import collate, synthetic_dataset
        from smoltts_torch.train.loss import compute_losses, forward_train_loss
        from smoltts_torch.train.optim import tree_leaves

        torch, dev = self.torch, self.dev
        cfg = tiny_debug_config(codebook_size=64, vocab_size=256 + 64 + 64)
        tok = TokenConfig.smoltts_v0(64)

        def batch(B, T, seed):
            rows = synthetic_dataset(B, cfg, tok, seq_len=T, seed=seed)
            b = collate([r["ground_truth"] for r in rows], tok.pad_id, max_len=T)
            return torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"])

        def run(params, tokens, labels, c=cfg, **kw):
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            if kw:
                losses = forward_train_loss(params, c, tokens, labels, **kw)
                out = None
            else:
                out = forward_train(params, c, tokens)
                losses = compute_losses(out.token_logits, out.codebook_logits, labels, True)
            grads = torch.autograd.grad(losses.total, leaves)
            for p in leaves:
                p.requires_grad_(False)
            return out, losses, grads

        cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        tokens, labels = batch(2, 16, 0)
        o_c, l_c, g_c = run(cpu, tokens, labels)
        o_d, l_d, g_d = run(card, tokens.to(dev), labels.to(dev))
        worst = {}
        for f in ("token_logits", "codebook_logits"):
            a, b = getattr(o_d, f).detach().cpu(), getattr(o_c, f).detach()
            torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-4)
            worst[f] = float((a - b).abs().max())
        for f in ("total", "base", "semantic", "per_codebook"):
            torch.testing.assert_close(getattr(l_d, f).cpu(), getattr(l_c, f), rtol=1e-5, atol=1e-5)
        for a, b in zip(g_d, g_c):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
        worst["grads"] = max(float((a.cpu() - b).abs().max()) for a, b in zip(g_d, g_c))
        log(f"[11 train] tiny f32 forward_train, losses (incl. per codebook) and every gradient "
            f"on the card == the CPU run (5e-4 / 1e-5 / 1e-5); max abs err {worst}")

        tokens, labels = (t.to(dev) for t in batch(1, 512, 4))
        kw = dict(dropout_seed=21, train=True)
        off = cfg.replace(dropout=0.1, use_gradient_checkpointing=False)
        on = cfg.replace(dropout=0.1, use_gradient_checkpointing=True)
        _, l0, g0 = run(card, tokens, labels, off, **kw)
        _, l1, g1 = run(card, tokens, labels, on, **kw)
        _, l2, _ = run(card, tokens, labels, cfg, **kw)
        torch.testing.assert_close(l1.total, l0.total, rtol=1e-6, atol=0)
        for a, b in zip(g0, g1):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
        check(float(l2.total) != float(l0.total), "dropout 0.1 did not change the loss")
        log(f"[11 train] dropout 0.1, T=512 (sdpa_blockwise): gradients with remat == without "
            f"(max abs diff {max(float((a - b).abs().max()) for a, b in zip(g0, g1))}); loss "
            f"{float(l1.total)} vs {float(l2.total)} without dropout")

        tokens, labels = (t.to(dev) for t in batch(2, 16, 0))
        dense = forward_train_loss(card, cfg, tokens, labels, per_codebook=True)
        for ct in (4, 8):
            ch = forward_train_loss(card, cfg, tokens, labels, chunk_t=ct, per_codebook=True)
            torch.testing.assert_close(ch.total, dense.total, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(ch.per_codebook, dense.per_codebook, rtol=1e-5, atol=1e-6)
        log(f"[11 train] fast_chunk_t 4 and 8 losses == the dense path's ({float(dense.total)})")

    def _train_operating_point(self, smi):
        """bench_train.py's operating point: 150M, batch 16 x seq 768, bf16
        params, gradient checkpointing and dropout 0.1 as released, the
        reference hyperparameters, one synthetic batch repeated."""
        from smoltts_torch.config import TrainingConfig, smoltts_byte_150m
        from smoltts_torch.models.dual_ar import init_params
        from smoltts_torch.tokenizer import TokenConfig
        from smoltts_torch.train.data import collate, synthetic_dataset
        from smoltts_torch.train.trainer import batch_to, init_train_state, make_train_step

        torch, dev = self.torch, self.dev
        B, T = TRAIN_BATCH, TRAIN_SEQ
        cfg = smoltts_byte_150m()
        check(cfg.use_gradient_checkpointing and cfg.dropout == 0.1, "the released recipe")
        tc = TrainingConfig(batch_size=B, learning_rate=5e-4, lr_start=1e-3,
                            lr_warmup_steps=70_000, weight_decay=0.01, gradient_clip=1.0)
        tok = TokenConfig.smoltts_v0()
        params = init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                             device=dev)
        rows = synthetic_dataset(B, cfg, tok, seq_len=T, seed=0)
        batch = batch_to(collate([r["ground_truth"] for r in rows], tok.pad_id, max_len=T),
                         dev)
        state, tx = init_train_state(params, tc)
        step = make_train_step(cfg, tc, tx)
        gen = torch.Generator().manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, times = [], []
        for _ in range(10):
            seed = int(torch.randint(0, 2**62, (1,), generator=gen))
            t0 = time.perf_counter()
            state, m = step(state, batch, seed)
            losses.append(float(m["loss"]))  # waits for the step
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall over 10 steps: {losses}")
        timed = [t * 1e3 for t in times[2:7]]
        step_ms = float(np.median(timed))
        flops = model_flops_per_step(cfg, B, T)
        log(f"[11 train] 150M bf16, batch {B} x seq {T}, remat + dropout 0.1, on {smi}: step "
            f"{step_ms} ms median of 5 after 2 warm ({timed}); {B * T / step_ms * 1e3} tokens/s; "
            f"{flops / 1e12} TFLOP/step (bench_train.py's count), MFU "
            f"{flops / (step_ms / 1e3) / BF16_FLOPS} of {BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
            f"bound {flops / BF16_FLOPS * 1e3} ms; peak max_memory_allocated "
            f"{peak / 2**30} GiB (params + optimizer {base / 2**30} GiB)")
        log(f"[11 train] loss over 10 steps on one batch: {losses}")

        def one():
            nonlocal state
            state, _ = step(state, batch, 7)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = _profile(one, 1, 0)
        wall = (time.perf_counter() - t0) * 1e3
        kernels = trace_kernels(prof)
        rows = sorted((e for e in prof.key_averages() if _on_device(e)),
                      key=_self_device_ms, reverse=True)
        dev_ms = sum(_self_device_ms(e) for e in rows)
        busy = busy_us(kernels) / 1e3
        log(f"[11 train] one profiled step: {wall:.1f} ms wall, {busy:.1f} ms device busy "
            f"(share {busy / wall:.4f}), {dev_ms:.1f} ms of kernels, {len(kernels)} kernels")
        for e in rows[:12]:
            log(f"[11 train]   {_self_device_ms(e):9.3f} ms x{e.count:5d}  {e.key[:110]}")

        del state, tx, step
        return cfg, params

    def _train_to_serve(self, cfg, params, smi):
        """train_loop with a CheckpointManager, a resume from its newest step,
        convert to the release layout, and SmolTTS on the result."""
        from smoltts_torch import SmolTTS
        from smoltts_torch.codec.config import MimiConfig
        from smoltts_torch.codec.mimi import init_mimi_params
        from smoltts_torch.config import TrainingConfig
        from smoltts_torch.io.convert import convert
        from smoltts_torch.io.safetensors import save_file
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.tokenizer import TokenConfig, save_byte_level_tokenizer
        from smoltts_torch.train.checkpoint import CheckpointManager
        from smoltts_torch.train.data import batch_iterator, synthetic_dataset
        from smoltts_torch.train.optim import tree_leaves
        from smoltts_torch.train.trainer import TrainState, init_train_state, train_loop

        torch, dev = self.torch, self.dev
        tok = TokenConfig.smoltts_v0()
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(tmp)
            tc = TrainingConfig(batch_size=2, max_sequence_length=256, learning_rate=5e-4,
                                lr_start=1e-3, lr_warmup_steps=70_000, weight_decay=0.01,
                                save_every_n_steps=2, log_every_n_steps=1, keep_last_n_checkpoints=2,
                                checkpoint_path=str(d / "ckpt"))
            rows = synthetic_dataset(8, cfg, tok, seq_len=256, seed=1)
            batches = list(batch_iterator(rows, batch_size=2, semantic_pad_id=tok.pad_id,
                                          max_len=256, seed=2))
            logs = []
            mgr = CheckpointManager(tc.checkpoint_path, keep_last_n=2, config=tc)
            t0 = time.perf_counter()
            state, tx = init_train_state(params, tc)
            state = train_loop(cfg, tc, state, tx, batches[:2], checkpoint_manager=mgr,
                               log_fn=lambda s, m: logs.append((s, m["loss"])), device=dev)
            latest = CheckpointManager.latest_checkpoint(tc.checkpoint_path)
            check(latest is not None and latest.name == "step_000002", f"latest {latest}")
            ckpt, n, reinit = CheckpointManager.load(str(latest), tc, map_location=dev)
            check(n == 2 and not reinit, f"load -> step {n}, reinit {reinit}")
            check(all(bool(torch.equal(a, b.detach())) for a, b in
                      zip(tree_leaves(ckpt["params"]), tree_leaves(state.params))),
                  "the checkpoint's params differ from the trained ones")
            del state, tx
            state, tx = init_train_state(ckpt["params"], tc)
            tx.load_state_dict(ckpt["opt_state"])
            state = train_loop(cfg, tc, TrainState(state.params, tx, n), tx, batches[2:4],
                               checkpoint_manager=mgr,
                               log_fn=lambda s, m: logs.append((s, m["loss"])), device=dev)
            latest = CheckpointManager.latest_checkpoint(tc.checkpoint_path)
            check(state.step == 4 and latest.name == "step_000004", f"resumed to {latest}")
            check(all(math.isfinite(v) for _, v in logs), f"losses {logs}")
            t_train = time.perf_counter() - t0
            sizes = {p.name: p.stat().st_size for p in latest.iterdir()}
            del state, tx, ckpt

            cfg.save(d / "model_config.json")
            rel = d / "release"
            t0 = time.perf_counter()
            n_params = convert(latest, d / "model_config.json", rel, device=dev)
            save_byte_level_tokenizer(rel, cfg.codebook_size)
            mcfg = MimiConfig()
            save_file(mimi_hf_state(init_mimi_params(mcfg, seed=0, device="cpu"), mcfg),
                      rel / "mimi.safetensors")
            t_conv = time.perf_counter() - t0
            sampled = GenerationSettings(default_temp=0.7, default_fast_temp=0.7, min_p=0.05,
                                         max_new_tokens=16, audio_only_constraint=True)
            tts = SmolTTS(rel, generation_settings=sampled, quantize="int8+kv8", seed=1,
                          device=dev)
            pcm = tts("Hello from a checkpoint trained on the card.")
            hop = mcfg.samples_per_frame
            check(pcm.ndim == 1 and pcm.size > 0 and pcm.size % hop == 0, f"PCM {pcm.shape}")
            check(bool(np.isfinite(pcm).all()), "PCM not finite")
        log(f"[11 train] train_loop 2 steps + checkpoint, resume from step 2, 2 more steps + "
            f"checkpoint (batch 2 x 256) in {t_train:.1f} s, losses {logs}; step dir {sizes}; "
            f"convert ({n_params} params) + tokenizer + Mimi in {t_conv:.1f} s; SmolTTS(release, "
            f"'int8+kv8') __call__ -> {pcm.size // hop} frames of finite PCM on {smi}")

    # ---- phase 12: the data pipeline ----------------------------------------

    def phase12_data_pipeline(self):
        """Audio -> Mimi codes -> packed ChatML rows -> 150M train steps, at
        full width on the card, through the pipeline's library functions."""
        from smoltts_torch.codec.mimi import init_mimi_params
        from smoltts_torch.data_pipeline.encode_audio import MimiCodec
        from smoltts_torch.data_pipeline.tokenize_dataset import PipelineConfig

        t_phase = time.perf_counter()
        smi = nvidia_smi()
        mcfg = pipe_mimi_config()
        mimi = init_mimi_params(mcfg, seed=0, device="cpu")  # f32
        codec = MimiCodec(mimi, mcfg, device=self.dev)
        self._pipe_encoder_parity(codec, mimi, mcfg)
        cfg = PipelineConfig.from_json(ROOT / "config" / "pipeline" / "project_gutenberg_v2.json")
        rows = pipeline_utterances(PIPE_UTTS, mcfg.sampling_rate, cfg.speaker.speaker_names,
                                   seed=12)
        encoded = self._pipe_encode(codec, rows, smi)
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(tmp)
            self._pipe_tokenize_and_train(encoded, cfg, mimi, mcfg, d / "init", smi)
            self._pipe_warm_start(d / "warm", smi)
            self._pipe_bpe(d / "bpe", smi)
        self._pipe_preview(encoded, codec, mcfg)
        log(f"[12 data] phase 12 took {time.perf_counter() - t_phase:.1f} s on {smi}")

    def _pipe_encoder_parity(self, codec, mimi, mcfg):
        """(i) encode_batch on the card == on the CPU for 6 ragged
        utterances (f32, TF32 off); a differing code must be a near tie: at
        the first level of its side where the two differ, the CPU's residual
        scores the card's code within RVQ_NEAR_TIE of the score range below
        the CPU's (later levels of that side follow from the first)."""
        from smoltts_torch.codec.conv import causal_conv1d
        from smoltts_torch.codec.seanet import build_encoder_plan, seanet_apply
        from smoltts_torch.codec.transformer import transformer_forward
        from smoltts_torch.data_pipeline.encode_audio import MimiCodec

        torch = self.torch
        hop = mcfg.samples_per_frame
        rng = np.random.default_rng(5)
        lens = [int(s * mcfg.sampling_rate) + int(rng.integers(0, hop))
                for s in (1.3, 2.0, 0.5, 3.7, 2.9, 1.1)]
        audios = [synth_audio(rng, n, mcfg.sampling_rate) for n in lens]
        card = codec.encode_batch(audios)
        cpu = MimiCodec(mimi, mcfg, device="cpu").encode_batch(audios)
        batch = np.zeros((len(audios), max(card[i].shape[-1] for i in range(6)) * hop), np.float32)
        for i, a in enumerate(audios):
            batch[i, : a.size] = a

        def embed(params, dev):
            x = torch.from_numpy(batch).to(dev)[..., None]
            with torch.no_grad():
                x = seanet_apply(build_encoder_plan(mcfg), params["encoder"], x, mcfg)
                x = transformer_forward(params["encoder_transformer"], mcfg, x)
                return causal_conv1d(x, params["downsample"]["w"], params["downsample"].get("b"),
                                     stride=mcfg.downsample_stride, pad_mode="replicate").float()

        x = embed(mimi, "cpu")
        x_err = float((embed(codec.params, self.dev).cpu() - x).abs().max() / x.abs().max())
        q = mimi["quantizer"]
        n_sem = mcfg.num_semantic_quantizers
        differ, firsts, worst = np.zeros(codec.num_codebooks, int), 0, 0.0
        for b, (c, r) in enumerate(zip(card, cpu)):
            check(c.shape == r.shape == (codec.num_codebooks, math.ceil(lens[b] / hop)),
                  f"codes {c.shape} vs {r.shape}")
            differ += (c != r).sum(axis=1)
            for t in np.nonzero((c != r).any(axis=0))[0]:
                for side, levels in (("semantic", range(0, n_sem)),
                                     ("acoustic", range(n_sem, codec.num_codebooks))):
                    res = x[b, t] @ q[side]["in_proj"]
                    for k in levels:
                        emb = q[side]["embed"][k - levels[0]]
                        if c[k, t] != r[k, t]:
                            s = res @ emb.T - 0.5 * (emb * emb).sum(-1)
                            gap = float(s[r[k, t]] - s[c[k, t]]) / float(s.max() - s.min())
                            worst = max(worst, gap)
                            firsts += 1
                            break
                        res = res - emb[int(r[k, t])]
        n = sum(int(r.size) for r in cpu)
        log(f"[12 data] (i) MimiCodec.encode_batch, 6 ragged utterances {lens} samples, "
            f"{codec.num_codebooks} codebooks, f32, TF32 off: {int(differ.sum())} of {n} codes differ "
            f"card vs CPU, by level {differ.tolist()}; {firsts} first differences, the largest "
            f"score gap {worst:.3e} of the score range (gate {RVQ_NEAR_TIE}); pre-RVQ embedding "
            f"max abs diff {x_err:.3e} of its max")
        check(worst <= RVQ_NEAR_TIE, f"a differing code is not a near tie ({worst})")

    def _pipe_encode(self, codec, rows, smi):
        """(ii) the 192 utterances through encode_dataset_rows at the CLI's
        batch size; the device's busy share and top kernels over one batch."""
        from smoltts_torch.data_pipeline.encode_audio import encode_dataset_rows
        from smoltts_torch.utils.profiling import device_op_summary, trace

        torch = self.torch
        sr, hop = codec.config.sampling_rate, codec.config.samples_per_frame
        sizes = [r["audio"]["array"].size for r in rows]
        encode_dataset_rows(codec, rows[:PIPE_BATCH], batch_size=PIPE_BATCH)  # warm (cuDNN)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        encoded = encode_dataset_rows(codec, rows, batch_size=PIPE_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        audio_s = sum(sizes) / sr
        padded = sum(len(sizes[i:i + PIPE_BATCH]) * math.ceil(max(sizes[i:i + PIPE_BATCH]) / hop)
                     for i in range(0, len(sizes), PIPE_BATCH)) * hop / sr
        check(len(encoded) == len(rows) and all(
            r["codes"].shape == (8, math.ceil(n / hop)) for r, n in zip(encoded, sizes)),
            "encoded rows' shapes")
        flops = mimi_encoder_flops(codec.config, codec.num_codebooks) * padded
        log(f"[12 data] (ii) encode_dataset_rows {len(rows)} utterances ({audio_s:.1f} audio-s, "
            f"{padded:.1f} s with each batch padded to its longest) at batch {PIPE_BATCH} on {smi}: "
            f"{wall:.3f} s, {audio_s / wall:.1f} audio-s/s by host clock after a sync; "
            f"{flops / 1e12:.2f} TFLOP, bound {flops / F32_FLOPS:.3f} s at {F32_FLOPS / 1e12:.0f} "
            f"TFLOP/s f32 (TF32 off); peak max_memory_allocated {peak / 2**30:.2f} GiB")

        captured = []
        real_profile = torch.profiler.profile

        class Capture(real_profile):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                captured.append(self)

        with tempfile.TemporaryDirectory() as log_dir:
            torch.cuda.synchronize()
            with mock.patch("torch.profiler.profile", Capture), trace(log_dir):
                t0 = time.perf_counter()
                encode_dataset_rows(codec, rows[:PIPE_BATCH], batch_size=PIPE_BATCH)
                window = (time.perf_counter() - t0) * 1e6  # the codes are on the host
            summary = device_op_summary(log_dir, top_k=10**6)
            (path,) = Path(log_dir).glob("*.pt.trace.json")
            kernels = kernel_intervals(json.loads(path.read_text())["traceEvents"])
        prof = captured[0]
        busy = busy_us(kernels)
        rows_ka = [e for e in prof.key_averages() if _on_device(e)
                   and not e.key.startswith(("Memcpy", "Memset"))]
        ka_count = sum(e.count for e in rows_ka)
        ka_us = sum(_self_device_ms(e) for e in rows_ka) * 1e3
        sum_count = sum(c for _, _, c in summary)
        sum_us = sum(us for _, us, _ in summary)
        log(f"[12 data] (ii) one batch of {PIPE_BATCH} under utils.profiling.trace: {window / 1e3:.1f} ms "
            f"host window, device busy {busy / 1e3:.1f} ms (share {busy / window:.4f}); "
            f"device_op_summary {sum_count} kernels {sum_us / 1e3:.3f} ms, the profiler's own "
            f"rows {ka_count} kernels {ka_us / 1e3:.3f} ms")
        check(sum_count == ka_count and abs(sum_us - ka_us) <= 0.01 * ka_us,
              "device_op_summary disagrees with the profiler's own kernel rows")
        for name, us, count in summary[:8]:
            log(f"[12 data]   {us / 1e3:9.3f} ms x{count:4d}  {name[:110]}")
        return encoded

    def _pipe_tokenize_and_train(self, encoded, cfg, mimi, mcfg, init_dir, smi):
        """(iii) filter, tokenize and pack with the project_gutenberg_v2
        config, a 150M byte-level init made by create_bytelevel_init, 3
        train steps at 16 x 768 on the packed rows, SmolTTS on the dir."""
        from smoltts_torch import SmolTTS
        from smoltts_torch.config import DualARConfig, ModelType, TrainingConfig
        from smoltts_torch.data_pipeline.create_init import create_bytelevel_init
        from smoltts_torch.data_pipeline.prompt import PipelinePromptEncoder, TokenizationConfig
        from smoltts_torch.data_pipeline.tokenize_dataset import (
            SyspromptEncoder, _load_tokenizer, process_rows,
        )
        from smoltts_torch.io.checkpoint import load_params
        from smoltts_torch.io.safetensors import save_file
        from smoltts_torch.lm.samplers import GenerationSettings
        from smoltts_torch.tokenizer import TokenConfig
        from smoltts_torch.train.data import batch_iterator
        from smoltts_torch.train.trainer import batch_to, init_train_state, make_train_step

        torch, dev = self.torch, self.dev
        t0 = time.perf_counter()
        create_bytelevel_init(init_dir, pipe_lm_config(), seed=0, device=dev)
        t_init = time.perf_counter() - t0
        cfg.tokenization.tokenizer_path = str(init_dir)
        enc = PipelinePromptEncoder(_load_tokenizer(cfg.tokenization.tokenizer_path),
                                    TokenizationConfig(duplicate_code_0=cfg.tokenization.duplicate_code_0))
        t0 = time.perf_counter()
        packed = process_rows(encoded, cfg, enc, SyspromptEncoder(cfg, enc))
        t_tok = time.perf_counter() - t0
        cap = cfg.audio.frame_rate * cfg.audio.max_sample_secs
        kept = sum(r["codes"].shape[-1] <= cap for r in encoded)
        widths = sorted(r["ground_truth"].shape[-1] for r in packed)
        check(all(w <= cfg.packing.max_sequence_length for w in widths), f"widths {widths}")
        log(f"[12 data] (iii) create_bytelevel_init 150m on the card + write: {t_init:.2f} s; "
            f"filter (<= {cap} frames) kept {kept} of {len(encoded)}, tokenize + pack "
            f"(project_gutenberg_v2: {len(cfg.speaker.speaker_names)} speakers, packing "
            f"{cfg.packing.max_sequence_length}) -> {len(packed)} rows in {t_tok:.3f} s, "
            f"{len(encoded) / t_tok:.1f} utterance rows/s on the host; packed widths min "
            f"{widths[0]} median {widths[len(widths) // 2]} max {widths[-1]}, fill "
            f"{sum(widths) / (len(widths) * cfg.packing.max_sequence_length):.4f}")

        lm_cfg = DualARConfig.from_json_file(init_dir)
        tok = TokenConfig.from_tokenizer(ModelType.smoltts_v0(), enc.tokenizer, lm_cfg)
        params = load_params(init_dir, lm_cfg, dtype=torch.bfloat16, device=dev)
        tc = TrainingConfig(batch_size=TRAIN_BATCH, learning_rate=5e-4, lr_start=1e-3,
                            lr_warmup_steps=70_000, weight_decay=0.01, gradient_clip=1.0)
        batches = batch_iterator(packed, batch_size=TRAIN_BATCH, semantic_pad_id=tok.pad_id,
                                 max_len=cfg.packing.max_sequence_length, seed=0, epochs=3)
        state, tx = init_train_state(params, tc)
        step = make_train_step(lm_cfg, tc, tx)
        losses, times = [], []
        for i in range(3):
            batch = batch_to(next(batches), dev)
            t0 = time.perf_counter()
            state, m = step(state, batch, i)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
        del state, tx, step, params
        save_file(mimi_hf_state(mimi, mcfg), init_dir / "mimi.safetensors")
        tts = SmolTTS(init_dir, generation_settings=GenerationSettings(
            default_temp=0.7, default_fast_temp=0.7, min_p=0.05, max_new_tokens=8,
            audio_only_constraint=True), quantize="int8+kv8", seed=1, device=dev)
        pcm = tts("A line from the packed rows.")
        check(pcm.ndim == 1 and bool(np.isfinite(pcm).all()), f"PCM {pcm.shape}")
        log(f"[12 data] (iii) 3 train steps (150M bf16, remat + dropout 0.1) on batches of "
            f"{TRAIN_BATCH} x {cfg.packing.max_sequence_length} from batch_iterator over the packed rows: losses "
            f"{losses}, {[round(t, 1) for t in times]} ms by host; SmolTTS(init dir, 'int8+kv8') "
            f"-> {pcm.size} PCM samples, finite")
        del tts

    def _pipe_warm_start(self, out_dir, smi):
        """(iv) convert_lm_init on a seeded state dict at SmolLM2-135M's
        published widths, a random fast trunk merged in, save_params,
        load_params onto the card: bit for bit, and a finite forward_train."""
        from smoltts_torch.data_pipeline.create_init import convert_lm_init
        from smoltts_torch.io.checkpoint import (
            load_params, params_from_state_dict, save_params, state_dict_from_params,
        )
        from smoltts_torch.models.dual_ar import forward_train, init_params
        from smoltts_torch.train.loss import compute_losses

        torch, dev = self.torch, self.dev
        cfg, hf = warm_start_config()
        t0 = time.perf_counter()
        hf_state = smollm_state(hf, seed=3)
        t_make = time.perf_counter() - t0
        t0 = time.perf_counter()
        conv = convert_lm_init(hf_state, cfg, hf["num_hidden_layers"])
        del hf_state
        state = state_dict_from_params(init_params(cfg, torch.Generator().manual_seed(4),
                                                   device="cpu"), cfg)
        check(set(conv) <= set(state), f"keys outside the schema {set(conv) - set(state)}")
        state.update({k: torch.from_numpy(v) for k, v in conv.items()})
        save_params(params_from_state_dict(state, cfg), cfg, out_dir)
        del state
        t_conv = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_params(out_dir, cfg, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        back = state_dict_from_params(loaded, cfg)
        check(all(back[k].dtype == torch.float32 and np.array_equal(back[k].cpu().numpy(), v)
                  for k, v in conv.items()), "the loaded tensors differ from convert_lm_init's")
        rng = np.random.default_rng(6)
        tokens = rng.integers(0, cfg.codebook_size, (2, cfg.num_rows, 129)).astype(np.int64)
        tokens[:, 0] = rng.integers(0, cfg.vocab_size, (2, 129))
        t = torch.from_numpy(tokens).to(dev)
        with torch.no_grad():
            out = forward_train(loaded, cfg, t[..., :-1])
            loss = compute_losses(out.token_logits, out.codebook_logits, t[..., 1:], True).total
        check(math.isfinite(float(loss)), f"warm-start loss {float(loss)}")
        n = sum(v.size for v in conv.values())
        log(f"[12 data] (iv) warm start from a seeded state dict at SmolLM2-135M widths "
            f"({hf}) made in {t_make:.1f} s: convert_lm_init ({len(conv)} tensors, {n} values, "
            f"embeddings {tuple(conv['embeddings.weight'].shape)}) + random fast trunk + "
            f"save_params in {t_conv:.1f} s; load_params onto the card in {t_load:.2f} s, every "
            f"converted tensor equal bit for bit; forward_train loss {float(loss):.4f} (finite)")
        del loaded, back, out

    def _pipe_bpe(self, tok_dir, smi):
        """(v) the checked-in BPE fixture through load_tokenizer, without HF
        `tokenizers`: the fixture's HF ids for every string."""
        from smoltts_torch.bpe import BPETokenizer
        from smoltts_torch.tokenizer import load_tokenizer

        fx = json.loads((ROOT / "tests" / "data" / "torch_bpe_fixture.json")
                        .read_text(encoding="utf-8"))
        tok_dir.mkdir(parents=True)
        (tok_dir / "tokenizer.json").write_text(json.dumps(fx["tokenizer"]), encoding="utf-8")
        has_hf = "present" if importlib.util.find_spec("tokenizers") else "absent"
        with mock.patch.dict(sys.modules, {"tokenizers": None}):  # unimportable here
            t0 = time.perf_counter()
            tok = load_tokenizer(tok_dir)
            t_load = time.perf_counter() - t0
            bad = [c["text"] for c in fx["cases"] if tok.encode(c["text"]) != c["ids"]]
        check(isinstance(tok, BPETokenizer), f"load_tokenizer gave {type(tok).__name__}")
        check(not bad, f"ids differ from the fixture's HF ids for {bad[:3]}")
        text = " ".join(c["text"] for c in fx["cases"])
        t0 = time.perf_counter()
        for _ in range(5):
            tok.encode(text)
        rate = 5 * len(text) / (time.perf_counter() - t0)
        log(f"[12 data] (v) BPE fixture ({len(fx['tokenizer']['model']['merges'])} merges, "
            f"{tok.vocab_size} tokens; HF tokenizers {has_hf} on this machine, blocked for the "
            f"check): load_tokenizer {t_load:.3f} s, ids == the fixture's HF ids for all "
            f"{len(fx['cases'])} strings; encode "
            f"{rate:.0f} characters/s on the host")

    def _pipe_preview(self, encoded, codec, mcfg):
        """(vi) serve_preview on 127.0.0.1 over the encoded rows: GET
        /random returns a WAV of frames x 1920 samples."""
        from smoltts_torch.data_pipeline import preview
        from smoltts_torch.server.http import HttpServer

        has_ds = "installed" if importlib.util.find_spec("datasets") else "not installed"
        started = []
        real_run = HttpServer.run

        def run(app, host, port):
            started.append(app)
            real_run(app, host, port)

        import threading

        port = free_port()
        with mock.patch.object(HttpServer, "run", run):
            th = threading.Thread(target=preview.serve_preview,
                                  args=(encoded, codec, "127.0.0.1", port), daemon=True)
            th.start()
            deadline = time.time() + 60
            while not port_open(port):
                check(time.time() < deadline and th.is_alive(), "the preview did not start")
                time.sleep(0.05)
        try:
            t0 = time.perf_counter()
            status, _, body = request(port, "GET", "/random")
            t_req = time.perf_counter() - t0
            _, _, page = request(port, "GET", "/")
        finally:
            started[0].stop()
            th.join(timeout=30)
        check(not th.is_alive(), "the preview thread did not stop")
        hop = mcfg.samples_per_frame
        lengths = {44 + 2 * r["codes"].shape[-1] * hop for r in encoded}
        check(status == 200 and body[:4] == b"RIFF" and len(body) in lengths,
              f"/random -> {status}, {len(body)} bytes")
        check(b'src="/random"' in page, "the preview page")
        log(f"[12 data] (vi) serve_preview on 127.0.0.1 (stdlib server): GET /random -> WAV of "
            f"{(len(body) - 44) // 2 // hop} frames x {hop} samples in {t_req * 1e3:.0f} ms; "
            f"HF datasets {has_ds} on this machine (the phase does not use it)")

    def _f32_trees(self):
        """Phase 6's trees: 150M f32 int8 LM and the Mimi f32 int8 tree."""
        from smoltts_torch.codec.mimi import init_mimi_params
        from smoltts_torch.models.dual_ar import init_params
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
        return params, mimi

    def run(self, phases=None):
        table = [
            (1, self.phase1_build), (2, self.phase2_attention), (3, self.phase3_fast_loop),
            (4, self.phase4_sampler), (5, self.phase5_main_path), (6, self.phase6_greedy_e2e),
            (7, self.phase7_library), (8, self.phase8_engine), (9, self.phase9_server),
            (10, self.phase10_gates), (11, self.phase11_training),
            (12, self.phase12_data_pipeline),
        ]
        for num, fn in table:
            if phases is not None and num != 1 and num not in phases:
                continue
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
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (the build, phase 1, always runs); "
                         "default all")
    opts = ap.parse_args()
    phases = None if opts.phases is None else {int(p) for p in opts.phases.split(",")}
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
    smoke.run(phases)
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
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if phases is not None:  # a partial run says which phases it ran
        result["phases"] = sorted(phases | {1})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
