"""The benchmark's arithmetic: percentiles, interval unions, the
window logic of the serving metrics, trace parsing, the traffic generator,
and the operation and byte counts against the figures recorded on the card
(K1 at B=64: 37.0 GFLOP / 48.2 MB; K2 at lim 256: 8.00 MB; a 150M train
step at 16 x 768: 28.30 TFLOP)."""

import json
import math

import numpy as np
import pytest

from portbench import flops, registry, stats, traffic
from portbench.registry import HERE
from portbench.rooflines import k1, k2
from portbench.tracing import breakdown, call_spans, parse_trace


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_percentile_is_nearest_rank_and_counts_missing_as_infinite():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95 and stats.percentile(vals, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0] * 19 + [math.inf], 95) == 1.0
    assert stats.percentile([1.0] * 18 + [math.inf] * 2, 95) == math.inf


def test_interval_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == 4
    assert stats.gaps(iv, 0, 8) == [(3, 5), (6, 8)]


def test_k1_counts_at_b64_match_the_recorded_figures():
    f, b = k1.work(config("smoltts_150m")["model"], 64)
    assert round(f / 1e9, 1) == 37.0 and round(b / 1e6, 1) == 48.2


def test_k2_bytes_at_lim_256_match_the_recorded_figure():
    """chip_smoke.py phase 2's main-path case: B 64, 12/4 heads at hd 64,
    lim 256, tail 128, positions from numpy's default_rng(7)."""
    B, lim, W = 64, 256, 128
    rng = np.random.default_rng(7)
    flushed = rng.integers(lim // 2, lim - W // 2, B)
    n_new = rng.integers(1, W // 2, B)
    pos = np.minimum(flushed + n_new - 1, lim - 1)
    flushed[0], pos[0] = 0, n_new[0] - 1
    flushed[1], pos[1] = lim, lim - 1
    flushed[2], pos[2] = lim + 5, lim + 10
    tail_pos = np.full((B, W), -1, np.int64)
    for b in range(B):
        cols = rng.permutation(W)[: pos[b] - flushed[b] + 1]
        tail_pos[b, cols] = np.arange(flushed[b], pos[b] + 1)
        tail_pos[b, rng.integers(0, W)] = flushed[b] - 3 if flushed[b] >= 3 else -1
        tail_pos[b, cols[:1]] = flushed[b]
    n_hist = int(np.minimum(flushed, lim).sum())
    n_tail = int(((tail_pos >= flushed[:, None]) & (tail_pos <= pos[:, None])).sum())
    _, nbytes = k2.work(config("smoltts_150m")["model"], B, n_hist, n_tail, W)
    assert round(nbytes / 1e6, 2) == 8.00


def test_train_step_flops_of_the_150m_at_16x768():
    assert round(flops.train_step_flops(config("smoltts_150m")["model"], 16, 768) / 1e12, 2) == 28.30


def test_vocoder_and_lm_frame_flops_are_positive_and_grow_with_context():
    conf = config("smoltts_150m")
    assert 1e8 < flops.vocoder_frame_flops(conf["codec"]) < 1e10
    m = conf["model"]
    assert flops.lm_frame_flops(m, 600) > flops.lm_frame_flops(m, 100) > k1.work(m, 1)[0]


def test_traffic_gives_every_seed_the_same_sizes_in_another_order():
    t = json.loads((HERE / "traffic" / "closed64.json").read_text())
    conf = config("smoltts_150m")
    a = traffic.requests(t, conf["vocab"], 9, 1)
    b = traffic.requests(t, conf["vocab"], 9, 2**31 + 11)
    assert sorted(r.budget for r in a) == sorted(r.budget for r in b)
    assert [r.budget for r in a] != [r.budget for r in b]
    lens = np.array([len(r.text) for r in a])
    assert 10 <= lens.min() and lens.max() <= 300 and 50 <= np.median(lens) <= 70
    assert all(12 <= r.budget <= 250 for r in a)
    assert all("s" not in r.text for r in a)


def test_prompts_are_what_the_ports_tokenizer_makes():
    from smoltts_torch.config import DualARConfig
    from smoltts_torch.lm.prompt import PromptEncoder
    from smoltts_torch.tokenizer import ByteTokenizer, TokenConfig

    conf = config("smoltts_150m")
    cfg = DualARConfig.from_dict(conf["model"])
    pe = PromptEncoder.from_config(ByteTokenizer(2048), cfg, TokenConfig.smoltts_v0())
    t = json.loads((HERE / "traffic" / "closed64.json").read_text())
    for r in traffic.requests(t, conf["vocab"], cfg.num_rows, 3)[:20]:
        want = np.concatenate([pe.encode_text_turn("system", f"<|speaker:{r.speaker}|>"),
                               pe.encode_text_turn("user", r.text),
                               pe.encode_text_turn("assistant")], axis=1)
        np.testing.assert_array_equal(r.prompt, want)


def test_poisson_arrivals_share_their_gaps_across_seeds():
    t = {"rate": 8.0, "pool": {"seed": 3}}
    a, b = traffic.poisson_arrivals(t, 500, 1), traffic.poisson_arrivals(t, 500, 2)
    assert a[-1] == pytest.approx(b[-1]) and not np.allclose(a, b)
    assert 500 / a[-1] == pytest.approx(8.0, rel=0.15)


def _ctx():
    """Two requests: one inside the window with 4 frames at 0.1 s, one that
    starts before it and one that never gets a first frame."""
    conf = config("smoltts_150m")
    r1 = traffic.Request(0, "a", 0, 10, np.zeros((9, 5), np.int32), submit=10.5, first=10.9,
                         arrivals=[10.9, 11.0, 11.1, 11.2])
    r2 = traffic.Request(1, "b", 0, 10, np.zeros((9, 5), np.int32), submit=9.0, first=9.5,
                         arrivals=[9.5, 9.7, 10.2, 10.6, 11.0])
    r3 = traffic.Request(2, "c", 0, 10, np.zeros((9, 5), np.int32), submit=11.5)
    return {"t_open": 10.0, "t_close": 12.0, "window_s": 2.0, "requests": [r1, r2, r3],
            "codec": conf["codec"], "model": conf["model"], "stats": {"frame_steps": 25}}


def test_serving_metrics_count_the_window_only():
    ctx = _ctx()
    read = lambda n: registry.reader(n)(ctx)  # noqa: E731
    assert read("audio_s_per_s") == pytest.approx(7 * 0.08 / 2.0)
    assert read("first_audio_ms_p95") == math.inf  # r3 never started
    assert read("frame_interval_ms_p95") == pytest.approx(400.0)  # r2: 10.2 -> 11.0 over 2
    assert read("engine_step_ms") == pytest.approx(80.0)
    assert read("serve_mfu") > 0
    ctx["requests"].pop()
    assert read("first_audio_ms_p95") == pytest.approx(400.0)


def test_trace_parsing_spans_and_breakdown():
    events = [
        {"cat": "user_annotation", "name": "portbench.advance#0", "ts": 0.0, "dur": 50.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2.0, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 60.0, "tid": 7,
         "args": {"correlation": 3}},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 55.0, "dur": 10.0, "tid": 7},
        {"cat": "kernel", "name": "gemm_i8", "ts": 10.0, "dur": 5.0, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "fast_attn", "ts": 14.0, "dur": 6.0, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "other", "ts": 70.0, "dur": 10.0, "args": {"correlation": 3}},
    ]
    tr = parse_trace(events, 100e-6)
    assert tr.busy_s == pytest.approx(20e-6)
    got = tr.kernels_in("advance")
    assert list(got) == [0] and [k.name for k in got[0]] == ["gemm_i8", "fast_attn"]
    assert call_spans(got[0], 1) == [pytest.approx(10e-6)]
    assert call_spans(got[0], 3) == []
    b = breakdown(tr)
    assert b["device_ops"][0] == ["other", pytest.approx(10e-6)]
    assert b["idle_gaps"] == [["host: in aten::mm", pytest.approx(50e-6)]]
