"""The readers of the program's own spans and counters on synthetic runs:
the alignment of the program's spans with the benchmark's on a trace
whose clock is offset by a known amount, each new reader against values
computed from the run's construction, and None where the ring dropped
spans inside the window, where the window is empty, or where the program
records nothing (a parent without the spans)."""

import numpy as np
import pytest

from portbench import program_spans, registry
from portbench.tracing import Kernel, Trace

OFFSET_US = 4.2e9 + 0.37  # the trace's clock: perf_counter s * 1e6 + OFFSET_US
LEAD_US = 2.0  # the benchmark's span opens this long before the program's
DISPATCH, CLIENT = 11, 22  # thread ids
QUIET = [(99.5, 102.0), (104.0, 106.5)]
TRACED = (102.05, 103.95)  # where the benchmark's spans were recorded
LM_UNION_US, VOC_UNION_US = 220.0, 110.0


class Ring:
    """The recorder's interface as the readers use it."""

    def __init__(self, spans, dropped=0):
        self.spans, self.dropped = sorted(spans, key=lambda s: s[2]), dropped

    def snapshot(self):
        return list(self.spans)


def synthetic(seed=0, engine=True):
    """A served run of chunk steps of 2 frames on one thread (engine: each
    inside `engine.advance`; library: `step.stream` steps of 1 frame), with
    prefills between, clients' submit waits and the library's PCM waits,
    the benchmark's advance spans over the traced part on the trace's clock,
    and kernels launched inside each frame, each step and between steps.
    Returns (ctx, spans, expected readings)."""
    rng = np.random.default_rng(seed)
    spans, bench, kernels = [], [], []
    exp = {"lm": [], "voc": [], "wait": [], "pcm": [], "frames": 0, "ops": 0, "in_anchor": 0}
    t, i = 99.0, 0
    while t < 106.2:
        i += 1
        if i % 10 == 0:  # a prefill: its frame is not a served frame step
            spans += [("step.prefill", t, t + 0.06, DISPATCH), ("lm.frame", t, t + 0.05, DISPATCH)]
            t += 0.07
        a0 = t
        cur = a0 + 1e-4
        parts = []
        for _ in range(2 if engine else 1):
            for name, base in (("lm.frame", 0.010), ("codec.step", 0.008)):
                d = base + rng.uniform(0, 0.004)
                parts.append((name, cur, cur + d, DISPATCH))
                cur += d + 1e-5
        step = ("step.chunk" if engine else "step.stream", a0 + 5e-5, cur + 1e-4, DISPATCH)
        a1 = cur + 3e-4
        spans += parts + [step]
        anchor = ("engine.advance", a0, a1, DISPATCH) if engine else step
        if engine:
            spans.append(anchor)
        pcm = ("stream.to_host", a1 + 1e-4, a1 + 1e-4 + rng.uniform(0.001, 0.003), DISPATCH)
        wait = ("engine.submit_wait", a0 + 0.01, a0 + 0.01 + rng.uniform(0, 0.2), CLIENT)
        spans += [pcm, wait]
        if any(lo <= step[1] and step[2] <= hi for lo, hi in QUIET):
            exp["lm"] += [(p[2] - p[1]) * 1e3 for p in parts if p[0] == "lm.frame"]
            exp["voc"] += [(p[2] - p[1]) * 1e3 for p in parts if p[0] == "codec.step"]
        for s, key in ((pcm, "pcm"), (wait, "wait")):
            if any(lo <= s[1] and s[2] <= hi for lo, hi in QUIET):
                exp[key].append((s[2] - s[1]) * 1e3)
        if TRACED[0] <= anchor[1] and anchor[2] <= TRACED[1]:
            jitter = rng.uniform(-1.0, 1.0)
            bench.append((f"portbench.advance#{len(bench)}",
                          anchor[1] * 1e6 + OFFSET_US - LEAD_US + jitter,
                          anchor[2] * 1e6 + OFFSET_US + LEAD_US + jitter))
            for p in parts:
                p0 = p[1] * 1e6 + OFFSET_US
                n = 3 if p[0] == "lm.frame" else 2
                kernels += [Kernel("k", p0 + 10 * (k + 1) + 5, p0 + 10 * (k + 1)
                                   + (205 if n == 3 else 105), p0 + 10 * (k + 1))
                            for k in range(n)]
                exp["ops"] += n
                exp["frames"] += p[0] == "lm.frame"
            s1 = step[2] * 1e6 + OFFSET_US
            kernels.append(Kernel("cat", s1 - 40, s1 - 30, s1 - 50))  # in the step, not a frame
            exp["in_anchor"] += 1
        kernels.append(Kernel("gap", a1 * 1e6 + OFFSET_US + 900, a1 * 1e6 + OFFSET_US + 950,
                              a1 * 1e6 + OFFSET_US + 800))  # between anchors
        t = a1 + rng.uniform(0.005, 0.02)
    exp["in_anchor"] += exp["ops"]
    trace = Trace(kernels=sorted(kernels, key=lambda k: k.t0), spans=bench,
                  window_s=TRACED[1] - TRACED[0], busy_s=0.1)
    ctx = {"t_open": QUIET[0][0], "t_close": QUIET[1][1], "quiet": QUIET, "trace": trace,
           "stats": {"frame_steps": 40, "dispatch_s": 1.0, "gate_wait_s": 0.25,
                     "lock_wait_s.dispatch": 0.5}}
    return ctx, spans, exp


@pytest.fixture
def program(monkeypatch):
    """Install a synthetic ring as the program's recorder."""
    def install(spans, dropped=0):
        ring = Ring(spans, dropped)
        monkeypatch.setattr(program_spans, "recorder", lambda: ring)
        return ring
    return install


@pytest.mark.parametrize("engine", [True, False], ids=["engine", "library"])
def test_the_alignment_recovers_a_known_offset(program, engine):
    ctx, spans, exp = synthetic(engine=engine)
    program(spans)
    al = program_spans.align(ctx)
    assert al is not None and al.bench == len(ctx["trace"].spans) >= 3
    assert abs(al.offset_us - (OFFSET_US - LEAD_US)) < 5.0
    assert al.residual_us < 5.0 and al.enclosed == al.bench
    got = program_spans.coverage(ctx)
    assert got["ops_in_anchors"] == exp["in_anchor"] and got["ops_in_frames"] == exp["ops"]


def test_the_alignment_finds_the_pairing_among_shifted_ones(program):
    """Only a middle stretch of the program's anchors was traced: the
    pairing is found among every shift of the series."""
    ctx, spans, _ = synthetic(seed=3)
    program(spans)
    al = program_spans.align(ctx)
    first = min(s[1] for s in spans if s[0] == "engine.advance" and s[1] >= TRACED[0])
    assert abs(al.anchors[0][1] - (first * 1e6 + OFFSET_US)) < 5.0


def _expected(exp, name):
    mean = lambda v: float(np.mean(v))  # noqa: E731
    return {
        "engine_dispatch_lock_wait_share": 100 * 0.5 / 5.0,
        "engine_gate_wait_share": 100 * 0.25 / 5.0,
        "dispatch_host_ms_per_step": 1.0e3 / 40,
        "engine_submit_wait_ms_p95": float(np.sort(exp["wait"])[
            int(np.ceil(0.95 * len(exp["wait"]))) - 1]),
        "lm_host_ms_per_frame": mean(exp["lm"]),
        "vocoder_host_ms_per_frame": mean(exp["voc"]),
        "lm_device_ms_per_frame": LM_UNION_US / 1e3,
        "vocoder_device_ms_per_frame": VOC_UNION_US / 1e3,
        "kernels_per_frame": exp["ops"] / exp["frames"],
        "lib_pcm_wait_ms_per_frame": mean(exp["pcm"]),
    }[name]


SPAN_READERS = ["engine_submit_wait_ms_p95", "lm_host_ms_per_frame",
                "vocoder_host_ms_per_frame", "lm_device_ms_per_frame",
                "vocoder_device_ms_per_frame", "kernels_per_frame", "lib_pcm_wait_ms_per_frame"]
COUNTER_READERS = ["engine_dispatch_lock_wait_share", "engine_gate_wait_share",
                   "dispatch_host_ms_per_step"]


@pytest.mark.parametrize("name", COUNTER_READERS + SPAN_READERS)
def test_each_reader_reads_the_synthetic_run(program, name):
    ctx, spans, exp = synthetic(engine=name != "lib_pcm_wait_ms_per_frame")
    program(spans)
    assert registry.reader(name)(ctx) == pytest.approx(_expected(exp, name), rel=1e-6)


@pytest.mark.parametrize("case", ["dropped", "empty", "no_recorder"])
@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_none_without_whole_spans(program, monkeypatch, name, case):
    ctx, spans, _ = synthetic()
    if case == "dropped":  # the ring lost spans that ended inside the window
        program([s for s in spans if s[2] > QUIET[0][0] + 0.5], dropped=100)
    elif case == "empty":
        program([s for s in spans if s[2] < QUIET[0][0] or s[1] > QUIET[1][1]])
        ctx["trace"] = Trace(kernels=[], spans=[], window_s=1.9, busy_s=0.0)
    else:
        monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert registry.reader(name)(ctx) is None


def test_a_ring_that_dropped_only_older_spans_still_reads(program):
    ctx, spans, exp = synthetic()
    program([s for s in spans if s[2] > QUIET[0][0] - 0.2], dropped=100)
    assert registry.reader("lm_host_ms_per_frame")(ctx) == pytest.approx(np.mean(exp["lm"]))


@pytest.mark.parametrize("stats", [{}, {"frame_steps": 40, "dispatch_s": 0.0,
                                        "gate_wait_s": 0.0, "lock_wait_s.dispatch": 0.0}],
                         ids=["parent", "zero"])
@pytest.mark.parametrize("name", COUNTER_READERS)
def test_counter_readers_read_none_without_counts(name, stats):
    ctx, _, _ = synthetic()
    ctx["stats"] = stats
    assert registry.reader(name)(ctx) is None
