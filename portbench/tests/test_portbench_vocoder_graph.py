"""The `vocoder_graph_share` reader on synthetic spans: the share of the
served frame steps' vocoder steps that hold a graph replay, prefills not
counted, and None without spans or without the program's graph module."""

import importlib.util

import pytest

from portbench import program_spans, registry

QUIET = [(10.0, 20.0), (30.0, 40.0)]
TID = 7


class Ring:
    def __init__(self, spans):
        self.spans, self.dropped = sorted(spans, key=lambda s: s[2]), 0

    def snapshot(self):
        return list(self.spans)


def run(replays_every: int, frames_per_step: int = 2, prefill_replays: bool = True):
    """Frame steps across both quiet stretches, each vocoder step replaying
    a graph when its index is a multiple of `replays_every` (0: never), with
    a prefill (its vocoder step always replaying) before every third.
    Returns (ctx, spans, the share the construction gives)."""
    spans, t, n, held = [], 10.5, 0, 0
    while t < 39.0:
        if QUIET[0][1] - 1.0 < t < QUIET[1][0] + 0.5:
            t = QUIET[1][0] + 0.5
        if n % 3 == 0:
            spans += [("step.prefill", t, t + 0.05, TID), ("codec.step", t + 0.03, t + 0.04, TID)]
            if prefill_replays:
                spans.append(("codec.replay", t + 0.032, t + 0.038, TID))
            t += 0.06
        name = "step.chunk" if frames_per_step > 1 else "step.stream"
        spans.append((name, t, t + 0.03 * frames_per_step, TID))
        for f in range(frames_per_step):
            c0 = t + 0.03 * f + 0.015
            spans.append(("codec.step", c0, c0 + 0.01, TID))
            if replays_every and n % replays_every == 0:
                spans.append(("codec.replay", c0 + 0.002, c0 + 0.008, TID))
                held += 1
            n += 1
        t += 0.03 * frames_per_step + 0.01
    ctx = {"quiet": QUIET, "t_open": QUIET[0][0], "t_close": QUIET[1][1]}
    return ctx, spans, 100.0 * held / n


@pytest.fixture
def program(monkeypatch):
    def install(spans):
        ring = Ring(spans)
        monkeypatch.setattr(program_spans, "recorder", lambda: ring)
    return install


READ = registry.reader("vocoder_graph_share")


@pytest.mark.parametrize("frames_per_step", [1, 4], ids=["stream", "chunk"])
@pytest.mark.parametrize("every, want", [(1, 100.0), (2, 50.0), (0, 0.0)])
def test_reads_the_share_of_served_vocoder_steps_that_replay(program, frames_per_step, every,
                                                              want):
    ctx, spans, exact = run(every, frames_per_step)
    program(spans)
    assert READ(ctx) == pytest.approx(exact)
    assert abs(exact - want) < 0.5


def test_prefill_steps_are_not_counted(program):
    ctx, with_prefill, exact = run(2, prefill_replays=True)
    program(with_prefill)
    a = READ(ctx)
    ctx, without, _ = run(2, prefill_replays=False)
    program(without)
    assert a == READ(ctx) == pytest.approx(exact)


def test_reads_none_without_spans(program, monkeypatch):
    ctx, spans, _ = run(1)
    program([s for s in spans if s[0] != "codec.step"])
    assert READ(ctx) is None
    program([])
    assert READ(ctx) is None
    monkeypatch.setattr(program_spans, "recorder", lambda: None)
    assert READ(ctx) is None


def test_reads_none_where_the_program_has_no_vocoder_graphs(program, monkeypatch):
    ctx, spans, _ = run(1)
    program(spans)
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        None if name == "smoltts_torch.codec.graph" else real(name, *a)))
    assert READ(ctx) is None
