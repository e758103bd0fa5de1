"""The engine driver at a tiny size on the CPU (the program's plain path):
a sound run is correct, and a run whose timed path is broken underneath is
not: a token altered where it is produced, a frame step that returns its
state unchanged. The card test runs a cell through the command."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import registry
from portbench.registry import ROOT
from portbench.tests.tiny import tiny_cell


def run_tiny(cell, seconds=2.0, seed=2**31 + 77):
    torch.set_num_threads(2)
    return registry.driver("engine").run(cell, seed, seconds, False, time.perf_counter(),
                                         device="cpu")


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_a_sound_run_is_correct_and_reads_its_metrics(loop):
    res = run_tiny(tiny_cell(loop))
    assert res.attempted > 0 and res.failed == 0
    assert all(n.ok for n in res.numbers), [(n.name, n.value, n.limit) for n in res.numbers]
    for name in ("audio_s_per_s", "first_audio_ms_p95", "frame_interval_ms_p95",
                 "engine_step_ms", "serve_mfu", "setup_s"):
        v = registry.reader(name)(res.ctx)
        assert v is not None and 0 < v < float("inf"), name
    if loop == "open":
        assert all(r.due is not None for r in res.ctx["requests"])


def _altered(fn):
    def frame(*a, **kw):
        out = fn(*a, **kw)
        codes = out.audio_codes.clone()
        codes[:, 3] = (codes[:, 3] + 1) % 2048
        tokens = out.tokens.clone()
        tokens[:, 4] = codes[:, 3]
        return out._replace(audio_codes=codes, tokens=tokens)
    return frame


def _unchanged(fn):
    def decode_frame(params, cfg, token_cfg, settings, state, *a, **kw):
        _, out = fn(params, cfg, token_cfg, settings, state, *a, **kw)
        return state, out
    return decode_frame


@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    import smoltts_torch.lm.decode as D
    import smoltts_torch.lm.pipeline as P

    if fault == "token_altered":
        monkeypatch.setattr(D, "_frame_from_hidden", _altered(D._frame_from_hidden))
    else:
        monkeypatch.setattr(P, "decode_frame", _unchanged(P.decode_frame))
    res = run_tiny(tiny_cell())
    bad = [n.name for n in res.numbers if not n.ok]
    assert "token_gap" in bad, [(n.name, n.value) for n in res.numbers]


@pytest.mark.card
def test_a_cell_runs_on_the_card_through_the_command():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2147483999", "--seconds", "5", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and line["metrics"]


def run_tiny_train(seconds=1.0, seed=2**31 + 5):
    from portbench.tests.tiny import tiny_train_cell

    torch.set_num_threads(2)
    return registry.driver("train").run(tiny_train_cell(), seed, seconds, False,
                                        time.perf_counter(), device="cpu")


def test_a_sound_train_run_is_correct_and_reads_its_metrics():
    res = run_tiny_train()
    assert all(n.ok for n in res.numbers), [(n.name, n.value, n.limit) for n in res.numbers]
    assert res.attempted > 0
    assert registry.reader("train_tokens_per_s")(res.ctx) > 0
    assert registry.reader("train_mfu")(res.ctx) > 0


def test_a_train_step_that_leaves_half_the_batch_out_is_not_correct(monkeypatch):
    import smoltts_torch.train.trainer as T

    batch_to = T.batch_to
    monkeypatch.setattr(T, "batch_to", lambda batch, device: {
        k: v[: len(v) // 2] for k, v in batch_to(batch, device).items()})
    bad = [n.name for n in run_tiny_train().numbers if not n.ok]
    assert {"loss_gap", "grad_gap"} & set(bad), bad


def test_a_train_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    from smoltts_torch.train.optim import AdamW

    monkeypatch.setattr(AdamW, "step", lambda self, grads=None: torch.zeros(()))
    res = run_tiny_train()
    bad = {n.name: n.value for n in res.numbers if not n.ok}
    assert bad.get("update_gap") == pytest.approx(1.0), bad


def test_a_sound_library_run_is_correct_and_reads_its_metrics():
    from portbench.tests.tiny import tiny_library_cell

    torch.set_num_threads(2)
    res = registry.driver("library").run(tiny_library_cell(), 2**31 + 9, 6.0, False,
                                         time.perf_counter(), device="cpu")
    assert res.attempted > 0 and res.failed == 0
    assert all(n.ok for n in res.numbers), [(n.name, n.value, n.limit) for n in res.numbers]
    for name in ("audio_s_per_s", "first_audio_ms_p95", "frame_interval_ms_p95", "serve_mfu"):
        assert 0 < registry.reader(name)(res.ctx) < float("inf"), name


def test_the_served_control_is_not_correct():
    """The reference one step below the stated precisions (int4 weights and
    caches, fp8 dense weights), read at a sound run's prompts and served
    tokens, fails the tiny cell's limits."""
    from portbench import check
    from portbench.tests.tiny import tiny_cell

    cell = tiny_cell()
    res = run_tiny(cell)
    prec = check.stated_precision(cell.config)
    streams = check.sample(res.ctx["finished"], 3, 1)
    ref = check.reference_models(cell.config, 2**31 + 77, "cpu", prec)
    ctl = check.reference_models(cell.config, 2**31 + 77, "cpu", prec.lower())
    got = check.readings(*ref, streams, control=ctl)
    limits = cell.workload["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got


def test_the_training_control_is_not_correct():
    """The reference with every product on fp8 inputs, in the program's
    place, fails the tiny training cell's limits."""
    from portbench import check_train
    from portbench.tests.tiny import tiny_train_cell

    cell, res = tiny_train_cell(), run_tiny_train()
    c = res.ctx
    ctl = check_train.reference_readings(cell.config, 2**31 + 5, c["pool"], c["step_seeds"],
                                         "cpu", lower=True)
    got = check_train.gaps(ctl, c["ref"])
    limits = cell.workload["check"]["limits"]
    assert any(got[k] > limits[k] for k in limits), got
