"""PyTorch port, `utils/compare.py` against the JAX package's on `.npy`,
`.npz` and `.safetensors` dumps (the same verdicts and report lines), and
`utils/profiling.py`: `trace` writes a Chrome trace with the host spans
of its window merged in, `device_op_summary` sums a hand-written one."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from smoltts_tpu.utils import compare as jcmp
from smoltts_torch.io.safetensors import save_file
from smoltts_torch.utils import compare as tcmp
from smoltts_torch.utils.profiling import SPANS, device_op_summary, trace
from tests import torch_threads  # noqa: F401  (one intra-op thread)


def _dumps(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", a + 5e-7)
    np.save(tmp_path / "c.npy", a + 1.0)
    np.save(tmp_path / "d.npy", np.zeros((3,), np.float32))
    np.savez(tmp_path / "x.npz", p=a, q=2 * a)
    np.savez(tmp_path / "y.npz", p=a, r=2 * a)
    np.savez(tmp_path / "z.npz", p=a, q=2 * a + 1e-4, n=np.arange(5))
    np.savez(tmp_path / "w.npz", p=a, q=2 * a, n=np.arange(5) + 1)
    save_file({"p": a, "q": 2 * a}, tmp_path / "s.safetensors")
    save_file({"p": a, "q": 2 * a + 0.5}, tmp_path / "t.safetensors")
    save_file({"p": a, "q": (2 * a)[:4]}, tmp_path / "u.safetensors")
    return tmp_path


PAIRS = [("a.npy", "b.npy"), ("a.npy", "c.npy"), ("a.npy", "d.npy"), ("x.npz", "y.npz"),
         ("x.npz", "z.npz"), ("z.npz", "w.npz"), ("x.npz", "x.npz"),
         ("s.safetensors", "s.safetensors"), ("s.safetensors", "t.safetensors"),
         ("s.safetensors", "u.safetensors"), ("x.npz", "s.safetensors")]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_compare_main_equals_jax(tmp_path, capsys, pair):
    d = _dumps(tmp_path)
    args = [str(d / pair[0]), str(d / pair[1]), "--rtol", "1e-3", "--atol", "1e-3"]
    got = tcmp.main(args)
    got_out = capsys.readouterr().out
    ref = jcmp.main(args)
    assert got == ref and got_out == capsys.readouterr().out
    for name in pair:
        g, r = tcmp.load_dump(str(d / name)), jcmp.load_dump(str(d / name))
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(g[k], np.asarray(r[k]))


def test_compare_bf16_safetensors_and_unknown_suffix(tmp_path):
    x = torch.randn(4, 3).to(torch.bfloat16)
    save_file({"w": x}, tmp_path / "bf.safetensors")
    got = tcmp.load_dump(str(tmp_path / "bf.safetensors"))
    assert got["w"].dtype == np.float32
    np.testing.assert_array_equal(got["w"], x.float().numpy())
    with pytest.raises(ValueError, match="unsupported"):
        tcmp.load_dump(str(tmp_path / "x.pt"))


def test_trace_writes_a_chrome_trace(tmp_path):
    def worker():
        with SPANS.span("test.worker"):
            time.sleep(0.002)

    with SPANS.span("test.before"):
        pass
    with trace(str(tmp_path / "tr")) as d:
        with SPANS.span("test.outer"):
            torch.randn(64, 64) @ torch.randn(64, 64)
        with SPANS.span("test.probe"):
            with torch.profiler.record_function("test.probe_range"):
                pass
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    with SPANS.span("test.after"):
        pass
    assert d == str(tmp_path / "tr")
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # the window's host spans, one track per thread, on the trace's clock
    spans = {e["name"]: e for e in events
             if e.get("cat") == "host_span" and e["name"].startswith("test.")}
    assert sorted(spans) == ["test.outer", "test.probe", "test.worker"]
    assert spans["test.outer"]["tid"] != spans["test.worker"]["tid"]
    tracks = {e["tid"] for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {spans["test.outer"]["tid"], spans["test.worker"]["tid"]} <= tracks
    outer = spans["test.outer"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert outer["ts"] <= float(mm["ts"]) <= outer["ts"] + outer["dur"]
    # a profiled range inside a span lands inside it, to well under a
    # millisecond (the first range of a profile can take one to enter)
    probe = spans["test.probe"]
    (rng,) = [e for e in events if e.get("name") == "test.probe_range"]
    assert abs(float(rng["ts"]) - probe["ts"]) < 500
    assert abs(float(rng["ts"]) + float(rng["dur"]) - probe["ts"] - probe["dur"]) < 500
    assert device_op_summary(str(tmp_path / "tr")) == []  # no card: no kernel events
    assert device_op_summary(str(tmp_path / "none")) == []


def test_device_op_summary_sums_the_newest_trace(tmp_path):
    old = {"traceEvents": [{"cat": "kernel", "name": "stale", "dur": 1.0}]}
    (tmp_path / "old.pt.trace.json").write_text(json.dumps(old))
    past = time.time() - 100
    os.utime(tmp_path / "old.pt.trace.json", (past, past))
    events = [
        {"cat": "kernel", "name": "gemm", "ts": 0, "dur": 10.5},
        {"cat": "kernel", "name": "gemm", "ts": 20, "dur": 4.5},
        {"cat": "kernel", "name": "softmax", "ts": 30, "dur": 7.0},
        {"cat": "kernel", "name": "tiny", "ts": 40, "dur": 0.25},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100.0},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 50, "dur": 30.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 3.0},
    ]
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "new.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    assert device_op_summary(str(tmp_path)) == [("gemm", 15.0, 2), ("softmax", 7.0, 1),
                                                 ("tiny", 0.25, 1)]
    assert device_op_summary(str(tmp_path), top_k=1) == [("gemm", 15.0, 2)]
