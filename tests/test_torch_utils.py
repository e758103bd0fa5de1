"""PyTorch port, `utils/compare.py` against the JAX package's on `.npy`,
`.npz` and `.safetensors` dumps (the same verdicts and report lines), and
`utils/profiling.py`: `trace` writes a Chrome trace, `device_op_summary`
sums a hand-written one."""

import json
import os
import time

import numpy as np
import pytest
import torch

from smoltts_tpu.utils import compare as jcmp
from smoltts_torch.io.safetensors import save_file
from smoltts_torch.utils import compare as tcmp
from smoltts_torch.utils.profiling import device_op_summary, trace


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
    with trace(str(tmp_path / "tr")) as d:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert d == str(tmp_path / "tr")
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
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
