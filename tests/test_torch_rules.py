"""PyTorch port, package rules: the port, chip_smoke.py and the port's
scripts import neither JAX nor the JAX package, importing the port builds
nothing, and every entry point refuses to fall back to the CPU when no
device is named."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "smoltts_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
    for p in PKG.rglob("*.py")
)


def test_imports_without_jax_in_a_fresh_interpreter():
    code = (
        "import sys, py_compile\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['smoltts_tpu'] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"py_compile.compile({str(ROOT / 'chip_smoke.py')!r}, doraise=True, cfile=None)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'smoltts_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "from smoltts_torch.ops import _build\n"
        "assert _build._lib is None\n"
        "print('ok')\n"
    )
    # -S skips `site` (and any sitecustomize that might import JAX first);
    # the parent's import path comes through PYTHONPATH instead.
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT)] + [p for p in sys.path if p]))
    res = subprocess.run([sys.executable, "-S", "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                              ROOT / "scripts" / "torch_k1_products.py",
                                                              ROOT / "scripts" / "torch_k3_threads.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_static_scan_has_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "smoltts_tpu")]
    assert not bad, f"{path}: {bad}"


def test_entry_points_raise_without_a_card(monkeypatch):
    from smoltts_torch.codec.config import MimiConfig
    from smoltts_torch.codec.mimi import decode_stream_init, init_mimi_params
    from smoltts_torch.config import tiny_debug_config
    from smoltts_torch.lm.decode import init_decode_state
    from smoltts_torch.lm.pipeline import make_flush_step, make_prefill_step, make_stream_step
    from smoltts_torch.lm.samplers import GenerationSettings
    from smoltts_torch.models.dual_ar import init_params
    from smoltts_torch.tokenizer import TokenConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, mcfg = tiny_debug_config(), MimiConfig()
    tok, settings = TokenConfig.smoltts_v0(), GenerationSettings()
    calls = [
        lambda: init_params(cfg),
        lambda: init_mimi_params(mcfg),
        lambda: init_decode_state(cfg, 1, 16),
        lambda: decode_stream_init(mcfg, 1),
        lambda: make_prefill_step(cfg, tok, settings, mcfg),
        lambda: make_stream_step(cfg, tok, settings, mcfg),
        lambda: make_flush_step(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # an explicit CPU device is honoured
    assert init_decode_state(cfg, 1, 16, device="cpu").k.device.type == "cpu"
