"""PyTorch port, package rules: the port, chip_smoke.py and the port's
scripts import neither JAX nor the JAX package, nor the packages the card's
machine lacks; importing the port builds nothing; every entry point refuses
to fall back to the CPU when no device is named; and the CUDA sources share
one word-to-Gumbel mapping."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from tests import torch_threads  # noqa: F401  (one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "smoltts_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
    for p in PKG.rglob("*.py")
)
# JAX and the JAX package, then packages the card's machine does not have
BLOCKED = ("jax", "jaxlib", "smoltts_tpu", "safetensors", "tokenizers", "pydantic", "ml_dtypes",
           "transformers", "regex")


def test_imports_without_jax_in_a_fresh_interpreter():
    code = (
        "import sys, py_compile\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from smoltts_torch import SmolTTS\n"
        f"py_compile.compile({str(ROOT / 'chip_smoke.py')!r}, doraise=True, cfile=None)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}"
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
                                                              ROOT / "scripts" / "torch_k3_threads.py",
                                                              ROOT / "scripts" / "torch_k2_build.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_static_scan_has_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path}: {bad}"


def test_datasets_is_imported_only_inside_functions():
    """HF `datasets` is missing on the card's machine: the CLIs import it
    inside `main` (or the function that reads a dataset), never at a
    module's top level."""
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] == "datasets"], path


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from smoltts_torch import SmolTTS
    from smoltts_torch.codec.config import MimiConfig
    from smoltts_torch.codec.mimi import decode_stream_init, init_mimi_params, load_mimi
    from smoltts_torch.config import TrainingConfig, tiny_debug_config
    from smoltts_torch.data_pipeline.create_init import create_bytelevel_init
    from smoltts_torch.data_pipeline.encode_audio import MimiCodec
    from smoltts_torch.data_pipeline.encode_audio import main as encode_main
    from smoltts_torch.io.convert import convert
    from smoltts_torch.io.checkpoint import load_params
    from smoltts_torch.lm.decode import init_decode_state
    from smoltts_torch.lm.engine import DecodeEngine
    from smoltts_torch.lm.generate import generate_blocking, make_device_generator
    from smoltts_torch.lm.pipeline import (
        make_chunk_step, make_flush_step, make_prefill_step, make_stream_step,
    )
    from smoltts_torch.lm.samplers import GenerationSettings
    from smoltts_torch.models.dual_ar import init_params
    from smoltts_torch.ops.quant_gate import run_quant_gates, run_quant_gates_cached
    from smoltts_torch.parallel.launch import run_ranks
    from smoltts_torch.parallel.mesh import Mesh, init_distributed
    from smoltts_torch.server.app import load_core
    from smoltts_torch.server.settings import ServerSettings
    from smoltts_torch.tokenizer import TokenConfig
    from smoltts_torch.train.checkpoint import CheckpointManager
    from smoltts_torch.train.main import main as train_main
    from smoltts_torch.train.trainer import TrainState, train_loop

    saver = CheckpointManager(str(tmp_path / "ckpt"), run_name="run")  # one process: no device
    saver.mesh = Mesh(1, 2)  # ...and then a rank of a mesh, whose device None means CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # never a download here
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
        lambda: make_chunk_step(cfg, tok, settings, mcfg, 8),
        lambda: make_device_generator(cfg, tok, settings, 8),
        lambda: generate_blocking({}, cfg, tok, settings, [np.zeros((cfg.num_rows, 4), np.int32)]),
        lambda: DecodeEngine({}, cfg, tok, settings, num_slots=1, max_seq_len=16),
        # no file is read before the device check
        lambda: SmolTTS(tmp_path / "missing"),
        lambda: load_params(tmp_path / "missing", cfg),
        lambda: load_mimi(tmp_path / "missing.safetensors"),
        lambda: load_core(ServerSettings(checkpoint_dir=str(tmp_path / "missing"))),
        # the device is checked before any download is tried
        lambda: load_core(ServerSettings(model_id="jkeisling/smoltts_v0")),
        # training, the quant gates and conversion
        lambda: train_main(["--config", str(tmp_path / "missing.json")]),
        lambda: train_loop(cfg, TrainingConfig(), None, None, []),
        lambda: run_quant_gates(cfg, tok, settings, mcfg, {}, {}, {}, {}, int8=True, kv8=True),
        lambda: run_quant_gates_cached(cfg, tok, settings, mcfg, {}, {}, {}, {}, int8=True,
                                       kv8=True, cache_path=str(tmp_path / "gates.json")),
        lambda: convert(tmp_path / "missing", tmp_path / "missing.json", tmp_path / "out"),
        # the data pipeline
        lambda: MimiCodec({}, mcfg),
        lambda: create_bytelevel_init(tmp_path / "init", cfg),
        lambda: encode_main(["--dataset-path", str(tmp_path / "missing"), "--out-path",
                             str(tmp_path / "codes"), "--mimi-path", str(tmp_path / "m.st")]),
        # the parallel layer: no process group is joined, no rank is spawned
        lambda: init_distributed("127.0.0.1:1", 1, 0),
        lambda: run_ranks(print, 2),
        lambda: train_main(["--config", str(tmp_path / "missing.json"), "--multihost"]),
        lambda: train_main(["--config", str(tmp_path / "missing.json"), "--coordinator",
                            "127.0.0.1:1", "--num-processes", "2", "--process-id", "0"]),
        # checkpoints on a mesh: no collective, no file
        lambda: CheckpointManager(str(tmp_path / "mesh_ckpt"), mesh=Mesh(1, 2)),
        lambda: saver.save(TrainState({}, None, 5)),
        lambda: CheckpointManager.load(str(tmp_path / "missing"), TrainingConfig(),
                                       mesh=Mesh(1, 2)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not torch.distributed.is_initialized()
    for name in ("gates.json", "out", "init", "codes", "mesh_ckpt", "ckpt/run/step_000005"):
        assert not (tmp_path / name).exists(), name
    # an explicit CPU device is honoured
    assert init_decode_state(cfg, 1, 16, device="cpu").k.device.type == "cpu"


def test_one_word_to_gumbel_mapping():
    """K1's gumbel() and K3's sampler both map a Philox word to noise through
    common.cuh's gumbel_word, the top 23 bits at their bin centres. The old
    24-bit mapping gave u = 1 (and +inf noise) in its last bin."""
    csrc = PKG / "csrc"
    common = (csrc / "common.cuh").read_text()
    sampling = (csrc / "sampling.cu").read_text()
    fast_loop = (csrc / "fast_loop.cu").read_text()
    defs = re.findall(r"float\s+gumbel_word\s*\(", common + sampling + fast_loop)
    assert len(defs) == 1 and re.search(r"float\s+gumbel_word\s*\(", common)
    assert "((float)(w >> 9) + 0.5f) * (1.0f / 8388608.0f)" in common
    body = common[common.index("float gumbel(") :]
    assert "return gumbel_word(r.x);" in body[: body.index("\n}")]
    assert "gumbel_word(" in sampling and "gumbel(seed" in fast_loop
    for src in (common, sampling, fast_loop):
        assert ">> 8)" not in src and "16777216" not in src

    w = np.uint32(0xFFFFFFFF)
    old = (np.float32(w >> np.uint32(8)) + np.float32(0.5)) * np.float32(1.0 / 16777216.0)
    new = (np.float32(w >> np.uint32(9)) + np.float32(0.5)) * np.float32(1.0 / 8388608.0)
    assert old == np.float32(1.0)
    assert np.float32(0.0) < new < np.float32(1.0)
    words = np.array([0, 511, 512, 0x80000000, 0xFFFFFE00, 0xFFFFFFFF], np.uint32)
    u = ((words >> np.uint32(9)).astype(np.float32) + np.float32(0.5)) * np.float32(1.0 / 8388608.0)
    assert u.dtype == np.float32 and (u > 0).all() and (u < 1).all()
    assert np.isfinite(-np.log(-np.log(u))).all()


def test_port_reads_its_own_data_files(monkeypatch):
    """The MPEG encoder's prototype windows and the native audio source are
    the port's own copies, read from smoltts_torch/, never from the JAX
    package's directory."""
    from smoltts_torch.io import mpeg
    from smoltts_torch.native import audio_io

    loaded = []
    real_load = np.load
    monkeypatch.setattr(np, "load", lambda path, *a, **k: loaded.append(Path(path)) or real_load(path, *a, **k))
    window, _, _ = mpeg._prototype.__wrapped__()
    assert window.shape == (512,)
    assert loaded == [PKG / "io" / "pqmf_window_iso.npz"]
    assert (PKG / "io" / "pqmf_window.npz").exists()
    assert audio_io._SRC == PKG / "native" / "audio.c" and audio_io._SRC.exists()
    for path in PKG.rglob("*.py"):
        assert "smoltts_tpu" not in "".join(
            line for line in path.read_text().splitlines() if "Path(" in line or "open(" in line), path
