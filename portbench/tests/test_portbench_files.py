"""BENCHMARK.json and the files it names: every cell, configuration,
traffic, driver and metric loads and is found by its name; names, units
and keys keep to the contract's characters; nothing under portbench/
imports JAX or the JAX package, and the reference imports nothing of the
program."""

import ast
import json
import re

import pytest

from portbench import registry
from portbench.registry import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"] and len(BENCH["command"]) <= 32
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                      "program_counter", "host_clock")
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))
    assert "setup_s" in e2e


def test_every_cell_reports_what_it_must():
    """setup_s, another end-to-end metric and a per-layer metric in every
    cell, and each per-layer metric only where its end-to-end one is."""
    for name in CELLS:
        cell = registry.cell(BENCH, name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files_by_name(name):
    cell = registry.cell(BENCH, name)
    assert cell.config["name"] == cell.config_name and cell.config["reduced"] == []
    assert (HERE / "drivers" / f"{cell.traffic['driver']}.py").exists()
    assert callable(registry.driver(cell.traffic["driver"]).run)
    assert "limits" in cell.workload["check"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_each_metric_has_a_reader(metric):
    assert callable(registry.reader(metric))


def test_files_under_paths_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel) and len(rel) <= 200, rel


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    """Whole top-level names, compared before the first dot: the port's
    name begins with the JAX package's."""
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "smoltts_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "dataclasses", "math", "typing", "torch", "portbench"}, path
        assert not any(m.startswith("portbench.") and not m.startswith("portbench.reference")
                       for m in _imports(path)), path
