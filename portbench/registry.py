"""Finds every part of a cell by its name in BENCHMARK.json: the
configuration file, the traffic file, the cell's own file (its correctness
limits), the driver the traffic names and the reader of each metric.

    portbench/configs/<config>.json      (BENCHMARK.json gives the path)
    portbench/traffic/<traffic>.json     the mix and the driver's settings
    portbench/workloads/<cell>.json      the cell's comparison and limits
    portbench/drivers/<driver>.py        run(cell, seed, seconds, trace, t_start)
    portbench/metrics/<metric>.py        read(ctx) -> number or None
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its files loaded."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload_file = HERE / "workloads" / f"{name}.json"
    return Cell(
        name=name,
        chips=entry["chips"],
        config_name=conf["name"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic_name=entry["traffic"],
        traffic=json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        workload=json.loads(workload_file.read_text()) if workload_file.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def open_loop_cell(bench: dict, config: str, traffic: str, root: Path = ROOT) -> Cell:
    """A configuration under a traffic file that no cell names yet (the
    sweep for a sustained rate), with the limits of a cell of the same
    configuration for its check."""
    conf = next(c for c in bench["configs"] if c["name"] == config)
    sibling = next(w["name"] for w in bench["workloads"] if w["config"] == config)
    return Cell(name=f"{config}.{traffic}", chips=1, config_name=config,
                config=json.loads((root / conf["file"]).read_text()), traffic_name=traffic,
                traffic=json.loads((HERE / "traffic" / f"{traffic}.json").read_text()),
                workload=json.loads((HERE / "workloads" / f"{sibling}.json").read_text()),
                end_to_end=[], per_layer=[])


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """The driver module of a traffic's `driver` kind."""
    return _module(HERE / "drivers" / f"{kind}.py", f"portbench.drivers.{kind}")


def reader(metric: str):
    """The reader of a metric: `read(ctx)`."""
    return _module(HERE / "metrics" / f"{metric}.py", f"portbench.metrics.{metric}").read
