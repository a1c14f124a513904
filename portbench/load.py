"""Finds a cell's files by the names `BENCHMARK.json` gives them.

  configuration   the `file` of the entry in `configs`
  traffic         traffic/<traffic>.json
  limits          limits/<workload>.json (each number the check compares
                  and its limit)
  metric          metrics/<metric>.py, whose `read(ctx)` returns the
                  metric's value or None when it finds nothing to read
  adapter         adapters/<backend>.py (the configuration's `backend`):
                  `Program`, the port's entry point for that kind of
                  configuration (`programs.py`)
  reference       reference/<backend>.py: what both sides need of that
                  kind of configuration (`reference/__init__.py`)
  traffic kind    kinds/<kind>.py (the traffic's `kind`): `check(traffic)`
                  and `make_round(config, traffic, seed, rank, rnd,
                  device)` (`inputs.py`)

A cell reports its end-to-end metrics (those with a `workloads` key only
where it lists the cell), and with --trace 1 the per-layer metrics that
list it, or have no `workloads` key and move an end-to-end metric the
cell reports.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
#: the checkout's root: BENCHMARK.json sits there
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]
    limits: Dict[str, float]


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, workload: str) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(ROOT / configs[w["config"]]["file"])
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    units = {m["name"]: m["unit"] for m in e2e + per_layer}
    return Cell(name=workload, config=config, traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m["name"] for m in e2e],
                per_layer=[m["name"] for m in per_layer], units=units,
                limits=_json(HERE / "limits" / f"{workload}.json"))


def metric_reader(name: str) -> Callable:
    """`read` of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _module(group: str, name: str):
    """`portbench.<group>.<name>`: <group>/<name>.py, or the module of that
    name already in `sys.modules`."""
    full = f"{__package__}.{group}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"no {group}/{name}.py in the benchmark") from None


def adapter(config: dict):
    """adapters/<backend>.py of a configuration."""
    return _module("adapters", config["backend"])


def reference(config: dict):
    """reference/<backend>.py of a configuration."""
    return _module("reference", config["backend"])


def kind(traffic: dict):
    """kinds/<kind>.py of a traffic mix."""
    return _module("kinds", traffic["kind"])
