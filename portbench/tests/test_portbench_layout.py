"""BENCHMARK.json against the benchmark's contract, and discovery by name:
every configuration, traffic mix, limits file and metric reader a cell
names is found."""
from __future__ import annotations

import ast
import json
import re

import pytest

from portbench import load

BENCH = load.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    for kind in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[kind]]
        assert len(ns) == len(set(ns))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_order_chips_and_pairs():
    assert CELLS == ["caffenet.b256.tau5", "alexnet_graph.b256.tau5",
                     "caffenet.b256.tau5.x4"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = load.find_cell(BENCH, cell)
    assert c.config["name"] in {x["name"] for x in BENCH["configs"]}
    assert callable(load.kind(c.traffic).make_round)
    assert callable(load.adapter(c.config).Program)
    assert callable(load.reference(c.config).loss)
    assert set(c.limits) == {"loss_gap", "grad_gap", "grad_unit_gap",
                             "momentum_gap", "change_gap"}
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    for name in c.end_to_end + c.per_layer:
        assert callable(load.metric_reader(name))


def test_per_layer_metrics_by_cell():
    got = {cell: load.find_cell(BENCH, cell).per_layer for cell in CELLS}
    common = {"prep_wait_ms", "step_mfu", "device_idle_pct", "forward_ms",
              "backward_ms", "solver_ms", "host_lead_ms"}
    assert set(got["caffenet.b256.tau5"]) == common | {
        "lrn_roofline_pct", "maxpool_bwd_roofline_pct"}
    assert set(got["alexnet_graph.b256.tau5"]) == common
    assert set(got["caffenet.b256.tau5.x4"]) == common | {"allreduce_ms",
                                                         "exchange_ms"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs_are_files_under_paths(entry):
    assert entry["file"].startswith("portbench/configs/")
    with open(load.ROOT / entry["file"]) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert entry["source"].startswith("https://")
    assert config["source"] == entry["source"]


def test_layers_share_one_name_each():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert layers["kernels"] == {"lrn_roofline_pct",
                                 "maxpool_bwd_roofline_pct"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p for p in load.HERE.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(load.HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "sparknet_tpu"}, path


@pytest.mark.parametrize("path", sorted(
    list((load.HERE / "reference").glob("*.py"))
    + list((load.HERE / "kinds").glob("*.py"))),
    ids=lambda p: str(p.relative_to(load.HERE)))
def test_the_reference_imports_nothing_of_the_port(path):
    """Nor do the traffic kinds, which the reference draws its rows
    through."""
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "sparknet_tpu_torch" not in tops
    text = path.read_text()
    assert "sparknet_tpu_torch" not in text.replace(
        "imports nothing of", "")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    from portbench.cell import forbidden_modules
    monkeypatch.setitem(sys.modules, "sparknet_tpu_torch_fake",
                        types.ModuleType("sparknet_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    before = forbidden_modules()
    assert "sparknet_tpu" not in before and "jax" not in before
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in forbidden_modules()
