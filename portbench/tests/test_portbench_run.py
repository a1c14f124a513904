"""A run end to end on the CPU at a tiny size, past the harness's look for
a card: the program's own loop through the plain routes, the window, the
check against the reference, and the result line; device metrics fail
rather than fall back; four gloo ranks run the several-card path."""
from __future__ import annotations

import json
import time
from types import SimpleNamespace

import pytest

from portbench import cell as cell_mod
from portbench.tests import tiny

SEED = 2 ** 31 + 77  # past 32 signed bits: seeds of any size must work


def _run(cell, tmp_path, seconds=0.5, trace=False, seed=SEED):
    return cell_mod.run_rank(cell, seed, seconds, trace, 0, 1, "cpu",
                             time.time(), str(tmp_path),
                             str(tmp_path / "kernels"))


@pytest.fixture(autouse=True)
def _f32_policy():
    yield
    from sparknet_tpu_torch import precision
    precision.set_policy("float32")


@pytest.mark.parametrize("kind", ["caffe", "graph"])
def test_a_tiny_cpu_run_is_correct(kind, tmp_path):
    config, traffic = (tiny.caffe(precision="float32") if kind == "caffe"
                       else tiny.graph())
    res = _run(tiny.cell(kind, config, traffic,
                         limits_of="alexnet_graph.b256.tau5"), tmp_path)
    assert res["correct"], res["checks"]
    assert res["timed_rounds"] >= 1 and res["failed"] == 0
    assert res["forbidden"] == []
    assert set(res["metrics"]) == {"train_img_per_s", "setup_s"}
    assert res["metrics"]["train_img_per_s"]["value"] > 0


def test_the_result_line(tmp_path):
    from portbench.run import assemble
    config, traffic = tiny.graph()
    c = tiny.cell("g", config, traffic, limits_of="alexnet_graph.b256.tau5")
    line = assemble(c, [_run(c, tmp_path)], trace=False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["device"] == {"platform": "gpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "grad_unit_gap",
                                  "momentum_gap", "change_gap"}
    for c_ in line["checks"].values():
        assert set(c_) == {"value", "limit"}
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("metric", ["device_idle_pct", "step_mfu",
                                    "lrn_roofline_pct"])
def test_device_metrics_fail_without_a_card(metric, tmp_path):
    config, traffic = tiny.caffe(precision="float32")
    c = tiny.cell("c", config, traffic, limits_of="alexnet_graph.b256.tau5",
                  per_layer=[metric])
    with pytest.raises(RuntimeError, match="device metric|no card"):
        _run(c, tmp_path, trace=True)


def test_prep_wait_reads_the_loops_telemetry(tmp_path):
    config, traffic = tiny.graph()
    c = tiny.cell("g", config, traffic, limits_of="alexnet_graph.b256.tau5",
                  per_layer=["prep_wait_ms"])
    res = _run(c, tmp_path, trace=True)
    assert res["metrics"]["prep_wait_ms"]["value"] >= 0
    assert res["correct"]


def test_four_gloo_ranks(tmp_path):
    config, traffic = tiny.graph()
    c = tiny.cell("g4", config, traffic, chips=4,
                  limits_of="alexnet_graph.b256.tau5")
    res = cell_mod.spawn(c, SEED, 0.5, False, "cpu", time.time(),
                         str(tmp_path), str(tmp_path / "kernels"),
                         deadline_s=600)
    assert [r["rank"] for r in res] == [0, 1, 2, 3]
    assert res[0]["correct"], res[0]["checks"]
    assert len({r["timed_rounds"] for r in res}) == 1


def _ctx_of(rank_events, world=4):
    import torch
    return SimpleNamespace(world=world, device=torch.device("cuda"),
                           profile=SimpleNamespace(rank_events=rank_events,
                                                   rounds=2))


def test_allreduce_takes_each_collectives_least_waiting_rank():
    """Two rounds of (a big, a scalar) collective on two ranks: rank 0
    waits in round 0, rank 1 in round 1; the transfer is 1000 us."""
    from portbench.load import metric_reader
    read = metric_reader("allreduce_ms")
    r0 = [("ncclDevKernel_AllReduce", 10.0, 5000.0), ("gemm", 5.0, 99.0),
          ("ncclDevKernel_AllReduce", 6000.0, 20.0),
          ("ncclDevKernel_AllReduce", 9000.0, 1000.0),
          ("ncclDevKernel_AllReduce", 10500.0, 30.0)]
    r1 = [("ncclDevKernel_AllReduce", 4010.0, 1000.0),
          ("ncclDevKernel_AllReduce", 6000.0, 20.0),
          ("ncclDevKernel_AllReduce", 7000.0, 3500.0),
          ("ncclDevKernel_AllReduce", 10500.0, 40.0)]
    # listed out of order: the reader pairs them by start time
    got = read(_ctx_of([r0, list(reversed(r1))], world=2))
    assert got == pytest.approx((1000 + 20 + 1000 + 30) / 1e3 / 2)
    # kernels that do not pair: the smallest rank's sum
    got = read(_ctx_of([r0, r1[:3]], world=2))
    assert got == pytest.approx((1000 + 20 + 3500) / 1e3 / 2)
    assert read(_ctx_of([r0], world=1)) is None


def _rank_counting_traces(rank, world, args, queue):
    """A rank whose per-layer reader reports how many ranks' device
    operations its profile holds."""
    from portbench import load
    load.metric_reader = lambda name: (
        lambda ctx: len(ctx.profile.rank_events))
    cell_mod.rank_main(rank, world, args, queue)


def test_traced_ranks_gather_every_ranks_operations(tmp_path):
    config, traffic = tiny.graph()
    c = tiny.cell("g4", config, traffic, chips=4,
                  limits_of="alexnet_graph.b256.tau5",
                  per_layer=["prep_wait_ms"])
    res = cell_mod.spawn(c, SEED, 0.3, True, "cpu", time.time(),
                         str(tmp_path), str(tmp_path / "kernels"),
                         deadline_s=600, target=_rank_counting_traces)
    assert res[0]["metrics"]["prep_wait_ms"]["value"] == 4
    assert res[0]["correct"], res[0]["checks"]
