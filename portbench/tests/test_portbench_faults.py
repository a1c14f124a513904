"""A run with the timed path broken underneath, past the harness's look
for a card, at a tiny size on the CPU: `correct` comes out false once for
each fault a training cell can have (a round that returns its state
unchanged; half of the batch left out, the mean taken over the rest; the
exchange between ranks left out)."""
from __future__ import annotations

import time

import pytest

from portbench import cell as cell_mod
from portbench.tests import tiny

#: each tiny cell is held to the limits of the benchmark cell it stands for
LIMITS = {("caffe", 1): "caffenet.b256.tau5",
          ("caffe", 2): "caffenet.b256.tau5.x4",
          ("graph", 1): "alexnet_graph.b256.tau5"}


@pytest.fixture(autouse=True)
def _f32_policy():
    yield
    from sparknet_tpu_torch import precision
    precision.set_policy("float32")


def _cell(kind, chips=1):
    config, traffic = (tiny.caffe(precision="float32") if kind == "caffe"
                       else tiny.graph())
    return tiny.cell(kind, config, traffic, chips=chips,
                     limits_of=LIMITS[kind, chips])


def _run(cell, tmp_path):
    return cell_mod.run_rank(cell, 31, 0.3, False, 0, 1, "cpu", time.time(),
                             str(tmp_path), str(tmp_path / "kernels"))


def _trainer(kind):
    if kind == "caffe":
        from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
        return ParallelTrainer
    from sparknet_tpu_torch.parallel.graph_trainer import GraphTrainer
    return GraphTrainer


@pytest.mark.parametrize("kind", ["caffe", "graph"])
def test_a_round_that_leaves_its_state_unchanged(kind, tmp_path,
                                                 monkeypatch):
    import torch
    cls = _trainer(kind)
    orig = cls.train_round

    def frozen(self, state, *a, **kw):
        if kind == "caffe":
            saved = (state.flat_params.detach().clone(),
                     state.flat_momentum.clone())
            state, loss = orig(self, state, *a, **kw)
            with torch.no_grad():
                state.flat_params.copy_(saved[0])
                state.flat_momentum.copy_(saved[1])
            return state, loss
        _, loss = orig(self, state, *a, **kw)
        return state, loss

    monkeypatch.setattr(cls, "train_round", frozen)
    res = _run(_cell(kind), tmp_path)
    assert not res["correct"], res["checks"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("kind", ["caffe", "graph"])
def test_half_of_the_batch_left_out(kind, tmp_path, monkeypatch):
    if kind == "caffe":
        from sparknet_tpu_torch.parallel import trainer as tr
        orig = tr.value_and_grad

        def half(loss_fn, params, batch, gen=None):
            return orig(loss_fn, params, {k: v[:v.shape[0] // 2]
                                          for k, v in batch.items()}, gen)

        monkeypatch.setattr(tr, "value_and_grad", half)
    else:
        from sparknet_tpu_torch.parallel.graph_trainer import GraphTrainer
        from sparknet_tpu_torch.parallel.trainer import PlacedBatches
        orig = GraphTrainer._round

        def half(self, state, placed):
            cut = PlacedBatches({k: v[:, :v.shape[1] // 2]
                                 for k, v in placed.items()})
            return orig(self, state, cut)

        monkeypatch.setattr(GraphTrainer, "_round", half)
    res = _run(_cell(kind), tmp_path)
    assert not res["correct"], res["checks"]


def no_exchange_rank(rank, world, args, queue):
    """A spawned rank whose trainer leaves the τ-boundary average out."""
    from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
    ParallelTrainer._round_end = lambda self, state, work: None
    cell_mod.rank_main(rank, world, args, queue)


def test_the_exchange_between_ranks_left_out(tmp_path):
    """The several-card cell is CaffeNet's: its exchange left out."""
    res = cell_mod.spawn(_cell("caffe", chips=2), 31, 0.3, False, "cpu",
                         time.time(), str(tmp_path),
                         str(tmp_path / "kernels"), deadline_s=600,
                         target=no_exchange_rank)
    assert not res[0]["correct"], res[0]["checks"]


def test_two_ranks_with_the_exchange_are_correct(tmp_path):
    res = cell_mod.spawn(_cell("caffe", chips=2), 31, 0.3, False, "cpu",
                         time.time(), str(tmp_path),
                         str(tmp_path / "kernels"), deadline_s=600)
    assert res[0]["correct"], res[0]["checks"]
