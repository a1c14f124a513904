"""`GraphTrainer.place_batches`: how a graph round reaches the device.

- On the CPU a round is placed as it always was: each input cast to its
  placeholder's dtype (int8 pixels to float32), no bytes counted as
  crossing, no event, no slot; a `PlacedBatches` passes through; a leading
  dim other than τ and a missing input raise.
- The loop's round records carry `h2d_async_bytes` beside `h2d_bytes`: 0
  on the CPU; on a card every byte crosses through pinned staging on the
  copy stream, so the two are equal.
- On a card (`-m gpu`): rounds placed one ahead on another thread, as the
  loop's round-prep thread places them, with and without donated slots,
  train bit for bit as the same rounds placed inline and as rounds placed
  by blocking copies on the compute stream.
No JAX here: the file runs on the card's machine as it is.
"""
import json

import numpy as np
import pytest
import torch

from sparknet_tpu_torch.apps.graph_common import train_graph
from sparknet_tpu_torch.backend import GraphNet, build_mnist_graph
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.parallel.graph_trainer import GraphTrainer
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import PlacedBatches
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.logger import Logger

torch.set_num_threads(2)
TAU, LB = 2, 4


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _net(device):
    return GraphNet(build_mnist_graph(batch=LB, train_size=8),
                    device=device)


def _round(seed=0):
    """A round held as the benchmark's traffic holds it: int8 pixels, which
    cross in their host dtype and become the placeholder's float32 on the
    device (small values: the graph's lr is set for unit-scale inputs),
    and int32 labels."""
    r = np.random.default_rng(seed)
    return {"data": r.integers(-2, 3, (TAU, LB, 28, 28, 1)).astype(
                np.int8),
            "label": r.integers(0, 10, (TAU, LB, 1)).astype(np.int32)}


@pytest.fixture
def cpu_trainer(tmp_path):
    group = init_data_group("cpu", store_path=str(tmp_path / "store"),
                            rank=0, world_size=1)
    yield GraphTrainer(_net("cpu"), group, tau=TAU, donate_batches=True)
    group.close()


@pytest.mark.parametrize("case", ["host", "placed", "lead", "missing"])
def test_on_the_cpu_a_graph_round_is_placed_as_before(cpu_trainer, case):
    b = _round()
    if case == "host":
        placed = cpu_trainer.place_batches(b)
        assert isinstance(placed, PlacedBatches)
        assert sorted(placed) == ["data", "label"]
        assert placed["data"].dtype == torch.float32
        assert placed["label"].dtype == torch.int32
        for k, v in b.items():
            want = torch.from_numpy(v).to(placed[k].dtype)
            assert torch.equal(placed[k], want), k
        assert placed.nbytes == 0
        assert placed.ready is None and placed.slot is None
    elif case == "placed":
        placed = cpu_trainer.place_batches(b)
        assert cpu_trainer.place_batches(placed) is placed
    elif case == "lead":
        with pytest.raises(ValueError, match="leading dim"):
            cpu_trainer.place_batches({k: v[:1] for k, v in b.items()})
    else:
        del b["label"]
        with pytest.raises(ValueError, match="missing graph input"):
            cpu_trainer.place_batches(b)


def _graph_loop_records(tmp_path, device):
    r = np.random.default_rng(0)
    ds = ArrayDataset({"data": r.standard_normal((64, 28, 28, 1)).astype(
        np.float32), "label": r.integers(0, 10, (64, 1)).astype(np.int32)})
    cfg = RunConfig(tau=TAU, local_batch=LB, max_rounds=3, eval_every=0,
                    seed=0, workdir=str(tmp_path / "w"))
    jsonl = tmp_path / "graph.jsonl"
    log = Logger(echo=False, jsonl_path=str(jsonl))
    train_graph(cfg, build_mnist_graph(batch=LB, train_size=8), ds,
                logger=log, device=device)
    log.close()
    return [json.loads(l) for l in open(jsonl) if '"loss"' in l]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_the_graph_loop_records_the_bytes_that_crossed_async(tmp_path,
                                                             device):
    if device == "cuda":
        _need_card()
    rounds = _graph_loop_records(tmp_path, device)
    assert [r["step"] for r in rounds] == [0, 1, 2]
    crossed = TAU * LB * (28 * 28 * 1 * 4 + 4) if device == "cuda" else 0
    for r in rounds:
        assert r["h2d_bytes"] == crossed, r
        assert r["h2d_async_bytes"] == r["h2d_bytes"], r


@pytest.mark.gpu
@pytest.mark.parametrize("donate", [True, False])
def test_on_the_card_graph_rounds_placed_ahead_train_as_host_arrays(
        tmp_path, donate):
    """The loop's one-deep schedule on the card: round R+1 is placed on
    another thread (pinned staging, the copy stream, two donated slots or
    fresh buffers) while round R runs; losses and variables equal those of
    the same rounds placed inline, and of rounds placed by blocking copies
    on the compute stream, bit for bit."""
    from concurrent.futures import ThreadPoolExecutor
    _need_card()
    torch.backends.cudnn.deterministic = True
    group = init_data_group("cuda", store_path=str(tmp_path / "store"),
                            rank=0, world_size=1)
    n_rounds = 6
    try:
        runs = []
        for how in ("blocking", "inline", "ahead"):
            tr = GraphTrainer(_net("cuda"), group, tau=TAU,
                              donate_batches=donate)
            state = tr.init_state()
            losses = []
            with ThreadPoolExecutor(1) as pool:
                nxt = pool.submit(tr.place_batches, _round(0)) \
                    if how == "ahead" else None
                for rnd in range(n_rounds):
                    if how == "ahead":
                        b = nxt.result()
                        if rnd + 1 < n_rounds:
                            nxt = pool.submit(tr.place_batches,
                                              _round(rnd + 1))
                    elif how == "inline":
                        b = _round(rnd)
                    else:
                        on, n = tr._place_inputs(_round(rnd), TAU)
                        b = PlacedBatches(on, nbytes=n)
                    state, loss = tr.train_round(state, b)
                    if how == "ahead":
                        assert b.ready is not None and b.nbytes > 0
                        assert (b.slot is not None) == donate
                    crossed = 0 if how == "blocking" else tr.h2d_bytes
                    assert tr.h2d_bytes > 0
                    assert tr.h2d_async_bytes == crossed
                    losses.append(loss)
            runs.append(([float(x) for x in losses],
                         {k: v.detach().clone()
                          for k, v in state["variables"].items()}))
        assert all(np.isfinite(runs[0][0])), runs[0][0]
        for losses, variables in runs[1:]:
            assert losses == runs[0][0]
            assert sorted(variables) == sorted(runs[0][1])
            for k, v in variables.items():
                assert torch.equal(v, runs[0][1][k]), k
    finally:
        group.close()
        torch.backends.cudnn.deterministic = False
