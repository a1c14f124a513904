"""The port's ParallelTrainer against the JAX package's on meshes of 1 and 2.

The same numpy params (the JAX package's init), round batches and eval
batch go through the JAX `ParallelTrainer` on `make_mesh(n)` (CPU devices)
and through the port's trainer on n gloo ranks — a world of one in this
process, and two ranks spawned with torch.multiprocessing that join
through a FileStore (no port), import only torch and the port
(`tests/torch_trainer_worker.py`) and write npz files this process holds
against the JAX results. Nets: TINY_MLP of `tests/test_parallel.py` and
cifar10_quick (no dropout), in local_sgd (τ = 2) and sync_sgd (τ = 1).
Held: params after the rounds, each rank's momentum (never averaged),
the mean loss, grad_norm, nonfinite_by_worker (a NaN fed to rank 1 of
TINY_MLP in the last round flags rank 1 alone) and evaluate's accuracy.
Tolerance: max |port - JAX| <= 1e-4 * max |JAX| + 1e-6 per tensor, losses
and grad norms within rtol 1e-4 (matrix and convolution sums run in
another order); accuracies, nonfinite flags and the ranks they name
exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sparknet_tpu import net_from_prototxt
from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.parallel import ParallelTrainer as JaxTrainer
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.solver import SolverConfig as JaxSolverConfig

import torch_trainer_worker
from sparknet_tpu_torch.model.net import (CompiledNet, params_from_jax,
                                          params_to_jax)
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solver import SolverConfig
from test_parallel import TINY_MLP
from test_torch_train import jax_params, to_port_spec

torch.set_num_threads(2)

SOLVER = dict(base_lr=0.05, momentum=0.9, weight_decay=0.001)
SPAWN_TIMEOUT_S = 240


def _spec(name):
    if name == "tiny_mlp":
        return net_from_prototxt(TINY_MLP)
    return jax_zoo.cifar10_quick(batch=2)


def _rounds(jnet, tau, global_b, n_rounds, poison_rank=None, world=1):
    """Round batches [tau, global_b, ...] (and an eval batch); with
    poison_rank, NaN in that rank's block of the last round."""
    r = np.random.default_rng(5)
    rounds = []
    for i in range(n_rounds):
        b = {}
        for name, shape in jnet.input_shapes.items():
            full = (tau, global_b) + tuple(shape[1:])
            b[name] = (r.integers(0, shape[-1] if name != "label" else 4,
                                  full).astype(np.int32)
                       if jnet.input_dtypes[name] == "int32"
                       else r.standard_normal(full).astype(np.float32))
        rounds.append(b)
    if poison_rank is not None:
        lb = global_b // world
        rounds[-1]["data"][:, poison_rank * lb:(poison_rank + 1) * lb] = \
            np.nan
    ev = {k: v[0] for k, v in rounds[0].items()}
    return rounds, ev


def _jax_run(jspec, jp, rounds, ev, mode, n):
    jnet = JaxCompiledNet.compile(jspec)
    tau = rounds[0]["data"].shape[0]
    tr = JaxTrainer(jnet, JaxSolverConfig(**SOLVER), make_mesh(n), tau=tau,
                    mode=mode)
    state = tr.state_from_params(jax.tree_util.tree_map(jnp.asarray, jp))
    out = {}
    for r, b in enumerate(rounds):
        out[f"acc/{r}"] = tr.evaluate(state, ev)
        state, loss = tr.train_round(state, b, jax.random.PRNGKey(r))
        out[f"loss/{r}"] = float(loss)
        for k, v in tr.last_health.items():
            out[f"{k}/{r}"] = np.asarray(v)
    params = jax.tree_util.tree_map(np.asarray, tr.averaged_params(state))
    momentum = jax.tree_util.tree_map(np.asarray, state.momentum)
    return out, params, momentum


def _close(got, want):
    want = np.asarray(want)
    if not np.isfinite(want).all():
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        return
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-6


def _check(tnet, res, want, params, momentum, n_rounds):
    """`res`: one npz-like mapping per rank, port layouts."""
    for rank, got in enumerate(res):
        for r in range(n_rounds):
            assert got[f"acc/{r}"] == want[f"acc/{r}"], (rank, r)
            np.testing.assert_allclose(got[f"loss/{r}"], want[f"loss/{r}"],
                                       rtol=1e-4)
            np.testing.assert_allclose(got[f"grad_norm/{r}"],
                                       want[f"grad_norm/{r}"], rtol=1e-4)
            for k in ("nonfinite", "nonfinite_by_worker"):
                np.testing.assert_array_equal(got[f"{k}/{r}"],
                                              want[f"{k}/{r}"])
        for kind in ("params", "momentum"):
            tree = {l: {p: torch.from_numpy(got[f"{kind}/{l}/{p}"])
                        for p in lp} for l, lp in params.items()}
            conv = params_to_jax(tnet, tree)
            for l in params:
                for p in params[l]:
                    w = (params[l][p] if kind == "params"
                         else momentum[l][p][rank])
                    _close(conv[l][p], w)


CASES = [("tiny_mlp", "local_sgd"), ("tiny_mlp", "sync_sgd"),
         ("cifar10_quick", "local_sgd"), ("cifar10_quick", "sync_sgd")]


def _setup(name, mode, world, poison):
    jspec = _spec(name)
    jnet = JaxCompiledNet.compile(jspec)
    tau = 2 if mode == "local_sgd" else 1
    lb = jnet.input_shapes["data"][0] // 2 if name == "tiny_mlp" else 2
    rounds, ev = _rounds(jnet, tau, lb * world, 3,
                         poison_rank=world - 1 if poison else None,
                         world=world)
    jp = jax_params(jnet)
    tspec = to_port_spec(jspec)
    tnet = CompiledNet.compile(tspec)
    tp = {l: {p: t.numpy() for p, t in lp.items()}
          for l, lp in params_from_jax(tnet, jp, torch.device("cpu")).items()}
    return jspec, jp, tspec, tnet, tp, rounds, ev


@pytest.mark.parametrize("name,mode", CASES)
def test_world_of_one_matches_jax_mesh_of_one(tmp_path, name, mode):
    jspec, jp, tspec, tnet, tp, rounds, ev = _setup(name, mode, 1, False)
    want, params, momentum = _jax_run(jspec, jp, rounds, ev, mode, 1)
    torch_trainer_worker.run(0, 1, str(tmp_path / "store"), tspec, tp,
                             rounds, ev, mode, SOLVER, str(tmp_path))
    res = [np.load(tmp_path / "rank0.npz")]
    _check(tnet, res, want, params, momentum, len(rounds))


@pytest.mark.parametrize("name,mode", CASES)
def test_two_gloo_ranks_match_jax_mesh_of_two(tmp_path, name, mode):
    """Two spawned ranks. TINY_MLP's local_sgd run feeds rank 1 a NaN in
    its last round, so the attribution row names rank 1 on both sides
    (not cifar10_quick: a NaN pooling window routes its gradient nowhere
    in the port and somewhere in select-and-scatter, so which params turn
    NaN differs — ROADMAP §C)."""
    poison = mode == "local_sgd" and name == "tiny_mlp"
    jspec, jp, tspec, tnet, tp, rounds, ev = _setup(name, mode, 2, poison)
    want, params, momentum = _jax_run(jspec, jp, rounds, ev, mode, 2)
    if poison:
        assert list(want["nonfinite_by_worker/2"]) == [0.0, 1.0]
    ctx = mp.spawn(torch_trainer_worker.run,
                   args=(2, str(tmp_path / "store"), tspec, tp, rounds, ev,
                         mode, SOLVER, str(tmp_path)),
                   nprocs=2, join=False)
    deadline = SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        deadline -= 5
        if deadline <= 0:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the two ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    _check(tnet, res, want, params, momentum, len(rounds))
    if mode == "local_sgd":  # momentum stays on its rank
        key = next(k for k in res[0].files if k.startswith("momentum/"))
        assert not np.array_equal(res[0][key], res[1][key])


def test_group_mean_is_sum_then_divide(tmp_path):
    g = init_data_group("cpu", store_path=str(tmp_path / "s"), rank=0,
                        world_size=1)
    try:
        t = torch.tensor([1.0, 3.0])
        assert g.all_reduce_mean_(t) is t and t.tolist() == [1.0, 3.0]
        assert (g.rank, g.size, g.device.type) == (0, 1, "cpu")
    finally:
        g.close()
    assert not torch.distributed.is_initialized()


def test_unported_trainer_options_raise(tmp_path):
    net = CompiledNet.compile(to_port_spec(net_from_prototxt(TINY_MLP)))
    g = init_data_group("cpu", store_path=str(tmp_path / "s"), rank=0,
                        world_size=1)
    try:
        with pytest.raises(NotImplementedError, match="elastic"):
            ParallelTrainer(net, SolverConfig(), g, elastic_tau=True)
        with pytest.raises(NotImplementedError, match="tensor parallel"):
            ParallelTrainer(net, SolverConfig(), g, tp=2)
        with pytest.raises(NotImplementedError, match="resize"):
            ParallelTrainer(net, SolverConfig(), g).resized(2)
        with pytest.raises(ValueError, match="tau must be 1"):
            ParallelTrainer(net, SolverConfig(), g, tau=2, mode="sync_sgd")
        with pytest.raises(ValueError, match="iter_size"):
            ParallelTrainer(net, SolverConfig(iter_size=2), g)
        tr = ParallelTrainer(net, SolverConfig(), g, tau=3)
        with pytest.raises(ValueError, match="tau 3"):
            tr.train_round(tr.init_state(0),
                           {"data": np.zeros((2, 8, 6), np.float32),
                            "label": np.zeros((2, 8, 1), np.int32)}, 0)
    finally:
        g.close()
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        os.environ.pop("MASTER_ADDR", None)
        init_data_group("cpu", rank=0, world_size=2)
