"""The port's tensor parallelism (the column-parallel InnerProduct of
`model/layers.py` and `ParallelTrainer(tp=...)`) against the JAX package's
("data", "model") mesh.

Ranks are gloo processes spawned with torch.multiprocessing
(`tests/torch_zero_worker.py`, torch and the port only); rank r sits at
data index r // tp and model index r % tp, the JAX package's device order.
  - DP x TP 2 x 2 on 4 ranks, cifar10_quick at batch 2 (ip1 and ip2 both
    column-sharded), 3 rounds against the JAX ParallelTrainer on
    `make_mesh(4, ("data", "model"), (2, 2))`: losses within rtol 1e-4,
    the logical params within rtol 1e-3 and atol 5e-4 (the bound of
    test_parallel.py::test_tp_trajectory_matches_dp_exactly, for the
    reason its docstring gives: a 1-ulp drift can flip a ReLU or max-pool
    decision that 3 rounds of momentum SGD amplify), eval accuracy within
    abs 1e-6, and `checkpoint_tree` key for key in shape against the JAX
    trainer's replica state;
  - TP alone (1 x 2) on TINY_MLP against the JAX trainer, and the sharded
    trainer's "replicated" TP run bit for bit against ParallelTrainer's;
  - one step's gradients at tp = 2 against the one-rank gradients: exact
    after the fix-up, while the raw shard gradients are x tp (the
    convention this port pins: the gather's backward is a reduce-scatter).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.parallel import ParallelTrainer as JaxTrainer
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.solver import SolverConfig as JaxSolverConfig

import torch_zero_worker
from sparknet_tpu_torch.model.layers import tp_shards_layer
from sparknet_tpu_torch.model.net import (CompiledNet, params_from_jax,
                                          params_to_jax)
from sparknet_tpu_torch.solver import value_and_grad
from test_torch_sharded import _jax_run, _setup, _tree, spawn
from test_torch_train import jax_params, to_port_spec
from test_torch_trainer import SOLVER, SPAWN_TIMEOUT_S

torch.set_num_threads(2)

TAU = 2


def _tp_mesh(world, tp):
    return make_mesh(world, axis_names=("data", "model"),
                     shape=(world // tp, tp))


def _jax_tp(jnet, jp, rounds, ev, world, tp):
    tr = JaxTrainer(jnet, JaxSolverConfig(**SOLVER), _tp_mesh(world, tp),
                    tau=TAU)
    assert tr.tp == tp
    state = tr.state_from_params(jax.tree_util.tree_map(jnp.asarray, jp))
    state, want = _jax_run(tr, state, rounds, ev)
    params = jax.tree_util.tree_map(np.asarray, tr.averaged_params(state))
    return tr, state, want, params


def test_the_sharding_convention_is_the_jax_package_s():
    from sparknet_tpu.model.layers import tp_shards_layer as jax_rule
    spec = jax_zoo.caffenet(batch=1, crop=67, n_classes=10)
    for tp in (1, 2, 4, 8, 3):
        for layer, jlayer in zip(to_port_spec(spec).layers, spec.layers):
            assert tp_shards_layer(layer, tp) == jax_rule(jlayer, tp)


def test_dp_x_tp_matches_the_jax_dp_x_tp_trainer(tmp_path):
    jspec = jax_zoo.cifar10_quick(batch=2)
    jnet = JaxCompiledNet.compile(jspec)
    r = np.random.default_rng(11)
    rounds = [{"data": r.standard_normal((TAU, 4, 32, 32, 3))
               .astype(np.float32),
               "label": r.integers(0, 10, (TAU, 4, 1)).astype(np.int32)}
              for _ in range(3)]
    ev = {k: v[0] for k, v in rounds[2].items()}
    jp = jax_params(jnet, seed=3)
    tspec = to_port_spec(jspec)
    tnet = CompiledNet.compile(tspec)
    tp = {l: {p: t.numpy() for p, t in lp.items()}
          for l, lp in params_from_jax(tnet, jp, torch.device("cpu")).items()}
    jtr, jstate, want, params = _jax_tp(jnet, jp, rounds, ev, 4, 2)
    assert {"ip1", "ip2"} <= jtr._tp_sharded_layers()
    res = spawn(4, tmp_path, "tp", tspec, tp, rounds, ev,
                {"tp": 2, "solver": SOLVER})
    shapes = {f"{kind}/{l}/{p}": np.shape(a)
              for kind in ("params", "momentum")
              for l, lp in getattr(jstate, kind).items()
              for p, a in lp.items()}
    shapes["it"] = np.shape(jstate.it)
    for got in res:
        for i in range(len(rounds)):
            np.testing.assert_allclose(got[f"loss/{i}"], want[f"loss/{i}"],
                                       rtol=1e-4)
            assert got[f"acc/{i}"] == pytest.approx(want[f"acc/{i}"],
                                                    abs=1e-6)
        conv = params_to_jax(tnet, _tree(got, "params", params))
        for l in params:
            for p in params[l]:
                np.testing.assert_allclose(conv[l][p], params[l][p],
                                           rtol=1e-3, atol=5e-4,
                                           err_msg=f"{l}/{p}")
        ck = {k[len("ckpt/"):]: np.shape(v) for k, v in got.items()
              if k.startswith("ckpt/")}
        assert ck == shapes
    # the replica rows: a sharded layer's row r is rank r's column shard
    w = res[0]["ckpt/params/ip1/w"]
    assert w.shape == (4, 1024, 32)
    np.testing.assert_array_equal(np.concatenate([w[0], w[1]], axis=1),
                                  res[0]["params/ip1/w"].T)
    np.testing.assert_array_equal(w[0], w[2])


def test_tp_alone_matches_jax_and_the_sharded_trainer(tmp_path):
    """1 x 2 on TINY_MLP (ip1 16 and ip2 4 outputs, both sharded): the port
    within rtol 1e-4 of the JAX trainer; the sharded trainer's
    "replicated" TP run equal to ParallelTrainer's, its logical checkpoint
    the gathered params and one momentum row per data group."""
    jspec, jnet, jp, tspec, tnet, tparams, rounds, ev = _setup("tiny_mlp", 1)
    _, _, want, params = _jax_tp(jnet, jp, rounds, ev, 2, 2)
    runs = {impl: spawn(2, tmp_path, impl, tspec, tparams, rounds, ev,
                        {"impl": impl, "tp": 2, "solver": SOLVER})
            for impl in ("shard_map", "named")}
    for got in runs["shard_map"]:
        for i in range(len(rounds)):
            np.testing.assert_allclose(got[f"loss/{i}"], want[f"loss/{i}"],
                                       rtol=1e-4)
            np.testing.assert_allclose(got[f"grad_norm/{i}"],
                                       want[f"grad_norm/{i}"], rtol=1e-4)
            assert got[f"acc/{i}"] == want[f"acc/{i}"]
        conv = params_to_jax(tnet, _tree(got, "params", params))
        for l in params:
            for p in params[l]:
                np.testing.assert_allclose(conv[l][p], params[l][p],
                                           rtol=1e-4, atol=1e-6)
    for a, b in zip(runs["shard_map"], runs["named"]):
        for k in a:
            if not k.startswith(("ckpt/", "at_rest/")):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for l, lp in params.items():
            for p in lp:
                np.testing.assert_array_equal(
                    b[f"ckpt/params/{l}/{p}"],
                    params_to_jax(tnet, _tree(b, "params", params))[l][p])
                assert b[f"ckpt/momentum/{l}/{p}"].shape == \
                    (1,) + params[l][p].shape


def test_the_tp_gradient_is_exact_and_a_factor_of_tp_is_caught(tmp_path):
    """One step of cifar10_quick at tp = 2 (one data group): after
    `_fix_tp_grads` every gradient is the one-rank gradient; before it a
    sharded layer's (ip1, ip2) is tp times that — the gather's backward is
    a reduce-scatter, the convention pinned here — and a replicated
    layer's (the convolutions) holds only its own shard's term, tp times,
    so neither is the whole gradient. A fix-up that was skipped, applied
    twice, or averaged where it must sum, is off by tp and fails."""
    jspec = jax_zoo.cifar10_quick(batch=4)
    jnet = JaxCompiledNet.compile(jspec)
    net = CompiledNet.compile(to_port_spec(jspec))
    params = {l: {p: t.numpy() for p, t in lp.items()}
              for l, lp in params_from_jax(net, jax_params(jnet),
                                           torch.device("cpu")).items()}
    r = np.random.default_rng(2)
    batch = {"data": r.standard_normal((4, 32, 32, 3)).astype(np.float32),
             "label": r.integers(0, 10, (4, 1)).astype(np.int32)}
    ctx = mp.spawn(torch_zero_worker.grads,
                   args=(2, str(tmp_path / "store"), to_port_spec(jspec),
                         params, batch, 2, str(tmp_path)),
                   nprocs=2, join=False)
    deadline = SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        deadline -= 5
        if deadline <= 0:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two ranks did not finish")
    loss, want = value_and_grad(
        net.loss_fn(),
        {l: {p: torch.from_numpy(v).requires_grad_(True)
             for p, v in lp.items()} for l, lp in params.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tp_layers = {l.name for l in net.spec.layers if tp_shards_layer(l, 2)}
    assert tp_layers == {"ip1", "ip2"}
    for rank in range(2):
        got = np.load(tmp_path / f"grads{rank}.npz")
        assert float(got["loss"]) == pytest.approx(float(loss), rel=1e-6)
        for l, lp in want.items():
            for p, g in lp.items():
                g = g.numpy()
                tol = 1e-5 * np.abs(g).max() + 1e-8
                fixed, raw = got[f"fixed/{l}/{p}"], got[f"raw/{l}/{p}"]
                assert np.abs(fixed - g).max() <= tol, (l, p)
                if l in tp_layers:
                    assert np.abs(raw - 2 * g).max() <= 2 * tol, (l, p)
                else:
                    assert np.abs(raw - g).max() > 100 * tol, (l, p)
                    assert np.abs(raw - 2 * g).max() > 100 * tol, (l, p)
