"""The port's ShardedTrainer (`parallel/sharded.py`) against the JAX
package's, and the restores across every state layout.

The same numpy params and round batches go through the JAX
`ShardedTrainer(make_mesh(n), state_sharding=...)` on n CPU devices and
through the port's on n gloo ranks, spawned with torch.multiprocessing
(`tests/torch_zero_worker.py` imports torch and the port only). Nets:
TINY_MLP of `tests/test_parallel.py` and cifar10_quick at batch 10 (no
dropout). Held over 3 rounds of τ = 2:
  - "momentum" / "full" (ZeRO-1): losses and grad norms within rtol 1e-4,
    logical params and the one logical momentum within
    1e-4 * max |JAX| + 1e-6 (the port's data-parallel tolerance), eval
    accuracies exactly, and each rank's at-rest numel equal to the JAX
    ShardedTrainer's `per_device_state_bytes` over the itemsize. Three
    ranks on TINY_MLP leave leaves whole (no dim divisible by 3). The
    rounds are held to the JAX package's ZeRO semantics on its own round
    math (the ParallelTrainer's round, then the velocities averaged): on
    jax 0.9.0 the JAX ShardedTrainer's ZeRO rounds sum the workers'
    gradients, a fault of the reference pinned here;
  - "replicated": the JAX named-replicated trainer is red on jax 0.9.0
    (its `lax.scan` carry raises "varying manual axes do not match"), so
    the port's is held to the port's ParallelTrainer bit for bit and to
    the JAX ParallelTrainer (which the JAX package says it equals bit for
    bit) within the tolerances above.
Checkpoints: a logical per-shard step restores to the flat map of the
monolithic step, bit for bit; a port step restores into the JAX
ShardedTrainer and a JAX ZeRO loop's step into the port; and the restore
matrix holds every port trainer's `adapt_state` to the JAX trainers' on
steps of every layout, at the same world size and another (params exact,
momentum exact where the data groups map one to one).
"""
import dataclasses
import json
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
from sparknet_tpu.parallel import ShardedTrainer as JaxSharded
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.parallel.mesh import per_device_state_bytes
from sparknet_tpu.solver import SolverConfig as JaxSolverConfig

import torch_zero_worker
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps import train_loop
from sparknet_tpu_torch.model.net import (CompiledNet, params_from_jax,
                                          params_to_jax)
from sparknet_tpu_torch.parallel import mesh as port_mesh
from sparknet_tpu_torch.parallel import trainer as port_trainer
from sparknet_tpu_torch.parallel.mesh import DataGroup, init_data_group
from sparknet_tpu_torch.parallel.sharded import ShardedTrainer
from sparknet_tpu_torch.parallel.trainer import (ParallelTrainer,
                                                 reduce_momentum_rows)
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.logger import Logger
from test_parallel import TINY_MLP
from test_torch_train import jax_params, to_port_spec
from test_torch_trainer import SOLVER, SPAWN_TIMEOUT_S, _close, _rounds

torch.set_num_threads(2)

TAU = 2


def _spec(name):
    if name == "tiny_mlp":
        return net_from_prototxt(TINY_MLP)
    return jax_zoo.cifar10_quick(batch=10)


def _setup(name, world):
    jspec = _spec(name)
    jnet = JaxCompiledNet.compile(jspec)
    lb = 4 if name == "tiny_mlp" else 10
    rounds, _ = _rounds(jnet, TAU, lb * world, 3)
    ev = {k: v[0] for k, v in rounds[1].items()}
    jp = jax_params(jnet)
    tspec = to_port_spec(jspec)
    tnet = CompiledNet.compile(tspec)
    tp = {l: {p: t.numpy() for p, t in lp.items()}
          for l, lp in params_from_jax(tnet, jp, torch.device("cpu")).items()}
    return jspec, jnet, jp, tspec, tnet, tp, rounds, ev


def spawn(world, tmp_path, sub, spec, params, rounds, ev, setup,
          ckpt_dirs=None, restore=None):
    """Run torch_zero_worker on `world` gloo ranks; their npz results."""
    out = tmp_path / sub
    out.mkdir()
    args = (world, str(out / "store"), spec, params, rounds, ev, setup,
            str(out), ckpt_dirs, restore)
    ctx = mp.spawn(torch_zero_worker.run, args=args, nprocs=world,
                   join=False)
    deadline = SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        deadline -= 5
        if deadline <= 0:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _jax_run(tr, state, rounds, ev):
    out = {}
    for r, b in enumerate(rounds):
        out[f"acc/{r}"] = tr.evaluate(state, ev)
        state, loss = tr.train_round(state, b, jax.random.PRNGKey(r))
        out[f"loss/{r}"] = float(loss)
        for k, v in tr.last_health.items():
            out[f"{k}/{r}"] = np.asarray(v)
    return state, out


def _tree(res, kind, like):
    return {l: {p: torch.from_numpy(res[f"{kind}/{l}/{p}"]) for p in lp}
            for l, lp in like.items()}


def _check_scalars(got, want, n_rounds):
    for r in range(n_rounds):
        assert got[f"acc/{r}"] == want[f"acc/{r}"], r
        np.testing.assert_allclose(got[f"loss/{r}"], want[f"loss/{r}"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got[f"grad_norm/{r}"],
                                   want[f"grad_norm/{r}"], rtol=1e-4)
        for k in ("nonfinite", "nonfinite_by_worker"):
            np.testing.assert_array_equal(got[f"{k}/{r}"], want[f"{k}/{r}"])


ZERO_CASES = [("tiny_mlp", 2, "momentum"), ("tiny_mlp", 2, "full"),
              ("tiny_mlp", 3, "full"), ("cifar10_quick", 2, "momentum"),
              ("cifar10_quick", 2, "full")]


def _jax_zero_reference(jnet, jp, rounds, ev, world):
    """The ZeRO round of the JAX package's sharded.py, on its own round
    math: the JAX ParallelTrainer's τ worker-local steps and param
    average, then the workers' velocities averaged into one momentum
    (`lax.pmean`'s order: the sum over the rows, then a division)."""
    tr = JaxTrainer(jnet, JaxSolverConfig(**SOLVER), make_mesh(world),
                    tau=TAU)
    state = tr.state_from_params(jax.tree_util.tree_map(jnp.asarray, jp))
    out = {}
    for r, b in enumerate(rounds):
        out[f"acc/{r}"] = tr.evaluate(state, ev)
        state, loss = tr.train_round(state, b, jax.random.PRNGKey(r))
        out[f"loss/{r}"] = float(loss)
        for k, v in tr.last_health.items():
            out[f"{k}/{r}"] = np.asarray(v)
        mean = jax.tree_util.tree_map(
            lambda x: np.asarray(x).sum(0, dtype=np.float32)
            / np.float32(world), state.momentum)
        state = tr.place(dataclasses.replace(state, momentum=(
            jax.tree_util.tree_map(
                lambda m: np.broadcast_to(m, (world,) + m.shape), mean))))
    params = jax.tree_util.tree_map(np.asarray, tr.averaged_params(state))
    return out, params, mean


@pytest.mark.parametrize("name,world,mode", ZERO_CASES)
def test_zero_modes_match_the_jax_sharded_trainer(tmp_path, name, world,
                                                   mode):
    """The round against the JAX package's ZeRO semantics
    (`_jax_zero_reference`); the at-rest sizes and the checkpoint against
    the JAX ShardedTrainer itself. Its rounds are not the reference on
    jax 0.9.0 (`test_the_jax_zero_trainer_sums_the_workers_gradients`)."""
    jspec, jnet, jp, tspec, tnet, tp, rounds, ev = _setup(name, world)
    tr = JaxSharded(jnet, JaxSolverConfig(**SOLVER), make_mesh(world),
                    tau=TAU, state_sharding=mode)
    at_rest = per_device_state_bytes(tr.state_from_params(
        jax.tree_util.tree_map(jnp.asarray, jp)))
    want, params, momentum = _jax_zero_reference(jnet, jp, rounds, ev,
                                                 world)
    dirs = {"on": str(tmp_path / "on"), "off": str(tmp_path / "off")}
    res = spawn(world, tmp_path, "run", tspec, tp, rounds, ev,
                {"impl": "named", "state_sharding": mode, "solver": SOLVER},
                ckpt_dirs=dirs)
    for got in res:
        _check_scalars(got, want, len(rounds))
        assert int(got["at_rest/params"]) * 4 == at_rest["params"]
        assert int(got["at_rest/momentum"]) * 4 == at_rest["momentum"]
        for kind, ref in (("params", params), ("momentum", momentum)):
            conv = params_to_jax(tnet, _tree(got, kind, ref))
            for l in ref:
                for p in ref[l]:
                    _close(conv[l][p], ref[l][p])
    # every rank sees the same logical state
    for k in res[0]:
        np.testing.assert_array_equal(res[0][k], res[-1][k])
    if mode == "full":
        assert at_rest["params"] < sum(
            int(np.prod(x.shape)) * 4 for x in jax.tree.leaves(params))
    # the per-shard step is the monolithic step, bit for bit, and the
    # monolithic one is the worker's checkpoint_tree
    on, step_on, extra = ckpt.restore_flat(dirs["on"])
    off, step_off, extra_off = ckpt.restore_flat(dirs["off"])
    assert "shards" in ckpt._load_meta(os.path.join(dirs["on"], "step-3"))
    assert step_on == step_off == 3 and sorted(on) == sorted(off)
    for k in on:
        assert np.asarray(on[k]).dtype == np.asarray(off[k]).dtype, k
        np.testing.assert_array_equal(on[k], off[k])
        np.testing.assert_array_equal(off[k], res[0][f"ckpt/{k}"])
    for e in (extra, extra_off):
        assert (e["layout"], e["state_sharding"], e["tp"],
                e["n_devices"]) == ("logical", mode, 1, world)
    # the port's step restores into the JAX trainer as its own state
    back = tr.adapt_state(on, old_layout="logical")
    for kind, ref in (("params", params), ("momentum", momentum)):
        got = jax.tree_util.tree_map(np.asarray, getattr(back, kind))
        for l in ref:
            for p in ref[l]:
                np.testing.assert_array_equal(got[l][p],
                                              on[f"{kind}/{l}/{p}"])


def test_the_jax_zero_trainer_sums_the_workers_gradients():
    """A fault of the reference on jax 0.9.0, pinned: the JAX
    ShardedTrainer's ZeRO modes keep the params replicated (`P()`) inside
    shard_map, whose autodiff turns their implicit broadcast into a psum,
    so each worker steps with the SUM of the workers' gradients instead
    of its own (sharded.py says its τ steps are worker-local). With both
    workers on the same data, its round is the one-device round at twice
    the learning rate, not the one-device round; at one device it is the
    ParallelTrainer's. The port keeps the worker-local steps."""
    jnet = JaxCompiledNet.compile(net_from_prototxt(TINY_MLP))
    jp = jax_params(jnet)
    rounds, _ = _rounds(jnet, TAU, 4, 2)
    twice = [{k: np.concatenate([v, v], 1) for k, v in b.items()}
             for b in rounds]

    def losses(cls, n, batches, lr_mult=1.0, **kw):
        cfg = dict(SOLVER, base_lr=SOLVER["base_lr"] * lr_mult)
        tr = cls(jnet, JaxSolverConfig(**cfg), make_mesh(n), tau=TAU, **kw)
        st = tr.state_from_params(jax.tree_util.tree_map(jnp.asarray, jp))
        out = []
        for r, b in enumerate(batches):
            st, loss = tr.train_round(st, b, jax.random.PRNGKey(r))
            out.append(float(loss))
        return np.asarray(out)

    one = losses(JaxTrainer, 1, rounds)
    zero1 = losses(JaxSharded, 1, rounds, state_sharding="momentum")
    np.testing.assert_array_equal(zero1, one)
    zero2 = losses(JaxSharded, 2, twice, state_sharding="momentum")
    doubled = losses(JaxTrainer, 1, rounds, lr_mult=2.0)
    np.testing.assert_allclose(zero2, doubled, rtol=1e-4)
    assert np.abs(zero2 - one).max() > 100 * np.abs(zero2 - doubled).max()


@pytest.mark.parametrize("name", ["tiny_mlp", "cifar10_quick"])
def test_named_replicated_is_the_parallel_trainer(tmp_path, name):
    """Bit for bit against the port's ParallelTrainer; against the JAX
    ParallelTrainer within the tolerances (the JAX named-replicated
    trainer is red on jax 0.9.0: its scan carry's manual axes). Its
    checkpoint is the logical view of the replica one: params row 0,
    momentum one row per data group."""
    jspec, jnet, jp, tspec, tnet, tp, rounds, ev = _setup(name, 2)
    runs = {impl: spawn(2, tmp_path, impl, tspec, tp, rounds, ev,
                        {"impl": impl, "solver": SOLVER})
            for impl in ("shard_map", "named")}
    for a, b in zip(runs["shard_map"], runs["named"]):
        for k in a:
            if k.startswith(("ckpt/", "at_rest/")):
                continue
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k, v in b.items():
            if not k.startswith("ckpt/params/"):
                continue
            np.testing.assert_array_equal(v, a[k][0])
        for k, v in b.items():
            if k.startswith("ckpt/momentum/"):
                np.testing.assert_array_equal(v, a[k])
        assert b["ckpt/it"].shape == () and a["ckpt/it"].shape == (2,)
    jtr = JaxTrainer(jnet, JaxSolverConfig(**SOLVER), make_mesh(2), tau=TAU)
    state = jtr.state_from_params(jax.tree_util.tree_map(jnp.asarray, jp))
    state, want = _jax_run(jtr, state, rounds, ev)
    params = jax.tree_util.tree_map(np.asarray, jtr.averaged_params(state))
    momentum = jax.tree_util.tree_map(np.asarray, state.momentum)
    for rank, got in enumerate(runs["named"]):
        _check_scalars(got, want, len(rounds))
        conv = params_to_jax(tnet, _tree(got, "params", params))
        mom = params_to_jax(tnet, _tree(got, "momentum", params))
        for l in params:
            for p in params[l]:
                _close(conv[l][p], params[l][p])
                _close(mom[l][p], momentum[l][p][rank])


@pytest.mark.parametrize("mode", ["momentum", "full"])
def test_a_world_of_one_zero_run_is_the_replicated_run(tmp_path, mode):
    """At one rank the gather, the reduce-scatter and the division by 1 are
    exact: a ZeRO run is the ParallelTrainer's bit for bit, its at-rest
    state is the whole state, and "full" leaves the probe's element in
    `head`."""
    net = CompiledNet.compile(zoo.cifar10_quick(batch=4))
    g = init_data_group("cpu", store_path=str(tmp_path / "s"), rank=0,
                        world_size=1)
    try:
        r = np.random.default_rng(0)
        rounds = [{"data": r.standard_normal((TAU, 4, 32, 32, 3))
                   .astype(np.float32),
                   "label": r.integers(0, 10, (TAU, 4, 1)).astype(np.int32)}
                  for _ in range(3)]
        cfg = SolverConfig(**SOLVER)
        a, b = (ParallelTrainer(net, cfg, g, tau=TAU),
                ShardedTrainer(net, cfg, g, tau=TAU, state_sharding=mode))
        sa, sb = a.init_state(3), b.init_state(3)
        assert sb.flat_params.numel() == sa.flat_params.numel()
        assert sb.flat_momentum.numel() == sa.flat_momentum.numel()
        for i, batches in enumerate(rounds):
            la = a.train_round(sa, batches, (0, i))[1]
            lb = b.train_round(sb, batches, (0, i))[1]
            assert torch.equal(la, lb)
            for k in a.last_health:
                assert torch.equal(a.last_health[k], b.last_health[k])
            probe = train_loop.probe_value(sb, net)
            assert torch.equal(probe, train_loop.probe_value(sa, net))
            assert (sb.head is not None) == (mode == "full")
        pb, mb = b.averaged_params(sb), b.logical_momentum(sb)
        for l, lp in sa.params.items():
            for p, t in lp.items():
                assert torch.equal(pb[l][p], t.detach())
                assert torch.equal(mb[l][p], sa.momentum[l][p])
        ev = {k: v[0] for k, v in rounds[0].items()}
        assert a.evaluate(sa, ev) == b.evaluate(sb, ev)
        # `place`: the logical state held in this layout again, the
        # momentum cast to the velocity dtype
        placed = b.place(port_trainer.TrainState(
            pb, {l: {p: t.double() for p, t in lp.items()}
                 for l, lp in mb.items()}, sb.it, None, None))
        assert placed.it == sb.it
        assert torch.equal(placed.flat_params, sb.flat_params)
        assert torch.equal(placed.flat_momentum, sb.flat_momentum)
    finally:
        g.close()


def test_the_sharded_trainer_refuses_what_the_jax_one_refuses():
    net = CompiledNet.compile(to_port_spec(net_from_prototxt(TINY_MLP)))
    g2 = DataGroup(0, 2, torch.device("cpu"))
    for mode in ("momentum", "full"):
        with pytest.raises(NotImplementedError, match="tensor parallelism"):
            ShardedTrainer(net, SolverConfig(), g2, tp=2,
                           state_sharding=mode)
    with pytest.raises(ValueError, match="state_sharding"):
        ShardedTrainer(net, SolverConfig(), g2, state_sharding="typo")
    tr = ShardedTrainer(net, SolverConfig(), DataGroup(0, 1,
                                                       torch.device("cpu")),
                        state_sharding="momentum")
    with pytest.raises(NotImplementedError, match="relaunch"):
        tr.adapt_live(tr.init_state(0))
    with pytest.raises(NotImplementedError, match="relaunch"):
        tr.resized(2)


def test_resolve_trainer_impl_is_the_jax_loop_s(monkeypatch):
    from sparknet_tpu.apps.train_loop import resolve_trainer_impl as jres
    from sparknet_tpu.utils.config import RunConfig as JaxRunConfig
    cases = [({}, None), ({}, "named"), ({"trainer_impl": "shard_map"},
                                          "named"),
             ({"trainer_impl": "named", "state_sharding": "full"}, None)]
    for kw, env in cases:
        if env is None:
            monkeypatch.delenv("SPARKNET_TRAINER_IMPL", raising=False)
        else:
            monkeypatch.setenv("SPARKNET_TRAINER_IMPL", env)
        assert train_loop.resolve_trainer_impl(RunConfig(**kw)) == \
            jres(JaxRunConfig(**kw))
    monkeypatch.delenv("SPARKNET_TRAINER_IMPL", raising=False)
    for kw in ({"trainer_impl": "nope"},
               {"trainer_impl": "shard_map", "state_sharding": "momentum"},
               {"state_sharding": "momentum"}):
        for f, c in ((train_loop.resolve_trainer_impl, RunConfig),
                     (jres, JaxRunConfig)):
            with pytest.raises(ValueError):
                f(c(**kw))


# -- the train loop ------------------------------------------------------------


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    from sparknet_tpu_torch.data import cifar
    d = str(tmp_path_factory.mktemp("cifar"))
    cifar.write_synthetic(d, n_per_file=40)
    return d


def _port_loop(tmp_path, sub, cifar_dir, impl, max_rounds, ckdir=None,
               state_sharding="replicated", checkpoint_sharded="auto"):
    from sparknet_tpu_torch.apps import cifar_app
    wd = tmp_path / sub
    wd.mkdir(exist_ok=True)
    cfg = RunConfig(
        solver=SolverConfig(base_lr=0.01, momentum=0.9, weight_decay=0.004,
                            lr_policy="fixed"),
        tau=2, local_batch=4, eval_every=0, max_rounds=max_rounds,
        workdir=str(wd), seed=0, trainer_impl=impl, data_dir=cifar_dir,
        state_sharding=state_sharding, checkpoint_sharded=checkpoint_sharded,
        checkpoint_dir=str(ckdir or wd / "ck"), checkpoint_every=2,
        checkpoint_async=False)
    jsonl = str(wd / "m.jsonl")
    log = Logger(str(wd / "log.txt"), echo=False, jsonl_path=jsonl)
    try:
        state = train_loop.train(cfg, zoo.cifar10_quick(batch=4),
                                 *cifar_app.build_datasets(cfg),
                                 device="cpu", logger=log)
    finally:
        log.close()
    losses = [json.loads(l)["loss"] for l in open(jsonl) if '"loss"' in l]
    return losses, cfg, state, open(wd / "log.txt").read()


def test_the_loop_trains_every_named_mode_as_shard_map(tmp_path, cifar_dir):
    """train() with trainer_impl="named": every state sharding gives the
    shard_map run's losses at one rank, stamps the layout under the JAX
    keys, and resumes its own step exactly; a step of another layout
    resumes elastically."""
    ref, _, ref_state, _ = _port_loop(tmp_path, "ref", cifar_dir,
                                      "shard_map", 4)
    assert len(ref) == 4
    for mode in ("replicated", "momentum", "full"):
        got, cfg, _, log = _port_loop(tmp_path, mode, cifar_dir, "named", 4,
                                      state_sharding=mode)
        assert got == ref, mode
        assert "trainer ShardedTrainer" in log
        meta = json.load(open(os.path.join(cfg.checkpoint_dir, "step-4",
                                           "meta.json")))
        assert (meta["extra"]["layout"], meta["extra"]["state_sharding"],
                meta["extra"]["tp"]) == ("logical", mode, 1)
        # its own step at round 2 resumes exactly
        ck = tmp_path / f"{mode}_ck2"
        os.makedirs(ck)
        os.rename(os.path.join(cfg.checkpoint_dir, "step-2"), ck / "step-2")
        cont, _, _, log = _port_loop(tmp_path, f"{mode}_cont", cifar_dir,
                                     "named", 4, ckdir=ck,
                                     state_sharding=mode)
        assert cont == ref[2:] and "resumed from checkpoint round 2" in log
    # a replica step under the named trainer, and the reverse: elastic
    _, c_rep, _, _ = _port_loop(tmp_path, "rep2", cifar_dir, "shard_map", 2)
    cont, _, _, log = _port_loop(tmp_path, "x1", cifar_dir, "named", 4,
                                 ckdir=c_rep.checkpoint_dir)
    assert cont == ref[2:] and "ELASTIC resume from round 2" in log
    _, c_named, _, _ = _port_loop(tmp_path, "named2", cifar_dir, "named", 2)
    cont, _, _, log = _port_loop(tmp_path, "x2", cifar_dir, "shard_map", 4,
                                 ckdir=c_named.checkpoint_dir)
    assert cont == ref[2:] and "layout logical" in log


def test_a_jax_zero_loop_step_restores_into_the_port(tmp_path):
    """The JAX loop's "momentum" step (8 CPU devices: the path of
    test_sharded.py::test_zero1_loop_checkpoint_roundtrip) restores into
    the port's trainers: params exact, the one logical momentum as it is
    in every ZeRO mode and broadcast to the data groups otherwise."""
    from test_sharded import _run_loop
    _, cfg = _run_loop(tmp_path, "zm", "named", 2, state_sharding="momentum")
    flat, step, extra = ckpt.restore_flat(cfg.checkpoint_dir)
    assert (step, extra["layout"], extra["state_sharding"]) == \
        (2, "logical", "momentum")
    net = CompiledNet.compile(zoo.cifar10_quick(batch=4))
    g = DataGroup(0, 1, torch.device("cpu"))
    for tr in (ParallelTrainer(net, SolverConfig(), g),
               ShardedTrainer(net, SolverConfig(), g),
               ShardedTrainer(net, SolverConfig(), g,
                              state_sharding="momentum"),
               ShardedTrainer(net, SolverConfig(), g,
                              state_sharding="full")):
        st = tr.state_from_checkpoint(flat, extra)
        assert st.it == 4
        p = params_to_jax(net, tr.averaged_params(st))
        m = params_to_jax(net, tr.logical_momentum(st)
                          if isinstance(tr, ShardedTrainer) else st.momentum)
        for key, a in flat.items():
            if key == "it":
                continue
            kind, l, q = key.split("/")
            np.testing.assert_array_equal((p if kind == "params" else m)
                                          [l][q], a, err_msg=key)


# -- the restore matrix --------------------------------------------------------

#: source steps: (name, layout, tp, world, state sharding)
SOURCES = [("replica_tp1", "replica", 1, 2, "replicated"),
           ("replica_tp2", "replica", 2, 4, "replicated"),
           ("logical_replicated", "logical", 1, 2, "replicated"),
           ("logical_momentum", "logical", 1, 2, "momentum"),
           ("logical_full", "logical", 1, 2, "full")]
#: destination trainers: (name, impl, tp, state sharding, world sizes)
DESTS = [("parallel_tp1", "shard_map", 1, "replicated", (2, 1)),
         ("parallel_tp2", "shard_map", 2, "replicated", (4, 2)),
         ("named_replicated", "named", 1, "replicated", (2, 1)),
         ("named_momentum", "named", 1, "momentum", (2, 1)),
         ("named_full", "named", 1, "full", (2, 1))]


def _source_flat(jnet, layout, tp, world, sharding, seed=7):
    """A step of that layout holding seeded values: logical params P, one
    momentum row per data group (replicated) or one logical momentum."""
    r = np.random.default_rng(seed)
    P = {l: {p: r.standard_normal(x.shape).astype(np.float32)
             for p, x in lp.items()}
         for l, lp in jax_params(jnet).items()}
    n_data = world // tp
    M = {l: {p: r.standard_normal((n_data,) + x.shape).astype(np.float32)
             for p, x in lp.items()} for l, lp in P.items()}
    flat = {}
    tp_layers = {l.name for l in jnet.spec.layers
                 if l.type == "InnerProduct"
                 and l.inner_product.num_output % tp == 0} if tp > 1 else ()
    for l, lp in P.items():
        for p, x in lp.items():
            if layout == "logical":
                flat[f"params/{l}/{p}"] = x
                flat[f"momentum/{l}/{p}"] = (M[l][p] if sharding ==
                                             "replicated" else M[l][p][0])
                continue
            axis = 1 if p == "w" else 0
            prow, mrow = [], []
            for dev in range(world):
                d, m = divmod(dev, tp)
                take = ((lambda a: np.split(a, tp, axis=axis)[m])
                        if l in tp_layers else (lambda a: a))
                prow.append(take(x))
                mrow.append(take(M[l][p][d]))
            flat[f"params/{l}/{p}"] = np.stack(prow)
            flat[f"momentum/{l}/{p}"] = np.stack(mrow)
    flat["it"] = (np.asarray(6, np.int32) if layout == "logical"
                  else np.full((world,), 6, np.int32))
    return flat, P, M


def _virtual(monkeypatch, cls, net, rank, world, tp, **kw):
    """A port trainer at `rank` of `world` with no process group: the grid
    is built by hand (adapt_state runs no collective)."""
    d, m = divmod(rank, tp)
    cpu = torch.device("cpu")
    grid = port_mesh.ProcessGrid(
        DataGroup(rank, world, cpu), tp, DataGroup(d, world // tp, cpu),
        DataGroup(m, tp, cpu) if tp > 1 else None)
    monkeypatch.setattr(port_trainer, "make_grid", lambda g, t: grid)
    return cls(net, SolverConfig(), DataGroup(rank, world, cpu), tp=tp, **kw)


@pytest.mark.parametrize("dst", [d[0] for d in DESTS])
@pytest.mark.parametrize("src", [s[0] for s in SOURCES])
def test_restore_matrix(monkeypatch, src, dst):
    """Every rank's restored state equals the JAX trainer's `adapt_state`
    of the same step (its row of the replica state; the logical state, or
    this rank's data group's momentum row), bit for bit. Held to numpy as
    well: the params are the step's logical params (this rank's column
    shard under TP); a ZeRO step's one momentum is taken as it is by every
    trainer; rows of tp = 1 map one to one onto a worker-local trainer
    with as many data groups, and are reduced (`reduce_momentum_rows`,
    "norm_rescale") otherwise."""
    _, layout, old_tp, old_world, sharding = next(s for s in SOURCES
                                                 if s[0] == src)
    _, impl, tp, dst_sharding, worlds = next(d for d in DESTS if d[0] == dst)
    jspec = net_from_prototxt(TINY_MLP)
    jnet = JaxCompiledNet.compile(jspec)
    net = CompiledNet.compile(to_port_spec(jspec))
    flat, P, M = _source_flat(jnet, layout, old_tp, old_world, sharding)
    cls = ParallelTrainer if impl == "shard_map" else ShardedTrainer
    kw = {} if impl == "shard_map" else {"state_sharding": dst_sharding}
    jcls = JaxTrainer if impl == "shard_map" else JaxSharded
    zero = dst_sharding != "replicated"
    for world in worlds:
        n_data = world // tp
        jmesh = (make_mesh(world) if tp == 1 else
                 make_mesh(world, axis_names=("data", "model"),
                           shape=(n_data, tp)))
        want = jcls(jnet, JaxSolverConfig(), jmesh, **kw).adapt_state(
            flat, old_tp=old_tp, momentum_policy="norm_rescale",
            old_layout=layout)
        wp = jax.tree_util.tree_map(np.asarray, want.params)
        wm = jax.tree_util.tree_map(np.asarray, want.momentum)
        for rank in range(world):
            d, m = divmod(rank, tp)
            tr = _virtual(monkeypatch, cls, net, rank, world, tp, **kw)
            st = tr.state_from_checkpoint(
                flat, {"n_devices": old_world, "tp": old_tp,
                       "layout": layout, "state_sharding": sharding})
            assert st.it == 6
            if impl == "shard_map":   # this rank's row of the JAX state
                ep = {l: {p: a[rank] for p, a in lp.items()}
                      for l, lp in wp.items()}
                em = {l: {p: a[rank] for p, a in lp.items()}
                      for l, lp in wm.items()}
            else:                     # the logical state / this data group's
                ep = wp
                em = (wm if zero else {l: {p: a[d] for p, a in lp.items()}
                                       for l, lp in wm.items()})
            # the numpy statement of the momentum this rank must hold
            if sharding != "replicated":
                nm = {l: {p: a[0] for p, a in lp.items()}
                      for l, lp in M.items()}
            elif old_tp == 1 and tp == 1:
                nm = {l: {p: (a[d] if not zero and n_data == len(a)
                              else reduce_momentum_rows(a, "norm_rescale"))
                          for p, a in lp.items()} for l, lp in M.items()}
            else:
                nm = None

            def own(l, p, full):
                if impl == "shard_map" and l in tr._tp_layers:
                    return np.split(full, tp, axis=1 if p == "w" else 0)[m]
                return full

            if impl == "named" and zero:
                # this rank's shard (no process group here to gather it)
                def shard(tree, dtype=torch.float32):
                    return tr._own_shard(params_from_jax(
                        net, tree, torch.device("cpu")), dtype)
                if tr._full:
                    assert torch.equal(st.flat_params, shard(ep))
                    assert torch.equal(st.flat_params, shard(P))
                else:
                    gp = params_to_jax(net, st.params)
                    for l in P:
                        for p in P[l]:
                            np.testing.assert_array_equal(gp[l][p], P[l][p])
                assert torch.equal(st.flat_momentum, shard(em))
                if nm is not None:
                    assert torch.equal(st.flat_momentum, shard(nm))
                continue
            gp = params_to_jax(net, st.params)
            gm = params_to_jax(net, st.momentum)
            for l in ep:
                for p in ep[l]:
                    np.testing.assert_array_equal(gp[l][p], ep[l][p])
                    np.testing.assert_array_equal(gm[l][p], em[l][p])
                    np.testing.assert_array_equal(gp[l][p],
                                                  own(l, p, P[l][p]))
                    if nm is not None:
                        np.testing.assert_array_equal(gm[l][p],
                                                      own(l, p, nm[l][p]))

