"""The port's elastic training against the JAX package, on the CPU:
membership (`parallel/elastic.py`), per-worker τ and the elastic resume
(`parallel/trainer.py`), and the train loop's resize path, which in the
port always relaunches (`apps/train_loop.py`).

- Membership: the two `MembershipController`s, each with its own
  injected clock and `random.Random(0)`, read one heartbeat prefix through
  the same script of beats, backdated beats and polls (the scenarios of
  `tests/test_elastic.py`, with full-jitter re-probes): every event,
  epoch, membership, suspect table, audit record and τ budget is equal.
- `adapt_state`: the step of a JAX 4-device mesh (TINY_MLP with a float32
  and a bfloat16 velocity, cifar10_quick) adapted by the port at 1 and 2
  ranks under each momentum policy: params and momentum bit-equal to the
  JAX package's `adapt_state` (numpy on both sides); at 4 ranks each
  rank's own row, exact.
- Per-worker τ: two spawned gloo ranks run one TINY_MLP round per τ
  vector against a JAX `make_mesh(2)` elastic trainer: losses and grad
  norms within rtol 1e-4, params and momentum within 1e-4 × max |JAX| +
  1e-6 (the tolerances of `test_torch_trainer.py`: sums run in another
  order). A full vector equals the unmasked round, and all ones a τ = 1
  trainer (params, momentum, loss), bit for bit.
- The loop on one machine: JAX `train` on 2 devices evicts the nominal
  worker 1 (its beat backdated after round 2) and resizes live to 1, then
  adopts it back (1 → 2) and runs to round 8. The port: 2 gloo ranks both
  leave by ElasticRelaunch (exit 75) at the eviction boundary after
  writing the boundary step; 1 rank resumes elastically and leaves again
  at the rejoin boundary; 2 ranks resume and finish. Every round's loss
  within rtol 1e-4 of JAX's, the final params within 1e-4 × max |JAX| +
  1e-6.
- The same relaunch on the default layout ("auto"): the two ranks write
  the boundary step per shard and the relaunched rank resumes from it,
  every loss and resize event equal to the monolithic chain's.
- The loop over two machines (4 gloo ranks, `LOCAL_WORLD_SIZE=2`):
  machine 1's beats go stale; every rank raises at the same round and no
  boundary step is written; below `min_workers`, TrainingHealthError.
- The launch guard and the CLI's exit code 75.
- On four cards (`gpu`; skips here): the same relaunch with four NCCL
  ranks and a 2-rank resume, against the chain on four gloo CPU ranks.

Multi-process cases wait on their ranks with a deadline (a hang fails the
test, it never blocks the run).
"""
import json
import os
import pickle
import random
import subprocess
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sparknet_tpu import net_from_prototxt as jax_net_from_prototxt
from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.parallel import ParallelTrainer as JaxTrainer
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.parallel import elastic as jax_elastic
from sparknet_tpu.solver import SolverConfig as JaxSolverConfig
from sparknet_tpu.utils import checkpoint as jck
from sparknet_tpu.utils.config import ElasticConfig as JaxElasticConfig
from sparknet_tpu.utils.config import RunConfig as JaxRunConfig
from sparknet_tpu.utils.health import TrainingHealthError as JaxHealthError
from sparknet_tpu.utils.logger import Logger as JaxLogger

import torch_elastic_worker
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps.train_loop import train
from sparknet_tpu_torch.data.cifar import write_synthetic
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.model.net import CompiledNet, params_to_jax
from sparknet_tpu_torch.model.prototxt import net_from_prototxt
from sparknet_tpu_torch.obs.pod import worker_heartbeat_path
from sparknet_tpu_torch.parallel import elastic
from sparknet_tpu_torch.parallel.mesh import DataGroup
from sparknet_tpu_torch.parallel.trainer import (ParallelTrainer,
                                                 reduce_momentum_rows)
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.config import ElasticConfig, RunConfig
from sparknet_tpu_torch.utils.health import TrainingHealthError
from sparknet_tpu_torch.utils.heartbeat import HeartbeatWriter
from sparknet_tpu_torch.utils.logger import Logger
from test_parallel import TINY_MLP
from test_torch_train import jax_params

torch.set_num_threads(2)
SPAWN_TIMEOUT_S = 240
SOLVER = dict(base_lr=0.05, momentum=0.9, weight_decay=0.001,
              lr_policy="fixed")


def _spawn(fn, args, nprocs):
    ctx = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s (a rank hangs)")


def _load(out_dir, name, world):
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{name}_rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _records(path):
    return [json.loads(line) for line in open(path)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-6


# -- membership: the same script through both controllers --------------------

class Clock:
    """An injected clock; `tick` steps advance it."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _beat(pod, worker, status="ok", age=0.0, **kv):
    p = worker_heartbeat_path(str(pod), worker)
    HeartbeatWriter(p, interval_s=0.0).beat(0, status=status, force=True,
                                            **kv)
    if age:
        rec = json.load(open(p))
        rec["t"] = time.time() - age
        json.dump(rec, open(p, "w"))


def _polls(k, dt=1.0):
    return [("tick", dt), ("poll",)] * k


SCENARIOS = {
    "single_missed_beat": dict(
        n=3, steps=[("beat", 1), ("beat", 2), ("poll",),
                    ("beat", 2, dict(age=1000))] + _polls(10)),
    "fresh_beat_clears_suspicion": dict(
        n=2, steps=[("beat", 1), ("poll",), ("beat", 1, dict(age=1000)),
                    ("tick", 1.0), ("poll",), ("beat", 1)] + _polls(4)),
    "done_is_a_graceful_leave": dict(
        n=2, steps=[("beat", 1), ("poll",), ("beat", 1, dict(status="done")),
                    ("tick", 1.0), ("poll",)]),
    "joiner_adopted": dict(
        n=1, steps=[("poll",), ("beat", 5)] + _polls(2)),
    "joiner_denied": dict(
        n=1, cfg=dict(rejoin="deny"),
        steps=[("poll",), ("beat", 7)] + _polls(3)),
    "stale_leftover_outside_range": dict(
        n=2, steps=[("beat", 9, dict(age=1000)), ("beat", 1), ("poll",)]
        + _polls(4)),
    "stale_leftover_inside_range": dict(
        n=3, steps=[("beat", 1), ("beat", 2, dict(age=1000)), ("poll",),
                    ("tick", 1.0), ("poll",), ("beat", 2)] + _polls(2)),
    "never_beating_worker_evicted": dict(n=2, steps=[("poll",)] + _polls(8)),
    "rate_limited_polls": dict(
        n=2, cfg=dict(poll_interval_s=5.0),
        steps=[("beat", 1), ("poll",), ("beat", 1, dict(age=1000))]
        + _polls(12) + [("poll_force",)]),
    "tau_budgets": dict(
        n=2, cfg=dict(tau_adapt=True),
        steps=[("beat", 0, dict(round_s=1.0)), ("beat", 1, dict(round_s=2.0)),
               ("poll",), ("tau", 4), ("beat", 1, dict(round_s=1.0)),
               ("poll_force",), ("tau", 4), ("beat", 1, dict(round_s=100.0)),
               ("poll_force",), ("tau", 4), ("beat", 2, dict(round_s=1.0)),
               ("poll_force",), ("tau", 4), ("tau", 7)]),
    "tau_budgets_skip_stale_and_timeless": dict(
        n=4, cfg=dict(tau_adapt=True, tau_min=2),
        steps=[("beat", 0, dict(round_s=0.5)), ("beat", 1, dict(round_s=1.5)),
               ("beat", 2), ("beat", 3, dict(round_s=9.0)), ("poll",),
               ("tau", 6), ("beat", 3, dict(round_s=9.0, age=1000)),
               ("poll_force",), ("tau", 6)]),
    "tau_adapt_off": dict(
        n=2, steps=[("beat", 0, dict(round_s=1.0)),
                    ("beat", 1, dict(round_s=5.0)), ("poll",), ("tau", 4)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_membership_controller_is_the_jax_packages(tmp_path, name):
    sc = SCENARIOS[name]
    pod = tmp_path / "pod"
    os.makedirs(pod)
    # the beats interleave with polls: each beat is written once and read
    # by both controllers
    port_seen, jax_seen = [], []
    port_clock, jax_clock = Clock(), Clock()
    cfg = dict(dict(stale_after_s=60.0, reprobe_backoff_s=2.0,
                    dead_probes=2, poll_interval_s=0.0), **sc.get("cfg", {}))
    port_c = elastic.MembershipController(
        ElasticConfig(enabled=True, **cfg), str(pod), self_worker=0,
        expected_workers=sc["n"], now=port_clock, rng=random.Random(0))
    jax_c = jax_elastic.MembershipController(
        JaxElasticConfig(enabled=True, **cfg), str(pod), self_worker=0,
        expected_workers=sc["n"], now=jax_clock, rng=random.Random(0))
    for i, step in enumerate(sc["steps"]):
        if step[0] == "beat":
            _beat(pod, step[1], **(step[2] if len(step) > 2 else {}))
            continue
        if step[0] == "tick":
            port_clock.t += step[1]
            jax_clock.t += step[1]
            continue
        for c, seen in ((port_c, port_seen), (jax_c, jax_seen)):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                if step[0] in ("poll", "poll_force"):
                    ev = c.poll(i, force=step[0] == "poll_force")
                    out = None if ev is None else (
                        ev.epoch, ev.alive, ev.dead, ev.joined, ev.reasons,
                        ev.n_workers)
                else:
                    out = c.tau_by_worker(step[1])
            seen.append({"step": i, "out": out, "epoch": c.epoch,
                         "members": sorted(c.members),
                         "suspect": {k: dict(v)
                                     for k, v in c._suspect.items()},
                         "audit": list(c.audit),
                         "warnings": [str(x.message) for x in w]})
    assert port_seen == jax_seen
    # each scenario reaches the outcome it is named for
    outs = [s["out"] for s in port_seen if s["out"] is not None]
    if name in ("single_missed_beat", "never_beating_worker_evicted",
                "done_is_a_graceful_leave"):
        assert outs and outs[0][2], port_seen
    if name in ("joiner_adopted", "stale_leftover_inside_range"):
        assert outs and outs[-1][3], port_seen
    if name == "joiner_denied":
        assert any(s["warnings"] for s in port_seen) and not outs
    if name == "tau_budgets":
        assert port_seen[1]["out"] == {"0": 4, "1": 3}


def test_elastic_relaunch_is_exit_75():
    e = elastic.ElasticRelaunch("why")
    assert isinstance(e, SystemExit)
    assert e.code == elastic.ELASTIC_RELAUNCH_EXIT == \
        jax_elastic.ELASTIC_RELAUNCH_EXIT == 75
    assert str(e) == str(jax_elastic.ElasticRelaunch("why"))


# -- adapt_state: a JAX 4-device step at 1, 2 and 4 port ranks ---------------

NETS = {"tiny_mlp": "float32", "tiny_mlp_bf16": "bfloat16",
        "cifar10_quick": "float32"}


def _jax_spec(name):
    if name.startswith("tiny_mlp"):
        return jax_net_from_prototxt(TINY_MLP)
    return jax_zoo.cifar10_quick(batch=2)


def _port_spec(name):
    if name.startswith("tiny_mlp"):
        return net_from_prototxt(TINY_MLP)
    return zoo.cifar10_quick(batch=2)


@pytest.fixture(scope="module")
def jax_steps4(tmp_path_factory):
    """{net: checkpoint dir}: two rounds of a JAX 4-device mesh, saved at
    step 2 (four different momentum rows)."""
    root = tmp_path_factory.mktemp("jax_steps4")
    out = {}
    r = np.random.default_rng(3)
    for name, vdt in NETS.items():
        if name.startswith("tiny_mlp"):
            x = r.standard_normal((256, 6)).astype(np.float32)
            ds = {"data": x, "label": (x.sum(-1, keepdims=True) > 0)
                  .astype(np.int32)}
            lb = 8
        else:
            ds = {"data": r.standard_normal((64, 3, 32, 32))
                  .astype(np.float32),
                  "label": r.integers(0, 10, (64, 1)).astype(np.int32)}
            lb = 2
        cfg = JaxRunConfig(
            model="prototxt-inline", n_devices=4, local_batch=lb, tau=2,
            max_rounds=2, eval_every=0, workdir=str(root / name),
            checkpoint_dir=str(root / name / "ck"), checkpoint_every=2,
            checkpoint_sharded="off", checkpoint_async=False,
            trainer_impl="shard_map",
            solver=JaxSolverConfig(**SOLVER, velocity_dtype=vdt))
        jax_train(cfg, _jax_spec(name), JaxArrayDataset(ds), None,
                  logger=JaxLogger(echo=False))
        out[name] = cfg.checkpoint_dir
    return out


def _port_trainer(name, rank, world):
    net = CompiledNet.compile(_port_spec(name))
    return ParallelTrainer(net, SolverConfig(
        **SOLVER, velocity_dtype=NETS[name]), DataGroup(
            rank, world, torch.device("cpu")), tau=2)


def _bits(a):
    """The exact values as float32 numpy: a bfloat16 leaf (a torch tensor
    or an ml_dtypes array) upcasts exactly, so equal upcasts are equal
    bits."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("policy", ["norm_rescale", "average", "zero"])
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("name", sorted(NETS))
def test_adapt_state_of_a_jax_4_device_step_is_the_jax_packages(
        jax_steps4, name, world, policy):
    flat, step, extra = ckpt.restore_flat(jax_steps4[name])
    assert extra["n_devices"] == 4 and step == 2
    jflat, _, _ = jck.restore_flat(jax_steps4[name])
    jnet = JaxCompiledNet.compile(_jax_spec(name))
    jtr = JaxTrainer(jnet, JaxSolverConfig(**SOLVER,
                                           velocity_dtype=NETS[name]),
                     make_mesh(world), tau=2)
    want = jtr.adapt_state(jflat, momentum_policy=policy)
    for rank in range(world):
        tr = _port_trainer(name, rank, world)
        got = tr.state_from_checkpoint(flat, extra, momentum_policy=policy)
        direct = tr.adapt_state(flat, momentum_policy=policy)
        assert got.it == direct.it == int(np.asarray(want.it)[rank]) == 4
        for kind in ("params", "momentum"):
            conv = params_to_jax(tr.net, getattr(got, kind))
            conv2 = params_to_jax(tr.net, getattr(direct, kind))
            wtree = getattr(want, kind)
            for l, lp in conv.items():
                for p, a in lp.items():
                    w = np.asarray(wtree[l][p])[rank]
                    np.testing.assert_array_equal(_bits(a), _bits(w),
                                                  err_msg=f"{kind}/{l}/{p}")
                    np.testing.assert_array_equal(_bits(conv2[l][p]),
                                                  _bits(w))
    if policy == "norm_rescale" and name == "tiny_mlp":
        # the reconstruction is the numpy function over the four rows
        rows = np.asarray(flat["momentum/ip1/w"])
        np.testing.assert_array_equal(
            params_to_jax(tr.net, got.momentum)["ip1"]["w"],
            reduce_momentum_rows(rows, "norm_rescale"))


@pytest.mark.parametrize("name", sorted(NETS))
def test_same_topology_restores_each_rank_s_own_row(jax_steps4, name):
    flat, _, extra = ckpt.restore_flat(jax_steps4[name])
    for rank in range(4):
        tr = _port_trainer(name, rank, 4)
        for st in (tr.state_from_checkpoint(flat, extra),
                   tr.adapt_state(flat, momentum_policy="zero")):
            for kind in ("params", "momentum"):
                conv = params_to_jax(tr.net, getattr(st, kind))
                for l, lp in conv.items():
                    for p, a in lp.items():
                        np.testing.assert_array_equal(
                            _bits(a), _bits(flat[f"{kind}/{l}/{p}"][rank]))


def test_reduce_momentum_rows_is_the_jax_packages():
    from sparknet_tpu.parallel.trainer import \
        reduce_momentum_rows as jax_reduce
    r = np.random.default_rng(0)
    rows = r.standard_normal((5, 7, 3)).astype(np.float32)
    for policy in ("norm_rescale", "average", "zero"):
        np.testing.assert_array_equal(reduce_momentum_rows(rows, policy),
                                      jax_reduce(rows, policy))
    np.testing.assert_array_equal(
        reduce_momentum_rows(np.zeros((2, 3), np.float32), "norm_rescale"),
        np.zeros(3, np.float32))


def test_tp_and_logical_steps_still_raise(jax_steps4):
    """ROADMAP A11 (ported; the name is kept from when these steps were
    refused): a step of another tp or layout restores
    through `adapt_state` as the JAX ParallelTrainer's does — here a tp = 2
    step of 4 devices made from the TINY_MLP step (device 2d + m holds
    column shard m of data group d's row) — and this tp = 1 step read as
    tp = 2 or as the logical layout is refused by its shapes, as is an
    unknown policy or layout."""
    flat, _, extra = ckpt.restore_flat(jax_steps4["tiny_mlp"])
    tr = _port_trainer("tiny_mlp", 0, 2)
    for bad in (dict(extra, tp=2), dict(extra, layout="logical"),
                dict(extra, layout="logical", state_sharding="momentum")):
        with pytest.raises(ValueError, match="shape"):
            tr.state_from_checkpoint(flat, bad)
    tp2 = {"it": np.asarray(flat["it"])}
    for key, a in flat.items():
        if key == "it":
            continue
        axis = 1 if key.endswith("/w") else 0     # both layers are sharded
        tp2[key] = np.stack([np.split(a[d], 2, axis=axis)[m]
                             for d in range(2) for m in range(2)])
    jnet = JaxCompiledNet.compile(jax_net_from_prototxt(TINY_MLP))
    want = JaxTrainer(jnet, JaxSolverConfig(), make_mesh(2)).adapt_state(
        tp2, old_tp=2)
    for st in (tr.state_from_checkpoint(tp2, dict(extra, tp=2)),
               tr.adapt_state(tp2, old_tp=2)):
        for kind in ("params", "momentum"):
            got = params_to_jax(tr.net, getattr(st, kind))
            for l, lp in getattr(want, kind).items():
                for p, a in lp.items():
                    np.testing.assert_array_equal(got[l][p],
                                                  np.asarray(a)[0])
                    if kind == "params":
                        np.testing.assert_array_equal(
                            got[l][p], flat[f"params/{l}/{p}"][0])
    with pytest.raises(ValueError, match="layout"):
        tr.adapt_state(flat, old_layout="rows")
    with pytest.raises(ValueError, match="momentum_policy"):
        tr.adapt_state(flat, momentum_policy="mean")


# -- per-worker τ: two gloo ranks against a JAX mesh of two -----------------

TAU, LB = 3, 4
VECTORS = ([3, 1], [3, 3], [1, 1])


@pytest.fixture(scope="module")
def tau_runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("tau_runs"))
    jnet = JaxCompiledNet.compile(jax_net_from_prototxt(TINY_MLP))
    jp = jax_params(jnet, seed=2)
    r = np.random.default_rng(7)
    data = r.standard_normal((TAU, 2 * LB, 6)).astype(np.float32)
    batches = {"data": data,
               "label": (data.sum(-1, keepdims=True) > 0).astype(np.int32)}
    tnet = CompiledNet.compile(net_from_prototxt(TINY_MLP))
    from sparknet_tpu_torch.model.net import params_from_jax
    tp = {l: {p: t.numpy() for p, t in lp.items()} for l, lp in
          params_from_jax(tnet, jp, torch.device("cpu")).items()}
    _spawn(torch_elastic_worker.tau_rounds,
           (2, os.path.join(out_dir, "store"), TINY_MLP, tp, batches,
            VECTORS, SOLVER, out_dir), 2)
    port = _load(out_dir, "tau", 2)
    jtr = JaxTrainer(jnet, JaxSolverConfig(**SOLVER), make_mesh(2), tau=TAU,
                     elastic_tau=True)
    want = {}
    for vec in VECTORS:
        st = jtr.state_from_params(jax.tree_util.tree_map(jnp.asarray, jp))
        st, loss = jtr.train_round(st, batches, jax.random.PRNGKey(1),
                                   tau_by_worker=vec)
        want[tuple(vec)] = {
            "loss": float(loss),
            "grad_norm": float(jtr.last_health["grad_norm"]),
            "params": jax.tree_util.tree_map(np.asarray, st.params),
            "momentum": jax.tree_util.tree_map(np.asarray, st.momentum),
            "it": np.asarray(st.it)}
    return tnet, port, want


@pytest.mark.parametrize("vec", VECTORS, ids=lambda v: "-".join(map(str, v)))
def test_tau_vector_round_matches_a_jax_mesh_of_two(tau_runs, vec):
    tnet, port, want = tau_runs
    w = want[tuple(vec)]
    for rank in range(2):
        got = port[rank][tuple(vec)]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
        assert got["it"] == int(w["it"][rank]) == TAU  # the nominal τ
        for kind in ("params", "momentum"):
            conv = params_to_jax(tnet, {
                l: {p: torch.from_numpy(a) for p, a in lp.items()}
                for l, lp in got[kind].items()})
            for l, lp in conv.items():
                for p, a in lp.items():
                    _close(a, w[kind][l][p][rank])


def _equal_states(a, b, it=True):
    assert a["loss"] == b["loss"]
    if it:
        assert a["it"] == b["it"]
    for kind in ("params", "momentum"):
        for l, lp in a[kind].items():
            for p, x in lp.items():
                np.testing.assert_array_equal(x, b[kind][l][p])


def test_full_tau_vector_is_the_unmasked_round_bit_for_bit(tau_runs):
    _, port, _ = tau_runs
    for rank in range(2):
        _equal_states(port[rank][(3, 3)], port[rank]["unmasked"])
        _equal_states(port[rank]["elastic_none"], port[rank]["unmasked"])


def test_all_ones_is_a_tau1_trainer_bit_for_bit(tau_runs):
    _, port, _ = tau_runs
    for rank in range(2):
        _equal_states(port[rank][(1, 1)], port[rank]["tau1"], it=False)
        # the schedule clock still advances by the nominal τ
        assert port[rank][(1, 1)]["it"] == TAU and \
            port[rank]["tau1"]["it"] == 1


def test_tau_by_worker_needs_an_elastic_tau_trainer(tmp_path):
    net = CompiledNet.compile(net_from_prototxt(TINY_MLP))
    g = DataGroup(0, 1, torch.device("cpu"))
    b = {"data": np.zeros((2, 8, 6), np.float32),
         "label": np.zeros((2, 8, 1), np.int32)}
    tr = ParallelTrainer(net, SolverConfig(), g, tau=2)
    with pytest.raises(ValueError, match="elastic_tau"):
        tr.train_round(tr.init_state(0), b, 0, tau_by_worker=[1])
    el = ParallelTrainer(net, SolverConfig(), g, tau=2, elastic_tau=True)
    with pytest.raises(ValueError, match="2 entries for 1 ranks"):
        el.train_round(el.init_state(0), b, 0, tau_by_worker=[1, 2])
    with pytest.raises(ValueError, match="local_sgd"):
        ParallelTrainer(net, SolverConfig(), g, tau=1, mode="sync_sgd",
                        elastic_tau=True)
    with pytest.raises(ValueError, match="local_sgd"):
        JaxTrainer(JaxCompiledNet.compile(jax_net_from_prototxt(TINY_MLP)),
                   JaxSolverConfig(), make_mesh(1), tau=1, mode="sync_sgd",
                   elastic_tau=True)


# -- the loop on one machine: evict, relaunch, resume, rejoin ----------------

ROUNDS, KILL_AT = 8, 2


def _tiny_data(n=512, seed=0):
    r = np.random.default_rng(seed)
    data = r.standard_normal((n, 6)).astype(np.float32)
    return {"data": data,
            "label": (data.sum(-1, keepdims=True) > 0).astype(np.int32)}


def _elastic_kw(**kw):
    return dict(dict(enabled=True, expected_workers=2, stale_after_s=120.0,
                     reprobe_backoff_s=0.0, dead_probes=2,
                     poll_interval_s=0.0, min_workers=1), **kw)


def _loop_cfg(root, n_dev, **kw):
    return dict(dict(model="prototxt-inline", n_devices=n_dev,
                     local_batch=8, tau=2, max_rounds=ROUNDS, eval_every=0,
                     workdir=str(root), checkpoint_dir=str(root / "ck"),
                     checkpoint_every=3, pod_dir=str(root / "pod"),
                     heartbeat_every_s=0.0, checkpoint_sharded="off"), **kw)


def _kill(pod, worker):
    p = worker_heartbeat_path(str(pod), worker)
    rec = json.load(open(p))
    rec["t"] = time.time() - 1e4
    json.dump(rec, open(p, "w"))


@pytest.fixture(scope="module")
def jax_elastic_run(tmp_path_factory):
    """JAX train on 2 devices: worker 1 evicted (backdated after round 2),
    resized live to 1, adopted back after the resize, to round 8."""
    root = tmp_path_factory.mktemp("jax_elastic")
    cfg = JaxRunConfig(**_loop_cfg(root, 2, trainer_impl="shard_map"),
                       elastic=JaxElasticConfig(**_elastic_kw()),
                       solver=JaxSolverConfig(**SOLVER))
    pod = root / "pod"
    hb1 = HeartbeatWriter(worker_heartbeat_path(str(pod), 1),
                          interval_s=0.0)
    hb1.beat(0, status="ok", round_s=0.01, force=True)
    shapes, killed, rejoined = [], [False], [False]

    def hook(rnd, state):
        shapes.append(np.asarray(
            state.momentum[list(state.momentum)[0]]["w"]).shape[0])
        if not killed[0] and rnd == KILL_AT:
            killed[0] = True
            _kill(pod, 1)
        elif killed[0] and not rejoined[0] and min(shapes) == 1:
            rejoined[0] = True
            hb1.beat(rnd, status="ok", round_s=0.01, force=True)
        elif not killed[0]:
            hb1.beat(rnd, status="ok", round_s=0.01, force=True)

    jspec = jax_net_from_prototxt(TINY_MLP)
    log = JaxLogger(str(root / "l.txt"), echo=False,
                    jsonl_path=str(root / "m.jsonl"))
    st = jax_train(cfg, jspec, JaxArrayDataset(_tiny_data()), None,
                   logger=log, round_hook=hook)
    log.close()
    jnet = JaxCompiledNet.compile(jspec)
    return {"records": _records(root / "m.jsonl"), "shapes": shapes,
            "params": jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                             st.params),
            "init": jax_params(jnet, seed=0)}


@pytest.fixture(scope="module")
def port_elastic_runs(tmp_path_factory, jax_elastic_run):
    """The port's relaunch chain from the JAX package's initial params:
    2 ranks (evicted: exit 75), 1 rank (resumed; the rejoin: exit 75),
    2 ranks (resumed to round 8)."""
    root = tmp_path_factory.mktemp("port_elastic")
    out = str(root)
    tnet = CompiledNet.compile(net_from_prototxt(TINY_MLP))
    from sparknet_tpu_torch.model.net import params_from_jax
    params = {l: {p: t.numpy() for p, t in lp.items()} for l, lp in
              params_from_jax(tnet, jax_elastic_run["init"],
                              torch.device("cpu")).items()}
    data = _tiny_data()
    base = _loop_cfg(root, None)

    def run(name, world, resume, plan):
        cfg = dict(base, workdir=str(root / name), resume=resume,
                   elastic=ElasticConfig(**_elastic_kw()),
                   solver=SolverConfig(**SOLVER))
        os.makedirs(cfg["workdir"], exist_ok=True)
        runs = [{"name": name, "cfg": cfg, "plan": plan}]
        if world == 1:
            torch_elastic_worker.loop(0, 1, 1, str(root / f"{name}.store"),
                                      TINY_MLP, params, data, runs, out)
        else:
            _spawn(torch_elastic_worker.loop,
                   (world, world, str(root / f"{name}.store"), TINY_MLP,
                    params, data, runs, out), world)
        return _load(out, name, world), [
            _records(os.path.join(cfg["workdir"], f"m{r}.jsonl"))
            for r in range(world)], [
            open(os.path.join(cfg["workdir"], f"l{r}.txt")).read()
            for r in range(world)]

    res = {}
    res["evict"] = run("evict", 2, False, {"beat1_until": KILL_AT,
                                           "kill1_at": KILL_AT})
    steps_after_evict = sorted(os.listdir(root / "ck"))
    res["rejoin"] = run("rejoin", 1, True, {"rejoin1": True})
    res["finish"] = run("finish", 2, True, {})
    res["steps_after_evict"] = steps_after_evict
    res["ck"] = str(root / "ck")
    res["params"] = params
    return res


def _resize_events(recs):
    return [r for r in recs if r.get("event") == "resize"]


def test_every_rank_relaunches_at_the_eviction_boundary(port_elastic_runs,
                                                        jax_elastic_run):
    ends, recs, _ = port_elastic_runs["evict"]
    assert [e["end"] for e in ends] == ["relaunch", "relaunch"]
    assert [e["code"] for e in ends] == [75, 75]
    evs = [_resize_events(r) for r in recs]
    assert evs[0] and [e["step"] for e in evs[0]] == \
        [e["step"] for e in evs[1]]
    assert evs[0][0]["dead"] == ["1"] and evs[0][0]["epoch"] == 1
    # the JAX package resized live at the same boundary
    jax_evs = _resize_events(jax_elastic_run["records"])
    assert jax_evs[0]["dead"] == ["1"]
    assert jax_evs[0]["step"] == evs[0][0]["step"]


def test_the_boundary_step_is_written_and_verified(port_elastic_runs):
    ends, recs, _ = port_elastic_runs["evict"]
    boundary = _resize_events(recs[0])[0]["step"]
    assert f"step-{boundary}" in port_elastic_runs["steps_after_evict"]
    path = os.path.join(port_elastic_runs["ck"], f"step-{boundary}")
    assert ckpt.verify(path)
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["extra"]["n_devices"] == 2
    # the evicted run logged every round before the boundary
    assert [r["step"] for r in recs[0] if "loss" in r] == \
        list(range(boundary))


def test_the_relaunch_resumes_elastically_and_leaves_at_the_rejoin(
        port_elastic_runs, jax_elastic_run):
    ends, recs, logs = port_elastic_runs["rejoin"]
    boundary = _resize_events(port_elastic_runs["evict"][1][0])[0]["step"]
    assert "ELASTIC resume from round %d: 2 devices" % boundary in logs[0]
    assert ends[0]["end"] == "relaunch" and ends[0]["code"] == 75
    ev = _resize_events(recs[0])
    assert len(ev) == 1 and ev[0]["joined"] == ["1"]
    jax_evs = _resize_events(jax_elastic_run["records"])
    assert jax_evs[1]["joined"] == ["1"]
    assert ev[0]["step"] == jax_evs[1]["step"]
    _, recs2, logs2 = port_elastic_runs["finish"]
    assert all("ELASTIC resume from round %d: 1 devices" % ev[0]["step"]
               in log for log in logs2)


def test_every_round_and_the_final_params_match_jax(port_elastic_runs,
                                                    jax_elastic_run):
    want = {r["step"]: r["loss"] for r in jax_elastic_run["records"]
            if "loss" in r}
    assert sorted(want) == list(range(ROUNDS))
    assert sorted(set(jax_elastic_run["shapes"])) == [1, 2]
    got = {}
    for phase in ("evict", "rejoin", "finish"):
        for r in port_elastic_runs[phase][1][0]:
            if "loss" in r:
                assert r["step"] not in got
                got[r["step"]] = r["loss"]
    assert sorted(got) == list(range(ROUNDS))
    for s in range(ROUNDS):
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4,
                                   err_msg=f"round {s}")
    ends = port_elastic_runs["finish"][0]
    assert [e["end"] for e in ends] == ["done", "done"]
    tnet = CompiledNet.compile(net_from_prototxt(TINY_MLP))
    for e in ends:
        assert e["state"]["it"] == ROUNDS * 2
        conv = params_to_jax(tnet, {
            l: {p: torch.from_numpy(a) for p, a in lp.items()}
            for l, lp in e["state"]["params"].items()})
        for l, lp in conv.items():
            for p, a in lp.items():
                _close(a, jax_elastic_run["params"][l][p])


@pytest.fixture(scope="module")
def port_elastic_auto(tmp_path_factory, port_elastic_runs):
    """The chain's first two runs on the default layout ("auto": the two
    ranks write a per-shard boundary step), from the same params."""
    root = tmp_path_factory.mktemp("port_elastic_auto")
    params = port_elastic_runs["params"]
    base = dict(_loop_cfg(root, None), checkpoint_sharded="auto")
    out = {}
    for name, world, resume, plan in (
            ("evict", 2, False, {"beat1_until": KILL_AT,
                                 "kill1_at": KILL_AT}),
            ("rejoin", 1, True, {"rejoin1": True})):
        cfg = dict(base, workdir=str(root / name), resume=resume,
                   elastic=ElasticConfig(**_elastic_kw()),
                   solver=SolverConfig(**SOLVER))
        os.makedirs(cfg["workdir"])
        runs = [{"name": name, "cfg": cfg, "plan": plan}]
        if world == 1:
            torch_elastic_worker.loop(0, 1, 1, str(root / f"{name}.store"),
                                      TINY_MLP, params, _tiny_data(), runs,
                                      str(root))
        else:
            _spawn(torch_elastic_worker.loop,
                   (world, world, str(root / f"{name}.store"), TINY_MLP,
                    params, _tiny_data(), runs, str(root)), world)
        out[name] = (_load(str(root), name, world), [
            _records(os.path.join(cfg["workdir"], f"m{r}.jsonl"))
            for r in range(world)],
            open(os.path.join(cfg["workdir"], "l0.txt")).read())
        if name == "evict":
            out["boundary_meta"] = {
                s: json.load(open(root / "ck" / s / "meta.json"))
                for s in sorted(os.listdir(root / "ck"))}
    return out


def test_the_relaunch_resumes_from_a_per_shard_boundary_step(
        port_elastic_runs, port_elastic_auto):
    """On the default layout the two ranks write the boundary step per
    shard, and the relaunched rank resumes from it elastically: every
    round's loss and the resize events equal the monolithic chain's, bit
    for bit."""
    ends, recs, _ = port_elastic_auto["evict"]
    assert [e["end"] for e in ends] == ["relaunch", "relaunch"]
    boundary = _resize_events(recs[0])[0]["step"]
    meta = port_elastic_auto["boundary_meta"][f"step-{boundary}"]
    assert meta["format"] == "sharded" and len(meta["shards"]) == 2
    assert meta["extra"]["n_devices"] == 2
    for phase in ("evict", "rejoin"):
        got = port_elastic_auto[phase][1][0]
        want = port_elastic_runs[phase][1][0]
        assert [(r["step"], r["loss"]) for r in got if "loss" in r] == \
            [(r["step"], r["loss"]) for r in want if "loss" in r], phase
        assert [(r["step"], r["dead"], r["joined"]) for r in
                _resize_events(got)] == \
            [(r["step"], r["dead"], r["joined"]) for r in
             _resize_events(want)], phase
    assert f"ELASTIC resume from round {boundary}: 2 devices" in \
        port_elastic_auto["rejoin"][2]


@pytest.mark.gpu
def test_four_nccl_ranks_relaunch_together_and_resume_at_two(tmp_path):
    """On four cards (NCCL, the agreement on its gloo side group): the
    nominal worker 1 is evicted, all four ranks leave with exit 75 at the
    same boundary after the 4-row boundary step; two ranks resume it
    (adapt_state 4 -> 2) and finish. Every round's loss within rtol 1e-4
    of the same chain on four gloo CPU ranks, the final params within
    1e-4 × max + 1e-6 (cuBLAS and the CPU sum in other orders)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    tnet = CompiledNet.compile(net_from_prototxt(TINY_MLP))
    params = {l: {p: t.detach().numpy() for p, t in lp.items()}
              for l, lp in tnet.init_params(torch.Generator().manual_seed(0),
                                            torch.device("cpu")).items()}
    out = {}
    for device in ("cuda", "cpu"):
        root = tmp_path / device
        for name, world, resume, plan in (
                ("evict", 4, False, {"beat1_until": KILL_AT,
                                     "kill1_at": KILL_AT}),
                ("finish", 2, True, {})):
            cfg = dict(_loop_cfg(root, None, local_batch=4),
                       workdir=str(root / name), resume=resume,
                       elastic=ElasticConfig(**_elastic_kw()),
                       solver=SolverConfig(**SOLVER))
            os.makedirs(cfg["workdir"])
            _spawn(torch_elastic_worker.loop,
                   (world, world, str(root / f"{name}.store"), TINY_MLP,
                    params, _tiny_data(), [{"name": name, "cfg": cfg,
                                            "plan": plan}], str(root),
                    device), world)
            out[(device, name)] = (_load(str(root), name, world), [
                _records(os.path.join(cfg["workdir"], f"m{r}.jsonl"))
                for r in range(world)])
    ends, recs = out[("cuda", "evict")]
    assert [e["end"] for e in ends] == ["relaunch"] * 4
    steps = {_resize_events(r)[0]["step"] for r in recs}
    assert steps == {KILL_AT + 3}
    assert ckpt.verify(str(tmp_path / "cuda" / "ck" / f"step-{KILL_AT + 3}"))
    losses = {}
    for device in ("cuda", "cpu"):
        losses[device] = {r["step"]: r["loss"]
                          for name in ("evict", "finish")
                          for r in out[(device, name)][1][0] if "loss" in r}
    assert sorted(losses["cuda"]) == list(range(ROUNDS))
    for s in range(ROUNDS):
        np.testing.assert_allclose(losses["cuda"][s], losses["cpu"][s],
                                   rtol=1e-4, err_msg=f"round {s}")
    for e_gpu, e_cpu in zip(out[("cuda", "finish")][0],
                            out[("cpu", "finish")][0]):
        assert e_gpu["end"] == e_cpu["end"] == "done"
        for l, lp in e_gpu["state"]["params"].items():
            for p, a in lp.items():
                _close(a, e_cpu["state"]["params"][l][p])


# -- the loop over two machines ----------------------------------------------

@pytest.fixture(scope="module")
def two_machines(tmp_path_factory):
    """4 gloo ranks as 2 machines: machine 1's beats go stale after round
    2 (suspected at round 3's boundary, evicted at round 5's) — once with
    min_workers 1 (relaunch), once with 2 (halt)."""
    root = tmp_path_factory.mktemp("two_machines")
    tnet = CompiledNet.compile(net_from_prototxt(TINY_MLP))
    params = {l: {p: t.detach().numpy() for p, t in lp.items()}
              for l, lp in tnet.init_params(torch.Generator().manual_seed(0),
                                            torch.device("cpu")).items()}
    runs = []
    for name, min_workers in (("relaunch", 1), ("halt", 2)):
        d = root / name
        os.makedirs(d)
        runs.append({"name": name, "cfg": dict(
            _loop_cfg(d, None, checkpoint_every=4, max_rounds=40,
                      local_batch=4, collect_async=False),
            elastic=ElasticConfig(**_elastic_kw(expected_workers=None,
                                                min_workers=min_workers)),
            solver=SolverConfig(**SOLVER)),
            "plan": {"silence_rank": 2, "silence_at": KILL_AT - 1,
                     "backdate_at": KILL_AT}})
    _spawn(torch_elastic_worker.loop,
           (4, 2, str(root / "store"), TINY_MLP, params, _tiny_data(), runs,
            str(root)), 4)
    out = {}
    for run in runs:
        wd = run["cfg"]["workdir"]
        out[run["name"]] = {
            "ends": _load(str(root), run["name"], 4),
            "records": [_records(os.path.join(wd, f"m{r}.jsonl"))
                        for r in range(4)],
            "steps": sorted(os.listdir(run["cfg"]["checkpoint_dir"]))}
    return out


def test_two_machines_every_rank_relaunches_at_the_same_round(two_machines):
    run = two_machines["relaunch"]
    assert [e["end"] for e in run["ends"]] == ["relaunch"] * 4
    assert {e["code"] for e in run["ends"]} == {75}
    evs = [_resize_events(r) for r in run["records"]]
    assert all(len(e) == 1 for e in evs)
    assert len({e[0]["step"] for e in evs}) == 1
    assert evs[0][0]["dead"] == ["1"] and evs[0][0]["relaunch"]
    last = [max(r["step"] for r in recs if "loss" in r)
            for recs in run["records"]]
    assert len(set(last)) == 1 and last[0] == evs[0][0]["step"] - 1
    assert evs[0][0]["step"] == KILL_AT + 3


def test_two_machines_write_no_boundary_step(two_machines):
    for name in ("relaunch", "halt"):
        run = two_machines[name]
        # round 5's boundary: step 4 is the periodic step of round 3
        assert _resize_events(run["records"][0])[0]["step"] == KILL_AT + 3
        assert run["steps"] == ["step-4"], run["steps"]


def test_two_machines_below_min_workers_halt_on_every_rank(two_machines):
    run = two_machines["halt"]
    assert [e["end"] for e in run["ends"]] == ["health"] * 4
    assert all("min_workers=2" in e["reason"] for e in run["ends"])
    steps = {_resize_events(r)[0]["step"] for r in run["records"]}
    assert len(steps) == 1


# -- the launch guard and the CLI --------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_launch_below_min_workers_raises_before_round_0(tmp_path, pkg):
    pod = tmp_path / "pod"
    _beat(pod, 1, age=1000)  # a previous incarnation's leftover
    kw = _loop_cfg(tmp_path, 1, max_rounds=3)
    jsonl = str(tmp_path / "m.jsonl")
    if pkg == "port":
        kw.pop("n_devices")
        cfg = RunConfig(**kw, elastic=ElasticConfig(
            **_elastic_kw(min_workers=2)))
        log = Logger(str(tmp_path / "l.txt"), echo=False, jsonl_path=jsonl)
        with pytest.raises(TrainingHealthError, match="launched with 1"):
            train(cfg, net_from_prototxt(TINY_MLP),
                  ArrayDataset(_tiny_data()), None, logger=log,
                  device="cpu")
        assert not torch.distributed.is_initialized()
    else:
        cfg = JaxRunConfig(**kw, elastic=JaxElasticConfig(
            **_elastic_kw(min_workers=2)))
        log = JaxLogger(str(tmp_path / "l.txt"), echo=False,
                        jsonl_path=jsonl)
        with pytest.raises(JaxHealthError, match="launched with 1"):
            jax_train(cfg, jax_net_from_prototxt(TINY_MLP),
                      JaxArrayDataset(_tiny_data()), None, logger=log)
    log.close()
    assert not any("loss" in r for r in _records(jsonl))


def test_elastic_needs_a_pod_dir_and_a_checkpoint_dir(tmp_path):
    for drop in ("pod_dir", "checkpoint_dir"):
        kw = _loop_cfg(tmp_path, 1)
        kw.pop("n_devices")
        kw[drop] = None
        cfg = RunConfig(**kw, elastic=ElasticConfig(**_elastic_kw()))
        with pytest.raises(ValueError, match=drop):
            train(cfg, net_from_prototxt(TINY_MLP),
                  ArrayDataset(_tiny_data()), None,
                  logger=Logger(echo=False), device="cpu")


def test_the_cifar_app_exits_75_at_a_membership_change(tmp_path):
    """worker 1 is declared but never beats: seeded at launch, suspected
    at round 0's boundary, probed at rounds 1 and 2 and evicted at round
    2's; the app writes step 2 and its process ends with 75."""
    data = tmp_path / "cifar"
    write_synthetic(str(data), n_per_file=40)
    el = json.dumps(_elastic_kw())
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    p = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.apps.cifar_app",
         "--device", "cpu", "--data-dir", str(data), "max_rounds=10",
         "tau=1", "local_batch=4", "eval_every=0",
         f"workdir={tmp_path / 'w'}", f"checkpoint_dir={tmp_path / 'ck'}",
         f"pod_dir={tmp_path / 'pod'}", "heartbeat_every_s=0",
         f"elastic={el}"],
        env=env, capture_output=True, text=True, timeout=240)
    assert p.returncode == 75, p.stderr[-2000:]
    assert os.listdir(tmp_path / "ck") == ["step-2"]
    logs = [f for f in os.listdir(tmp_path / "w") if f.endswith(".txt")]
    text = open(tmp_path / "w" / logs[0]).read()
    assert "exit 75 to relaunch" in text and "dead ['1']" in text
