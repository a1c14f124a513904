"""One rank of the port's elastic tests (tests/test_torch_elastic.py). It
imports torch and the port only: the test spawns it with
torch.multiprocessing; it joins a gloo group through a FileStore and
writes what it saw to `<out>/<name>_rank<r>.pkl`.

- `tau_rounds`: one round of TINY_MLP per τ vector on an `elastic_tau`
  trainer, one unmasked round and one round of a τ = 1 trainer on the
  first slice, each from the same params.
- `loop`: `train()` runs (each a dict of settings, in order, in one
  group), with a round hook that beats, backdates or silences heartbeats
  as the run's plan says; each run's end — done, ElasticRelaunch or
  TrainingHealthError, with the round — and its final state.
"""
import json
import os
import pickle
import time

import numpy as np
import torch

from sparknet_tpu_torch.apps.train_loop import train
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.model.net import CompiledNet
from sparknet_tpu_torch.model.prototxt import net_from_prototxt
from sparknet_tpu_torch.obs.pod import worker_heartbeat_path
from sparknet_tpu_torch.parallel.elastic import ElasticRelaunch
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.health import TrainingHealthError
from sparknet_tpu_torch.utils import heartbeat as heartbeat_mod
from sparknet_tpu_torch.utils.heartbeat import HeartbeatWriter
from sparknet_tpu_torch.utils.logger import Logger


def _tensors(params):
    return {l: {p: torch.from_numpy(np.array(v)) for p, v in lp.items()}
            for l, lp in params.items()}


def _numpy_state(state):
    return {"it": state.it,
            "params": {l: {p: t.detach().cpu().numpy().copy()
                           for p, t in lp.items()}
                       for l, lp in state.params.items()},
            "momentum": {l: {p: t.cpu().numpy().copy()
                             for p, t in lp.items()}
                         for l, lp in state.momentum.items()}}


def _save(out_dir, name, rank, obj):
    with open(os.path.join(out_dir, f"{name}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def tau_rounds(rank, world, store_path, net_text, params, batches, vectors,
               solver_kw, out_dir):
    """Rounds from `params` on this rank's block of `batches`
    ([tau, world * lb, ...]): one per τ vector (elastic_tau), one
    unmasked, one τ = 1 on slice 0."""
    torch.set_num_threads(1)
    group = init_data_group("cpu", store_path=store_path, rank=rank,
                            world_size=world)
    try:
        net = CompiledNet.compile(net_from_prototxt(net_text))
        tau = next(iter(batches.values())).shape[0]
        lb = next(iter(batches.values())).shape[1] // world
        mine = {k: v[:, rank * lb:(rank + 1) * lb]
                for k, v in batches.items()}
        out = {}

        def one(trainer, b, **kw):
            state = trainer.state_from_params(_tensors(params))
            state, loss = trainer.train_round(state, b, (0, 1), **kw)
            return {"loss": float(loss),
                    "grad_norm": float(trainer.last_health["grad_norm"]),
                    **_numpy_state(state)}

        el = ParallelTrainer(net, SolverConfig(**solver_kw), group, tau=tau,
                             elastic_tau=True)
        for vec in vectors:
            out[tuple(vec)] = one(el, mine, tau_by_worker=vec)
        out["elastic_none"] = one(el, mine)
        out["unmasked"] = one(ParallelTrainer(
            net, SolverConfig(**solver_kw), group, tau=tau), mine)
        out["tau1"] = one(ParallelTrainer(
            net, SolverConfig(**solver_kw), group, tau=1),
            {k: v[:1] for k, v in mine.items()})
        _save(out_dir, "tau", rank, out)
    finally:
        group.close()


def _backdate(path, age=1e4):
    """Rewrite a heartbeat as `age` seconds old, atomically (a reader
    never sees a torn or a fresh intermediate file)."""
    rec = json.load(open(path))
    rec["t"] = time.time() - age
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)


class _StaleClock:
    """The `time` module as the heartbeat writer sees it on a machine
    that has gone silent: every beat it writes is already stale."""

    def time(self):
        return time.time() - 1e4

    def __getattr__(self, name):
        return getattr(time, name)


def _hook(plan, rank, pod_dir):
    """The round hook of one run's plan:
    - "beat1_until": rank 0 beats the nominal worker 1 before the run and
      after each round below it; "kill1_at": rank 0 backdates worker 1's
      beat after that round;
    - "rejoin1": rank 0 beats worker 1 after the run's first round only;
    - "silence_rank", "silence_at": after that round, that rank writes
      every heartbeat backdated (its machine goes silent); "backdate_at":
      rank 0 backdates machine 1's beat after that round. With inline
      flushes (`collect_async=False`) no fresh beat of machine 1 can land
      after rank 0's backdate, so the eviction round is fixed."""
    hb1 = (HeartbeatWriter(worker_heartbeat_path(pod_dir, 1),
                           interval_s=0.0)
           if rank == 0 and ("beat1_until" in plan or "rejoin1" in plan)
           else None)
    if hb1 is not None and "beat1_until" in plan:
        hb1.beat(0, status="ok", round_s=0.01, force=True)
    first = [True]

    def hook(rnd, state):
        if hb1 is not None:
            if rnd < plan.get("beat1_until", -1) or (
                    plan.get("rejoin1") and first[0]):
                hb1.beat(rnd, status="ok", round_s=0.01, force=True)
            elif rnd == plan.get("kill1_at"):
                _backdate(worker_heartbeat_path(pod_dir, 1))
        first[0] = False
        if rank == plan.get("silence_rank") and rnd == plan["silence_at"]:
            heartbeat_mod.time = _StaleClock()
        if rank == 0 and rnd == plan.get("backdate_at"):
            _backdate(worker_heartbeat_path(pod_dir, 1))

    return hook


def loop(rank, world, local_size, store_path, net_text, params, data,
         runs, out_dir, device="cpu"):
    """`runs`: [{"name", "cfg": RunConfig kwargs, "plan": {...}}], on
    `device` ("cuda": this rank's card, NCCL)."""
    torch.set_num_threads(1 if world > 1 else torch.get_num_threads())
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
    saved = ({k: os.environ.get(k) for k in keys}, ParallelTrainer.init_state)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % local_size),
                      LOCAL_WORLD_SIZE=str(local_size))
    start = _tensors(params)
    ParallelTrainer.init_state = \
        lambda self, seed=0: self.state_from_params(start)
    group = init_data_group(device, store_path=store_path, rank=rank,
                            world_size=world)
    try:
        spec = net_from_prototxt(net_text)
        ds = ArrayDataset(data)
        for run in runs:
            cfg = RunConfig(**run["cfg"])
            hook = _hook(run["plan"], rank, cfg.pod_dir)
            log = Logger(os.path.join(cfg.workdir, f"l{rank}.txt"),
                         echo=False, jsonl_path=os.path.join(
                             cfg.workdir, f"m{rank}.jsonl"))
            res = {"end": "done"}
            try:
                res["state"] = _numpy_state(train(
                    cfg, spec, ds, None, logger=log, round_hook=hook,
                    device=device))
            except ElasticRelaunch as e:
                res.update(end="relaunch", code=e.code, reason=e.reason)
            except TrainingHealthError as e:
                res.update(end="health", reason=str(e))
            finally:
                heartbeat_mod.time = time
                log.close()
            _save(out_dir, run["name"], rank, res)
    finally:
        group.close()
        # the 1-rank runs execute in the test's own process
        ParallelTrainer.init_state = saved[1]
        for k, v in saved[0].items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
