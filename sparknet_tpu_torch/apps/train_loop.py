"""The training driver: the reference's app loop on the port's trainer.

The counterpart of `sparknet_tpu/apps/train_loop.py`: `train()` (its
l.144-199) and the core of `run_loop`. Reference shape
(`apps/CifarApp.scala:100-149`), one process per card:

    every eval_every rounds: distributed eval   -> trainer.evaluate
    τ local solver steps per rank               -> trainer.train_round
    average the weights                         -> (inside the round)
    log loss, health, the conv1[0] probe        -> logger + HealthMonitor

Each round draws `RoundSampler.next_round(round_index=r)` over the whole
dataset (every rank loads it identically, with one partition per rank)
and this rank takes its block of the batch axis — the data the JAX
package's device of the same index gets.

Not ported yet, and what the loop does with each:
  - settings that would change results raise NotImplementedError:
    `checkpoint_dir`, `elastic`, `trainer_impl="named"`, `state_sharding`
    other than "replicated", streaming ingest (a `next_round` source),
    `heartbeat_path`, `solver_prototxt` and a `.prototxt` model;
  - pipeline and observability levers that do not change the numbers are
    accepted and logged as not yet ported: `h2d_prefetch`,
    `donate_batches`, `fused_boundary`, `collect_async`,
    `compile_cache_dir`, `status_port`, `pod_dir`, `pod_port`,
    `trace_out`, `history`, `profile_dir`;
  - the health supervisor's rollback waits for checkpoints: until then a
    round whose `nonfinite` is above 0, or a run of spikes the monitor
    would roll back, stops the loop with `TrainingHealthError`.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from .. import precision
from ..data.dataset import ArrayDataset, RoundSampler
from ..model.layers import OpsImpl
from ..model.net import CompiledNet
from ..model.spec import NetSpec
from ..parallel.mesh import init_data_group
from ..parallel.trainer import ParallelTrainer, TrainState
from ..utils.config import RunConfig
from ..utils.health import (HealthConfig, HealthMonitor, TrainingHealthError,
                            poison_batch)
from ..utils.logger import Logger, default_logger

_NOT_PORTED_LEVERS = ("h2d_prefetch", "donate_batches", "fused_boundary",
                      "collect_async", "compile_cache_dir", "status_port",
                      "pod_dir", "pod_port", "trace_out", "history",
                      "profile_dir")


def resolve_spec(cfg: RunConfig, **input_shapes) -> NetSpec:
    """cfg.model -> NetSpec from the zoo (prototxt files wait for the
    model-file port)."""
    from .. import zoo
    if cfg.model.endswith(".prototxt"):
        raise NotImplementedError(
            "prototxt models are not ported yet; use a zoo name")
    builders = {
        "cifar10_quick": lambda: zoo.cifar10_quick(batch=cfg.local_batch),
        "caffenet": lambda: zoo.caffenet(batch=cfg.local_batch,
                                         crop=cfg.crop or 227,
                                         n_classes=cfg.n_classes),
        "lenet": lambda: zoo.lenet(batch=cfg.local_batch),
        "adult_mlp": lambda: zoo.adult_mlp(batch=cfg.local_batch),
    }
    if cfg.model not in builders:
        raise ValueError(f"unknown model {cfg.model!r}: expected one of "
                         f"{sorted(builders)}")
    return builders[cfg.model]()


def check_config(cfg: RunConfig, train_ds) -> list:
    """Raise on settings that would change results and are not ported;
    return the names of the accepted-but-not-ported levers that are on."""
    refused = {
        "checkpoint_dir": cfg.checkpoint_dir is not None,
        "elastic": cfg.elastic is not None and cfg.elastic.enabled,
        "trainer_impl='named'": cfg.trainer_impl == "named",
        f"state_sharding={cfg.state_sharding!r}":
            cfg.state_sharding != "replicated",
        "streaming ingest": hasattr(train_ds, "next_round"),
        "heartbeat_path": cfg.heartbeat_path is not None,
        "solver_prototxt": cfg.solver_prototxt is not None,
    }
    bad = [k for k, on in refused.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported to the PyTorch port yet: {', '.join(bad)}")
    if cfg.trainer_impl not in ("auto", "shard_map"):
        raise ValueError(f"unknown trainer_impl {cfg.trainer_impl!r}")
    if cfg.ops_interpret:
        raise ValueError("ops_interpret runs Pallas kernels under the JAX "
                         "interpreter; the port has none")
    return [k for k in _NOT_PORTED_LEVERS if getattr(cfg, k)]


def probe_value(state: TrainState, net: CompiledNet) -> float:
    """First scalar of the first parametric layer's weights — the
    reference's divergence probe (`apps/CifarApp.scala:147`)."""
    return float(state.params[net.param_layers()[0]]["w"].detach()
                 .reshape(-1)[0])


def train(cfg: RunConfig, spec: NetSpec, train_ds: ArrayDataset,
          test_ds: Optional[ArrayDataset] = None,
          logger: Optional[Logger] = None,
          round_hook: Optional[Callable[[int, TrainState], None]] = None,
          device=None) -> TrainState:
    """Run the distributed training loop per cfg on this process's card
    (default cuda; `device="cpu"` for the CPU). Returns the final state."""
    log = logger or default_logger(cfg.workdir)
    levers = check_config(cfg, train_ds)
    precision.set_policy(cfg.precision)
    net = CompiledNet.compile(spec)
    group = init_data_group(device, workdir=cfg.workdir)
    try:
        if cfg.n_devices is not None and cfg.n_devices != group.size:
            raise ValueError(f"n_devices={cfg.n_devices}, but the data "
                             f"group has {group.size} ranks (one per card)")
        compute_health = cfg.health is not None and cfg.health.enabled
        trainer = ParallelTrainer(net, cfg.solver, group, tau=cfg.tau,
                                  mode=cfg.mode,
                                  compute_health=compute_health,
                                  ops=OpsImpl(lrn=cfg.lrn_impl,
                                              pool=cfg.pool_impl))
        log.log(f"data group: rank {group.rank} of {group.size} on "
                f"{group.device}; tau={cfg.tau} mode={cfg.mode} "
                f"local_batch={cfg.local_batch} precision={cfg.precision} "
                f"lrn={cfg.lrn_impl} pool={cfg.pool_impl}")
        if levers:
            log.log(f"accepted, not yet ported (no effect on the numbers): "
                    f"{', '.join(levers)}")
        train_ds = _to_device_layout(train_ds, net)
        if test_ds is not None:
            test_ds = _to_device_layout(test_ds, net)
        return run_loop(cfg, trainer, train_ds, test_ds, log,
                        probe=lambda s: probe_value(s, net),
                        round_hook=round_hook)
    finally:
        group.close()


def run_loop(cfg: RunConfig, trainer: ParallelTrainer,
             train_ds: ArrayDataset, test_ds: Optional[ArrayDataset],
             log: Logger, probe: Optional[Callable[[Any], float]] = None,
             round_hook=None) -> TrainState:
    """The round loop: sample, train, log, evaluate (see the module
    docstring for what is not ported)."""
    rank, n = trainer.group.rank, trainer.group.size
    if log.worker is None and n > 1:
        log.worker = rank  # stamp each rank's JSONL records
    lb = cfg.local_batch
    sampler = RoundSampler(train_ds, n, lb, cfg.tau, seed=cfg.seed)
    log.log(f"train examples: {len(train_ds)} ({len(train_ds) // n} per "
            f"rank)" + (f"; test examples: {len(test_ds)}"
                        if test_ds else ""))
    state = trainer.init_state(cfg.seed)
    health_cfg = (cfg.health if cfg.health is not None
                  else HealthConfig(enabled=False))
    monitor = HealthMonitor(health_cfg) if health_cfg.enabled else None
    for rnd in range(cfg.max_rounds):
        if test_ds is not None and cfg.eval_every and \
                rnd % cfg.eval_every == 0:
            acc = _evaluate(trainer, state, test_ds, cfg.eval_batch)
            log.log(f"test accuracy: {acc:.4f}", rnd)
            log.metrics(rnd, test_accuracy=acc)
        batches = sampler.next_round(round_index=rnd)
        if monitor is not None and rnd in health_cfg.inject_nan_rounds:
            batches = poison_batch(batches, "nan")
        elif monitor is not None and rnd in health_cfg.inject_spike_rounds:
            batches = poison_batch(batches, "spike",
                                   scale=health_cfg.inject_spike_scale)
        mine = {k: v[:, rank * lb:(rank + 1) * lb]
                for k, v in batches.items()}
        t0 = time.perf_counter()
        state, loss = trainer.train_round(state, mine, (cfg.seed, rnd))
        loss = float(loss)  # the round's host sync
        round_s = time.perf_counter() - t0
        kv: Dict[str, Any] = {
            "loss": loss, "round_s": round(round_s, 6),
            "images_per_sec": round(cfg.tau * lb * n / round_s, 2)}
        health = trainer.last_health
        if health is not None:
            kv["grad_norm"] = float(health["grad_norm"])
            kv["nonfinite"] = float(health["nonfinite"])
            by_worker = health["nonfinite_by_worker"].cpu().numpy()
            if by_worker.max() > 0:
                kv["worst_worker"] = int(np.argmax(by_worker))
        cls = None
        if monitor is not None:
            cls = monitor.observe(rnd, loss, grad_norm=kv.get("grad_norm"),
                                  nonfinite_count=kv.get("nonfinite", 0.0))
            if cls != "ok":
                kv["health"] = cls
        probe_txt = f"  probe: {probe(state):.6f}" if probe else ""
        log.log(f"round loss: {loss:.4f}{probe_txt}"
                + (f"  HEALTH: {cls}" if cls not in (None, "ok") else ""),
                rnd)
        log.metrics(rnd, **kv)
        if kv.get("nonfinite", 0.0) > 0 or (
                monitor is not None and monitor.rollback_needed):
            raise TrainingHealthError(
                f"round {rnd}: {cls or 'nonfinite'} (nonfinite="
                f"{kv.get('nonfinite')}); the rollback to a verified "
                f"checkpoint is not ported yet, so the run stops here")
        if round_hook:
            round_hook(rnd, state)
    log.log("done")
    return state


def _to_device_layout(ds: ArrayDataset, net: CompiledNet) -> ArrayDataset:
    """One-time NCHW -> NHWC conversion for 4D inputs that arrive in the
    reference's Caffe layout."""
    arrays = dict(ds.arrays)
    for name, want in net.input_shapes.items():
        arr = arrays.get(name)
        if arr is None or arr.ndim != 4:
            continue
        want_el = tuple(want[1:])
        if tuple(arr.shape[1:]) != want_el and \
                (arr.shape[2], arr.shape[3], arr.shape[1]) == want_el:
            arrays[name] = np.ascontiguousarray(
                np.transpose(arr, (0, 2, 3, 1)))
    return ArrayDataset(arrays)


def _evaluate(trainer: ParallelTrainer, state: TrainState,
              test_ds: ArrayDataset, eval_batch: int) -> float:
    """Accuracy over the test set in global batches of `eval_batch`, each
    split evenly over the ranks (this rank evaluates its block); a tail
    past the last full batch runs as one smaller batch, weighted by its
    size. At most n-1 trailing examples are left out."""
    n = trainer.group.size
    rank = trainer.group.rank
    eval_batch = min(eval_batch, len(test_ds))
    eval_batch = max(n, (eval_batch // n) * n)
    if len(test_ds) < eval_batch:
        raise ValueError(f"test set ({len(test_ds)}) smaller than {n} "
                         f"ranks' minimum eval batch")

    def run(lo: int, size: int) -> float:
        per = size // n
        batch = {k: v[lo + rank * per:lo + (rank + 1) * per]
                 for k, v in test_ds.arrays.items()}
        return trainer.evaluate(state, batch) * size

    total, count = 0.0, 0
    n_full = (len(test_ds) // eval_batch) * eval_batch
    for i in range(0, n_full, eval_batch):
        total += run(i, eval_batch)
        count += eval_batch
    tail = ((len(test_ds) - n_full) // n) * n
    if tail:
        total += run(n_full, tail)
        count += tail
    return total / max(count, 1)
