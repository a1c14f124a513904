"""The training driver: the reference's app loop on the port's trainer.

The counterpart of `sparknet_tpu/apps/train_loop.py`: `train()` (its
l.144-199), `run_loop` with checkpoints, resume and the health
supervisor's rollback, and `_save_checkpoint`. Reference shape
(`apps/CifarApp.scala:100-149`), one process per card:

    every eval_every rounds: distributed eval   -> trainer.evaluate
    τ local solver steps per rank               -> trainer.train_round
    average the weights                         -> (inside the round)
    log loss, health, the conv1[0] probe        -> logger + HealthMonitor
    every checkpoint_every rounds: save         -> utils/checkpoint

Each round draws `RoundSampler.next_round(round_index=r)` over the whole
dataset (every rank loads it identically, with one partition per rank)
and this rank takes its block of the batch axis — the data the JAX
package's device of the same index gets.

Checkpoints (`checkpoint_dir`) are the reference's replica layout on a
local directory (`parallel/trainer.py:checkpoint_tree`). Stage 1, on every
rank, gathers the momentum and copies the state to host memory; rank 0
then writes it (stage 2), inline or on the background writer
(`checkpoint_async`). `resume` restarts at the newest step, with the
health supervisor's state (`extra["health"]`). A nonfinite round, or a
run of spikes, rolls back to the newest verified non-anomalous step with
the learning rate scaled by `lr_backoff`; the retried rounds draw another
data window (round R of rollback generation g samples logical round
R + g * 2**20). The port fetches each round's loss and health as the
round ends, so an incident is seen at its own round; the reference's
deferred fetch may see it one round later, unless the round ends at a
checkpoint.

Not ported yet, and what the loop does with each:
  - settings that would change results raise NotImplementedError:
    `elastic`, `trainer_impl="named"`, `state_sharding` other than
    "replicated", streaming ingest (a `next_round` source),
    `heartbeat_path`, a bucket `checkpoint_dir` (gs://, s3://), and the
    per-shard checkpoint layout (`checkpoint_sharded="on"`, or "auto" at
    more than one rank, where the reference writes one file per shard);
  - pipeline and observability levers that do not change the numbers are
    accepted and logged as not yet ported: `h2d_prefetch`,
    `donate_batches`, `fused_boundary`, `collect_async`,
    `compile_cache_dir`, `status_port`, `pod_dir`, `pod_port`,
    `trace_out`, `history`, `profile_dir`.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np

from .. import precision
from ..data.dataset import ArrayDataset, RoundSampler
from ..model.layers import OpsImpl
from ..model.net import CompiledNet
from ..model.spec import NetSpec
from ..parallel.mesh import init_data_group
from ..parallel.trainer import ParallelTrainer, TrainState
from ..utils import checkpoint as ckpt
from ..utils.config import RunConfig
from ..utils.health import (HealthConfig, HealthMonitor, TrainingHealthError,
                            poison_batch)
from ..utils.logger import Logger, default_logger

_NOT_PORTED_LEVERS = ("h2d_prefetch", "donate_batches", "fused_boundary",
                      "collect_async", "compile_cache_dir", "status_port",
                      "pod_dir", "pod_port", "trace_out", "history",
                      "profile_dir")

#: retried rounds sample a disjoint deterministic data window: round R on
#: rollback generation g draws as logical round R + g * _RETRY_DATA_OFFSET
_RETRY_DATA_OFFSET = 1 << 20


def resolve_spec(cfg: RunConfig, **input_shapes) -> NetSpec:
    """cfg.model -> NetSpec: a zoo builder name, or a .prototxt path (its
    input dims overridden by `input_shapes` where given)."""
    from .. import zoo
    from ..model.prototxt import net_from_prototxt_file
    if cfg.model.endswith(".prototxt"):
        return net_from_prototxt_file(
            cfg.model, input_shapes=input_shapes or None)
    builders = {
        "cifar10_quick": lambda: zoo.cifar10_quick(batch=cfg.local_batch),
        "caffenet": lambda: zoo.caffenet(batch=cfg.local_batch,
                                         crop=cfg.crop or 227,
                                         n_classes=cfg.n_classes),
        "lenet": lambda: zoo.lenet(batch=cfg.local_batch),
        "adult_mlp": lambda: zoo.adult_mlp(batch=cfg.local_batch),
    }
    if cfg.model not in builders:
        raise ValueError(f"unknown model {cfg.model!r}: expected a .prototxt "
                         f"path or one of {sorted(builders)}")
    return builders[cfg.model]()


def resolve_solver(cfg: RunConfig):
    """Apply cfg.solver_prototxt over cfg.solver if set."""
    if cfg.solver_prototxt:
        from ..model.prototxt import solver_from_prototxt_file
        from ..solver import SolverConfig
        cfg.solver = SolverConfig.from_dict(
            solver_from_prototxt_file(cfg.solver_prototxt))
    return cfg.solver


def check_config(cfg: RunConfig, train_ds) -> list:
    """Raise on settings that would change results and are not ported;
    return the names of the accepted-but-not-ported levers that are on."""
    if cfg.checkpoint_sharded not in ("auto", "on", "off"):
        raise ValueError(f"checkpoint_sharded={cfg.checkpoint_sharded!r}: "
                         f"expected 'auto', 'on', or 'off'")
    refused = {
        "elastic": cfg.elastic is not None and cfg.elastic.enabled,
        "trainer_impl='named'": cfg.trainer_impl == "named",
        f"state_sharding={cfg.state_sharding!r}":
            cfg.state_sharding != "replicated",
        "streaming ingest": hasattr(train_ds, "next_round"),
        "heartbeat_path": cfg.heartbeat_path is not None,
        "checkpoint_dir on a bucket store (gs://, s3://)":
            bool(cfg.checkpoint_dir)
            and cfg.checkpoint_dir.startswith(("gs://", "s3://")),
        "checkpoint_sharded='on' (per-shard checkpoint files)":
            bool(cfg.checkpoint_dir) and cfg.checkpoint_sharded == "on",
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
    resolve_solver(cfg)
    net = CompiledNet.compile(spec)
    group = init_data_group(device, workdir=cfg.workdir)
    try:
        if cfg.n_devices is not None and cfg.n_devices != group.size:
            raise ValueError(f"n_devices={cfg.n_devices}, but the data "
                             f"group has {group.size} ranks (one per card)")
        if cfg.checkpoint_dir and cfg.checkpoint_sharded == "auto" and \
                group.size > 1:
            raise NotImplementedError(
                f"checkpoint_sharded='auto' at {group.size} ranks means "
                f"per-shard checkpoint files, which are not ported yet; "
                f"set checkpoint_sharded=off for the monolithic layout")
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


def prepare_round_batches(source: RoundSampler, rnd: int, retry: int = 0,
                          health: Optional[HealthConfig] = None,
                          first_pass: bool = True) -> Dict[str, np.ndarray]:
    """One round's [tau, world * local_batch, ...] batches. `retry` is the
    rollback generation: a retried round draws logical round
    rnd + retry * 2**20. With `health` enabled, the configured rounds are
    poisoned on their first pass only (`first_pass`: the round is above
    the highest one already run), so a retried window is clean while
    later configured rounds still fire."""
    batches = source.next_round(
        round_index=rnd + retry * _RETRY_DATA_OFFSET if retry else rnd)
    if health is not None and health.enabled and first_pass:
        if rnd in health.inject_nan_rounds:
            batches = poison_batch(batches, "nan")
        elif rnd in health.inject_spike_rounds:
            batches = poison_batch(batches, "spike",
                                   scale=health.inject_spike_scale)
    return batches


def run_loop(cfg: RunConfig, trainer: ParallelTrainer,
             train_ds: ArrayDataset, test_ds: Optional[ArrayDataset],
             log: Logger, probe: Optional[Callable[[Any], float]] = None,
             round_hook=None) -> TrainState:
    """The round loop: resume, sample, train, log, evaluate, checkpoint,
    roll back (see the module docstring)."""
    rank, n = trainer.group.rank, trainer.group.size
    if log.worker is None and n > 1:
        log.worker = rank  # stamp each rank's JSONL records
    lb = cfg.local_batch
    ckdir = cfg.checkpoint_dir
    sampler = RoundSampler(train_ds, n, lb, cfg.tau, seed=cfg.seed)
    log.log(f"train examples: {len(train_ds)} ({len(train_ds) // n} per "
            f"rank)" + (f"; test examples: {len(test_ds)}"
                        if test_ds else ""))
    state = trainer.init_state(cfg.seed)
    start_round = 0
    resumed_extra: Dict[str, Any] = {}
    if ckdir and cfg.resume and ckpt.latest_step(ckdir) is not None:
        flat, start_round, resumed_extra = ckpt.restore_flat(ckdir)
        state = trainer.state_from_checkpoint(flat, resumed_extra)
        log.log(f"resumed from checkpoint round {start_round}")
    health_cfg = (cfg.health if cfg.health is not None
                  else HealthConfig(enabled=False))
    monitor = HealthMonitor(health_cfg) if health_cfg.enabled else None
    # stage-2 background writer (at most one snapshot in flight); None =
    # synchronous saves
    ck_writer = (ckpt.AsyncCheckpointWriter()
                 if ckdir and cfg.checkpoint_async else None)

    def ckpt_barrier() -> None:
        """Settle the store before reading it: drain the in-flight write
        (re-raising its failure), then every rank waits for rank 0's."""
        if ck_writer is not None:
            ck_writer.wait()
        trainer.group.barrier()

    # the health supervisor's state resumes with the checkpoint: the lr
    # backoff, the retried data order and the rollback budget
    saved_health = resumed_extra.get("health", {})
    retry = int(saved_health.get("retry", 0))
    lr_scale = float(saved_health.get("lr_scale", 1.0))
    if monitor is not None:
        monitor.rollbacks = int(saved_health.get("rollbacks", 0))
    if retry or lr_scale != 1.0:
        log.log(f"health state resumed: retry={retry} lr_scale={lr_scale} "
                f"rollbacks={saved_health.get('rollbacks', 0)}")
    # the highest round already run: rounds at or below it are retries,
    # where fault injection does not fire
    high_water = start_round - 1

    def recover(state):
        """Roll back to the newest verified non-anomalous checkpoint;
        returns (restored state, its round). Raises TrainingHealthError
        when the budget is spent or there is nothing to roll back to."""
        nonlocal retry, lr_scale
        reason = monitor.consume_rollback()  # raises once budget is spent
        if not ckdir:
            raise TrainingHealthError(
                f"training health: {reason} detected but no checkpoint_dir "
                f"is configured — nothing to roll back to. Enable "
                f"checkpointing or disable cfg.health.")
        ckpt_barrier()  # the in-flight write may BE the rollback target
        found = ckpt.restore_newest_verified(ckdir, skip_anomalous=True)
        if found is None:
            raise TrainingHealthError(
                f"training health: {reason} detected and no verified "
                f"non-anomalous checkpoint exists under {ckdir!r} — cannot "
                f"recover.")
        flat, ck_round, extra = found
        try:
            state = trainer.state_from_checkpoint(flat, extra)
        except ValueError as e:
            raise TrainingHealthError(
                f"training health: rollback target step {ck_round} cannot "
                f"be loaded — {e}") from e
        retry += 1
        if health_cfg.lr_backoff != 1.0:
            lr_scale *= health_cfg.lr_backoff
        log.event(ck_round, "rollback", reason=reason, target_step=ck_round,
                  rollbacks=monitor.rollbacks, retry=retry,
                  lr_scale=round(lr_scale, 6))
        return state, ck_round

    rnd = start_round
    loop_completed = False
    try:
        while rnd < cfg.max_rounds:
            if monitor is not None and monitor.rollback_needed:
                state, rnd = recover(state)
                continue
            if test_ds is not None and cfg.eval_every and \
                    rnd % cfg.eval_every == 0:
                acc = _evaluate(trainer, state, test_ds, cfg.eval_batch)
                log.log(f"test accuracy: {acc:.4f}", rnd)
                log.metrics(rnd, test_accuracy=acc)
            batches = prepare_round_batches(
                sampler, rnd, retry, health_cfg if monitor else None,
                first_pass=rnd > high_water)
            high_water = max(high_water, rnd)
            mine = {k: v[:, rank * lb:(rank + 1) * lb]
                    for k, v in batches.items()}
            # a retried round keys its dropout masks anew as well
            key = (cfg.seed, rnd) + ((retry,) if retry else ())
            t0 = time.perf_counter()
            state, loss = trainer.train_round(state, mine, key,
                                              lr_scale=lr_scale)
            loss = float(loss)  # the round's host sync
            round_s = time.perf_counter() - t0
            _log_round(log, trainer, monitor, rnd, loss, round_s, cfg,
                       probe(state) if probe else None)
            if ckdir and cfg.checkpoint_every and \
                    (rnd + 1) % cfg.checkpoint_every == 0:
                if monitor is not None and monitor.rollback_needed:
                    continue  # never checkpoint a poisoned state; the
                    #           loop top recovers instead
                anomalous = (monitor is not None
                             and monitor.recently_anomalous(rnd))
                _save_checkpoint(cfg, trainer, state, rnd + 1,
                                 anomalous=anomalous,
                                 health_state=_health_state(
                                     retry, lr_scale, monitor),
                                 writer=ck_writer)
                if anomalous:
                    log.event(rnd, "anomalous_checkpoint",
                              checkpoint_step=rnd + 1)
                log.log("checkpoint saved" if ck_writer is None else
                        "checkpoint snapshotted (async write)", rnd)
            if round_hook:
                round_hook(rnd, state)
            rnd += 1
            if rnd >= cfg.max_rounds and monitor is not None and \
                    monitor.rollback_needed:
                # an incident in the last round recovers before the final
                # checkpoint is written
                state, rnd = recover(state)
        loop_completed = True
    finally:
        if ck_writer is not None:
            # a running write always completes; on the normal path its
            # failure raises here, on an aborted one it must not mask
            # the exception already propagating
            try:
                ck_writer.close(wait=True)
            except Exception as e:
                if loop_completed:
                    raise
                log.log(f"background checkpoint write failed during "
                        f"abort: {e}")
    if ckdir and start_round < cfg.max_rounds:
        # start_round >= max_rounds: the loop ran no round, and the
        # restored step is already the final state
        _save_checkpoint(cfg, trainer, state, cfg.max_rounds, retain=False,
                         anomalous=(monitor is not None and
                                    monitor.recently_anomalous(
                                        cfg.max_rounds - 1)),
                         health_state=_health_state(retry, lr_scale,
                                                    monitor))
        # no rank returns before rank 0's final step is committed: a
        # caller may resume from it at once
        trainer.group.barrier()
    if monitor is not None and (monitor.counts["spike"]
                                or monitor.counts["nonfinite"]):
        log.log(f"health summary: {monitor.counts['spike']} spikes, "
                f"{monitor.counts['nonfinite']} nonfinite rounds, "
                f"{monitor.rollbacks} rollbacks")
    log.log("done")
    return state


def _log_round(log: Logger, trainer: ParallelTrainer,
               monitor: Optional[HealthMonitor], rnd: int, loss: float,
               round_s: float, cfg: RunConfig, probe: Optional[float]
               ) -> None:
    """One round's log line and metrics record; the monitor classifies
    the round (and latches a rollback when its policy asks for one)."""
    kv: Dict[str, Any] = {
        "loss": loss, "round_s": round(round_s, 6),
        "images_per_sec": round(cfg.tau * cfg.local_batch
                                * trainer.group.size / round_s, 2)}
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
    probe_txt = f"  probe: {probe:.6f}" if probe is not None else ""
    log.log(f"round loss: {loss:.4f}{probe_txt}"
            + (f"  HEALTH: {cls}" if cls not in (None, "ok") else ""), rnd)
    log.metrics(rnd, **kv)
    if cls == "spike" and not monitor.rollback_needed:
        log.event(rnd, "spike_skip", loss=loss)


def _health_state(retry: int, lr_scale: float,
                  monitor: Optional[HealthMonitor]
                  ) -> Optional[Dict[str, Any]]:
    """The supervisor's recovery state for the checkpoint's `extra` — only
    when it differs from a fresh run's."""
    rollbacks = monitor.rollbacks if monitor is not None else 0
    if not retry and lr_scale == 1.0 and not rollbacks:
        return None
    return {"retry": int(retry), "lr_scale": float(lr_scale),
            "rollbacks": int(rollbacks)}


def _save_checkpoint(cfg: RunConfig, trainer: ParallelTrainer,
                     state: TrainState, step: int, retain: bool = True,
                     anomalous: bool = False,
                     health_state: Optional[Dict[str, Any]] = None,
                     writer: Optional[ckpt.AsyncCheckpointWriter] = None
                     ) -> None:
    """Two-stage save. Stage 1 (here, blocking, on every rank): the state
    in the replica layout, copied to host memory the snapshot owns — the
    next round updates the device buffers in place. Stage 2 (serialize,
    digest, persist, retain to 3) runs on rank 0 only: inline when
    `writer` is None, else on the background writer. The bytes, digests
    and tags are the same either way."""
    tree = trainer.checkpoint_tree(state)
    if trainer.group.rank != 0:
        return

    def persist() -> None:
        extra: Dict[str, Any] = {"n_devices": trainer.group.size, "tp": 1,
                                 "publish_t": round(time.time(), 3)}
        if anomalous:
            extra["anomalous"] = True
        if health_state is not None:
            extra["health"] = health_state
        ckpt.save(cfg.checkpoint_dir, tree, step=step, extra=extra)
        if retain:
            try:
                ckpt.retain(cfg.checkpoint_dir, keep=3)
            except Exception as e:
                # retention is best-effort: the step itself saved
                warnings.warn(f"checkpoint retention failed (snapshot "
                              f"step-{step} saved OK): {e}", RuntimeWarning)

    if writer is not None:
        writer.submit(persist)
    else:
        persist()


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
