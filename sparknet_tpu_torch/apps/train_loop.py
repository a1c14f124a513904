"""The training driver: the reference's app loop on the port's trainer.

The counterpart of `sparknet_tpu/apps/train_loop.py`: `train()` (its
l.144-199), `prepare_round_batches`, `run_loop` with the round pipeline,
checkpoints, resume and the health supervisor's rollback, and
`_save_checkpoint`. Reference shape (`apps/CifarApp.scala:100-149`), one
process per card:

    every eval_every rounds: distributed eval   -> trainer.evaluate
    τ local solver steps per rank               -> trainer.train_round
    average the weights                         -> (inside the round)
    log loss, health, the conv1[0] probe        -> logger + HealthMonitor
    every checkpoint_every rounds: save         -> utils/checkpoint

Each round draws `RoundSampler.next_round(round_index=r)` over the whole
dataset (every rank loads it identically, with one partition per rank);
a `batch_transform` (the ImageNet app's crop, mean and cast) runs on each
τ-slice of that world batch with a round-keyed generator, and this rank
takes its block of the batch axis — the data the JAX package's device of
the same index gets.

The round pipeline, as the JAX loop runs it by default:
  - round prep (sampling, the transform, the cast to the compute dtype:
    `prepare_round_batches`) for round R+1 runs on a one-deep `round-prep`
    thread while round R runs; `prefetch=False` prepares every round
    inline on the main thread instead (the synchronous loop);
  - `h2d_prefetch`: that thread also places round R+1 on the card
    (`ParallelTrainer.place_batches`: pinned staging, a copy stream, an
    event the compute stream waits on), so the round's `h2d` phase is a
    pass-through; `donate_batches` rotates placed rounds through two
    device slots (parallel/trainer.py);
  - the deferred fetch: each round leaves a record (round, loss, probe,
    health, breakdown) whose scalars are copied off the card
    asynchronously; records are flushed — logged and classified by the
    health monitor — every `log_every` rounds, inline or, with
    `collect_async`, on a `collect` thread, and always at an eval, a
    checkpoint, a recovery, the loop's end and an abort. So an incident
    at round R is seen while round R+1 runs (at R itself when R ends at a
    checkpoint), as in the JAX loop;
  - with `telemetry`, every round record carries the step-time breakdown:
    t_data_ms (the main thread's wait for round prep), t_h2d_ms,
    t_round_ms (queueing the round), t_ckpt_fetch_ms, t_collect_ms (or
    t_collect_bg_ms off the loop), t_log_ms, t_prep_ms (round prep's own
    time, on whichever thread ran it) and h2d_bytes.
The prep thread's and the collector's exceptions re-raise in the main
thread.

Checkpoints (`checkpoint_dir`) are the reference's replica layout on a
local directory (`parallel/trainer.py:checkpoint_tree`). Stage 1, on every
rank, gathers the momentum and copies the state to host memory; rank 0
then writes it (stage 2), inline or on the background writer
(`checkpoint_async`). `resume` restarts at the newest step, with the
health supervisor's state (`extra["health"]`). A nonfinite round, or a
run of spikes, rolls back to the newest verified non-anomalous step with
the learning rate scaled by `lr_backoff`; the prefetched round is
dropped and the retried rounds draw another data window (round R of
rollback generation g samples logical round R + g * 2**20, its transform
generators keyed (seed, R + g * 2**20, g, t)).

Not ported yet, and what the loop does with each:
  - settings that would change results raise NotImplementedError:
    `elastic`, `trainer_impl="named"`, `state_sharding` other than
    "replicated", streaming ingest (a `next_round` source),
    `heartbeat_path`, a bucket `checkpoint_dir` (gs://, s3://), and the
    per-shard checkpoint layout (`checkpoint_sharded="on"`, or "auto" at
    more than one rank, where the reference writes one file per shard);
  - levers that do not change the numbers are accepted and logged as not
    yet ported: `fused_boundary` (an eager round already averages right
    after its last step), `compile_cache_dir`, `status_port`, `pod_dir`,
    `pod_port`, `trace_out`, `history`, `profile_dir`.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import precision
from ..data.dataset import ArrayDataset, RoundSampler
from ..model.layers import OpsImpl
from ..model.net import CompiledNet
from ..model.spec import NetSpec
from ..obs import trace as obs_trace
from ..parallel.mesh import init_data_group
from ..parallel.trainer import ParallelTrainer, TrainState
from ..utils import checkpoint as ckpt
from ..utils.config import RunConfig
from ..utils.health import (HealthConfig, HealthMonitor, TrainingHealthError,
                            poison_batch)
from ..utils.logger import Logger, default_logger
from ..utils.metrics import PhaseTimers, ThroughputMeter

_NOT_PORTED_LEVERS = ("fused_boundary", "compile_cache_dir", "status_port",
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


def probe_value(state: TrainState, net: CompiledNet) -> torch.Tensor:
    """First scalar of the first parametric layer's weights — the
    reference's divergence probe (`apps/CifarApp.scala:147`) — as a 0-d
    view of the params; the loop copies it into the round's record before
    the next round updates the params in place."""
    return state.params[net.param_layers()[0]]["w"].detach().reshape(-1)[0]


def train(cfg: RunConfig, spec: NetSpec, train_ds: ArrayDataset,
          test_ds: Optional[ArrayDataset] = None,
          logger: Optional[Logger] = None,
          round_hook: Optional[Callable[[int, TrainState], None]] = None,
          batch_transform=None, eval_transform=None, device=None,
          prefetch: bool = True) -> TrainState:
    """Run the distributed training loop per cfg on this process's card
    (default cuda; `device="cpu"` for the CPU). `batch_transform` /
    `eval_transform` (e.g. `data.preprocess.ImagePreprocessor`) convert
    each train τ-slice / eval batch of raw examples to net inputs; without
    one, 4D inputs in Caffe's NCHW layout are transposed to NHWC once.
    `prefetch=False` prepares each round on the main thread (module
    docstring). Returns the final state."""
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
                                              pool=cfg.pool_impl),
                                  donate_batches=cfg.donate_batches)
        log.log(f"data group: rank {group.rank} of {group.size} on "
                f"{group.device}; tau={cfg.tau} mode={cfg.mode} "
                f"local_batch={cfg.local_batch} precision={cfg.precision} "
                f"lrn={cfg.lrn_impl} pool={cfg.pool_impl}")
        log.log(f"round pipeline: prep thread "
                f"{'on' if prefetch else 'off'}, h2d_prefetch="
                f"{cfg.h2d_prefetch}, donate_batches={cfg.donate_batches}, "
                f"collect_async={cfg.collect_async}, log_every="
                f"{cfg.log_every}, telemetry={cfg.telemetry}")
        if levers:
            log.log(f"accepted, not yet ported (no effect on the numbers): "
                    f"{', '.join(levers)}")
        if batch_transform is None:
            train_ds = _to_device_layout(train_ds, net)
        if test_ds is not None and eval_transform is None:
            test_ds = _to_device_layout(test_ds, net)
        return run_loop(cfg, trainer, train_ds, test_ds, log,
                        batch_transform=batch_transform,
                        eval_transform=eval_transform,
                        probe=lambda s: probe_value(s, net),
                        round_hook=round_hook, prefetch=prefetch)
    finally:
        group.close()


def _stack(slices):
    """Stack per-slice arrays (numpy, or CPU tensors for bfloat16)."""
    if isinstance(slices[0], torch.Tensor):
        return torch.stack(slices)
    return np.stack(slices)


def prepare_round_batches(source: RoundSampler, rnd: int, tau: int,
                          seed: int, batch_transform, compute_dt,
                          retry: int = 0,
                          health: Optional[HealthConfig] = None,
                          first_pass: bool = True) -> Dict[str, Any]:
    """One round's host-side work: sample -> per-τ-slice preprocessing
    (fresh random crops from a generator keyed (seed, round, slice), so a
    resume reproduces the crops) -> cast to `compute_dt` (read on the
    main thread: the policy is thread-local). Returns the world's
    [tau, world * local_batch, ...] batches; a bfloat16 input is a CPU
    `torch.bfloat16` tensor.

    `retry` is the rollback generation: a retried round draws logical
    round rnd + retry * 2**20 and re-keys the transform's generators
    (seed, that round, retry, slice). With `health` enabled, the
    configured rounds are poisoned before the cast, on their first pass
    only (`first_pass`: the round is above the highest one already run),
    so a retried window is clean while later configured rounds still
    fire."""
    data_rnd = rnd + retry * _RETRY_DATA_OFFSET if retry else rnd
    batches = source.next_round(round_index=data_rnd)
    if batch_transform is not None:
        slices = [batch_transform.convert_batch(
            {k: v[t] for k, v in batches.items()}, train=True,
            rng=np.random.default_rng((seed, data_rnd, retry, t)
                                      if retry else (seed, rnd, t)))
            for t in range(tau)]
        batches = {k: _stack([sl[k] for sl in slices]) for k in slices[0]}
    if health is not None and health.enabled and first_pass:
        if rnd in health.inject_nan_rounds:
            batches = poison_batch(batches, "nan")
        elif rnd in health.inject_spike_rounds:
            batches = poison_batch(batches, "spike",
                                   scale=health.inject_spike_scale)
    return precision.cast_host_inputs(batches, compute_dt)


def _record_scalars(loss: torch.Tensor, probe: Optional[torch.Tensor],
                    health: Optional[Dict[str, torch.Tensor]]):
    """A round's scalars (loss, probe, grad norm, nonfinite, the per-rank
    rows) as one new float32 vector, copied to pinned host memory behind
    an event on the card; returns (vector, event or None). The copy is
    taken now, so the next round's in-place update cannot reach it."""
    parts = [loss.reshape(1).float()]
    if probe is not None:
        parts.append(probe.reshape(1).float())
    if health is not None:
        parts += [health["grad_norm"].reshape(1).float(),
                  health["nonfinite"].reshape(1).float(),
                  health["nonfinite_by_worker"].reshape(-1).float()]
    vec = torch.cat(parts)
    if vec.device.type != "cuda":
        return vec, None
    host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
    host.copy_(vec, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def run_loop(cfg: RunConfig, trainer: ParallelTrainer,
             train_ds: ArrayDataset, test_ds: Optional[ArrayDataset],
             log: Logger, batch_transform=None, eval_transform=None,
             probe: Optional[Callable[[Any], torch.Tensor]] = None,
             round_hook=None, prefetch: bool = True) -> TrainState:
    """The round loop: resume, prepare, train, log, evaluate, checkpoint,
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
    timers = PhaseTimers()
    meter = ThroughputMeter(n_chips=n)
    if cfg.telemetry:
        trainer.phase_timers = timers  # the h2d / dispatch split
    # read on the MAIN thread: the policy is thread-local
    compute_dt = precision.compute_dtype()
    h2d_prefetch = bool(cfg.h2d_prefetch)

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

    def prepare_round(rnd: int, retry_: int, first_pass: bool):
        """Round `rnd`'s batches for this rank, placed on the device when
        h2d_prefetch is on; returns (batches, {"prep_s", "h2d_bytes"})."""
        t0 = time.perf_counter()
        with obs_trace.span("round_prep", round=rnd):
            batches = prepare_round_batches(
                sampler, rnd, cfg.tau, cfg.seed, batch_transform,
                compute_dt, retry=retry_,
                health=health_cfg if monitor else None,
                first_pass=first_pass)
            batches = {k: v[:, rank * lb:(rank + 1) * lb]
                       for k, v in batches.items()}
            if h2d_prefetch:
                with obs_trace.span("h2d_prefetch", round=rnd):
                    batches = trainer.place_batches(batches, compute_dt)
        return batches, {"prep_s": time.perf_counter() - t0}

    # the previous flush's own cost rides in the next record: a flush
    # cannot time itself into the row it is writing
    last_flush_ms = [0.0]
    collect_async = bool(cfg.collect_async)

    def flush_round_log(rec) -> None:
        """Emit one deferred round: wait for its scalars (the pipeline's
        real sync), classify it and log it."""
        t_flush0 = time.perf_counter()
        rnd_, (vec, done), round_s, breakdown = rec
        if done is not None:
            done.synchronize()
        vals = vec.tolist()
        t_collect = time.perf_counter() - t_flush0
        loss = vals[0]
        probe_v = vals[1] if probe is not None else None
        kv: Dict[str, Any] = {
            "loss": loss, "round_s": round(round_s, 6),
            "images_per_sec": round(cfg.tau * lb * n / round_s, 2),
            "images_per_sec_per_chip": round(
                meter.images_per_sec_per_chip(), 2)}
        if trainer.compute_health:
            i = 2 if probe is not None else 1
            kv["grad_norm"] = vals[i]
            kv["nonfinite"] = vals[i + 1]
            by_worker = vals[i + 2:]
            if max(by_worker) > 0:
                kv["worst_worker"] = int(np.argmax(by_worker))
        if breakdown is not None:
            if collect_async:
                breakdown["collect"] = 0.0
                breakdown["collect_bg"] = t_collect
            else:
                breakdown["collect"] = t_collect
            breakdown["log"] = last_flush_ms[0] / 1e3
            h2d_bytes = breakdown.pop("h2d_bytes")
            kv.update({f"t_{k}_ms": round(v * 1e3, 3)
                       for k, v in breakdown.items()})
            kv["h2d_bytes"] = h2d_bytes
        cls = None
        if monitor is not None:
            cls = monitor.observe(rnd_, loss, grad_norm=kv.get("grad_norm"),
                                  nonfinite_count=kv.get("nonfinite", 0.0))
            if cls != "ok":
                kv["health"] = cls
        probe_txt = (f"  probe: {probe_v:.6f}" if probe_v is not None
                     else "")
        log.log(f"round loss: {loss:.4f}{probe_txt}"
                + (f"  HEALTH: {cls}" if cls not in (None, "ok") else ""),
                rnd_)
        log.metrics(rnd_, **kv)
        if cls == "spike" and not monitor.rollback_needed:
            log.event(rnd_, "spike_skip", loss=loss)
        last_flush_ms[0] = (time.perf_counter() - t_flush0) * 1e3

    prep = ThreadPoolExecutor(1, thread_name_prefix="round-prep") \
        if prefetch else None
    pending = None  # the prefetched next round (a future)
    deferred: deque = deque()  # records not flushed yet
    collector = (ThreadPoolExecutor(1, thread_name_prefix="collect")
                 if collect_async else None)
    collect_pending: deque = deque()  # in-flight collector futures (FIFO)
    log_every = max(1, cfg.log_every)

    def flush_deferred(wait: bool = True) -> None:
        """Flush every deferred record: inline, or by handing them to the
        collector. `wait=False` (the in-round path only) returns without
        joining; every other call site drains, re-raising a collector
        failure. A bounded in-flight window keeps records from piling
        up."""
        if collector is None:
            while deferred:
                flush_round_log(deferred.popleft())
            return
        while deferred:
            collect_pending.append(
                collector.submit(flush_round_log, deferred.popleft()))
            while len(collect_pending) > max(4, 2 * log_every):
                collect_pending.popleft().result()
        if wait:
            while collect_pending:
                collect_pending.popleft().result()

    def drop_pending() -> None:
        """Drop the prefetched round: cancel it, or wait out a running
        prep (it must not race the retried round's), re-raising its
        failure."""
        nonlocal pending
        if pending is not None and not pending.cancel():
            pending.result()
        pending = None

    def recover(state):
        """Roll back to the newest verified non-anomalous checkpoint;
        returns (restored state, its round). Raises TrainingHealthError
        when the budget is spent or there is nothing to roll back to."""
        nonlocal retry, lr_scale
        flush_deferred()  # drain in-flight records of the same incident
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
        drop_pending()  # prepared for the old window
        log.event(ck_round, "rollback", reason=reason, target_step=ck_round,
                  rollbacks=monitor.rollbacks, retry=retry,
                  lr_scale=round(lr_scale, 6))
        return state, ck_round

    # per-round deltas of the accumulating phase timers
    last_tot: Dict[str, float] = {}

    def phase_delta(name: str) -> float:
        cur = timers.total.get(name, 0.0)
        d = cur - last_tot.get(name, 0.0)
        last_tot[name] = cur
        return d

    rnd = start_round
    loop_completed = False
    try:
        while rnd < cfg.max_rounds:
            if monitor is not None and monitor.rollback_needed:
                state, rnd = recover(state)
                continue
            if test_ds is not None and cfg.eval_every and \
                    rnd % cfg.eval_every == 0:
                flush_deferred()  # keep the log round-ordered
                if monitor is not None and monitor.rollback_needed:
                    continue  # don't evaluate a poisoned state
                with timers.phase("eval"):
                    acc = _evaluate(trainer, state, test_ds, cfg.eval_batch,
                                    transform=eval_transform)
                log.log(f"test accuracy: {acc:.4f}", rnd)
                log.metrics(rnd, test_accuracy=acc)
            with timers.phase("sample"):
                batches, info = (pending.result() if pending is not None
                                 else prepare_round(rnd, retry,
                                                    rnd > high_water))
            pending = None
            if prep is not None and rnd + 1 < cfg.max_rounds:
                pending = prep.submit(prepare_round, rnd + 1, retry,
                                      rnd + 1 > high_water)
            high_water = max(high_water, rnd)
            # a retried round keys its dropout masks anew as well
            key = (cfg.seed, rnd) + ((retry,) if retry else ())
            with timers.phase("train_round"):
                state, loss = trainer.train_round(state, batches, key,
                                                  lr_scale=lr_scale)
                del batches  # the slot or buffers go back with the round
                scalars = _record_scalars(
                    loss, probe(state) if probe else None,
                    trainer.last_health)
                if len(deferred) >= log_every:
                    flush_deferred(wait=False)
            round_s = phase_delta("train_round")
            meter.add(cfg.tau * lb * n, round_s)
            breakdown = None
            if cfg.telemetry:
                breakdown = {"data": phase_delta("sample"),
                             "h2d": phase_delta("h2d"),
                             "round": phase_delta("dispatch"),
                             # stage 1 of the previous round's save, which
                             # delayed this one
                             "ckpt_fetch": phase_delta("checkpoint"),
                             "prep": info["prep_s"],
                             "h2d_bytes": trainer.h2d_bytes}
            deferred.append((rnd, scalars, round_s, breakdown))
            if ckdir and cfg.checkpoint_every and \
                    (rnd + 1) % cfg.checkpoint_every == 0:
                flush_deferred()  # keep the log round-ordered
                if monitor is not None and monitor.rollback_needed:
                    continue  # never checkpoint a poisoned state; the
                    #           loop top recovers instead
                anomalous = (monitor is not None
                             and monitor.recently_anomalous(rnd))
                with timers.phase("checkpoint"):
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
            if rnd >= cfg.max_rounds:
                # the last rounds' records are still deferred: an
                # incident there recovers before the final checkpoint
                flush_deferred()
                if monitor is not None and monitor.rollback_needed:
                    state, rnd = recover(state)
        loop_completed = True
    finally:
        # an aborted loop: drain what can be drained without masking the
        # exception already propagating; leave no thread running
        if deferred and not loop_completed:
            try:
                flush_deferred()
            except Exception as e:
                log.log(f"deferred round flush failed during abort: {e}")
        if pending is not None:
            pending.cancel()
        if prep is not None:
            prep.shutdown(wait=True, cancel_futures=True)
        if collector is not None:
            try:
                while collect_pending:
                    collect_pending.popleft().result()
            except Exception as e:
                if loop_completed:
                    raise
                log.log(f"round collector failed during abort: {e}")
            finally:
                collector.shutdown(wait=True)
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
              test_ds: ArrayDataset, eval_batch: int, transform=None
              ) -> float:
    """Accuracy over the test set in global batches of `eval_batch`, each
    split evenly over the ranks (this rank evaluates its block); a tail
    past the last full batch runs as one smaller batch, weighted by its
    size. At most n-1 trailing examples are left out. `transform`
    converts each batch of raw examples (`convert_batch(train=False)`:
    e.g. a center crop and the mean on uint8 pixels), so one batch of
    net inputs exists at a time."""
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
        if transform is not None:
            batch = transform.convert_batch(batch, train=False)
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
