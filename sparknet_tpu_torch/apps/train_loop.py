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

Where the ranks sit (`parallel/mesh.py:machine_topology`): rank r is
local rank l of the local_size ranks on machine m — the JAX package's
device l of host m. A dataset `train_ds` is this machine's corpus (every
rank of a machine loads the same one; the ImageNet app gives machine m
its shards m::n_machines): each round draws `RoundSampler.next_round(
round_index=r)` with local_size workers over it, a `batch_transform` (the
ImageNet app's crop, mean and cast) runs on each τ-slice of that machine
batch with a round-keyed generator, and this rank takes block l of the
batch axis — the data the JAX package's device l of host m gets. On one
machine that is block `rank` of the world batch.

`train_ds` may instead be a round SOURCE, an object with
`next_round(round_index=...)` (`data/streaming.py`'s sources over tar
shards larger than host RAM, with one worker: this rank's batch): it
replaces the sampler. A streaming source is stateful: its position is
a cursor, which each checkpoint records as `extra["stream"]` in the JAX
package's format — one list per machine of [shard, entry, epochs] rows,
one row per reader, gathered over the group in local-rank order — taken
at the round the checkpoint follows (`cursor_at`), not at the prefetched
next one. A resume seeks every rank's readers to its rows; a checkpoint
of another machine count or reader count restarts the stream at shard 0.
A rollback drops the prefetched round and the stream simply continues.

The round pipeline, as the JAX loop runs it by default:
  - round prep (sampling, the transform, the cast to the compute dtype:
    `prepare_round_batches`) for round R+1 runs on a one-deep `round-prep`
    thread while round R runs; `prefetch=False` prepares every round
    inline on the main thread instead (the synchronous loop);
  - `h2d_prefetch`: that thread also places round R+1 on the card
    (the trainer's `place_batches`, `ParallelTrainer`'s or
    `GraphTrainer`'s, both through `parallel/trainer.py:BatchPlacer`:
    pinned staging, a copy stream, an event the compute stream waits on),
    so the round's `h2d` phase is a pass-through; `donate_batches`
    rotates placed rounds through two device slots;
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
    time, on whichever thread ran it), h2d_bytes and h2d_async_bytes
    (those of them that crossed through pinned staging on the copy
    stream: all on a card, 0 on the CPU).
Every round record carries `round_s`, the host's time to queue the round
(the `train_round` phase: on a card the call returns once the round is
queued); the heartbeats' and the pod view's straggler input
(`sparknet_train_round_seconds`) is its `dispatch` share. On a card the
round's `done` event (after its scalars' copy) is a timing event, and
from the second flushed round on the record carries `t_card_round_ms`,
the card's time from the previous flushed round's `done` to this one's:
the round's period. `images_per_sec`, `images_per_sec_per_chip` and the
throughput meter's gauge read that period, else (the CPU, a card's first
round) `round_s`.
The prep thread's and the collector's exceptions re-raise in the main
thread.

Checkpoints (`checkpoint_dir`) are the reference's replica layout on a
local directory or a bucket prefix (gs://, s3://; a world over several
machines needs a store every machine reads), in one of two file layouts
(`checkpoint_sharded`: "auto" is per-shard above one rank and monolithic
at one, "on" per-shard at any size, "off" monolithic):
  - per-shard (`utils/checkpoint.py:save_sharded`): stage 1, on every
    rank, copies only that rank's rows off the card (`parallel/trainer.
    py:checkpoint_shards`, no gather); above one rank the writers are
    drained, rank 0 clears the step between two barriers
    (`prepare_sharded_step`), then every rank writes its own shard file
    (stage 2) and rank 0 commits the manifest;
  - monolithic (`checkpoint_tree`): stage 1 gathers the momentum and
    copies the state to host memory; rank 0 writes it alone.
Stage 2 runs inline or on each rank's background writer
(`checkpoint_async`). `resume` restarts at the newest step of either
layout, with the health supervisor's state (`extra["health"]`). A
nonfinite round, or a run of spikes, rolls back to the newest verified
non-anomalous step with the learning rate scaled by `lr_backoff`; the
prefetched round is dropped and the retried rounds draw another data
window (round R of rollback generation g samples logical round
R + g * 2**20, its transform generators keyed (seed, R + g * 2**20, g,
t)).

Telemetry, as the JAX loop's (`telemetry`, or a `status_port`, builds a
per-run metrics registry that the phase timers, the throughput meter, the
health monitor, the checkpoint writer, the heartbeat and the membership
controller register into, with the JAX loop's metric names; the card's
memory is sampled at every flush, `obs/device.py`):
  - `status_port`: each machine's local rank 0 serves /metrics, /healthz
    and /status (the JAX package serves one per process, and a process
    there is a machine); port 0 binds an ephemeral port, written back to
    `cfg.status_address`;
  - `heartbeat_path`: global rank 0 rewrites one heartbeat at every flush
    and boundary (`utils/heartbeat.py`);
  - `pod_dir`: each machine's local rank 0 rewrites
    `worker-<machine>.heartbeat.json` under it, with `round_s`,
    `data_wait_s` and, when elastic, `membership_epoch` and `n_members`;
    `pod_port`: global rank 0 serves the pod view over that prefix
    (`obs/pod.py:PodAggregator`; the address goes to `cfg.pod_address`).

Elastic membership (`elastic`, which needs `pod_dir` and
`checkpoint_dir`): global rank 0's `MembershipController` (its own worker
is machine 0) watches the machines' heartbeats and decides for the world.
At every τ boundary, on every rank, its decision — a membership event or
none, and with `tau_adapt` the per-rank τ vector — is broadcast on a gloo
side group (a world of one needs no collective): the number of collectives
never depends on the wall clock or the poll's rate limit, and the NCCL
round stays queued. At launch every machine beats, then rank 0 seeds the
membership; fewer members than `min_workers` raise TrainingHealthError
before round 0. A port process drives one card and a torch process group
cannot drop or add a member in place, so every membership change takes
the JAX package's relaunch branches:
  - one machine: drain the pipeline (the deferred records, the prefetched
    round, the in-flight write), write the boundary checkpoint, log the
    `resize` event and beat "resize", then raise TrainingHealthError
    below `min_workers`, else `ElasticRelaunch` (exit 75);
  - several machines: the same without the boundary save — the relaunch
    resumes from the newest periodic step.
Before it raises, each machine's local rank 0 writes the new membership
where the relaunch supervisor asked (`parallel/elastic.py:
write_relaunch_record`), and `parallel/supervise.py` relaunches at the
size it implies. The relaunched run resumes at its new size through
`ParallelTrainer.state_from_checkpoint` (the elastic resume, "ELASTIC
resume" in the log, as after any supervised exit 75; a rollback target
of another size too): params exact, momentum reconstructed per
`elastic.momentum_policy`; a fresh sampler over the new rank count is
the JAX package's resharded one.

Observability levers, on rank 0: `trace_out` records the host spans
(round_prep, h2d_prefetch, the phase timers' sample / train_round / h2d /
dispatch / checkpoint / eval, checkpoint_write on the writer's thread;
inside dispatch the trainers' step, forward, backward, solver and
exchange spans with round and step, and a graph's per-node op spans)
and a `flush` instant with round and loss per flushed round
(`obs/trace.py`), written when the loop ends ("host trace written to
..."). On a card the tracer also times forward, backward, solver and
exchange there (`obs/trace.py:CardClock`; at a round boundary, once its
anchor is 10 s old, a synchronize re-anchors the card's clock to the
host's): the main thread hands each round's card spans to its record,
the flush resolves them after the round's `done`, writes them on the
trace's `card` lane, and adds `card_forward_ms`, `card_backward_ms`,
`card_solver_ms`, `card_exchange_ms` (card ms summed over the round) and
`host_lead_ms` (the smallest lead of the host over the card at a span
edge) to the record; without a tracer there are no such fields and no
events beyond `done`. `profile_dir` runs round start_round + 1 under
`torch.profiler` (`utils/profiling.py`: CPU and, on the card, CUDA
activity) and exports its Chrome trace there; with `trace_out` as well,
each span is a `record_function` range in it.

The trainer (`resolve_trainer_impl`, the JAX loop's): `trainer_impl`
"shard_map" is `ParallelTrainer` (the replica layout), "named" is
`parallel/sharded.py:ShardedTrainer` (the logical layout, with
`state_sharding` "replicated", "momentum" or "full"), and "auto" reads
$SPARKNET_TRAINER_IMPL, else "shard_map". A step's `extra` carries the
layout and state sharding under the JAX keys when the layout is logical,
and a resume of another topology, layout or state sharding takes the
trainer's `adapt_state` ("ELASTIC resume" in the log). Tensor parallelism
is reached through the trainers' API (`tp=`), not through the loop, as in
the JAX package.

Not ported: a lever that does not change the numbers is accepted and
logged as not yet ported: `fused_boundary` (an eager round already
averages right after its last step).

`compile_cache_dir` points the kernel builds at the warm-up cache
(`utils/compile_cache.py`: the shared kernel-build directory; a relaunched
worker with a warm directory runs no nvcc), logged as the JAX loop logs
its persistent compile cache. The run's registry carries the compile
events (`sparknet_compile_events_total`, `sparknet_compile_seconds`:
`obs/device.attach_compile_metrics`), the spec compile that preceded it
replayed.

`history` runs the SLO ledger's metrics-history sampler over the run's
registry on each machine's local rank 0 (the process that serves the
machine's /metrics, the JAX loop's per-host process): `/timeseries` on
the status server, and JSONL shards in `history_dir` for
`python -m sparknet_tpu_torch.obs.slo` (`obs/history.py`).
"""
from __future__ import annotations

import os
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import precision
from ..data.dataset import ArrayDataset, RoundSampler
from ..model.layers import OpsImpl
from ..model.net import CompiledNet
from ..model.spec import NetSpec
from ..obs import device as obs_device
from ..obs import pod as obs_pod
from ..obs import trace as obs_trace
from ..obs.http import StatusServer
from ..obs.meta import register_build_info
from ..obs.registry import MetricsRegistry
from ..parallel.elastic import (RELAUNCHED_ENV, ElasticRelaunch,
                                MembershipController, write_relaunch_record)
from ..parallel.mesh import DataGroup, init_data_group, machine_topology
from ..parallel.sharded import ShardedTrainer
from ..parallel.trainer import ParallelTrainer, TrainState
from ..utils import checkpoint as ckpt
from ..utils.config import RunConfig
from ..utils.health import (HealthConfig, HealthMonitor, TrainingHealthError,
                            poison_batch)
from ..utils.heartbeat import HeartbeatWriter, worker_sort_key
from ..utils.logger import Logger, default_logger
from ..utils.metrics import PhaseTimers, ThroughputMeter
from ..utils.profiling import maybe_trace

_NOT_PORTED_LEVERS = ("fused_boundary",)

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


def resolve_trainer_impl(cfg: RunConfig) -> str:
    """cfg.trainer_impl -> "shard_map" (`ParallelTrainer`) or "named"
    (`ShardedTrainer`): "auto" defers to $SPARKNET_TRAINER_IMPL and falls
    back to "shard_map" (the JAX loop's rule). A state sharding other
    than "replicated" needs the named trainer."""
    impl = cfg.trainer_impl
    if impl == "auto":
        impl = os.environ.get("SPARKNET_TRAINER_IMPL", "shard_map")
    if impl not in ("shard_map", "named"):
        raise ValueError(f"unknown trainer_impl {impl!r}: expected "
                         f"'auto', 'shard_map', or 'named'")
    if impl != "named" and cfg.state_sharding != "replicated":
        raise ValueError(
            f"state_sharding={cfg.state_sharding!r} needs the NamedSharding "
            f"trainer — set trainer_impl='named' (resolved: {impl!r})")
    return impl


def check_config(cfg: RunConfig) -> list:
    """Raise on settings that are not valid or not ported; return the
    names of the accepted-but-not-ported levers that are on."""
    if cfg.checkpoint_sharded not in ("auto", "on", "off"):
        raise ValueError(f"checkpoint_sharded={cfg.checkpoint_sharded!r}: "
                         f"expected 'auto', 'on', or 'off'")
    resolve_trainer_impl(cfg)
    if cfg.ops_interpret:
        raise ValueError("ops_interpret runs Pallas kernels under the JAX "
                         "interpreter; the port has none")
    return [k for k in _NOT_PORTED_LEVERS if getattr(cfg, k)]


def probe_value(state: TrainState, net: CompiledNet) -> torch.Tensor:
    """First scalar of the first parametric layer's weights — the
    reference's divergence probe (`apps/CifarApp.scala:147`) — as a 0-d
    view of the params; the loop copies it into the round's record before
    the next round updates the params in place. Where the params at rest
    are split ("full" state sharding) the round left it in `state.head`."""
    if state.head is not None:
        return state.head
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
    `train_ds` / `test_ds` are this machine's share (module docstring).
    `prefetch=False` prepares each round on the main thread (module
    docstring). Returns the final state."""
    log = logger or default_logger(cfg.workdir)
    levers = check_config(cfg)
    precision.set_policy(cfg.precision)
    resolve_solver(cfg)
    # the warm-up cache (process-global): every kernel this run builds,
    # and every relaunched worker's, goes through it
    from ..utils.compile_cache import init_compile_cache
    cache = init_compile_cache(cfg.compile_cache_dir)
    if cache:
        log.log(f"warm-up cache (kernel builds): {cache}")
    net = CompiledNet.compile(spec)
    group = init_data_group(device, workdir=cfg.workdir)
    try:
        if cfg.n_devices is not None and cfg.n_devices != group.size:
            raise ValueError(f"n_devices={cfg.n_devices}, but the data "
                             f"group has {group.size} ranks (one per card)")
        compute_health = cfg.health is not None and cfg.health.enabled
        elastic_tau = (cfg.elastic is not None and cfg.elastic.enabled
                       and cfg.elastic.tau_adapt)
        trainer_kw: Dict[str, Any] = {}
        trainer_cls = ParallelTrainer
        if resolve_trainer_impl(cfg) == "named":
            trainer_cls = ShardedTrainer
            trainer_kw["state_sharding"] = cfg.state_sharding
        trainer = trainer_cls(net, cfg.solver, group, tau=cfg.tau,
                              mode=cfg.mode, compute_health=compute_health,
                              elastic_tau=elastic_tau,
                              ops=OpsImpl(lrn=cfg.lrn_impl,
                                          pool=cfg.pool_impl),
                              donate_batches=cfg.donate_batches,
                              **trainer_kw)
        log.log(f"data group: rank {group.rank} of {group.size} on "
                f"{group.device}; trainer {trainer_cls.__name__} "
                f"(state_sharding="
                f"{trainer.state_sharding}); "
                f"tau={cfg.tau} mode={cfg.mode} "
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


def prepare_round_batches(source, rnd: int, tau: int,
                          seed: int, batch_transform, compute_dt,
                          retry: int = 0,
                          health: Optional[HealthConfig] = None,
                          first_pass: bool = True) -> Dict[str, Any]:
    """One round's host-side work: sample -> per-τ-slice preprocessing
    (fresh random crops from a generator keyed (seed, round, slice), so a
    resume reproduces the crops) -> cast to `compute_dt` (read on the
    main thread: the policy is thread-local). `source` is a
    `RoundSampler` or a round source (`next_round`). Returns the source's
    [tau, workers * local_batch, ...] batches; a bfloat16 input is a CPU
    `torch.bfloat16` tensor.

    `retry` is the rollback generation: a retried round of a stateless
    sampler draws logical round rnd + retry * 2**20, and the transform's
    generators are re-keyed (seed, that round, retry, slice). A stateful
    streaming source keeps the true round index (its cursors are keyed on
    it): continuing the stream already moves the data on. With `health`
    enabled, the
    configured rounds are poisoned before the cast, on their first pass
    only (`first_pass`: the round is above the highest one already run),
    so a retried window is clean while later configured rounds still
    fire."""
    stateless = isinstance(source, RoundSampler)
    data_rnd = rnd + retry * _RETRY_DATA_OFFSET if retry and stateless \
        else rnd
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
    """A round's scalars (loss, probe, grad norm, nonfinite) as one new
    float32 vector, copied to pinned host memory behind a timing event on
    the card (the round's `done`: the loop times the card's round period
    between two of them); returns (vector, event or None). The copy is
    taken now, so the next round's in-place update cannot reach it."""
    parts = [loss.reshape(1).float()]
    if probe is not None:
        parts.append(probe.reshape(1).float())
    if health is not None:
        parts += [health["grad_norm"].reshape(1).float(),
                  health["nonfinite"].reshape(1).float()]
    vec = torch.cat(parts)
    if vec.device.type != "cuda":
        return vec, None
    host = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
    host.copy_(vec, non_blocking=True)
    done = torch.cuda.Event(enable_timing=True)
    done.record()
    return host, done


def run_loop(cfg: RunConfig, trainer: ParallelTrainer,
             train_ds: ArrayDataset, test_ds: Optional[ArrayDataset],
             log: Logger, batch_transform=None, eval_transform=None,
             probe: Optional[Callable[[Any], torch.Tensor]] = None,
             round_hook=None, prefetch: bool = True) -> TrainState:
    """The round loop: resume, prepare, train, log, evaluate, checkpoint,
    roll back (see the module docstring). Generic over the trainer, as the
    JAX loop is: `ParallelTrainer` / `ShardedTrainer` for the layer IR,
    `parallel/graph_trainer.py:GraphTrainer` for serialized graphs. A
    trainer without `supports_lr_scale` takes no lr backoff on a rollback,
    and one without `checkpoint_shards` saves monolithic steps."""
    rank, n = trainer.group.rank, trainer.group.size
    if log.worker is None and n > 1:
        log.worker = rank  # stamp each rank's JSONL records
    lb = cfg.local_batch
    ckdir = cfg.checkpoint_dir
    topo = machine_topology(trainer.group)
    machine, n_machines, local_rank, local_size = topo
    where = (f"{n} ranks: machine {machine} of {n_machines}, local rank "
             f"{local_rank} of {local_size}")
    if hasattr(train_ds, "next_round"):
        source = train_ds
        if getattr(source, "n_workers", 1) != 1:
            raise ValueError(
                f"a round source of {source.n_workers} workers: a rank's "
                f"source holds its own batch (one worker)")
        block = 0
        log.log(f"train source: streaming ({where})"
                + (f"; test examples: {len(test_ds)}" if test_ds else ""))
    else:
        source = RoundSampler(train_ds, local_size, lb, cfg.tau,
                              seed=cfg.seed)
        block = local_rank
        log.log(f"train examples: {len(train_ds)} on this machine "
                f"({len(train_ds) // local_size} per rank; {where})"
                + (f"; test examples: {len(test_ds)}" if test_ds else ""))
    # elastic membership: the heartbeats under pod_dir are how it is
    # observed, the verified checkpoint store is how a resize recovers
    elastic_cfg = (cfg.elastic if cfg.elastic is not None
                   and cfg.elastic.enabled else None)
    if elastic_cfg is not None and not cfg.pod_dir:
        raise ValueError(
            "cfg.elastic.enabled requires cfg.pod_dir: the per-worker "
            "heartbeats under it are how membership is observed")
    if elastic_cfg is not None and not ckdir:
        raise ValueError(
            "cfg.elastic.enabled requires cfg.checkpoint_dir: a resize "
            "restores workers from the newest verified checkpoint")
    # a step of another world size restores through adapt_state with the
    # policy the JAX package's live resize applies
    policy = (elastic_cfg.momentum_policy if elastic_cfg is not None
              else "norm_rescale")
    state = trainer.init_state(cfg.seed)
    start_round = 0
    resumed_extra: Dict[str, Any] = {}
    if ckdir and cfg.resume and ckpt.latest_step(ckdir) is not None:
        flat, start_round, resumed_extra = ckpt.restore_flat(ckdir)
        saved_n = trainer.saved_world(flat, resumed_extra)
        same_topo = trainer.same_topology(flat, resumed_extra)
        state = trainer.state_from_checkpoint(flat, resumed_extra, policy)
        if same_topo and os.environ.get(RELAUNCHED_ENV) != "1":
            log.log(f"resumed from checkpoint round {start_round}")
        else:
            log.log(f"ELASTIC resume from round {start_round}: {saved_n} "
                    f"devices (tp={resumed_extra.get('tp', 1)}, layout "
                    f"{resumed_extra.get('layout', 'replica')}) -> {n} "
                    f"(tp={trainer.tp}, layout {trainer.state_layout}), "
                    f"momentum {policy}")
        _seek_stream(source, resumed_extra, log, topo)

    # the per-run registry every meter, supervisor and writer below
    # registers into; a status_port forces it (an empty /metrics would
    # betray the scrape surface it asks for)
    registry = (MetricsRegistry()
                if cfg.telemetry or cfg.status_port is not None else None)
    g_round = g_loss = c_rounds = g_round_s = g_wait_s = dev_tel = None
    if registry is not None:
        register_build_info(registry)
        g_round = registry.gauge("sparknet_train_round",
                                 "last flushed round index")
        g_loss = registry.gauge("sparknet_train_loss",
                                "last flushed round loss")
        c_rounds = registry.counter("sparknet_train_rounds_total",
                                    "rounds dispatched")
        # the pod aggregator's straggler inputs: this worker's last round
        # wall time and residual data wait
        g_round_s = registry.gauge(
            "sparknet_train_round_seconds",
            "last round wall time on this worker")
        g_wait_s = registry.gauge(
            "sparknet_train_data_wait_seconds",
            "last round's residual data wait on this worker")
        dev_tel = obs_device.DeviceTelemetry(registry,
                                             devices=[trainer.device])
        obs_device.attach_compile_metrics(registry)
    health_cfg = (cfg.health if cfg.health is not None
                  else HealthConfig(enabled=False))
    monitor = (HealthMonitor(health_cfg, registry=registry)
               if health_cfg.enabled else None)
    # stage-2 background writer (at most one snapshot in flight); None =
    # synchronous saves
    ck_writer = (ckpt.AsyncCheckpointWriter(registry=registry)
                 if ckdir and cfg.checkpoint_async else None)
    timers = PhaseTimers(registry=registry)
    meter = ThroughputMeter(n_chips=n, registry=registry)
    # heartbeats: global rank 0 writes heartbeat_path; each machine's
    # local rank 0 writes its pod heartbeat (registry=None: the primary
    # heartbeat owns the sparknet_heartbeat_* families)
    heartbeat = (HeartbeatWriter(cfg.heartbeat_path, role="train",
                                 interval_s=cfg.heartbeat_every_s,
                                 registry=registry)
                 if cfg.heartbeat_path and rank == 0 else None)
    pod_hb = (HeartbeatWriter(
        obs_pod.worker_heartbeat_path(cfg.pod_dir, machine), role="train",
        interval_s=cfg.heartbeat_every_s)
        if cfg.pod_dir and local_rank == 0 else None)
    # global rank 0 decides membership for the world (its worker is
    # machine 0); the decision reaches the other ranks over a gloo side
    # group, so reading it never waits on the NCCL round in flight
    membership = (MembershipController(
        elastic_cfg, cfg.pod_dir, self_worker=machine,
        expected_workers=n_machines, registry=registry)
        if elastic_cfg is not None and rank == 0 else None)
    side = (dist.new_group(backend="gloo")
            if elastic_cfg is not None and n > 1 else None)
    #: the membership as the last agreement left it (every rank)
    member_view: Dict[str, Any] = {"epoch": 0, "n_members": None}
    # live vitals for /healthz and /status; beat_ts is the loop's own
    # freshness stamp, so a hung loop whose HTTP thread still answers
    # reads as stale to the pod aggregator
    vitals: Dict[str, Any] = {"role": "train", "round": start_round,
                              "status": "ok", "loss": None,
                              "worker": machine, "round_s": None,
                              "data_wait_s": None,
                              "beat_ts": round(time.time(), 3)}
    # the servers and the side group are released in the loop's finally
    status_srv = pod_srv = None
    if cfg.status_port is not None and local_rank == 0:
        try:
            status_srv = StatusServer(
                cfg.status_port, registry, host=cfg.status_host,
                healthz=lambda: (vitals["status"] not in ("nonfinite",),
                                 dict(vitals)),
                status=lambda: {**vitals,
                                "rollbacks": (monitor.rollbacks
                                              if monitor else 0),
                                "phase_means": timers.summary()})
        except OSError as e:
            # a taken port degrades observability, never training
            warnings.warn(f"status server failed to bind port "
                          f"{cfg.status_port}: {e}; continuing without",
                          RuntimeWarning)
        else:
            cfg.status_address = status_srv.address
            log.log(f"train status server at http://"
                    f"{status_srv.address[0]}:{status_srv.address[1]}"
                    f"/metrics")
    # the SLO ledger's history sampler: the training process gets the
    # same /timeseries surface serve and router processes get, plus JSONL
    # shards for the SLO report
    history = None
    if cfg.history and registry is not None and local_rank == 0:
        from ..obs.history import HistoryConfig, MetricsHistory
        history = MetricsHistory(
            registry,
            HistoryConfig(sample_interval_s=cfg.history_interval_s,
                          persist_dir=cfg.history_dir),
            logger=log).start()
        if status_srv is not None:
            history.attach_http(status_srv)
    if cfg.pod_port is not None and cfg.pod_dir and rank == 0:
        try:
            # one staleness rule: the aggregator's down verdicts use the
            # threshold the membership controller evicts on
            pod_srv = obs_pod.PodAggregator(
                pod_dir=cfg.pod_dir,
                stale_after_s=(elastic_cfg.stale_after_s
                               if elastic_cfg is not None else 120.0)
            ).serve(cfg.pod_port, host=cfg.status_host)
        except OSError as e:
            warnings.warn(f"pod status server failed to bind port "
                          f"{cfg.pod_port}: {e}; continuing without",
                          RuntimeWarning)
        else:
            cfg.pod_address = pod_srv.address
            log.log(f"pod status server at http://{pod_srv.address[0]}:"
                    f"{pod_srv.address[1]}/pod/status")
    if cfg.telemetry:
        trainer.phase_timers = timers  # the h2d / dispatch split
    # read on the MAIN thread: the policy is thread-local
    compute_dt = precision.compute_dtype()
    # the graph backend's in-graph optimizer owns its learning rate
    supports_lr = bool(getattr(trainer, "supports_lr_scale", True))
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

    def beat(step: int, status: str, force: bool = False, **kv) -> None:
        """Rewrite this rank's heartbeats (best-effort: a full disk must
        degrade observability, not kill the run)."""
        rollbacks = monitor.rollbacks if monitor is not None else 0
        if elastic_cfg is not None:
            # the epoch rides every beat, so the pod view sees resizes
            kv.setdefault("membership_epoch", member_view["epoch"])
            kv.setdefault("n_members", member_view["n_members"])
        for hb, extra in ((heartbeat, kv),
                          (pod_hb, {**kv, "worker": machine,
                                    "n_workers": n_machines,
                                    "round_s": vitals.get("round_s"),
                                    "data_wait_s": vitals.get(
                                        "data_wait_s")})):
            if hb is None:
                continue
            try:
                hb.beat(step, status=status, force=force,
                        rollbacks=rollbacks, **extra)
            except OSError as e:
                warnings.warn(f"heartbeat write failed: {e}", RuntimeWarning)

    def expand_tau(by_worker: Optional[Dict[str, int]]):
        """Per-worker τ budgets -> one per rank. Over several machines a
        rank's owner is its machine; on one machine the members own
        contiguous blocks of ranks in sorted-id order (the JAX package's
        single-process rule). Unknown owners run the full τ."""
        if not by_worker:
            return None
        if n_machines > 1:
            return [by_worker.get(str(r // local_size), cfg.tau)
                    for r in range(n)]
        order = sorted(membership.members, key=worker_sort_key)
        m = max(1, len(order))
        return [by_worker.get(order[min(r * m // n, m - 1)], cfg.tau)
                for r in range(n)]

    def agree(rnd: int, bootstrap: bool = False) -> Dict[str, Any]:
        """Rank 0's membership decision at this boundary, on every rank:
        {"event": MembershipEvent or None, "tau": per-rank budgets or
        None, "epoch", "members"}. Rank 0 polls (the first poll seeds the
        membership); the decision is broadcast on the gloo side group at
        every boundary, whatever the poll's rate limit says, so every
        rank runs the same collectives and takes the same branch."""
        decision = None
        if membership is not None:
            ev = membership.poll(rnd, force=bootstrap)
            tau = (expand_tau(membership.tau_by_worker(cfg.tau))
                   if ev is None and not bootstrap and trainer.elastic_tau
                   else None)
            decision = {"event": ev, "tau": tau, "epoch": membership.epoch,
                        "members": tuple(sorted(membership.members,
                                                key=worker_sort_key))}
        if side is not None:
            box = [decision]
            dist.broadcast_object_list(box, src=0, group=side)
            decision = box[0]
        member_view.update(epoch=decision["epoch"],
                           n_members=len(decision["members"]))
        return decision

    def leave_record(ev) -> None:
        """The new membership, for the relaunch supervisor (one writer a
        machine: its local rank 0)."""
        if local_rank == 0:
            path = write_relaunch_record(ev, n, machine, n_machines,
                                         local_size)
            if path is not None:
                log.log(f"elastic: relaunch record written to {path}")

    def apply_resize(state, ev, rnd: int):
        """A membership change at this τ boundary: the JAX package's
        relaunch branches (module docstring). Always raises:
        ElasticRelaunch (exit 75), or TrainingHealthError below
        min_workers."""
        flush_deferred()
        drop_pending()  # wait out a running prep: never race the source
        what = (f"membership epoch {ev.epoch}: {ev.n_workers} worker(s) "
                f"(dead {list(ev.dead)}, joined {list(ev.joined)})")
        below = ev.n_workers < max(1, elastic_cfg.min_workers)
        vitals["membership_epoch"] = ev.epoch
        if n_machines > 1:
            # no boundary save: the relaunch resumes from the newest
            # periodic step (the JAX package's multi-host branch)
            log.event(rnd, "resize", epoch=ev.epoch, dead=list(ev.dead),
                      joined=list(ev.joined), reasons=ev.reasons,
                      n_workers=ev.n_workers, relaunch=True)
            beat(rnd, "resize", force=True, dead=list(ev.dead),
                 joined=list(ev.joined))
            if below:
                raise TrainingHealthError(
                    f"elastic: the world fell to {ev.n_workers} worker(s) "
                    f"(dead: {list(ev.dead)}), below min_workers="
                    f"{elastic_cfg.min_workers}. Resume from the newest "
                    f"periodic checkpoint under {ckdir!r} once capacity "
                    f"returns.")
            log.log(f"elastic: {what}; exit 75 to relaunch at the new "
                    f"size from the newest periodic checkpoint", rnd)
            leave_record(ev)
            raise ElasticRelaunch(f"{what}; several machines relaunch at "
                                  f"the new size")
        ckpt_barrier()
        with timers.phase("checkpoint"):
            _save_checkpoint(cfg, trainer, state, rnd, source=source,
                             last_round=rnd - 1, local_size=local_size,
                             anomalous=(monitor is not None and
                                        monitor.recently_anomalous(rnd)),
                             health_state=_health_state(retry, lr_scale,
                                                        monitor))
        log.event(rnd, "resize", epoch=ev.epoch, dead=list(ev.dead),
                  joined=list(ev.joined), reasons=ev.reasons,
                  n_workers=ev.n_workers)
        beat(rnd, "resize", force=True, dead=list(ev.dead),
             joined=list(ev.joined))
        if below:
            raise TrainingHealthError(
                f"elastic: the world fell to {ev.n_workers} worker(s) "
                f"(dead: {list(ev.dead)}), below min_workers="
                f"{elastic_cfg.min_workers}. A verified checkpoint at round "
                f"{rnd} is saved under {ckdir!r} — relaunch with capacity "
                f"to continue.")
        log.log(f"elastic: {what}; checkpointed round {rnd}, exit 75 to "
                f"relaunch at the new size", rnd)
        leave_record(ev)
        raise ElasticRelaunch(f"{what}; checkpointed round {rnd}")

    def prepare_round(rnd: int, retry_: int, first_pass: bool):
        """Round `rnd`'s batches for this rank, placed on the device when
        h2d_prefetch is on; returns (batches, {"prep_s", "h2d_bytes"})."""
        t0 = time.perf_counter()
        with obs_trace.span("round_prep", round=rnd):
            batches = prepare_round_batches(
                source, rnd, cfg.tau, cfg.seed, batch_transform,
                compute_dt, retry=retry_,
                health=health_cfg if monitor else None,
                first_pass=first_pass)
            batches = {k: v[:, block * lb:(block + 1) * lb]
                       for k, v in batches.items()}
            if h2d_prefetch:
                with obs_trace.span("h2d_prefetch", round=rnd):
                    batches = trainer.place_batches(batches, compute_dt)
        return batches, {"prep_s": time.perf_counter() - t0}

    # the previous flush's own cost rides in the next record: a flush
    # cannot time itself into the row it is writing
    last_flush_ms = [0.0]
    # the last flushed round's `done` event: the card's round period runs
    # from it to the next one's
    last_done = [None]
    collect_async = bool(cfg.collect_async)

    def flush_round_log(rec) -> None:
        """Emit one deferred round: wait for its scalars (the pipeline's
        real sync), classify it and log it."""
        t_flush0 = time.perf_counter()
        rnd_, (vec, done), round_s, breakdown, card_spans = rec
        if done is not None:
            done.synchronize()
        vals = vec.tolist()
        t_collect = time.perf_counter() - t_flush0
        loss = vals[0]
        probe_v = vals[1] if probe is not None else None
        kv: Dict[str, Any] = {"loss": loss, "round_s": round(round_s, 6)}
        # the round's period: on a card, the card's time from the last
        # flushed round's done event to this one's; else (and for a
        # card's first round) the host's time to queue the round
        period_s = round_s
        if done is not None:
            if last_done[0] is not None:
                card_ms = last_done[0].elapsed_time(done)
                kv["t_card_round_ms"] = round(card_ms, 3)
                period_s = card_ms / 1e3
            last_done[0] = done
        meter.add(cfg.tau * lb * n, period_s)
        kv["images_per_sec"] = round(cfg.tau * lb * n / period_s, 2)
        kv["images_per_sec_per_chip"] = round(
            meter.images_per_sec_per_chip(), 2)
        if card_spans is not None:
            # the round's card-timed spans, every event done by now
            kv.update({k: round(v, 4) for k, v in
                       tracer.card.resolve(card_spans).items()})
        if trainer.compute_health:
            i = 2 if probe is not None else 1
            kv["grad_norm"] = vals[i]
            kv["nonfinite"] = vals[i + 1]
        if breakdown is not None:
            if collect_async:
                breakdown["collect"] = 0.0
                breakdown["collect_bg"] = t_collect
            else:
                breakdown["collect"] = t_collect
            breakdown["log"] = last_flush_ms[0] / 1e3
            h2d = {k: breakdown.pop(k)
                   for k in ("h2d_bytes", "h2d_async_bytes")}
            kv.update({f"t_{k}_ms": round(v * 1e3, 3)
                       for k, v in breakdown.items()})
            kv.update(h2d)
            # the straggler inputs: /status, the gauges, the pod beat
            vitals["round_s"] = round(breakdown["round"], 6)
            vitals["data_wait_s"] = round(breakdown["data"], 6)
            if g_round_s is not None:
                g_round_s.set(breakdown["round"])
                g_wait_s.set(breakdown["data"])
        if dev_tel is not None:
            dev_tel.sample()  # the card's memory at the flush cadence
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
        finite = bool(np.isfinite(loss))
        if tracer is not None:
            tracer.instant("flush", round=rnd_,
                           loss=loss if finite else None)
        vitals.update(round=rnd_, loss=loss if finite else None,
                      status=cls or "ok", beat_ts=round(time.time(), 3))
        if g_round is not None:
            g_round.set(rnd_)
            if finite:
                g_loss.set(loss)
        beat(rnd_, cls or "ok", force=cls not in (None, "ok"),
             last_loss=loss if finite else None)
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

    stateful = not isinstance(source, RoundSampler)

    def drop_pending() -> None:
        """Drop the prefetched round: cancel it, or wait out a running
        prep (it must not race the retried round's), re-raising its
        failure. A stateful source's prefetched round is always waited
        out, so that it has always left the stream: where the stream
        resumes does not hang on whether the prep thread had started."""
        nonlocal pending
        if pending is not None and (stateful or not pending.cancel()):
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
            # the target may predate an elastic relaunch (another size)
            state = trainer.state_from_checkpoint(flat, extra, policy)
        except ValueError as e:
            raise TrainingHealthError(
                f"training health: rollback target step {ck_round} cannot "
                f"be loaded — {e}") from e
        retry += 1
        if supports_lr and health_cfg.lr_backoff != 1.0:
            lr_scale *= health_cfg.lr_backoff
        drop_pending()  # prepared for the old window
        log.event(ck_round, "rollback", reason=reason, target_step=ck_round,
                  rollbacks=monitor.rollbacks, retry=retry,
                  lr_scale=round(lr_scale, 6))
        beat(ck_round, "rollback", force=True, reason=reason)
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
    tau_vec = None  # this round's per-rank τ budgets (tau_adapt)
    # host spans of every thread on one timeline (process-wide; stopped
    # and written in the finally below, after the writer drained)
    tracer = (obs_trace.start_tracing()
              if cfg.trace_out and rank == 0 else None)
    if tracer is not None and trainer.device.type == "cuda":
        tracer.attach_card(trainer.device)  # card-timed spans
    t_member = 0.0  # this round's boundary agreement, for the breakdown
    try:
        if elastic_cfg is not None:
            # every machine beats, then rank 0 seeds the membership from
            # the prefix: a member's first flush cannot race the seeding
            beat(start_round, "ok", force=True)
            if side is not None:
                dist.barrier(group=side)
            seeded = agree(start_round, bootstrap=True)
            if len(seeded["members"]) < max(1, elastic_cfg.min_workers):
                # a relaunch below min_workers halts here, loudly, rather
                # than bouncing between relaunches
                raise TrainingHealthError(
                    f"elastic: launched with {len(seeded['members'])} "
                    f"worker(s), below min_workers="
                    f"{elastic_cfg.min_workers} — refusing to start; the "
                    f"newest verified checkpoint resumes once capacity "
                    f"returns.")
            vitals["membership_epoch"] = seeded["epoch"]
            log.log(f"elastic membership: {list(seeded['members'])} "
                    f"({len(seeded['members'])} worker(s) over "
                    f"{n_machines} machine(s); stale_after="
                    f"{elastic_cfg.stale_after_s}s min_workers="
                    f"{elastic_cfg.min_workers}; rank 0 decides)")
        while rnd < cfg.max_rounds:
            if monitor is not None and monitor.rollback_needed:
                state, rnd = recover(state)
                continue
            if elastic_cfg is not None:
                # the τ boundary: every rank's params are synchronized, so
                # this is the one safe point to change the world
                t0 = time.perf_counter()
                decision = agree(rnd)
                t_member = time.perf_counter() - t0
                if decision["event"] is not None:
                    apply_resize(state, decision["event"], rnd)
                tau_vec = decision["tau"]
            if test_ds is not None and cfg.eval_every and \
                    rnd % cfg.eval_every == 0:
                flush_deferred()  # keep the log round-ordered
                if monitor is not None and monitor.rollback_needed:
                    continue  # don't evaluate a poisoned state
                with timers.phase("eval"):
                    acc = _evaluate(trainer, state, test_ds, cfg.eval_batch,
                                    (local_rank, local_size),
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
            # profile one steady round (the first one builds and warms)
            profile_this = (bool(cfg.profile_dir) and rank == 0
                            and rnd == start_round + 1)
            with maybe_trace(cfg.profile_dir if profile_this else None,
                             label=f"round-{rnd}"), \
                    timers.phase("train_round"):
                tr_kw = ({} if tau_vec is None
                         else {"tau_by_worker": tau_vec})
                if supports_lr:
                    tr_kw["lr_scale"] = lr_scale
                state, loss = trainer.train_round(state, batches, key,
                                                  **tr_kw)
                del batches  # the slot or buffers go back with the round
                scalars = _record_scalars(
                    loss, probe(state) if probe else None,
                    trainer.last_health)
                if len(deferred) >= log_every:
                    flush_deferred(wait=False)
            if profile_this:
                log.log(f"profiler trace written to {cfg.profile_dir}", rnd)
            round_s = phase_delta("train_round")
            breakdown = None
            if cfg.telemetry:
                breakdown = {"data": phase_delta("sample"),
                             "h2d": phase_delta("h2d"),
                             "round": phase_delta("dispatch"),
                             # stage 1 of the previous round's save, which
                             # delayed this one
                             "ckpt_fetch": phase_delta("checkpoint"),
                             "prep": info["prep_s"],
                             "h2d_bytes": trainer.h2d_bytes,
                             "h2d_async_bytes": trainer.h2d_async_bytes}
                if elastic_cfg is not None:
                    breakdown["member"] = t_member
            if c_rounds is not None:
                c_rounds.inc()
            card_spans = None
            if tracer is not None and tracer.card is not None:
                card_spans = tracer.card.take()
                # the card's timer drifts from the host's clock: a
                # synchronize and a new anchor every REANCHOR_S seconds
                tracer.card.reanchor_if_due()
            deferred.append((rnd, scalars, round_s, breakdown, card_spans))
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
                                     source=source, last_round=rnd,
                                     local_size=local_size,
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
        try:
            if ck_writer is not None:
                # a running write always completes; on the normal path
                # its failure raises here, on an aborted one it must not
                # mask the exception already propagating
                try:
                    ck_writer.close(wait=True)
                except Exception as e:
                    if loop_completed:
                        raise
                    log.log(f"background checkpoint write failed during "
                            f"abort: {e}")
        finally:
            # the ports unbind even when the writer's failure re-raises
            if history is not None:
                history.stop()
            if status_srv is not None:
                status_srv.stop()
            if pod_srv is not None:
                pod_srv.stop()
            if side is not None:
                dist.destroy_process_group(side)
            if tracer is not None:
                # after the writer drained: its last checkpoint_write
                # span is on the timeline. Observability: a failed write
                # is logged, never raised
                obs_trace.stop_tracing()
                try:
                    n_ev = tracer.write(cfg.trace_out)
                    log.log(f"host trace written to {cfg.trace_out} "
                            f"({n_ev} events; load in Perfetto or "
                            f"chrome://tracing)")
                except OSError as e:
                    log.log(f"host trace write failed: {e}")
    if ckdir and start_round < cfg.max_rounds:
        # start_round >= max_rounds: the loop ran no round, and the
        # restored step is already the final state (a save now would also
        # carry no stream cursor: cursor_at has seen no rounds)
        _save_checkpoint(cfg, trainer, state, cfg.max_rounds, retain=False,
                         source=source, last_round=cfg.max_rounds - 1,
                         local_size=local_size,
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
    beat(rnd, "done", force=True)
    for hb in (heartbeat, pod_hb):
        if hb is not None:
            hb.flush()  # bounded wait: the done beat lands on a bucket
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


def _stream_rows(source, last_round: Optional[int],
                 group: DataGroup, local_size: int) -> Optional[list]:
    """The stream cursors after `last_round` in the JAX package's format:
    one list per machine of [shard, entry, epochs] rows, one row per
    reader, the machine's ranks in local-rank order (the rows of the JAX
    host that reads the same shards). None when the source is not
    seekable or no longer holds that round's cursor. Collective over the
    group: every rank calls it at every save, and a rank whose reader
    count differs from the others' raises on every rank."""
    if last_round is None or not hasattr(source, "cursor_at"):
        return None
    cur = source.cursor_at(last_round)
    if cur is not None and not isinstance(cur, list):
        cur = [cur]  # a single-reader source
    rows = torch.tensor([[s, e, ep] for (s, e), ep in cur or ()],
                        dtype=torch.int64).reshape(-1, 3)
    dev = group.device
    counts = group.all_gather(torch.tensor(
        [cur is not None, len(rows)], dtype=torch.int64, device=dev)).cpu()
    if not bool(counts[:, 0].all()):
        return None
    if len(set(counts[:, 1].tolist())) != 1:
        raise ValueError(
            f"stream cursor rows by rank {counts[:, 1].tolist()}: every "
            f"rank must run the same number of readers")
    every = group.all_gather(rows.to(dev)).cpu()  # [world, readers, 3]
    return [every[m * local_size:(m + 1) * local_size].reshape(
        -1, 3).tolist() for m in range(group.size // local_size)]


def _seek_stream(source, extra: Dict[str, Any], log: Logger,
                 topo) -> None:
    """Resume this rank's readers at the checkpoint's cursor rows: its
    machine's list, the block of this local rank. A change in the machine
    count or the reader count restarts the stream at shard 0 (the shard
    assignment changed, so the old cursors mean nothing). A flat
    [shard, entry, epochs] per machine is a one-reader cursor."""
    rows = extra.get("stream")
    if rows is None:
        return
    machine, n_machines, local_rank, local_size = topo
    if len(rows) != n_machines:
        log.log(f"stream cursor in checkpoint covers {len(rows)} hosts, "
                f"now {n_machines}: restarting stream at shard 0")
        return
    host_rows = rows[machine]
    if host_rows and not isinstance(host_rows[0], list):
        host_rows = [host_rows]
    per, rem = divmod(len(host_rows), local_size)
    mine = host_rows[local_rank * per:(local_rank + 1) * per]
    if rem or not per or not hasattr(source, "seek_rows") or \
            not source.seek_rows(mine):
        log.log(f"stream cursor in checkpoint covers {len(host_rows)} "
                f"readers, source has a different count: restarting "
                f"stream at shard 0")
        return
    pos = ", ".join(f"shard {s} entry {e} (epoch {ep})"
                    for s, e, ep in mine)
    log.log(f"stream resumed at {pos}")


def _sharded_save_enabled(cfg: RunConfig, trainer) -> bool:
    """cfg.checkpoint_sharded for the trainer's world: "auto" is
    per-shard above one rank and monolithic at one (where there is
    nothing to split), "on" per-shard at any size (one shard file at one
    rank), "off" the monolithic layout. A trainer without per-shard
    snapshots (the graph backend's) saves monolithically, and "on"
    raises for it, as in the JAX loop."""
    knob = cfg.checkpoint_sharded  # check_config validated it
    if not hasattr(trainer, "checkpoint_shards"):
        if knob == "on":
            raise ValueError(
                f"checkpoint_sharded='on' needs a layer-IR trainer (per-rank "
                f"shard plans); {type(trainer).__name__} saves "
                f"monolithically")
        return False
    return knob == "on" or (knob == "auto" and trainer.group.size > 1)


def _save_checkpoint(cfg: RunConfig, trainer: ParallelTrainer,
                     state: TrainState, step: int, retain: bool = True,
                     source=None, last_round: Optional[int] = None,
                     local_size: int = 1, anomalous: bool = False,
                     health_state: Optional[Dict[str, Any]] = None,
                     writer: Optional[ckpt.AsyncCheckpointWriter] = None
                     ) -> None:
    """Two-stage save; every rank calls it. Stage 1 (here, blocking): the
    state as host memory the snapshot owns — the next round updates the
    device buffers in place — and the stream cursors after `last_round`,
    gathered. Per-shard (`_sharded_save_enabled`): each rank snapshots
    only its own rows (`checkpoint_shards`); above one rank every writer
    is drained, and rank 0 clears the step between two barriers, before
    any rank writes. Monolithic: the replica tree with the momentum
    gathered (`checkpoint_tree`). Stage 2 (serialize, digest, persist;
    retain to 3 on rank 0): every rank writes its own shard file, rank 0
    commits the manifest; monolithic, rank 0 writes alone. Inline when
    `writer` is None, else on the rank's background writer. The bytes,
    digests and tags are the same either way."""
    group = trainer.group
    sharded = _sharded_save_enabled(cfg, trainer)
    if sharded:
        if group.size > 1:
            if writer is not None:
                writer.wait()  # the previous step's files are committed
            group.barrier()
            if group.rank == 0:
                ckpt.prepare_sharded_step(cfg.checkpoint_dir, step)
            group.barrier()
        snapshot = trainer.checkpoint_shards(state)
    else:
        tree = trainer.checkpoint_tree(state)
    stream = _stream_rows(source, last_round, group, local_size)
    if group.rank != 0 and not sharded:
        return

    def persist() -> None:
        extra: Dict[str, Any] = {"n_devices": group.size, "tp": trainer.tp,
                                 "publish_t": round(time.time(), 3)}
        if trainer.state_layout != "replica":
            # the logical layout, stamped under the JAX keys so a restore
            # routes between the layouts; the momentum's shape depends on
            # the state sharding ([n_data] rows or one tree)
            extra["layout"] = trainer.state_layout
            extra["state_sharding"] = trainer.state_sharding
        if stream is not None:
            extra["stream"] = stream
        if anomalous:
            extra["anomalous"] = True
        if health_state is not None:
            extra["health"] = health_state
        if sharded:
            ckpt.save_sharded(
                cfg.checkpoint_dir, snapshot, step=step, extra=extra,
                metrics=writer.note_write if writer is not None else None)
        else:
            ckpt.save(cfg.checkpoint_dir, tree, step=step, extra=extra)
        if retain and group.rank == 0:
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
              test_ds: ArrayDataset, eval_batch: int, local: tuple,
              transform=None) -> float:
    """Accuracy over the test set in machine batches of `eval_batch`, each
    split evenly over the machine's ranks (`local` = (local_rank,
    local_size)) — the JAX
    package's host batch over its local devices; every machine holds a
    test set of the same size. A tail past the last full batch runs as
    one smaller batch, weighted by its size. At most n-1 trailing
    examples are left out. `transform` converts each batch of raw
    examples (`convert_batch(train=False)`: e.g. a center crop and the
    mean on uint8 pixels), so one batch of net inputs exists at a time.
    The counts are summed over the whole group."""
    rank, n = local
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
