"""Typed run configuration.

The reference's config was scattered across four channels (positional argv,
env vars, model/solver data files, hardcoded app constants — SURVEY §5.6).
Here one dataclass covers model, solver, data, mesh, τ, eval cadence,
checkpointing; loadable from JSON and overridable from CLI key=value pairs.
Model/solver remain loadable from prototxt data files (capability parity).

A copy of `sparknet_tpu/utils/config.py` (pure Python): the port imports
nothing of the JAX package, and one JSON config loads in both packages.
What differs: `lrn_impl` and `pool_impl` take the port's kernel routes,
"auto" (the CUDA kernels for CUDA tensors, the plain versions for CPU
tensors) or "plain", and a JAX-only value raises here. Which settings the
port's loop does not run yet, and what it does with them, is
`sparknet_tpu_torch/apps/train_loop.py`'s docstring.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..solver import SolverConfig
from .health import HealthConfig

#: the port's kernel routes for lrn_impl / pool_impl
IMPLS = ("auto", "plain")


@dataclass
class ElasticConfig:
    """Knobs for elastic, preemption-tolerant pod membership
    (RunConfig.elastic; driven by `parallel.elastic.MembershipController`).

    Liveness is read from the per-worker heartbeats under
    `RunConfig.pod_dir` (the pod observability surface — no new channel).
    A worker whose beat ages past `stale_after_s` becomes SUSPECT, is
    re-probed with full-jitter backoff, and is declared dead only after
    `dead_probes` consecutive stale probes — never on a single missed
    beat. The same `stale_after_s` threshold feeds the pod aggregator and
    the launcher watch so "stale" means one thing everywhere.

    On a membership change the train loop resizes at the τ boundary:
    checkpoint, rebuild the compiled round over the survivors, restore
    through the newest VERIFIED snapshot (params exact; momentum per
    `momentum_policy` — norm_rescale won the r5 A/B,
    scripts/elastic_momentum_ab.py / ELASTIC_AB_r05.json), reshard the
    data partitions, and continue. Dropping below `min_workers`
    checkpoints and raises TrainingHealthError — loud, never a hang.
    """

    enabled: bool = False
    # how many workers the pod was LAUNCHED with (worker ids 0..N-1, the
    # worker-heartbeat naming convention). None = jax.process_count().
    # A launched-but-never-beating worker is a candidate-dead from the
    # start — it goes through the normal suspect -> re-probe -> evict
    # path instead of silently shrinking the pod's definition.
    expected_workers: Optional[int] = None
    # dead-vs-slow: heartbeat age that makes a worker suspect (shared
    # with PodAggregator staleness and the launcher watch probe)
    stale_after_s: float = 60.0
    # full-jitter re-probe: suspect worker k is re-checked after
    # uniform(0, reprobe_backoff_s * 2^k); declared dead after
    # `dead_probes` consecutive stale probes (>= 1; the first stale
    # sighting is never enough on its own)
    reprobe_backoff_s: float = 2.0
    dead_probes: int = 2
    # membership checks are rate-limited to this interval (0 = every
    # round; the check is a heartbeat-prefix listing, cheap but not free)
    poll_interval_s: float = 5.0
    # below this many live workers: verified checkpoint + loud
    # TrainingHealthError (a 1-worker "pod" still trains by default)
    min_workers: int = 1
    # "adopt": a fresh heartbeat from an unknown/evicted worker id joins
    # the pod at the next τ boundary (restored from the newest verified
    # checkpoint); "deny": log-and-ignore (fixed membership after evict)
    rejoin: str = "adopt"
    # momentum reconstruction across a topology change
    # (ParallelTrainer.adapt_state policy; A/B winner norm_rescale)
    momentum_policy: str = "norm_rescale"
    # heterogeneous pods: scale each worker's local steps by the pod's
    # round-time skew — worker i runs tau_i = clip(round(tau * median_
    # round_s / round_s_i), tau_min, tau) steps of the τ-scan (the rest
    # are masked no-ops; a traced input, so adapting never recompiles)
    tau_adapt: bool = False
    tau_min: int = 1

    def __post_init__(self) -> None:
        # validated at CONSTRUCTION, not just from_dict: in-tree callers
        # build ElasticConfig directly, and a typo'd rejoin policy must
        # not silently behave as "adopt"
        if self.rejoin not in ("adopt", "deny"):
            raise ValueError(f"elastic.rejoin must be 'adopt' or 'deny', "
                             f"got {self.rejoin!r}")
        if self.dead_probes < 1:
            raise ValueError("elastic.dead_probes must be >= 1 (a single "
                             "missed beat must never evict)")

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ElasticConfig":
        known = {f.name for f in dataclasses.fields(ElasticConfig)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown elastic config keys: {sorted(unknown)}")
        return ElasticConfig(**d)


@dataclass
class RunConfig:
    # model
    model: str = "cifar10_quick"        # zoo name, or path to a .prototxt
    n_classes: int = 10
    # solver (inline or from solver_prototxt)
    solver: SolverConfig = field(default_factory=SolverConfig)
    solver_prototxt: Optional[str] = None
    # data
    data_dir: str = "data"
    subtract_mean: bool = True
    crop: Optional[int] = None
    # concurrent shard readers per host for streaming ingest (shards split
    # j::N across readers; kills the per-reader serial ceiling — a single
    # reader's tar-read/buffer-write residue caps it at ~5k img/s
    # regardless of host cores, PERF.md input-pipeline model)
    ingest_sources: int = 1
    # distribution
    n_devices: Optional[int] = None     # None = all visible
    tau: int = 10                       # local steps per sync round
    mode: str = "local_sgd"             # or "sync_sgd"
    local_batch: int = 100
    # trainer implementation for the layer-IR backend. "shard_map": the
    # replica-axis ParallelTrainer (state leaves carry a leading
    # [n_devices] axis). "named": the NamedSharding ShardedTrainer
    # (parallel/sharded.py — logical state placed by spec; prerequisite
    # for state_sharding below; parity-pinned against shard_map by
    # tests/test_sharded.py). "auto" (default): $SPARKNET_TRAINER_IMPL if
    # set (the CI matrix leg sets it to "named"), else "shard_map".
    trainer_impl: str = "auto"
    # ZeRO-1-style at-rest state sharding (trainer_impl="named" only;
    # requires tp == 1): "replicated" = exact reference semantics
    # (worker-local momentum); "momentum" = ONE momentum stored sharded
    # over the data axis (per-device optimizer-state HBM / n_data;
    # cross-worker averaged each round — the r5 A/B measured averaging
    # within noise of norm_rescale); "full" = params also stored sharded
    # at rest. PR 5's HBM gauges say when a net needs this; BENCH_r07
    # carries the per-device before/after bytes.
    state_sharding: str = "replicated"
    # loop
    max_rounds: int = 100
    eval_every: int = 5                 # rounds between evals (reference: 5/10)
    eval_batch: int = 1000
    # precision
    precision: str = "float32"          # or "bfloat16"
    # round-pipeline overlap (each individually toggleable, each pinned
    # bit-exact by tests/test_torch_pipeline.py): h2d_prefetch extends
    # the one-deep round-prep thread to also PLACE round R+1's batches on
    # the card (trainer.place_batches: pinned staging, a copy stream)
    # while round R computes — t_h2d_ms in the step-time breakdown drops
    # to ~0. donate_batches rotates placed rounds through two device
    # slots (R+1 is copied into the slot R-1 used once R-1 is queued),
    # instead of fresh buffers each round.
    # lrn_impl / pool_impl pick the kernel route in the layer path:
    # "auto" = the CUDA kernels for CUDA tensors (plain versions for CPU
    # tensors), "plain" = the plain PyTorch versions everywhere; validated
    # at construction (__post_init__). ops_interpret is the JAX package's
    # Pallas-interpreter switch; the port has no interpreter and refuses it.
    h2d_prefetch: bool = True
    donate_batches: bool = True
    lrn_impl: str = "auto"
    # "auto" where the JAX package defaults to "xla": its Pallas pool
    # backward lost on the TPU only by breaking XLA's fusion, which eager
    # PyTorch does not have (ops/pooling.py)
    pool_impl: str = "auto"
    ops_interpret: bool = False
    # fused_boundary is the JAX package's peeled final scan step; an
    # eager round already averages right after its last step, so the
    # port accepts it and logs it as not ported. collect_async moves the
    # deferred loss/health fetch onto a background collector thread so
    # the round loop NEVER blocks on boundary results: t_collect_ms in
    # the step-time breakdown reads ~0 (the off-thread fetch lands as
    # t_collect_bg_ms), log/JSONL content is unchanged and rows stay
    # round-ordered (the collector is a FIFO drained at every eval/
    # checkpoint/recovery boundary).
    fused_boundary: bool = True
    collect_async: bool = True
    # the warm-up cache (utils/compile_cache.py): the kernel-build
    # directory processes share, so a relaunched worker or a replica with
    # a warm directory runs no nvcc. None = $SPARKNET_COMPILE_CACHE if
    # set, else sparknet_tpu_torch/_build/; compile events carry a
    # cache_hit label either way
    # (sparknet_compile_events_total{what,cache_hit}).
    compile_cache_dir: Optional[str] = None
    # checkpoint. checkpoint_dir accepts a local path OR a gs://|s3://
    # prefix (native bucket checkpoints — no FUSE mount; utils/checkpoint
    # uploads through the data plane's HTTP clients). checkpoint_async
    # moves serialize+digest+persist to a background writer thread: the
    # round loop blocks only for the device->host state fetch, with at
    # most one snapshot in flight (the next save waits out the previous
    # write). False restores the fully synchronous save.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25          # rounds
    checkpoint_async: bool = True
    # per-shard checkpoint layout: each rank writes only its own rows
    # (shard-k-of-n.npz files + a manifest with per-shard digests in
    # meta.json, still committed LAST) instead of rank 0 writing the
    # gathered state. Restores read BOTH layouts (bit-identical flat
    # map), so a resume across layouts is exact. "auto" (default):
    # per-shard above one rank, monolithic at one; "on" per-shard at any
    # size; "off" the monolithic layout.
    checkpoint_sharded: str = "auto"
    resume: bool = True
    # training health supervisor: anomaly classification (spike/nonfinite),
    # skip / rollback-to-verified-checkpoint / LR-backoff recovery, and the
    # deterministic fault-injection hooks (utils/health.py)
    health: HealthConfig = field(default_factory=HealthConfig)
    # liveness heartbeat: when set, the loop atomically rewrites this JSON
    # file (utils/heartbeat.py schema: t/step/status/rollbacks) at the
    # log_every flush cadence — `tpu_pod_launch.sh watch` (with
    # TPU_HEARTBEAT_FILE pointed here) distinguishes "slow" (fresh beat,
    # status ok) from "sick" (stale beat, or spike/nonfinite/rollback
    # status) without parsing logs. The serve subsystem writes the same
    # schema with role="serve".
    heartbeat_path: Optional[str] = None
    heartbeat_every_s: float = 10.0
    # unified telemetry (sparknet_tpu.obs). telemetry=True builds a
    # per-run MetricsRegistry every meter/supervisor/writer registers
    # into and emits per-round step-time breakdown fields (t_data_ms /
    # t_h2d_ms / t_round_ms / t_collect_ms / t_ckpt_fetch_ms / t_log_ms)
    # in the metrics JSONL; False restores the pre-obs behavior (the
    # bench.py --obs "disabled" arm). status_port serves /metrics
    # (Prometheus text, same name schema as serve), /healthz and /status
    # from EVERY training process (since the pod PR — each worker is its
    # own scrape surface, the raw feed of pod aggregation; 0 = ephemeral,
    # and co-located processes on one host MUST use 0 or distinct ports —
    # the bound address lands on cfg.status_address). trace_out captures
    # host-side spans (round loop / prefetch / async checkpoint writer
    # lanes) into a Chrome-trace-event JSON loadable in Perfetto next to
    # the profile_dir device trace.
    # status_host defaults to loopback (scrape via SSH tunnel / sidecar);
    # set "0.0.0.0" for a cross-host Prometheus to reach it directly.
    # status_address is OUTPUT, not input: run_loop writes the bound
    # (host, port) here once the server is up (port 0 resolves to the
    # ephemeral port) — leave it None in configs.
    telemetry: bool = True
    status_port: Optional[int] = None
    status_host: str = "127.0.0.1"
    status_address: Optional[Tuple[str, int]] = None
    # SLO ledger (obs/history.py): history=True runs the metrics-history
    # sampler in the training process — bounded multi-resolution rings
    # behind a /timeseries route on the status server, with optional
    # JSONL shard persistence under history_dir for `sparknet-slo`
    # retrospective reports. Off by default (zero overhead unless asked).
    history: bool = False
    history_dir: Optional[str] = None
    history_interval_s: float = 1.0
    trace_out: Optional[str] = None
    # pod-scope observability (obs/pod.py). pod_dir is a shared prefix —
    # local/NFS dir or a gs://|s3:// bucket — where EVERY worker rewrites
    # its own worker-<i>.heartbeat.json (step/status/loss plus round_s /
    # data_wait_s, the straggler-attribution inputs) at the heartbeat
    # cadence. pod_port makes process 0 additionally run a PodAggregator
    # endpoint over that prefix: merged pod /metrics, /pod/status JSON
    # naming stragglers and stale workers (0 = ephemeral; bound address
    # lands on pod_address — OUTPUT, leave None in configs). The
    # standalone `sparknet-podview` console reads either surface.
    pod_dir: Optional[str] = None
    pod_port: Optional[int] = None
    pod_address: Optional[Tuple[str, int]] = None
    # elastic pod membership (parallel/elastic.py): when enabled AND
    # pod_dir is set, the loop watches the per-worker heartbeats, evicts
    # dead workers (stale-then-reprobed, full jitter), adopts joiners,
    # and resizes the compiled round at the τ boundary through the
    # checkpoint store. None/disabled = the pre-elastic loop exactly.
    elastic: Optional[ElasticConfig] = None
    # logging. None -> $SPARKNET_TPU_HOME, else "." (the reference logged
    # to $SPARKNET_HOME/training_log_<ms>.txt); tests set the env var to a
    # tmp dir so stray default-config runs never litter the repo root
    workdir: Optional[str] = None
    # fetch/flush round metrics every K rounds (losses stay on device in
    # between). The loop's ONLY per-round host sync is the deferred loss
    # fetch; when rounds are shorter than the dispatch/fetch round trip
    # (very fast models, or a high-latency dev tunnel where a fetch costs
    # ~100 ms), K>1 amortizes that sync K-fold. Log content is identical,
    # just flushed in batches.
    log_every: int = 1
    seed: int = 0
    # torch.profiler capture (utils/profiling.py): trace ONE steady round
    # (start_round+1, skipping the warm-up round) into this directory
    profile_dir: Optional[str] = None

    def __post_init__(self) -> None:
        for knob in ("lrn_impl", "pool_impl"):
            v = getattr(self, knob)
            if v not in IMPLS:
                raise ValueError(
                    f"{knob}={v!r}: the PyTorch port's routes are {IMPLS} "
                    f"(\"auto\": the CUDA kernels for CUDA tensors, the "
                    f"plain versions for CPU tensors; \"plain\": the plain "
                    f"versions everywhere)")

    @staticmethod
    def from_json(path: str) -> "RunConfig":
        with open(path) as f:
            d = json.load(f)
        return RunConfig.from_dict(d)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RunConfig":
        d = dict(d)
        if "solver" in d and isinstance(d["solver"], dict):
            d["solver"] = SolverConfig.from_dict(d["solver"])
        if "health" in d and isinstance(d["health"], dict):
            d["health"] = HealthConfig.from_dict(d["health"])
        if "elastic" in d and isinstance(d["elastic"], dict):
            d["elastic"] = ElasticConfig.from_dict(d["elastic"])
        known = {f.name for f in dataclasses.fields(RunConfig)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return RunConfig(**d)

    def with_overrides(self, *pairs: str) -> "RunConfig":
        """Apply CLI 'key=value' overrides (JSON-parsed values)."""
        d = dataclasses.asdict(self)
        for p in pairs:
            k, _, v = p.partition("=")
            if not _:
                raise ValueError(f"override {p!r} is not key=value")
            try:
                d[k] = json.loads(v)
            except json.JSONDecodeError:
                d[k] = v
        return RunConfig.from_dict(d)
