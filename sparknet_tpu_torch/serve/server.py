"""The serving loop: bucket-padded forwards over dynamically formed
batches, hot reload between batches, metrics, /healthz and heartbeats.

The counterpart of `sparknet_tpu/serve/server.py`. Shape buckets:
requests are padded to the smallest configured bucket size >= the formed
batch (default: powers of two up to max_batch), so the net sees exactly
len(buckets) batch shapes; the first forward of each bucket is counted in
`bucket_compiles` and timed (on the card it pays cuDNN's algorithm choice
and the allocator's first growth for that shape). Padding rows are zeros;
de-padding slices each request's own row back out. Every layer is
row-independent across the batch, so padding within one bucket does not
change a request's answer.

Pad/de-pad is PRE-SIZED: each (bucket, float dtype) owns one cached host
buffer per net input (allocated on first use, reused every batch), and
request rows are stacked straight into it. Safe because `TorchNet.forward`
copies host->device synchronously and fetches its outputs with a blocking
copy before it returns, and exactly one thread drives the net. The
quantized lane (`quant="int8"`, bfloat16 activations) fills bfloat16 CPU
tensors instead of float32 arrays, so its host->device copy carries half
the bytes; int inputs keep their schema dtype.

One worker owns the net: batch forwards, weight swaps (between batches,
via ModelManager) and the canary all run on it, so no lock guards the
params. The worker parks in the batcher's wake-on-submit wait; periodic
duties (the hot-reload poll, the heartbeat) run on their own cadence via
the `wake_at` alarm, so an idle server polls and beats too
(`serve_tick`, `duty_tick`).

`status_port` serves /metrics (Prometheus text from the server's
registry, the same names the JAX server exports), /healthz and /status
through `obs/http.StatusServer`; `heartbeat_path` writes the training
heartbeat schema with role="serve". With request tracing on
(`obs/reqtrace.py`), each traced request gets its `queue`, `form`,
`forward` and `depad` stages.

Requests are dicts of PER-EXAMPLE arrays (no batch dim), NHWC for images.
Missing net inputs are zero-filled (zoo nets carry label-consuming
loss/accuracy heads; an inference client has no labels).

Not ported (each raises NotImplementedError when set): the SLO history
and its objectives (`history`, `history_dir`, `slo_availability`,
`slo_spec`: ROADMAP A10c), the fleet rollout gate (`rollout_gate`: A10b)
and the persistent compile cache (`compile_cache_dir`: A10d). Raw-pixel
preprocessing at the door (the JAX server's `preprocessor`) is not ported
either: requests carry the net's own input schema.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..model.quant import QuantConfig
from ..obs import reqtrace
from ..obs import trace as obs_trace
from ..obs.http import StatusServer
from ..obs.meta import register_build_info
from ..obs.registry import MetricsRegistry
from ..utils.heartbeat import HeartbeatWriter
from ..utils.logger import Logger
from ..utils.metrics import FillMeter, LatencyStats
from .batcher import DynamicBatcher, ServeRequest
from .model_manager import ModelManager

#: histogram buckets (seconds) of a bucket's first forward — the JAX
#: package's compile-time buckets (`sparknet_tpu/obs/device.py`)
FIRST_FORWARD_BUCKETS = (0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                         10.0, 30.0, 60.0, 120.0, 300.0)


def net_input_specs(net) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{input name: (per-example NHWC shape, dtype)} for a net that wraps a
    CompiledNet as `.net` (TorchNet)."""
    dtypes = {i.name: i.dtype for i in net.net.spec.inputs}
    return {name: (tuple(shape[1:]), dtypes.get(name, "float32"))
            for name, shape in net.net.input_shapes.items()}


def zeros_batch(net, n: int, bf16: bool = False) -> Dict[str, Any]:
    """An all-zeros batch of n examples in the net's input schema — the
    canary forward's food, and the source of padding for absent inputs.
    `bf16` makes the FLOATING inputs bfloat16 CPU tensors, the quantized
    lane's host buffers (numpy has no bfloat16); int/label inputs keep
    their schema dtype."""
    out: Dict[str, Any] = {}
    for name, (shape, dtype) in net_input_specs(net).items():
        dt = np.dtype(dtype)
        if bf16 and np.issubdtype(dt, np.floating):
            out[name] = torch.zeros((n,) + shape, dtype=torch.bfloat16)
        else:
            out[name] = np.zeros((n,) + shape, dtype=dt)
    return out


def parity_batch(net, n: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A deterministic RANDOM batch in the net's input schema — the quant
    parity canary's food. Zeros would vet only the bias path (a conv of
    zeros never touches w, so a corrupted weight scale would pass);
    standard-normal pixels exercise every quantized weight."""
    r = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in net_input_specs(net).items():
        dt = np.dtype(dtype)
        if np.issubdtype(dt, np.floating):
            out[name] = r.standard_normal((n,) + shape).astype(dt)
        else:
            out[name] = np.zeros((n,) + shape, dtype=dt)
    return out


# Reserved payload key carrying a request's named output blobs across
# transports that only speak tensors (npz POST bodies). Encoded as a uint8
# view of the comma-joined names; the terminal frontend pops it before the
# tensors reach the net.
OUTPUTS_KEY = "__outputs__"


def encode_outputs(payload: Dict[str, Any],
                   outputs: Optional[Tuple[str, ...]]) -> Dict[str, Any]:
    """Return payload with the outputs request folded in as a tensor
    field (no-op when outputs is empty). Does not mutate the input."""
    if not outputs:
        return payload
    names = ",".join(outputs)
    out = dict(payload)
    out[OUTPUTS_KEY] = np.frombuffer(names.encode("utf-8"), dtype=np.uint8)
    return out


def pop_outputs(payload: Dict[str, Any]) -> Tuple[Dict[str, Any],
                                                  Optional[Tuple[str, ...]]]:
    """Split a payload into (tensors, requested output names). The
    inverse of encode_outputs; payloads without the key pass through."""
    if OUTPUTS_KEY not in payload:
        return payload, None
    out = dict(payload)
    raw = np.asarray(out.pop(OUTPUTS_KEY), dtype=np.uint8)
    names = raw.tobytes().decode("utf-8", errors="replace")
    parsed = tuple(n for n in (s.strip() for s in names.split(",")) if n)
    return out, (parsed or None)


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to max_batch (max_batch itself always included)."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


#: ServeConfig fields of later slices: (field, value that means "off",
#: what it needs)
_NOT_PORTED = (
    ("history", False, "the SLO history (obs/history.py): ROADMAP A10c"),
    ("history_dir", None, "the SLO history (obs/history.py): ROADMAP A10c"),
    ("slo_availability", None,
     "the SLO burn-rate alerter (obs/slo.py): ROADMAP A10c"),
    ("slo_spec", None,
     "the SLO burn-rate alerter (obs/slo.py): ROADMAP A10c"),
    ("rollout_gate", None,
     "the fleet rollout gate (fleet/rollout.py): ROADMAP A10b"),
    ("compile_cache_dir", None,
     "a warm-up cache in place of the XLA compile cache: ROADMAP A10d"),
)


@dataclass
class ServeConfig:
    """Knobs for the inference server (the serve CLI mirrors these)."""

    # labels every serve metric family this server registers, and names
    # the model in /status, heartbeats and the HTTP data plane's URLs
    model_name: str = "default"
    # batching policy
    max_batch: int = 8
    max_wait_ms: float = 5.0            # oldest-request deadline
    # batch-size buckets (None -> powers of 2 up to max_batch, or a
    # traffic-derived ladder from serve.buckets.derive_buckets); validated
    # at construction: strictly increasing, positive, top >= max_batch
    buckets: Optional[Tuple[int, ...]] = None
    max_queue: int = 1024               # backpressure threshold
    # weight-only quantized serving (model/quant.py): None = the f32 path
    # exactly as before; "int8" (or a QuantConfig) = int8 per-channel
    # weights, bfloat16 activations, every install parity-gated against
    # the f32 forward
    quant: Optional[Any] = None
    # ROADMAP A10d: a warm-up cache; only None is accepted
    compile_cache_dir: Optional[str] = None
    # per-model latency objective (ms), advisory: stamped into /status
    slo_p99_ms: Optional[float] = None
    # response content: blob names to return (None -> every per-row blob
    # of the net's output; pass ("prob",) to skip the label heads)
    outputs: Optional[Tuple[str, ...]] = None
    # checkpoint hot reload
    checkpoint_dir: Optional[str] = None
    poll_interval_s: float = 2.0
    # ± fraction of poll_interval_s each poll deadline is jittered by
    poll_jitter: float = 0.1
    canary: bool = True                 # nonfinite-canary gate on swaps
    # the `replica` label on the freshness gauges
    replica_name: str = "local"
    # ROADMAP A10b: the fleet's rollout gate; only None is accepted
    rollout_gate: Optional[str] = None
    # observability: status_port serves /metrics, /healthz and /status
    # (None = no HTTP; 0 = ephemeral); registry: share one registry across
    # co-located components (None = a fresh one)
    status_port: Optional[int] = None
    status_host: str = "127.0.0.1"
    # ROADMAP A10c: the SLO history; only the defaults are accepted
    history: bool = False
    history_dir: Optional[str] = None
    slo_availability: Optional[float] = None
    slo_spec: Optional[Any] = None
    heartbeat_path: Optional[str] = None
    heartbeat_every_s: float = 10.0
    metrics_every_batches: int = 50     # JSONL cadence (0 = off)
    registry: Optional[MetricsRegistry] = None

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 "
                             f"(got {self.max_batch})")
        if self.buckets is not None:
            b = tuple(int(x) for x in self.buckets)
            if not b:
                raise ValueError("buckets must be None or non-empty")
            if any(x <= 0 for x in b):
                raise ValueError(f"buckets must be positive (got {b})")
            if any(y <= x for x, y in zip(b, b[1:])):
                raise ValueError(
                    f"buckets must be strictly increasing — sorted, no "
                    f"duplicates (got {b})")
            if b[-1] < self.max_batch:
                raise ValueError(
                    f"largest bucket {b[-1]} < max_batch "
                    f"{self.max_batch}: a full batch would have no "
                    f"bucket")
            self.buckets = b
        if self.slo_availability is not None \
                and not 0.0 < self.slo_availability < 1.0:
            raise ValueError(f"slo_availability must be in (0, 1) "
                             f"(got {self.slo_availability})")
        for field, off, what in _NOT_PORTED:
            if getattr(self, field) != off:
                raise NotImplementedError(
                    f"ServeConfig.{field} needs {what}, which is not "
                    f"ported yet")
        self.quant = QuantConfig.coerce(self.quant)


class InferenceServer:
    """Dynamic-batching inference over one TorchNet (module doc)."""

    def __init__(self, net, cfg: Optional[ServeConfig] = None,
                 logger: Optional[Logger] = None):
        self.net = net
        self.cfg = cfg = cfg if cfg is not None else ServeConfig()
        self.model_name = cfg.model_name
        self.log = logger
        self.buckets = tuple(cfg.buckets or default_buckets(cfg.max_batch))
        # quantized serving: bfloat16 activation buffers (half the H2D
        # bytes)
        self.quant = cfg.quant
        self._bf16 = (self.quant is not None
                      and self.quant.act == "bfloat16")
        # the shared-schema registry every serve component registers into;
        # /metrics renders it
        self.registry = cfg.registry or MetricsRegistry()
        register_build_info(self.registry)
        self._c_requests = self.registry.counter(
            "sparknet_serve_requests_total", "served requests by outcome",
            labels=("model", "outcome"))
        self._c_bucket_compiles = self.registry.counter(
            "sparknet_serve_bucket_compiles_total",
            "first forward per batch bucket",
            labels=("model",))
        self._h_bucket_compile = self.registry.histogram(
            "sparknet_serve_bucket_compile_seconds",
            "wall time of each bucket's first forward",
            labels=("model",), buckets=FIRST_FORWARD_BUCKETS)
        self._compiled_buckets: set = set()
        self.batcher = DynamicBatcher(cfg.max_batch,
                                      max_wait_s=cfg.max_wait_ms / 1e3,
                                      max_queue=cfg.max_queue,
                                      registry=self.registry,
                                      model=cfg.model_name)
        hb = (HeartbeatWriter(cfg.heartbeat_path, role="serve",
                              interval_s=cfg.heartbeat_every_s,
                              registry=self.registry)
              if cfg.heartbeat_path else None)
        self.heartbeat = hb
        self.manager = ModelManager(
            net, checkpoint_dir=cfg.checkpoint_dir,
            poll_interval_s=cfg.poll_interval_s,
            canary_batch=(zeros_batch(net, self.buckets[0],
                                      bf16=self._bf16)
                          if cfg.canary else None),
            canary_outputs=cfg.outputs, logger=logger, heartbeat=hb,
            registry=self.registry, model=cfg.model_name,
            quant=self.quant,
            parity_batch=(parity_batch(net, self.buckets[0])
                          if self.quant is not None else None),
            replica=cfg.replica_name, poll_jitter=cfg.poll_jitter)
        # meters: worker-written, internally locked
        self.latency = LatencyStats(registry=self.registry,
                                    model=cfg.model_name)
        self.fill = FillMeter(registry=self.registry, model=cfg.model_name)
        self.requests_ok = 0
        self.requests_failed = 0
        self.batch_log: List[Tuple[int, int]] = []  # (n_real, bucket)
        self._t0 = time.time()
        self._images = 0
        # pre-sized pad buffers: {(bucket, float dtype): {input: host
        # buffer}} plus the inputs a previous batch wrote real rows into
        # (re-zeroed before a batch that does not carry them)
        self._bucket_buf: Dict[int, Dict[str, Any]] = {}
        self._bucket_dirty: Dict[int, set] = {}
        self._input_specs = net_input_specs(net)
        # periodic-duty cadence: the worker surfaces at least this often
        # for reload polls, heartbeats and liveness even with an empty
        # queue (bounded by 1 s so /healthz freshness works)
        duties = [1.0]
        if cfg.checkpoint_dir:
            duties.append(cfg.poll_interval_s)
        if hb is not None:
            duties.append(cfg.heartbeat_every_s)
        self._duty_s = max(min(duties), 1e-3)
        self._worker: Optional[threading.Thread] = None
        self._http: Optional[StatusServer] = None
        self._running = False
        self._last_tick = 0.0

    # -- client API ----------------------------------------------------------

    def submit(self, payload: Dict[str, Any],
               deadline_s: Optional[float] = None,
               priority: Optional[str] = None,
               outputs: Optional[Tuple[str, ...]] = None,
               trace=None):
        """Enqueue one example (dict of per-example arrays); returns a
        Future resolving to {blob name: per-example array}. `deadline_s`
        sheds the request (DeadlineExpiredError) if no batch forms before
        it. `outputs` names the blobs THIS request wants, validated here
        against the net's blob table (also read from the payload's
        OUTPUTS_KEY). `priority` tags the queued request; `trace` is its
        request-trace context."""
        payload, inline = pop_outputs(payload)
        if outputs is None:
            outputs = inline
        if outputs:
            bad = [o for o in outputs if o not in self.net.net.blob_shapes]
            if bad:
                raise ValueError(
                    f"unknown output blob(s) {bad!r} "
                    f"(net has {sorted(self.net.net.blob_shapes)})")
        self._validate_payload(payload)
        return self.batcher.submit(payload, deadline_s=deadline_s,
                                   priority=priority, outputs=outputs,
                                   trace=trace)

    def _validate_payload(self, payload: Dict[str, Any]) -> None:
        """Reject a mis-shaped or unknown-field example AT THE DOOR with a
        ValueError, before it can enter (and fail) a whole batch."""
        for k, v in payload.items():
            spec = self._input_specs.get(k)
            if spec is None:
                raise ValueError(
                    f"request field {k!r} is not a net input "
                    f"(net has {sorted(self._input_specs)})")
            shape = tuple(np.shape(v))
            if shape != spec[0]:
                raise ValueError(
                    f"request field {k!r} has per-example shape "
                    f"{shape}, net input wants {spec[0]}")

    def infer(self, payload: Dict[str, Any], timeout: float = 30.0
              ) -> Dict[str, np.ndarray]:
        """Synchronous convenience wrapper over submit(); the timeout is
        also the request's deadline."""
        fut = self.submit(payload, deadline_s=timeout)
        return fut.result(timeout=timeout + 5.0)

    # -- lifecycle -----------------------------------------------------------

    def start(self, weights: Optional[Dict[str, np.ndarray]] = None
              ) -> "InferenceServer":
        """Install the initial weights — `weights`, a checkpoint flat map
        in the JAX package's layouts, or else the newest verified step of
        `checkpoint_dir`, or else the net's own — and start the worker
        thread."""
        assert self._worker is None and not self._running, "already started"
        self.manager.load_initial(weights)
        self._running = True
        self._last_tick = time.monotonic()
        self._worker = threading.Thread(target=self._run,
                                        name="serve-worker", daemon=True)
        self._worker.start()
        if self.cfg.status_port is not None:
            self._start_http(self.cfg.status_port)
        return self

    def stop(self, drain_s: float = 5.0) -> None:
        """Stop accepting work, serve what's already queued (bounded by
        drain_s), then stop the worker."""
        deadline = time.monotonic() + drain_s
        while self.batcher.depth() and time.monotonic() < deadline:
            time.sleep(0.01)
        self._running = False
        self.batcher.close()
        if self._worker is not None:
            self._worker.join(timeout=max(drain_s, 1.0))
            self._worker = None
        # one final metrics row with the worker quiesced: a short-lived
        # server still leaves its batch_size_hist on disk (the
        # --buckets-from input)
        if self.log is not None and self.fill.batches and \
                self.cfg.metrics_every_batches:
            self._log_metrics_row()
        if self._http is not None:
            self._http.stop()
            self._http = None
        if self.heartbeat is not None:
            try:
                self.heartbeat.beat(self.manager.step or 0, status="done",
                                    rollbacks=self.manager.swap_failures,
                                    force=True)
            except OSError:
                pass

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- status --------------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The /status JSON: serving vitals in one flat dict, from locked
        snapshots and single-writer attributes."""
        dt = max(time.time() - self._t0, 1e-9)
        m = self.manager
        real, padded, batches = self.fill.snapshot()
        out = {
            "role": "serve",
            "model": self.model_name,
            "device": str(self.net.device),
            "uptime_s": round(dt, 1),
            "queue_depth": self.batcher.depth(),
            "requests_ok": self.requests_ok,
            "requests_failed": self.requests_failed,
            "requests_shed": self.batcher.shed,
            "images_per_sec": round(self._images / dt, 2),
            "batches": batches,
            "batch_fill_ratio": round(real / padded if padded else 0.0, 4),
            "buckets": list(self.buckets),
            "bucket_compiles": len(self._compiled_buckets),
            "batch_size_hist": {str(s): c for s, c
                                in sorted(self.fill.size_hist().items())},
            "quant": None if self.quant is None else self.quant.mode,
            "model_step": m.step,
            "replica": m.replica,
            "freshness_s": m.freshness_s(),
            "model_step_lag": m.step_lag(),
            "latest_step_seen": m.latest_seen,
            "swaps": m.swaps,
            "swap_failures": m.swap_failures,
            "last_error": m.last_error,
        }
        if self.cfg.slo_p99_ms is not None:
            out["slo_p99_ms"] = self.cfg.slo_p99_ms
        out.update(self.latency.summary())
        rt = reqtrace.active()
        if rt is not None:
            ex = rt.exemplars().get(self.model_name)
            if ex:
                out["slow_requests"] = ex
            out["reqtrace"] = rt.stats()
        out["models"] = {self.model_name: self.model_row()}
        return out

    def reset_counters(self) -> None:
        """Zero the windowed serving metrics (latency, fill, throughput
        clock), e.g. after warmup. Lifetime totals keep counting."""
        self.latency.reset()
        self.fill.reset()
        self._images = 0
        self._t0 = time.time()

    def healthy(self) -> bool:
        """Liveness: the serving thread ticked recently (a wedged forward
        or a dead thread flips /healthz to 503, not hangs it)."""
        alive = self._worker is not None and self._worker.is_alive()
        fresh = (time.monotonic() - self._last_tick) < max(
            3 * self._duty_s, 2.0)
        return alive and fresh

    # -- worker loop ---------------------------------------------------------

    def _run(self) -> None:
        while self._running:
            self.serve_tick()

    def serve_tick(self, wake_at: Optional[float] = None) -> bool:
        """One worker iteration: park for a batch (wake-on-submit; surface
        at `wake_at` — default now + the duty cadence — for periodic
        duties), serve it, then run the duties. Returns True when a batch
        was served. Only the worker thread calls it."""
        self._last_tick = time.monotonic()
        if wake_at is None:
            wake_at = time.perf_counter() + self._duty_s
        reqs = self.batcher.next_batch(wake_at=wake_at)
        if reqs:
            # a formed batch has already waited out its deadline: serve
            # it FIRST — a checkpoint download must never sit between
            # batch formation and its forward
            self._serve_batch(reqs)
        self.duty_tick()
        return bool(reqs)

    def duty_tick(self) -> None:
        """Hot reload + heartbeat, in the gaps after serving and on idle
        ticks. Nothing the poll raises may kill the worker: a dead worker
        strands every queued future while submit() keeps accepting."""
        self._last_tick = time.monotonic()
        try:
            self.manager.poll()
        except Exception as e:
            self.manager.last_error = f"poll: {e}"
            self._log(f"serve: reload poll crashed ({e}); serving "
                      f"continues on step {self.manager.step}")
        self._beat()

    def _beat(self) -> None:
        if self.heartbeat is None:
            return
        try:
            self.heartbeat.beat(
                self.manager.step or 0,
                status="degraded" if self.manager.last_error else "ok",
                rollbacks=self.manager.swap_failures,
                queue_depth=self.batcher.depth(),
                batch_fill=round(self.fill.ratio(), 4),
                models={self.model_name: self.model_row()})
        except OSError:
            pass  # observability must not take serving down

    def model_row(self) -> Dict[str, Any]:
        """The compact per-model vitals row (heartbeats, /status
        "models", the pod view)."""
        lat = self.latency.summary()
        row = {"step": self.manager.step,
               "model_step": self.manager.step,
               "freshness_s": self.manager.freshness_s(),
               "step_lag": self.manager.step_lag(),
               "queue_depth": self.batcher.depth(),
               "requests_ok": self.requests_ok,
               "requests_failed": self.requests_failed,
               "requests_shed": self.batcher.shed,
               "p50_ms": lat["p50_ms"], "p99_ms": lat["p99_ms"],
               "batch_fill": round(self.fill.ratio(), 4),
               "recent_occupancy": self.fill_signal(),
               "swaps": self.manager.swaps,
               "swap_failures": self.manager.swap_failures}
        rt = reqtrace.active()
        if rt is not None:
            worst = rt.worst(self.model_name)
            if worst is not None:
                row["slow_request"] = worst
        return row

    def fill_signal(self) -> Optional[float]:
        """Recent batch occupancy vs max_batch in [0, 1] (None until a
        batch forms)."""
        occ = self.fill.recent_occupancy(self.cfg.max_batch)
        return None if occ is None else round(occ, 4)

    def _serve_batch(self, reqs: List[ServeRequest]) -> None:
        # group by input signature so one odd request fails ITS group,
        # not the whole batch (and stacked arrays are always rectangular)
        groups: Dict[tuple, List[ServeRequest]] = {}
        for r in reqs:
            sig = tuple(sorted((k, v.shape, str(v.dtype))
                               for k, v in r.payload.items()))
            groups.setdefault(sig, []).append(r)
        for group in groups.values():
            with obs_trace.span("forward", n=len(group)):
                self._forward_group(group)

    def _bucket_batch(self, reqs: List[ServeRequest], bucket: int
                      ) -> Dict[str, Any]:
        """Fill this bucket's cached buffers with the group's rows, the
        pad tail re-zeroed. Inputs absent from the request stay zero."""
        n = len(reqs)
        buf = self._bucket_buf.get(bucket)
        if buf is None:
            buf = self._bucket_buf[bucket] = zeros_batch(
                self.net, bucket, bf16=self._bf16)
            self._bucket_dirty[bucket] = set()
        payload = reqs[0].payload
        dirty = self._bucket_dirty[bucket]
        for k in dirty - set(payload):
            buf[k][:] = 0  # stale rows from a batch that carried k
        dirty.intersection_update(payload)
        for k in payload:
            dst = buf[k]
            rows = [r.payload[k] for r in reqs]
            if isinstance(dst, torch.Tensor):
                # the bfloat16 lane: stack, then round into the buffer
                dst[:n] = torch.from_numpy(np.stack(rows))
            else:
                try:
                    np.stack(rows, out=dst[:n])
                except TypeError:
                    # unusual-dtype payload (e.g. int rows for a float
                    # input): stack on the side and let the assignment
                    # cast
                    dst[:n] = np.stack(rows)
            dst[n:] = 0
            dirty.add(k)
        return buf

    def _forward_group(self, reqs: List[ServeRequest]) -> None:
        n = len(reqs)
        bucket = next(b for b in self.buckets if b >= n)
        # queue wait, submit -> forward start, and the checkpoint step
        # whose weights compute this forward, stamped on each future so a
        # frontend can put them on the wire (X-Queue-Wait-Ms,
        # X-Model-Step). Swaps run on this thread between batches, so the
        # step read here is the one the forward uses.
        t_form = time.perf_counter()
        step = self.manager.step
        for r in reqs:
            r.future._spkn_queue_wait_s = t_form - r.t_enqueue
            r.future._spkn_step = step
        # request-trace stages: one global None-check when tracing is
        # off; rows only for requests that carry a context
        rt = reqtrace.active()
        traced = ([r for r in reqs if r.trace is not None]
                  if rt is not None else ())
        for r in traced:
            rt.stage(r.trace, "queue", rt.to_us(r.t_enqueue),
                     (t_form - r.t_enqueue) * 1e6,
                     bucket=bucket, batch_n=n)
        try:
            full = self._bucket_batch(reqs, bucket)
            extra = set()
            for r in reqs:
                if r.outputs:
                    extra.update(r.outputs)
            t_fwd0 = time.perf_counter()
            for r in traced:
                rt.stage(r.trace, "form", rt.to_us(t_form),
                         (t_fwd0 - t_form) * 1e6,
                         bucket=bucket, batch_n=n)
            out = self.net.forward(
                full, blob_names=list(set(self.cfg.outputs or ()) | extra))
            t_fwd1 = time.perf_counter()
            if bucket not in self._compiled_buckets:
                self._compiled_buckets.add(bucket)
                self._c_bucket_compiles.inc(model=self.model_name)
                self._h_bucket_compile.observe(t_fwd1 - t_fwd0,
                                               model=self.model_name)
                self._log(f"serve: first forward of bucket {bucket} took "
                          f"{t_fwd1 - t_fwd0:.3f}s")
            # de-pad: slice each request's row out of per-row blobs; batch
            # aggregates (the zoo heads' scalar loss/accuracy) are dropped
            # unless cfg.outputs names them. Responses are float32 (the
            # net returns bfloat16 blobs as float32).
            want = set(self.cfg.outputs) if self.cfg.outputs else None
            fields = [(k, v, v.ndim >= 1 and v.shape[0] == bucket)
                      for k, v in out.items()]
            if want is not None:
                default = [f for f in fields if f[0] in want]
            else:
                default = [f for f in fields if f[2]]
            now = time.perf_counter()
            # emitted before set_result: resolving the future runs the
            # frontend's completion, which finishes the trace record
            for r in traced:
                rt.stage(r.trace, "forward", rt.to_us(t_fwd0),
                         (t_fwd1 - t_fwd0) * 1e6,
                         bucket=bucket, batch_n=n)
                rt.stage(r.trace, "depad", rt.to_us(t_fwd1),
                         (now - t_fwd1) * 1e6)
            for i, r in enumerate(reqs):
                sel = ([f for f in fields if f[0] in r.outputs]
                       if r.outputs else default)
                r.future.set_result({k: (v[i] if per_row else v)
                                     for k, v, per_row in sel})
                self.latency.add(now - r.t_enqueue)
            self.requests_ok += n
            self._c_requests.inc(n, model=self.model_name, outcome="ok")
        except Exception as e:
            # the worker must survive a failed batch: its futures carry
            # the error to their clients
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            self.requests_failed += n
            self._c_requests.inc(n, model=self.model_name,
                                 outcome="failed")
            self._log(f"serve: batch of {n} failed: {e}")
        self._images += n
        self.fill.add(n, bucket)
        self.batch_log.append((n, bucket))
        if len(self.batch_log) > 10000:
            del self.batch_log[:5000]
        if self.cfg.metrics_every_batches and self.log is not None and \
                self.fill.batches % self.cfg.metrics_every_batches == 0:
            self._log_metrics_row()

    def _log_metrics_row(self) -> None:
        st = self.status()
        self.log.metrics(self.fill.batches, model=self.model_name,
                         # cumulative; offline readers (--buckets-from)
                         # take the LAST row per model
                         batch_size_hist=st["batch_size_hist"], **{
                             k: v for k, v in st.items()
                             if isinstance(v, (int, float))
                             and v is not None})

    def _log(self, msg: str) -> None:
        if self.log is not None:
            self.log.log(msg)

    # -- status HTTP (obs/http.StatusServer) ---------------------------------

    @property
    def status_address(self) -> Optional[Tuple[str, int]]:
        """(host, port) of the status HTTP server, once started."""
        return None if self._http is None else self._http.address

    def _start_http(self, port: int) -> None:
        # the same server class the train loop runs: /metrics is the
        # Prometheus text of this server's registry, /status the JSON
        # vitals
        self._http = StatusServer(
            port, self.registry, host=self.cfg.status_host,
            healthz=lambda: (self.healthy(),
                             {"model_step": self.manager.step,
                              "queue_depth": self.batcher.depth()}),
            status=self.status)
        self._log(f"serve: status at http://{self._http.address[0]}:"
                  f"{self._http.address[1]}/healthz")
