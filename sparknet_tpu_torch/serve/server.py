"""The serving loop: bucket-padded forwards over dynamically formed batches.

The counterpart of `sparknet_tpu/serve/server.py`, first part: the
submit door, dynamic batching, bucket padding, the forward and de-padding,
with latency/fill meters and `status()`. Status HTTP, the SLO history,
request tracing, heartbeats, quantized serving and checkpoint hot reload
come with later slices.

Shape buckets: requests are padded to the smallest configured bucket size
>= the formed batch (default: powers of two up to max_batch), so the net
sees exactly len(buckets) batch shapes; the first forward of each bucket
is counted in `bucket_compiles` (on the card it pays cuDNN's algorithm
choice and the allocator's first growth for that shape). Padding rows are
zeros; de-padding slices each request's own row back out. Every layer is
row-independent across the batch, so padding within one bucket does not
change a request's answer.

Pad/de-pad is PRE-SIZED: each bucket owns one cached host buffer per net
input (allocated on first use, reused every batch), and request rows are
stacked straight into it. Safe because `TorchNet.forward` copies
host->device synchronously and fetches its outputs with a blocking copy
before it returns, and exactly one thread (the worker) drives the net.

Requests are dicts of PER-EXAMPLE arrays (no batch dim), NHWC for images.
Missing net inputs are zero-filled (zoo nets carry label-consuming
loss/accuracy heads; an inference client has no labels).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import trace as obs_trace
from ..obs.registry import MetricsRegistry
from ..utils.logger import Logger
from ..utils.metrics import FillMeter, LatencyStats
from .batcher import DynamicBatcher, ServeRequest
from .model_manager import ModelManager


def net_input_specs(net) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{input name: (per-example NHWC shape, dtype)} for a net that wraps a
    CompiledNet as `.net` (TorchNet)."""
    dtypes = {i.name: i.dtype for i in net.net.spec.inputs}
    return {name: (tuple(shape[1:]), dtypes.get(name, "float32"))
            for name, shape in net.net.input_shapes.items()}


def zeros_batch(net, n: int) -> Dict[str, np.ndarray]:
    """An all-zeros batch of n examples in the net's input schema — the
    canary forward's food, and the source of padding for absent inputs."""
    return {name: np.zeros((n,) + shape, dtype=np.dtype(dtype))
            for name, (shape, dtype) in net_input_specs(net).items()}


def default_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to max_batch (max_batch itself always included)."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


@dataclass
class ServeConfig:
    """Knobs for the inference server (the serve CLI mirrors these)."""

    # labels every serve metric family this server registers
    model_name: str = "default"
    # batching policy
    max_batch: int = 8
    max_wait_ms: float = 5.0            # oldest-request deadline
    # batch-size buckets (None -> powers of 2 up to max_batch); validated
    # at construction: strictly increasing, positive, top >= max_batch
    buckets: Optional[Tuple[int, ...]] = None
    max_queue: int = 1024               # backpressure threshold
    # response content: blob names to return (None -> every per-row blob
    # of the net's output; pass ("prob",) to skip the label heads)
    outputs: Optional[Tuple[str, ...]] = None

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


class InferenceServer:
    """Dynamic-batching inference over one TorchNet (module doc)."""

    def __init__(self, net, cfg: Optional[ServeConfig] = None,
                 logger: Optional[Logger] = None):
        self.net = net
        self.cfg = cfg = cfg if cfg is not None else ServeConfig()
        self.model_name = cfg.model_name
        self.log = logger
        self.buckets = tuple(cfg.buckets or default_buckets(cfg.max_batch))
        # the metric families every serve component registers into (a
        # status exporter reads them; none is wired up in this package yet)
        self.registry = MetricsRegistry()
        self._c_requests = self.registry.counter(
            "sparknet_serve_requests_total", "served requests by outcome",
            labels=("model", "outcome"))
        self._c_bucket_compiles = self.registry.counter(
            "sparknet_serve_bucket_compiles_total",
            "first forward per batch bucket",
            labels=("model",))
        self._compiled_buckets: set = set()
        self.batcher = DynamicBatcher(cfg.max_batch,
                                      max_wait_s=cfg.max_wait_ms / 1e3,
                                      max_queue=cfg.max_queue,
                                      registry=self.registry,
                                      model=cfg.model_name)
        self.manager = ModelManager(
            net, canary_batch=zeros_batch(net, self.buckets[0]),
            canary_outputs=cfg.outputs, logger=logger,
            registry=self.registry, model=cfg.model_name)
        self.latency = LatencyStats(registry=self.registry,
                                    model=cfg.model_name)
        self.fill = FillMeter(registry=self.registry, model=cfg.model_name)
        self.requests_ok = 0
        self.requests_failed = 0
        self.batch_log: List[Tuple[int, int]] = []  # (n_real, bucket)
        self._t0 = time.time()
        self._images = 0
        # pre-sized pad buffers: {bucket: {input: host array}} plus the
        # inputs a previous batch wrote real rows into (re-zeroed before a
        # batch that does not carry them)
        self._bucket_buf: Dict[int, Dict[str, np.ndarray]] = {}
        self._bucket_dirty: Dict[int, set] = {}
        self._input_specs = net_input_specs(net)
        self._worker: Optional[threading.Thread] = None
        self._running = False

    # -- client API ----------------------------------------------------------

    def submit(self, payload: Dict[str, Any],
               deadline_s: Optional[float] = None,
               outputs: Optional[Tuple[str, ...]] = None):
        """Enqueue one example (dict of per-example arrays); returns a
        Future resolving to {blob name: per-example array}. `deadline_s`
        sheds the request (DeadlineExpiredError) if no batch forms before
        it. `outputs` names the blobs THIS request wants, validated here
        against the net's blob table."""
        if outputs:
            bad = [o for o in outputs if o not in self.net.net.blob_shapes]
            if bad:
                raise ValueError(
                    f"unknown output blob(s) {bad!r} "
                    f"(net has {sorted(self.net.net.blob_shapes)})")
        self._validate_payload(payload)
        return self.batcher.submit(payload, deadline_s=deadline_s,
                                   outputs=outputs)

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
        """Install the initial weights (`weights`: a checkpoint flat map in
        the JAX package's layouts, or None for the net's own) and start
        the worker thread."""
        assert self._worker is None and not self._running, "already started"
        self.manager.load_initial(weights)
        self._running = True
        self._worker = threading.Thread(target=self._run,
                                        name="serve-worker", daemon=True)
        self._worker.start()
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

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- status --------------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """Serving vitals in one flat dict, from locked snapshots."""
        dt = max(time.time() - self._t0, 1e-9)
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
            "model_step": self.manager.step,
            "swap_failures": self.manager.swap_failures,
            "last_error": self.manager.last_error,
        }
        out.update(self.latency.summary())
        return out

    def reset_counters(self) -> None:
        """Zero the windowed serving metrics (latency, fill, throughput
        clock), e.g. after warmup."""
        self.latency.reset()
        self.fill.reset()
        self._images = 0
        self._t0 = time.time()

    # -- worker loop ---------------------------------------------------------

    def _run(self) -> None:
        while self._running:
            reqs = self.batcher.next_batch(
                wake_at=time.perf_counter() + 1.0)
            if reqs:
                self._serve_batch(reqs)

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
                      ) -> Dict[str, np.ndarray]:
        """Fill this bucket's cached buffers with the group's rows, the
        pad tail re-zeroed. Inputs absent from the request stay zero."""
        n = len(reqs)
        buf = self._bucket_buf.get(bucket)
        if buf is None:
            buf = self._bucket_buf[bucket] = zeros_batch(self.net, bucket)
            self._bucket_dirty[bucket] = set()
        payload = reqs[0].payload
        dirty = self._bucket_dirty[bucket]
        for k in dirty - set(payload):
            buf[k][:] = 0  # stale rows from a batch that carried k
        dirty.intersection_update(payload)
        for k in payload:
            dst = buf[k]
            rows = [r.payload[k] for r in reqs]
            try:
                np.stack(rows, out=dst[:n])
            except TypeError:
                # unusual-dtype payload (e.g. int rows for a float input):
                # stack on the side and let the assignment cast
                dst[:n] = np.stack(rows)
            dst[n:] = 0
            dirty.add(k)
        return buf

    def _forward_group(self, reqs: List[ServeRequest]) -> None:
        n = len(reqs)
        bucket = next(b for b in self.buckets if b >= n)
        try:
            full = self._bucket_batch(reqs, bucket)
            extra = set()
            for r in reqs:
                if r.outputs:
                    extra.update(r.outputs)
            t0 = time.perf_counter()
            out = self.net.forward(
                full, blob_names=list(set(self.cfg.outputs or ()) | extra))
            if bucket not in self._compiled_buckets:
                self._compiled_buckets.add(bucket)
                self._c_bucket_compiles.inc(model=self.model_name)
                self._log(f"serve: first forward of bucket {bucket} took "
                          f"{time.perf_counter() - t0:.3f}s")
            # de-pad: slice each request's row out of per-row blobs; batch
            # aggregates (the zoo heads' scalar loss/accuracy) are dropped
            # unless cfg.outputs names them
            want = set(self.cfg.outputs) if self.cfg.outputs else None
            fields = [(k, v, v.ndim >= 1 and v.shape[0] == bucket)
                      for k, v in out.items()]
            if want is not None:
                default = [f for f in fields if f[0] in want]
            else:
                default = [f for f in fields if f[2]]
            now = time.perf_counter()
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

    def _log(self, msg: str) -> None:
        if self.log is not None:
            self.log.log(msg)
