"""Meters, registry-backed: the train loop's phase timers and throughput
meter, and the server's request-latency quantiles and batch fill ratio.

A copy of `PhaseTimers`, `ThroughputMeter`, `LatencyStats` and `FillMeter`
from `sparknet_tpu/utils/metrics.py` (pure Python). Constructed with a
registry they also register the shared-schema metrics
(sparknet_train_phase_seconds_total, sparknet_serve_request_latency_seconds,
sparknet_serve_batch_*, ...) and update them on every mutation. They carry
their own locks: `summary()` / `snapshot()` readers get a CONSISTENT view
of state a worker thread is mutating. `PhaseTimers.phase(...)` also
emits a host-side trace span (obs.trace).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

from ..obs import trace as _trace
from ..obs.registry import MetricsRegistry


class PhaseTimers:
    """Accumulating named wall-clock spans (per-phase step breakdown).

    With a registry, each phase exit also feeds the counters
    `<prefix>_phase_seconds_total{phase=...}` and
    `<prefix>_phase_count_total{phase=...}`; an active tracer gets the
    phase as a span on the calling thread's lane."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "sparknet_train"):
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._c_seconds = self._c_count = None
        if registry is not None:
            self._c_seconds = registry.counter(
                f"{prefix}_phase_seconds_total",
                "wall seconds accumulated per host-side phase",
                labels=("phase",))
            self._c_count = registry.counter(
                f"{prefix}_phase_count_total",
                "entries per host-side phase", labels=("phase",))

    @contextmanager
    def phase(self, name: str):
        with _trace.span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.total[name] = self.total.get(name, 0.0) + dt
                    self.count[name] = self.count.get(name, 0) + 1
                if self._c_seconds is not None:
                    self._c_seconds.inc(dt, phase=name)
                    self._c_count.inc(1, phase=name)

    def mean(self, name: str) -> float:
        with self._lock:
            return self.total.get(name, 0.0) / max(self.count.get(name, 0),
                                                   1)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            names = list(self.total)
        return {f"{k}_mean_s": round(self.mean(k), 6) for k in names}

    def reset(self) -> None:
        with self._lock:
            self.total.clear()
            self.count.clear()


class ThroughputMeter:
    """images/sec (/chip if n_chips given), over a sliding accumulation."""

    def __init__(self, n_chips: int = 1,
                 registry: Optional[MetricsRegistry] = None,
                 prefix: str = "sparknet_train"):
        self.n_chips = n_chips
        self.images = 0
        self.seconds = 0.0
        self._lock = threading.Lock()
        self._c_images = self._g_ips = None
        if registry is not None:
            self._c_images = registry.counter(
                f"{prefix}_images_total", "examples trained/served")
            self._g_ips = registry.gauge(
                f"{prefix}_images_per_sec_per_chip",
                "throughput over the accumulation window")

    def add(self, n_images: int, seconds: float) -> None:
        with self._lock:
            self.images += n_images
            self.seconds += seconds
        if self._c_images is not None:
            self._c_images.inc(n_images)
            self._g_ips.set(self.images_per_sec_per_chip())

    def images_per_sec(self) -> float:
        with self._lock:
            return self.images / self.seconds if self.seconds else 0.0

    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec() / self.n_chips

    def reset(self) -> None:
        with self._lock:
            self.images = 0
            self.seconds = 0.0


def _rank(xs, q: float) -> float:
    """Nearest-rank order statistic over sorted xs (non-empty)."""
    i = min(len(xs) - 1, max(0, int(q * len(xs))))
    return xs[i]


class LatencyStats:
    """Sliding-window latency quantiles (p50/p99) over the last `window`
    observations. A bounded deque, not a histogram: serving windows are a
    few thousand requests, where exact order statistics are cheaper than
    tuning bucket boundaries, and the window naturally ages out a warmup
    or a transient stall instead of averaging it into eternity. (The
    registry half DOES get a fixed-bucket histogram —
    `<name>` in seconds — because Prometheus quantiles are computed
    server-side from cumulative buckets.)"""

    def __init__(self, window: int = 4096,
                 registry: Optional[MetricsRegistry] = None,
                 name: str = "sparknet_serve_request_latency_seconds",
                 model: Optional[str] = None,
                 max_age_s: float = 300.0):
        """`model` labels the registry histogram (serve lanes sharing one
        registry across models); None keeps the unlabeled family — but
        the two modes must not mix within one registry/name. `max_age_s`
        is the on-record pruning horizon: observations older than it are
        dropped from the left at `add` time, so memory is bounded by
        BOTH the count window and the age horizon."""
        self._obs: deque = deque(maxlen=max(2, window))
        # record times of the SAME observations (parallel deque, same
        # maxlen, appended under the same lock) for the age horizon
        self._obs_t: deque = deque(maxlen=max(2, window))
        self.max_age_s = float(max_age_s)
        self._lock = threading.Lock()
        self.count = 0
        self._hist = None
        self._labels = {} if model is None else {"model": str(model)}
        if registry is not None:
            self._hist = registry.histogram(
                name, "request latency, submit to response",
                labels=tuple(self._labels))

    def add(self, seconds: float) -> None:
        now = time.monotonic()
        with self._lock:
            # prune-to-window on record: both deques stay parallel, and
            # entries older than max_age_s never outlive the next add —
            # len(self._obs) <= min(maxlen, arrivals within max_age_s)
            cutoff = now - self.max_age_s
            while self._obs_t and self._obs_t[0] < cutoff:
                self._obs_t.popleft()
                self._obs.popleft()
            self._obs.append(float(seconds))
            self._obs_t.append(now)
            self.count += 1
        if self._hist is not None:
            self._hist.observe(seconds, **self._labels)

    def quantile(self, q: float) -> Optional[float]:
        """Exact order statistic over the window (nearest-rank), or None
        with no observations."""
        with self._lock:
            xs = sorted(self._obs)
        return _rank(xs, q) if xs else None

    def windowed_quantile(self, q: float, window_s: float
                          ) -> Optional[float]:
        """Exact order statistic (SECONDS) over the observations of the
        last `window_s` seconds, or None if the window holds nothing —
        the request tracer's "beyond the live p95" threshold and the
        router's hedge delay."""
        cutoff = time.monotonic() - float(window_s)
        with self._lock:
            xs = sorted(v for v, t in zip(self._obs, self._obs_t)
                        if t >= cutoff)
        return _rank(xs, q) if xs else None

    def windowed(self, window_s: float) -> Dict[str, Optional[float]]:
        """p50/p99 (ms) + n over the observations of the last `window_s`
        seconds: the fleet controller's SLO-burn input. An empty window
        gives {"n": 0, "p50_ms": None, "p99_ms": None} (a quiet model
        reads as not burning, never as burning on a stale tail)."""
        cutoff = time.monotonic() - float(window_s)
        with self._lock:
            xs = sorted(v for v, t in zip(self._obs, self._obs_t)
                        if t >= cutoff)
        out: Dict[str, Optional[float]] = {"n": len(xs)}
        for name, q in (("p50_ms", 0.50), ("p99_ms", 0.99)):
            out[name] = round(_rank(xs, q) * 1e3, 3) if xs else None
        return out

    def summary(self) -> Dict[str, Optional[float]]:
        # ONE consistent copy for all three quantiles: a scrape racing the
        # worker's add() must not see p50 and p99 from different windows
        with self._lock:
            xs = sorted(self._obs)
            n = self.count
        out: Dict[str, Optional[float]] = {"n": n}  # lifetime count
        for name, q in (("p50_ms", 0.50), ("p90_ms", 0.90),
                        ("p99_ms", 0.99)):
            out[name] = round(_rank(xs, q) * 1e3, 3) if xs else None
        return out

    def reset(self) -> None:
        with self._lock:
            self._obs.clear()
            self._obs_t.clear()
            self.count = 0


class FillMeter:
    """Batch-fill accounting for the dynamic batcher: real examples over
    padded bucket slots. fill == 1.0 means every compiled forward ran at
    its bucket's full width; low fill at high offered load means the
    batcher is flushing early (deadline too tight or buckets too big).

    Also keeps the per-batch-SIZE histogram — how many formed batches
    carried exactly n real examples, the evidence a bucket ladder is fitted
    to. It lands in `status()` (`batch_size_hist`) and in the registry as
    `<prefix>_size_batches_total{model,size}` (cardinality is bounded by
    max_batch)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "sparknet_serve_batch",
                 model: Optional[str] = None):
        """`model` labels the registry families (multi-model routers share
        one registry); None keeps them unlabeled — don't mix modes within
        one registry/prefix."""
        self.real = 0
        self.padded = 0
        self.batches = 0
        self.size_counts: Dict[int, int] = {}
        # the last few formed batches as (real, bucket) pairs: the recent
        # occupancy a status row reports (the cumulative ratio would stay
        # near 1.0 long after the load turned to a trickle)
        self._recent: deque = deque(maxlen=64)
        self._lock = threading.Lock()
        self._labels = {} if model is None else {"model": str(model)}
        self._c_rows = self._c_batches = self._g_fill = None
        self._c_sizes = None
        if registry is not None:
            lnames = tuple(self._labels)
            self._c_rows = registry.counter(
                f"{prefix}_rows_total",
                "batch rows by kind (real examples vs padding slots)",
                labels=lnames + ("kind",))
            self._c_batches = registry.counter(
                f"{prefix}es_total", "compiled forwards run",
                labels=lnames)
            self._g_fill = registry.gauge(
                f"{prefix}_fill_ratio",
                "real rows / padded bucket slots, cumulative",
                labels=lnames)
            self._c_sizes = registry.counter(
                f"{prefix}_size_batches_total",
                "formed batches by real-example count (the bucket-ladder "
                "derivation input)", labels=lnames + ("size",))

    def add(self, n_real: int, bucket: int) -> None:
        with self._lock:
            self.real += int(n_real)
            self.padded += int(bucket)
            self.batches += 1
            self.size_counts[int(n_real)] = \
                self.size_counts.get(int(n_real), 0) + 1
            self._recent.append((int(n_real), int(bucket)))
        if self._c_rows is not None:
            self._c_rows.inc(int(n_real), kind="real", **self._labels)
            self._c_rows.inc(int(bucket) - int(n_real), kind="padding",
                             **self._labels)
            self._c_batches.inc(**self._labels)
            self._g_fill.set(self.ratio(), **self._labels)
            self._c_sizes.inc(size=int(n_real), **self._labels)

    def ratio(self) -> float:
        with self._lock:
            return self.real / self.padded if self.padded else 0.0

    def recent_ratio(self, n: int = 16) -> Optional[float]:
        """Fill over the last `n` formed batches, or None with no recent
        batches: real rows over the padded bucket slots they ran in."""
        with self._lock:
            tail = list(self._recent)[-int(n):]
        real = sum(r for r, _ in tail)
        padded = sum(b for _, b in tail)
        return real / padded if padded else None

    def recent_occupancy(self, capacity: int,
                         n: int = 16) -> Optional[float]:
        """Mean real rows per recent batch as a fraction of `capacity`
        (max_batch), or None with no recent batches: the router's
        coalescing trigger. Bucket-relative fill is blind to a fragmented
        trickle (a single request pads into bucket 1 at fill 1.0);
        occupancy against capacity is not."""
        with self._lock:
            tail = list(self._recent)[-int(n):]
        if not tail or capacity <= 0:
            return None
        real = sum(r for r, _ in tail)
        return min(1.0, real / (len(tail) * capacity))

    def snapshot(self) -> Tuple[int, int, int]:
        """(real, padded, batches) read consistently under the lock."""
        with self._lock:
            return self.real, self.padded, self.batches

    def size_hist(self) -> Dict[int, int]:
        """{real batch size: formed batches} — a consistent copy."""
        with self._lock:
            return dict(self.size_counts)

    def reset(self) -> None:
        with self._lock:
            self.real = self.padded = self.batches = 0
            self.size_counts.clear()
            self._recent.clear()
