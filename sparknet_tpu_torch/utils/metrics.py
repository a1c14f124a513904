"""Serving meters, registry-backed: request-latency quantiles and the
dynamic batcher's fill ratio.

A copy of `LatencyStats` and `FillMeter` from `sparknet_tpu/utils/metrics.py`
(pure Python), the two meters the port's inference server needs. Constructed
with a registry they also register the shared-schema metrics
(sparknet_serve_request_latency_seconds, sparknet_serve_batch_*) and update
them on every mutation. They carry their own locks: `summary()` /
`snapshot()` readers get a CONSISTENT view of state the serve worker thread
is mutating.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from ..obs.registry import MetricsRegistry


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
