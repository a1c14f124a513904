"""Dynamic batching: a thread-safe request queue + the batch-forming policy.

The policy is the adaptive-batching core of Clipper (Crankshaw et al.,
NSDI 2017): a batch closes when EITHER it reaches `max_batch` examples OR
the OLDEST queued request has waited `max_wait_s` — so under saturating
load batches run full (throughput mode: the jit forward amortizes over
max_batch rows) and under trickle load no request waits longer than the
deadline plus one forward (latency mode). The deadline is keyed on the
oldest request, not the newest: a steady trickle cannot starve the head
of the queue by perpetually resetting the timer.

The consumer is WOKEN ON SUBMIT: `next_batch` parks on a condition
variable with no polling quantum — an idle worker sleeps until the next
`submit` notifies it (or until `wake_at`, the caller's periodic-duty
alarm for hot-reload polls and heartbeats). The old `poll_s` idle tick
put up to one poll interval of pure quantization into a lone request's
latency; now a lone request's latency is bounded by `max_wait_s` plus
one forward, full stop (pinned in tests).

Requests may carry a client DEADLINE (`submit(deadline_s=...)`). Batch
formation is deadline-aware twice over: the batch closes early when a
queued request's deadline would expire before the oldest-request timer
(serve it while the answer still matters), and a request whose deadline
has ALREADY expired is shed at formation — its future fails with
`DeadlineExpiredError` and it never pads into a bucket, so dead requests
never occupy forward slots (Orca's lesson: schedule the queue into the
accelerator's batch shape, and the batch shape is too precious for
corpses). Shed demand is counted per reason on
`sparknet_serve_shed_total{model,reason}`.

One consumer (the server's worker thread, or one router pool thread at a
time under the lane lock) calls `next_batch`; any number of producer
threads call `submit` and block on the returned
`concurrent.futures.Future`. Padding to shape buckets is the SERVER's
concern — the batcher only promises len(batch) <= max_batch, so a batch
never spans buckets.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class QueueFullError(RuntimeError):
    """Backpressure signal: the request queue is at capacity. Callers
    (an RPC frontend, a bench client) should shed or retry — unbounded
    queueing would just convert overload into unbounded latency. The
    HTTP frontend maps this to 429 + Retry-After."""


class RequestCancelledError(RuntimeError):
    """The request was cancelled (hedging's losing leg, or an explicit
    client CANCEL frame) while still queued — it never formed into a
    batch. Cancellation is BEST-EFFORT: a request that already formed
    cannot be cancelled and completes normally (the wire maps this to
    the 499 `cancelled` error kind)."""


class DeadlineExpiredError(RuntimeError):
    """The request's client deadline passed before a forward could run;
    it was shed instead of padded into a bucket. The HTTP frontend maps
    this to 503 + Retry-After (the answer would have been dead on
    arrival — better an immediate, honest shed than a late response)."""


@dataclass
class ServeRequest:
    """One queued inference request: per-example input arrays (no batch
    dim), the future its response lands on, its enqueue time (the
    latency clock starts at submit, not at batch formation), and an
    optional absolute client deadline on the same perf_counter clock."""

    payload: Dict[str, np.ndarray]
    future: Future = field(default_factory=Future)
    t_enqueue: float = field(default_factory=time.perf_counter)
    id: int = 0
    deadline: Optional[float] = None
    # admission class the request arrived under ("high"/"normal"/"low");
    # the fleet controller reads the queue's low-priority share so
    # scavenger (batch-tenant) backlog never reads as online demand
    priority: str = "normal"
    # per-request named output blobs (the featurizer route): None =
    # the lane's configured outputs / default per-row blobs
    outputs: Optional[Tuple[str, ...]] = None
    # distributed-trace context (obs/reqtrace.TraceContext) riding the
    # request through batch formation: None = untraced (the common case;
    # the worker's span emission is gated on this plus one global check)
    trace: Optional[Any] = None


class DynamicBatcher:
    """Thread-safe queue + max-batch/max-wait batch former (one consumer).

    `model` labels every metric family this batcher registers (the
    multi-model router shares ONE registry across lanes — per-model
    labels are what keep the lanes' demand distinguishable). `on_submit`
    is an optional callback fired after each accepted enqueue, OUTSIDE
    the queue lock — the router's pool scheduler hangs its wake-up on
    it."""

    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.005,
                 max_queue: int = 1024, registry=None,
                 model: str = "default",
                 on_submit: Optional[Callable[[], None]] = None):
        assert max_batch >= 1 and max_queue >= max_batch
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.max_queue = int(max_queue)
        self.model = str(model)
        self.on_submit = on_submit
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._ids = itertools.count()
        self._closed = False
        self.shed = 0  # lifetime shed count (all reasons)
        # shared-schema telemetry (obs.MetricsRegistry): accepted vs shed
        # demand, and the live queue depth as a scrape-time gauge
        self._c_submitted = self._c_rejected = self._c_shed = None
        if registry is not None:
            self._c_submitted = registry.counter(
                "sparknet_serve_submitted_total", "requests accepted",
                labels=("model",))
            self._c_rejected = registry.counter(
                "sparknet_serve_queue_rejected_total",
                "requests shed by backpressure (queue at capacity)",
                labels=("model",))
            self._c_shed = registry.counter(
                "sparknet_serve_shed_total",
                "requests shed before a forward, by reason (deadline = "
                "client deadline expired before batch formation)",
                labels=("model", "reason"))
            registry.gauge(
                "sparknet_serve_queue_depth",
                "requests queued, not yet formed into a batch",
                labels=("model",)
            ).set_fn(self.depth, model=self.model)

    def depth(self) -> int:
        return len(self._q)  # len(deque) is atomic; hot path, no lock

    def low_depth(self) -> int:
        """Queued requests in the "low" class (scavenger/batch tenants).
        Scanned under the lock at the fleet controller's tick cadence —
        never on the submit hot path."""
        with self._lock:
            return sum(1 for r in self._q if r.priority == "low")

    def submit(self, payload: Dict[str, Any],
               deadline_s: Optional[float] = None,
               priority: Optional[str] = None,
               outputs: Optional[Tuple[str, ...]] = None,
               trace: Optional[Any] = None) -> Future:
        """Enqueue one request; returns its response future. Raises
        QueueFullError at capacity and RuntimeError after close().
        `deadline_s` (relative seconds) is the client's answer-by bound:
        a request that cannot be formed into a batch before it expires
        is shed with DeadlineExpiredError instead of riding a bucket
        slot. An ALREADY-expired deadline returns a pre-failed future
        without touching the queue. `priority` tags the queued request
        with its admission class (low-share telemetry); `outputs` pins
        per-request named blobs for the forming forward; `trace` is the
        request's distributed-trace context (rides to the worker)."""
        req = ServeRequest(payload={k: np.asarray(v)
                                    for k, v in payload.items()},
                           priority=(priority or "normal"),
                           outputs=(tuple(outputs) if outputs else None),
                           trace=trace)
        if deadline_s is not None:
            req.deadline = req.t_enqueue + float(deadline_s)
            if deadline_s <= 0:
                self._shed([req], "deadline")
                return req.future
        with self._nonempty:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._q) >= self.max_queue:
                if self._c_rejected is not None:
                    self._c_rejected.inc(model=self.model)
                raise QueueFullError(
                    f"request queue at capacity ({self.max_queue})")
            req.id = next(self._ids)
            self._q.append(req)
            self._nonempty.notify()
        if self._c_submitted is not None:
            self._c_submitted.inc(model=self.model)
        if self.on_submit is not None:
            self.on_submit()
        return req.future

    def cancel(self, future: Future) -> bool:
        """Best-effort cancel of a QUEUED request by its future: remove
        it from the queue and fail the future with
        RequestCancelledError. Returns True iff the request was still
        queued — False means it already formed into a batch (or was
        never here) and will complete normally; the caller drops the
        cancel, exactly-once delivery is preserved by the future's
        first-resolution-wins semantics."""
        hit: Optional[ServeRequest] = None
        with self._nonempty:
            for r in self._q:
                if r.future is future:
                    hit = r
                    break
            if hit is not None:
                self._q.remove(hit)
        if hit is None:
            return False
        if not hit.future.done():
            hit.future.set_exception(RequestCancelledError(
                "request cancelled while queued (never formed into a "
                "batch)"))
        with self._lock:
            self.shed += 1
        if self._c_shed is not None:
            self._c_shed.inc(1, model=self.model, reason="cancelled")
        return True

    def _pop_expired_locked(self, now: float) -> List[ServeRequest]:
        """Remove every queued request whose deadline has passed (caller
        holds the lock; futures are resolved OUTSIDE it)."""
        if not any(r.deadline is not None and r.deadline <= now
                   for r in self._q):
            return []
        keep, dead = [], []
        for r in self._q:
            (dead if r.deadline is not None and r.deadline <= now
             else keep).append(r)
        self._q.clear()
        self._q.extend(keep)
        return dead

    def _shed(self, reqs: List[ServeRequest], reason: str) -> None:
        """Fail shed requests' futures + count them. Callers hold no
        lock (set_exception may run waiter callbacks); the counter add
        takes the queue lock once — submit() sheds pre-expired requests
        on N producer threads concurrently with the consumer's
        formation sheds, and a bare += would lose counts."""
        if not reqs:
            return
        for r in reqs:
            if not r.future.done():
                waited = time.perf_counter() - r.t_enqueue
                r.future.set_exception(DeadlineExpiredError(
                    f"deadline expired before batch formation "
                    f"(waited {waited * 1e3:.1f} ms)"))
        with self._lock:
            self.shed += len(reqs)
        if self._c_shed is not None:
            self._c_shed.inc(len(reqs), model=self.model, reason=reason)

    def next_batch(self, wake_at: Optional[float] = None,
                   poll_s: Optional[float] = None
                   ) -> Optional[List[ServeRequest]]:
        """Form the next batch. Parks on the condition variable until a
        submit arrives (wake-on-submit — no polling quantum); `wake_at`
        (absolute perf_counter time) is the caller's periodic-duty alarm:
        with an empty queue the call returns None at `wake_at` so the
        worker can run hot-reload polls and heartbeats, then park again.
        `wake_at=None` blocks until work or close(). `poll_s` is the
        legacy relative form of the same alarm.

        Once a first request exists, the batch is held open until
        max_batch is reached, the OLDEST request's deadline
        (t_enqueue + max_wait_s) expires, or a queued request's CLIENT
        deadline would expire (close early and serve it while the answer
        matters). Requests whose client deadline already passed are shed
        here — before padding — and never returned. Returns None after
        close()."""
        if poll_s is not None and wake_at is None:
            wake_at = time.perf_counter() + float(poll_s)
        shed: List[ServeRequest] = []
        batch: List[ServeRequest] = []
        with self._nonempty:
            while not self._q and not self._closed:
                now = time.perf_counter()
                if wake_at is not None and now >= wake_at:
                    break
                self._nonempty.wait(
                    timeout=None if wake_at is None else wake_at - now)
            if self._q:
                close_at = self._q[0].t_enqueue + self.max_wait_s
                while len(self._q) < self.max_batch and not self._closed:
                    now = time.perf_counter()
                    # deadline-aware close: only the first max_batch
                    # requests can make THIS batch, so only their client
                    # deadlines may close it early — a hair EARLY
                    # (1 ms), so the request is served on the near side
                    # of its deadline instead of shed exactly at it
                    eff = min([close_at] + [
                        r.deadline - 1e-3 for r in
                        itertools.islice(self._q, self.max_batch)
                        if r.deadline is not None])
                    if eff - now <= 0:
                        break
                    self._nonempty.wait(timeout=eff - now)
                # shed the dead BEFORE they pad into a bucket
                shed = self._pop_expired_locked(time.perf_counter())
                n = min(len(self._q), self.max_batch)
                batch = [self._q.popleft() for _ in range(n)]
        self._shed(shed, "deadline")
        return batch or None

    def close(self) -> None:
        """Stop accepting requests and fail everything still queued (the
        server drains in-flight batches separately; queued-but-unformed
        requests must not hang their clients forever)."""
        with self._nonempty:
            self._closed = True
            leftovers = list(self._q)
            self._q.clear()
            self._nonempty.notify_all()
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("server shut down before this request "
                                 "was served"))
