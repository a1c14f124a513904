"""Host-side span tracer: Chrome-trace-event JSON with per-thread lanes.

A copy of `sparknet_tpu/obs/trace.py` (pure Python). A device profiler
answers "what did the device do"; this answers "where did the host's wall
clock go" across threads. Code wraps its sections in `span("name")`
context managers (the serve worker's forward and the weight install; the
train loop's phase timers, round prep, H2D prefetch and the checkpoint
writer); each completed span becomes one Chrome `"X"` (complete) event
with `ts`/`dur` in microseconds and the recording thread as its `tid`,
`instant` adds a zero-duration `"i"` mark (the train loop's per-round
`flush`), and `write()` produces a JSON file loadable in Perfetto /
chrome://tracing.

Timestamps are epoch-anchored (epoch_at_start + perf_counter elapsed), so
traces from different processes merge on one timeline.

Tracing is off by default and costs one None-check per span when off. One
process-wide active tracer: spans are emitted by library code that cannot
know which run is being traced, so activation is global —
`start_tracing()` / `stop_tracing()`, or the `tracing(path)` context
manager.

Beyond the JAX package's tracer:
  - a span inside another on the same thread takes the enclosing span's
    `round` and `step` args unless it sets its own (the trainers' step
    spans give them to the forward, backward and solver spans below);
  - while a profiler runs, a span is also a `torch.profiler.
    record_function` range, so a profiler trace (`profile_dir`) shows each
    kernel under the span that launched it;
  - `card_span` is a span whose edges are also timed on the card: with a
    `CardClock` attached (`attach_card`; the train loop attaches one on a
    card), each edge records a CUDA timing event on the current stream
    beside the host time it was queued at. `CardClock.resolve` places the
    events on this tracer's clock, from an anchor event recorded on an
    idle card, once they completed, writes each span on a `card` lane,
    and returns the card ms per span name and the host's smallest lead
    over the card at an edge.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, Iterator, List, Optional

#: events kept per tracer; beyond this new spans are counted but dropped
#: (a runaway soak must not OOM the host to produce a trace)
MAX_EVENTS = 500_000
#: the args a nested span takes from the span around it
INHERITED = ("round", "step")
#: the lane card-timed spans are written on (`CardClock.resolve`)
CARD_LANE = "card"


class Tracer:
    """Collects span events; thread-safe; one instance per capture."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._thread_names: Dict[int, str] = {}
        self._lanes: Dict[str, int] = {}
        self._open = threading.local()  # each thread's open spans' args
        self.dropped = 0
        self.pid = os.getpid()
        # epoch-anchored monotonic clock: ts = (_epoch0 + perf_counter) µs
        self._epoch0 = time.time() - time.perf_counter()
        #: the card's clock for card-timed spans (`attach_card`), or None
        self.card: Optional[CardClock] = None
        self._profiling = _profiler_probe()

    def now_us(self) -> float:
        return (self._epoch0 + time.perf_counter()) * 1e6

    def attach_card(self, device, new_event=None) -> "CardClock":
        """Time card spans on `device` from now on (`CardClock`)."""
        self.card = CardClock(self, device, new_event)
        return self.card

    def add_complete(self, name: str, t0_us: float, dur_us: float,
                     args: Optional[Dict[str, Any]] = None) -> None:
        self._record({"name": name, "ph": "X", "cat": "host",
                      "ts": round(t0_us, 3), "dur": round(dur_us, 3)}, args)

    def add_lane_complete(self, lane: str, name: str, t0_us: float,
                          dur_us: float,
                          args: Optional[Dict[str, Any]] = None) -> None:
        """A complete event on a named lane of its own (not a thread's)."""
        with self._lock:
            tid = self._lanes.setdefault(lane, len(self._lanes) + 1)
        self._keep({"name": name, "ph": "X", "cat": lane,
                    "ts": round(t0_us, 3), "dur": round(dur_us, 3),
                    "pid": self.pid, "tid": tid}, args, None)

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration mark (scope: thread) — e.g. a log flush."""
        self._record({"name": name, "ph": "i", "s": "t", "cat": "host",
                      "ts": round(self.now_us(), 3)}, args)

    def _record(self, ev: Dict[str, Any],
                args: Optional[Dict[str, Any]]) -> None:
        """Stamp `ev` with this process and thread and keep it (counted
        as dropped beyond MAX_EVENTS)."""
        th = threading.current_thread()
        ev.update(pid=self.pid, tid=th.ident)
        self._keep(ev, args, th)

    def _keep(self, ev: Dict[str, Any], args: Optional[Dict[str, Any]],
              th: Optional[threading.Thread]) -> None:
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= MAX_EVENTS:
                self.dropped += 1
                return
            if th is not None:
                self._thread_names.setdefault(th.ident, th.name)
            self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot: span events plus thread-name metadata (`"M"`) records
        so each lane is labeled (MainThread / round-prep_0 / ckpt-write_0 /
        serve-worker / card) instead of a bare thread id."""
        with self._lock:
            evs = list(self._events)
            names = dict(self._thread_names)
            names.update((tid, lane) for lane, tid in self._lanes.items())
        meta = [{"name": "thread_name", "ph": "M", "pid": self.pid,
                 "tid": tid, "args": {"name": name}}
                for tid, name in sorted(names.items())]
        meta.append({"name": "process_name", "ph": "M", "pid": self.pid,
                     "args": {"name": f"sparknet_tpu_torch pid {self.pid}"}})
        return meta + evs

    def write(self, path: str) -> int:
        """Write the Chrome trace JSON object form; returns event count."""
        evs = self.events()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": evs, "displayTimeUnit": "ms",
                       "otherData": {"dropped_events": self.dropped}}, f)
        return len(evs)


class CardClock:
    """Timing events at the edges of card-timed spans, placed on a
    tracer's clock.

    An anchor is a timing event recorded on an idle card (after a
    synchronize), with the host time its record returned. An edge is a
    timing event taken from a reused pool and recorded on the current
    stream, with the host time it was queued at. Once an edge's event has
    completed, the card reached it at anchor host time +
    `anchor.elapsed_time(event)`; its lead is that minus the host time it
    was queued at (near 0 where the card waited on the host).

    On an H100 the card's timer wanders from the host's clock by over
    100 µs a minute, so `reanchor_if_due` (the loop calls it at each round
    boundary) synchronizes and re-anchors once the anchor is `REANCHOR_S`
    old: one drained pipeline every 10 s keeps an event queued on the idle
    card placed 8-126 µs after its queueing over a minute.

    Spans are kept in order until `take()` hands them over with their
    anchor (the loop, once a round); `resolve(batch)` runs after their
    last event completed (the loop's flush, after the round's `done`
    event). `new_event` makes the events (a timing CUDA event by default;
    the tests pass a fake)."""

    #: seconds an anchor is used for before `reanchor_if_due` re-anchors
    REANCHOR_S = 10.0

    def __init__(self, tracer: Tracer, device, new_event=None):
        import torch
        self._tracer = tracer
        self.device = torch.device(device)
        self._new = new_event or (
            lambda: torch.cuda.Event(enable_timing=True))
        cuda = self.device.type == "cuda"
        self._sync = ((lambda: torch.cuda.synchronize(self.device))
                      if cuda else (lambda: None))
        self._stream = ((lambda: torch.cuda.current_stream(self.device))
                        if cuda else (lambda: None))
        self._free: deque = deque()
        self._lock = threading.Lock()
        self._spans: List[tuple] = []
        self.reanchor()

    def reanchor(self) -> None:
        """Synchronize, then record a new anchor for the spans to come."""
        self._sync()
        ev = self._new()
        ev.record(self._stream())
        self.anchor, self.anchor_us = ev, self._tracer.now_us()
        self._anchored = time.perf_counter()

    def reanchor_if_due(self) -> bool:
        """`reanchor` when the anchor is REANCHOR_S old; whether it did."""
        if time.perf_counter() - self._anchored < self.REANCHOR_S:
            return False
        self.reanchor()
        return True

    def edge(self) -> tuple:
        """(event, host µs it was queued at), recorded now."""
        try:
            ev = self._free.popleft()
        except IndexError:
            ev = self._new()
        t = self._tracer.now_us()
        ev.record(self._stream())
        return ev, t

    def add(self, name: str, args: Optional[Dict[str, Any]], first: tuple,
            last: tuple) -> None:
        with self._lock:
            self._spans.append((name, args, first, last))

    def take(self) -> tuple:
        """(anchor, anchor host µs, the card spans closed since the last
        take, in order): a batch for `resolve`."""
        with self._lock:
            spans, self._spans = self._spans, []
        return self.anchor, self.anchor_us, spans

    def resolve(self, batch: tuple) -> Dict[str, float]:
        """Place a batch of `take()` (every event completed) on the
        tracer's clock: each span goes on the card lane from the card's
        first edge to its last. Returns {"card_<name>_ms": card ms
        between each span's edges, summed by name, "host_lead_ms": the
        smallest lead over the spans' edges}; {} for no spans. Their
        events go back to the pool."""
        a, a_us, spans = batch
        if not spans:
            return {}
        out: Dict[str, float] = {}
        lead = float("inf")
        for name, args, (e0, q0), (e1, q1) in spans:
            t0 = a_us + a.elapsed_time(e0) * 1e3
            t1 = a_us + a.elapsed_time(e1) * 1e3
            key = f"card_{name}_ms"
            out[key] = out.get(key, 0.0) + (t1 - t0) / 1e3
            lead = min(lead, t0 - q0, t1 - q1)
            self._tracer.add_lane_complete(CARD_LANE, name, t0, t1 - t0,
                                           args)
            self._free.append(e0)
            self._free.append(e1)
        out["host_lead_ms"] = lead / 1e3
        return out


def _profiler_probe():
    """A callable saying whether a torch profiler is recording (then a
    span is a record_function range too), or None without torch."""
    try:
        import torch
        return torch.autograd._profiler_enabled
    except (ImportError, AttributeError):
        return None


class _Span:
    """One open span of an active tracer (`span`, `card_span`)."""

    __slots__ = ("tr", "name", "args", "card", "t0", "first", "rf",
                 "stack")

    def __init__(self, tr: Tracer, name: str, args: Dict[str, Any],
                 card: bool):
        self.tr, self.name, self.args = tr, name, args
        self.card = tr.card if card else None
        self.rf = self.first = None

    def __enter__(self) -> None:
        tr = self.tr
        stack = getattr(tr._open, "stack", None)
        if stack is None:
            stack = tr._open.stack = []
        if stack:
            outer = stack[-1]
            for k in INHERITED:
                if k in outer and k not in self.args:
                    self.args[k] = outer[k]
        stack.append(self.args)
        self.stack = stack
        if tr._profiling is not None and tr._profiling():
            from torch.profiler import record_function
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = tr.now_us()
        if self.card is not None:
            self.first = self.card.edge()

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self.tr
        if self.card is not None and exc_type is None:
            self.card.add(self.name, self.args or None, self.first,
                          self.card.edge())
        t1 = tr.now_us()
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        self.stack.pop()
        # re-read: a tracer stopped mid-span (loop teardown while the
        # checkpoint writer drains) must not resurrect into the report
        if _active is tr:
            tr.add_complete(self.name, self.t0, t1 - self.t0,
                            self.args or None)
        return False


_active: Optional[Tracer] = None
#: what `span` and `card_span` return with tracing off
_OFF = nullcontext()


def active_tracer() -> Optional[Tracer]:
    """The installed tracer, or None when tracing is off."""
    return _active


def start_tracing(tracer: Optional[Tracer] = None) -> Tracer:
    """Install `tracer` (or a fresh one) as the process-wide span sink."""
    global _active
    _active = tracer or Tracer()
    return _active


def stop_tracing() -> Optional[Tracer]:
    """Uninstall and return the active tracer (None when none was on)."""
    global _active
    t, _active = _active, None
    return t


def span(name: str, **args: Any):
    """Record the with-block as one complete event on the current thread's
    lane. Near-free when tracing is off (one global read + None check)."""
    tr = _active
    if tr is None:
        return _OFF
    return _Span(tr, name, args, False)


def card_span(name: str, **args: Any):
    """`span`, whose edges are also timed on the card when the tracer has
    a `CardClock` (module docstring). One None check when tracing is off:
    no event, no record_function."""
    tr = _active
    if tr is None:
        return _OFF
    return _Span(tr, name, args, True)


@contextmanager
def tracing(path: Optional[str] = None) -> Iterator[Tracer]:
    """Capture spans for the with-block; write to `path` on exit when
    given. The train loop's `--trace-out` wrapper."""
    tr = start_tracing()
    try:
        yield tr
    finally:
        stop_tracing()
        if path:
            tr.write(path)
