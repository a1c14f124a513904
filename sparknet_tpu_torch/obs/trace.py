"""Host-side span tracer: Chrome-trace-event JSON with per-thread lanes.

A copy of `sparknet_tpu/obs/trace.py` (pure Python). A device profiler
answers "what did the device do"; this answers "where did the host's wall
clock go" across threads. Code wraps its sections in `span("name")`
context managers (here: the serve worker's forward and the weight
install); each completed span becomes one Chrome `"X"` (complete) event
with `ts`/`dur` in microseconds and the recording thread as its `tid`,
and `write()` produces a JSON file loadable in Perfetto / chrome://tracing.

Timestamps are epoch-anchored (epoch_at_start + perf_counter elapsed), so
traces from different processes merge on one timeline.

Tracing is off by default and costs one None-check per span when off. One
process-wide active tracer: spans are emitted by library code that cannot
know which run is being traced, so activation is global —
`start_tracing()` / `stop_tracing()`, or the `tracing(path)` context
manager.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

#: events kept per tracer; beyond this new spans are counted but dropped
#: (a runaway soak must not OOM the host to produce a trace)
MAX_EVENTS = 500_000


class Tracer:
    """Collects span events; thread-safe; one instance per capture."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._thread_names: Dict[int, str] = {}
        self.dropped = 0
        self.pid = os.getpid()
        # epoch-anchored monotonic clock: ts = (_epoch0 + perf_counter) µs
        self._epoch0 = time.time() - time.perf_counter()

    def now_us(self) -> float:
        return (self._epoch0 + time.perf_counter()) * 1e6

    def add_complete(self, name: str, t0_us: float, dur_us: float,
                     args: Optional[Dict[str, Any]] = None) -> None:
        th = threading.current_thread()
        ev = {"name": name, "ph": "X", "cat": "host",
              "ts": round(t0_us, 3), "dur": round(dur_us, 3),
              "pid": self.pid, "tid": th.ident}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= MAX_EVENTS:
                self.dropped += 1
                return
            self._thread_names.setdefault(th.ident, th.name)
            self._events.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot: span events plus thread-name metadata (`"M"`) records
        so each lane is labeled (MainThread / round-prep_0 / ckpt-write_0 /
        serve-worker) instead of a bare thread id."""
        with self._lock:
            evs = list(self._events)
            names = dict(self._thread_names)
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


_active: Optional[Tracer] = None


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


@contextmanager
def span(name: str, **args: Any) -> Iterator[None]:
    """Record the with-block as one complete event on the current thread's
    lane. Near-free when tracing is off (one global read + None check)."""
    tr = _active
    if tr is None:
        yield
        return
    t0 = tr.now_us()
    try:
        yield
    finally:
        # re-read: a tracer stopped mid-span (loop teardown while the
        # checkpoint writer drains) must not resurrect into the report
        tr2 = _active
        if tr2 is tr:
            tr.add_complete(name, t0, tr.now_us() - t0, args or None)


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
