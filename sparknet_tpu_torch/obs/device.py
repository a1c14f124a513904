"""Device-level telemetry: the card's memory, and compile events.

The counterpart of `sparknet_tpu/obs/device.py`. Two signals:

  - **Memory** (`DeviceTelemetry`). `torch.cuda.memory_stats()` of the
    caching allocator is exported as gauges labelled by device and sampled
    at the train loop's flush cadence — the curve that answers "is this
    OOM a leak or a step change" without attaching a profiler:

  sparknet_device_hbm_bytes_in_use    bytes held by live tensors
                                      (allocated_bytes.all.current)
  sparknet_device_hbm_peak_bytes      their high-water mark
                                      (allocated_bytes.all.peak)
  sparknet_device_hbm_bytes_reserved  bytes the caching allocator holds
                                      from the driver
                                      (reserved_bytes.all.current)
  sparknet_device_hbm_bytes_limit     the card's memory

    A CPU device has no allocator stats, so its gauges stay unset, as the
    JAX package's do on a backend without them. The JAX module's live jax
    array gauge (`sparknet_device_live_arrays`) has no counterpart: an
    eager process holds no jax arrays.

  - **Compiles.** `note_compile(what, seconds, cache_hit=...)` is the
    process-wide record, as in the JAX package: `CompiledNet.compile`
    stamps spec compiles ("net"; a memo hit is `cache_hit=True`, a memo
    miss `None`), the serve worker stamps the first forward of each batch
    bucket ("serve_bucket"), with the verdict of
    `utils/compile_cache.track_compiles` over it: "false" when that forward
    ran nvcc (a kernel library missing from the warm-up cache), "true"
    when it ran none. `attach_compile_metrics` replays the history into a
    registry as `sparknet_compile_events_total{what,cache_hit}` +
    `sparknet_compile_seconds{what}` (the histogram records non-"true"
    events only, so memo and cache hits never dilute the compile-cost
    percentiles), so a registry created after the model was built (the
    train loop's per-run registry) still shows the compiles before it.

The accumulator is process-global by design (compiles happen before any
registry exists); attached registries are held weakly so per-run and
per-test registries die normally.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .registry import Metric, MetricsRegistry

#: compile durations span four orders of magnitude: a sub-ms memoized spec
#: compile to a minutes-long kernel build
COMPILE_BUCKETS = (0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0, 120.0, 300.0)

_lock = threading.Lock()
#: (what, seconds, cache_hit), process lifetime. cache_hit: True/False/None
_events: List[Tuple[str, float, Optional[bool]]] = []
#: weakly-held (counter, histogram) pairs of attached registries
_attached: List[Tuple["weakref.ref[Metric]", "weakref.ref[Metric]"]] = []


def _hit_label(cache_hit: Optional[bool]) -> str:
    return "unknown" if cache_hit is None else \
        ("true" if cache_hit else "false")


def note_compile(what: str, seconds: float,
                 cache_hit: Optional[bool] = None) -> None:
    """Record one compile event (`what` is the site: "net" for
    CompiledNet.compile, "serve_bucket" for a serve bucket's first
    forward). `cache_hit` is the warm-up cache's verdict for the region
    (module doc; None = not sampled). Fans out to every attached registry;
    never raises."""
    cache_hit = None if cache_hit is None else bool(cache_hit)
    with _lock:
        _events.append((str(what), float(seconds), cache_hit))
        pairs = list(_attached)
    for c_ref, h_ref in pairs:
        c, h = c_ref(), h_ref()
        if c is None or h is None:
            continue
        try:
            c.inc(what=what, cache_hit=_hit_label(cache_hit))
            if cache_hit is not True:
                h.observe(seconds, what=what)
        except Exception:
            pass  # a dying registry must not break the compile path


def attach_compile_metrics(registry: MetricsRegistry) -> None:
    """Register the compile counter + histogram into `registry`, replay
    every event recorded so far (compiles routinely PRECEDE registry
    creation), and keep feeding it (weakly held) as new ones land."""
    c = registry.counter("sparknet_compile_events_total",
                         "XLA/spec compile events by site and persistent-"
                         "cache outcome", labels=("what", "cache_hit"))
    h = registry.histogram("sparknet_compile_seconds",
                           "seconds per FRESH compile event (cache/memo "
                           "hits excluded — real compile cost only)",
                           labels=("what",), buckets=COMPILE_BUCKETS)
    with _lock:
        history = list(_events)
        _attached[:] = [(cr, hr) for cr, hr in _attached
                        if cr() is not None and hr() is not None]
        _attached.append((weakref.ref(c), weakref.ref(h)))
    for what, seconds, cache_hit in history:
        c.inc(what=what, cache_hit=_hit_label(cache_hit))
        if cache_hit is not True:
            h.observe(seconds, what=what)


def compile_stats() -> Dict[str, Dict[str, float]]:
    """{what: {"events": n, "seconds": total, "cache_hits": n,
    "cache_misses": n}}: the accumulated record. Events with an unknown
    verdict count in "events" only."""
    out: Dict[str, Dict[str, float]] = {}
    with _lock:
        for what, seconds, cache_hit in _events:
            d = out.setdefault(what, {"events": 0, "seconds": 0.0,
                                      "cache_hits": 0, "cache_misses": 0})
            d["events"] += 1
            d["seconds"] += seconds
            if cache_hit is not None:
                d["cache_hits" if cache_hit else "cache_misses"] += 1
    return out


class timed_compile:
    """Context manager stamping its wall time as one compile event, with
    the warm-up cache's verdict sampled over the region (per thread:
    concurrent lanes' builds don't cross-attribute)."""

    def __init__(self, what: str):
        self.what = what

    def __enter__(self):
        from ..utils.compile_cache import track_compiles
        self._track = track_compiles()
        self._track.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._track.__exit__(*exc)
        if exc[0] is None:
            note_compile(self.what, time.perf_counter() - self._t0,
                         cache_hit=self._track.cache_hit)
        return False

#: memory_stats() keys -> gauge name, help text
_MEM_KEYS = (("allocated_bytes.all.current",
              "sparknet_device_hbm_bytes_in_use",
              "allocator bytes currently in use by live tensors"),
             ("allocated_bytes.all.peak", "sparknet_device_hbm_peak_bytes",
              "allocator high-water mark"),
             ("reserved_bytes.all.current",
              "sparknet_device_hbm_bytes_reserved",
              "bytes the caching allocator holds from the driver"))
_LIMIT = ("sparknet_device_hbm_bytes_limit", "the card's memory capacity")


class DeviceTelemetry:
    """Registers and samples the memory gauges of `devices` (default: the
    cards this process uses — the current CUDA device when one is
    available, else none). `sample()` never raises: a failed read
    degrades to a missing sample, since observability must not take
    training down."""

    def __init__(self, registry: MetricsRegistry,
                 devices: Optional[Iterable[torch.device]] = None):
        self.registry = registry
        self._gauges = {name: registry.gauge(name, help_text,
                                             labels=("device",))
                        for _, name, help_text in _MEM_KEYS}
        self._g_limit = registry.gauge(_LIMIT[0], _LIMIT[1],
                                       labels=("device",))
        if devices is None:
            devices = ([torch.device("cuda", torch.cuda.current_device())]
                       if torch.cuda.is_available() else [])
        self.devices = [torch.device(d) for d in devices]

    def sample(self) -> None:
        for d in self.devices:
            if d.type != "cuda":
                continue  # no allocator stats off the card
            try:
                stats = torch.cuda.memory_stats(d)
                limit = torch.cuda.get_device_properties(d).total_memory
            except (RuntimeError, AssertionError):
                continue
            label = str(d)
            for key, name, _ in _MEM_KEYS:
                v = stats.get(key)
                if v is not None:
                    self._gauges[name].set(float(v), device=label)
            self._g_limit.set(float(limit), device=label)
