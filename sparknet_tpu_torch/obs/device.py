"""Device-level telemetry: the card's memory, sampled into the registry.

The counterpart of the memory half of `sparknet_tpu/obs/device.py`
(`DeviceTelemetry`). `torch.cuda.memory_stats()` of the caching allocator
is exported as gauges labelled by device and sampled at the train loop's
flush cadence — the curve that answers "is this OOM a leak or a step
change" without attaching a profiler:

  sparknet_device_hbm_bytes_in_use    bytes held by live tensors
                                      (allocated_bytes.all.current)
  sparknet_device_hbm_peak_bytes      their high-water mark
                                      (allocated_bytes.all.peak)
  sparknet_device_hbm_bytes_reserved  bytes the caching allocator holds
                                      from the driver
                                      (reserved_bytes.all.current)
  sparknet_device_hbm_bytes_limit     the card's memory

A CPU device has no allocator stats, so its gauges stay unset, as the JAX
package's do on a backend without them. The JAX module's other half, the
compile-event record (`note_compile`, `attach_compile_metrics`) and the
live jax array count, has no eager counterpart and is not ported (ROADMAP
A10: graph-capture events).
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from .registry import MetricsRegistry

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
