"""Device profiler hook: `maybe_trace` over `torch.profiler`.

The counterpart of `sparknet_tpu/utils/profiling.py` (`jax.profiler`).
PhaseTimers and the host tracer (`obs/trace.py`) say where the host's
wall clock goes; this records what the device did inside a bounded window
of work — every kernel the window launched, by name, with its device
time — and exports it as a Chrome trace (Perfetto, chrome://tracing).
`RunConfig.profile_dir` profiles one steady round of the train loop.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], label: str = "trace"
                ) -> Iterator[None]:
    """Profile the with-block into `<trace_dir>/<label>.pt.trace.json`; a
    no-op when `trace_dir` is falsy. CPU activity always, and CUDA
    activity whenever a card is present: the card is drained before the
    profiler starts and the block's queued kernels are waited for before
    it stops, so the trace holds the block's kernels and no others."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()  # the window holds the block's work only
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir,
                                          f"{label}.pt.trace.json"))
