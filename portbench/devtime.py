"""Device time: kernels queued behind a sleep kernel, and the profiler's
trace reduced to busy time, idle gaps and time by operation.

`device_ms` is a copy of `chip_smoke.device_ms`'s method: the stream is
held by `torch.cuda._sleep` while the host queues the calls between two
CUDA events, so the host's launch overhead does not pace the card; if
queueing took more than half the sleep, it tries again with fewer calls
and a longer sleep. Where the host can never get ahead, it raises.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the annotation that ties the profiler's clock to the host trace's
MARK = "portbench.mark"


def device_ms(fn: Callable[[int], object], n_inputs: int,
              iters: int = 20) -> float:
    """Device ms per call of `fn(i)`, the calls (i cycling over
    `n_inputs`) back to back on the card. Warms up first."""
    import torch
    for i in range(min(n_inputs, 5)):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(8):
        torch.cuda.synchronize()
        sleep_s = min(max(5e-3, 4 * iters * host_s), 2.0)
        torch.cuda._sleep(int(sleep_s * 2e9))
        t0 = time.perf_counter()
        start.record()
        for i in range(iters):
            fn(i % n_inputs)
        end.record()
        queued_s = time.perf_counter() - t0
        end.synchronize()
        host_s = queued_s / iters
        if queued_s <= sleep_s / 2:
            return start.elapsed_time(end) / iters
        iters = max(2, iters // 2)
    raise RuntimeError(f"device time not measured: the host could not "
                       f"queue {iters} calls ahead of the card")


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def device_events(trace: dict) -> List[Tuple[str, float, float]]:
    """(name, start us, duration us) of every device operation."""
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and str(ev.get("cat", "")).lower() in \
                DEVICE_CATS:
            out.append((str(ev.get("name", "")), float(ev["ts"]),
                        float(ev.get("dur", 0.0))))
    return out


def mark_ts(trace: dict) -> Optional[float]:
    """The profiler's start time of the MARK annotation, us."""
    for ev in trace.get("traceEvents", []):
        if ev.get("name") == MARK and ev.get("ph") == "X":
            return float(ev["ts"])
    return None


def union(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merge (start, end) intervals."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_and_gaps(events, t0: float, t1: float):
    """(busy us, [(gap start, gap end)]) of the device inside [t0, t1]."""
    spans = union([(max(s, t0), min(s + d, t1)) for _, s, d in events
                   if s + d > t0 and s < t1])
    busy = sum(e - s for s, e in spans)
    gaps, cur = [], t0
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    return busy, gaps


def by_name(events, top: int = 10) -> List[List[object]]:
    """The operations that took most device time: [[name, seconds]]."""
    tot: Dict[str, float] = {}
    for name, _, d in events:
        tot[name] = tot.get(name, 0.0) + d
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:200], us / 1e6] for name, us in rows]


def main_thread_spans(host_trace: dict) -> List[Tuple[str, float, float,
                                                      dict]]:
    """(name, start us, end us, args) of the host trace's MainThread spans."""
    tid = None
    for ev in host_trace.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name" and \
                ev.get("args", {}).get("name") == "MainThread":
            tid = ev.get("tid")
    return [(ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
             ev.get("args", {}))
            for ev in host_trace.get("traceEvents", [])
            if ev.get("ph") == "X" and ev.get("tid") == tid]


def label_gaps(gaps, spans, offset_us: float, top: int = 10
               ) -> List[List[object]]:
    """The longest gaps, [[what the main thread was doing, seconds]]: the
    innermost host span at the gap's middle (`offset_us` moves device
    time onto the host trace's clock)."""
    rows = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2 + offset_us
        inside = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        if inside:
            name, a, b, args = min(inside, key=lambda sp: sp[2] - sp[1])
            rnd = args.get("round")
            what = name if rnd is None else f"{name} (round {rnd})"
        else:
            what = "no host span"
        rows.append([what, (e - s) / 1e6])
    return rows
