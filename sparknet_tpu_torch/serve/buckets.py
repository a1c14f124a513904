"""Traffic-derived batch-bucket ladders.

A copy of `sparknet_tpu/serve/buckets.py` (pure Python): the port imports
nothing of the JAX package. It reads the `batch_size_hist` rows the
port's `FillMeter.size_hist` writes through the server's metrics JSONL.

The server pads every formed batch up to a configured bucket so the net
sees exactly `len(buckets)` batch shapes (each one's first forward pays
cuDNN's algorithm choice and the allocator's growth). The default ladder
is powers of two up to max_batch — a blind guess. But `FillMeter` already
records exactly what batch sizes traffic forms (`batch_size_hist` in the
serve JSONL / /status); `derive_buckets` turns that histogram into the
ladder that MINIMIZES padded slots for the observed distribution (Orca,
OSDI'22: schedule the queue *into* the accelerator's batch shape — here
the dual: shape the compiled forwards to the queue the traffic forms).

Exact DP: the optimal <=k-rung ladder's rungs sit ON observed sizes (any
rung between two observed sizes can drop to the lower one without cost),
so candidates are the distinct observed sizes plus the mandatory top rung
`max_batch` (a full batch must always have a bucket). Minimizing
`sum_s count[s] * rung(s)` — total padded slots, the denominator of the
fill ratio — over m distinct sizes and k rungs is O(m^2 k); m <= max_batch
makes this instant.

Workflow (offline first, per the bucket-ladder acceptance):

    python -m sparknet_tpu_torch.serve.app --model lenet ... --workdir run/
    python -m sparknet_tpu_torch.serve.app --model lenet ... \
        --buckets-from run/serving_metrics_*.jsonl

The second invocation reads the recorded `batch_size_hist` rows and
serves on the fitted ladder; `bucket_compiles == len(buckets)` after full
traffic (the ladder changes shape, never the first-forward count).
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Mapping, Optional, Tuple


def padded_slots(sizes: Mapping[int, int],
                 buckets: Tuple[int, ...]) -> int:
    """Total padded bucket slots the ladder spends on this traffic
    histogram (each size rides the smallest rung >= it). The fill ratio
    of a ladder on a histogram is sum(s*n)/padded_slots."""
    bs = sorted(buckets)
    total = 0
    for s, n in sizes.items():
        rung = next((b for b in bs if b >= s), None)
        if rung is None:
            raise ValueError(f"batch size {s} exceeds the largest bucket "
                             f"{bs[-1]}")
        total += rung * int(n)
    return total


def fill_ratio(sizes: Mapping[int, int], buckets: Tuple[int, ...]) -> float:
    real = sum(int(s) * int(n) for s, n in sizes.items())
    padded = padded_slots(sizes, buckets)
    return real / padded if padded else 0.0


def derive_buckets(sizes: Mapping[int, int], max_batch: int,
                   k: int = 4) -> Tuple[int, ...]:
    """Fit a <=k-rung bucket ladder to an observed batch-size histogram.

    `sizes`: {real batch size: count} (FillMeter.size_hist(), or the
    JSONL aggregation below — string keys tolerated). Sizes above
    max_batch are clipped to it (the batcher never forms them, but a
    histogram from a previous config might carry them). Returns a sorted
    tuple whose last rung is always max_batch, minimizing total padded
    slots exactly. An empty histogram falls back to (max_batch,) — with
    no evidence, one full-width bucket spends the fewest compiles."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
    if k < 1:
        raise ValueError(f"bucket ladder needs k >= 1 rungs (got {k})")
    hist: Dict[int, int] = {}
    for s, n in sizes.items():
        s, n = int(s), int(n)
        if n <= 0 or s <= 0:
            continue
        hist[min(s, max_batch)] = hist.get(min(s, max_batch), 0) + n
    # the mandatory top rung rides the DP as a (possibly zero-count) size
    hist.setdefault(max_batch, 0)
    ss = sorted(hist)                       # s_0 < ... < s_{m-1}
    counts = [hist[s] for s in ss]
    m = len(ss)
    k = min(k, m)
    csum = [0]
    for n in counts:
        csum.append(csum[-1] + n)           # csum[i] = sum(counts[:i])

    def seg(a: int, b: int) -> int:         # sizes a..b ride rung ss[b]
        return ss[b] * (csum[b + 1] - csum[a])

    # dp[j][i] = min padded slots covering sizes ss[0..i] with exactly
    # j+1 rungs, the top rung AT ss[i]; parent[j][i] = the previous
    # rung's index (-1 = this rung covers from the bottom)
    INF = float("inf")
    dp = [[INF] * m for _ in range(k)]
    parent = [[-1] * m for _ in range(k)]
    for i in range(m):
        dp[0][i] = seg(0, i)
    for j in range(1, k):
        for i in range(j, m):
            best, arg = dp[j - 1][i], -2    # -2 = unused extra rung
            for p in range(j - 1, i):
                c = dp[j - 1][p] + seg(p + 1, i)
                if c < best:
                    best, arg = c, p
            dp[j][i] = best
            parent[j][i] = arg
    # backtrack from (k-1, m-1): the top rung is always ss[m-1]==max_batch
    rungs, j, i = [m - 1], k - 1, m - 1
    while j > 0:
        p = parent[j][i]
        if p == -2:                          # the extra rung bought nothing
            j -= 1
            continue
        if p == -1:
            break
        rungs.append(p)
        j, i = j - 1, p
    return tuple(sorted(ss[r] for r in set(rungs)))


def size_hist_from_jsonl(paths: Iterable[str],
                         model: Optional[str] = None
                         ) -> Dict[str, Dict[int, int]]:
    """Aggregate `batch_size_hist` records from serve metrics JSONLs:
    {model: {size: count}}. The hist rows are CUMULATIVE per process, so
    per file only the LAST row per model counts; multiple files (several
    replicas/processes) sum. `model` filters to one model (still keyed
    in the result)."""
    out: Dict[str, Dict[int, int]] = {}
    for path in paths:
        last: Dict[str, Dict] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                hist = rec.get("batch_size_hist")
                if not isinstance(hist, dict):
                    continue
                name = str(rec.get("model", "default"))
                if model is not None and name != model:
                    continue
                last[name] = hist
        for name, hist in last.items():
            agg = out.setdefault(name, {})
            for s, n in hist.items():
                try:
                    agg[int(s)] = agg.get(int(s), 0) + int(n)
                except (TypeError, ValueError):
                    continue
    return out
