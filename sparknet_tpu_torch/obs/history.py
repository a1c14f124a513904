"""In-process metrics history: the time-series substrate under the SLO layer.

A copy of `sparknet_tpu/obs/history.py` (pure Python): the port imports
nothing of the JAX package. The shard format is the JAX package's, so
each package reads the other's shards (`read_history_shards`).

Every other surface answers "what is happening now": /metrics is a
point-in-time scrape, /status a live vitals dict. `MetricsHistory` makes
the process's `MetricsRegistry` answerable retrospectively: a sampler
thread snapshots the registry on a fixed interval and folds the diffs
into bounded multi-resolution ring buffers (the RRD cascade, e.g.
1 s x 10 min -> 10 s x 2 h -> 60 s x 24 h), so "what was p99 over the
last five minutes" and "how many requests failed in the last hour" are
O(window/res) queries against process memory.

What a ring slot stores, per metric child (one labeled series):

  counters    the DELTA over the slot (a rate is delta/res; counter
              resets clamp to zero, Prometheus-style). The first time a
              child is seen it becomes the baseline — no delta is
              emitted for history that predates the sampler.
  gauges      a (last, min, max) envelope — downsampling keeps the
              envelope honest where "last" alone would alias spikes away.
  histograms  per-bucket count deltas + sum/count deltas, so windowed
              quantiles are answerable after the fact by merging slot
              deltas and interpolating the cumulative bucket curve
              (`quantile_from_buckets`), the estimate Prometheus's
              `histogram_quantile` computes server-side.

Slots merge losslessly (deltas add, envelopes widen), which is what makes
the cascade sound: a 10 s slot is exactly the fold of its ten 1 s slots.

Persistence: base-resolution samples append to JSONL shards
(`history-<seq>.jsonl`, size-rotated, oldest deleted — disk is bounded),
each shard self-describing via a leading meta row. `read_history_shards`
is the offline reader `python -m sparknet_tpu_torch.obs.slo` builds
retrospective reports from.

Serving: `attach_http` adds `/timeseries?name=...&window=...` to the
shared `StatusServer`, so train, serve and router processes all expose
windowed queries.

Thread-safety: one lock guards the rings; the sampler thread, HTTP
handlers and the `BurnRateAlerter` (driven synchronously from the
sampler via listeners) all read/write under it. Registry snapshots are
taken outside the history lock — the registry has its own.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)
from urllib.parse import parse_qs, urlparse

from .registry import MetricsRegistry

# -- series keys -------------------------------------------------------------
# One history series per metric CHILD. The key is the Prometheus-style
# sample name — `name{label=value,...}` in declared label order — chosen
# so shard rows and /timeseries responses read like the exposition and
# parse back without a schema side-channel.


def series_key(name: str, label_names: Sequence[str],
               label_values: Sequence[str]) -> str:
    if not label_names:
        return name
    inner = ",".join(f"{n}={v}" for n, v in zip(label_names, label_values))
    return f"{name}{{{inner}}}"


def split_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of series_key (labels as a dict)."""
    if "{" not in key:
        return key, {}
    name, _, rest = key.partition("{")
    labels: Dict[str, str] = {}
    for pair in rest.rstrip("}").split(","):
        if pair:
            k, _, v = pair.partition("=")
            labels[k] = v
    return name, labels


# -- bucket math -------------------------------------------------------------


def quantile_from_buckets(le: Sequence[float], counts: Sequence[float],
                          count: float, q: float) -> Optional[float]:
    """Quantile estimate from per-bucket (non-cumulative) counts, linear
    interpolation within the containing bucket — the histogram_quantile
    estimate. `count` includes the +Inf overflow (count - sum(counts));
    a quantile landing there clamps to the top finite bound, Prometheus
    convention. None when the window saw no observations."""
    if count <= 0:
        return None
    rank = q * count
    acc = 0.0
    lo = 0.0
    for b, c in zip(le, counts):
        if c > 0 and acc + c >= rank:
            return lo + (b - lo) * (rank - acc) / c
        acc += c
        lo = b
    return float(le[-1]) if le else None


def fraction_over(le: Sequence[float], counts: Sequence[float],
                  count: float, threshold: float) -> float:
    """Estimated fraction of observations ABOVE `threshold` — the error
    fraction of a latency SLO. Observations in the bucket containing the
    threshold are split by linear interpolation."""
    if count <= 0:
        return 0.0
    under = 0.0
    lo = 0.0
    for b, c in zip(le, counts):
        if b <= threshold:
            under += c
        else:
            if lo < threshold:
                under += c * (threshold - lo) / (b - lo)
            break
        lo = b
    else:
        # threshold above the top finite bucket: only overflow is over
        pass
    return max(0.0, min(1.0, (count - under) / count))


# -- slots -------------------------------------------------------------------


class Slot:
    """One ring entry: the fold of registry diffs over [t0, t1)."""

    __slots__ = ("t0", "t1", "c", "g", "h")

    def __init__(self, t0: float, t1: float):
        self.t0 = t0
        self.t1 = t1
        self.c: Dict[str, float] = {}          # key -> delta
        self.g: Dict[str, List[float]] = {}    # key -> [last, min, max]
        # key -> [bucket_deltas, sum_delta, count_delta]
        self.h: Dict[str, List[Any]] = {}

    def merge(self, other: "Slot") -> None:
        """Fold a LATER slot in (the cascade merges in time order)."""
        self.t1 = other.t1
        for k, d in other.c.items():
            self.c[k] = self.c.get(k, 0.0) + d
        for k, env in other.g.items():
            mine = self.g.get(k)
            if mine is None:
                self.g[k] = list(env)
            else:
                mine[0] = env[0]
                mine[1] = min(mine[1], env[1])
                mine[2] = max(mine[2], env[2])
        for k, (buckets, s, n) in other.h.items():
            mine = self.h.get(k)
            if mine is None:
                self.h[k] = [list(buckets), s, n]
            elif len(mine[0]) == len(buckets):
                mine[0] = [a + b for a, b in zip(mine[0], buckets)]
                mine[1] += s
                mine[2] += n

    def to_row(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {"t0": round(self.t0, 3),
                               "t1": round(self.t1, 3)}
        if self.c:
            row["c"] = {k: v for k, v in self.c.items() if v}
        if self.g:
            row["g"] = self.g
        if self.h:
            row["h"] = {k: {"d": v[0], "s": v[1], "n": v[2]}
                        for k, v in self.h.items() if v[2]}
        return row

    @classmethod
    def from_row(cls, row: Dict[str, Any]) -> "Slot":
        s = cls(float(row.get("t0", 0.0)), float(row.get("t1", 0.0)))
        s.c = {k: float(v) for k, v in (row.get("c") or {}).items()}
        s.g = {k: list(v) for k, v in (row.get("g") or {}).items()}
        s.h = {k: [list(v["d"]), float(v["s"]), float(v["n"])]
               for k, v in (row.get("h") or {}).items()}
        return s


# -- config ------------------------------------------------------------------


@dataclass
class HistoryConfig:
    """Knobs for the sampler + cascade + persistence.

    rings: ((resolution_s, capacity), ...) finest first; every resolution
    must be an integer multiple of sample_interval_s, and each coarser
    ring's resolution an integer multiple of the previous — the cascade
    folds exact groups, never fractional slots.
    """
    sample_interval_s: float = 1.0
    rings: Tuple[Tuple[float, int], ...] = ((1.0, 600), (10.0, 720),
                                            (60.0, 1440))
    persist_dir: Optional[str] = None
    shard_max_bytes: int = 4 * 1024 * 1024
    shard_max_files: int = 8

    def __post_init__(self):
        if self.sample_interval_s <= 0:
            raise ValueError("history: sample_interval_s must be > 0")
        if not self.rings:
            raise ValueError("history: need at least one ring")
        prev = self.sample_interval_s
        for res, cap in self.rings:
            if cap <= 0:
                raise ValueError("history: ring capacity must be > 0")
            ratio = res / prev
            if res < prev or abs(ratio - round(ratio)) > 1e-9:
                raise ValueError(
                    f"history: ring resolution {res}s is not an integer "
                    f"multiple of the previous step {prev}s")
            prev = res
        if self.shard_max_bytes <= 0 or self.shard_max_files <= 0:
            raise ValueError("history: shard bounds must be > 0")


class _Ring:
    __slots__ = ("res_s", "slots", "acc", "acc_n", "factor")

    def __init__(self, res_s: float, cap: int, factor: int):
        self.res_s = res_s
        self.slots: deque = deque(maxlen=cap)
        self.acc: Optional[Slot] = None  # partial coarse slot being built
        self.acc_n = 0
        self.factor = factor             # base samples per slot


# -- the history -------------------------------------------------------------


class MetricsHistory:
    """Sampler + multi-resolution rings + shard writer over one registry."""

    def __init__(self, registry: MetricsRegistry,
                 cfg: Optional[HistoryConfig] = None,
                 logger: Optional[Any] = None):
        self.registry = registry
        self.cfg = cfg or HistoryConfig()
        self.logger = logger
        self._lock = threading.Lock()
        self._prev: Optional[Dict[str, Dict[str, Any]]] = None
        self._prev_t: Optional[float] = None
        # family metadata keyed by metric NAME (kind + bucket bounds),
        # refreshed every sample so queries/readers can interpret keys
        self.families: Dict[str, Dict[str, Any]] = {}
        self.rings: List[_Ring] = []
        prev_res = self.cfg.sample_interval_s
        factor = 1
        for res, cap in self.cfg.rings:
            factor *= int(round(res / prev_res))
            self.rings.append(_Ring(res, cap, factor))
            prev_res = res
        self.samples_total = 0
        self._listeners: List[Callable[["MetricsHistory", float], None]] = []
        # persistence
        self._families_dirty = False
        self._shard_f = None
        self._shard_seq = 0
        self._shard_bytes = 0
        if self.cfg.persist_dir:
            os.makedirs(self.cfg.persist_dir, exist_ok=True)
            self._open_shard()
        # sampler thread (started explicitly; tests drive sample_now)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MetricsHistory":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="obs-history", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        with self._lock:
            f = self._shard_f
            self._shard_f = None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass

    def _run(self) -> None:
        # drift-free cadence: sleep to the NEXT multiple of the interval,
        # not interval-after-wake, so ring slot spans stay honest
        interval = self.cfg.sample_interval_s
        next_t = time.monotonic() + interval
        while not self._stop.wait(max(0.0, next_t - time.monotonic())):
            next_t += interval
            try:
                self.sample_now()
            except Exception as e:  # sampler must never die silently
                if self.logger is not None:
                    try:
                        self.logger.log(f"history: sample failed: {e!r}")
                    except Exception:
                        pass

    def add_listener(self,
                     fn: Callable[["MetricsHistory", float], None]) -> None:
        """Called after every base sample with (history, sample_time) —
        the alerter's evaluation hook. Runs on the sampler thread,
        OUTSIDE the history lock (listeners query back into us)."""
        self._listeners.append(fn)

    # -- sampling ------------------------------------------------------------

    def sample_now(self, now: Optional[float] = None) -> Slot:
        """Take one sample: snapshot the registry, diff against the
        previous snapshot, fold into the rings, append the shard row.
        `now` is injectable so tests drive a deterministic clock."""
        t = time.time() if now is None else float(now)
        snap = self.registry.snapshot()  # registry's own lock
        with self._lock:
            slot = self._diff_locked(snap, t)
            self._fold_locked(slot)
            self._persist_locked(slot)
            self.samples_total += 1
        for fn in list(self._listeners):
            try:
                fn(self, t)
            except Exception as e:
                if self.logger is not None:
                    try:
                        self.logger.log(f"history: listener failed: {e!r}")
                    except Exception:
                        pass
        return slot

    def _diff_locked(self, snap: Dict[str, Dict[str, Any]],
                     t: float) -> Slot:
        prev = self._prev
        t0 = self._prev_t if self._prev_t is not None \
            else t - self.cfg.sample_interval_s
        slot = Slot(t0, t)
        for name, fam in snap.items():
            if name not in self.families:
                # a family registered after the shard opened: readers
                # need its kind/buckets too -> refresh the meta row
                self._families_dirty = True
            self.families[name] = {"kind": fam["kind"],
                                   "labels": list(fam["labels"]),
                                   "le": list(fam.get("le") or ())}
            pfam = (prev or {}).get(name, {})
            pvals = pfam.get("values", {})
            for lkey, v in fam["values"].items():
                key = series_key(name, fam["labels"], lkey)
                if fam["kind"] == "histogram":
                    pv = pvals.get(lkey)
                    if pv is None:
                        continue  # first sight = baseline, no delta
                    d = [max(0.0, a - b)
                         for a, b in zip(v["buckets"], pv["buckets"])]
                    dn = max(0.0, v["count"] - pv["count"])
                    if dn:
                        slot.h[key] = [d, max(0.0, v["sum"] - pv["sum"]), dn]
                elif fam["kind"] == "counter":
                    pv = pvals.get(lkey)
                    if pv is None:
                        continue
                    # reset (restart / re-registration) clamps to zero
                    slot.c[key] = max(0.0, float(v) - float(pv))
                else:  # gauge: envelope starts degenerate at the sample
                    fv = float(v)
                    slot.g[key] = [fv, fv, fv]
        self._prev = snap
        self._prev_t = t
        return slot

    def _fold_locked(self, slot: Slot) -> None:
        for i, ring in enumerate(self.rings):
            if i == 0 and ring.factor == 1:
                ring.slots.append(slot)
                continue
            if ring.acc is None:
                ring.acc = Slot(slot.t0, slot.t1)
                ring.acc.merge(slot)
                ring.acc_n = 1
            else:
                ring.acc.merge(slot)
                ring.acc_n += 1
            if ring.acc_n >= ring.factor:
                ring.slots.append(ring.acc)
                ring.acc = None
                ring.acc_n = 0

    # -- persistence ---------------------------------------------------------

    def _shard_path(self, seq: int) -> str:
        return os.path.join(self.cfg.persist_dir,  # type: ignore[arg-type]
                            f"history-{seq:06d}.jsonl")

    def _open_shard(self) -> None:
        existing = sorted(
            f for f in os.listdir(self.cfg.persist_dir)
            if f.startswith("history-") and f.endswith(".jsonl"))
        if existing:
            self._shard_seq = int(existing[-1].split("-")[1].split(".")[0]) + 1
        self._shard_f = open(self._shard_path(self._shard_seq), "a",
                             encoding="utf-8")
        self._shard_bytes = 0
        self._write_meta_row()
        self._prune_shards(existing)

    def _write_meta_row(self) -> None:
        # each shard self-describes: readers need bucket bounds + kinds
        # without the originating process
        row = json.dumps({"meta": self.families,
                          "interval_s": self.cfg.sample_interval_s})
        self._shard_f.write(row + "\n")
        self._shard_bytes += len(row) + 1
        self._families_dirty = False

    def _prune_shards(self, existing: List[str]) -> None:
        keep = self.cfg.shard_max_files - 1  # room for the live shard
        for f in existing[:max(0, len(existing) - keep)]:
            try:
                os.unlink(os.path.join(self.cfg.persist_dir, f))
            except OSError:
                pass

    def _persist_locked(self, slot: Slot) -> None:
        if self._shard_f is None:
            return
        try:
            if self._families_dirty:
                self._write_meta_row()
            line = json.dumps(slot.to_row())
            self._shard_f.write(line + "\n")
            self._shard_f.flush()
            self._shard_bytes += len(line) + 1
            if self._shard_bytes >= self.cfg.shard_max_bytes:
                self._shard_f.close()
                self._shard_seq += 1
                self._shard_f = open(self._shard_path(self._shard_seq), "a",
                                     encoding="utf-8")
                self._shard_bytes = 0
                self._write_meta_row()
                self._prune_shards(sorted(
                    f for f in os.listdir(self.cfg.persist_dir)
                    if f.startswith("history-") and f.endswith(".jsonl"))[:-1])
        except OSError as e:
            # disk trouble must not kill sampling; drop persistence
            if self.logger is not None:
                try:
                    self.logger.log(f"history: shard write failed: {e!r}")
                except Exception:
                    pass
            try:
                self._shard_f.close()
            except OSError:
                pass
            self._shard_f = None

    # -- queries -------------------------------------------------------------

    def _ring_for(self, window_s: float) -> _Ring:
        """Finest ring whose RETAINED span covers the window (data that
        aged out of ring 0 is still answerable from the coarser rings)."""
        for ring in self.rings:
            if ring.res_s * ring.slots.maxlen >= window_s:
                return ring
        return self.rings[-1]

    def _slots_in(self, window_s: float,
                  now: Optional[float] = None) -> Tuple[_Ring, List[Slot]]:
        ring = self._ring_for(window_s)
        with self._lock:
            slots = list(ring.slots)
            if ring.acc is not None:
                # include a COPY of the partial coarse slot (freshness
                # beats slot alignment); the original keeps mutating
                # under the sampler, so readers must not share it
                snap = Slot(ring.acc.t0, ring.acc.t1)
                snap.merge(ring.acc)
                slots.append(snap)
            t_now = now
            if t_now is None:
                t_now = slots[-1].t1 if slots else time.time()
            lo = t_now - window_s
            return ring, [s for s in slots if s.t1 > lo and s.t0 < t_now]

    def window(self, name: str, window_s: float,
               labels: Optional[Dict[str, str]] = None,
               now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """Windowed aggregate per matching series key.

        counters   -> {"delta", "rate"}
        gauges     -> {"last", "min", "max"}
        histograms -> {"count", "sum", "buckets", "le"} (merged deltas)
        """
        fam = self.families.get(name)
        ring, slots = self._slots_in(window_s, now)
        out: Dict[str, Dict[str, Any]] = {}
        if fam is None:
            return out
        span = sum(max(0.0, s.t1 - s.t0) for s in slots) or window_s
        for s in slots:
            src = {"counter": s.c, "gauge": s.g,
                   "histogram": s.h}[fam["kind"]]
            for key, v in src.items():
                kname, klabels = split_key(key)
                if kname != name:
                    continue
                if labels and any(klabels.get(k) != str(lv)
                                  for k, lv in labels.items()):
                    continue
                cur = out.get(key)
                if fam["kind"] == "counter":
                    if cur is None:
                        out[key] = {"delta": v}
                    else:
                        cur["delta"] += v
                elif fam["kind"] == "gauge":
                    if cur is None:
                        out[key] = {"last": v[0], "min": v[1], "max": v[2]}
                    else:
                        cur["last"] = v[0]
                        cur["min"] = min(cur["min"], v[1])
                        cur["max"] = max(cur["max"], v[2])
                else:
                    if cur is None:
                        out[key] = {"count": v[2], "sum": v[1],
                                    "buckets": list(v[0]),
                                    "le": fam["le"]}
                    else:
                        cur["count"] += v[2]
                        cur["sum"] += v[1]
                        cur["buckets"] = [a + b for a, b in
                                          zip(cur["buckets"], v[0])]
        for key, agg in out.items():
            if "delta" in agg:
                agg["rate"] = agg["delta"] / span if span > 0 else 0.0
        return out

    def windowed_quantile(self, name: str, q: float, window_s: float,
                          labels: Optional[Dict[str, str]] = None,
                          now: Optional[float] = None) -> Optional[float]:
        """Quantile estimate over the merged histogram window (all
        matching children folded together). None without observations."""
        agg = self.window(name, window_s, labels=labels, now=now)
        if not agg:
            return None
        le: Sequence[float] = ()
        buckets: List[float] = []
        count = 0.0
        for v in agg.values():
            if "le" not in v:
                return None
            le = v["le"]
            if not buckets:
                buckets = list(v["buckets"])
            else:
                buckets = [a + b for a, b in zip(buckets, v["buckets"])]
            count += v["count"]
        return quantile_from_buckets(le, buckets, count, q)

    def points(self, name: str, window_s: float,
               labels: Optional[Dict[str, str]] = None,
               now: Optional[float] = None) -> Dict[str, List[List[float]]]:
        """Per-slot series for plotting: counter -> rate, gauge -> last,
        histogram -> count delta. Each point is [t1, value]."""
        fam = self.families.get(name)
        if fam is None:
            return {}
        ring, slots = self._slots_in(window_s, now)
        out: Dict[str, List[List[float]]] = {}
        for s in slots:
            src = {"counter": s.c, "gauge": s.g,
                   "histogram": s.h}[fam["kind"]]
            dt = max(s.t1 - s.t0, 1e-9)
            for key, v in src.items():
                kname, klabels = split_key(key)
                if kname != name:
                    continue
                if labels and any(klabels.get(k) != str(lv)
                                  for k, lv in labels.items()):
                    continue
                if fam["kind"] == "counter":
                    val = v / dt
                elif fam["kind"] == "gauge":
                    val = v[0]
                else:
                    val = v[2]
                out.setdefault(key, []).append([round(s.t1, 3), val])
        return out

    # -- HTTP ----------------------------------------------------------------

    def timeseries_route(self, path: str) -> Dict[str, Any]:
        """GET /timeseries?name=<metric>[&window=<s>][&q=<quantile>]
        [&<label>=<value>...] — windowed aggregate + per-slot points.
        Without ?name= lists the known families (discovery)."""
        qs = parse_qs(urlparse(path).query)
        name = (qs.get("name") or [None])[0]
        if not name:
            return {"families": {n: f["kind"]
                                 for n, f in sorted(self.families.items())},
                    "rings": [{"res_s": r.res_s, "slots": len(r.slots),
                               "cap": r.slots.maxlen} for r in self.rings],
                    "samples_total": self.samples_total}
        if name not in self.families:
            raise ValueError(f"unknown metric {name!r}")
        try:
            window_s = float((qs.get("window") or ["300"])[0])
            quant = float((qs.get("q") or ["0.99"])[0])
        except ValueError:
            raise ValueError("window and q must be numbers")
        labels = {k: v[0] for k, v in qs.items()
                  if k not in ("name", "window", "q")}
        fam = self.families[name]
        ring, _ = self._slots_in(window_s)
        body: Dict[str, Any] = {
            "name": name, "kind": fam["kind"], "window_s": window_s,
            "res_s": ring.res_s,
            "agg": self.window(name, window_s, labels=labels or None),
            "points": self.points(name, window_s, labels=labels or None),
        }
        if fam["kind"] == "histogram":
            body["quantile"] = {
                "q": quant,
                "value": self.windowed_quantile(name, quant, window_s,
                                                labels=labels or None)}
        return body

    def attach_http(self, server: Any) -> None:
        """Add /timeseries to a StatusServer (train, serve, router)."""
        server.add_route("/timeseries", self.timeseries_route)


# -- offline shard reader ----------------------------------------------------


def read_history_shards(persist_dir: str
                        ) -> Tuple[Dict[str, Dict[str, Any]], List[Slot]]:
    """Read every `history-*.jsonl` shard in order -> (families, slots).
    Tolerates a torn final line (the process may have died mid-write)."""
    families: Dict[str, Dict[str, Any]] = {}
    slots: List[Slot] = []
    try:
        names = sorted(f for f in os.listdir(persist_dir)
                       if f.startswith("history-") and f.endswith(".jsonl"))
    except OSError:
        return families, slots
    for fname in names:
        try:
            with open(os.path.join(persist_dir, fname), encoding="utf-8") \
                    as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        row = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail
                    if "meta" in row:
                        families.update(row["meta"])
                    else:
                        slots.append(Slot.from_row(row))
        except OSError:
            continue
    slots.sort(key=lambda s: s.t1)
    return families, slots


def merge_slots(slots: Iterable[Slot]) -> Optional[Slot]:
    """Fold a time-ordered slot sequence into one (offline reports)."""
    merged: Optional[Slot] = None
    for s in slots:
        if merged is None:
            merged = Slot(s.t0, s.t1)
        merged.merge(s)
    return merged
