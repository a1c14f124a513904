"""Pod-scope observability: cross-worker aggregation + straggler attribution.

A copy of `sparknet_tpu/obs/pod.py` (pure Python): the port imports
nothing of the JAX package. A "worker" here is a machine: the JAX
package's process, the port's local rank 0 of each machine, which serves
the machine's /metrics and writes its heartbeat under `pod_dir`.

Per-process telemetry alone leaves "which machine is slow" to parsing N
logs. SparkNet's premise (arXiv:1511.06051) is that τ-interval averaging
tolerates slow workers; this module makes slow workers visible:

  - `PodAggregator` merges every worker's telemetry into one pod-level
    view, from either or both of two sources:
      * **http mode** — scrape each worker's `StatusServer`
        (`/metrics` + `/status`, `RunConfig.status_port`);
      * **file mode** — read per-worker heartbeat files from a shared
        `pod_dir` prefix (local/NFS path or `gs://`/`s3://` bucket —
        `utils/heartbeat.py` writes them), which needs no cross-host
        network reachability at all.
  - The merged Prometheus exposition re-exports every worker family with
    a `worker` label plus pod aggregates: counters get a
    `worker="pod"` sum, gauges get `worker="max"` / `worker="min"`,
    histograms a pod-summed `worker="pod"` child.
  - **Straggler attribution**: per-worker round wall time and data-wait
    time (the train loop's `sparknet_train_round_seconds` /
    `sparknet_train_data_wait_seconds` and heartbeat `round_s` /
    `data_wait_s`) feed a median+MAD rule (`utils.health.mad_classify`).
    The aggregator exports `sparknet_pod_round_skew_seconds` (max −
    median) and `sparknet_pod_straggler_rounds_total{worker}`
    (deduplicated per reported round), and `/pod/status` names the sick
    worker in JSON. With exactly two workers the MAD is degenerate, so a
    ratio rule applies instead: the slower worker is flagged when it
    exceeds `two_worker_ratio` × the faster.

`python -m sparknet_tpu_torch.obs.pod` is the console: live table / JSON /
merged exposition over `--workers URL...` or `--pod-dir PREFIX`, `--serve
PORT` to run the aggregation endpoint (global rank 0 runs the same thing
via `RunConfig.pod_port`), and `--selfcheck` for CI.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import threading
import time
import urllib.request
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..utils.health import _median, liveness_classify, mad_classify
from ..utils.heartbeat import read_heartbeat, staleness_s, worker_sort_key
from .http import StatusServer
from .registry import MetricsRegistry, _escape_label, _fmt

# ---------------------------------------------------------------------------
# Prometheus text exposition: parse / merge / render
# ---------------------------------------------------------------------------

#: sample line: name{labels} value  (the format registry.render_prometheus
#: emits; timestamps are not produced by our exporter and not accepted)
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            n = s[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(n, "\\" + n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


LabelKey = Tuple[Tuple[str, str], ...]  # sorted (name, value) pairs


class Family:
    """One parsed/merged metric family. Scalar kinds keep `samples`
    (label-key -> value); histograms keep `hists` (label-key ->
    {"le": {le_str: cumulative_count}, "sum": ..., "count": ...})."""

    __slots__ = ("kind", "help", "samples", "hists")

    def __init__(self, kind: str, help_text: str = ""):
        self.kind = kind
        self.help = help_text
        self.samples: Dict[LabelKey, float] = {}
        self.hists: Dict[LabelKey, Dict[str, Any]] = {}


def parse_exposition(text: str) -> Dict[str, Family]:
    """Parse a Prometheus text exposition (version 0.0.4) into families.
    Tolerant by design — an unparseable line is skipped, a sample without
    a TYPE becomes an untyped gauge — because a pod scrape must degrade,
    never fail, when one worker runs a different code rev."""
    fams: Dict[str, Family] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                fam = fams.get(parts[2])
                if fam is None:
                    fams[parts[2]] = Family(parts[3])
                elif fam.kind == "untyped":  # HELP (or a sample) came first
                    fam.kind = parts[3]
            elif len(parts) >= 3 and parts[1] == "HELP":
                name = parts[2]
                fams.setdefault(name, Family("untyped"))
                fams[name].help = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, raw_labels, raw_v = m.groups()
        try:
            value = float(raw_v)
        except ValueError:
            continue
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(raw_labels or "")}
        # histogram series route to their base family
        base, part = name, None
        for suffix in ("_bucket", "_sum", "_count"):
            b = name[:-len(suffix)] if name.endswith(suffix) else None
            if b and b in fams and fams[b].kind == "histogram":
                base, part = b, suffix
                break
        fam = fams.setdefault(base, Family("untyped"))
        if fam.kind == "histogram" and part is not None:
            le = labels.pop("le", None)
            key = tuple(sorted(labels.items()))
            h = fam.hists.setdefault(key,
                                     {"le": {}, "sum": 0.0, "count": 0.0})
            if part == "_bucket" and le is not None:
                h["le"][le] = value
            elif part == "_sum":
                h["sum"] = value
            elif part == "_count":
                h["count"] = value
        else:
            fam.samples[tuple(sorted(labels.items()))] = value
    return fams


def _with_worker(key: LabelKey, worker: str) -> LabelKey:
    """Add the worker label to a label key. A family that already carries
    a `worker` label keeps it as `src_worker` — the pod dimension wins
    the canonical name."""
    pairs = [(("src_worker", v) if k == "worker" else (k, v))
             for k, v in key]
    return tuple(sorted(pairs + [("worker", str(worker))]))


def merge_expositions(per_worker: Dict[str, Dict[str, Family]]
                      ) -> Dict[str, Family]:
    """Merge N workers' parsed expositions into one set of pod families:
    every scalar child re-exported per worker plus aggregates — counter
    `worker="pod"` sums, gauge `worker="max"`/`worker="min"` envelopes,
    histogram `worker="pod"` sums (cumulative bucket counts add
    exactly). A family whose kind differs across workers keeps the
    first-seen kind and skips the disagreeing workers (mixed code revs
    must degrade a family, not the scrape)."""
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    scalars: Dict[str, Dict[LabelKey, Dict[str, float]]] = {}
    hists: Dict[str, Dict[LabelKey, Dict[str, Dict[str, Any]]]] = {}
    for worker in sorted(per_worker):
        for name, fam in per_worker[worker].items():
            if name not in kinds:
                kinds[name] = fam.kind
                helps[name] = fam.help
            elif kinds[name] != fam.kind:
                continue
            if fam.kind == "histogram":
                for key, h in fam.hists.items():
                    hists.setdefault(name, {}).setdefault(
                        key, {})[worker] = h
            else:
                for key, v in fam.samples.items():
                    scalars.setdefault(name, {}).setdefault(
                        key, {})[worker] = v
    out: Dict[str, Family] = {}
    for name, kind in kinds.items():
        fam = Family(kind, helps[name])
        for key, by_w in hists.get(name, {}).items():
            le: Dict[str, float] = {}
            total_sum = total_count = 0.0
            for h in by_w.values():
                for l_, n_ in h["le"].items():
                    le[l_] = le.get(l_, 0.0) + n_
                total_sum += h["sum"]
                total_count += h["count"]
            fam.hists[_with_worker(key, "pod")] = {
                "le": le, "sum": total_sum, "count": total_count}
        for key, by_w in scalars.get(name, {}).items():
            for worker, v in by_w.items():
                fam.samples[_with_worker(key, worker)] = v
            vals = list(by_w.values())
            if kind == "counter":
                fam.samples[_with_worker(key, "pod")] = sum(vals)
            else:
                fam.samples[_with_worker(key, "max")] = max(vals)
                fam.samples[_with_worker(key, "min")] = min(vals)
        out[name] = fam
    return out


def render_exposition(fams: Dict[str, Family]) -> str:
    """Render families back to deterministic Prometheus text (same sorted
    layout as `MetricsRegistry.render_prometheus`)."""
    lines: List[str] = []
    for name in sorted(fams):
        fam = fams[name]
        if fam.help:
            lines.append(f"# HELP {name} {fam.help}")
        lines.append(f"# TYPE {name} {fam.kind}")
        for key in sorted(fam.hists):
            h = fam.hists[key]
            pairs = [f'{k}="{_escape_label(v)}"' for k, v in key]
            finite = sorted((l for l in h["le"] if l != "+Inf"), key=float)
            for l_ in finite:
                lb = "{" + ",".join(pairs + [f'le="{l_}"']) + "}"
                lines.append(f"{name}_bucket{lb} {_fmt(h['le'][l_])}")
            lb = "{" + ",".join(pairs + ['le="+Inf"']) + "}"
            lines.append(
                f"{name}_bucket{lb} {_fmt(h['le'].get('+Inf', h['count']))}")
            suffix = "{" + ",".join(pairs) + "}" if pairs else ""
            lines.append(f"{name}_sum{suffix} {_fmt(h['sum'])}")
            lines.append(f"{name}_count{suffix} {_fmt(h['count'])}")
        for key in sorted(fam.samples):
            pairs = [f'{k}="{_escape_label(v)}"' for k, v in key]
            suffix = "{" + ",".join(pairs) + "}" if pairs else ""
            lines.append(f"{name}{suffix} {_fmt(fam.samples[key])}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# straggler attribution
# ---------------------------------------------------------------------------

def flag_stragglers(by_worker: Dict[str, float], thresh_sigma: float = 4.0,
                    rel_floor: float = 0.25, two_worker_ratio: float = 2.0
                    ) -> Tuple[float, float, Set[str]]:
    """(median, skew, flagged workers) over one cross-section of per-worker
    durations. Skew is max − median (the MegaScale-style "how much wall
    clock the slowest worker costs every round" number — with τ-interval
    averaging every other worker waits exactly this long at the sync
    point). Flags come from `utils.health.mad_classify`; with exactly two
    samples the MAD is degenerate, so the slower worker is flagged when
    it exceeds `two_worker_ratio` × the faster instead."""
    items = sorted(by_worker.items())
    vals = [v for _, v in items]
    if len(vals) < 2:
        return (vals[0] if vals else 0.0), 0.0, set()
    med, _, flags = mad_classify(vals, thresh_sigma=thresh_sigma,
                                 rel_floor=rel_floor)
    flagged = {w for (w, _), f in zip(items, flags) if f}
    if len(vals) == 2 and not flagged:
        lo, hi = sorted(vals)
        if lo > 0 and hi > two_worker_ratio * lo:
            flagged = {w for w, v in items if v == hi}
    return med, max(vals) - med, flagged


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------

@dataclass
class WorkerView:
    """One worker's latest telemetry as the aggregator saw it."""

    worker: str
    alive: bool = False
    error: Optional[str] = None
    role: str = "train"
    round: Optional[int] = None
    status: Optional[str] = None
    loss: Optional[float] = None
    round_s: Optional[float] = None
    data_wait_s: Optional[float] = None
    staleness_s: Optional[float] = None
    rollbacks: int = 0
    straggler: bool = False
    #: elastic membership epoch the worker's loop last reported (None
    #: when the run is not elastic / pre-elastic heartbeat schema)
    membership_epoch: Optional[int] = None
    #: serve role: per-model vitals rows ({model: {step, queue_depth,
    #: p99_ms, ...}} — InferenceServer.model_row schema) from the
    #: worker's /status or heartbeat, so multi-model straggler
    #: attribution works per model, not just per process
    models: Optional[Dict[str, Any]] = None
    #: parsed /metrics families (http mode only; file mode has heartbeats)
    metrics: Optional[Dict[str, Family]] = field(default=None, repr=False)

    def as_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in (
            "worker", "alive", "role", "round", "status", "loss",
            "round_s", "data_wait_s", "staleness_s", "rollbacks",
            "straggler")}
        if self.membership_epoch is not None:
            d["membership_epoch"] = self.membership_epoch
        if self.models is not None:
            d["models"] = self.models
        if self.error:
            d["error"] = self.error
        return d


def worker_heartbeat_path(pod_dir: str, index: int) -> str:
    """The per-worker heartbeat path convention under a pod prefix."""
    name = f"worker-{int(index):03d}.heartbeat.json"
    if pod_dir.startswith(("gs://", "s3://")):
        return f"{pod_dir.rstrip('/')}/{name}"
    return os.path.join(pod_dir, name)


_HB_NAME_RE = re.compile(r"worker-0*(\d+)\.heartbeat\.json$")


def discover_worker_heartbeats(pod_dir: str) -> Dict[str, str]:
    """{worker id: heartbeat path} for every worker-*.heartbeat.json
    under the prefix (local dir or gs://|s3:// bucket). Missing prefix ->
    empty dict (the pod may not have beaten yet)."""
    paths: List[str] = []
    try:
        if pod_dir.startswith(("gs://", "s3://")):
            from ..utils.checkpoint import _bucket_ops
            paths = list(_bucket_ops(pod_dir).list_urls(
                pod_dir.rstrip("/") + "/"))
        else:
            paths = [os.path.join(pod_dir, n)
                     for n in sorted(os.listdir(pod_dir))]
    except Exception:
        return {}
    out: Dict[str, str] = {}
    for p in paths:
        m = _HB_NAME_RE.search(p)
        if m:
            out[str(int(m.group(1)))] = p
    return out


class PodAggregator:
    """Merges N workers' telemetry into one pod view (module docstring).

    `workers` maps worker id -> StatusServer base URL (http mode);
    `pod_dir` points file mode at the per-worker heartbeat prefix. Both
    may be given; file views fill in workers http mode cannot reach.
    `collect()` is cached for `min_refresh_s` so the three HTTP handlers
    (merged /metrics, /pod/status, /healthz) cannot turn one dashboard
    into N× scrape amplification."""

    def __init__(self, workers: Optional[Dict[str, str]] = None,
                 pod_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 thresh_sigma: float = 4.0, rel_floor: float = 0.25,
                 two_worker_ratio: float = 2.0,
                 stale_after_s: float = 120.0,
                 min_refresh_s: float = 1.0, timeout_s: float = 5.0):
        if not workers and not pod_dir:
            raise ValueError("PodAggregator needs workers URLs and/or a "
                             "pod_dir heartbeat prefix")
        self.workers = {str(k): v for k, v in (workers or {}).items()}
        self.pod_dir = pod_dir
        self.thresh_sigma = thresh_sigma
        self.rel_floor = rel_floor
        self.two_worker_ratio = two_worker_ratio
        self.stale_after_s = stale_after_s
        self.min_refresh_s = min_refresh_s
        self.timeout_s = timeout_s
        self.registry = registry or MetricsRegistry()
        r = self.registry
        self._g_workers = r.gauge("sparknet_pod_workers",
                                  "workers known to the aggregator")
        self._g_alive = r.gauge("sparknet_pod_workers_alive",
                                "workers with fresh, readable telemetry")
        self._g_skew = r.gauge(
            "sparknet_pod_round_skew_seconds",
            "per-round wall-time skew across workers (max - median)")
        self._g_wait_skew = r.gauge(
            "sparknet_pod_data_wait_skew_seconds",
            "data-wait skew across workers (max - median)")
        self._g_round = r.gauge("sparknet_pod_round",
                                "round envelope across workers",
                                labels=("agg",))
        self._c_straggler = r.counter(
            "sparknet_pod_straggler_rounds_total",
            "rounds a worker was flagged slow (median+MAD over per-worker "
            "round wall time; deduplicated per reported round)",
            labels=("worker",))
        self._c_collects = r.counter("sparknet_pod_collects_total",
                                     "aggregation sweeps")
        self._g_w_round_s = r.gauge(
            "sparknet_pod_worker_round_seconds",
            "last reported round wall time per worker", labels=("worker",))
        self._g_w_wait_s = r.gauge(
            "sparknet_pod_worker_data_wait_seconds",
            "last reported data wait per worker", labels=("worker",))
        self._g_w_up = r.gauge(
            "sparknet_pod_worker_up",
            "1 = fresh telemetry, 0 = unreachable or stale",
            labels=("worker",))
        self._lock = threading.Lock()
        self._cached: Tuple[float, List[WorkerView]] = (0.0, [])
        #: every file-mode worker EVER discovered on the prefix: a worker
        #: whose heartbeat object vanishes between scrapes (deleted by an
        #: operator, lost with its VM's disk) must be surfaced as
        #: worker_up=0 / candidate-dead, not silently dropped from the
        #: pod view and the straggler population (mid-run membership
        #: change would otherwise be invisible exactly when it matters)
        self._known_files: Dict[str, str] = {}
        self._last_flag_round: Dict[str, Any] = {}
        self._straggler_log: deque = deque(maxlen=256)
        self.server: Optional[StatusServer] = None

    # -- collection ----------------------------------------------------------

    def _fetch(self, url: str) -> bytes:
        return urllib.request.urlopen(url, timeout=self.timeout_s).read()

    def _collect_http(self, worker: str, base: str) -> WorkerView:
        v = WorkerView(worker=worker)
        base = base.rstrip("/")
        try:
            v.metrics = parse_exposition(
                self._fetch(base + "/metrics").decode())
            st = json.loads(self._fetch(base + "/status"))
        except Exception as e:
            v.error = f"{type(e).__name__}: {e}"
            return v
        v.alive = True
        # freshness comes from the WORKER LOOP's own beat_ts stamp, not
        # from the scrape succeeding: a hung round loop whose HTTP daemon
        # thread still answers must read as stale, not alive-and-fresh.
        # Payloads without the stamp (serve role, older revs) stay 0.0.
        bts = st.get("beat_ts")
        v.staleness_s = (max(0.0, time.time() - float(bts))
                         if bts is not None else 0.0)
        if v.staleness_s > self.stale_after_s:
            v.alive = False
            v.error = f"stale ({v.staleness_s:.0f}s since last flush)"
        v.role = st.get("role", "train")
        v.round = st.get("round", st.get("model_step"))
        if isinstance(st.get("models"), dict):
            v.models = st["models"]
        v.status = st.get("status")
        v.loss = st.get("loss")
        v.round_s = st.get("round_s")
        v.data_wait_s = st.get("data_wait_s")
        v.rollbacks = int(st.get("rollbacks") or 0)
        if v.round_s is None and v.metrics:
            fam = v.metrics.get("sparknet_train_round_seconds")
            if fam and fam.samples:
                v.round_s = next(iter(fam.samples.values()))
        if v.data_wait_s is None and v.metrics:
            fam = v.metrics.get("sparknet_train_data_wait_seconds")
            if fam and fam.samples:
                v.data_wait_s = next(iter(fam.samples.values()))
        return v

    def _collect_file(self, worker: str, path: str) -> WorkerView:
        v = WorkerView(worker=worker)
        hb = read_heartbeat(path)
        if hb is None:
            v.error = "heartbeat unreadable"
            return v
        v.staleness_s = staleness_s(hb)
        v.role = hb.get("role", "train")
        v.round = hb.get("step")
        v.status = hb.get("status")
        v.loss = hb.get("last_loss")
        v.round_s = hb.get("round_s")
        v.data_wait_s = hb.get("data_wait_s")
        v.rollbacks = int(hb.get("rollbacks") or 0)
        if hb.get("membership_epoch") is not None:
            v.membership_epoch = int(hb["membership_epoch"])
        if isinstance(hb.get("models"), dict):
            v.models = hb["models"]
        # dead-vs-slow through the SHARED rule (utils.health.
        # liveness_classify — the one the elastic controller evicts on):
        # slow is a straggler verdict, never a liveness one
        verdict = liveness_classify(hb, self.stale_after_s)
        if verdict == "done":
            # a graceful exit stays visible while its beat is fresh, then
            # ages out like any other silence; a done record WITHOUT a
            # timestamp can never age out, so it must not count as alive
            v.alive = (v.staleness_s is not None
                       and v.staleness_s <= self.stale_after_s)
        else:
            v.alive = verdict in ("ok", "sick")
        if not v.alive:
            v.error = (f"stale ({v.staleness_s:.0f}s since last beat)"
                       if v.staleness_s is not None
                       else "heartbeat carries no timestamp")
        return v

    def collect(self, force: bool = False) -> List[WorkerView]:
        """One aggregation sweep (cached `min_refresh_s`): fetch every
        worker, run straggler attribution, update the pod registry."""
        with self._lock:
            t_cache, views = self._cached
            if not force and views and \
                    time.monotonic() - t_cache < self.min_refresh_s:
                return views
            # fetch workers CONCURRENTLY: a blackholed host costs one
            # timeout_s, not N of them serialized — the aggregator must
            # stay responsive exactly when part of the pod is sick
            by_id: Dict[str, WorkerView] = {}
            file_targets = (discover_worker_heartbeats(self.pod_dir)
                            if self.pod_dir else {})
            # sticky membership: a previously-seen worker whose file is
            # gone still gets probed (the read fails -> candidate-dead
            # view) instead of vanishing from the population
            self._known_files.update(file_targets)
            file_targets = dict(self._known_files)
            n_jobs = len(self.workers) + len(file_targets)
            if n_jobs:
                with ThreadPoolExecutor(min(16, n_jobs)) as ex:
                    http_futs = {w: ex.submit(self._collect_http, w, b)
                                 for w, b in self.workers.items()}
                    file_futs = {w: ex.submit(self._collect_file, w, p)
                                 for w, p in file_targets.items()}
                    by_id = {w: f.result() for w, f in http_futs.items()}
                    for w, f in file_futs.items():
                        if w not in by_id or not by_id[w].alive:
                            by_id[w] = f.result()
            views = [by_id[w] for w in sorted(by_id, key=worker_sort_key)]
            self._attribute(views)
            self._cached = (time.monotonic(), views)
            self._c_collects.inc()
            return views

    def _attribute(self, views: List[WorkerView]) -> None:
        """Skew + straggler flags over this sweep; pod registry update."""
        self._g_workers.set(len(views))
        self._g_alive.set(sum(v.alive for v in views))
        rounds = [v.round for v in views if v.alive and v.round is not None]
        if rounds:
            self._g_round.set(max(rounds), agg="max")
            self._g_round.set(min(rounds), agg="min")
        for v in views:
            self._g_w_up.set(1.0 if v.alive else 0.0, worker=v.worker)
            if v.round_s is not None:
                self._g_w_round_s.set(v.round_s, worker=v.worker)
            if v.data_wait_s is not None:
                self._g_w_wait_s.set(v.data_wait_s, worker=v.worker)
        times = {v.worker: v.round_s for v in views
                 if v.alive and v.round_s}
        if len(times) >= 2:
            med, skew, flagged = flag_stragglers(
                times, thresh_sigma=self.thresh_sigma,
                rel_floor=self.rel_floor,
                two_worker_ratio=self.two_worker_ratio)
            self._g_skew.set(skew)
            for v in views:
                v.straggler = v.worker in flagged
                if not v.straggler:
                    continue
                # dedup per reported round: a 1 Hz scrape of a 30 s round
                # must count the straggler ONCE per round, not 30 times
                if self._last_flag_round.get(v.worker) == v.round:
                    continue
                self._last_flag_round[v.worker] = v.round
                self._c_straggler.inc(worker=v.worker)
                self._straggler_log.append({
                    "ts": round(time.time(), 3), "worker": v.worker,
                    "round": v.round, "round_s": v.round_s,
                    "median_s": round(med, 6)})
        waits = [v.data_wait_s for v in views
                 if v.alive and v.data_wait_s is not None]
        if len(waits) >= 2:
            self._g_wait_skew.set(max(waits) - _median(sorted(waits)))

    # -- outputs -------------------------------------------------------------

    def pod_status(self) -> Dict[str, Any]:
        """The /pod/status JSON: per-worker vitals + the attribution."""
        views = self.collect()
        rounds = [v.round for v in views if v.round is not None]
        epochs = [v.membership_epoch for v in views
                  if v.membership_epoch is not None]
        return {
            "role": "pod",
            "ts": round(time.time(), 3),
            "n_workers": len(views),
            "n_alive": sum(v.alive for v in views),
            "max_round": max(rounds) if rounds else None,
            "min_round": min(rounds) if rounds else None,
            "round_skew_s": self._g_skew.value(),
            # elastic runs: the newest membership epoch any worker
            # reported, plus the workers currently read as down — the
            # controller's eviction candidates, named before they're gone
            "membership_epoch": max(epochs) if epochs else None,
            "candidate_dead": [v.worker for v in views if not v.alive],
            "stragglers": [v.worker for v in views if v.straggler],
            "straggler_rounds": {
                v.worker: c for v in views
                if (c := self._c_straggler.value(worker=v.worker))},
            "workers": [v.as_dict() for v in views],
            "straggler_log": list(self._straggler_log)[-20:],
        }

    def render(self) -> str:
        """The merged pod exposition: every reachable worker's families
        (worker label + pod/max/min aggregates) followed by the
        aggregator's own sparknet_pod_* registry."""
        views = self.collect()
        per = {v.worker: v.metrics for v in views if v.metrics}
        merged = merge_expositions(per) if per else {}
        text = render_exposition(merged) if merged else ""
        return text + self.registry.render_prometheus()

    def healthz(self) -> Tuple[bool, Dict[str, Any]]:
        views = self.collect()
        alive = sum(v.alive for v in views)
        return alive > 0, {"workers": len(views), "alive": alive,
                           "stragglers": [v.worker for v in views
                                          if v.straggler]}

    def serve(self, port: int, host: str = "127.0.0.1") -> StatusServer:
        """Run the pod endpoint: merged /metrics, /pod/status (alias
        /status), /healthz. Returns the server (address on `.address`)."""
        self.server = StatusServer(
            port, registry=None, host=host, metrics_text=self.render,
            healthz=self.healthz, status=self.pod_status,
            routes={"/pod/status": self.pod_status})
        return self.server

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None


# ---------------------------------------------------------------------------
# console: sparknet-podview
# ---------------------------------------------------------------------------

def format_pod_table(status: Dict[str, Any]) -> str:
    """Human console rendering of a pod_status() dict."""
    lines = [
        f"pod: {status['n_alive']}/{status['n_workers']} workers alive"
        + (f"  rounds {status['min_round']}..{status['max_round']}"
           if status["max_round"] is not None else "")
        + (f"  round skew {status['round_skew_s'] * 1e3:.1f} ms"
           if status.get("round_skew_s") is not None else "")
        + (f"  STRAGGLERS: {', '.join(status['stragglers'])}"
           if status["stragglers"] else "")]
    hdr = (f"  {'worker':<8}{'round':>7}  {'status':<10}{'loss':>10}"
           f"{'round ms':>10}{'wait ms':>9}{'stale s':>9}  flags")
    lines.append(hdr)
    for w in status["workers"]:
        def _n(v, scale=1.0, fmt="{:.1f}"):
            return fmt.format(v * scale) if v is not None else "-"
        flags = []
        if w.get("straggler"):
            flags.append("STRAGGLER")
        if not w["alive"]:
            flags.append(w.get("error", "down"))
        if w.get("rollbacks"):
            flags.append(f"rollbacks={w['rollbacks']}")
        lines.append(
            f"  {w['worker']:<8}{w['round'] if w['round'] is not None else '-':>7}  "
            f"{(w['status'] or '-'):<10}"
            f"{_n(w['loss'], 1.0, '{:.4f}'):>10}"
            f"{_n(w['round_s'], 1e3):>10}"
            f"{_n(w['data_wait_s'], 1e3):>9}"
            f"{_n(w['staleness_s']):>9}  {' '.join(flags)}".rstrip())
        # serve role, multi-model: one sub-row per model so straggler
        # attribution reads per model, not just per process
        for name in sorted(w.get("models") or ()):
            m = w["models"][name] or {}
            parts = [f"model={name}"]
            # freshness (commit age of the serving step) and step lag
            # ride the heartbeat model rows — staleness per replica
            # WITHOUT a /metrics scrape
            for k, fmt in (("step", "step={}"), ("freshness_s",
                           "fresh={}s"), ("step_lag", "lag={}"),
                           ("queue_depth", "q={}"),
                           ("p99_ms", "p99={}ms"),
                           ("requests_ok", "ok={}"),
                           ("requests_shed", "shed={}"),
                           ("swaps", "swaps={}")):
                if m.get(k) is not None:
                    parts.append(fmt.format(m[k]))
            # the worst recent captured request (reqtrace exemplar):
            # duration, dominant stage, and the trace id prefix to feed
            # straight to `sparknet-trace`
            sr = m.get("slow_request")
            if isinstance(sr, dict) and sr.get("ms") is not None:
                parts.append(
                    f"slow={sr['ms']}ms@{sr.get('stage', '-')}"
                    f"[{str(sr.get('trace', ''))[:8]}]")
            # the SLO ledger's per-replica slice: error budget left and
            # any FIRING alert (model:objective:severity), so a burning
            # page is visible from the pod table without a /slo/status
            # round-trip per replica
            if m.get("slo_budget_remaining") is not None:
                parts.append(f"budget={m['slo_budget_remaining']}")
            if m.get("slo_firing"):
                parts.append("SLO:" + ",".join(m["slo_firing"]))
            lines.append(f"    └ {' '.join(parts)}")
    log = status.get("straggler_log") or []
    if log:
        lines.append("  straggler audit trail (last "
                     f"{len(log)}):")
        for e in log:
            lines.append(f"    round {e['round']}: worker {e['worker']} "
                         f"at {e['round_s'] * 1e3:.1f} ms vs median "
                         f"{e['median_s'] * 1e3:.1f} ms")
    return "\n".join(lines)


def _selfcheck() -> int:
    """Two in-process fake workers (worker 1 straggling 10x), aggregated
    over real HTTP: verifies counter pod-sums, gauge max/min labels, and
    straggler attribution end-to-end. CI's no-rot gate for the pod path."""
    regs = [MetricsRegistry(), MetricsRegistry()]
    servers = []
    vitals = [{"role": "train", "round": 10, "status": "ok", "loss": 1.0,
               "round_s": 0.1, "data_wait_s": 0.001, "rollbacks": 0},
              {"role": "train", "round": 9, "status": "ok", "loss": 1.1,
               "round_s": 1.0, "data_wait_s": 0.5, "rollbacks": 0}]
    try:
        for i, reg in enumerate(regs):
            reg.counter("sparknet_train_rounds_total").inc(10 - i)
            reg.gauge("sparknet_train_round_seconds").set(
                vitals[i]["round_s"])
            srv = StatusServer(0, reg,
                               status=(lambda v=vitals[i]: dict(v)))
            servers.append(srv)
        agg = PodAggregator(
            workers={str(i): f"http://{s.address[0]}:{s.address[1]}"
                     for i, s in enumerate(servers)},
            min_refresh_s=0.0)
        status = agg.pod_status()
        text = agg.render()
        ok = True

        def check(cond, what):
            nonlocal ok
            print(f"  {'ok' if cond else 'FAIL'}: {what}")
            ok = ok and cond

        check('sparknet_train_rounds_total{worker="pod"} 19' in text,
              "counter pod sum (10 + 9 = 19)")
        check('sparknet_train_round_seconds{worker="max"} 1' in text,
              "gauge worker=max")
        check('sparknet_train_round_seconds{worker="min"} 0.1' in text,
              "gauge worker=min")
        check(status["stragglers"] == ["1"],
              f"straggler attribution -> {status['stragglers']}")
        check("sparknet_pod_round_skew_seconds" in text,
              "pod skew gauge exported")
        # clean pod: equal round times -> zero stragglers
        vitals[1]["round_s"] = 0.1
        regs[1].gauge("sparknet_train_round_seconds").set(0.1)
        clean = PodAggregator(
            workers=dict(agg.workers), min_refresh_s=0.0).pod_status()
        check(clean["stragglers"] == [], "clean pod flags nothing")
        print(format_pod_table(status))
        return 0 if ok else 1
    finally:
        for s in servers:
            s.stop()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="sparknet-podview",
        description="Pod-scope telemetry: merge every worker's metrics/"
                    "heartbeats, attribute stragglers, serve or print "
                    "the pod view.")
    p.add_argument("--workers", nargs="+", metavar="URL", default=[],
                   help="worker StatusServer base URLs (http mode); "
                        "NAME=URL to pick worker ids, else 0..N-1 in "
                        "the given order")
    p.add_argument("--pod-dir", default=None,
                   help="shared per-worker heartbeat prefix (file mode; "
                        "local dir or gs://|s3:// bucket)")
    p.add_argument("--serve", type=int, metavar="PORT", default=None,
                   help="serve merged /metrics + /pod/status on PORT "
                        "(0 = ephemeral) and keep running")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind host for --serve (0.0.0.0 for cross-host)")
    p.add_argument("--watch", type=float, metavar="SECS", default=None,
                   help="refresh the console view every SECS")
    p.add_argument("--json", action="store_true",
                   help="print /pod/status JSON instead of the table")
    p.add_argument("--metrics", action="store_true",
                   help="print the merged Prometheus exposition")
    p.add_argument("--mad-sigma", type=float, default=4.0,
                   help="straggler threshold in robust sigmas (default 4)")
    p.add_argument("--stale-after", type=float, default=120.0,
                   help="heartbeat staleness that marks a worker down")
    p.add_argument("--selfcheck", action="store_true",
                   help="aggregate two in-process fake workers and verify "
                        "merge + straggler attribution (CI)")
    args = p.parse_args(argv)
    if args.selfcheck:
        return _selfcheck()
    if not args.workers and not args.pod_dir:
        p.error("need --workers URLs and/or --pod-dir (or --selfcheck)")
    workers: Dict[str, str] = {}
    for i, spec in enumerate(args.workers):
        name, sep, url = spec.partition("=")
        if sep and "://" not in name:
            workers[name] = url
        else:
            workers[str(i)] = spec
    agg = PodAggregator(workers=workers or None, pod_dir=args.pod_dir,
                        thresh_sigma=args.mad_sigma,
                        stale_after_s=args.stale_after)
    srv = None
    if args.serve is not None:
        srv = agg.serve(args.serve, host=args.host)
        print(f"pod view at http://{srv.address[0]}:{srv.address[1]}"
              f"/pod/status (merged /metrics alongside)")
    try:
        while True:
            if args.metrics:
                print(agg.render(), end="")
            elif args.json:
                print(json.dumps(agg.pod_status()))
            else:
                print(format_pod_table(agg.pod_status()))
            if args.watch is None and srv is None:
                return 0
            time.sleep(args.watch if args.watch is not None else 60.0)
    except KeyboardInterrupt:
        return 0
    finally:
        agg.stop()


if __name__ == "__main__":
    import sys
    sys.exit(main())
