"""SLO layer: declarative objectives, multi-window burn-rate alerting,
and retrospective reporting — `python -m sparknet_tpu_torch.obs.slo`.

A copy of `sparknet_tpu/obs/slo.py` (pure Python): the port imports
nothing of the JAX package. Its `slo_alert` rows, `/slo/status` body and
reports have the JAX package's schemas, and it reads either package's
history shards.

Objectives are declared, not hand-assembled: an `SloSpec` says "p99
latency <= X over window W" and/or "availability >= Y", and the
`BurnRateAlerter` evaluates them against the `MetricsHistory` rings
every sample. The alerting rule is the Google-SRE multi-window
multi-burn-rate recipe scaled to this system's horizons:

    burn rate = (error fraction over window) / (error budget fraction)

  page    (fast burn)  burn >= fast_burn over BOTH the fast window and a
                       short confirmation window — fires within seconds
                       of a real incident, and the confirmation window
                       resolves it promptly when the incident ends.
  ticket  (slow burn)  burn >= slow_burn over the slow window pair —
                       catches the quiet leak that would exhaust the
                       budget by end of window without ever paging.

A latency objective's error fraction is the estimated fraction of
requests slower than the threshold (interpolated from the history's
per-bucket deltas); availability's is non-"ok" outcomes over total.
Zero traffic burns nothing — an idle replica never pages.

Alerts are edge events (firing / resolved), never level-triggered: each
edge lands in an audit deque, as a JSONL `event="slo_alert"` row, and on
the `sparknet_slo_alerts_total{model,severity}` counter;
`sparknet_slo_error_budget_remaining{model}` tracks the spec window's
budget. `/slo/status` serves the live alert state; the fleet controller
(`fleet/controller.py`) consumes `firing_pages()` as a fast
admission-pressure input.

`main` builds retrospective reports from persisted history shards +
request journals: attainment per objective, the budget-burn timeline,
worst windows, per-model/per-tenant breakdown. `--selfcheck` runs the
whole loop live — quiet traffic must not page, an injected burn must.
`--latency-metric` is the port's: it names the latency histogram an
objective is read from (the `SloSpec.latency_metric` field), e.g. a
router's `sparknet_serve_routed_latency_seconds`, which covers replies
from remote replicas too; the JAX CLI reads only the lane's
`sparknet_serve_request_latency_seconds`.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .history import (HistoryConfig, MetricsHistory, Slot, fraction_over,
                      merge_slots, quantile_from_buckets,
                      read_history_shards, split_key)
from .registry import MetricsRegistry

LATENCY_METRIC = "sparknet_serve_request_latency_seconds"
REQUESTS_METRIC = "sparknet_serve_requests_total"


# -- specs -------------------------------------------------------------------


@dataclass
class SloSpec:
    """One model's objectives + the burn-rate alert policy over them.

    latency_ms / latency_quantile: "p<quantile> <= latency_ms over
    window_s" — equivalently, at most (1 - quantile) of requests may be
    slower than the threshold; that is the error budget the burn rates
    are measured against. availability: minimum fraction of requests
    answered "ok" over window_s.

    The default alert horizons are scaled-down Google SRE numbers (their
    1h/5m page at 14.4x, 6h/30m ticket at 6x — here minutes, because
    this system's incidents are bench-length, not month-length).
    """
    model: str
    latency_ms: Optional[float] = None
    latency_quantile: float = 0.99
    availability: Optional[float] = None
    window_s: float = 3600.0
    fast_burn: float = 8.0
    fast_window_s: float = 60.0
    fast_confirm_s: float = 5.0
    slow_burn: float = 2.0
    slow_window_s: float = 600.0
    slow_confirm_s: float = 60.0
    # metric families evaluated (overridable for non-serve processes)
    latency_metric: str = LATENCY_METRIC
    requests_metric: str = REQUESTS_METRIC

    def __post_init__(self):
        if self.latency_ms is None and self.availability is None:
            raise ValueError(f"slo[{self.model}]: declare at least one "
                             "objective (latency_ms / availability)")
        if not 0.0 < self.latency_quantile < 1.0:
            raise ValueError(f"slo[{self.model}]: latency_quantile must be "
                             "in (0, 1)")
        if self.availability is not None \
                and not 0.0 < self.availability < 1.0:
            raise ValueError(f"slo[{self.model}]: availability must be "
                             "in (0, 1)")
        if self.latency_ms is not None and self.latency_ms <= 0:
            raise ValueError(f"slo[{self.model}]: latency_ms must be > 0")
        for w in ("window_s", "fast_window_s", "fast_confirm_s",
                  "slow_window_s", "slow_confirm_s"):
            if getattr(self, w) <= 0:
                raise ValueError(f"slo[{self.model}]: {w} must be > 0")
        if self.fast_burn <= 0 or self.slow_burn <= 0:
            raise ValueError(f"slo[{self.model}]: burn thresholds must "
                             "be > 0")
        if self.fast_confirm_s > self.fast_window_s or \
                self.slow_confirm_s > self.slow_window_s:
            raise ValueError(f"slo[{self.model}]: confirm windows must "
                             "not exceed their long windows (the short "
                             "window CONFIRMS the long one)")

    def objectives(self) -> List[str]:
        out = []
        if self.latency_ms is not None:
            out.append("latency")
        if self.availability is not None:
            out.append("availability")
        return out

    def budget(self, objective: str) -> float:
        """Error budget FRACTION: the share of requests allowed to miss."""
        if objective == "latency":
            return 1.0 - self.latency_quantile
        return 1.0 - float(self.availability)

    def to_dict(self) -> Dict[str, Any]:
        return {"model": self.model, "latency_ms": self.latency_ms,
                "latency_quantile": self.latency_quantile,
                "availability": self.availability,
                "window_s": self.window_s,
                "fast_burn": self.fast_burn,
                "fast_window_s": self.fast_window_s,
                "fast_confirm_s": self.fast_confirm_s,
                "slow_burn": self.slow_burn,
                "slow_window_s": self.slow_window_s,
                "slow_confirm_s": self.slow_confirm_s}


# -- error fractions over a slot window (shared live/offline) ---------------


def _slot_err_frac(slots: Sequence[Slot], spec: SloSpec, objective: str,
                   le: Sequence[float]) -> Tuple[float, float]:
    """(error fraction, total observations) over merged slots."""
    merged = merge_slots(slots)
    if merged is None:
        return 0.0, 0.0
    if objective == "latency":
        buckets: List[float] = []
        count = 0.0
        for key, (d, s, n) in merged.h.items():
            name, labels = split_key(key)
            if name != spec.latency_metric or \
                    labels.get("model") != spec.model:
                continue
            buckets = d if not buckets else \
                [a + b for a, b in zip(buckets, d)]
            count += n
        if count <= 0:
            return 0.0, 0.0
        return fraction_over(le, buckets, count,
                             spec.latency_ms / 1e3), count
    total = err = 0.0
    for key, delta in merged.c.items():
        name, labels = split_key(key)
        if name != spec.requests_metric or \
                labels.get("model") != spec.model:
            continue
        total += delta
        if labels.get("outcome") != "ok":
            err += delta
    return (err / total if total > 0 else 0.0), total


# -- the alerter -------------------------------------------------------------


class _AlertState:
    __slots__ = ("firing", "since", "burn_long", "burn_short")

    def __init__(self):
        self.firing = False
        self.since: Optional[float] = None
        self.burn_long = 0.0
        self.burn_short = 0.0


class BurnRateAlerter:
    """Evaluates SloSpecs over a MetricsHistory; emits firing/resolved
    edges. Attach via `history.add_listener(alerter.listener)` so every
    sample is followed by an evaluation on the sampler thread, or call
    `evaluate(now)` directly (tests, selfcheck)."""

    def __init__(self, history: MetricsHistory, specs: Sequence[SloSpec],
                 registry: Optional[MetricsRegistry] = None,
                 logger: Optional[Any] = None, audit_len: int = 200):
        models = [s.model for s in specs]
        if len(set(models)) != len(models):
            raise ValueError("slo: one SloSpec per model")
        self.history = history
        self.specs = list(specs)
        self.logger = logger
        self._lock = threading.Lock()
        # (model, objective, severity) -> state
        self._states: Dict[Tuple[str, str, str], _AlertState] = {}
        self.audit: deque = deque(maxlen=audit_len)
        self.alerts_fired = 0
        reg = registry if registry is not None else history.registry
        self._c_alerts = reg.counter(
            "sparknet_slo_alerts_total",
            "SLO alert firing edges (page=fast burn, ticket=slow burn).",
            labels=("model", "severity"))
        self._g_budget = reg.gauge(
            "sparknet_slo_error_budget_remaining",
            "Fraction of the SLO window's error budget left (min across "
            "objectives; negative = budget blown).",
            labels=("model",))
        for spec in self.specs:
            self._g_budget.set(1.0, model=spec.model)

    # the bound method history.add_listener wants
    def listener(self, history: MetricsHistory, now: float) -> None:
        self.evaluate(now)

    def attach(self) -> "BurnRateAlerter":
        self.history.add_listener(self.listener)
        return self

    # -- evaluation ----------------------------------------------------------

    def _err_frac(self, spec: SloSpec, objective: str, window_s: float,
                  now: float) -> Tuple[float, float]:
        if objective == "latency":
            agg = self.history.window(spec.latency_metric, window_s,
                                      labels={"model": spec.model}, now=now)
            buckets: List[float] = []
            count = 0.0
            le: Sequence[float] = ()
            for v in agg.values():
                le = v["le"]
                buckets = v["buckets"] if not buckets else \
                    [a + b for a, b in zip(buckets, v["buckets"])]
                count += v["count"]
            if count <= 0:
                return 0.0, 0.0
            return fraction_over(le, buckets, count,
                                 spec.latency_ms / 1e3), count
        agg = self.history.window(spec.requests_metric, window_s,
                                  labels={"model": spec.model}, now=now)
        total = err = 0.0
        for key, v in agg.items():
            _, labels = split_key(key)
            total += v["delta"]
            if labels.get("outcome") != "ok":
                err += v["delta"]
        return (err / total if total > 0 else 0.0), total

    def evaluate(self, now: Optional[float] = None) -> None:
        t = time.time() if now is None else float(now)
        for spec in self.specs:
            remaining = 1.0
            for objective in spec.objectives():
                budget = spec.budget(objective)
                err_full, n_full = self._err_frac(spec, objective,
                                                  spec.window_s, t)
                att = (1.0 - err_full) if n_full > 0 else None
                if n_full > 0:
                    remaining = min(remaining, 1.0 - err_full / budget)
                for severity, burn_thr, long_w, short_w in (
                        ("page", spec.fast_burn, spec.fast_window_s,
                         spec.fast_confirm_s),
                        ("ticket", spec.slow_burn, spec.slow_window_s,
                         spec.slow_confirm_s)):
                    err_l, n_l = self._err_frac(spec, objective, long_w, t)
                    err_s, n_s = self._err_frac(spec, objective, short_w, t)
                    burn_l = err_l / budget
                    burn_s = err_s / budget
                    # both windows over threshold: the long window keeps
                    # one slow sample from paging, the short one lets the
                    # alert RESOLVE as soon as the incident actually ends
                    cond = (n_l > 0 and burn_l >= burn_thr
                            and burn_s >= burn_thr)
                    self._transition(spec, objective, severity, cond,
                                     burn_l, burn_s, t, att)
            self._g_budget.set(remaining, model=spec.model)

    def _transition(self, spec: SloSpec, objective: str, severity: str,
                    cond: bool, burn_l: float, burn_s: float,
                    t: float, attainment: Optional[float] = None) -> None:
        key = (spec.model, objective, severity)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = _AlertState()
            st.burn_long = burn_l
            st.burn_short = burn_s
            if cond == st.firing:
                return
            st.firing = cond
            edge = "firing" if cond else "resolved"
            if cond:
                st.since = t
                self.alerts_fired += 1
            row = {"t": round(t, 3), "model": spec.model,
                   "objective": objective, "severity": severity,
                   "edge": edge, "burn": round(burn_l, 2),
                   "burn_confirm": round(burn_s, 2)}
            if attainment is not None:
                # full-window attainment AT edge time — the retrospective
                # hook sparknet-metrics' SLO view reports without shards
                row["attainment"] = round(attainment, 4)
            self.audit.append(row)
        if cond:
            self._c_alerts.inc(model=spec.model, severity=severity)
        if self.logger is not None:
            try:
                # "t" is Logger's run-relative stamp; the edge time rides
                # the JSONL row as "at" (and "ts" is wall clock anyway)
                self.logger.event(0, "slo_alert",
                                  **{("at" if k == "t" else k): v
                                     for k, v in row.items()})
            except Exception:
                pass

    # -- consumers -----------------------------------------------------------

    def firing_pages(self) -> List[str]:
        """Models with a PAGE currently firing — the FleetController's
        fast admission-pressure input."""
        with self._lock:
            return sorted({m for (m, _o, sev), st in self._states.items()
                           if sev == "page" and st.firing})

    def state(self) -> Dict[str, Any]:
        """The /slo/status body: specs, live per-alert state, audit."""
        with self._lock:
            alerts = [{"model": m, "objective": o, "severity": sev,
                       "firing": st.firing, "since": st.since,
                       "burn": round(st.burn_long, 3),
                       "burn_confirm": round(st.burn_short, 3)}
                      for (m, o, sev), st in sorted(self._states.items())]
            audit = list(self.audit)
        return {"specs": [s.to_dict() for s in self.specs],
                "alerts": alerts,
                "firing": [a for a in alerts if a["firing"]],
                "budget_remaining": {
                    s.model: self._g_budget.value(model=s.model)
                    for s in self.specs},
                "alerts_fired_total": self.alerts_fired,
                "audit": audit}

    def summary(self) -> Dict[str, Any]:
        """Compact slice for /status dicts and podview model rows."""
        st = self.state()
        return {"firing": [f"{a['model']}:{a['objective']}:{a['severity']}"
                           for a in st["firing"]],
                "budget_remaining": st["budget_remaining"],
                "alerts_fired_total": st["alerts_fired_total"]}

    def attach_http(self, server: Any) -> None:
        server.add_route("/slo/status", self.state)


# -- retrospective reports ---------------------------------------------------


def _windows(slots: Sequence[Slot], window_s: float
             ) -> List[Tuple[float, float, List[Slot]]]:
    """Partition time-ordered slots into fixed report windows."""
    if not slots:
        return []
    t0 = slots[0].t0
    t1 = slots[-1].t1
    out: List[Tuple[float, float, List[Slot]]] = []
    w0 = t0
    while w0 < t1:
        w1 = w0 + window_s
        group = [s for s in slots if s.t1 > w0 and s.t0 < w1]
        if group:
            out.append((w0, min(w1, t1), group))
        w0 = w1
    return out


def discover_models(families: Dict[str, Dict[str, Any]],
                    slots: Sequence[Slot]) -> List[str]:
    models = set()
    for s in slots:
        for key in list(s.c) + list(s.h):
            name, labels = split_key(key)
            if name in (REQUESTS_METRIC, LATENCY_METRIC) \
                    and labels.get("model"):
                models.add(labels["model"])
    return sorted(models)


def build_report(history_dir: str,
                 journals: Sequence[str] = (),
                 specs: Optional[Sequence[SloSpec]] = None,
                 report_window_s: float = 60.0,
                 worst_n: int = 3) -> Dict[str, Any]:
    """The SLO report: SLO attainment, budget-burn timeline,
    worst windows, per-model/per-tenant breakdown — all offline, from
    persisted history shards (+ optional request-journal JSONLs for the
    tenant axis and the alert audit trail)."""
    families, slots = read_history_shards(history_dir)
    report: Dict[str, Any] = {
        "history_dir": history_dir,
        "span": {"t0": slots[0].t0 if slots else None,
                 "t1": slots[-1].t1 if slots else None,
                 "seconds": round(slots[-1].t1 - slots[0].t0, 3)
                 if slots else 0.0,
                 "slots": len(slots)},
        "report_window_s": report_window_s,
        "models": {}, "alerts": [], "tenants": {}}
    if not slots:
        return report
    le = list((families.get(LATENCY_METRIC) or {}).get("le") or ())
    by_spec = {s.model: s for s in (specs or ())}
    for model in discover_models(families, slots):
        spec = by_spec.get(model)
        if spec is None:
            # reporting needs SOME objective; default = availability-only
            # 99.9% so unconfigured models still get a breakdown
            spec = SloSpec(model=model, availability=0.999)
        merged = merge_slots(slots)
        entry: Dict[str, Any] = {}
        # traffic + latency overview
        total = ok = 0.0
        for key, delta in merged.c.items():
            name, labels = split_key(key)
            if name == spec.requests_metric \
                    and labels.get("model") == model:
                total += delta
                if labels.get("outcome") == "ok":
                    ok += delta
        buckets: List[float] = []
        lat_n = lat_sum = 0.0
        for key, (d, s_, n) in merged.h.items():
            name, labels = split_key(key)
            if name == spec.latency_metric \
                    and labels.get("model") == model:
                buckets = d if not buckets else \
                    [a + b for a, b in zip(buckets, d)]
                lat_n += n
                lat_sum += s_
        entry["requests"] = total
        entry["ok"] = ok
        entry["availability"] = round(ok / total, 6) if total else None
        if lat_n:
            entry["latency"] = {
                "n": lat_n,
                "mean_ms": round(lat_sum / lat_n * 1e3, 3),
                "p50_ms": _q_ms(le, buckets, lat_n, 0.5),
                "p99_ms": _q_ms(le, buckets, lat_n, 0.99)}
        # per-objective attainment + worst windows + burn timeline
        wins = _windows(slots, report_window_s)
        entry["slo"] = {}
        for objective in spec.objectives():
            budget = spec.budget(objective)
            rows = []
            for w0, w1, group in wins:
                err, n = _slot_err_frac(group, spec, objective, le)
                rows.append({"t0": round(w0, 3), "t1": round(w1, 3),
                             "err_frac": round(err, 6), "n": n,
                             "burn": round(err / budget, 2)})
            with_traffic = [r for r in rows if r["n"] > 0]
            met = [r for r in with_traffic if r["err_frac"] <= budget]
            consumed = 0.0
            timeline = []
            for r in rows:
                if r["n"] > 0:
                    # budget consumed this window, weighted by its share
                    # of the spec window
                    consumed += (r["err_frac"] / budget) \
                        * ((r["t1"] - r["t0"]) / spec.window_s)
                timeline.append([r["t1"], round(consumed, 4)])
            worst = sorted(with_traffic, key=lambda r: -r["err_frac"])
            entry["slo"][objective] = {
                "target": (f"p{int(spec.latency_quantile * 100)}<="
                           f"{spec.latency_ms}ms"
                           if objective == "latency"
                           else f"availability>={spec.availability}"),
                "budget_frac": budget,
                "windows": len(with_traffic),
                "attainment": round(len(met) / len(with_traffic), 6)
                if with_traffic else None,
                "budget_consumed": round(consumed, 4),
                "worst_windows": worst[:worst_n],
                "burn_timeline": timeline}
        report["models"][model] = entry
    # journals: alert audit trail + per-tenant breakdown
    for path in journals:
        for rec in _read_jsonl(path):
            if rec.get("event") == "slo_alert":
                report["alerts"].append(
                    {k: rec.get(k) for k in ("ts", "model", "objective",
                                             "severity", "edge", "burn",
                                             "burn_confirm")})
            elif rec.get("kind") == "request":
                tenant = rec.get("tenant") or "-"
                trow = report["tenants"].setdefault(
                    tenant, {"requests": 0, "ok": 0, "models": {}})
                trow["requests"] += 1
                outcome = rec.get("outcome")
                if outcome in ("ok", None):
                    # http journal rows are written at ADMISSION (no
                    # outcome field); binary rows carry the outcome
                    trow["ok"] += 1
                m = rec.get("model") or "-"
                trow["models"][m] = trow["models"].get(m, 0) + 1
    report["alerts"].sort(key=lambda a: a.get("ts") or 0)
    return report


def _q_ms(le: Sequence[float], buckets: Sequence[float], count: float,
          q: float) -> Optional[float]:
    v = quantile_from_buckets(le, buckets, count, q)
    return round(v * 1e3, 3) if v is not None else None


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
    except OSError:
        pass
    return out


def format_report(report: Dict[str, Any]) -> str:
    lines = [f"slo report: {report['history_dir']}  "
             f"span {report['span']['seconds']:.0f}s "
             f"({report['span']['slots']} slots, "
             f"window {report['report_window_s']:.0f}s)"]
    for model, e in sorted(report["models"].items()):
        avail = e.get("availability")
        lat = e.get("latency") or {}
        lines.append(
            f"  model={model} requests={e['requests']:.0f} "
            f"ok={e['ok']:.0f}"
            + (f" availability={avail:.4f}" if avail is not None else "")
            + (f" p50={lat['p50_ms']}ms p99={lat['p99_ms']}ms"
               if lat.get("p99_ms") is not None else ""))
        for objective, s in sorted((e.get("slo") or {}).items()):
            att = s.get("attainment")
            lines.append(
                f"    {objective} [{s['target']}] attainment="
                + (f"{att:.4f}" if att is not None else "-")
                + f" budget_consumed={s['budget_consumed']:.2%}"
                + f" windows={s['windows']}")
            for w in s.get("worst_windows") or []:
                if w["err_frac"] > 0:
                    lines.append(
                        f"      worst {w['t0']:.0f}..{w['t1']:.0f}: "
                        f"err={w['err_frac']:.4f} burn={w['burn']:.1f} "
                        f"n={w['n']:.0f}")
    if report["alerts"]:
        lines.append(f"  alert audit ({len(report['alerts'])} edges):")
        for a in report["alerts"]:
            lines.append(
                f"    {a.get('ts', 0):.0f} {a.get('model')} "
                f"{a.get('objective')}/{a.get('severity')} "
                f"{a.get('edge')} burn={a.get('burn')}")
    if report["tenants"]:
        lines.append("  tenants:")
        for t, row in sorted(report["tenants"].items()):
            lines.append(f"    {t}: requests={row['requests']} "
                         f"ok={row['ok']}")
    return "\n".join(lines)


# -- selfcheck ---------------------------------------------------------------


def _selfcheck(keep: Optional[str] = None) -> int:
    """End-to-end gate: a live StatusServer with /timeseries + /slo/status,
    a history sampling a real registry (deterministic injected clock), a
    burn injected mid-stream. Quiet traffic must NOT page (the false-
    positive gate), the burn MUST page then resolve, the shards must
    reproduce the incident in the offline report."""
    import shutil
    import tempfile
    import urllib.request

    from .http import StatusServer
    from ..utils.logger import Logger

    root = keep or tempfile.mkdtemp(prefix="sparknet_slo_check_")
    hist_dir = f"{root}/history"
    jsonl = f"{root}/journal.jsonl"
    ok = True

    def check(cond, what):
        nonlocal ok
        print(f"  {'ok' if cond else 'FAIL'}: {what}")
        ok = ok and cond

    reg = MetricsRegistry()
    lat = reg.histogram(LATENCY_METRIC, labels=("model",))
    req = reg.counter(REQUESTS_METRIC, labels=("model", "outcome"))
    hist = MetricsHistory(reg, HistoryConfig(
        sample_interval_s=1.0, rings=((1.0, 600), (10.0, 120)),
        persist_dir=hist_dir))
    logger = Logger(echo=False, jsonl_path=jsonl)
    spec = SloSpec(model="selfcheck", latency_ms=50.0, availability=0.99,
                   window_s=120.0, fast_burn=8.0, fast_window_s=10.0,
                   fast_confirm_s=2.0, slow_burn=2.0, slow_window_s=60.0,
                   slow_confirm_s=10.0)
    alerter = BurnRateAlerter(hist, [spec], logger=logger)
    srv = StatusServer(0, reg)
    hist.attach_http(srv)
    alerter.attach_http(srv)

    def get(path):
        host, port = srv.address
        with urllib.request.urlopen(
                f"http://{host}:{port}{path}", timeout=5) as r:
            return json.loads(r.read())

    try:
        t0 = time.time()
        # quiet phase: 30 s of healthy traffic, 5 ms
        for i in range(30):
            t = t0 + i
            for _ in range(20):
                lat.observe(0.005, model="selfcheck")
                req.inc(model="selfcheck", outcome="ok")
            hist.sample_now(now=t)
            alerter.evaluate(now=t)
        check(alerter.alerts_fired == 0,
              "quiet arm: zero alerts over 30s of healthy traffic")
        # burn: every request 200 ms (> 50 ms threshold) and failing
        burn_onset = t0 + 30
        fired_at = None
        for i in range(30, 60):
            t = t0 + i
            for _ in range(20):
                lat.observe(0.200, model="selfcheck")
                req.inc(model="selfcheck", outcome="failed")
            hist.sample_now(now=t)
            alerter.evaluate(now=t)
            if fired_at is None and alerter.firing_pages():
                fired_at = t
        check(fired_at is not None, "injected burn fires a page")
        if fired_at is not None:
            detect = fired_at - burn_onset
            check(detect <= 2 * spec.fast_window_s,
                  f"detection latency {detect:.0f}s <= "
                  f"2x fast window ({2 * spec.fast_window_s:.0f}s)")
        # recovery: page must RESOLVE (edge semantics, not a latch)
        for i in range(60, 90):
            t = t0 + i
            for _ in range(40):
                lat.observe(0.005, model="selfcheck")
                req.inc(model="selfcheck", outcome="ok")
            hist.sample_now(now=t)
            alerter.evaluate(now=t)
        check(not alerter.firing_pages(), "page resolves after recovery")
        edges = [a["edge"] for a in alerter.audit]
        check("firing" in edges and "resolved" in edges,
              f"audit has firing+resolved edges ({len(edges)} total)")
        # live HTTP surfaces
        ts = get(f"/timeseries?name={LATENCY_METRIC}&window=30&q=0.99")
        check(ts.get("quantile", {}).get("value") is not None,
              "/timeseries answers a windowed p99")
        st = get("/slo/status")
        check(st.get("alerts_fired_total", 0) >= 1
              and len(st.get("audit") or []) >= 2,
              "/slo/status serves alert state + audit")
        # retrospective report reproduces the incident from shards
        logger.close()
        rep = build_report(hist_dir, journals=[jsonl], specs=[spec],
                           report_window_s=10.0)
        mod = rep["models"].get("selfcheck") or {}
        lat_slo = (mod.get("slo") or {}).get("latency") or {}
        att = lat_slo.get("attainment")
        check(att is not None and att < 1.0,
              f"report shows burned latency attainment ({att})")
        check(any(a.get("edge") == "firing" for a in rep["alerts"]),
              "report's alert audit shows the page")
        worst = lat_slo.get("worst_windows") or []
        check(bool(worst) and worst[0]["err_frac"] > 0.5,
              "worst window lands inside the burn")
        print(format_report(rep))
        return 0 if ok else 1
    finally:
        srv.stop()
        hist.stop()
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)
        else:
            print(f"  artifacts kept in {root}")


# -- CLI ---------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.obs.slo",
        description="Retrospective SLO reports from persisted metrics-"
                    "history shards (+ request journals): attainment, "
                    "budget burn, worst windows, per-tenant breakdown.")
    p.add_argument("history_dir", nargs="?", default=None,
                   help="directory of history-*.jsonl shards")
    p.add_argument("--journal", action="append", default=[],
                   help="request-journal / metrics JSONL (repeatable): "
                        "adds the alert audit trail + tenant breakdown")
    p.add_argument("--model", default=None,
                   help="SLO model name (default: every model discovered)")
    p.add_argument("--latency-ms", type=float, default=None,
                   help="latency objective: p<quantile> <= this")
    p.add_argument("--quantile", type=float, default=0.99)
    p.add_argument("--latency-metric", default=LATENCY_METRIC,
                   help="the latency histogram the objective is read "
                        "from (default: the lane's "
                        f"{LATENCY_METRIC}; a router's routed latency: "
                        "sparknet_serve_routed_latency_seconds)")
    p.add_argument("--availability", type=float, default=None,
                   help="availability objective, e.g. 0.999")
    p.add_argument("--window", type=float, default=60.0,
                   help="report window seconds (attainment granularity)")
    p.add_argument("--json", action="store_true", dest="as_json")
    p.add_argument("--selfcheck", action="store_true",
                   help="live end-to-end gate: quiet arm must not page, "
                        "an injected burn must page and show in the "
                        "report (CI)")
    p.add_argument("--keep", default=None, metavar="DIR",
                   help="with --selfcheck: keep artifacts here")
    args = p.parse_args(argv)

    if args.selfcheck:
        return _selfcheck(keep=args.keep)
    if not args.history_dir:
        p.error("history_dir required (or --selfcheck)")
    specs: List[SloSpec] = []
    if args.latency_ms is not None or args.availability is not None:
        if not args.model:
            p.error("--model required with --latency-ms/--availability")
        specs.append(SloSpec(model=args.model, latency_ms=args.latency_ms,
                             latency_quantile=args.quantile,
                             availability=args.availability,
                             latency_metric=args.latency_metric))
    report = build_report(args.history_dir, journals=args.journal,
                          specs=specs, report_window_s=args.window)
    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(format_report(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
