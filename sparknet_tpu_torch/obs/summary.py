"""`sparknet-metrics` — summarize a metrics JSONL on the console
(`python -m sparknet_tpu_torch.obs.summary`).

The counterpart of `sparknet_tpu/obs/summary.py`: the same records give the
same `summarize()` and `format_text()` in both packages. Its self-check
runs the port's training loop, serving replica, fleet controller, batch
job and SLO alerter, on the CUDA card unless `--device cpu` (without a
card and without `--device cpu` it raises before it starts).

The metrics JSONL (utils/logger.py) is the run's machine-readable record:
loss rows, eval rows, per-round step-time breakdowns (t_*_ms fields), and
the health supervisor's event audit trail. Reading it used to mean ad-hoc
jq one-liners documented nowhere; this tool is the blessed reader:

    sparknet-metrics training_metrics_1234.jsonl
    sparknet-metrics --tail 20 --json run/*.jsonl

prints the loss-curve tail, a step-time breakdown table (where each
round's wall clock went: data / H2D / compiled round / collect /
checkpoint-fetch / log), the eval trajectory, and every event record
(spike_skip, rollback, anomalous_checkpoint, ...) next to the losses they
explain. Multiple files merge on the wall-clock `ts` field — a trainer
JSONL and its serve JSONL interleave into one timeline.

`--selfcheck` runs a 3-round synthetic training first and summarizes its
freshly written JSONL (the CI step: the tooling cannot rot against the
live schema); `--selfcheck-workers 2` runs one per worker id and checks
the POD view below; `--keep DIR` retains the artifacts for CI upload;
`--device cpu` runs it without a card.

**Fleet view**: when the records carry the fleet controller's rows
(`event="fleet_scale"` + periodic `fleet_replicas` counts), the summary
adds the scale-event audit trail and the per-model replica count over
time — the post-hoc answer to "when did the fleet grow, and why".

**SLO view**: when the records carry the burn-rate alerter's edge rows
(`event="slo_alert"` — firing/resolved, burn multiples, full-window
attainment at edge time), the summary adds per-model attainment, the
set of alerts still firing at end-of-record, and the alert audit trail.

**Pod view**: when the merged records span >= 2 workers (the `worker`
field every multi-host run stamps, falling back to one-file-per-worker
input order), the summary adds a per-worker step-time breakdown table
plus a round-skew / straggler audit trail — per matched round, workers'
`t_round_ms` are compared with the same median+MAD rule the live pod
aggregator uses (`obs/pod.py`), so post-hoc JSONL analysis and the live
`/pod/status` endpoint name the same sick host.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
import sys
import time
from typing import Any, Dict, List, Optional

from .pod import flag_stragglers

#: step-time breakdown columns, in pipeline order (emitted by run_loop).
#: t_collect_ms is the round loop's BLOCKING share of the deferred
#: loss/health fetch — ~0 under collect_async (r8), where the fetch
#: itself runs on the collector thread and lands as t_collect_bg_ms
BREAKDOWN_FIELDS = ("t_data_ms", "t_h2d_ms", "t_round_ms", "t_collect_ms",
                    "t_collect_bg_ms", "t_ckpt_fetch_ms", "t_log_ms")


def load_records(paths: List[str]) -> List[Dict[str, Any]]:
    recs: List[Dict[str, Any]] = []
    for fi, path in enumerate(paths):
        with open(path) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    print(f"{path}:{i + 1}: skipping unparseable line "
                          f"({e})", file=sys.stderr)
                    continue
                if len(paths) > 1:
                    # records without a worker stamp fall back to their
                    # source file as the worker id (one JSONL per worker
                    # is the pod layout)
                    rec.setdefault("worker", fi)
                recs.append(rec)
    # merge multiple processes' files on the wall-clock ts (satellite of
    # the same PR); files predating the ts field fall back to input order
    if len(paths) > 1 and all("ts" in r for r in recs):
        recs.sort(key=lambda r: r["ts"])
    return recs


def _mean(xs: List[float]) -> Optional[float]:
    xs = [x for x in xs if x is not None and math.isfinite(x)]
    return sum(xs) / len(xs) if xs else None


def summarize(recs: List[Dict[str, Any]], tail: int = 10) -> Dict[str, Any]:
    """The machine half (--json): everything the text report prints."""
    loss_rows = [r for r in recs if "loss" in r and "event" not in r]
    eval_rows = [r for r in recs if "test_accuracy" in r]
    events = [r for r in recs if "event" in r]
    losses = [r["loss"] for r in loss_rows if r.get("loss") is not None]
    out: Dict[str, Any] = {
        "records": len(recs),
        "rounds": len(loss_rows),
        "events": len(events),
        "loss_first": losses[0] if losses else None,
        "loss_final": losses[-1] if losses else None,
        "loss_min": min(losses) if losses else None,
        "loss_tail": [
            {"step": r["step"], "loss": r.get("loss"),
             **({"health": r["health"]} if "health" in r else {})}
            for r in loss_rows[-tail:]],
        "eval_tail": [{"step": r["step"], "test_accuracy":
                       r["test_accuracy"]} for r in eval_rows[-tail:]],
        "images_per_sec_per_chip": _mean(
            [r.get("images_per_sec_per_chip") for r in loss_rows[-tail:]]),
        "event_trail": [
            {k: v for k, v in r.items() if k not in ("t", "ts")}
            for r in events],
    }
    breakdown: Dict[str, Any] = {}
    for fld in BREAKDOWN_FIELDS:
        vals = [r[fld] for r in loss_rows if fld in r]
        if vals:
            breakdown[fld] = {"mean_ms": round(_mean(vals), 3),
                              "max_ms": round(max(vals), 3),
                              "total_s": round(sum(vals) / 1e3, 3)}
    if breakdown:
        out["step_time_breakdown"] = breakdown
    pod = _pod_view(loss_rows)
    if pod is not None:
        out["pod"] = pod
    serve = _serve_view(recs)
    if serve is not None:
        out["serve"] = serve
    fresh = _fresh_view(recs)
    if fresh is not None:
        out["freshness"] = fresh
    fleet = _fleet_view(recs)
    if fleet is not None:
        out["fleet"] = fleet
    batch = _batch_view(recs)
    if batch is not None:
        out["batch"] = batch
    slo = _slo_view(recs)
    if slo is not None:
        out["slo"] = slo
    return out


def _percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (ceil rank) over a non-empty list."""
    ys = sorted(xs)
    return ys[min(len(ys) - 1, max(0, math.ceil(q * len(ys)) - 1))]


def _fresh_view(recs: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Train->serve freshness: the age of each model's SERVING step
    (`freshness_s` = now - the checkpoint's meta.json commit_ts, which
    serve metrics rows carry once a stamped checkpoint installs), the
    distinct steps the replica actually served, and how far it trailed
    the newest committed step (`model_step_lag`). This is the post-hoc
    freshness-SLO answer — `bench.py --fresh` stamps the same p99 into
    BENCH_FRESH.json from live samples. None when no row carries
    freshness (no continuous-learning serve run in the records)."""
    rows = [r for r in recs if r.get("freshness_s") is not None]
    if not rows:
        return None
    models: Dict[str, Any] = {}
    for r in rows:
        m = models.setdefault(str(r.get("model", "default")), {
            "samples": 0, "_fresh": [], "_steps": set()})
        m["samples"] += 1
        m["_fresh"].append(float(r["freshness_s"]))
        if r.get("model_step") is not None:
            m["_steps"].add(int(r["model_step"]))
        if r.get("model_step_lag") is not None:
            m["step_lag_max"] = max(m.get("step_lag_max", 0),
                                    int(r["model_step_lag"]))
        if r.get("swaps") is not None:
            # cumulative per process; max = the final count
            m["swaps"] = max(m.get("swaps", 0), int(r["swaps"]))
    for m in models.values():
        xs = m.pop("_fresh")
        m["steps_served"] = sorted(m.pop("_steps"))
        m["freshness_last_s"] = round(xs[-1], 3)
        m["freshness_p99_s"] = round(_percentile(xs, 0.99), 3)
        m["freshness_max_s"] = round(max(xs), 3)
    return {"models": models}


def _fleet_view(recs: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The fleet controller's record: the scale-event audit trail
    (`event="fleet_scale"` rows — model, direction, reason, replica)
    plus the per-model replica count OVER TIME (the periodic
    `fleet_replicas` rows). None when the records carry no fleet rows."""
    events = [r for r in recs if r.get("event") == "fleet_scale"]
    series: Dict[str, List[Any]] = {}
    pressures: List[float] = []
    for r in recs:
        if isinstance(r.get("fleet_replicas"), dict):
            for m, n in r["fleet_replicas"].items():
                series.setdefault(str(m), []).append(
                    {"step": r.get("step"), "ts": r.get("ts"),
                     "replicas": n})
            if r.get("fleet_pressure") is not None:
                pressures.append(float(r["fleet_pressure"]))
    if not events and not series:
        return None
    models: Dict[str, Any] = {}
    for m, rows in series.items():
        counts = [row["replicas"] for row in rows]
        models[m] = {"rows": len(rows), "replicas_first": counts[0],
                     "replicas_max": max(counts),
                     "replicas_last": counts[-1],
                     "tail": rows[-10:]}
    by_dir: Dict[str, int] = {}
    for e in events:
        key = f"{e.get('direction', '?')}/{e.get('reason', '?')}"
        by_dir[key] = by_dir.get(key, 0) + 1
    return {
        "scale_events": len(events),
        "events_by_kind": dict(sorted(by_dir.items())),
        "audit": [{k: v for k, v in e.items()
                   if k not in ("t", "ts", "event")}
                  for e in events[-20:]],
        "models": models,
        "pressure_max": max(pressures) if pressures else None,
    }


def _batch_view(recs: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The `sparknet-batch` driver's record: per-unit commit rows
    (`event="batch_unit"`), the retry trail (`event="batch_retry"`,
    split shed-vs-error — backpressure is not breakage), and the final
    job summary (`event="batch_done"` — fleet-aggregate rows/s and
    cost-per-million). None when the records carry no batch rows."""
    units = [r for r in recs if r.get("event") == "batch_unit"]
    retries = [r for r in recs if r.get("event") == "batch_retry"]
    dones = [r for r in recs if r.get("event") == "batch_done"]
    if not units and not retries and not dones:
        return None
    by_replica: Dict[str, int] = {}
    for u in units:
        key = str(u.get("replica", "?"))
        by_replica[key] = by_replica.get(key, 0) + 1
    by_kind: Dict[str, int] = {}
    for r in retries:
        key = str(r.get("kind", "?"))
        by_kind[key] = by_kind.get(key, 0) + 1
    jobs: Dict[str, Any] = {}
    for d in dones:  # last row per job wins (a resume re-summarizes)
        jobs[str(d.get("job_id", "?"))] = {
            k: d.get(k) for k in
            ("done", "units_total", "units_done",
             "units_skipped_resume", "rows_total", "elapsed_s",
             "rows_per_s", "retries", "cost_per_million_embeddings")}
    return {
        "units": len(units),
        "rows": sum(int(u.get("rows", 0)) for u in units),
        "output_bytes": sum(int(u.get("bytes", 0)) for u in units),
        "attempts_max": max((int(u.get("attempts", 1)) for u in units),
                            default=None),
        "retries": len(retries),
        "retries_by_kind": dict(sorted(by_kind.items())),
        "units_by_replica": dict(sorted(by_replica.items())),
        "jobs": jobs,
    }


def _slo_view(recs: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The SLO ledger's record: burn-rate alert EDGES
    (`event="slo_alert"` rows — model, objective, severity,
    firing/resolved, burn multiples, full-window attainment at edge
    time) aggregated into per-model attainment, the set of alerts
    still firing at end-of-record, and the audit trail. None when the
    records carry no alert rows."""
    edges = [r for r in recs if r.get("event") == "slo_alert"]
    if not edges:
        return None
    by_kind: Dict[str, int] = {}
    last_edge: Dict[tuple, Dict[str, Any]] = {}
    models: Dict[str, Any] = {}
    for e in edges:
        key = f"{e.get('severity', '?')}/{e.get('edge', '?')}"
        by_kind[key] = by_kind.get(key, 0) + 1
        k = (str(e.get("model", "?")), str(e.get("objective", "?")),
             str(e.get("severity", "?")))
        last_edge[k] = e
        m = models.setdefault(k[0], {"edges": 0, "pages": 0,
                                     "attainment": {}})
        m["edges"] += 1
        if e.get("severity") == "page" and e.get("edge") == "firing":
            m["pages"] += 1
        if e.get("attainment") is not None:
            m["attainment"][k[1]] = e["attainment"]  # last edge wins
    firing = sorted(":".join(k) for k, e in last_edge.items()
                    if e.get("edge") == "firing")
    return {
        "alert_edges": len(edges),
        "edges_by_kind": dict(sorted(by_kind.items())),
        "firing_at_end": firing,
        "models": models,
        "audit": [{k: v for k, v in e.items()
                   if k not in ("t", "ts", "event", "step")}
                  for e in edges[-20:]],
    }


def _serve_view(recs: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Per-model serve vitals + the formed-batch request-size histogram —
    the input `sparknet-serve --buckets-from` / serve.buckets.
    derive_buckets fits a bucket ladder to. Hist rows are CUMULATIVE per
    process, so the LAST row per (source, model) counts and sources sum;
    None when the records carry no serve rows."""
    last: Dict[tuple, Dict[str, Any]] = {}
    for r in recs:
        if isinstance(r.get("batch_size_hist"), dict):
            key = (r.get("worker"), str(r.get("model", "default")))
            last[key] = r
    if not last:
        return None
    models: Dict[str, Any] = {}
    for (_, name), r in last.items():
        m = models.setdefault(name, {"batch_size_hist": {}, "rows": 0})
        for s, n in r["batch_size_hist"].items():
            try:
                s, n = int(s), int(n)
            except (TypeError, ValueError):
                continue
            m["batch_size_hist"][s] = m["batch_size_hist"].get(s, 0) + n
        m["rows"] += 1
        # multi-source (several replicas' files for one model): counters
        # SUM; per-process quality gauges take the WORST source (max
        # p99, min fill) — never one arbitrary replica's number
        # presented as the model's
        for fld in ("requests_ok", "requests_shed", "bucket_compiles",
                    "images_per_sec"):
            if r.get(fld) is not None:
                m[fld] = round(m.get(fld, 0) + r[fld], 2)
        if r.get("p99_ms") is not None:
            m["p99_ms"] = max(m.get("p99_ms", 0.0), r["p99_ms"])
        if r.get("batch_fill_ratio") is not None:
            m["batch_fill_ratio"] = min(m.get("batch_fill_ratio", 1.0),
                                        r["batch_fill_ratio"])
    for m in models.values():
        m["batch_size_hist"] = {
            str(s): c for s, c in sorted(m["batch_size_hist"].items())}
    return {"models": models}


def _pod_view(loss_rows: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Per-worker breakdown + round-skew/straggler audit when the records
    span >= 2 workers; None for single-worker runs (no pod to describe)."""
    by_worker: Dict[int, List[Dict[str, Any]]] = {}
    for r in loss_rows:
        wid = r.get("worker")
        if wid is None:
            continue
        by_worker.setdefault(int(wid), []).append(r)
    if len(by_worker) < 2:
        return None
    workers: Dict[str, Any] = {}
    for wid in sorted(by_worker):
        rows = by_worker[wid]
        w: Dict[str, Any] = {"rounds": len(rows)}
        for fld in BREAKDOWN_FIELDS:
            vals = [r[fld] for r in rows if fld in r]
            if vals:
                w[fld] = {"mean_ms": round(_mean(vals), 3),
                          "max_ms": round(max(vals), 3)}
        losses = [r["loss"] for r in rows if r.get("loss") is not None]
        if losses:
            w["loss_final"] = losses[-1]
        workers[str(wid)] = w
    # per-matched-round skew + straggler flags: the SAME median+MAD rule
    # the live aggregator applies, over t_round_ms grouped by step
    per_step: Dict[Any, Dict[str, float]] = {}
    for wid, rows in by_worker.items():
        for r in rows:
            if "t_round_ms" in r:
                per_step.setdefault(r["step"], {})[str(wid)] = r["t_round_ms"]
    skews: List[float] = []
    straggler_rounds: Dict[str, int] = {}
    audit: List[Dict[str, Any]] = []
    for step in sorted(per_step):
        vals = per_step[step]
        if len(vals) < 2:
            continue
        med_s, skew_s, flagged = flag_stragglers(
            {w: v / 1e3 for w, v in vals.items()})
        skews.append(skew_s * 1e3)
        for w in sorted(flagged):
            straggler_rounds[w] = straggler_rounds.get(w, 0) + 1
            audit.append({"step": step, "worker": w,
                          "round_ms": round(vals[w], 3),
                          "median_ms": round(med_s * 1e3, 3)})
    pod: Dict[str, Any] = {"n_workers": len(workers), "workers": workers,
                           "straggler_rounds": straggler_rounds,
                           "straggler_audit": audit[-20:]}
    if skews:
        pod["round_skew_ms"] = {"mean": round(_mean(skews), 3),
                                "max": round(max(skews), 3),
                                "rounds": len(skews)}
    return pod


def format_text(s: Dict[str, Any]) -> str:
    lines: List[str] = []
    lines.append(f"records: {s['records']}  loss rows: {s['rounds']}  "
                 f"events: {s['events']}")
    if s["loss_final"] is not None:
        lines.append(f"loss: first {s['loss_first']:.4f}  min "
                     f"{s['loss_min']:.4f}  final {s['loss_final']:.4f}")
    if s.get("images_per_sec_per_chip"):
        lines.append(f"throughput (tail mean): "
                     f"{s['images_per_sec_per_chip']:.1f} img/s/chip")
    if s["loss_tail"]:
        lines.append("")
        lines.append("loss tail:")
        for r in s["loss_tail"]:
            flag = f"  [{r['health']}]" if "health" in r else ""
            loss = ("nan/inf" if r["loss"] is None
                    else f"{r['loss']:.4f}")
            lines.append(f"  round {r['step']:>6}  loss {loss}{flag}")
    if s["eval_tail"]:
        lines.append("")
        lines.append("eval tail:")
        for r in s["eval_tail"]:
            lines.append(f"  round {r['step']:>6}  accuracy "
                         f"{r['test_accuracy']:.4f}")
    bd = s.get("step_time_breakdown")
    if bd:
        lines.append("")
        lines.append("step-time breakdown (per round):")
        lines.append(f"  {'phase':<14}{'mean ms':>10}{'max ms':>10}"
                     f"{'total s':>10}")
        for fld, row in bd.items():
            name = fld[2:-3]  # t_<phase>_ms
            lines.append(f"  {name:<14}{row['mean_ms']:>10.3f}"
                         f"{row['max_ms']:>10.3f}{row['total_s']:>10.3f}")
    pod = s.get("pod")
    if pod:
        lines.append("")
        lines.append(f"pod view ({pod['n_workers']} workers, per-worker "
                     f"step-time means):")
        # the table shows the three columns skew lives in; --json has all
        cols = [f for f in ("t_data_ms", "t_h2d_ms", "t_round_ms")
                if any(f in w for w in pod["workers"].values())]
        hdr = f"  {'worker':<8}{'rounds':>7}{'loss':>10}"
        hdr += "".join(f"{c[2:-3] + ' ms':>12}" for c in cols)
        hdr += f"{'straggler':>11}"
        lines.append(hdr)
        for wid, w in pod["workers"].items():
            row = f"  {wid:<8}{w['rounds']:>7}"
            row += (f"{w['loss_final']:>10.4f}" if "loss_final" in w
                    else f"{'-':>10}")
            for c in cols:
                row += (f"{w[c]['mean_ms']:>12.3f}" if c in w
                        else f"{'-':>12}")
            row += f"{pod['straggler_rounds'].get(wid, 0):>11}"
            lines.append(row)
        skew = pod.get("round_skew_ms")
        if skew:
            lines.append(f"  round skew across workers: mean "
                         f"{skew['mean']:.3f} ms  max {skew['max']:.3f} ms "
                         f"(over {skew['rounds']} matched rounds)")
        if pod["straggler_audit"]:
            lines.append("  straggler audit trail:")
            for e in pod["straggler_audit"]:
                lines.append(f"    round {e['step']:>6}  worker "
                             f"{e['worker']}  {e['round_ms']:.3f} ms vs "
                             f"median {e['median_ms']:.3f} ms")
        else:
            lines.append("  straggler audit trail: clean (no rounds "
                         "flagged)")
    serve = s.get("serve")
    if serve:
        lines.append("")
        lines.append("serve view (request-size histogram = the "
                     "bucket-ladder derivation input):")
        for name, m in sorted(serve["models"].items()):
            vit = "  ".join(
                f"{fld}={m[fld]}" for fld in
                ("requests_ok", "batch_fill_ratio", "bucket_compiles",
                 "p99_ms") if m.get(fld) is not None)
            lines.append(f"  model {name}: {vit}")
            hist = m["batch_size_hist"]
            peak = max(hist.values(), default=0)
            for sz, n in hist.items():
                bar = "#" * max(1, round(24 * n / peak)) if peak else ""
                lines.append(f"    batch size {sz:>4}  {n:>8}  {bar}")
    fresh = s.get("freshness")
    if fresh:
        lines.append("")
        lines.append("freshness view (train->serve commit age of the "
                     "serving step):")
        for name, m in sorted(fresh["models"].items()):
            steps = m["steps_served"]
            shown = (", ".join(str(x) for x in steps) if len(steps) <= 8
                     else f"{steps[0]}..{steps[-1]} ({len(steps)} steps)")
            lines.append(
                f"  model {name}: p99 {m['freshness_p99_s']:.3f} s  "
                f"max {m['freshness_max_s']:.3f} s  "
                f"last {m['freshness_last_s']:.3f} s  "
                f"({m['samples']} samples)")
            lines.append(
                f"    steps served: {shown}  swaps {m.get('swaps', 0)}  "
                f"max step lag {m.get('step_lag_max', 0)}")
    fleet = s.get("fleet")
    if fleet:
        lines.append("")
        lines.append(f"fleet view ({fleet['scale_events']} scale "
                     f"events):")
        for m, row in sorted(fleet["models"].items()):
            lines.append(f"  model {m}: replicas "
                         f"{row['replicas_first']} -> "
                         f"{row['replicas_last']} "
                         f"(max {row['replicas_max']}, over "
                         f"{row['rows']} rows)")
        if fleet["events_by_kind"]:
            kinds = "  ".join(f"{k}={n}" for k, n
                              in fleet["events_by_kind"].items())
            lines.append(f"  events: {kinds}")
        for e in fleet["audit"]:
            rest = " ".join(f"{k}={v}" for k, v in e.items()
                            if k not in ("model", "direction", "reason",
                                         "step"))
            lines.append(f"    {e.get('model', '?')}: "
                         f"{e.get('direction', '?')} "
                         f"({e.get('reason', '?')}) {rest}".rstrip())
    batch = s.get("batch")
    if batch:
        lines.append("")
        lines.append(f"batch view (scavenger bulk-inference; "
                     f"{batch['units']} units committed):")
        lines.append(f"  rows {batch['rows']}  output "
                     f"{batch['output_bytes'] / 1e6:.2f} MB  retries "
                     f"{batch['retries']}"
                     + ("".join(f"  {k}={n}" for k, n in
                                batch["retries_by_kind"].items())))
        for addr, n in batch["units_by_replica"].items():
            lines.append(f"    replica {addr}: {n} units")
        for jid, j in sorted(batch["jobs"].items()):
            cpm = j.get("cost_per_million_embeddings")
            lines.append(
                f"  job {jid}: "
                f"{'done' if j.get('done') else 'INCOMPLETE'}  units "
                f"{j.get('units_done')}/{j.get('units_total')}  "
                f"{j.get('rows_per_s')} rows/s"
                + (f"  ${cpm}/M embeddings" if cpm is not None else ""))
    slo = s.get("slo")
    if slo:
        lines.append("")
        firing = (", ".join(slo["firing_at_end"])
                  if slo["firing_at_end"] else "none")
        lines.append(f"slo view ({slo['alert_edges']} alert edges; "
                     f"firing at end: {firing}):")
        for m, row in sorted(slo["models"].items()):
            att = "  ".join(f"{obj}={v:.4f}" for obj, v
                            in sorted(row["attainment"].items()))
            lines.append(f"  model {m}: {row['edges']} edges  "
                         f"{row['pages']} pages"
                         + (f"  attainment {att}" if att else ""))
        if slo["edges_by_kind"]:
            kinds = "  ".join(f"{k}={n}" for k, n
                              in slo["edges_by_kind"].items())
            lines.append(f"  edges: {kinds}")
        for e in slo["audit"]:
            rest = " ".join(f"{k}={v}" for k, v in e.items()
                            if k not in ("model", "objective",
                                         "severity", "edge"))
            lines.append(f"    {e.get('model', '?')}: "
                         f"{e.get('severity', '?')} "
                         f"{e.get('edge', '?')} "
                         f"({e.get('objective', '?')}) {rest}".rstrip())
    if s["event_trail"]:
        lines.append("")
        lines.append("health/event audit trail:")
        for r in s["event_trail"]:
            step = r.get("step", "?")
            ev = r.get("event", "?")
            rest = " ".join(f"{k}={v}" for k, v in r.items()
                            if k not in ("step", "event"))
            lines.append(f"  round {step:>6}  {ev}  {rest}".rstrip())
    else:
        lines.append("")
        lines.append("health/event audit trail: clean (no events)")
    return "\n".join(lines)


def _selfcheck_jsonl(n_workers: int = 1, out_dir: Optional[str] = None,
                     device: Optional[str] = None) -> List[str]:
    """Run tiny synthetic trainings (3 rounds each, lenet shapes) on
    `device` (the CUDA card unless "cpu"), one per worker id, then the
    serve, fleet, batch and SLO runs, and return the metrics JSONLs they
    wrote: the freshest possible schema. Each training also writes a trace
    JSON next to its JSONL (with `out_dir` these survive as CI artifacts).
    Multi-worker runs stamp `worker` on every record, so the merged
    summary exercises the pod view against live-written files."""
    import tempfile

    import numpy as np

    from ..apps.train_loop import train
    from ..data.dataset import ArrayDataset
    from ..device import resolve_device
    from ..utils.config import RunConfig
    from ..utils.logger import Logger
    from ..zoo import lenet

    dev = str(resolve_device(device))  # no card: raise before any run
    root = out_dir or tempfile.mkdtemp(prefix="sparknet-metrics-selfcheck-")
    os.makedirs(root, exist_ok=True)
    r = np.random.default_rng(0)
    n, b, tau = 256, 16, 2
    ds = ArrayDataset({
        "data": r.standard_normal((n, 1, 28, 28)).astype(np.float32),
        "label": r.integers(0, 10, (n, 1)).astype(np.int32)})
    paths: List[str] = []
    for w in range(max(1, n_workers)):
        suffix = f"_w{w}" if n_workers > 1 else ""
        jsonl = os.path.join(root, f"selfcheck_metrics{suffix}.jsonl")
        cfg = RunConfig(model="lenet", n_devices=1, local_batch=b, tau=tau,
                        max_rounds=3, eval_every=0,
                        workdir=os.path.join(root, f"train{suffix}"),
                        seed=w, trace_out=os.path.join(
                            root, f"selfcheck_trace{suffix}.json"))
        log = Logger(os.path.join(root, f"selfcheck_log{suffix}.txt"),
                     echo=False, jsonl_path=jsonl,
                     worker=w if n_workers > 1 else None)
        try:
            train(cfg, lenet(batch=b), ds, None, logger=log, device=dev)
        finally:
            log.close()
        paths.append(jsonl)
    paths.append(_selfcheck_serve_jsonl(root, dev))
    paths.append(_selfcheck_fleet_jsonl(root, dev))
    paths.append(_selfcheck_batch_jsonl(root, dev))
    paths.append(_selfcheck_slo_jsonl(root))
    return paths


def _selfcheck_slo_jsonl(root: str) -> str:
    """Drive a real MetricsHistory + BurnRateAlerter through a
    quiet->burn->recovery traffic shape on an injected clock and return
    the alert JSONL it wrote — so the SLO view (attainment + the
    firing/resolved alert audit trail) cannot rot against the
    alerter's live record schema without failing the selfcheck."""
    from .history import HistoryConfig, MetricsHistory
    from .registry import MetricsRegistry
    from .slo import LATENCY_METRIC, REQUESTS_METRIC, BurnRateAlerter, SloSpec
    from ..utils.logger import Logger

    jsonl = os.path.join(root, "selfcheck_slo_metrics.jsonl")
    log = Logger(os.path.join(root, "selfcheck_slo_log.txt"),
                 echo=False, jsonl_path=jsonl)
    reg = MetricsRegistry()
    lat = reg.histogram(LATENCY_METRIC, labels=("model",))
    req = reg.counter(REQUESTS_METRIC, labels=("model", "outcome"))
    hist = MetricsHistory(reg, HistoryConfig(
        sample_interval_s=1.0, rings=((1.0, 600),)))
    spec = SloSpec(model="slo_demo", latency_ms=50.0, availability=0.99,
                   window_s=120.0, fast_burn=8.0, fast_window_s=10.0,
                   fast_confirm_s=2.0, slow_burn=2.0, slow_window_s=60.0,
                   slow_confirm_s=10.0)
    alerter = BurnRateAlerter(hist, [spec], registry=reg, logger=log)
    t0 = time.time()
    try:
        for i in range(45):
            burning = 15 <= i < 30
            for _ in range(20):
                lat.observe(0.2 if burning else 0.005, model="slo_demo")
                req.inc(model="slo_demo",
                        outcome="failed" if burning else "ok")
            hist.sample_now(now=t0 + i)
            alerter.evaluate(now=t0 + i)
    finally:
        log.close()
    return jsonl


def _selfcheck_batch_jsonl(root: str, device: str) -> str:
    """Run a tiny real `sparknet-batch` job (a lenet replica on `device`
    behind a binary frontend, an 8-row npz swept as
    tenant=batch/priority=low) and return the driver JSONL it wrote — so
    the batch view (unit commits, retry trail, the rows/s +
    cost-per-million job summary) cannot rot against the driver's live
    record schema without failing the selfcheck."""
    import numpy as np

    from ..batch import BatchConfig, BatchDriver
    from ..net_api import TorchNet
    from ..serve import BinaryFrontend, InferenceServer, ServeConfig
    from ..zoo import lenet

    jsonl = os.path.join(root, "selfcheck_batch_metrics.jsonl")
    r = np.random.default_rng(0)
    inp = os.path.join(root, "selfcheck_batch_input.npz")
    np.savez(inp, data=r.standard_normal(
        (8, 28, 28, 1)).astype(np.float32))
    cfg = ServeConfig(max_batch=4, max_wait_ms=2.0, buckets=(1, 4),
                      outputs=("prob",), metrics_every_batches=0)
    with InferenceServer(TorchNet(lenet(batch=4), device=device),
                         cfg) as srv:
        fe = BinaryFrontend(srv, port=0)
        try:
            BatchDriver(BatchConfig(
                input=inp,
                output=os.path.join(root, "selfcheck_batch_out"),
                replicas=[f"{fe.address[0]}:{fe.address[1]}"],
                outputs=("fc1",), unit_rows=4, window=4,
                concurrency=1, cost_per_replica_hour=1.0,
                jsonl_path=jsonl)).run()
        finally:
            fe.stop()
    return jsonl


def _selfcheck_fleet_jsonl(root: str, device: str) -> str:
    """Run a tiny live ModelRouter (lenet on `device`) under a
    FleetController with an in-process replica provider, push a burning
    latency window through the policy, and return the fleet JSONL it
    wrote — so the fleet view (scale-event audit + replica-count-over-
    time) cannot rot against the controller's live record schema without
    failing the selfcheck."""
    from dataclasses import replace as dc_replace

    import numpy as np

    from ..fleet import (FleetConfig, FleetController, FleetPolicy,
                         ReplicaHandle, ReplicaProvider)
    from ..net_api import TorchNet
    from ..serve import (BinaryFrontend, InferenceServer, ModelRouter,
                         RouterConfig, ServeConfig)
    from ..utils.logger import Logger
    from ..zoo import lenet

    jsonl = os.path.join(root, "selfcheck_fleet_metrics.jsonl")
    log = Logger(os.path.join(root, "selfcheck_fleet_log.txt"),
                 echo=False, jsonl_path=jsonl)
    cfg = ServeConfig(max_batch=4, max_wait_ms=2.0, buckets=(1, 4),
                      outputs=("prob",), slo_p99_ms=50.0,
                      metrics_every_batches=0)

    class InProcessProvider(ReplicaProvider):
        def __init__(self):
            self.spawned = []

        def grow(self, model):
            srv = InferenceServer(TorchNet(lenet(batch=4), device=device),
                                  dc_replace(cfg, model_name=model))
            srv.start()
            fe = BinaryFrontend(srv, port=0)
            self.spawned.append((srv, fe))
            return ReplicaHandle(
                model, f"spkn://{fe.address[0]}:{fe.address[1]}")

        def retire(self, handle):
            pass

        def stop(self):
            for srv, fe in self.spawned:
                fe.stop()
                srv.stop()

    provider = InProcessProvider()
    router = ModelRouter(RouterConfig(workers=1), logger=log)
    router.add_model("fleet_demo", TorchNet(lenet(batch=4), device=device),
                     cfg=cfg)
    fc = FleetController(
        router, provider=provider,
        cfg=FleetConfig(interval_s=0.05, window_s=30.0, max_replicas=2,
                        up_cooldown_s=0.0, status_row_every=1,
                        policy=FleetPolicy(up_ticks=2, min_window_n=8)),
        logger=log)
    r = np.random.default_rng(0)
    req = {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}
    try:
        with router:
            router.infer("fleet_demo", req, timeout=60.0)
            for _ in range(32):  # a tail 4x over the 50 ms objective
                router.latency["fleet_demo"].add(0.2)
            fc.tick()
            fc.tick()  # hysteresis satisfied -> grow + audit row
            router.infer("fleet_demo", req, timeout=60.0)
            fc.stop()
    finally:
        provider.stop()
        log.close()
    return jsonl


def _selfcheck_serve_jsonl(root: str, device: str) -> str:
    """Run a tiny live InferenceServer (lenet on `device`) against a short
    synthetic request trace — watching a real checkpoint dir it initial-
    loads from and hot-swaps against — and return the serve metrics
    JSONL it wrote: the freshest possible serve schema, so the
    request-size-histogram section (the `--buckets-from` input) AND the
    freshness view (commit-age rows from commit_ts-stamped checkpoints)
    cannot rot against the live logger without failing the selfcheck."""
    import numpy as np

    from ..model.net import params_to_jax
    from ..net_api import TorchNet
    from ..serve import InferenceServer, ServeConfig
    from ..utils import checkpoint as ckpt
    from ..utils.logger import Logger
    from ..zoo import lenet

    jsonl = os.path.join(root, "selfcheck_serve_metrics.jsonl")
    log = Logger(os.path.join(root, "selfcheck_serve_log.txt"),
                 echo=False, jsonl_path=jsonl)
    net = TorchNet(lenet(batch=4), device=device)
    ck = os.path.join(root, "selfcheck_serve_ckpt")

    def save_step(step):
        ckpt.save(ck, {"params": params_to_jax(net.net, net.params)},
                  step=step)

    save_step(1)  # initial load: freshness rows from the first batch on
    cfg = ServeConfig(max_batch=4, max_wait_ms=2.0, buckets=(1, 4),
                      outputs=("prob",), metrics_every_batches=1,
                      checkpoint_dir=ck, poll_interval_s=0.05,
                      poll_jitter=0.0)
    r = np.random.default_rng(0)
    req = {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}
    try:
        with InferenceServer(net, cfg, logger=log) as srv:
            srv.infer(req)                     # a size-1 batch
            save_step(2)                       # a commit lands mid-serve
            # force one due poll (deterministic: no sleep-for-the-duty)
            srv.manager.poll(now=time.monotonic() + 1.0)
            for f in [srv.submit(req) for _ in range(4)]:  # a size-4 one
                f.result(timeout=60.0)
    finally:
        log.close()
    return jsonl


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="sparknet-metrics",
        description="Summarize sparknet_tpu metrics JSONL files: loss "
                    "curve, step-time breakdown, health-event audit trail.")
    p.add_argument("paths", nargs="*", help="metrics JSONL file(s); "
                   "multiple files merge on the wall-clock ts field")
    p.add_argument("--tail", type=int, default=10,
                   help="rows of loss/eval tail to show (default 10)")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as one JSON object")
    p.add_argument("--selfcheck", action="store_true",
                   help="run a 3-round synthetic training and summarize "
                   "its fresh JSONL (CI: the tool vs the live schema)")
    p.add_argument("--selfcheck-workers", type=int, default=1,
                   metavar="N",
                   help="with --selfcheck: run N worker trainings and "
                   "summarize the merged JSONLs — fails unless the pod "
                   "view (per-worker breakdown + straggler audit) "
                   "appears for N >= 2")
    p.add_argument("--keep", metavar="DIR", default=None,
                   help="with --selfcheck: write the selfcheck JSONL + "
                   "trace artifacts under DIR and keep them (CI uploads "
                   "these) instead of a deleted temp dir")
    p.add_argument("--device", default=None,
                   help="with --selfcheck: where its runs go (default: "
                   "the CUDA card; 'cpu' to run without one)")
    args = p.parse_args(argv)

    paths: List[str] = []
    for pat in args.paths:
        hits = sorted(glob.glob(pat))
        paths.extend(hits or [pat])
    selfcheck_dir = None
    if args.selfcheck:
        jsonls = _selfcheck_jsonl(args.selfcheck_workers,
                                  out_dir=args.keep, device=args.device)
        if args.keep is None:
            selfcheck_dir = os.path.dirname(jsonls[0])
        paths.extend(jsonls)
    if not paths:
        p.error("no JSONL paths given (or use --selfcheck)")

    try:
        recs = load_records(paths)
    finally:
        if selfcheck_dir is not None:  # the run was only food for the
            shutil.rmtree(selfcheck_dir, ignore_errors=True)  # summary
    s = summarize(recs, tail=args.tail)
    if args.json:
        print(json.dumps(s))
    else:
        print(format_text(s))
    if args.selfcheck and not s["rounds"]:
        print("selfcheck: training produced no loss rows", file=sys.stderr)
        return 1
    if args.selfcheck and args.selfcheck_workers > 1 and "pod" not in s:
        print("selfcheck: multi-worker run produced no pod view",
              file=sys.stderr)
        return 1
    if args.selfcheck and not (s.get("serve") or {}).get("models"):
        print("selfcheck: serve run produced no request-size histogram "
              "(the --buckets-from input)", file=sys.stderr)
        return 1
    if args.selfcheck and not (s.get("freshness") or {}).get("models"):
        print("selfcheck: serve run produced no freshness rows (the "
              "train->serve commit-age view's input)", file=sys.stderr)
        return 1
    if args.selfcheck and not (s.get("fleet") or {}).get("scale_events"):
        print("selfcheck: fleet run produced no scale-event audit "
              "(the fleet view's input)", file=sys.stderr)
        return 1
    if args.selfcheck and not (s.get("batch") or {}).get("units"):
        print("selfcheck: batch run produced no unit-commit rows "
              "(the batch view's input)", file=sys.stderr)
        return 1
    if args.selfcheck and not (s.get("slo") or {}).get("alert_edges"):
        print("selfcheck: burn drive produced no slo_alert edges "
              "(the SLO view's input)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
