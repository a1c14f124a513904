"""Distributed per-request tracing: context propagation, tail-sampled
span capture, and cross-process trace assembly.

A copy of `sparknet_tpu/obs/reqtrace.py` (pure Python): the port imports
nothing of the JAX package. The port's HTTP frontend begins and finishes
the request records and echoes `X-Trace-Id`; the server's worker emits
the `queue`, `form`, `forward` and `depad` stages. The binary wire, the
router's proxy and hedge legs, and the live two-process selfcheck (it
drives the binary frontend) arrive with ROADMAP A10; the CLI's
`--selfcheck` raises NotImplementedError until then. Assemble shards with
`python -m sparknet_tpu_torch.obs.reqtrace SHARD_DIR ...`.

`obs/trace.py` answers "where did THIS PROCESS's wall clock go"; nothing
answered "why was THIS REQUEST 40 ms" once a request crosses the router,
a hedged leg, an `spkn://` proxy hop, or the shm transport. This module
is that layer, in the Dapper tradition:

  - **TraceContext** — a compact identity (trace_id + span id + sampling
    flag + an optional hedge-leg tag) minted at the front doors, carried
    as the `X-Trace-Id` header on HTTP and a `trace` str8 field in the
    binary REQUEST meta (wire VERSION 4), and re-encoded per hop: every
    downstream leg gets a CHILD context (fresh span id, same trace_id),
    so a client-side wire span and the server-side request it produced
    share a span id ACROSS processes — that equality is the join key
    assembly uses to stitch shards and normalize clocks.
  - **RequestTracer** — the per-process capture buffer. Library code
    emits stage spans (`queue`, `form`, `forward`, `wire:binary`, ...)
    keyed by trace_id; when the owning record finishes, a TAIL-based
    sampling decision runs: always capture typed sheds/errors and
    requests beyond the live windowed p95 (per model, the hedging
    window's own `LatencyStats`), plus a small probabilistic
    head-sample minted into the context itself so every hop agrees.
    Buffers are bounded with explicit drop counters (a span flood must
    not OOM the host to produce a trace), flushed as JSONL shards —
    the obs stack's format. Cost when tracing is off: one module-global
    None-check (the same <= 2% budget rule as `obs.trace`).
  - **Assembly** — `python -m sparknet_tpu_torch.obs.reqtrace shard...
    [--out DIR]` merges shards
    from N processes, aligns per-process clocks on the wire hop (the
    client span and the server request row it matches should share a
    midpoint — epoch-anchored clocks make the residual offset small,
    the hop alignment makes it zero), and emits one Chrome trace per
    trace_id plus a slowest-requests table with the
    queue / formation / forward / wire breakdown.

Timestamps are epoch-anchored microseconds (`epoch_at_start +
perf_counter`), the same scheme as `obs.trace.Tracer`, so shards from
processes that never exchanged a request still land on one timeline.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import random
import socket
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

# LatencyStats is imported where it is constructed, as in the JAX package,
# so that importing this module never pulls in the meters.

# -- trace context -----------------------------------------------------------

_HEX = set("0123456789abcdef")


@dataclass(frozen=True)
class TraceContext:
    """The identity one request carries across every hop.

    `encoded()` is the exact string that rides the wire (both wires):
    ``<trace_id 16hex>-<span_id 8hex>-<0|1>[-<leg>]`` — trace identity,
    THIS hop's span id, the head-sample flag, and the hedge-leg tag
    (`primary` / `hedge`) when the router armed a second leg."""

    trace_id: str
    span_id: str
    sampled: bool = False
    leg: str = ""

    def child(self, leg: Optional[str] = None) -> "TraceContext":
        """A downstream hop: fresh span id, same trace identity. The leg
        tag is inherited unless overridden — a hedge leg's proxy call is
        still the hedge leg."""
        return replace(self, span_id=os.urandom(4).hex(),
                       leg=self.leg if leg is None else str(leg))

    def encoded(self) -> str:
        s = f"{self.trace_id}-{self.span_id}-{1 if self.sampled else 0}"
        return f"{s}-{self.leg}" if self.leg else s


def mint_context(sampled: bool = False, leg: str = "") -> TraceContext:
    return TraceContext(trace_id=os.urandom(8).hex(),
                        span_id=os.urandom(4).hex(),
                        sampled=bool(sampled), leg=leg)


def parse_context(s: Any) -> Optional[TraceContext]:
    """Tolerant decode of the wire form; a malformed header is ignored
    (None), never an error — tracing must not be able to shed traffic."""
    if isinstance(s, TraceContext):
        return s
    if not s or not isinstance(s, str):
        return None
    parts = s.strip().split("-", 3)
    if len(parts) < 3:
        return None
    tid, sid, flag = parts[0].lower(), parts[1].lower(), parts[2]
    if not (0 < len(tid) <= 32 and set(tid) <= _HEX):
        return None
    if not (0 < len(sid) <= 16 and set(sid) <= _HEX):
        return None
    if flag not in ("0", "1"):
        return None
    leg = parts[3][:16] if len(parts) > 3 else ""
    return TraceContext(trace_id=tid, span_id=sid, sampled=flag == "1",
                        leg=leg)


def ctx_str(trace: Any) -> Optional[str]:
    """Normalize a context-or-encoded-string to the wire string (None
    passes through): what the transports call at pack time."""
    if trace is None:
        return None
    if isinstance(trace, TraceContext):
        return trace.encoded()
    return str(trace)


#: exception class name -> typed outcome string on the request row.
#: Matched by NAME walking the MRO so this module never imports the serve
#: stack (which imports this module).
_OUTCOMES = {
    "QueueFullError": "queue_full",
    "PriorityShedError": "priority",
    "TenantLimitError": "tenant_limit",
    "DeadlineExpiredError": "deadline",
    "RequestCancelledError": "cancelled",
    "NoReplicaError": "no_replica",
    "UnknownModelError": "unknown_model",
    "WireError": "bad_request",
    "TimeoutError": "timeout",
    "ConnectionError": "connection",
}


def outcome_of(exc: BaseException) -> str:
    for klass in type(exc).__mro__:
        if klass.__name__ in _OUTCOMES:
            return _OUTCOMES[klass.__name__]
    return "error"


# -- per-process capture -----------------------------------------------------

class RequestTracer:
    """Bounded per-process request-span buffer with tail-based sampling.

    The protocol library code follows (all methods thread-safe):

      rec = rt.begin(ctx, transport="binary", model=m)   # request owner
      rt.stage(ctx, "queue", t0_us, dur_us, bucket=4)    # any thread
      rt.finish(rec, outcome="ok")                       # decide+drain

    `stage()` rows park in a pending dict keyed by trace_id; `finish()`
    pops them and applies the capture rule — `outcome != "ok"` (typed
    sheds and errors), total latency beyond the live windowed p95 for
    that model, or the context's head-sample flag. Captured rows append
    to a bounded shard buffer (overflow counted in `dropped_rows`, never
    blocking) and auto-flush to `out_dir/trace-<proc>.jsonl`. The minted
    head-sample rate travels IN the context, so downstream processes
    capture the same requests without coordinating rates."""

    def __init__(self, out_dir: Optional[str] = None,
                 head_sample: float = 0.01,
                 slow_quantile: float = 0.95, slow_window_s: float = 30.0,
                 slow_min_n: int = 8,
                 max_pending: int = 8192, max_rows: int = 200_000,
                 flush_every: int = 512, exemplar_keep: int = 8,
                 proc: Optional[str] = None, seed: Optional[int] = None):
        self.out_dir = out_dir
        self.head_sample = float(head_sample)
        self.slow_quantile = float(slow_quantile)
        self.slow_window_s = float(slow_window_s)
        #: observations a model needs before "beyond p95" can trigger —
        #: with 3 samples the p95 IS the max and every new max would
        #: capture; the guard keeps warmup from reading as a tail
        self.slow_min_n = int(slow_min_n)
        self.max_pending = int(max_pending)
        self.max_rows = int(max_rows)
        self.flush_every = int(flush_every)
        self.pid = os.getpid()
        self.proc = proc or f"{socket.gethostname()}:{self.pid}"
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # trace_id -> parked span rows (insertion-ordered: overflow
        # evicts the OLDEST trace's spans, with accounting)
        self._pending: Dict[str, List[dict]] = {}
        self._pending_n = 0
        self._rows: List[dict] = []
        self._lat: Dict[str, LatencyStats] = {}   # model -> live window
        self._exemplars: Dict[str, deque] = {}
        self.exemplar_keep = int(exemplar_keep)
        self.captured = 0       # requests captured (rows written)
        self.finished = 0       # requests that reached a decision
        self.dropped_spans = 0  # stage rows lost to the pending bound
        self.dropped_rows = 0   # captured rows lost to the shard bound
        # epoch-anchored monotonic clock, same scheme as obs.trace.Tracer
        self._epoch0 = time.time() - time.perf_counter()

    # -- clocks ------------------------------------------------------------

    def now_us(self) -> float:
        return (self._epoch0 + time.perf_counter()) * 1e6

    def to_us(self, perf_t: float) -> float:
        """A stored `time.perf_counter()` instant (e.g. a request's
        `t_enqueue`) on the epoch-anchored scale."""
        return (self._epoch0 + perf_t) * 1e6

    # -- mint / emit -------------------------------------------------------

    def mint(self, sampled: Optional[bool] = None) -> TraceContext:
        if sampled is None:
            sampled = self._rng.random() < self.head_sample
        return mint_context(sampled=sampled)

    def begin(self, ctx: TraceContext, transport: str = "",
              model: str = "", root: bool = True) -> dict:
        return {"ctx": ctx, "transport": str(transport),
                "model": str(model or ""), "root": bool(root),
                "ts": self.now_us()}

    def stage(self, ctx: Optional[TraceContext], name: str,
              t0_us: float, dur_us: float, kind: str = "server",
              **attrs: Any) -> None:
        """Park one span row under the request's trace_id; it is only
        kept if the owning record's `finish()` decides to capture."""
        if ctx is None:
            return
        row: Dict[str, Any] = {
            "k": "s", "trace": ctx.trace_id, "span": ctx.span_id,
            "name": str(name), "kind": kind,
            "ts": round(t0_us, 3), "dur": round(max(0.0, dur_us), 3),
            "pid": self.pid, "proc": self.proc}
        if ctx.leg:
            row["leg"] = ctx.leg
        if attrs:
            row["attrs"] = attrs
        with self._lock:
            while self._pending_n >= self.max_pending and self._pending:
                # evict the oldest trace's parked spans wholesale: a span
                # flood from one runaway trace must not pin the buffer
                old = next(iter(self._pending))
                n = len(self._pending.pop(old))
                self._pending_n -= n
                self.dropped_spans += n
            self._pending.setdefault(ctx.trace_id, []).append(row)
            self._pending_n += 1

    def finish(self, rec: Optional[dict], outcome: str = "ok") -> bool:
        """Close the record, decide capture, drain its parked spans.
        Returns whether the request was captured."""
        if rec is None:
            return False
        ctx: TraceContext = rec["ctx"]
        end = self.now_us()
        dur_us = max(0.0, end - rec["ts"])
        with self._lock:
            spans = self._pending.pop(ctx.trace_id, [])
            self._pending_n -= len(spans)
            lat = self._lat.get(rec["model"])
            if lat is None:
                from ..utils.metrics import LatencyStats
                lat = self._lat[rec["model"]] = LatencyStats(window=2048)
        # the threshold is read BEFORE adding this observation: "beyond
        # the live p95" means beyond the distribution as it stood
        thr = lat.windowed_quantile(self.slow_quantile, self.slow_window_s)
        slow = (thr is not None and lat.count >= self.slow_min_n
                and dur_us / 1e6 > thr)
        lat.add(dur_us / 1e6)
        why = []
        if outcome != "ok":
            why.append("outcome")
        if slow:
            why.append("slow")
        if ctx.sampled:
            why.append("sampled")
        row: Dict[str, Any] = {
            "k": "r", "trace": ctx.trace_id, "span": ctx.span_id,
            "root": rec["root"], "model": rec["model"],
            "transport": rec["transport"], "outcome": str(outcome),
            "ts": round(rec["ts"], 3), "dur": round(dur_us, 3),
            "pid": self.pid, "proc": self.proc, "why": why}
        if ctx.leg:
            row["leg"] = ctx.leg
        stages: Dict[str, float] = {}
        for s in spans:
            stages[s["name"]] = round(
                stages.get(s["name"], 0.0) + s["dur"] / 1e3, 3)
        row["stages"] = stages
        captured = bool(why)
        need_flush = None
        with self._lock:
            self.finished += 1
            if captured:
                add = spans + [row]
                if len(self._rows) + len(add) > self.max_rows:
                    self.dropped_rows += len(add)
                    captured = False
                else:
                    self._rows.extend(add)
                    self.captured += 1
                    ex = self._exemplars.get(rec["model"])
                    if ex is None:
                        ex = self._exemplars[rec["model"]] = deque(
                            maxlen=self.exemplar_keep)
                    dominant = (max(stages, key=stages.get)
                                if stages else "-")
                    ex.append({"trace": ctx.trace_id,
                               "ms": round(dur_us / 1e3, 2),
                               "stage": dominant,
                               "outcome": str(outcome)})
            need_flush = (self.out_dir is not None
                          and len(self._rows) >= self.flush_every)
        if need_flush:
            self.flush()
        return captured

    def finish_exc(self, rec: Optional[dict], exc: BaseException) -> bool:
        return self.finish(rec, outcome=outcome_of(exc))

    # -- introspection / shards -------------------------------------------

    def exemplars(self) -> Dict[str, List[dict]]:
        """Per-model recent captured requests (newest last) — the
        `/status` and podview "slowest recent requests" feed."""
        with self._lock:
            return {m: list(d) for m, d in self._exemplars.items()}

    def worst(self, model: str) -> Optional[dict]:
        with self._lock:
            ex = list(self._exemplars.get(model, ()))
        return max(ex, key=lambda e: e["ms"]) if ex else None

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"finished": self.finished, "captured": self.captured,
                    "pending_spans": self._pending_n,
                    "buffered_rows": len(self._rows),
                    "dropped_spans": self.dropped_spans,
                    "dropped_rows": self.dropped_rows}

    def drain_rows(self) -> List[dict]:
        """Take the buffered rows without touching disk (tests, and the
        in-process assembly path)."""
        with self._lock:
            rows, self._rows = self._rows, []
        return rows

    def shard_path(self) -> Optional[str]:
        if self.out_dir is None:
            return None
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in self.proc)
        return os.path.join(self.out_dir, f"trace-{safe}.jsonl")

    def flush(self) -> Optional[str]:
        """Append buffered rows to this process's shard; returns the
        shard path (None when no out_dir is configured)."""
        path = self.shard_path()
        if path is None:
            return None
        rows = self.drain_rows()
        if not rows:
            return path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        return path


_active: Optional[RequestTracer] = None


def active() -> Optional[RequestTracer]:
    """The process-wide tracer, or None — the ONE check hot paths make."""
    return _active


def start_request_tracing(tracer: Optional[RequestTracer] = None,
                          **kw: Any) -> RequestTracer:
    global _active
    _active = tracer or RequestTracer(**kw)
    return _active


def stop_request_tracing() -> Optional[RequestTracer]:
    global _active
    t, _active = _active, None
    return t


@contextmanager
def request_tracing(out_dir: Optional[str] = None,
                    **kw: Any) -> Iterator[RequestTracer]:
    tr = start_request_tracing(out_dir=out_dir, **kw)
    try:
        yield tr
    finally:
        stop_request_tracing()
        tr.flush()


# -- assembly ----------------------------------------------------------------

def load_shards(paths: Iterable[str]) -> List[dict]:
    """Read trace rows from shard files and/or directories of
    `*.jsonl`. Tolerant: unreadable files and malformed lines skip."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(sorted(glob.glob(os.path.join(p, "*.jsonl"))))
        else:
            files.append(p)
    rows: List[dict] = []
    for fp in files:
        try:
            f = open(fp)
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if (isinstance(row, dict) and row.get("k") in ("r", "s")
                        and row.get("trace")):
                    rows.append(row)
    return rows


def group_traces(rows: Iterable[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for r in rows:
        out.setdefault(r["trace"], []).append(r)
    return out


def _mid(row: dict) -> float:
    return row["ts"] + row["dur"] / 2.0


def _req_by_span(trows: List[dict]) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for r in trows:
        if r["k"] == "r":
            out.setdefault(r["span"], r)
    return out


def wire_hops(trows: List[dict]) -> List[Tuple[dict, dict]]:
    """(client span, server request row) pairs that crossed a process
    boundary — the span-id equality is the hop: the client recorded its
    wait under the context it SENT, the server began its request row
    under the context it RECEIVED."""
    reqs = _req_by_span(trows)
    hops = []
    for s in trows:
        if s["k"] != "s" or s.get("kind") != "client":
            continue
        r = reqs.get(s["span"])
        if r is not None and r["proc"] != s["proc"]:
            hops.append((s, r))
    return hops


def _root_row(trows: List[dict]) -> dict:
    rrows = [r for r in trows if r["k"] == "r"]
    roots = [r for r in rrows if r.get("root")]
    pool = roots or rrows or trows
    return min(pool, key=lambda r: r["ts"])


def clock_offsets(trows: List[dict]) -> Dict[str, float]:
    """Per-process clock offsets (µs, added to that process's
    timestamps) normalizing every shard onto the ROOT process's clock.
    Each cross-process hop contributes one constraint: the client wire
    span and the server request row it matches describe the same
    interval minus symmetric network time, so their midpoints align.
    Offsets propagate hop-by-hop (BFS) from the root; processes no hop
    reaches keep their epoch-anchored clock (offset 0)."""
    offsets = {p: 0.0 for p in {r["proc"] for r in trows}}
    if not trows:
        return offsets
    # adjacency: proc -> [(peer, delta)] where off[peer] = off[proc] + d
    adj: Dict[str, List[Tuple[str, float]]] = {}
    for s, r in wire_hops(trows):
        d = _mid(s) - _mid(r)   # server clock lags client by d
        adj.setdefault(s["proc"], []).append((r["proc"], d))
        adj.setdefault(r["proc"], []).append((s["proc"], -d))
    root = _root_row(trows)["proc"]
    seen = {root}
    frontier = [root]
    while frontier:
        p = frontier.pop()
        for peer, d in adj.get(p, ()):
            if peer in seen:
                continue
            seen.add(peer)
            offsets[peer] = offsets[p] + d
            frontier.append(peer)
    return offsets


def chrome_trace(trace_id: str, trows: List[dict],
                 offsets: Optional[Dict[str, float]] = None) -> dict:
    """One Chrome trace object for one trace_id: a pid lane per process
    (request / server stages / client wire as tids), clock-normalized,
    zero-based."""
    if offsets is None:
        offsets = clock_offsets(trows)
    procs = sorted({r["proc"] for r in trows})
    pididx = {p: i for i, p in enumerate(procs)}

    def adj(row: dict) -> float:
        return row["ts"] + offsets.get(row["proc"], 0.0)

    base = min(adj(r) for r in trows) if trows else 0.0
    evs: List[dict] = []
    for p in procs:
        evs.append({"name": "process_name", "ph": "M", "pid": pididx[p],
                    "args": {"name": p}})
        for tid, nm in ((0, "request"), (1, "stages"),
                        (2, "wire (client)")):
            evs.append({"name": "thread_name", "ph": "M",
                        "pid": pididx[p], "tid": tid,
                        "args": {"name": nm}})
    for row in sorted(trows, key=adj):
        args: Dict[str, Any] = {"trace": trace_id}
        if row.get("leg"):
            args["leg"] = row["leg"]
        if row["k"] == "r":
            name = f"request {row.get('model') or '?'}"
            tid = 0
            args.update(model=row.get("model"),
                        transport=row.get("transport"),
                        outcome=row.get("outcome"),
                        stages=row.get("stages"), why=row.get("why"))
        else:
            name = row["name"]
            tid = 2 if row.get("kind") == "client" else 1
            if row.get("attrs"):
                args.update(row["attrs"])
        evs.append({"name": name, "ph": "X", "cat": "request",
                    "ts": round(adj(row) - base, 3),
                    "dur": round(row["dur"], 3),
                    "pid": pididx[row["proc"]], "tid": tid, "args": args})
    return {"traceEvents": evs, "displayTimeUnit": "ms",
            "otherData": {"trace_id": trace_id, "procs": procs}}


def trace_summary(trace_id: str, trows: List[dict],
                  offsets: Optional[Dict[str, float]] = None) -> dict:
    """The slowest-requests table row: total plus the queue / formation /
    forward / wire breakdown. Wire time is what the matched hop pairs
    prove — client wait minus the server's own request time; the rest of
    the total (decode, admission, de-pad, reply, scheduling) is
    `other_ms`."""
    root = _root_row(trows)
    stages: Dict[str, float] = {}
    for r in trows:
        if r["k"] != "r":
            continue
        for name, ms in (r.get("stages") or {}).items():
            stages[name] = stages.get(name, 0.0) + float(ms)
    hops = wire_hops(trows)
    wire_ms = sum(max(0.0, s["dur"] - r["dur"]) for s, r in hops) / 1e3
    total_ms = root["dur"] / 1e3
    br = {"queue": stages.get("queue", 0.0),
          "form": stages.get("form", 0.0),
          "forward": stages.get("forward", 0.0),
          "wire": wire_ms}
    dominant = max(br, key=br.get) if any(br.values()) else "-"
    other = max(0.0, total_ms - sum(br.values()))
    return {"trace": trace_id, "model": root.get("model") or "",
            "outcome": root.get("outcome") or "", "procs": len(
                {r["proc"] for r in trows}),
            "total_ms": round(total_ms, 3),
            "queue_ms": round(br["queue"], 3),
            "form_ms": round(br["form"], 3),
            "forward_ms": round(br["forward"], 3),
            "wire_ms": round(br["wire"], 3),
            "other_ms": round(other, 3), "dominant": dominant,
            "hops": len(hops), "rows": len(trows)}


def assemble(rows: List[dict]) -> Dict[str, dict]:
    """trace_id -> {rows, offsets, chrome, summary} for every trace in
    the merged shard rows."""
    out: Dict[str, dict] = {}
    for tid, trows in group_traces(rows).items():
        offs = clock_offsets(trows)
        out[tid] = {"rows": trows, "offsets": offs,
                    "chrome": chrome_trace(tid, trows, offs),
                    "summary": trace_summary(tid, trows, offs)}
    return out


def format_slowest(summaries: List[dict], top: int = 10) -> str:
    rows = sorted(summaries, key=lambda s: -s["total_ms"])[:top]
    hdr = (f"{'trace':<18} {'model':<10} {'outcome':<12} {'total':>9} "
           f"{'queue':>8} {'form':>8} {'forward':>8} {'wire':>8} "
           f"{'other':>8}  dominant")
    lines = [hdr, "-" * len(hdr)]
    for s in rows:
        lines.append(
            f"{s['trace']:<18} {s['model'][:10]:<10} "
            f"{s['outcome'][:12]:<12} {s['total_ms']:>8.2f}m "
            f"{s['queue_ms']:>7.2f}m {s['form_ms']:>7.2f}m "
            f"{s['forward_ms']:>7.2f}m {s['wire_ms']:>7.2f}m "
            f"{s['other_ms']:>7.2f}m  {s['dominant']}")
    return "\n".join(lines)



# -- console -----------------------------------------------------------------

def _selfcheck(keep: Optional[str] = None, delay_ms: float = 40.0) -> int:
    """The JAX package's live two-process proof drives a router in this
    process and a replica behind the binary frontend in a subprocess;
    neither is ported yet."""
    raise NotImplementedError(
        "the request-trace selfcheck drives the router and the binary "
        "frontend, which are not ported yet (ROADMAP A10)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparknet_tpu_torch.obs.reqtrace",
        description="Merge per-process request-trace shards, emit one "
                    "Chrome trace per trace_id, and print the "
                    "slowest-requests breakdown table.")
    ap.add_argument("shards", nargs="*",
                    help="trace shard files or directories of *.jsonl")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write trace-<id>.json Chrome traces here")
    ap.add_argument("--top", type=int, default=10,
                    help="slowest-requests rows to print (default 10)")
    ap.add_argument("--json", action="store_true",
                    help="print the summary table as JSON")
    ap.add_argument("--selfcheck", action="store_true",
                    help="live two-process capture+assembly proof (needs "
                    "the binary frontend: ROADMAP A10)")
    ap.add_argument("--keep", default=None, metavar="DIR",
                    help="selfcheck: keep artifacts under DIR")
    a = ap.parse_args(argv)
    if a.selfcheck:
        return _selfcheck(keep=a.keep)
    if not a.shards:
        ap.error("no shards given (or use --selfcheck)")
    rows = load_shards(a.shards)
    if not rows:
        print("no trace rows found", file=sys.stderr)
        return 1
    traces = assemble(rows)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        for tid, t in traces.items():
            with open(os.path.join(a.out, f"trace-{tid}.json"),
                      "w") as f:
                json.dump(t["chrome"], f)
        print(f"wrote {len(traces)} Chrome trace(s) to {a.out}")
    summaries = [t["summary"] for t in traces.values()]
    if a.json:
        print(json.dumps(sorted(summaries,
                                key=lambda s: -s["total_ms"])[:a.top]))
    else:
        print(f"{len(rows)} rows, {len(traces)} trace(s) — slowest:")
        print(format_slowest(summaries, top=a.top))
    return 0


if __name__ == "__main__":
    # `python -m sparknet_tpu_torch.obs.reqtrace` executes this file a
    # SECOND time as __main__ while the serve stack imports the package
    # copy: delegate to the canonical instance so both share `_active`
    from sparknet_tpu_torch.obs import reqtrace as _canonical
    sys.exit(_canonical.main())
