"""`sparknet-batch` — the bulk-inference driver (module doc in
__init__.py; manifest/commit semantics in manifest.py).

Shape of a run:

  input npz (local / gs:// / s3://)
    -> ArrayDataset (aligned field check)
    -> work units: disjoint [start, stop) row ranges (manifest.plan_units)
    -> `concurrency` units in flight at once, each dispatched WHOLE to
       one replica over the binary transport: per-row requests
       pipelined `window` deep on one connection (the chunked
       CHUNK-frame path carries the replies), every request
       `tenant=batch`, `priority=low`, with the named output blobs
       riding the per-request outputs route (serve/server.py)
    -> part-<uid>.npz written atomically, THEN the manifest row
       (manifest-last: kill -9 anywhere resumes exactly-once)

Failure policy — the scavenger contract:

  - admission sheds (priority / tenant_limit / queue_full / deadline)
    are BACKPRESSURE, not failures: the unit backs off with full jitter
    and retries on the next replica, forever. Sustained pressure cannot
    strand the job because the fleet controller's batch-starvation
    relief (fleet/policy.py) re-opens the door within
    `batch_max_starvation_s`.
  - transport deaths (ConnectionError: a replica kill -9 mid-unit) and
    timeouts are RETRIES on a different replica, counted against
    `max_attempts` — a job fails only when every replica refuses a unit
    `max_attempts` times over.
"""
from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.dataset import ArrayDataset
from ..data.gcs import retry_delay
from ..obs import reqtrace
from ..obs.http import StatusServer
from ..obs.registry import MetricsRegistry
from ..serve.batcher import DeadlineExpiredError, QueueFullError
from ..serve.binary_frontend import BinaryClient
from ..utils.heartbeat import HeartbeatWriter
from ..utils.logger import Logger
from . import manifest as mf
from . import store

#: sheds that mean "not now", never "broken" — retried without limit.
#: QueueFullError covers its Priority/TenantLimit subtypes; a deadline
#: expiry on a low request IS the admission stack aging it out under
#: pressure, the same backpressure by another door.
BACKPRESSURE_ERRORS = (QueueFullError, DeadlineExpiredError)


@dataclass
class BatchConfig:
    """Knobs for one batch job (the `sparknet-batch` CLI mirrors
    these)."""

    input: str                      # npz url: local / gs:// / s3://
    output: str                     # output dir/prefix (parts+manifest)
    replicas: List[str]             # binary frontend addresses
    model: str = ""                 # "" = the replica's sole model
    outputs: Tuple[str, ...] = ()   # named blobs ("" -> lane default)
    unit_rows: int = 64             # rows per work unit
    window: int = 16                # pipelined requests per connection
    concurrency: int = 2            # units in flight across the fleet
    tenant: str = "batch"
    priority: str = "low"
    deadline_s: Optional[float] = 10.0   # per-request answer-by bound
    request_timeout_s: float = 30.0
    max_attempts: int = 6           # HARD failures per unit (not sheds)
    use_shm: bool = False           # spkn-shm to colocated replicas.
    # Off by default: a bulk driver is built to be kill -9'd, and every
    # killed connection would orphan a /dev/shm segment until the next
    # frontend sweep; the unit pipeline amortizes TCP fine.
    backoff_cap_s: float = 2.0      # full-jitter retry sleep ceiling
    pace_s: float = 0.0             # sleep between unit starts (chaos)
    job_id: Optional[str] = None    # default: derived fresh per job
    cost_per_replica_hour: float = 0.0   # $ -> cost_per_million
    jsonl_path: Optional[str] = None
    heartbeat_path: Optional[str] = None
    status_port: Optional[int] = None
    progress_every_units: int = 5

    def __post_init__(self) -> None:
        if not self.replicas:
            raise ValueError("at least one replica address is required")
        if self.unit_rows < 1 or self.window < 1 or self.concurrency < 1:
            raise ValueError(
                f"unit_rows/window/concurrency must be >= 1 (got "
                f"{self.unit_rows}, {self.window}, {self.concurrency})")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1 "
                             f"(got {self.max_attempts})")


class UnitFailedError(RuntimeError):
    """One work unit exhausted max_attempts across the fleet."""


class BatchDriver:
    """One job: plan -> dispatch -> commit, resumable (module doc)."""

    def __init__(self, cfg: BatchConfig,
                 registry: Optional[MetricsRegistry] = None,
                 logger: Optional[Logger] = None):
        self.cfg = cfg
        self.registry = registry or MetricsRegistry()
        self.log = logger if logger is not None else (
            Logger(echo=False, jsonl_path=cfg.jsonl_path)
            if cfg.jsonl_path else None)
        r = self.registry
        self._c_units = r.counter(
            "sparknet_batch_units_done_total",
            "work units completed and committed to the manifest")
        self._c_retries = r.counter(
            "sparknet_batch_units_retried_total",
            "unit dispatch retries by kind (shed = backpressure, "
            "error = transport death / timeout)", labels=("kind",))
        self._c_rows = r.counter(
            "sparknet_batch_rows_total",
            "embedding rows computed and committed")
        self._c_bytes = r.counter(
            "sparknet_batch_output_bytes_total",
            "bytes of committed part objects")
        self._g_inflight = r.gauge(
            "sparknet_batch_units_inflight",
            "work units currently dispatched to replicas")
        self._g_rows_per_s = r.gauge(
            "sparknet_batch_rows_per_s",
            "committed rows per second, job-aggregate")
        self._g_inflight.set(0)
        self._g_rows_per_s.set(0.0)
        self.heartbeat = (HeartbeatWriter(cfg.heartbeat_path,
                                          role="batch", interval_s=1.0,
                                          registry=r)
                          if cfg.heartbeat_path else None)
        self._status_http: Optional[StatusServer] = None
        self._lock = threading.Lock()   # manifest + counters
        self._inflight = 0
        self._t0 = 0.0
        self.units_done = 0             # committed THIS run
        self.units_skipped = 0          # already in the manifest
        self.rows_done = 0              # committed THIS run
        self.retries = 0
        self.output_bytes = 0
        self._stop = threading.Event()

    # -- input ---------------------------------------------------------------

    def _load_input(self) -> ArrayDataset:
        raw = store.read_bytes(self.cfg.input)
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        if not arrays:
            raise ValueError(f"input {self.cfg.input} holds no arrays")
        return ArrayDataset(arrays)

    # -- one unit ------------------------------------------------------------

    def _unit_rows_out(self, cli: BinaryClient, data: ArrayDataset,
                      lo: int, hi: int,
                      trace=None) -> Dict[str, np.ndarray]:
        """Dispatch one unit's rows pipelined on one connection; returns
        {blob: (rows, ...) array}. Raises on the FIRST failed row — the
        unit is the retry granule, a half-computed unit is never
        committed."""
        cfg = self.cfg
        rids: List[int] = []
        results: List[Optional[Dict[str, np.ndarray]]] = []
        nexti = lo
        while nexti < hi or rids:
            while nexti < hi and len(rids) < cfg.window:
                payload = {k: v[nexti] for k, v in data.arrays.items()}
                rids.append(cli.submit(
                    payload, model=cfg.model, deadline_s=cfg.deadline_s,
                    tenant=cfg.tenant, priority=cfg.priority,
                    stream=True,
                    outputs=(cfg.outputs or None),
                    # every row request is a child span of the unit's
                    # trace — one trace id per work unit, so the
                    # assembler reconstructs the whole unit's fan-out
                    trace=(trace.child() if trace is not None
                           else None)))
                nexti += 1
            results.append(cli.collect(rids.pop(0),
                                       timeout=cfg.request_timeout_s))
        n = hi - lo
        assert len(results) == n, (len(results), n)
        keys = sorted(results[0])
        if not keys:
            raise ValueError(
                "replica returned no output blobs (name --outputs "
                "explicitly, or configure the lane's outputs)")
        return {k: np.stack([r[k] for r in results]) for k in keys}

    def _run_unit(self, data: ArrayDataset, uid: int, lo: int,
                  hi: int) -> Tuple[str, int, int]:
        """Compute + commit one unit; returns (replica, attempts,
        nbytes). Rotates replicas per attempt; full-jitter backoff."""
        cfg = self.cfg
        hard_attempts = 0
        attempt = 0
        # one trace per work unit (the driver is a front door: it MINTS)
        rt = reqtrace.active()
        ctx = rec = None
        if rt is not None:
            ctx = rt.mint()
            rec = rt.begin(ctx, transport="batch", model=cfg.model)
        while True:
            if self._stop.is_set():
                if rec is not None:
                    rt.finish(rec, "cancelled")
                raise UnitFailedError(f"unit {uid}: driver stopping")
            addr = cfg.replicas[(uid + attempt) % len(cfg.replicas)]
            attempt += 1
            cli = None
            try:
                host, port = _parse_hostport(addr)
                cli = BinaryClient(host, port,
                                   timeout=cfg.request_timeout_s,
                                   use_shm=cfg.use_shm)
                out = self._unit_rows_out(cli, data, lo, hi, trace=ctx)
                buf = io.BytesIO()
                np.savez(buf, **out)
                raw = buf.getvalue()
                store.write_bytes(
                    store.join(cfg.output, mf.part_name(uid)), raw)
                if rec is not None:
                    rt.stage(ctx, "unit", rec["ts"],
                             rt.now_us() - rec["ts"], unit=uid,
                             rows=hi - lo, attempts=attempt)
                    rt.finish(rec, "ok")
                return addr, attempt, len(raw)
            except BACKPRESSURE_ERRORS as e:
                # shed, typed: the fleet is busy — the scavenger waits
                # its turn (jittered) and tries another replica. Does
                # NOT count against max_attempts.
                self._note_retry("shed", uid, addr, attempt, e)
            except (ConnectionError, TimeoutError, OSError) as e:
                # a dying/dead replica (kill -9 mid-unit lands here):
                # a retry, not a job failure — but bounded
                hard_attempts += 1
                self._note_retry("error", uid, addr, attempt, e)
                if hard_attempts >= cfg.max_attempts:
                    if rec is not None:
                        rt.finish_exc(rec, e)
                    raise UnitFailedError(
                        f"unit {uid} rows [{lo}, {hi}): "
                        f"{hard_attempts} hard failures across the "
                        f"fleet; last: {type(e).__name__}: {e}") from e
            finally:
                if cli is not None:
                    try:
                        cli.close()
                    except Exception:
                        pass
            time.sleep(min(retry_delay(min(attempt, 6)),
                           cfg.backoff_cap_s))

    def _note_retry(self, kind: str, uid: int, addr: str,
                    attempt: int, err: BaseException) -> None:
        self._c_retries.inc(kind=kind)
        with self._lock:
            self.retries += 1
        if self.log is not None:
            self.log.metrics(uid, event="batch_retry", unit=uid,
                             kind=kind, replica=addr, attempt=attempt,
                             error=f"{type(err).__name__}: {err}")

    # -- the job -------------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        cfg = self.cfg
        data = self._load_input()
        m = mf.load_manifest(cfg.output)
        if m is None:
            m = mf.new_manifest(
                cfg.job_id or f"batch-{uuid.uuid4().hex[:8]}",
                cfg.input, len(data), cfg.unit_rows, cfg.model,
                cfg.outputs)
            # the EMPTY manifest is written up front: an out dir with
            # parts but no manifest is indistinguishable from another
            # job's leavings, and resume must never guess
            mf.save_manifest(cfg.output, m)
        else:
            mf.check_resume(m, cfg.input, len(data), cfg.unit_rows,
                            cfg.model, cfg.outputs)
        pending = mf.pending_units(m)
        self.units_skipped = m["n_units"] - len(pending)
        self._t0 = time.monotonic()
        if self.cfg.status_port is not None:
            self._status_http = StatusServer(
                self.cfg.status_port, registry=self.registry,
                status=self.status)
        if self.heartbeat is not None:
            self.heartbeat.beat(0, status="ok", force=True,
                                job_id=m["job_id"],
                                units_total=m["n_units"],
                                units_done=len(m["units"]))
        try:
            if pending:
                with ThreadPoolExecutor(
                        max_workers=min(cfg.concurrency, len(pending)),
                        thread_name_prefix="batch-unit") as ex:
                    futs = []
                    for uid, lo, hi in pending:
                        if cfg.pace_s > 0:
                            time.sleep(cfg.pace_s)
                        futs.append(ex.submit(
                            self._dispatch, data, m, uid, lo, hi))
                    for f in futs:
                        f.result()  # first unit failure fails the job
        except BaseException:
            self._stop.set()  # stop queued units; in-flight ones drain
            raise
        finally:
            self._shutdown()
        return self._summary(m)

    def _dispatch(self, data: ArrayDataset, m: Dict[str, Any],
                  uid: int, lo: int, hi: int) -> None:
        if self._stop.is_set():
            raise UnitFailedError(f"unit {uid}: driver stopping")
        with self._lock:
            self._inflight += 1
            self._g_inflight.set(self._inflight)
        t0 = time.monotonic()
        try:
            addr, attempts, nbytes = self._run_unit(data, uid, lo, hi)
        finally:
            with self._lock:
                self._inflight -= 1
                self._g_inflight.set(self._inflight)
        dt = time.monotonic() - t0
        with self._lock:
            # part is on the store: NOW the manifest may say so
            # (manifest-last; a kill between the two redoes the unit)
            mf.record_unit(m, uid, lo, hi, nbytes, addr, attempts)
            mf.save_manifest(self.cfg.output, m)
            self.units_done += 1
            self.rows_done += hi - lo
            self.output_bytes += nbytes
            rows_per_s = self.rows_done / max(
                time.monotonic() - self._t0, 1e-9)
            done_total = len(m["units"])
        self._c_units.inc()
        self._c_rows.inc(hi - lo)
        self._c_bytes.inc(nbytes)
        self._g_rows_per_s.set(round(rows_per_s, 3))
        if self.log is not None:
            self.log.metrics(uid, event="batch_unit", unit=uid,
                             rows=hi - lo, replica=addr,
                             attempts=attempts, bytes=nbytes,
                             dt_s=round(dt, 4))
            if (self.cfg.progress_every_units and
                    done_total % self.cfg.progress_every_units == 0):
                self.log.metrics(done_total, event="batch_progress",
                                 units_done=done_total,
                                 units_total=m["n_units"],
                                 rows=self.rows_done,
                                 rows_per_s=round(rows_per_s, 3))
        if self.heartbeat is not None:
            self.heartbeat.beat(done_total, status="ok",
                                job_id=m["job_id"],
                                units_total=m["n_units"],
                                units_done=done_total,
                                rows_per_s=round(rows_per_s, 3))

    def _shutdown(self) -> None:
        if self._status_http is not None:
            self._status_http.stop()
            self._status_http = None

    def _summary(self, m: Dict[str, Any]) -> Dict[str, Any]:
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        rows_per_s = self.rows_done / elapsed
        n_rep = len(self.cfg.replicas)
        cost = (self.cfg.cost_per_replica_hour * n_rep
                * (elapsed / 3600.0))
        out = {
            "job_id": m["job_id"],
            "done": bool(m["done"]),
            "units_total": m["n_units"],
            "units_done": len(m["units"]),
            "units_this_run": self.units_done,
            "units_skipped_resume": self.units_skipped,
            "rows_total": m["n_rows"],
            "rows_this_run": self.rows_done,
            "elapsed_s": round(elapsed, 3),
            "rows_per_s": round(rows_per_s, 3),
            "img_per_s": round(rows_per_s, 3),   # rows ARE images here
            "retries": self.retries,
            "output_bytes": self.output_bytes,
            "replicas": n_rep,
            "cost_usd": round(cost, 6),
            "cost_per_million_embeddings": (
                round(cost / (self.rows_done / 1e6), 6)
                if self.rows_done else None),
        }
        if self.heartbeat is not None:
            try:
                self.heartbeat.beat(len(m["units"]), status="done",
                                    force=True, job_id=m["job_id"],
                                    units_total=m["n_units"],
                                    units_done=len(m["units"]))
                self.heartbeat.flush()
            except OSError:
                pass
        if self.log is not None:
            self.log.metrics(len(m["units"]), event="batch_done", **{
                k: v for k, v in out.items() if k != "job_id"},
                job_id=m["job_id"])
        return out

    def status(self) -> Dict[str, Any]:
        """The /status row (obs StatusServer)."""
        with self._lock:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            return {
                "role": "batch",
                "units_done": self.units_done,
                "units_skipped_resume": self.units_skipped,
                "units_inflight": self._inflight,
                "rows": self.rows_done,
                "rows_per_s": round(self.rows_done / elapsed, 3),
                "retries": self.retries,
                "output_bytes": self.output_bytes,
                "replicas": list(self.cfg.replicas),
            }


def _parse_hostport(addr: str) -> Tuple[str, int]:
    """'host:port' / 'spkn://host:port' -> (host, port)."""
    a = addr.split("://", 1)[-1].rstrip("/")
    host, _, port = a.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"replica address {addr!r} is not host:port")
    return host, int(port)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="sparknet-batch",
        description="bulk inference across the replica fleet as a "
                    "low-priority scavenger tenant (resumable; "
                    "manifest-last commit)")
    ap.add_argument("--input", required=True,
                    help="input npz (local / gs:// / s3://)")
    ap.add_argument("--out", required=True,
                    help="output dir/prefix for part-*.npz + "
                         "MANIFEST.json")
    ap.add_argument("--replicas", required=True,
                    help="comma-separated binary frontend addresses "
                         "(host:port or spkn://host:port)")
    ap.add_argument("--model", default="")
    ap.add_argument("--outputs", default="",
                    help="comma-separated blob names to extract "
                         "(e.g. the embedding layer); empty = lane "
                         "default outputs")
    ap.add_argument("--unit-rows", type=int, default=64)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--concurrency", type=int, default=2)
    ap.add_argument("--tenant", default="batch")
    ap.add_argument("--priority", default="low")
    ap.add_argument("--deadline-ms", type=float, default=10000.0)
    ap.add_argument("--timeout-s", type=float, default=30.0)
    ap.add_argument("--max-attempts", type=int, default=6)
    ap.add_argument("--pace-s", type=float, default=0.0,
                    help="sleep between unit starts (chaos windows)")
    ap.add_argument("--job-id", default=None)
    ap.add_argument("--cost-per-replica-hour", type=float, default=0.0)
    ap.add_argument("--jsonl", default=None)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--status-port", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = BatchConfig(
        input=args.input, output=args.out,
        replicas=[a for a in args.replicas.split(",") if a],
        model=args.model,
        outputs=tuple(o for o in args.outputs.split(",") if o),
        unit_rows=args.unit_rows, window=args.window,
        concurrency=args.concurrency, tenant=args.tenant,
        priority=args.priority,
        deadline_s=(args.deadline_ms / 1e3
                    if args.deadline_ms > 0 else None),
        request_timeout_s=args.timeout_s,
        max_attempts=args.max_attempts, pace_s=args.pace_s,
        job_id=args.job_id,
        cost_per_replica_hour=args.cost_per_replica_hour,
        jsonl_path=args.jsonl, heartbeat_path=args.heartbeat,
        status_port=args.status_port)
    out = BatchDriver(cfg).run()
    json.dump(out, sys.stdout, indent=1, sort_keys=True)
    sys.stdout.write("\n")
    return 0 if out["done"] else 1


if __name__ == "__main__":
    sys.exit(main())
