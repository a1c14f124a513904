"""Liveness heartbeat: one small JSON file, atomically replaced in place.

A copy of `sparknet_tpu/utils/heartbeat.py` (pure Python): the port
imports nothing of the JAX package, and both packages write and read one
schema, so either one's heartbeats feed the other's pod view and
membership controller. Bucket paths go through the port's own
`utils/checkpoint.py:_bucket_ops`.

A run that is alive but sick (every round classified anomalous, the
rollback budget draining) and a run that is merely slow look the same
from process exit codes until the log is parsed. The heartbeat file is
the machine-readable middle ground: the training loop rewrites it at the
flush cadence with the HealthMonitor's latest view, so one probe
(`read_heartbeat`) answers "is it making healthy progress" without
touching the logs.

Schema (one flat JSON object):
  t               epoch seconds of the beat (staleness = now - t)
  pid, role       writer identity; role is "train" or "serve"
  step            round index (train) / served checkpoint step (serve)
  status          "ok", or the latest anomaly classification ("spike",
                  "nonfinite", "rollback"), or a serve state ("degraded"
                  when the last swap attempt failed, "done" on exit)
  rollbacks       health rollbacks so far (train) / rejected or rolled-back
                  weight swaps (serve)
  ...             writer-specific extras (e.g. last_loss, queue_depth)

Writes are atomic (tmp file + os.replace in the same directory) so a
reader never sees a torn JSON, and throttled to `interval_s` except when
`force=True` (status CHANGES always deserve a beat — the whole point is
that "sick" shows up promptly).

`path` may also be a `gs://`/`s3://` URL: the beat becomes one small
object PUT through the same bucket writers checkpointing uses
(single-object writes are atomic on both stores), which is what lets a
POD write per-worker heartbeats to one shared prefix with no shared
filesystem — the pod aggregator (`obs/pod.py`) reads them back from
anywhere. Bucket PUTs run on a background thread with a latest-wins
one-slot queue: the caller is the training round loop, and an object-
store stall must cost it a dict handoff, not a client timeout (the same
off-the-critical-path rule the async checkpoint writer enforces).
`flush()` drains the slot (bounded wait) so a final "done" beat lands
before process exit.
"""
from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
import warnings
from typing import Any, Dict, Optional


def _is_bucket(path: str) -> bool:
    return isinstance(path, str) and path.startswith(("gs://", "s3://"))


class HeartbeatWriter:
    """Throttled atomic writer of the heartbeat schema above."""

    def __init__(self, path: str, role: str = "train",
                 interval_s: float = 10.0, registry=None):
        self.path = path
        self.role = role
        self.interval_s = float(interval_s)
        self._last_t = 0.0
        self._last_status: Optional[str] = None
        self._q: Optional["queue.Queue"] = None
        if _is_bucket(path):
            # latest-wins one-slot queue + daemon writer: a beat is a
            # dict handoff on the caller's (round-loop) thread; the PUT
            # and any store stall happen over here
            self._q = queue.Queue(maxsize=1)
            threading.Thread(target=self._drain_bucket,
                             name="heartbeat-write", daemon=True).start()
        else:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
        # registry mirror (obs): a scraper that cannot reach the file —
        # Prometheus across hosts — still sees beat freshness and status
        self._c_beats = self._g_ts = None
        if registry is not None:
            self._c_beats = registry.counter(
                "sparknet_heartbeat_beats_total",
                "heartbeat file writes", labels=("role",))
            self._g_ts = registry.gauge(
                "sparknet_heartbeat_timestamp_seconds",
                "epoch seconds of the last beat (staleness = now - this)",
                labels=("role",))

    def _drain_bucket(self) -> None:
        from .checkpoint import _bucket_ops
        ops = _bucket_ops(self.path)
        while True:
            rec = self._q.get()
            try:
                ops.write(self.path, json.dumps(rec).encode())
            except Exception as e:
                # best-effort by contract: a store blip drops this beat,
                # the next one overwrites anyway
                warnings.warn(f"heartbeat bucket write failed: {e}",
                              RuntimeWarning)
            finally:
                self._q.task_done()

    def flush(self, timeout_s: float = 5.0) -> None:
        """Bounded wait for the in-flight bucket PUT (exit paths: the
        final 'done' beat should land before the process dies). Local
        writes are synchronous — nothing to flush."""
        if self._q is None:
            return
        deadline = time.monotonic() + timeout_s
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.05)

    def beat(self, step: int, status: str = "ok", rollbacks: int = 0,
             force: bool = False, **extra: Any) -> bool:
        """Write one heartbeat; returns True when a write happened.
        Throttled to `interval_s` unless `force` or the status changed
        since the last write."""
        now = time.time()
        if (not force and status == self._last_status
                and now - self._last_t < self.interval_s):
            return False
        rec: Dict[str, Any] = {"t": round(now, 3), "pid": os.getpid(),
                               "role": self.role, "step": int(step),
                               "status": str(status),
                               "rollbacks": int(rollbacks)}
        rec.update(extra)
        if self._q is not None:
            # bucket path: hand the record to the writer thread, latest
            # wins — if a PUT is still in flight, the queued (older)
            # record is replaced rather than blocking the caller
            try:
                self._q.put_nowait(rec)
            except queue.Full:
                try:
                    self._q.get_nowait()
                    self._q.task_done()
                except queue.Empty:
                    pass
                try:
                    self._q.put_nowait(rec)
                except queue.Full:
                    pass  # raced a concurrent beater; their rec is newer
            self._last_t = now
            self._last_status = status
            if self._c_beats is not None:
                self._c_beats.inc(role=self.role)
                self._g_ts.set(now, role=self.role)
            return True
        d = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".hb-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._last_t = now
        self._last_status = status
        if self._c_beats is not None:
            self._c_beats.inc(role=self.role)
            self._g_ts.set(now, role=self.role)
        return True


def read_heartbeat(path: str) -> Optional[Dict[str, Any]]:
    """The current heartbeat dict, or None when the file is missing or
    torn (a torn read is impossible from HeartbeatWriter's atomic replace,
    but a foreign/partial file must not crash the prober). Accepts
    `gs://`/`s3://` URLs like the writer.

    The returned dict additionally carries `age_s` — seconds since the
    beat was written, computed at READ time — so every consumer (the
    launcher watch, the pod aggregator/podview, the elastic
    MembershipController) applies one staleness rule to one number
    instead of re-deriving it from `t` with its own clock arithmetic.
    `age_s` is None when the record has no `t` (foreign file)."""
    try:
        if _is_bucket(path):
            from .checkpoint import _bucket_ops
            hb = json.loads(_bucket_ops(path).read(path))
        else:
            with open(path) as f:
                hb = json.load(f)
    except (OSError, ValueError):
        return None
    except Exception:
        return None  # bucket client errors degrade like a missing file
    if not isinstance(hb, dict):
        return None
    try:
        hb["age_s"] = round(max(0.0, time.time() - float(hb["t"])), 3)
    except (KeyError, TypeError, ValueError):
        hb["age_s"] = None
    return hb


def staleness_s(hb: Optional[Dict[str, Any]]) -> Optional[float]:
    """Seconds since the beat was written, or None without a valid beat.
    Prefers the `age_s` read_heartbeat stamped (one clock read per probe);
    falls back to `t` for records obtained some other way."""
    if not hb:
        return None
    if hb.get("age_s") is not None:
        return float(hb["age_s"])
    if "t" not in hb:
        return None
    try:
        return max(0.0, time.time() - float(hb["t"]))
    except (TypeError, ValueError):
        return None


def worker_sort_key(w: str):
    """Numeric-first worker-id ordering ('2' < '10'; names after digits)
    — THE ordering elastic membership, τ expansion, and the pod view all
    share (one definition; divergence would silently misalign the
    membership order against the pod table)."""
    return (0, int(w)) if str(w).isdigit() else (1, str(w))
