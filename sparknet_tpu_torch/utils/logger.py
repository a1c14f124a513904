"""Training logger: reference `libs/Logger.scala` parity plus structure.

The reference logged wall-clock-elapsed-prefixed lines to
`training_log_<millis>.txt`, flushed per line, with an optional iteration
index (`Logger.scala:5-18`). Same here, plus console echo and a JSONL twin
for machine-readable metrics (the reference's gap, SURVEY §5.5).
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Any, Dict, Optional


def _json_safe(v: Any) -> Any:
    """NaN/Inf serialize as null: json.dumps would emit bare NaN/Infinity
    tokens, which are outside RFC 8259 and break jq / pandas / non-Python
    consumers of the metrics JSONL (nonfinite rounds are now ROUTINELY
    logged by the health supervisor instead of crashing the run)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class Logger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 jsonl_path: Optional[str] = None,
                 worker: Optional[int] = None):
        self.t0 = time.time()
        self.echo = echo
        # worker id stamped on every JSONL record — the key that lets
        # `sparknet-metrics` group N merged per-worker files into the pod
        # view (per-worker breakdown, round skew, straggler audit). The
        # train loop fills it in on multi-host runs when the caller
        # didn't; single-process records stay byte-identical to before.
        self.worker = worker
        self._f = open(path, "a", buffering=1) if path else None
        self._jsonl = open(jsonl_path, "a", buffering=1) if jsonl_path else None

    def log(self, message: str, i: Optional[int] = None) -> None:
        """Elapsed-seconds-prefixed line (reference `logger.log(msg, i)`)."""
        elapsed = time.time() - self.t0
        suffix = f", iteration = {i}" if i is not None else ""
        line = f"[{elapsed:.3f}s] {message}{suffix}"
        if self._f:
            self._f.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr, flush=True)

    def metrics(self, step: int, **kv: Any) -> None:
        """One JSONL record: {"step": ..., "t": ..., "ts": ..., **metrics}.

        `t` is run-relative (human diffing within one file); `ts` is
        wall-clock epoch seconds, so JSONLs from different PROCESSES — a
        trainer, its serve fleet, the checkpoint writer's events — merge
        on one timeline (`sparknet-metrics a.jsonl b.jsonl` sorts on it,
        and it matches the trace timeline's epoch-anchored microseconds).
        """
        if self._jsonl:
            now = time.time()
            rec: Dict[str, Any] = {"step": step,
                                   "t": round(now - self.t0, 3),
                                   "ts": round(now, 3)}
            if self.worker is not None:
                rec["worker"] = int(self.worker)
            rec.update({k: _json_safe(float(v) if hasattr(v, "__float__")
                                      else v)
                        for k, v in kv.items()})
            self._jsonl.write(json.dumps(rec) + "\n")

    def event(self, step: int, event: str, **kv: Any) -> None:
        """A structured lifecycle event in BOTH channels: a human line in
        the text log and an {"event": ...} record in the metrics JSONL —
        the health supervisor's audit trail (spike_skip, rollback,
        anomalous_checkpoint, ...) must be machine-recoverable next to the
        loss curve it explains."""
        detail = " ".join(f"{k}={v}" for k, v in kv.items())
        self.log(f"[{event}] {detail}" if detail else f"[{event}]", step)
        self.metrics(step, event=event, **kv)

    def close(self) -> None:
        for f in (self._f, self._jsonl):
            if f:
                f.close()


def default_logger(workdir: Optional[str] = None, name: str = "training"
                   ) -> Logger:
    """Reference naming convention: training_log_<millis>.txt under the
    framework home (`apps/CifarApp.scala:51`)."""
    if workdir is None:
        workdir = os.environ.get("SPARKNET_TPU_HOME", ".")
    os.makedirs(workdir, exist_ok=True)
    ms = int(time.time() * 1000)
    return Logger(path=os.path.join(workdir, f"{name}_log_{ms}.txt"),
                  jsonl_path=os.path.join(workdir, f"{name}_metrics_{ms}.jsonl"))
