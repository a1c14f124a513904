"""The batch job's resumable work-unit manifest.

Commit protocol (the sharded-checkpoint writers' manifest-LAST rule,
utils/checkpoint.py, generalized to a long-running job):

  1. a unit's rows are computed and its `part-<uid>.npz` is written
     ATOMICALLY (store.write_bytes: bucket finalize / local
     temp+rename);
  2. only then is the unit recorded in `MANIFEST.json`, itself
     rewritten atomically.

So the manifest is always a TRUE inventory: every unit it lists has a
complete part object behind it. A driver killed -9 between (1) and (2)
leaves an orphan part — the resume pass treats the manifest as the only
authority, redoes that unit, and the atomic rewrite of the part makes
the redo invisible (never a torn row, never a doubled one). Units are
disjoint row ranges of the input, so "every manifest unit exactly once"
IS row-level exactly-once.

The manifest also pins the job's IDENTITY (input url, row count, unit
size, model, output blobs): a resume against a different input or plan
must fail loudly, not silently interleave two jobs' rows.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from . import store

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1


def plan_units(n_rows: int, unit_rows: int) -> List[Tuple[int, int]]:
    """Disjoint [start, stop) row ranges covering the input (the
    member-index split: contiguous, last unit ragged)."""
    if n_rows <= 0:
        raise ValueError(f"n_rows must be > 0 (got {n_rows})")
    if unit_rows <= 0:
        raise ValueError(f"unit_rows must be > 0 (got {unit_rows})")
    return [(lo, min(lo + unit_rows, n_rows))
            for lo in range(0, n_rows, unit_rows)]


def part_name(uid: int) -> str:
    return f"part-{uid:05d}.npz"


def new_manifest(job_id: str, input_url: str, n_rows: int,
                 unit_rows: int, model: str,
                 outputs: Tuple[str, ...]) -> Dict[str, Any]:
    units = plan_units(n_rows, unit_rows)
    return {
        "version": MANIFEST_VERSION,
        "job_id": job_id,
        "input": input_url,
        "n_rows": int(n_rows),
        "unit_rows": int(unit_rows),
        "n_units": len(units),
        "model": model,
        "outputs": list(outputs),
        "done": False,
        # uid (as str: JSON keys) -> completion record; ABSENT = pending
        "units": {},
    }


def save_manifest(out_dir: str, m: Dict[str, Any]) -> None:
    data = json.dumps(m, indent=1, sort_keys=True).encode()
    store.write_bytes(store.join(out_dir, MANIFEST_NAME), data)


def load_manifest(out_dir: str) -> Optional[Dict[str, Any]]:
    url = store.join(out_dir, MANIFEST_NAME)
    if not store.exists(url):
        return None
    m = json.loads(store.read_bytes(url).decode())
    if m.get("version") != MANIFEST_VERSION:
        raise ValueError(
            f"manifest {url} has version {m.get('version')!r}; this "
            f"driver speaks {MANIFEST_VERSION}")
    return m


def check_resume(m: Dict[str, Any], input_url: str, n_rows: int,
                 unit_rows: int, model: str,
                 outputs: Tuple[str, ...]) -> None:
    """A resume must be the SAME job: same input identity and the same
    unit plan. Anything else would interleave two jobs' rows under one
    manifest — fail loudly instead."""
    want = {"input": input_url, "n_rows": int(n_rows),
            "unit_rows": int(unit_rows), "model": model,
            "outputs": list(outputs)}
    got = {k: m.get(k) for k in want}
    if got != want:
        diffs = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise ValueError(
            f"manifest does not match this job (resume would mix "
            f"outputs); differing fields (manifest, requested): {diffs}")


def pending_units(m: Dict[str, Any]) -> List[Tuple[int, int, int]]:
    """(uid, start, stop) for every unit the manifest does NOT record
    as complete — the resume worklist."""
    done = set(int(k) for k in m["units"])
    return [(uid, lo, hi)
            for uid, (lo, hi) in enumerate(
                plan_units(m["n_rows"], m["unit_rows"]))
            if uid not in done]


def record_unit(m: Dict[str, Any], uid: int, lo: int, hi: int,
                nbytes: int, replica: str, attempts: int) -> None:
    m["units"][str(uid)] = {
        "start": int(lo), "stop": int(hi), "rows": int(hi - lo),
        "part": part_name(uid), "bytes": int(nbytes),
        "replica": replica, "attempts": int(attempts),
    }
    if len(m["units"]) == m["n_units"]:
        m["done"] = True
