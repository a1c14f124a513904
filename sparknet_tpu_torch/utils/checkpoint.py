"""Checkpoint / resume: params + optimizer state + loop counter, on a local
directory or a bucket prefix (`gs://`, `s3://`).

The counterpart of `sparknet_tpu/utils/checkpoint.py` for its monolithic
layout, on the same on-disk format, so that each package restores the
other's steps:

  - `step-N/state.npz` — flattened tree leaves, keys are "/"-joined paths
    (`params/conv1/w`, `momentum/conv1/w`, `it`);
  - `step-N/meta.json` — {"step": N, "keys": [...], "digests": {key:
    sha256-hex}, "ext_dtypes": {key: "bfloat16"}, "extra": {...},
    "commit_ts": t}, written LAST: it is the commit marker.

A local save writes both files into a `.tmp-*` work directory and renames
it to `step-N`, so a reader sees a whole step or none. A bucket store
mirrors the layout (`<root>/step-N/{state.npz,meta.json}`) through the
port's own clients (`data/gcs.py`, `data/s3.py`): state.npz goes up
through the chunked writers (GCS resumable sessions and compose, S3
multipart), which make an object visible only when it is finalized, and
meta.json lands last, so an interrupted save is not-a-checkpoint there
too; reads take the ranged streams with reconnect-resume. Only a 404 on
a bucket means absent: an outage or an auth failure propagates.

`restore_flat` (auto-latest) falls back to the newest step that verifies; `retain` never
deletes the newest verified step, nor the newest verified non-anomalous
one (the rollback target). `AsyncCheckpointWriter` is stage 2 of the train
loop's two-stage save: one background thread serializes, digests and
persists while the loop trains on.

Trees are nested dicts; leaves are numpy arrays or CPU tensors. numpy
has no bfloat16, and `np.savez` would degrade one, so a bfloat16 leaf is
stored as its uint16 bit pattern with `ext_dtypes[key] = "bfloat16"` (the
reference's encoding) and comes back from a restore as a bfloat16 CPU
tensor, bit for bit. The view is done with torch, not `ml_dtypes`.

A step that is gone when it is read (no meta.json, or its state.npz and
meta.json deleted while it was read) raises `CheckpointVanishedError`, a
`CheckpointCorruptError`: the serving manager counts it as neither a
rejection nor a cooldown.

Not ported yet: a step in the per-shard layout (meta.json with
"shards") raises NotImplementedError naming the layout and ROADMAP A6b
when it is read — it is not reported as corrupt; the logical
(NamedSharding) layout.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import tempfile
import time
import urllib.error
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory exists but fails integrity verification
    (unreadable meta.json / state.npz, missing keys, or digest mismatch)."""


class CheckpointVanishedError(CheckpointCorruptError):
    """A listed step is gone by the time it is read: its meta.json commit
    marker is missing (retention-pruned, or never committed), or its
    state.npz went missing together with its meta.json. A subclass of
    CheckpointCorruptError, so every rollback and skip path still treats
    the step as not loadable, while a caller that reacts to corruption
    (the serving manager's rejected-swap cooldown) can tell "the bytes
    are bad" from "the step is gone"."""


# -- store plumbing: local directories vs gs://|s3:// bucket prefixes -------

def is_bucket_path(path: str) -> bool:
    return isinstance(path, str) and path.startswith(("gs://", "s3://"))


def _bucket_ops(path: str) -> SimpleNamespace:
    """The scheme-matched object operations (read / ranged stream / small
    atomic write / chunked-parallel large write / delete / list / stat)."""
    if path.startswith("gs://"):
        from ..data import gcs as m
        return SimpleNamespace(
            read=m.gs_read, open_stream=m.gs_open_stream,
            write=m.gs_write, write_large=m.gs_write_large,
            delete=m.gs_delete, list_urls=m.gs_list_urls,
            stat=m.gs_stat)
    from ..data import s3 as m
    return SimpleNamespace(
        read=m.s3_read, open_stream=m.s3_open_stream,
        write=m.s3_write, write_large=m.s3_write_large,
        delete=m.s3_delete, list_urls=m.s3_list_urls,
        stat=m.s3_stat)


def _join(directory: str, *names: str) -> str:
    if is_bucket_path(directory):
        return "/".join((directory.rstrip("/"),) + names)
    return os.path.join(directory, *names)


def _leaf_to_numpy(leaf: Any) -> Tuple[np.ndarray, Optional[str]]:
    """(array as savez stores it, "bfloat16" for a bf16 tensor or None)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.asarray(leaf), None


def _from_stored(arr: np.ndarray, name: str) -> Any:
    """A stored uint view back to its extension dtype: bfloat16 as a CPU
    tensor (no ml_dtypes needed), anything else through numpy."""
    if name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr.view(np.dtype(name))


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> {"a/b/c": leaf} in insertion order (the reference's
    `_flatten` key form)."""
    if isinstance(tree, Mapping):
        flat: Dict[str, Any] = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def _digest(arr: np.ndarray) -> str:
    """SHA-256 over the array's C-order bytes (the bytes savez writes)."""
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()


# -- process-local "last step I wrote and verified" cache --------------------
#
# retain()'s protect scan would re-read and re-hash the newest step on every
# save (on a bucket, a full ranged GET of state.npz). When that step is the
# one this process just wrote, its digests were computed from the bytes it
# handed to the store, which commits them all or nothing; the cache records
# the step with a fingerprint of its state.npz taken right after the write —
# local (size, mtime_ns), bucket (size, generation|ETag) — and retain()
# takes it as verified only while that fingerprint still matches. Anything
# that rewrites the object falls back to the full verify.
_written_verified: Dict[str, Tuple[int, Tuple]] = {}


def _cache_key(directory: str) -> str:
    return (directory.rstrip("/") if is_bucket_path(directory)
            else os.path.abspath(directory))


def _fingerprint(directory: str, step: int) -> Optional[Tuple]:
    """("local", size, mtime_ns) or ("bucket", size, generation|ETag) of
    the step's state.npz; None when unreadable (a cache miss, never
    verified)."""
    url = _join(directory, f"step-{int(step)}", "state.npz")
    try:
        if is_bucket_path(directory):
            size, gen = _bucket_ops(directory).stat(url, fresh=True)
            return ("bucket", int(size), gen)
        st = os.stat(url)
    except Exception:
        return None
    return ("local", st.st_size, st.st_mtime_ns)


def _record_written(directory: str, step: int) -> None:
    key = _cache_key(directory)
    fp = _fingerprint(directory, step)
    if fp is None:
        _written_verified.pop(key, None)
    else:
        _written_verified[key] = (int(step), fp)


def _written_verified_hit(directory: str, step: int) -> bool:
    cached = _written_verified.get(_cache_key(directory))
    return (cached is not None and cached[0] == int(step)
            and _fingerprint(directory, step) == cached[1])


def invalidate_written_cache(directory: Optional[str] = None) -> None:
    """Drop the written-and-verified record (all directories, or one), so
    that retain() verifies from the disk again."""
    if directory is None:
        _written_verified.clear()
    else:
        _written_verified.pop(_cache_key(directory), None)


def _bucket_step_files(directory: str) -> Dict[int, set]:
    """{step: {file names under step-N/}} from ONE bucket listing (steps,
    the orphan sweep and retention all key off it)."""
    base = directory.rstrip("/")
    out: Dict[int, set] = {}
    for url in _bucket_ops(directory).list_urls(base):
        rel = url[len(base) + 1:]
        head, _, rest = rel.partition("/")
        if head.startswith("step-") and head[5:].isdigit():
            out.setdefault(int(head[5:]), set()).add(rest)
    return out


def _delete_step(directory: str, step: int) -> None:
    """Remove step-N. On a bucket meta.json goes FIRST, so a reader racing
    the delete sees not-a-checkpoint rather than a torn step; when it
    cannot be deleted the step is left whole (retention is best-effort and
    the next retain sweeps again)."""
    if not is_bucket_path(directory):
        shutil.rmtree(_join(directory, f"step-{step}"), ignore_errors=True)
        return
    ops = _bucket_ops(directory)
    prefix = _join(directory, f"step-{step}")
    try:
        ops.delete(f"{prefix}/meta.json")
    except Exception as e:
        warnings.warn(f"checkpoint retention: could not delete "
                      f"{prefix}/meta.json ({e}) — step left in place",
                      RuntimeWarning)
        return
    for url in ops.list_urls(prefix):
        try:
            ops.delete(url)
        except Exception:
            pass  # best-effort; the next retain sweeps again


def _sweep_bucket_orphans(directory: str, ops,
                          listing: Dict[int, set]) -> None:
    """Delete stray `.part-` components and every file of a meta-less
    (uncommitted, killed) step from a bucket listing. Best-effort; the
    next save sweeps again."""
    for s, fs in listing.items():
        for f in fs:
            if ".part-" in f or "meta.json" not in fs:
                try:
                    ops.delete(_join(directory, f"step-{s}", f))
                except Exception as e:
                    warnings.warn(f"checkpoint orphan sweep: could not "
                                  f"delete step-{s}/{f}: {e}",
                                  RuntimeWarning)


def _sweep_stale_tmp(directory: str,
                     current_step: Optional[int] = None) -> None:
    """Remove leftovers of a writer killed mid-save: `.tmp-*` work
    directories, and step directories without a meta.json commit marker.
    The step being written is never swept."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return
    for d in entries:
        path = os.path.join(directory, d)
        if d.startswith(".tmp-"):
            shutil.rmtree(path, ignore_errors=True)
        elif d.startswith("step-") and d[5:].isdigit():
            if current_step is not None and int(d[5:]) == int(current_step):
                continue
            if not os.path.exists(os.path.join(path, "meta.json")):
                shutil.rmtree(path, ignore_errors=True)


def read_file(directory: str, name: str) -> Optional[bytes]:
    """The bytes of a small file beside the steps (the ImageNet app's
    `mean_image.npz`), or None when it does not exist (on a bucket, a
    404; other store failures propagate)."""
    path = _join(directory, name)
    if is_bucket_path(directory):
        try:
            return _bucket_ops(directory).read(path)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None


def write_file(directory: str, name: str, data: bytes) -> None:
    """Write a small file beside the steps atomically: a temporary file
    renamed into place, or one object upload on a bucket."""
    if is_bucket_path(directory):
        _bucket_ops(directory).write(_join(directory, name), bytes(data))
        return
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _prepare_save(tree: Any, step: int, extra: Optional[Dict[str, Any]]
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(arrays as stored, meta dict without commit_ts)."""
    flat: Dict[str, np.ndarray] = {}
    ext_dtypes: Dict[str, str] = {}
    for key, leaf in _flatten(tree).items():
        flat[key], ext = _leaf_to_numpy(leaf)
        if ext is not None:
            ext_dtypes[key] = ext
    meta: Dict[str, Any] = {"step": int(step), "keys": sorted(flat),
                            "digests": {k: _digest(a)
                                        for k, a in flat.items()}}
    if ext_dtypes:
        meta["ext_dtypes"] = ext_dtypes
    if extra:
        meta["extra"] = extra
    return flat, meta


def save(directory: str, tree: Any, *, step: int,
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write checkpoint `step-N` under `directory` (a local path
    or a gs://|s3:// prefix); returns its path. Records a SHA-256 digest
    per array in meta.json, stamps `commit_ts` just before meta.json is
    written, and sweeps the leftovers of crashed earlier saves."""
    if is_bucket_path(directory):
        return _save_bucket(directory, tree, step=step, extra=extra)
    os.makedirs(directory, exist_ok=True)
    _sweep_stale_tmp(directory, current_step=step)
    flat, meta = _prepare_save(tree, step, extra)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp-")
    try:
        np.savez(os.path.join(tmp, "state.npz"), **flat)
        meta["commit_ts"] = round(time.time(), 3)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        final = os.path.join(directory, f"step-{int(step)}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _record_written(directory, step)
    return final


def _save_bucket(directory: str, tree: Any, *, step: int,
                 extra: Optional[Dict[str, Any]] = None) -> str:
    """Bucket save: orphans of crashed saves swept, the step decommitted
    (its meta.json deleted) before an overwrite, state.npz up through the
    chunked writer, meta.json LAST as the commit marker."""
    ops = _bucket_ops(directory)
    final = _join(directory, f"step-{int(step)}")
    _sweep_bucket_orphans(directory, ops, _bucket_step_files(directory))
    flat, meta = _prepare_save(tree, step, extra)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    ops.delete(f"{final}/meta.json")  # decommit before overwrite
    ops.write_large(f"{final}/state.npz", buf.getbuffer())
    meta["commit_ts"] = round(time.time(), 3)
    ops.write(f"{final}/meta.json", json.dumps(meta).encode())
    _record_written(directory, step)
    return final


def _list_steps(directory: str) -> List[int]:
    """All step numbers present as directories (no validity check)."""
    if is_bucket_path(directory):
        return sorted(_bucket_step_files(directory))
    if not os.path.isdir(directory):
        return []
    return sorted(int(d[5:]) for d in os.listdir(directory)
                  if d.startswith("step-") and d[5:].isdigit())


def _load_meta(path: str) -> Optional[Dict[str, Any]]:
    """meta.json as a dict, or None when missing or unparseable (the
    caller treats that as not-a-checkpoint). On a bucket only a 404 means
    absent: an outage or an auth/5xx failure propagates, so a transient
    store fault is never read as "no checkpoint"."""
    if is_bucket_path(path):
        try:
            raw = _bucket_ops(path).read(f"{path}/meta.json")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        try:
            meta = json.loads(raw)
        except ValueError:
            return None
        return meta if isinstance(meta, dict) else None
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None
    return meta if isinstance(meta, dict) else None


def latest_step(directory: str) -> Optional[int]:
    """Newest step whose meta.json is readable; a step with a missing or
    unparseable one is skipped with a warning."""
    for s in reversed(_list_steps(directory)):
        path = _join(directory, f"step-{s}")
        if _load_meta(path) is not None:
            return s
        warnings.warn(f"checkpoint {path}: meta.json missing/unreadable — "
                      f"treating as not-a-checkpoint", RuntimeWarning)
    return None


def _raise_missing_state(path: str, err: Exception) -> None:
    """A committed meta.json whose state.npz is missing: vanished when
    the meta.json has gone too (`retain` deleted the step between the two
    reads), else corrupt."""
    if _load_meta(path) is None:
        raise CheckpointVanishedError(
            f"{path}: deleted while it was read (state.npz and then "
            f"meta.json gone): {err}") from err
    raise CheckpointCorruptError(f"{path}: state.npz missing: {err}"
                                 ) from err


def _load_checkpoint(path: str) -> Tuple[Dict[str, Any], int,
                                         Dict[str, Any]]:
    """Load and verify one step directory. Raises CheckpointCorruptError
    on an unreadable meta/state, missing keys or a digest mismatch.
    Digest-less (older format) steps load with a vacuous digest check."""
    meta = _load_meta(path)
    if meta is None:
        raise CheckpointVanishedError(
            f"{path}: meta.json missing/unreadable — never committed or "
            f"retention-pruned")
    if "shards" in meta:
        raise NotImplementedError(
            f"{path}: a per-shard checkpoint (checkpoint_sharded layout); "
            f"reading per-shard steps is not ported yet (ROADMAP A6b)")
    try:
        if is_bucket_path(path):
            # one ranged stream with reconnect-resume, copied into ONE
            # buffer
            stream = _bucket_ops(path).open_stream(f"{path}/state.npz")
            try:
                src: Any = io.BytesIO()
                shutil.copyfileobj(stream, src, 1 << 20)
                src.seek(0)
            finally:
                stream.close()
        else:
            src = os.path.join(path, "state.npz")
        with np.load(src) as z:
            flat: Dict[str, Any] = {k: z[k] for k in z.files}
    except (ConnectionError, TimeoutError):
        raise  # store trouble, not corruption
    except urllib.error.HTTPError as e:
        if e.code == 404:  # committed meta over a missing state
            _raise_missing_state(path, e)
        raise
    except FileNotFoundError as e:
        _raise_missing_state(path, e)
    except Exception as e:
        raise CheckpointCorruptError(f"{path}: state.npz unreadable: {e}"
                                     ) from e
    missing = set(meta.get("keys", ())) - set(flat)
    if missing:
        raise CheckpointCorruptError(
            f"{path}: state.npz missing keys {sorted(missing)[:5]}")
    for key, want in meta.get("digests", {}).items():
        if key not in flat:
            raise CheckpointCorruptError(f"{path}: digest for missing "
                                         f"key {key!r}")
        got = _digest(flat[key])
        if got != want:
            raise CheckpointCorruptError(
                f"{path}: digest mismatch on {key!r} (stored "
                f"{want[:12]}…, recomputed {got[:12]}…) — bytes were "
                f"corrupted at rest or in transit")
    for key, name in meta.get("ext_dtypes", {}).items():
        flat[key] = _from_stored(flat[key], name)
    extra = dict(meta.get("extra") or {})
    if "commit_ts" in meta:
        extra.setdefault("commit_ts", meta["commit_ts"])
    return flat, int(meta["step"]), extra


def restore_flat(directory: str, step: Optional[int] = None
                 ) -> Tuple[Dict[str, Any], int, Dict[str, Any]]:
    """The flat {key: array} map of a step, its step number and its
    `extra` (with `commit_ts` folded in).

    With an explicit `step`, an integrity failure raises
    CheckpointCorruptError. With step=None the newest step that verifies
    wins; corrupt newer ones are skipped with a warning."""
    if step is not None:
        return _load_checkpoint(_join(directory, f"step-{int(step)}"))
    steps = _list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory!r}")
    last_err: Optional[Exception] = None
    for s in reversed(steps):
        try:
            return _load_checkpoint(_join(directory, f"step-{s}"))
        except CheckpointCorruptError as e:
            warnings.warn(f"{e} — falling back to the previous checkpoint",
                          RuntimeWarning)
            last_err = e
    raise CheckpointCorruptError(
        f"no checkpoint under {directory!r} passes verification "
        f"({len(steps)} candidates)") from last_err


def verify(path: str) -> bool:
    """True when the step directory `path` is complete and its recorded
    digests match the stored bytes (vacuously true for digest-less steps
    that load). A per-shard step raises NotImplementedError."""
    try:
        _load_checkpoint(path)
        return True
    except CheckpointCorruptError:
        return False


def restore_newest_verified(directory: str, skip_anomalous: bool = False
                            ) -> Optional[Tuple[Dict[str, Any], int,
                                                Dict[str, Any]]]:
    """Load the newest step that verifies, skipping those tagged
    `extra["anomalous"]` when asked — verification is the load, so the
    rollback reads the state once. Returns (flat, step, extra) or None."""
    for s in reversed(_list_steps(directory)):
        path = _join(directory, f"step-{s}")
        meta = _load_meta(path)
        if meta is None:
            continue
        if skip_anomalous and (meta.get("extra") or {}).get("anomalous"):
            continue
        try:
            return _load_checkpoint(path)
        except CheckpointCorruptError:
            continue
    return None


def newest_verified_step(directory: str, skip_anomalous: bool = False
                         ) -> Optional[int]:
    """Newest step that passes `verify` — the rollback target with
    `skip_anomalous=True`."""
    found = restore_newest_verified(directory, skip_anomalous=skip_anomalous)
    return found[1] if found is not None else None


def retain(directory: str, keep: int = 3) -> None:
    """Delete all but the newest `keep` steps — but never the newest one
    that verifies, nor the newest verified non-anomalous one, so that a
    resume and a rollback always find a target. The step this process just
    wrote counts as verified while its file is unchanged (the cache
    above); any other step is verified from the disk."""
    steps = _list_steps(directory)
    if not steps:
        return
    protect = set(steps[-keep:]) if keep else set()
    newest_verified = None
    for s in reversed(steps):
        path = _join(directory, f"step-{s}")
        meta = _load_meta(path)
        if meta is None:
            continue
        anomalous = bool((meta.get("extra") or {}).get("anomalous"))
        if newest_verified is not None and anomalous:
            continue  # only the non-anomalous target is still open
        if _written_verified_hit(directory, s) or verify(path):
            if newest_verified is None:
                newest_verified = s
                protect.add(s)
            if not anomalous:
                protect.add(s)
                break
    for s in steps:
        if s not in protect:
            _delete_step(directory, s)


class AsyncCheckpointWriter:
    """Stage 2 of the two-stage save: ONE background thread runs the
    serialize + digest + persist closure while the round loop trains on.
    At most one snapshot is in flight: `submit` first waits out the
    previous write and re-raises its failure. `wait` is the barrier the
    rollback path and the loop's exit take before reading the store."""

    def __init__(self, registry=None):
        self._ex = ThreadPoolExecutor(1, thread_name_prefix="ckpt-write")
        self._pending = None
        self._c_writes = self._h_write = self._h_stall = None
        if registry is not None:
            self._c_writes = registry.counter(
                "sparknet_checkpoint_writes_total",
                "background checkpoint writes by outcome and scope "
                "(snapshot|shard|meta)",
                labels=("outcome", "scope"))
            self._h_write = registry.histogram(
                "sparknet_checkpoint_write_seconds",
                "stage-2 persist duration by scope (snapshot|shard|meta)",
                labels=("scope",))
            self._h_stall = registry.histogram(
                "sparknet_checkpoint_submit_stall_seconds",
                "round-loop blocking wait for the previous in-flight "
                "write at submit")

    def submit(self, fn, *args, **kwargs) -> None:
        """Queue one write; blocks until the previous one finished (and
        re-raises its exception, if any)."""
        t0 = time.perf_counter()
        self.wait()
        if self._h_stall is not None:
            self._h_stall.observe(time.perf_counter() - t0)

        def run():
            t1 = time.perf_counter()
            from ..obs import trace as _trace
            try:
                with _trace.span("checkpoint_write"):
                    fn(*args, **kwargs)
            except BaseException:
                self.note_write("snapshot", 0.0, ok=False)
                raise
            self.note_write("snapshot", time.perf_counter() - t1)

        self._pending = self._ex.submit(run)

    def note_write(self, scope: str, seconds: float, ok: bool = True
                   ) -> None:
        """One count (and, when it succeeded, one duration) of a write in
        `scope`; a no-op without a registry."""
        if self._c_writes is not None:
            self._c_writes.inc(outcome="ok" if ok else "error",
                               scope=scope)
            if ok:
                self._h_write.observe(seconds, scope=scope)

    def wait(self) -> None:
        """Block until the in-flight write (if any) completes; re-raise
        its failure."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self, wait: bool = True) -> None:
        """Drain (re-raising a failed write when `wait`) and stop the
        thread. With wait=False a queued write is cancelled; a running
        one always completes."""
        try:
            if wait:
                self.wait()
        finally:
            self._ex.shutdown(wait=wait, cancel_futures=not wait)
