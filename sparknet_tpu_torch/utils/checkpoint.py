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

The per-shard layout (`save_sharded`, the JAX package's gather-free
save): instead of one state.npz, a step holds `shard-xxxxx-of-NNNNN.npz`
files, one per rank, each carrying only the pieces that rank owns
(`parallel/mesh.py:plan_state_shards`), and meta.json is a MANIFEST:
{"format": "sharded", "global": {key: {"shape", "dtype"}}, "shards":
[{"file", "entries": {key: [offsets, shape]}, "digest"}], ...} with a
sha256 of each file's exact bytes, still written last as the commit
marker. Extension dtypes are stored as uint views named in `ext_dtypes`,
as in state.npz. A world of one commits atomically (local: a `.tmp-*`
work directory renamed; bucket: orphans swept, an overwritten step
decommitted and cleared, meta.json last). A world of several ranks
writes every rank's files straight into `step-N/`: rank 0 clears the
step first (`prepare_sharded_step`, fenced by barriers), each rank
reports its digests in `commit-<rank>.json`, and rank 0 folds them into
the manifest, commits meta.json and removes the reports. `restore_flat`,
`verify`, `retain` and `newest_verified_step` read both layouts: the
manifest loader fetches every shard in parallel, checks its digest and
reassembles the same flat map a monolithic step of the same state
gives, bit for bit.

A step of the logical layout (the JAX package's NamedSharding trainer,
the port's `parallel/sharded.py`) restores to its flat map here too, in
either file layout; the trainers' `adapt_state` reads it.
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
# save (on a bucket, a full ranged GET of its state). When that step is the
# one this process just wrote, its digests were computed from the bytes it
# handed to the store, which commits them all or nothing; the cache records
# the step with a fingerprint of every state file (state.npz, or each shard
# file of a per-shard step) taken right after the write — local (size,
# mtime_ns), bucket (size, generation|ETag) — and retain() takes it as
# verified only while every fingerprint still matches. Anything that
# rewrites one of the files falls back to the full verify.
_written_verified: Dict[str, Tuple[int, Dict[str, Tuple]]] = {}


def _cache_key(directory: str) -> str:
    return (directory.rstrip("/") if is_bucket_path(directory)
            else os.path.abspath(directory))


def _fingerprint(directory: str, step: int,
                 name: str = "state.npz") -> Optional[Tuple]:
    """("local", size, mtime_ns) or ("bucket", size, generation|ETag) of
    one file of the step; None when unreadable (a cache miss, never
    verified)."""
    url = _join(directory, f"step-{int(step)}", name)
    try:
        if is_bucket_path(directory):
            size, gen = _bucket_ops(directory).stat(url, fresh=True)
            return ("bucket", int(size), gen)
        st = os.stat(url)
    except Exception:
        return None
    return ("local", st.st_size, st.st_mtime_ns)


def _record_written(directory: str, step: int,
                    files: Tuple[str, ...] = ("state.npz",)) -> None:
    key = _cache_key(directory)
    fps: Dict[str, Tuple] = {}
    for name in files:
        fp = _fingerprint(directory, step, name)
        if fp is None:
            _written_verified.pop(key, None)
            return
        fps[name] = fp
    _written_verified[key] = (int(step), fps)


def _written_verified_hit(directory: str, step: int) -> bool:
    cached = _written_verified.get(_cache_key(directory))
    return (cached is not None and cached[0] == int(step)
            and all(_fingerprint(directory, step, name) == fp
                    for name, fp in cached[1].items()))


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


def _committed(meta: Dict[str, Any]) -> bytes:
    """meta.json's bytes, stamped with `commit_ts` just before the commit
    marker is written: the instant the step becomes visible to readers
    (the serving fleet's freshness counts from it)."""
    meta["commit_ts"] = round(time.time(), 3)
    return json.dumps(meta).encode()


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
        with open(os.path.join(tmp, "meta.json"), "wb") as f:
            f.write(_committed(meta))
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
    ops.write(f"{final}/meta.json", _committed(meta))
    _record_written(directory, step)
    return final


# -- the per-shard layout: shard files + a manifest commit marker -----------

def shard_file_name(i: int, n: int) -> str:
    return f"shard-{int(i):05d}-of-{int(n):05d}.npz"


def _stored_dtype(dtype: Any) -> Tuple[np.dtype, Optional[str]]:
    """(dtype as a shard file stores it, extension name or None): a
    bfloat16 leaf is stored as its uint16 bit pattern."""
    if dtype in ("bfloat16", torch.bfloat16):
        return np.dtype(np.uint16), "bfloat16"
    return np.dtype(dtype), None


def sharded_nbytes(sharded: Dict[str, Any]) -> int:
    """The state bytes a per-shard snapshot persists: the monolithic
    layout's sum of array bytes (every piece is written once)."""
    return sum(int(np.prod(rec["shape"])) *
               _stored_dtype(rec["dtype"])[0].itemsize
               for rec in sharded["leaves"].values())


def _serialize_shard(pieces: Dict[str, Tuple[Tuple[int, ...], np.ndarray]]
                     ) -> Tuple[memoryview, str]:
    """One shard file's (npz bytes, sha256 hex). Keys are the flat state
    keys; a file holds at most one piece per key, so the piece offsets
    live in the manifest. The bytes are a view of the serialization
    buffer (no second copy of a shard's state)."""
    buf = io.BytesIO()
    np.savez(buf, **{k: arr for k, (_, arr) in pieces.items()})
    raw = buf.getbuffer()
    return raw, hashlib.sha256(raw).hexdigest()


def _sharded_meta(sharded: Dict[str, Any], step: int,
                  extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The manifest meta.json of a per-shard save, without digests. The
    piece plan is known to every rank, so every rank can build it; only
    the per-file digests need the writers' reports."""
    n = int(sharded["n_shards"])
    files: Dict[int, Dict[str, list]] = {}
    glob: Dict[str, Dict[str, Any]] = {}
    ext_dtypes: Dict[str, str] = {}
    for key, rec in sharded["leaves"].items():
        dt, ext = _stored_dtype(rec["dtype"])
        if ext is not None:
            ext_dtypes[key] = ext
        glob[key] = {"shape": [int(s) for s in rec["shape"]],
                     "dtype": dt.name}
        for fid, offsets, shape, _ in rec["pieces"]:
            files.setdefault(int(fid), {})[key] = [
                [int(o) for o in offsets], [int(s) for s in shape]]
    meta: Dict[str, Any] = {
        "step": int(step), "keys": sorted(sharded["leaves"]),
        "format": "sharded", "global": glob,
        "shards": [{"file": shard_file_name(fid, n), "entries": files[fid]}
                   for fid in sorted(files)]}
    if ext_dtypes:
        meta["ext_dtypes"] = ext_dtypes
    if extra:
        meta["extra"] = extra
    return meta


def _shard_payloads(sharded: Dict[str, Any]
                    ) -> Dict[int, Dict[str, Tuple[Tuple[int, ...],
                                                   np.ndarray]]]:
    """{file_id: {key: (offsets, array as stored)}} for the pieces this
    rank holds (a piece of another rank has arr None)."""
    out: Dict[int, Dict[str, Tuple[Tuple[int, ...], np.ndarray]]] = {}
    for key, rec in sharded["leaves"].items():
        for fid, offsets, _, arr in rec["pieces"]:
            if arr is not None:
                out.setdefault(int(fid), {})[key] = (
                    tuple(offsets), _leaf_to_numpy(arr)[0])
    return out


def save_sharded(directory: str, sharded: Dict[str, Any], *, step: int,
                 extra: Optional[Dict[str, Any]] = None,
                 metrics=None, commit_timeout_s: float = 600.0) -> str:
    """Write step-N in the per-shard layout from a snapshot of
    `parallel.mesh.plan_state_shards` (or the JAX package's
    `fetch_state_shards`): the shard files in parallel, then the manifest
    with per-file digests last. A world of one writes every file; in a
    world of several ranks every rank calls this with its own pieces and
    rank 0 commits once every rank's digest report has landed (module
    docstring; `prepare_sharded_step` must have run first). `metrics(
    scope, seconds, ok)` is the per-write hook (AsyncCheckpointWriter.
    note_write: "shard" per file, "meta" for the commit marker). A failed
    write, a missing report or a file the manifest names but no rank
    wrote raises."""
    payloads = _shard_payloads(sharded)
    meta = _sharded_meta(sharded, step, extra)
    owners = {int(k): int(v) for k, v in sharded.get("owners", {}).items()}
    me = int(sharded.get("process_index", 0))
    n_procs = int(sharded.get("process_count", 1))

    def timed_write(scope, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException:
            if metrics is not None:
                metrics(scope, time.perf_counter() - t0, ok=False)
            raise
        if metrics is not None:
            metrics(scope, time.perf_counter() - t0, ok=True)

    files = {shard_file_name(fid, sharded["n_shards"]): pieces
             for fid, pieces in payloads.items()}
    if n_procs == 1:
        if is_bucket_path(directory):
            return _commit_sharded_bucket(directory, step, files, meta,
                                          timed_write)
        return _commit_sharded_local(directory, step, files, meta,
                                     timed_write)
    return _commit_sharded_multiproc(directory, step, files, meta, owners,
                                     me, timed_write, commit_timeout_s)


def _parallel_file_writes(files: Dict[str, Dict], write_one,
                          timed_write) -> Dict[str, str]:
    """Serialize and write every shard file on a thread pool (np.savez,
    sha256 and the store's I/O all release the GIL); returns {file name:
    sha256 of the bytes written}."""
    if not files:
        return {}

    def one(name, pieces):
        raw, digest = _serialize_shard(pieces)
        timed_write("shard", lambda: write_one(name, raw))
        return name, digest

    with ThreadPoolExecutor(min(8, len(files)),
                            thread_name_prefix="ckpt-shard") as ex:
        futs = [ex.submit(one, name, pieces)
                for name, pieces in sorted(files.items())]
        return dict(f.result() for f in futs)


def _stamp_digests(meta: Dict[str, Any], digests: Dict[str, str]) -> None:
    for rec in meta["shards"]:
        if rec["file"] not in digests:
            raise RuntimeError(
                f"sharded checkpoint step-{meta['step']}: manifest file "
                f"{rec['file']} was never written")
        rec["digest"] = digests[rec["file"]]


def _commit_sharded_local(directory: str, step: int, files, meta,
                          timed_write) -> str:
    """A world of one on a local directory: the files and meta.json in a
    `.tmp-*` work directory, renamed to step-N in one step."""
    os.makedirs(directory, exist_ok=True)
    _sweep_stale_tmp(directory, current_step=step)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp-")
    try:
        def write_one(name, raw):
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(raw)

        _stamp_digests(meta, _parallel_file_writes(files, write_one,
                                                   timed_write))

        timed_write("meta", lambda: write_one("meta.json",
                                              _committed(meta)))
        final = os.path.join(directory, f"step-{int(step)}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _record_written(directory, step, files=tuple(sorted(files)))
    return final


def _commit_sharded_bucket(directory: str, step: int, files, meta,
                           timed_write) -> str:
    """A world of one on a bucket: orphans swept (a meta-less step loses
    every file), an overwritten step decommitted and its old files
    deleted (a wider save's extra shards must not pair with the new
    manifest), the shards uploaded in parallel, meta.json last."""
    ops = _bucket_ops(directory)
    final = _join(directory, f"step-{int(step)}")
    listing = _bucket_step_files(directory)
    _sweep_bucket_orphans(directory, ops, listing)
    step_files = listing.get(int(step), set())
    if "meta.json" in step_files:
        ops.delete(f"{final}/meta.json")  # decommit first, unguarded
        for f in step_files - {"meta.json"}:
            try:
                ops.delete(f"{final}/{f}")
            except Exception:
                pass  # the step is meta-less now: the next sweep retries

    def write_one(name, raw):
        ops.write_large(f"{final}/{name}", raw)

    _stamp_digests(meta, _parallel_file_writes(files, write_one,
                                               timed_write))

    timed_write("meta", lambda: ops.write(f"{final}/meta.json",
                                          _committed(meta)))
    _record_written(directory, step, files=tuple(sorted(files)))
    return final


def prepare_sharded_step(directory: str, step: int) -> None:
    """Stage-1 cleanup of a per-shard save in a world of several ranks,
    run by rank 0 between two barriers (so no rank has written a fresh
    file this could delete): decommit an overwritten step's meta.json
    first (a failure raises: never an old manifest over new shards), then
    delete every other file of the step — a crashed save's commit
    reports, a wider save's shard files — and sweep meta-less orphan
    steps."""
    if is_bucket_path(directory):
        ops = _bucket_ops(directory)
        listing = _bucket_step_files(directory)
        for f in sorted(listing.get(int(step), set()),
                        key=lambda f: f != "meta.json"):  # meta first
            try:
                ops.delete(_join(directory, f"step-{int(step)}", f))
            except Exception:
                if f == "meta.json":
                    raise
        _sweep_bucket_orphans(directory, ops, {
            s: fs for s, fs in listing.items() if s != int(step)})
        return
    step_dir = _join(directory, f"step-{int(step)}")
    if os.path.isdir(step_dir):
        meta = os.path.join(step_dir, "meta.json")
        if os.path.exists(meta):
            os.remove(meta)
        shutil.rmtree(step_dir, ignore_errors=True)
    _sweep_stale_tmp(directory, current_step=step)


def _commit_sharded_multiproc(directory: str, step: int, files, meta,
                              owners, me, timed_write,
                              commit_timeout_s: float) -> str:
    """A world of several ranks: each rank writes its shard files
    straight under step-N and a `commit-<rank>.json` digest report; rank
    0 polls for every owner's report (up to `commit_timeout_s`, then
    raises and leaves the step uncommitted), stamps the digests, commits
    meta.json and deletes the reports. A rank killed anywhere leaves a
    meta-less step that the next save's `prepare_sharded_step` sweeps."""
    final = _join(directory, f"step-{int(step)}")
    if is_bucket_path(directory):
        ops = _bucket_ops(directory)

        def write_one(name, raw):
            if len(raw) > (1 << 20):
                ops.write_large(f"{final}/{name}", raw)
            else:
                ops.write(f"{final}/{name}", bytes(raw))

        def read_one(name):
            return ops.read(f"{final}/{name}")

        def delete_one(name):
            ops.delete(f"{final}/{name}")
    else:
        os.makedirs(final, exist_ok=True)

        def write_one(name, raw):
            tmp = f"{os.path.join(final, name)}.tmp-{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, os.path.join(final, name))

        def read_one(name):
            with open(os.path.join(final, name), "rb") as f:
                return f.read()

        def delete_one(name):
            os.remove(os.path.join(final, name))

    digests = _parallel_file_writes(files, write_one, timed_write)
    write_one(f"commit-{int(me)}.json", json.dumps(digests).encode())
    if me != 0:
        return final
    expected = sorted(set(owners.values()))
    reported: Dict[str, str] = {}
    deadline = time.monotonic() + commit_timeout_s
    for p in expected:
        while True:
            try:
                reported.update(json.loads(read_one(f"commit-{p}.json")))
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"sharded checkpoint step-{step}: rank {p} never "
                        f"reported its shard digests within "
                        f"{commit_timeout_s}s — the step stays "
                        f"uncommitted (not-a-checkpoint)")
                time.sleep(0.05)
    _stamp_digests(meta, reported)

    timed_write("meta", lambda: write_one("meta.json", _committed(meta)))
    for p in expected:
        try:
            delete_one(f"commit-{p}.json")
        except Exception:
            pass  # harmless residue inside a committed step
    _record_written(directory, step,
                    files=tuple(sorted(r["file"] for r in meta["shards"])))
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
        try:
            return _load_sharded(path, meta)
        except (KeyError, TypeError, ValueError) as e:
            raise CheckpointCorruptError(
                f"{path}: malformed per-shard manifest: {e!r}") from e
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
    return flat, int(meta["step"]), _extra_with_commit(meta)


def _extra_with_commit(meta: Dict[str, Any]) -> Dict[str, Any]:
    """The step's `extra` with the manifest's `commit_ts` folded in."""
    extra = dict(meta.get("extra") or {})
    if "commit_ts" in meta:
        extra.setdefault("commit_ts", meta["commit_ts"])
    return extra


def _load_sharded(path: str, meta: Dict[str, Any]
                  ) -> Tuple[Dict[str, Any], int, Dict[str, Any]]:
    """Load and verify a per-shard step: every manifest file fetched in
    parallel, its sha256 recomputed over the stored bytes, the pieces
    reassembled into the flat map a monolithic step of the same state
    gives, bit for bit. A missing, tampered or unparseable shard, an
    unknown or missing key, a piece of the wrong shape and a key the
    pieces do not cover exactly raise CheckpointCorruptError; store
    trouble (ConnectionError, a non-404 HTTPError) propagates."""
    ops = _bucket_ops(path) if is_bucket_path(path) else None

    def load_one(rec: Dict[str, Any]) -> Dict[str, np.ndarray]:
        name = rec["file"]
        try:
            if ops is not None:
                stream = ops.open_stream(f"{path}/{name}")
                try:
                    buf = io.BytesIO()
                    shutil.copyfileobj(stream, buf, 1 << 20)
                    raw = buf.getvalue()
                finally:
                    stream.close()
            else:
                with open(os.path.join(path, name), "rb") as f:
                    raw = f.read()
        except (ConnectionError, TimeoutError):
            raise  # store trouble, not corruption
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise CheckpointCorruptError(
                    f"{path}: shard {name} missing: {e}") from e
            raise
        except OSError as e:
            raise CheckpointCorruptError(
                f"{path}: shard {name} unreadable: {e}") from e
        want = rec.get("digest")
        if want:
            got = hashlib.sha256(raw).hexdigest()
            if got != want:
                raise CheckpointCorruptError(
                    f"{path}: digest mismatch on shard {name} (stored "
                    f"{want[:12]}…, recomputed {got[:12]}…) — bytes were "
                    f"corrupted at rest or in transit")
        try:
            with np.load(io.BytesIO(raw)) as z:
                return {k: z[k] for k in z.files}
        except Exception as e:
            raise CheckpointCorruptError(
                f"{path}: shard {name} unparseable: {e}") from e

    shards = meta["shards"]
    with ThreadPoolExecutor(max(1, min(8, len(shards))),
                            thread_name_prefix="ckpt-shard-read") as ex:
        loaded = list(ex.map(load_one, shards))
    glob = meta.get("global", {})
    flat: Dict[str, Any] = {}
    filled: Dict[str, int] = {}
    for rec, data in zip(shards, loaded):
        for key, (offsets, shape) in rec["entries"].items():
            if key not in glob:
                raise CheckpointCorruptError(
                    f"{path}: shard {rec['file']} carries unknown key "
                    f"{key!r}")
            if key not in data:
                raise CheckpointCorruptError(
                    f"{path}: shard {rec['file']} missing key {key!r}")
            piece = data[key]
            if tuple(piece.shape) != tuple(shape):
                raise CheckpointCorruptError(
                    f"{path}: shard {rec['file']} piece {key!r} shape "
                    f"{piece.shape} != manifest {tuple(shape)}")
            g = glob[key]
            if key not in flat:
                flat[key] = np.empty(tuple(g["shape"]), np.dtype(g["dtype"]))
                filled[key] = 0
            if piece.ndim == 0:
                flat[key] = piece
                filled[key] += 1
            else:
                flat[key][tuple(slice(o, o + n) for o, n in
                                zip(offsets, piece.shape))] = piece
                filled[key] += int(np.prod(piece.shape))
    for key in meta.get("keys", ()):
        g = glob.get(key)
        want_n = (1 if g is None or not g["shape"]
                  else int(np.prod(g["shape"])))
        if filled.get(key, 0) != want_n:
            raise CheckpointCorruptError(
                f"{path}: key {key!r} covered {filled.get(key, 0)} of "
                f"{want_n} elements across the manifest — incomplete or "
                f"overlapping shards")
    for key, name in meta.get("ext_dtypes", {}).items():
        flat[key] = _from_stored(flat[key], name)
    return flat, int(meta["step"]), _extra_with_commit(meta)


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
    """True when the step directory `path` (either layout) is complete and
    its recorded digests match the stored bytes (vacuously true for
    digest-less steps that load). Store trouble propagates."""
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
