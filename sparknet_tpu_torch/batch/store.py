"""One tiny object-store surface for batch outputs: local directories
and gs:// | s3:// prefixes behave identically.

The property the manifest protocol needs is ATOMIC VISIBILITY: a reader
(a resuming driver) must see each object either absent or complete,
never half-written. Buckets give that for free (an object exists only
once its upload finalizes); local files get it from the
write-to-temp-then-os.replace dance (same filesystem, so the rename is
atomic on POSIX). Nothing here retries — the driver owns retry policy
(full jitter, data/gcs.retry_delay) because a store error mid-unit must
interact with unit accounting, not hide beneath it.
"""
from __future__ import annotations

import os
import tempfile
from typing import List

from ..utils.checkpoint import _bucket_ops, is_bucket_path


def is_bucket(path: str) -> bool:
    return is_bucket_path(path)


def join(root: str, *names: str) -> str:
    if is_bucket_path(root):
        return "/".join((root.rstrip("/"),) + names)
    return os.path.join(root, *names)


def read_bytes(url: str) -> bytes:
    if is_bucket_path(url):
        return _bucket_ops(url).read(url)
    with open(url, "rb") as f:
        return f.read()


def write_bytes(url: str, data: bytes) -> None:
    """All-or-nothing write: bucket objects finalize atomically; local
    files go through a same-directory temp + os.replace."""
    if is_bucket_path(url):
        _bucket_ops(url).write(url, data)
        return
    d = os.path.dirname(os.path.abspath(url))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-",
                               suffix=os.path.basename(url))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, url)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def exists(url: str) -> bool:
    if is_bucket_path(url):
        try:
            _bucket_ops(url).stat(url, fresh=True)
            return True
        except Exception:
            return False
    return os.path.exists(url)


def delete(url: str) -> None:
    if is_bucket_path(url):
        _bucket_ops(url).delete(url, missing_ok=True)
        return
    try:
        os.unlink(url)
    except FileNotFoundError:
        pass


def list_names(root: str) -> List[str]:
    """Object/file basenames directly under the prefix (temp files from
    an interrupted local write are invisible — they never count)."""
    if is_bucket_path(root):
        urls = _bucket_ops(root).list_urls(root.rstrip("/") + "/")
        return sorted(u.rsplit("/", 1)[-1] for u in urls)
    if not os.path.isdir(root):
        return []
    return sorted(n for n in os.listdir(root)
                  if not n.startswith(".tmp-"))
