"""Native `gs://` object-store ingest — no SDK, no FUSE.

The port's copy of `sparknet_tpu/data/gcs.py` (standard library only).

The reference's data plane read straight from the object store per task
(`loaders/ImageNetLoader.scala:62-63`: one `AmazonS3Client.getObject` per
tar). Instead of a GCS-FUSE mount and its failure modes, this module is
the direct equivalent of the reference's approach for GCS: plain HTTPS against the JSON API
(`storage.googleapis.com`) with

  - object LISTING with pagination (the shard discovery pass),
  - whole-object fetch (label files),
  - STREAMED ranged reads with transparent resume — a dropped connection
    mid-tar reconnects with `Range: bytes=<pos>-` and continues, so a
    multi-hour streaming epoch survives the network blips a FUSE mount
    turns into EIO.

Auth (in order): an emulator endpoint needs none; `GOOGLE_OAUTH_ACCESS_TOKEN`
if set; the GCE/TPU-VM metadata server (the standard production path — TPU
VMs carry a service account); `gcloud auth print-access-token`; anonymous
(public buckets). Tokens are cached until ~expiry.

`STORAGE_EMULATOR_HOST` (the conventional GCS-emulator knob) redirects all
traffic — tests run a local fake server and exercise the full path,
including mid-stream disconnects.
"""
from __future__ import annotations

import http.client
import io
import json
import os
import random
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import warnings
import urllib.request
from typing import List, Optional, Tuple

_METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                       "instance/service-accounts/default/token")

#: (attempts, base backoff seconds) for ranged-read reconnects and
#: retryable HTTP errors (429/5xx)
RETRIES = 5
BACKOFF_S = 0.5


def retry_delay(attempt: int, err: Optional[BaseException] = None) -> float:
    """Seconds to sleep before retry `attempt` + 1: FULL-JITTER exponential
    backoff — uniform in [0, BACKOFF_S * 2^attempt]. The previous
    deterministic `BACKOFF_S * 2^attempt` synchronized every reader into a
    thundering herd: after a shared 429 all `ingest_sources` readers (and
    all hosts of a pod) slept the exact same time and re-arrived together,
    earning the next 429. A 429/503's `Retry-After` header (seconds form),
    when present, is honored as a FLOOR under the jittered delay — the
    server knows when capacity returns; arriving earlier just burns an
    attempt. 503 matters for S3: AWS throttles with `503 SlowDown` (not
    429) and often names its price in Retry-After — a preempted worker
    rejoining a pod through a hot bucket prefix is exactly this path."""
    delay = random.uniform(0.0, BACKOFF_S * (2 ** attempt))
    if isinstance(err, urllib.error.HTTPError) and err.code in (429, 503):
        ra = (err.headers.get("Retry-After")
              if err.headers is not None else None)
        try:
            if ra is not None:
                delay = max(delay, float(ra))
        except ValueError:
            pass  # HTTP-date form: rare from GCS; keep the jittered delay
    return delay


def parse_gs_url(url: str) -> Tuple[str, str]:
    """'gs://bucket/some/prefix' -> ('bucket', 'some/prefix')."""
    if not url.startswith("gs://"):
        raise ValueError(f"not a gs:// url: {url!r}")
    rest = url[len("gs://"):]
    bucket, _, name = rest.partition("/")
    if not bucket:
        raise ValueError(f"gs:// url missing bucket: {url!r}")
    return bucket, name


def is_gs_path(path: str) -> bool:
    return isinstance(path, str) and path.startswith("gs://")


def http_get_with_retry(url: str, headers: Optional[dict] = None,
                        timeout: float = 60.0, method: str = "GET",
                        data: Optional[bytes] = None,
                        headers_fn=None):
    """HTTP request with retry on 429/5xx and connection errors; returns
    the open response (caller reads/closes). 4xx other than 429 propagates
    immediately — retrying a 403/404 only hides it. Shared by the GCS and
    S3 clients (auth differs per caller; the transport does not). Bodies
    (`data`) are bytes held in memory, so retrying a PUT/POST re-sends the
    identical payload.

    `headers_fn` (mutually additive with `headers`) is called PER ATTEMPT
    to (re)build the request headers: SigV4 signatures embed `x-amz-date`,
    and a retry that slept out a long Retry-After floor must present a
    FRESH signature, not replay a stale one into AWS's 15-minute clock-
    skew window (the S3 client signs per attempt through this hook)."""
    last: Optional[BaseException] = None
    for attempt in range(RETRIES):
        h = dict(headers or {})
        if headers_fn is not None:
            h.update(headers_fn())
        req = urllib.request.Request(url, headers=h, data=data,
                                     method=method)
        try:
            return urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            if e.code not in (429, 500, 502, 503, 504):
                raise
            last = e
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            last = e
        if attempt < RETRIES - 1:  # no dead-time sleep before the raise
            time.sleep(retry_delay(attempt, last))
    raise ConnectionError(f"{method} {url} failed after {RETRIES} attempts"
                          ) from last


class GcsClient:
    """Minimal GCS JSON-API client over urllib (stdlib only)."""

    def __init__(self, endpoint: Optional[str] = None,
                 timeout: float = 60.0):
        self.endpoint = (endpoint or os.environ.get("STORAGE_EMULATOR_HOST")
                         or "https://storage.googleapis.com").rstrip("/")
        if "://" not in self.endpoint:
            self.endpoint = "http://" + self.endpoint
        self._emulated = "storage.googleapis.com" not in self.endpoint
        self.timeout = timeout
        self._token: Optional[str] = None
        self._token_expiry = 0.0

    # -- auth ----------------------------------------------------------------

    def _auth_header(self) -> dict:
        if self._emulated:
            return {}
        tok = self._get_token()
        return {"Authorization": f"Bearer {tok}"} if tok else {}

    def _get_token(self) -> Optional[str]:
        if self._token is not None and time.time() < self._token_expiry:
            return self._token
        tok, ttl = self._fetch_token()
        self._token = tok
        self._token_expiry = time.time() + ttl
        return tok

    def _fetch_token(self) -> Tuple[Optional[str], float]:
        env = os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
        if env:
            return env, 300.0
        try:  # GCE/TPU-VM metadata server: THE production path
            req = urllib.request.Request(
                _METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"})
            with urllib.request.urlopen(req, timeout=2.0) as r:
                d = json.loads(r.read())
            return d["access_token"], max(60.0, d.get("expires_in", 300) - 60)
        except Exception:
            pass
        try:  # workstation fallback
            tok = subprocess.run(
                ["gcloud", "auth", "print-access-token"],
                capture_output=True, text=True, timeout=20).stdout.strip()
            if tok:
                return tok, 300.0
        except Exception:
            pass
        print("gcs: no credentials found (metadata server, "
              "GOOGLE_OAUTH_ACCESS_TOKEN, gcloud all unavailable) — "
              "proceeding anonymously", file=sys.stderr)
        return None, 300.0

    # -- requests with retry -------------------------------------------------

    def _open(self, url: str, headers: Optional[dict] = None):
        """GET with auth + the shared retry loop."""
        return http_get_with_retry(
            url, {**self._auth_header(), **(headers or {})}, self.timeout)

    # -- API -----------------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = ""
                     ) -> List[Tuple[str, int]]:
        """[(name, size), ...] under prefix, paginated, name-sorted."""
        return [(n, s) for n, s, _ in self.list_objects_meta(bucket, prefix)]

    def list_objects_meta(self, bucket: str, prefix: str = ""
                          ) -> List[Tuple[str, int, Optional[str]]]:
        """[(name, size, generation), ...] under prefix, paginated,
        name-sorted. Generation rides the same listing request (one extra
        field) so freshness tokens cost no additional round trips; servers
        that omit it (older emulators) yield None."""
        out: List[Tuple[str, int, Optional[str]]] = []
        token = None
        while True:
            q = {"prefix": prefix,
                 "fields": "items(name,size,generation),nextPageToken"}
            if token:
                q["pageToken"] = token
            url = (f"{self.endpoint}/storage/v1/b/"
                   f"{urllib.parse.quote(bucket, safe='')}/o?"
                   + urllib.parse.urlencode(q))
            with self._open(url) as r:
                d = json.loads(r.read())
            out.extend((it["name"], int(it.get("size", 0)),
                        it.get("generation"))
                       for it in d.get("items", []))
            token = d.get("nextPageToken")
            if not token:
                break
        return sorted(out)

    def _media_url(self, bucket: str, name: str) -> str:
        return (f"{self.endpoint}/storage/v1/b/"
                f"{urllib.parse.quote(bucket, safe='')}/o/"
                f"{urllib.parse.quote(name, safe='')}?alt=media")

    def read_object(self, bucket: str, name: str) -> bytes:
        with self._open(self._media_url(bucket, name)) as r:
            return r.read()

    def open_stream(self, bucket: str, name: str,
                    start: int = 0) -> "GcsRangeStream":
        """Byte stream from `start` with transparent reconnect-and-resume
        (the per-tar streamed GetObject of the reference's ingest)."""
        return GcsRangeStream(self, bucket, name, start)


class GcsRangeStream(io.RawIOBase):
    """Read-only streamed object body. A mid-read connection failure
    reopens the request with `Range: bytes=<current position>-` — the
    stream position never goes backwards and nothing is re-yielded."""

    def __init__(self, client: GcsClient, bucket: str, name: str,
                 start: int = 0):
        self._client = client
        self._bucket = bucket
        self._name = name
        self._pos = int(start)
        self._resp = None
        self._eof = False
        self._end: Optional[int] = None  # pos + remaining Content-Length

    def _connect(self):
        headers = {}
        if self._pos:
            headers["Range"] = f"bytes={self._pos}-"
        try:
            self._resp = self._client._open(
                self._client._media_url(self._bucket, self._name),
                headers=headers)
        except urllib.error.HTTPError as e:
            if e.code == 416:  # start is at/past EOF: empty stream
                self._resp = io.BytesIO(b"")
                self._eof = True
                return
            raise
        # a server ignoring Range would silently re-serve from byte 0 and
        # corrupt the tar stream mid-resume — fail loudly instead
        if self._pos and getattr(self._resp, "status", 206) != 206:
            raise IOError(
                f"gcs: server ignored Range bytes={self._pos}- for "
                f"gs://{self._bucket}/{self._name}")
        # http.client returns b"" (not an error) when a length-delimited
        # body is truncated by a dropped connection — remember where the
        # body SHOULD end so a short b"" is treated as a disconnect, not
        # EOF (a silently shortened tar would drop examples)
        cl = self._resp.headers.get("Content-Length")
        self._end = self._pos + int(cl) if cl is not None else None
        if self._end is None:
            # chunked-transfer proxy/emulator: a dropped connection then
            # looks exactly like EOF — truncation detection is OFF. Say
            # so once rather than silently degrade.
            warnings.warn(
                f"gcs: no Content-Length for gs://{self._bucket}/"
                f"{self._name} — truncated-body detection disabled for "
                f"this stream", RuntimeWarning, stacklevel=2)

    def readable(self) -> bool:
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = []
            while True:
                c = self.read(1 << 20)
                if not c:
                    return b"".join(chunks)
                chunks.append(c)
        if self._eof:
            return b""
        last: Optional[BaseException] = None
        for attempt in range(RETRIES):
            if self._resp is None:
                self._connect()
                if self._eof:
                    return b""
            try:
                data = self._resp.read(n)
            except (ConnectionError, TimeoutError, OSError,
                    urllib.error.URLError,
                    http.client.HTTPException) as e:  # e.g. IncompleteRead
                last = e
                try:
                    self._resp.close()
                except Exception:
                    pass
                self._resp = None  # reconnect from self._pos
                if attempt < RETRIES - 1:
                    time.sleep(retry_delay(attempt, last))
                continue
            if data:
                self._pos += len(data)
                return data
            if self._end is not None and self._pos < self._end:
                # truncated body: reconnect and resume from _pos
                last = ConnectionError(
                    f"body ended at {self._pos}, expected {self._end}")
                try:
                    self._resp.close()
                except Exception:
                    pass
                self._resp = None
                if attempt < RETRIES - 1:
                    time.sleep(retry_delay(attempt, last))
                continue
            self._eof = True
            return data
        raise ConnectionError(
            f"gcs: read of gs://{self._bucket}/{self._name} at byte "
            f"{self._pos} failed after {RETRIES} reconnects") from last

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        if self._resp is not None:
            try:
                self._resp.close()
            except Exception:
                pass
            self._resp = None
        super().close()


#: gs:// url -> byte size, filled by listings so per-shard size lookups
#: (corpus identity, host weight estimates) cost no extra round trips
_SIZE_CACHE: dict = {}

#: gs:// url -> (size, generation), filled alongside _SIZE_CACHE — the
#: freshness token pair the member-index staleness check compares (size
#: alone misses an equal-size replacement; generation cannot)
_STAT_CACHE: dict = {}

#: endpoint -> shared GcsClient: the token cache lives on the client, and
#: the ingest hot path opens one stream per tar per epoch — a fresh client
#: per call would re-fetch credentials (a metadata-server round trip, or
#: worse a `gcloud` subprocess) on every shard open. Keyed by endpoint so
#: tests that repoint STORAGE_EMULATOR_HOST get a matching client.
_CLIENTS: dict = {}


def _shared_client() -> "GcsClient":
    ep = (os.environ.get("STORAGE_EMULATOR_HOST")
          or "https://storage.googleapis.com")
    client = _CLIENTS.get(ep)
    if client is None:
        client = _CLIENTS[ep] = GcsClient()
    return client


def gs_list_shards(root: str, prefix: str = "") -> List[str]:
    """gs:// analogue of `imagenet.list_shards`: all .tar objects under
    root whose basename starts with prefix, as gs:// urls, sorted."""
    bucket, base = parse_gs_url(root)
    if base and not base.endswith("/"):
        base += "/"
    client = _shared_client()
    out = []
    for name, size, gen in client.list_objects_meta(bucket, base):
        rel = name[len(base):]
        if "/" in rel:  # direct children only, like os.listdir
            continue
        if rel.startswith(prefix) and rel.endswith(".tar"):
            url = f"gs://{bucket}/{name}"
            _SIZE_CACHE[url] = size
            _STAT_CACHE[url] = (size, gen)
            out.append(url)
    if not out:
        raise FileNotFoundError(f"no .tar shards under {root!r} "
                                f"matching prefix {prefix!r}")
    return sorted(out)


def gs_list_urls(root: str) -> List[str]:
    """ALL object urls under a gs:// prefix (recursive, sorted; empty list
    when nothing matches — unlike gs_list_shards this is not tar-specific
    and a bare prefix is not an error: the checkpoint store lists a
    possibly-empty directory)."""
    bucket, base = parse_gs_url(root)
    if base and not base.endswith("/"):
        base += "/"
    out = []
    for name, size, gen in _shared_client().list_objects_meta(bucket, base):
        url = f"gs://{bucket}/{name}"
        _SIZE_CACHE[url] = size
        _STAT_CACHE[url] = (size, gen)
        out.append(url)
    return sorted(out)


def gs_size(url: str, fresh: bool = False) -> int:
    """Object byte size: listing cache first, else one metadata GET.
    `fresh=True` bypasses the cache (one metadata GET) — used to detect
    an object replaced under a warm member index."""
    if not fresh and url in _SIZE_CACHE:
        return _SIZE_CACHE[url]
    return gs_stat(url, fresh=fresh)[0]


def gs_stat(url: str, fresh: bool = False
            ) -> Tuple[int, Optional[str]]:
    """(size, generation) from one metadata GET (`?fields=size,generation`
    — the same request the size-only check used, one extra field). The
    generation is the freshness token the member-index staleness check
    needs: an EQUAL-size replacement changes generation even though size
    alone cannot see it."""
    if not fresh and url in _STAT_CACHE:
        return _STAT_CACHE[url]
    bucket, name = parse_gs_url(url)
    client = _shared_client()
    u = (f"{client.endpoint}/storage/v1/b/"
         f"{urllib.parse.quote(bucket, safe='')}/o/"
         f"{urllib.parse.quote(name, safe='')}?fields=size,generation")
    with client._open(u) as r:
        d = json.loads(r.read())
    stat = (int(d.get("size", 0)), d.get("generation"))
    _SIZE_CACHE[url] = stat[0]
    _STAT_CACHE[url] = stat
    return stat


def gs_read(url: str) -> bytes:
    bucket, name = parse_gs_url(url)
    return _shared_client().read_object(bucket, name)


def gs_open_stream(url: str, start: int = 0) -> GcsRangeStream:
    bucket, name = parse_gs_url(url)
    return _shared_client().open_stream(bucket, name, start)


def gs_write(url: str, data: bytes) -> None:
    """Upload bytes to a gs:// object (simple media upload) — the push
    side of the ingest tooling (the reference's sharder uploaded its
    chunks to the object store, `scripts/put_imagenet_on_s3.py`)."""
    bucket, name = parse_gs_url(url)
    client = _shared_client()
    u = (f"{client.endpoint}/upload/storage/v1/b/"
         f"{urllib.parse.quote(bucket, safe='')}/o?uploadType=media&name="
         f"{urllib.parse.quote(name, safe='')}")
    with http_get_with_retry(
            u, {**client._auth_header(),
                "Content-Type": "application/octet-stream"},
            client.timeout, method="POST", data=data) as r:
        r.read()
    _SIZE_CACHE[url] = len(data)
    _STAT_CACHE.pop(url, None)


def gs_delete(url: str, missing_ok: bool = True) -> None:
    """DELETE an object; 404 is success when `missing_ok` (retention and
    part cleanup race nothing — only one writer per checkpoint dir)."""
    bucket, name = parse_gs_url(url)
    client = _shared_client()
    u = (f"{client.endpoint}/storage/v1/b/"
         f"{urllib.parse.quote(bucket, safe='')}/o/"
         f"{urllib.parse.quote(name, safe='')}")
    try:
        with http_get_with_retry(u, client._auth_header(), client.timeout,
                                 method="DELETE") as r:
            r.read()
    except urllib.error.HTTPError as e:
        if not (missing_ok and e.code == 404):
            raise
    _SIZE_CACHE.pop(url, None)
    _STAT_CACHE.pop(url, None)


# -- resumable / composite upload (the checkpoint writer's push side) --------

#: resumable-upload chunk granularity — the GCS protocol requires every
#: non-final chunk be a multiple of 256 KiB; 8 MiB balances per-chunk HTTP
#: overhead against retry re-send cost
GS_UPLOAD_CHUNK = 8 << 20

#: component count for parallel composite uploads of large blobs (the
#: ~244 MB checkpoint state.npz): each part is its own resumable session
#: on its own thread, then one compose call finalizes the object
GS_UPLOAD_PARALLEL = 4


def gs_write_resumable(url: str, data,
                       chunk_bytes: Optional[int] = None) -> None:
    """Upload bytes-like `data` (bytes or a zero-copy memoryview) via ONE
    resumable-upload session: initiate (POST
    `uploadType=resumable` -> session URL), then sequential chunk PUTs with
    `Content-Range`. The object becomes visible only when the FINAL chunk
    lands — a killed writer leaves no partial object, which is the
    atomicity the checkpoint store's upload-then-finalize protocol needs.
    Intermediate chunks answer 308 (Resume Incomplete); the final one 200."""
    if chunk_bytes is None:
        chunk_bytes = GS_UPLOAD_CHUNK  # read at call time: patchable
    if chunk_bytes % (256 << 10):
        raise ValueError(f"chunk_bytes {chunk_bytes} is not a multiple of "
                         f"256 KiB (GCS resumable-upload granularity)")
    bucket, name = parse_gs_url(url)
    client = _shared_client()
    u = (f"{client.endpoint}/upload/storage/v1/b/"
         f"{urllib.parse.quote(bucket, safe='')}/o?uploadType=resumable"
         f"&name={urllib.parse.quote(name, safe='')}")
    with http_get_with_retry(
            u, {**client._auth_header(),
                "x-upload-content-length": str(len(data)),
                "Content-Type": "application/octet-stream"},
            client.timeout, method="POST") as r:
        r.read()
        session = r.headers.get("Location")
    if not session:
        raise IOError(f"gcs: resumable-upload initiate for {url} returned "
                      f"no session Location")
    total = len(data)
    sent = 0
    while True:
        # bytes() per chunk: `data` may be a zero-copy memoryview of the
        # serialized state (checkpoint writer); urllib needs real bytes,
        # so copy only one chunk at a time, never the whole blob
        chunk = bytes(data[sent:sent + chunk_bytes])
        end = sent + len(chunk) - 1
        rng = (f"bytes {sent}-{end}/{total}" if chunk
               else f"bytes */{total}")  # zero-byte object: one finalize PUT
        try:
            with http_get_with_retry(
                    session, {"Content-Range": rng}, client.timeout,
                    method="PUT", data=chunk) as r:
                r.read()
        except urllib.error.HTTPError as e:
            if e.code != 308:  # 308 = chunk accepted, session continues
                raise
        sent += len(chunk)
        if sent >= total:
            break
    _SIZE_CACHE[url] = total
    _STAT_CACHE.pop(url, None)


def gs_compose(dest_url: str, part_urls: List[str]) -> None:
    """Server-side compose of up to 32 source objects into `dest_url` (the
    finalize step of a parallel composite upload): the destination appears
    atomically, or not at all."""
    bucket, name = parse_gs_url(dest_url)
    parts = []
    for p in part_urls:
        b, n = parse_gs_url(p)
        if b != bucket:
            raise ValueError(f"compose source {p} not in bucket {bucket}")
        parts.append(n)
    client = _shared_client()
    u = (f"{client.endpoint}/storage/v1/b/"
         f"{urllib.parse.quote(bucket, safe='')}/o/"
         f"{urllib.parse.quote(name, safe='')}/compose")
    body = json.dumps({"sourceObjects": [{"name": n} for n in parts]}
                      ).encode()
    with http_get_with_retry(
            u, {**client._auth_header(),
                "Content-Type": "application/json"},
            client.timeout, method="POST", data=body) as r:
        r.read()
    _SIZE_CACHE.pop(dest_url, None)
    _STAT_CACHE.pop(dest_url, None)


def gs_write_large(url: str, data, *,
                   parallel: Optional[int] = None,
                   chunk_bytes: Optional[int] = None) -> None:
    """Bulk upload of bytes-like `data` (bytes, or a memoryview that is
    never copied whole) for multi-hundred-MB blobs (checkpoint state.npz):
    split into `parallel` component objects uploaded CONCURRENTLY (each its
    own resumable session — gsutil's parallel composite upload shape), then
    one compose finalizes the destination and the parts are deleted. Small
    payloads (one chunk or parallel=1) take a single resumable session.
    Either way the destination object appears atomically: a writer killed
    mid-upload leaves at most invisible sessions / stray `.part-` objects,
    never a torn destination."""
    if parallel is None:
        parallel = GS_UPLOAD_PARALLEL
    if chunk_bytes is None:
        chunk_bytes = GS_UPLOAD_CHUNK
    if parallel <= 1 or len(data) <= chunk_bytes:
        gs_write_resumable(url, data, chunk_bytes)
        return
    from concurrent.futures import ThreadPoolExecutor
    n = min(parallel, -(-len(data) // chunk_bytes))
    # part boundaries on chunk granularity (non-final resumable chunks
    # must be 256 KiB-aligned; aligning parts keeps every chunk aligned)
    per = -(-len(data) // n)
    per = -(-per // chunk_bytes) * chunk_bytes
    bounds = [(i, min(i + per, len(data)))
              for i in range(0, len(data), per)]
    nonce = os.urandom(6).hex()
    part_urls = [f"{url}.part-{nonce}-{k:04d}" for k in range(len(bounds))]
    try:
        with ThreadPoolExecutor(len(bounds),
                                thread_name_prefix="gs-part") as ex:
            list(ex.map(lambda ab: gs_write_resumable(
                ab[0], data[ab[1][0]:ab[1][1]], chunk_bytes),
                zip(part_urls, bounds)))
        gs_compose(url, part_urls)
    finally:
        for p in part_urls:  # success or abort: parts must not linger
            try:
                gs_delete(p)
            except Exception:
                pass
    _SIZE_CACHE[url] = len(data)
    _STAT_CACHE.pop(url, None)
