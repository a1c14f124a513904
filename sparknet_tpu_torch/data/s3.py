"""Native `s3://` object-store ingest — the reference's actual data plane.

The port's copy of `sparknet_tpu/data/s3.py`; it shares the port's `gcs`
retry and range-stream machinery.

The reference streamed ImageNet straight from S3, one `AmazonS3Client.
getObject` per tar (`loaders/ImageNetLoader.scala:62-63`; upload side
`scripts/put_imagenet_on_s3.py`). This module gives the loaders the same
capability with no SDK: listing (ListObjectsV2), whole-object fetch, and
ranged streams with reconnect-resume, over plain HTTPS with AWS Signature
Version 4 computed from the stdlib (hmac/hashlib — SigV4 is just a chain
of HMAC-SHA256s).

Credentials: AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY (+ optional
AWS_SESSION_TOKEN) from the environment — the same channel the reference
used (its README.md:46-56 exported the keys). Anonymous requests (public
buckets) are made when no keys are set. Region from AWS_REGION /
AWS_DEFAULT_REGION, else us-east-1.

`AWS_ENDPOINT_URL` (the conventional S3-emulator knob) redirects all
traffic — tests run a local fake server through the full path, signature
included. Retry/resume semantics are shared with the GCS client
(`gcs.GcsRangeStream` drives the reconnects): a dropped connection mid-tar
resumes with `Range: bytes=<pos>-`; a truncated body is detected against
Content-Length and resumed, never treated as EOF.
"""
from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

from . import gcs as _gcs  # shared retry/range-stream machinery

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _canon_query(q: dict) -> str:
    """SigV4 canonical query string: sorted keys, %20-quoted values
    (urlencode's '+' form would sign a different string than AWS
    canonicalizes)."""
    return "&".join(
        f"{urllib.parse.quote(k, safe='')}="
        f"{urllib.parse.quote(v, safe='')}"
        for k, v in sorted(q.items()))


def parse_s3_url(url: str) -> Tuple[str, str]:
    """'s3://bucket/some/prefix' -> ('bucket', 'some/prefix')."""
    if not url.startswith("s3://"):
        raise ValueError(f"not an s3:// url: {url!r}")
    rest = url[len("s3://"):]
    bucket, _, name = rest.partition("/")
    if not bucket:
        raise ValueError(f"s3:// url missing bucket: {url!r}")
    return bucket, name


def is_s3_path(path: str) -> bool:
    return isinstance(path, str) and path.startswith("s3://")


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3Client:
    """Minimal SigV4-signing S3 client over the shared urllib machinery."""

    def __init__(self, endpoint: Optional[str] = None,
                 region: Optional[str] = None, timeout: float = 60.0):
        self.endpoint = (endpoint or os.environ.get("AWS_ENDPOINT_URL")
                         or "").rstrip("/")
        self.region = (region or os.environ.get("AWS_REGION")
                       or os.environ.get("AWS_DEFAULT_REGION")
                       or "us-east-1")
        self.timeout = timeout
        self.access_key = os.environ.get("AWS_ACCESS_KEY_ID")
        self.secret_key = os.environ.get("AWS_SECRET_ACCESS_KEY")
        self.session_token = os.environ.get("AWS_SESSION_TOKEN")

    # -- SigV4 ---------------------------------------------------------------

    def _sign(self, method: str, host: str, path: str, query: str,
              headers: dict, payload_hash: str = _EMPTY_SHA256) -> dict:
        """Add Authorization (+ x-amz-*) headers. SigV4 per the AWS spec:
        canonical request -> string-to-sign -> HMAC chain (date, region,
        service, 'aws4_request'). `payload_hash` is sha256(body) for PUTs
        (the empty-body hash for GETs)."""
        if not self.access_key or not self.secret_key:
            return headers  # anonymous (public bucket)
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = dict(headers)
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash
        if self.session_token:
            headers["x-amz-security-token"] = self.session_token
        all_h = {**headers, "host": host}
        signed = ";".join(sorted(k.lower() for k in all_h))
        canonical = "\n".join([
            method,
            urllib.parse.quote(path, safe="/-_.~"),
            query,
            "".join(f"{k}:{all_h[k2].strip()}\n" for k, k2 in
                    sorted((k.lower(), k) for k in all_h)),
            signed,
            payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
        key = _hmac(_hmac(_hmac(_hmac(
            ("AWS4" + self.secret_key).encode(), datestamp),
            self.region), "s3"), "aws4_request")
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}")
        return headers

    def _url_parts(self, bucket: str, key: str = ""
                   ) -> Tuple[str, str, str]:
        """(base_url, host, path). Custom endpoints use path-style
        addressing (emulators rarely speak virtual-hosted); AWS proper
        uses virtual-hosted-style."""
        if self.endpoint:
            host = urllib.parse.urlparse(self.endpoint).netloc
            path = f"/{bucket}" + (f"/{key}" if key else "")
            return self.endpoint, host, path
        host = f"{bucket}.s3.{self.region}.amazonaws.com"
        return f"https://{host}", host, ("/" + key if key else "/")

    def _request(self, bucket: str, key: str, query: str = "",
                 headers: Optional[dict] = None, method: str = "GET",
                 data: Optional[bytes] = None):
        base, host, path = self._url_parts(bucket, key)
        payload = (hashlib.sha256(data).hexdigest() if data is not None
                   else _EMPTY_SHA256)
        url = base + urllib.parse.quote(path, safe="/-_.~")
        if query:
            url += "?" + query
        # sign PER ATTEMPT (headers_fn): every multipart part PUT,
        # CompleteMultipartUpload POST, and ranged-GET reconnect shares
        # the transport's full-jitter backoff (Retry-After honored on
        # 429 and S3's `503 SlowDown`), and each retry carries a fresh
        # x-amz-date — a retry that slept out a long Retry-After floor
        # must not replay a signature into the SigV4 clock-skew window
        return _gcs.http_get_with_retry(
            url, None, self.timeout, method=method, data=data,
            headers_fn=lambda: self._sign(method, host, path, query,
                                          dict(headers or {}),
                                          payload_hash=payload))

    # -- API -----------------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = ""
                     ) -> List[Tuple[str, int]]:
        """[(key, size), ...] under prefix (ListObjectsV2, paginated)."""
        return [(k, s) for k, s, _ in self.list_objects_meta(bucket, prefix)]

    def list_objects_meta(self, bucket: str, prefix: str = ""
                          ) -> List[Tuple[str, int, Optional[str]]]:
        """[(key, size, etag), ...] under prefix (ListObjectsV2,
        paginated). The ETag rides the listing XML AWS already returns —
        the freshness token for warm member indexes, parallel to the GCS
        generation."""
        out: List[Tuple[str, int, Optional[str]]] = []
        token = None
        while True:
            q = {"list-type": "2", "prefix": prefix}
            if token:
                q["continuation-token"] = token
            with self._request(bucket, "", query=_canon_query(q)) as r:
                root = ET.fromstring(r.read())
            ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
            for c in root.findall(f"{ns}Contents"):
                et = c.find(f"{ns}ETag")
                out.append((c.find(f"{ns}Key").text,
                            int(c.find(f"{ns}Size").text or 0),
                            et.text.strip('"') if et is not None
                            and et.text else None))
            trunc = root.find(f"{ns}IsTruncated")
            if trunc is None or trunc.text != "true":
                break
            nxt = root.find(f"{ns}NextContinuationToken")
            token = nxt.text if nxt is not None else None
            if not token:
                break
        return sorted(out)

    def read_object(self, bucket: str, key: str) -> bytes:
        with self._request(bucket, key) as r:
            return r.read()

    def open_stream(self, bucket: str, key: str,
                    start: int = 0) -> "_S3RangeStream":
        return _S3RangeStream(self, bucket, key, start)


class _S3RangeStream(_gcs.GcsRangeStream):
    """GcsRangeStream with the connect step swapped for a signed S3 GET —
    inherits the reconnect/resume/truncation logic unchanged."""

    def __init__(self, client: S3Client, bucket: str, key: str,
                 start: int = 0):
        super().__init__(client=None, bucket=bucket, name=key, start=start)
        self._s3 = client

    def _connect(self):
        import io
        import urllib.error
        headers = {}
        if self._pos:
            headers["Range"] = f"bytes={self._pos}-"
        try:
            self._resp = self._s3._request(self._bucket, self._name,
                                           headers=headers)
        except urllib.error.HTTPError as e:
            if e.code == 416:
                self._resp = io.BytesIO(b"")
                self._eof = True
                return
            raise
        if self._pos and getattr(self._resp, "status", 206) != 206:
            raise IOError(
                f"s3: server ignored Range bytes={self._pos}- for "
                f"s3://{self._bucket}/{self._name}")
        cl = self._resp.headers.get("Content-Length")
        self._end = self._pos + int(cl) if cl is not None else None


#: s3:// url -> byte size (filled by listings, like gcs._SIZE_CACHE)
_SIZE_CACHE: dict = {}
#: s3:// url -> (size, etag) — the freshness token pair (gcs._STAT_CACHE)
_STAT_CACHE: dict = {}
_CLIENTS: dict = {}


def _shared_client() -> S3Client:
    ep = os.environ.get("AWS_ENDPOINT_URL") or "aws"
    client = _CLIENTS.get(ep)
    if client is None:
        client = _CLIENTS[ep] = S3Client()
    return client


def s3_list_shards(root: str, prefix: str = "") -> List[str]:
    """s3:// analogue of `imagenet.list_shards`."""
    bucket, base = parse_s3_url(root)
    if base and not base.endswith("/"):
        base += "/"
    out = []
    for key, size, etag in _shared_client().list_objects_meta(bucket, base):
        rel = key[len(base):]
        if "/" in rel:
            continue
        if rel.startswith(prefix) and rel.endswith(".tar"):
            url = f"s3://{bucket}/{key}"
            _SIZE_CACHE[url] = size
            _STAT_CACHE[url] = (size, etag)
            out.append(url)
    if not out:
        raise FileNotFoundError(f"no .tar shards under {root!r} "
                                f"matching prefix {prefix!r}")
    return sorted(out)


def s3_list_urls(root: str) -> List[str]:
    """ALL object urls under an s3:// prefix (recursive, sorted; empty
    list when nothing matches) — the checkpoint store's directory listing."""
    bucket, base = parse_s3_url(root)
    if base and not base.endswith("/"):
        base += "/"
    out = []
    for key, size, etag in _shared_client().list_objects_meta(bucket, base):
        url = f"s3://{bucket}/{key}"
        _SIZE_CACHE[url] = size
        _STAT_CACHE[url] = (size, etag)
        out.append(url)
    return sorted(out)


def s3_read(url: str) -> bytes:
    bucket, key = parse_s3_url(url)
    return _shared_client().read_object(bucket, key)


def s3_open_stream(url: str, start: int = 0) -> _S3RangeStream:
    bucket, key = parse_s3_url(url)
    return _shared_client().open_stream(bucket, key, start)


def s3_write(url: str, data: bytes) -> None:
    """Upload bytes to an s3:// object (SigV4-signed PUT with the payload
    hash) — the reference sharder's upload side
    (`scripts/put_imagenet_on_s3.py`). Content-Type is set (and signed)
    explicitly: urllib would otherwise inject form-urlencoded, which S3
    stores as the object's type."""
    bucket, key = parse_s3_url(url)
    with _shared_client()._request(
            bucket, key, method="PUT", data=data,
            headers={"Content-Type": "application/octet-stream"}) as r:
        r.read()
    _SIZE_CACHE[url] = len(data)
    _STAT_CACHE.pop(url, None)


def s3_size(url: str, fresh: bool = False) -> int:
    if not fresh and url in _SIZE_CACHE:
        return _SIZE_CACHE[url]
    return s3_stat(url, fresh=fresh)[0]


def s3_stat(url: str, fresh: bool = False) -> Tuple[int, Optional[str]]:
    """(size, etag) from one `bytes=0-0` ranged GET (the same request the
    size-only probe made — the ETag header rides along for free). The ETag
    is the freshness token: an equal-size replacement changes it."""
    import urllib.error
    if not fresh and url in _STAT_CACHE:
        return _STAT_CACHE[url]
    bucket, key = parse_s3_url(url)
    client = _shared_client()
    try:
        with client._request(bucket, key,
                             headers={"Range": "bytes=0-0"}) as r:
            cr = r.headers.get("Content-Range", "")
            size = (int(cr.rpartition("/")[2]) if "/" in cr
                    else int(r.headers.get("Content-Length", 0)))
            etag = (r.headers.get("ETag") or "").strip('"') or None
    except urllib.error.HTTPError as e:
        # a ZERO-byte object cannot satisfy bytes=0-0: AWS answers 416
        # with the total in Content-Range ("bytes */0")
        if e.code != 416:
            raise
        cr = e.headers.get("Content-Range", "")
        size = int(cr.rpartition("/")[2]) if "/" in cr else 0
        etag = (e.headers.get("ETag") or "").strip('"') or None
    _SIZE_CACHE[url] = size
    _STAT_CACHE[url] = (size, etag)
    return size, etag


def s3_delete(url: str, missing_ok: bool = True) -> None:
    """Signed DELETE; 404 is success when `missing_ok`."""
    import urllib.error
    bucket, key = parse_s3_url(url)
    try:
        with _shared_client()._request(bucket, key, method="DELETE") as r:
            r.read()
    except urllib.error.HTTPError as e:
        if not (missing_ok and e.code == 404):
            raise
    _SIZE_CACHE.pop(url, None)
    _STAT_CACHE.pop(url, None)


#: multipart part size — AWS requires >= 5 MiB per non-final part; 8 MiB
#: matches the GCS chunk for comparable retry re-send cost
S3_UPLOAD_PART = 8 << 20
S3_UPLOAD_PARALLEL = 4


def s3_write_large(url: str, data, *,
                   parallel: Optional[int] = None,
                   part_bytes: Optional[int] = None) -> None:
    """Bulk upload of bytes-like `data` (bytes, or a memoryview that is
    only copied one part at a time) via S3 multipart: initiate ->
    parallel signed UploadPart
    PUTs -> CompleteMultipartUpload. The object appears atomically at
    complete time — a writer killed mid-upload leaves only an invisible
    multipart session (aborted on failure when we still can), never a torn
    object. Payloads of one part or parallel=1 fall back to the plain
    signed PUT (itself atomic)."""
    if parallel is None:
        parallel = S3_UPLOAD_PARALLEL
    if part_bytes is None:
        part_bytes = S3_UPLOAD_PART  # read at call time: patchable
    if parallel <= 1 or len(data) <= part_bytes:
        s3_write(url, bytes(data) if isinstance(data, memoryview)
                 else data)
        return
    from concurrent.futures import ThreadPoolExecutor
    bucket, key = parse_s3_url(url)
    client = _shared_client()
    with client._request(bucket, key, query="uploads=",
                         method="POST") as r:
        root = ET.fromstring(r.read())
    ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
    uid_el = root.find(f"{ns}UploadId")
    if uid_el is None or not uid_el.text:
        raise IOError(f"s3: CreateMultipartUpload for {url} returned no "
                      f"UploadId")
    uid = uid_el.text

    bounds = [(i, min(i + part_bytes, len(data)))
              for i in range(0, len(data), part_bytes)]

    def put_part(n_ab):
        n, (a, b) = n_ab
        q = _canon_query({"partNumber": str(n), "uploadId": uid})
        # bytes() per part: `data` may be a zero-copy memoryview; urllib
        # needs real bytes, so copy one bounded part at a time
        with client._request(bucket, key, query=q, method="PUT",
                             data=bytes(data[a:b])) as r:
            r.read()
            return n, (r.headers.get("ETag") or "").strip('"')

    try:
        with ThreadPoolExecutor(min(parallel, len(bounds)),
                                thread_name_prefix="s3-part") as ex:
            etags = sorted(ex.map(put_part, enumerate(bounds, start=1)))
        body = ("<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber>"
            f"<ETag>\"{e}\"</ETag></Part>" for n, e in etags)
            + "</CompleteMultipartUpload>").encode()
        with client._request(bucket, key,
                             query=_canon_query({"uploadId": uid}),
                             method="POST", data=body) as r:
            resp = r.read()
        # AWS can answer CompleteMultipartUpload with HTTP 200 whose BODY
        # is an <Error> document (e.g. InternalError) — a 200 status does
        # not mean the object materialized. Committing meta.json on top
        # of a failed complete would break the commit-marker invariant.
        root2 = ET.fromstring(resp) if resp.strip() else None
        if root2 is None or root2.tag.endswith("Error"):
            raise IOError(
                f"s3: CompleteMultipartUpload for {url} failed in-body: "
                f"{resp[:200]!r}")
    except BaseException:
        try:  # abort so the store reclaims the parts
            with client._request(bucket, key,
                                 query=_canon_query({"uploadId": uid}),
                                 method="DELETE") as r:
                r.read()
        except Exception:
            pass
        raise
    _SIZE_CACHE[url] = len(data)
    _STAT_CACHE.pop(url, None)
