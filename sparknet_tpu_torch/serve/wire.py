"""The binary frame protocol: length-prefixed tensor transport for the
serve data plane.

The HTTP/1.1 front door (http_frontend.py) pays a re-encode on every
tensor — JSON lists or an npz zip container built per request/response —
plus stdlib header parsing on both sides. Once the forward itself is
cheap (int8) and batches fill (derived bucket ladders), that
per-request wire cost IS the serving cost. This protocol removes it:
a fixed 32-byte header, a compact tensor DESCRIPTOR TABLE
(name/dtype/shape/byte-offset/byte-length), and a payload of raw
row-major tensor bytes. Decoding a request is one `np.frombuffer` view
per input — zero parse, zero copy past the socket read.

Frame layout (everything little-endian)::

    offset  size  field
    0       4     magic      b"SPK1"
    4       1     version    3 (2 = pre-queue-wait RESPONSE meta,
                             1 = the pre-priority REQUEST meta)
    5       1     type       1=REQUEST 2=RESPONSE 3=ERROR 4=CHUNK
                             5=CANCEL 6=SHM_HELLO 7=SHM_RELEASE
    6       2     flags      bit0 STREAM, bit1 LAST (final chunk),
                             bit2 SHM (payload rides a shared-memory
                             segment named in the meta; zero payload
                             bytes follow on the socket)
    8       8     request_id client-chosen; replies carry it back
                             (pipelining: many ids in flight per
                             connection, replies in COMPLETION order)
    16      8     meta_len   bytes of the type-specific meta section
    24      8     payload_len raw tensor bytes after the meta section

followed by `meta_len` meta bytes and `payload_len` payload bytes.
The header carries both lengths, so a reader always knows exactly how
many bytes complete the frame (length-prefixed: no delimiters, no
chunked-encoding scan).

Meta sections (str8 = u8 length + utf-8 bytes; str16 = u16 length):

  REQUEST:  model str8 | tenant str8 | priority str8 ("" = normal;
            the admission priority class, serve/admission.py) |
            deadline_ms f64 (NaN = none) |
            trace str8 ("" = untraced: the encoded TraceContext —
            trace_id, span id, sampling flag, hedge-leg tag — see
            obs/reqtrace.py) |
            n_tensors u16 | descriptor* |
            [seg str8 — only with FLAG_SHM: the shared-memory segment
            holding the payload bytes the descriptors index into]
  RESPONSE: model str8 | step i64 (-1 = unknown) |
            queue_wait_ms f64 (NaN = unknown: time the request sat in
            the batcher queue before its forward started) |
            n_tensors u16 | descriptor* | [seg str8, as above]
            (with FLAG_STREAM: descriptors announce the full payload,
            which follows as CHUNK frames instead of inline bytes —
            payload_len in the RESPONSE header is the TOTAL streamed
            size, its own inline payload is empty)
  ERROR:    code u16 (the HTTP status analog) | kind str8 | msg str16
  CHUNK:    offset u64 into the logical response payload; the frame
            payload is that slice. FLAG_LAST marks the final chunk.
  CANCEL:   (empty meta) — best-effort cancel of the in-flight
            request_id. If the request is still queued it is shed with
            a typed `cancelled` (499) error frame; if it already formed
            into a batch the cancel is DROPPED and the normal response
            arrives — the client must tolerate either reply order.
  SHM_HELLO: client->server: nonce_path str16 | nonce str16 — the
            same-host proof (the server reads nonce_path and grants shm
            only if the contents match the nonce; a remote peer cannot
            read the client's filesystem). server->client: ok u8 —
            1 grants FLAG_SHM frames on this connection, 0 means
            inline payloads only (transparent fallback, not an error).
  SHM_RELEASE: seg str8 — receiver is done with this response segment;
            the sender's ring may reuse the slot. (Request segments
            need no release frame: the terminal reply for the rid IS
            the release.)

  descriptor: name str8 | dtype str8 (numpy dtype.str, e.g. "<f4") |
              ndim u8 | dim u32 * ndim | offset u64 | nbytes u64

Error frames mirror the HTTP error table one-for-one (same codes, same
`error_kind` strings), so `binary_infer` raises the SAME typed
exceptions `http_infer` does and the router's remote-replica proxy is
transport-blind. `request_id == 0` marks a CONNECTION-level error with
no associated request (bad magic/version, over capacity). An oversized
frame's error DOES carry the offending request_id (the header was
readable, so the requester can be told), but — like the rid-0 cases —
the server closes the connection after answering: it will not read its
way through an oversized frame to stay in sync (the binary analog of
HTTP's close-on-413). Either way, a `too_large`/`bad_magic`/
`bad_version` kind means this connection is done after the answer.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"SPK1"
# version 4: REQUEST meta grew the trace str8 field (between deadline_ms
# and the descriptor table) carrying the encoded distributed-trace
# context. The bump is what makes a rolling upgrade honest: a v3 peer
# gets the TYPED bad_version error frame instead of silently misparsing
# the trace bytes as a descriptor count.
# (version 3 grew the RESPONSE queue_wait_ms f64 + the CANCEL/SHM_HELLO/
# SHM_RELEASE frame types and FLAG_SHM; version 2 grew the REQUEST
# priority str8; same discipline each time.)
VERSION = 4
HEADER = struct.Struct("<4sBBHQQQ")
HEADER_LEN = HEADER.size  # 32

T_REQUEST, T_RESPONSE, T_ERROR, T_CHUNK = 1, 2, 3, 4
T_CANCEL, T_SHM_HELLO, T_SHM_RELEASE = 5, 6, 7

FLAG_STREAM = 1  # request: "stream my response"; response: "chunks follow"
FLAG_LAST = 2    # final CHUNK of a streamed response
FLAG_SHM = 4     # payload bytes live in the shm segment named in meta

# the HTTP error table, spelled for the binary wire: (code, kind)
ERR_BAD_REQUEST = (400, "bad_request")
ERR_BAD_MAGIC = (400, "bad_magic")
ERR_BAD_VERSION = (400, "bad_version")
ERR_UNKNOWN_MODEL = (404, "unknown_model")
ERR_TOO_LARGE = (413, "too_large")
ERR_QUEUE_FULL = (429, "queue_full")
ERR_TENANT_LIMIT = (429, "tenant_limit")
ERR_PRIORITY = (429, "priority")
ERR_CANCELLED = (499, "cancelled")
ERR_OVER_CAPACITY = (503, "over_capacity")
ERR_DEADLINE = (503, "deadline")
ERR_NO_REPLICA = (503, "no_replica")
ERR_TIMEOUT = (503, "timeout")
ERR_INTERNAL = (500, "internal")


class WireError(RuntimeError):
    """A protocol violation on the binary wire (bad magic/version,
    malformed meta, oversized frame). The side that detects it answers a
    typed error frame where possible, then closes the connection — one
    bad client never takes the server down."""


@dataclass(frozen=True)
class TensorDesc:
    """One row of the descriptor table."""

    name: str
    dtype: str          # numpy dtype.str ("<f4"), endianness explicit
    shape: Tuple[int, ...]
    offset: int         # byte offset into the frame payload
    nbytes: int


def _pack_str8(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 255:
        raise WireError(f"str8 field too long ({len(b)} bytes)")
    return bytes((len(b),)) + b


def _pack_str16(s: str) -> bytes:
    b = s.encode("utf-8")[:65535]
    return struct.pack("<H", len(b)) + b


class _Reader:
    """Sequential meta-section reader with bounds checks (malformed meta
    raises WireError, never an IndexError deep in struct)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise WireError("truncated meta section")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.take(8))[0]

    def str8(self) -> str:
        return self.take(self.u8()).decode("utf-8")

    def str16(self) -> str:
        # str16 carries error MESSAGES, which the packer truncates at a
        # byte boundary — decode lossy so a clipped multibyte codepoint
        # degrades a character, never the typed error it rides in
        return self.take(self.u16()).decode("utf-8", "replace")


# -- descriptor table ---------------------------------------------------------

def as_bytes_view(arr: np.ndarray) -> memoryview:
    """A flat byte view of the array's buffer — ZERO COPY for contiguous
    arrays (the writer sends straight from the forward's output buffers;
    no serialized second copy of the blob ever exists)."""
    a = np.ascontiguousarray(arr)
    return memoryview(a).cast("B")


def build_table(arrays: Dict[str, np.ndarray]
                ) -> Tuple[List[TensorDesc], List[memoryview], int]:
    """(descriptors, payload byte views, total payload bytes) for a dict
    of tensors. Views are zero-copy; the payload on the wire is their
    concatenation in table order."""
    descs: List[TensorDesc] = []
    views: List[memoryview] = []
    off = 0
    for name, v in arrays.items():
        a = np.asarray(v)
        mv = as_bytes_view(a)
        descs.append(TensorDesc(str(name), a.dtype.str, tuple(a.shape),
                                off, len(mv)))
        views.append(mv)
        off += len(mv)
    return descs, views, off


def _pack_table(descs: Sequence[TensorDesc]) -> bytes:
    parts = [struct.pack("<H", len(descs))]
    for d in descs:
        parts.append(_pack_str8(d.name))
        parts.append(_pack_str8(d.dtype))
        parts.append(bytes((len(d.shape),)))
        parts.append(struct.pack(f"<{len(d.shape)}I", *d.shape)
                     if d.shape else b"")
        parts.append(struct.pack("<QQ", d.offset, d.nbytes))
    return b"".join(parts)


def _read_table(r: _Reader) -> List[TensorDesc]:
    n = r.u16()
    descs = []
    for _ in range(n):
        name = r.str8()
        dtype = r.str8()
        ndim = r.u8()
        shape = tuple(r.u32() for _ in range(ndim))
        offset, nbytes = r.u64(), r.u64()
        descs.append(TensorDesc(name, dtype, shape, offset, nbytes))
    return descs


def tensors_from(descs: Sequence[TensorDesc], payload
                 ) -> Dict[str, np.ndarray]:
    """Descriptor table + payload (bytes/bytearray/memoryview) ->
    {name: array}. One `np.frombuffer` VIEW per tensor (no parse, no
    copy — the zero-decode half of the protocol's reason to exist)."""
    out: Dict[str, np.ndarray] = {}
    for d in descs:
        if d.offset + d.nbytes > len(payload):
            raise WireError(
                f"tensor {d.name!r} overruns the payload "
                f"({d.offset}+{d.nbytes} > {len(payload)})")
        dt = np.dtype(d.dtype)
        count = d.nbytes // dt.itemsize if dt.itemsize else 0
        arr = np.frombuffer(payload, dtype=dt, count=count,
                            offset=d.offset)
        try:
            arr = arr.reshape(d.shape)
        except ValueError as e:
            raise WireError(f"tensor {d.name!r}: {e}") from e
        out[d.name] = arr
    return out


# -- frame packers ------------------------------------------------------------

def _header(ftype: int, flags: int, request_id: int, meta_len: int,
            payload_len: int) -> bytes:
    return HEADER.pack(MAGIC, VERSION, ftype, flags, request_id,
                       meta_len, payload_len)


def pack_request(request_id: int, model: str,
                 payload: Dict[str, np.ndarray],
                 deadline_ms: Optional[float] = None,
                 tenant: Optional[str] = None,
                 priority: Optional[str] = None,
                 stream: bool = False,
                 shm_seg: Optional[str] = None,
                 trace: Optional[str] = None
                 ) -> Tuple[bytes, List[memoryview]]:
    """(header+meta bytes, payload byte views). The caller writes the
    bytes then each view — the tensors are never re-serialized. With
    `shm_seg` the caller has ALREADY copied the payload into that
    shared-memory segment (at the descriptors' offsets): the frame sets
    FLAG_SHM, names the segment in the meta, carries payload_len 0, and
    the returned view list is empty — zero tensor bytes on the socket."""
    descs, views, total = build_table(payload)
    flags = FLAG_STREAM if stream else 0
    tail = b""
    if shm_seg is not None:
        flags |= FLAG_SHM
        tail = _pack_str8(shm_seg)
        views, total = [], 0
    meta = b"".join((
        _pack_str8(model),
        _pack_str8(tenant or ""),
        _pack_str8(priority or ""),
        struct.pack("<d", float("nan") if deadline_ms is None
                    else float(deadline_ms)),
        _pack_str8(trace or ""),
        _pack_table(descs),
        tail))
    head = _header(T_REQUEST, flags, request_id, len(meta), total)
    return head + meta, views


def unpack_request_meta(meta: bytes
                        ) -> Tuple[str, str, str, Optional[float],
                                   Optional[str], List[TensorDesc],
                                   Optional[str]]:
    """-> (model, tenant, priority, deadline_ms, trace, descriptors,
    shm_seg). trace is None when the request is untraced ("" on the
    wire); shm_seg is None for inline payloads (no trailing segment
    name)."""
    r = _Reader(meta)
    model = r.str8()
    tenant = r.str8()
    priority = r.str8()
    deadline_ms = r.f64()
    if deadline_ms != deadline_ms:  # NaN
        deadline = None
    else:
        deadline = float(deadline_ms)
    trace = r.str8() or None
    descs = _read_table(r)
    seg = r.str8() if r.pos < len(meta) else None
    return model, tenant, priority, deadline, trace, descs, seg


def pack_response(request_id: int, model: str, step: Optional[int],
                  arrays: Dict[str, np.ndarray], stream: bool = False,
                  chunk_bytes: int = 256 << 10,
                  queue_wait_ms: Optional[float] = None,
                  shm_seg: Optional[str] = None
                  ) -> List[Tuple[bytes, Optional[memoryview]]]:
    """The response as a list of (copied header/meta bytes, optional
    zero-copy payload view) write items.

    Non-streamed: ONE frame — [(header+meta, None)] + one (b"", view)
    per tensor. Streamed: a RESPONSE frame announcing the table with
    payload_len = total, then CHUNK frames each carrying <= chunk_bytes
    of payload (FLAG_LAST on the final one). Either way the only COPIED
    bytes are the headers — per-connection buffering is bounded by the
    header size, never the blob size. With `shm_seg` (mutually
    exclusive with stream) the caller has already copied the payload
    into that segment: one FLAG_SHM frame, zero payload bytes on the
    socket."""
    descs, views, total = build_table(arrays)
    meta = b"".join((_pack_str8(model),
                     struct.pack("<q", -1 if step is None else int(step)),
                     struct.pack("<d", float("nan") if queue_wait_ms is
                                 None else float(queue_wait_ms)),
                     _pack_table(descs)))
    items: List[Tuple[bytes, Optional[memoryview]]] = []
    if shm_seg is not None:
        assert not stream, "shm responses are single-frame"
        meta += _pack_str8(shm_seg)
        items.append((_header(T_RESPONSE, FLAG_SHM, request_id,
                              len(meta), 0) + meta, None))
        return items
    if not stream:
        items.append((_header(T_RESPONSE, 0, request_id, len(meta),
                              total) + meta, None))
        for v in views:
            items.append((b"", v))
        return items
    items.append((_header(T_RESPONSE, FLAG_STREAM, request_id,
                          len(meta), total) + meta, None))
    chunk_bytes = max(int(chunk_bytes), 1)
    # chunk offsets run over the CONCATENATED payload; a chunk never
    # spans tensors (keeps the slicing trivial and the bound still holds)
    sent = 0
    for vi, v in enumerate(views):
        pos = 0
        while pos < len(v) or (len(v) == 0 and pos == 0):
            piece = v[pos:pos + chunk_bytes]
            pos += len(piece)
            sent += len(piece)
            last = (vi == len(views) - 1) and pos >= len(v)
            meta_c = struct.pack("<Q", sent - len(piece))
            items.append((_header(T_CHUNK, FLAG_LAST if last else 0,
                                  request_id, len(meta_c), len(piece))
                          + meta_c, piece))
            if len(v) == 0:
                break
    if not views:  # empty response still needs its LAST marker
        meta_c = struct.pack("<Q", 0)
        items.append((_header(T_CHUNK, FLAG_LAST, request_id,
                              len(meta_c), 0) + meta_c, None))
    return items


def unpack_response_meta(meta: bytes
                         ) -> Tuple[str, Optional[int], Optional[float],
                                    List[TensorDesc], Optional[str]]:
    """-> (model, step, queue_wait_ms, descriptors, shm_seg)."""
    r = _Reader(meta)
    model = r.str8()
    step = r.i64()
    qw = r.f64()
    queue_wait = None if qw != qw else float(qw)  # NaN = unknown
    descs = _read_table(r)
    seg = r.str8() if r.pos < len(meta) else None
    return model, (None if step < 0 else step), queue_wait, descs, seg


def pack_error(request_id: int, code_kind: Tuple[int, str],
               msg: str) -> bytes:
    code, kind = code_kind
    meta = struct.pack("<H", int(code)) + _pack_str8(kind) \
        + _pack_str16(msg)
    return _header(T_ERROR, 0, request_id, len(meta), 0) + meta


def unpack_error_meta(meta: bytes) -> Tuple[int, str, str]:
    r = _Reader(meta)
    return r.u16(), r.str8(), r.str16()


def unpack_chunk_meta(meta: bytes) -> int:
    return _Reader(meta).u64()


def pack_cancel(request_id: int) -> bytes:
    """Best-effort cancel of an in-flight request_id (empty meta). The
    hedging router sends this for the losing leg; a cancel that loses
    the race to batch formation is simply dropped server-side."""
    return _header(T_CANCEL, 0, request_id, 0, 0)


def pack_shm_hello(request_id: int, nonce_path: str, nonce: str) -> bytes:
    """Client->server shm capability offer. `nonce_path` names a file the
    CLIENT wrote containing `nonce`; a server that can read the matching
    bytes shares the client's filesystem — the same-host proof that
    makes granting named-segment access safe."""
    meta = _pack_str16(nonce_path) + _pack_str16(nonce)
    return _header(T_SHM_HELLO, 0, request_id, len(meta), 0) + meta


def unpack_shm_hello_meta(meta: bytes) -> Tuple[str, str]:
    r = _Reader(meta)
    return r.str16(), r.str16()


def pack_shm_hello_ack(request_id: int, ok: bool) -> bytes:
    """Server->client answer to SHM_HELLO: ok u8 (1 = FLAG_SHM granted
    on this connection, 0 = inline payloads only)."""
    meta = bytes((1 if ok else 0,))
    return _header(T_SHM_HELLO, FLAG_LAST, request_id, len(meta), 0) \
        + meta


def unpack_shm_hello_ack_meta(meta: bytes) -> bool:
    return _Reader(meta).u8() == 1


def pack_shm_release(seg: str) -> bytes:
    """Receiver->sender: done with this response segment, the ring slot
    may be reused. rid 0: releases are per-segment, not per-request."""
    meta = _pack_str8(seg)
    return _header(T_SHM_RELEASE, 0, 0, len(meta), 0) + meta


def unpack_shm_release_meta(meta: bytes) -> str:
    return _Reader(meta).str8()


def parse_header(buf) -> Tuple[int, int, int, int, int]:
    """First HEADER_LEN bytes -> (type, flags, request_id, meta_len,
    payload_len). Raises WireError (with the offending field named) on
    bad magic or version — the caller answers the typed error frame and
    closes."""
    magic, version, ftype, flags, req_id, meta_len, payload_len = \
        HEADER.unpack_from(bytes(buf[:HEADER_LEN]))
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (want {MAGIC!r})")
    if version != VERSION:
        raise WireError(f"unsupported wire version {version} "
                        f"(this server speaks {VERSION})")
    return ftype, flags, req_id, meta_len, payload_len
