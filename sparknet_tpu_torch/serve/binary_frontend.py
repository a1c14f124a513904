"""The binary data plane: a `selectors` event-loop front door speaking
the length-prefixed frame protocol (serve/wire.py), behind the SAME
`InferenceServer`/`ModelRouter` backends as the HTTP frontend.

The counterpart of `sparknet_tpu/serve/binary_frontend.py`; its frames
are byte-equal to the JAX package's, so either package's client talks to
the other's frontend. Why a second wire: the HTTP/1.1 door costs one OS
thread per connection (ThreadingHTTPServer), full-body buffering on both
sides, and an npz/JSON re-encode (`np.savez` / `np.load`) of every
tensor, all under the interpreter lock. This frontend removes all
three:

  - EVENT LOOP, NOT THREAD-PER-CONNECTION: one acceptor (io loop 0's
    listener) plus a small FIXED set of io threads, each running its own
    `selectors` loop over a share of the connections (new connections
    are dealt round-robin). Reads, frame decode (one `np.frombuffer`
    view per tensor — zero parse), submit, and writes for a connection
    all happen on its io thread; 10k idle connections cost file
    descriptors, not threads.
  - PIPELINING: a connection may have MANY request-ids in flight;
    replies are written in COMPLETION order (each response future's
    done-callback enqueues its frames the moment the forward resolves —
    a slow request never convoys the fast ones behind it).
  - CHUNKED RESPONSE STREAMING (flag-gated): a request with FLAG_STREAM
    gets its response as a descriptor-table frame followed by sized
    CHUNK frames written zero-copy from the forward's output buffers —
    first-byte latency decouples from blob size, and the only bytes the
    transport ever COPIES per connection are frame headers (the npz door
    serializes the whole blob into a second buffer before byte one).

Shed-not-hang carries over wholesale: every error path answers a TYPED
error frame (wire.py's table mirrors the HTTP codes one-for-one), a
malformed frame (bad magic/version, oversized) fails ITS connection
alone after a typed answer, and a wedged forward is reaped by the io
loop's timeout sweep — a client of this transport never hangs.

Tail-latency extensions (wire v3):
  - CANCEL frames: a client may cancel an in-flight request id; if the
    request is still queued server-side it resolves with the typed
    `cancelled` error, otherwise the cancel is dropped and the normal
    reply arrives — exactly one terminal frame per id either way. The
    hedging router uses this to reap its losing leg.
  - spkn-shm (serve/shm.py): same-host peers negotiate FLAG_SHM at
    connect (SHM_HELLO + nonce proof); granted, tensor payloads ride
    named shared-memory ring segments in BOTH directions and zero
    payload bytes cross the socket (`payload_rx_bytes` /
    `payload_tx_bytes` pin it; `shm_rx_bytes` / `shm_tx_bytes` count
    what rode the segments). Remote peers fall back inline.
  - Responses carry the request's measured queue wait (`queue_wait_ms`
    in the meta, `BinaryClient.last_timing`), splitting the observed
    tail into queueing vs compute.

`BinaryClient` / `binary_infer` at the bottom are the matching client
(keep-alive, pipelined submits, streaming reassembly, thread-cached) —
`ModelRouter.add_remote_replica(..., transport="binary")` proxies over
it, so cross-replica hops drop the HTTP tax too.
"""
from __future__ import annotations

import itertools
import selectors
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import reqtrace
from ..utils.logger import Logger
from . import shm, wire
from .admission import (PriorityShedError, TenantAdmission,
                        TenantLimitError)
from .batcher import (DeadlineExpiredError, QueueFullError,
                      RequestCancelledError)
from .http_frontend import (BackendAdapter, lru_cache_drop,
                            lru_cache_get, register_transport_metrics)
from .router import NoReplicaError, UnknownModelError
from .server import encode_outputs, pop_outputs

_DEFAULT_WAIT_S = 30.0  # reply bound for requests with no deadline


def _exception_to_err(e: BaseException) -> Tuple[Tuple[int, str], str]:
    """Serve exception -> (wire error (code, kind), message). The exact
    mapping the HTTP frontend's except-ladder implements."""
    if isinstance(e, TenantLimitError):
        return wire.ERR_TENANT_LIMIT, str(e)
    if isinstance(e, PriorityShedError):
        return wire.ERR_PRIORITY, str(e)
    if isinstance(e, QueueFullError):
        return wire.ERR_QUEUE_FULL, str(e)
    if isinstance(e, DeadlineExpiredError):
        return wire.ERR_DEADLINE, str(e)
    if isinstance(e, RequestCancelledError):
        return wire.ERR_CANCELLED, str(e)
    if isinstance(e, NoReplicaError):
        return wire.ERR_NO_REPLICA, str(e)
    if isinstance(e, UnknownModelError):
        return wire.ERR_UNKNOWN_MODEL, str(e)
    # FileNotFoundError: a FLAG_SHM request named a segment this host
    # cannot map — the CLIENT's framing was wrong, not the server
    if isinstance(e, (ValueError, KeyError, TypeError, wire.WireError,
                      FileNotFoundError)):
        return wire.ERR_BAD_REQUEST, str(e)
    return wire.ERR_INTERNAL, f"{type(e).__name__}: {e}"


def raise_for_error(code: int, kind: str, msg: str) -> None:
    """Wire error frame -> the SAME typed exception the local submit
    path (and http_infer) raises — transport-blind remote replicas.
    Protocol violations (bad magic/version, oversized frame) stay
    WireError: they mean OUR framing was wrong, not the request."""
    if kind in ("bad_magic", "bad_version", "too_large"):
        raise wire.WireError(f"server rejected the frame: {kind}: {msg}")
    if kind == "tenant_limit":
        raise TenantLimitError(msg)
    if kind == "priority":
        raise PriorityShedError(msg)
    if code == 429:
        raise QueueFullError(msg)
    if kind == "deadline":
        raise DeadlineExpiredError(msg)
    if kind == "cancelled":
        raise RequestCancelledError(msg)
    if code == 503:
        raise NoReplicaError(msg or f"replica shed ({kind})")
    if code == 404:
        raise UnknownModelError(msg)
    if code == 400:
        raise ValueError(f"binary_infer: {kind}: {msg}")
    raise RuntimeError(f"binary_infer: {code} {kind}: {msg}")


class _Conn:
    """One client connection: owned by exactly one io loop. The outbox
    is the only cross-thread surface (response done-callbacks append
    under `lock`; the io thread drains)."""

    __slots__ = ("sock", "loop", "rbuf", "outbox", "lock", "wview",
                 "wcopied", "closed", "close_after_flush", "inflight",
                 "copied_pending", "peak_copied", "reject_until",
                 "shm_ok", "shm_ring", "shm_segs")

    def __init__(self, sock, loop):
        self.sock = sock
        self.loop = loop
        self.rbuf = bytearray()
        self.outbox: deque = deque()
        self.lock = threading.Lock()
        self.wview: Optional[memoryview] = None
        self.wcopied = False
        self.closed = False
        self.close_after_flush = False
        # reject mode (over capacity): the typed error frame is queued,
        # incoming bytes are discarded (closing with unread request
        # bytes would RST the socket and destroy the answer in flight),
        # and the reaper closes the connection at this deadline if the
        # client hasn't hung up first
        self.reject_until: Optional[float] = None
        # req_id -> (reply bound (monotonic), response future, model,
        # journal row, trace record); popped on completion, or by the
        # reaper (which answers a timeout frame). The future rides along
        # so a CANCEL frame can reach the batcher's queue entry for this
        # id; the trace record so every terminal path can close it.
        self.inflight: Dict[int, Tuple[float, Any, str,
                                       Optional[dict],
                                       Optional[dict]]] = {}
        self.copied_pending = 0   # bytes of COPIED (header) data queued
        self.peak_copied = 0      # its high-water mark
        # spkn-shm (serve/shm.py): granted after a verified SHM_HELLO
        self.shm_ok = False
        self.shm_ring = None      # response-segment ring (lazy)
        self.shm_segs: Dict[str, Any] = {}  # attached request segments


class _IoLoop(threading.Thread):
    """One selectors loop over a share of the connections. `call_soon`
    is the only way other threads touch loop state."""

    def __init__(self, frontend: "BinaryFrontend", idx: int):
        super().__init__(name=f"serve-bin-io-{idx}", daemon=True)
        self.frontend = frontend
        self.idx = idx
        self.sel = selectors.DefaultSelector()
        self._rsock, self._wsock = socket.socketpair()
        self._rsock.setblocking(False)
        self._wsock.setblocking(False)
        self.sel.register(self._rsock, selectors.EVENT_READ, "wake")
        self._pending: List[Any] = []
        self._plock = threading.Lock()
        self.conns: set = set()
        self.running = True
        self._next_reap = 0.0

    def call_soon(self, fn) -> None:
        with self._plock:
            self._pending.append(fn)
        try:
            self._wsock.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # pipe full = a wake is already queued

    def stop(self) -> None:
        self.running = False
        self.call_soon(lambda: None)

    def adopt(self, conn: _Conn) -> None:
        """Register a freshly-accepted connection (loop thread only)."""
        if not self.running:
            conn.sock.close()
            self.frontend._conn_closed()
            return
        self.conns.add(conn)
        self.sel.register(conn.sock, selectors.EVENT_READ, conn)
        self.arm_write(conn)  # an outbox queued pre-adopt (the reject
        #                       path's error frame) must still flush

    def arm_write(self, conn: _Conn) -> None:
        """(Re)compute the interest set (loop thread only)."""
        if conn.closed:
            return
        events = selectors.EVENT_READ
        with conn.lock:
            if conn.outbox or conn.wview is not None:
                events |= selectors.EVENT_WRITE
        try:
            self.sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError):
            pass  # already closed/unregistered

    def run(self) -> None:
        try:
            while self.running:
                events = self.sel.select(timeout=0.25)
                with self._plock:
                    pending, self._pending = self._pending, []
                for fn in pending:
                    fn()
                for key, mask in events:
                    data = key.data
                    if data == "wake":
                        try:
                            while self._rsock.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    elif data == "accept":
                        self.frontend._accept()
                    else:
                        if mask & selectors.EVENT_READ:
                            self._read(data)
                        if mask & selectors.EVENT_WRITE and \
                                not data.closed:
                            self._write(data)
                now = time.monotonic()
                if now >= self._next_reap:
                    self._next_reap = now + 1.0
                    self._reap(now)
        finally:
            for conn in list(self.conns):
                self.close_conn(conn)
            self.sel.close()
            self._rsock.close()
            self._wsock.close()

    # -- per-connection io (loop thread only) --------------------------------

    def _read(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(1 << 18)
        except BlockingIOError:
            return
        except OSError:
            self.close_conn(conn)
            return
        if not data:
            self.close_conn(conn)
            return
        conn.rbuf += data
        self.frontend._process(conn)

    def _write(self, conn: _Conn) -> None:
        while True:
            if conn.wview is None:
                with conn.lock:
                    if not conn.outbox:
                        break
                    conn.wview, conn.wcopied = conn.outbox.popleft()
            try:
                n = conn.sock.send(conn.wview)
            except BlockingIOError:
                break
            except OSError:
                self.close_conn(conn)
                return
            if conn.wcopied:
                with conn.lock:
                    conn.copied_pending -= n
            conn.wview = conn.wview[n:] if n < len(conn.wview) else None
        self.arm_write(conn)
        with conn.lock:
            drained = not conn.outbox and conn.wview is None
        if drained and conn.close_after_flush:
            self.close_conn(conn)

    def _reap(self, now: float) -> None:
        """Answer (typed) any in-flight request past its reply bound —
        a wedged worker must never leave a binary client hanging. Also
        closes reject-mode connections whose client never hung up."""
        for conn in list(self.conns):
            if conn.reject_until is not None:
                if now >= conn.reject_until:
                    self.close_conn(conn)
                continue
            expired: List[Tuple[int, Optional[dict],
                               Optional[dict]]] = []
            with conn.lock:
                for rid, entry in list(conn.inflight.items()):
                    if now >= entry[0]:
                        expired.append((rid, entry[3], entry[4]))
                        del conn.inflight[rid]
            rt = reqtrace.active()
            for rid, jinfo, rec in expired:
                self.frontend._journal_row(jinfo, "timeout")
                if rt is not None and rec is not None:
                    rt.finish(rec, "timeout")
                self.frontend._answer_error(
                    conn, rid, wire.ERR_TIMEOUT,
                    "response wait timed out")

    def close_conn(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        with conn.lock:
            conn.inflight.clear()  # late completions become no-ops
            conn.outbox.clear()
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        # shm teardown: drop request-segment mappings (the client owns
        # and unlinks those) and unlink our response ring. A mapping
        # pinned by a still-live tensor view refuses to close
        # (BufferError) — it falls to process exit, never to a crash.
        for seg in conn.shm_segs.values():
            try:
                seg.close()
            except Exception:
                pass
        conn.shm_segs.clear()
        if conn.shm_ring is not None:
            conn.shm_ring.close()
        self.conns.discard(conn)
        self.frontend._conn_closed()


class BinaryFrontend:
    """The event-loop binary-frame inference endpoint over an
    InferenceServer or ModelRouter. Port 0 binds ephemeral; the bound
    address is `.address`."""

    transport = "binary"

    def __init__(self, backend, port: int = 0, host: str = "127.0.0.1",
                 io_threads: int = 2,
                 max_frame_bytes: int = 64 << 20,
                 chunk_bytes: int = 256 << 10,
                 default_deadline_s: Optional[float] = None,
                 max_connections: int = 4096,
                 tenants: Optional[TenantAdmission] = None,
                 logger: Optional[Logger] = None,
                 enable_shm: bool = True,
                 journal: Optional[Logger] = None):
        assert io_threads >= 1
        self.backend = backend
        self.adapter = BackendAdapter(backend)
        self.default_deadline_s = default_deadline_s
        self.max_frame_bytes = int(max_frame_bytes)
        self.chunk_bytes = int(chunk_bytes)
        self.max_connections = int(max_connections)
        self.tenants = tenants
        self.log = logger
        # spkn-shm: grant FLAG_SHM to same-host peers (serve/shm.py).
        # Sweep segments orphaned by kill -9'd predecessors BEFORE any
        # ring exists — a crashed replica must not leak /dev/shm forever.
        self.enable_shm = bool(enable_shm) and shm.shm_available()
        self.swept_segments = (shm.sweep_orphans()
                               if self.enable_shm else [])
        # request journal: one JSONL row per request frame
        # — arrival shape + outcome — for replaying real traffic shapes
        self.journal = journal
        # tensor payload bytes that crossed THIS socket, per direction
        # (headers/meta excluded). Over shm both stay 0, and the shm
        # counters count the payload bytes that rode segments instead
        self.payload_rx_bytes = 0
        self.payload_tx_bytes = 0
        self.shm_rx_bytes = 0
        self.shm_tx_bytes = 0
        self._byte_lock = threading.Lock()
        self.registry = backend.registry
        self._c_req, self._c_conns, self._g_active, self._c_shed = \
            register_transport_metrics(self.registry, self.transport)
        self.connections = 0       # lifetime accepted
        self.requests = 0          # lifetime request frames
        self.rejected_over_cap = 0
        self._active = 0
        self._active_lock = threading.Lock()
        self._g_active.set_fn(lambda: self._active,
                              transport=self.transport)
        self.peak_buffered_bytes = 0  # max COPIED bytes queued per conn
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1024)
        self._listener.setblocking(False)
        self._loops = [_IoLoop(self, i) for i in range(io_threads)]
        self._loops[0].sel.register(self._listener,
                                    selectors.EVENT_READ, "accept")
        self._rr = itertools.count()
        for lp in self._loops:
            lp.start()
        if logger is not None:
            logger.log(f"serve: binary data plane at "
                       f"spkn://{self.address[0]}:{self.address[1]} "
                       f"({io_threads} io threads, shm "
                       f"{'on' if self.enable_shm else 'off'})")
            if self.swept_segments:
                logger.log(f"serve: swept {len(self.swept_segments)} "
                           f"orphaned shm segment(s) from dead peers")

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.getsockname()[:2]

    def stop(self) -> None:
        for lp in self._loops:
            lp.stop()
        for lp in self._loops:
            lp.join(timeout=5.0)
        try:
            self._listener.close()
        except OSError:
            pass

    def _conn_closed(self) -> None:
        with self._active_lock:
            self._active -= 1

    # -- accept (io loop 0) ---------------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            self.connections += 1
            self._c_conns.inc(transport=self.transport)
            with self._active_lock:
                over = self._active >= self.max_connections
                self._active += 1  # rejects count too (close is
                #                    symmetric for both kinds)
            lp = self._loops[next(self._rr) % len(self._loops)]
            conn = _Conn(sock, lp)
            if over:
                # answered, not refused — but the client is mid-send of
                # its request, so the connection enters REJECT mode:
                # queue the typed frame, discard its input, and let the
                # client hang up after reading the answer (closing now,
                # with unread request bytes queued, would RST the
                # socket and destroy the answer in flight). The reaper
                # bounds a client that never hangs up.
                self.rejected_over_cap += 1
                conn.reject_until = time.monotonic() + 10.0
            lp.call_soon(lambda c=conn, l=lp: l.adopt(c))
            if over:
                # after adopt is queued: the enqueue's write-arm must
                # find the socket registered
                self._answer_error(conn, 0, wire.ERR_OVER_CAPACITY,
                                   "server at connection capacity")

    # -- frame processing (a conn's io thread) --------------------------------

    def _process(self, conn: _Conn) -> None:
        if conn.reject_until is not None:
            conn.rbuf.clear()  # reject mode: input is discarded
            return
        while not conn.closed and not conn.close_after_flush:
            if len(conn.rbuf) < wire.HEADER_LEN:
                return
            try:
                ftype, flags, req_id, meta_len, payload_len = \
                    wire.parse_header(conn.rbuf)
            except wire.WireError as e:
                err = (wire.ERR_BAD_MAGIC if "magic" in str(e)
                       else wire.ERR_BAD_VERSION)
                self._answer_error(conn, 0, err, str(e), close=True)
                return
            if meta_len + payload_len > self.max_frame_bytes:
                # the 413 analog: typed answer, then close THIS
                # connection (we will not read our way through an
                # oversized frame to stay in sync)
                self._answer_error(
                    conn, req_id, wire.ERR_TOO_LARGE,
                    f"frame of {meta_len + payload_len} bytes exceeds "
                    f"the {self.max_frame_bytes}-byte cap", close=True)
                return
            frame_len = wire.HEADER_LEN + meta_len + payload_len
            if len(conn.rbuf) < frame_len:
                return  # length-prefixed: wait for the rest
            meta = bytes(conn.rbuf[wire.HEADER_LEN:
                                   wire.HEADER_LEN + meta_len])
            payload = bytes(conn.rbuf[wire.HEADER_LEN + meta_len:
                                      frame_len])
            del conn.rbuf[:frame_len]
            if ftype == wire.T_CANCEL:
                # best-effort: reaches the batcher's queue entry if the
                # request hasn't formed yet (its future then resolves
                # with the typed `cancelled` error and answers the rid);
                # a cancel that lost the race — or names an unknown/
                # already-answered id — is silently dropped
                with conn.lock:
                    entry = conn.inflight.get(req_id)
                if entry is not None:
                    self.adapter.cancel(entry[2], entry[1])
                continue
            if ftype == wire.T_SHM_HELLO:
                self._handle_shm_hello(conn, req_id, meta)
                continue
            if ftype == wire.T_SHM_RELEASE:
                try:
                    name = wire.unpack_shm_release_meta(meta)
                except wire.WireError:
                    continue  # malformed release: the slot stays busy
                if conn.shm_ring is not None:
                    conn.shm_ring.release(name)
                continue
            if ftype != wire.T_REQUEST:
                self._answer_error(
                    conn, req_id, wire.ERR_BAD_REQUEST,
                    f"unexpected frame type {ftype} (server accepts "
                    f"REQUEST frames)")
                continue
            self._handle_request(conn, flags, req_id, meta, payload)

    def _handle_shm_hello(self, conn: _Conn, req_id: int,
                          meta: bytes) -> None:
        """Grant FLAG_SHM iff the peer proved same-host residency by
        writing a nonce we can read back through OUR filesystem. Any
        failure is a quiet deny — the connection proceeds inline."""
        ok = False
        if self.enable_shm:
            try:
                path, nonce = wire.unpack_shm_hello_meta(meta)
                ok = shm.check_nonce(path, nonce)
            except wire.WireError:
                ok = False
        if ok and conn.shm_ring is None:
            conn.shm_ring = shm.ShmRing()
        conn.shm_ok = ok
        self._enqueue(conn, [(wire.pack_shm_hello_ack(req_id, ok),
                              None)])

    def _handle_request(self, conn: _Conn, flags: int, req_id: int,
                        meta: bytes, payload: bytes) -> None:
        self.requests += 1
        stream = bool(flags & wire.FLAG_STREAM)
        with conn.lock:
            dup = req_id in conn.inflight
        if dup:
            # a duplicate id would overwrite the first entry and leave
            # one of the two completions unanswered — reject it before
            # anything is submitted (one io thread serves a connection,
            # so this check cannot race a concurrent insert)
            self._answer_error(
                conn, req_id, wire.ERR_BAD_REQUEST,
                f"request id {req_id} is already in flight on this "
                f"connection")
            return
        jinfo = rec = ctx = None
        rt = reqtrace.active()
        try:
            model_s, tenant, priority, deadline_ms, trace_s, descs, \
                seg = wire.unpack_request_meta(meta)
            # propagated context decodes even when THIS process is not
            # tracing (the journal still correlates); this front door
            # MINTS one only when tracing is on and none arrived
            if trace_s:
                ctx = reqtrace.parse_context(trace_s)
            if rt is not None:
                if ctx is None:
                    ctx = rt.mint()
                rec = rt.begin(ctx, transport=self.transport,
                               model=model_s or "")
            if self.journal is not None:
                jinfo = {"transport": self.transport,
                         "model": model_s or "",
                         "tenant": tenant or "",
                         "priority": priority or "",
                         "deadline_ms": deadline_ms,
                         "request_id": req_id,
                         "trace_id": ctx.trace_id if ctx else None,
                         "sizes": {d.name: int(d.nbytes)
                                   for d in descs}}
            # admission runs BEFORE tensor decode / model resolution
            # (the HTTP rule): a shed tenant's flood must not buy
            # io-thread decode time, and a malformed request still
            # spends its tenant's token
            reason = (self.tenants.admit(tenant or None,
                                         priority or None)
                      if self.tenants is not None else None)
            if rec is not None:
                rt.stage(ctx, "admission", rec["ts"],
                         rt.now_us() - rec["ts"])
            if reason is not None:
                self._c_shed.inc(model=model_s or "", reason=reason)
                self._journal_row(jinfo, reason)
                if rec is not None:
                    rt.finish(rec, reason)
                self._answer_error(
                    conn, req_id,
                    wire.ERR_TENANT_LIMIT if reason == "tenant_limit"
                    else wire.ERR_PRIORITY,
                    "tenant rate limit exceeded"
                    if reason == "tenant_limit" else
                    "shed by priority class under admission pressure")
                return
            t_dec = rt.now_us() if rec is not None else 0.0
            if seg is not None:
                # spkn-shm request: the payload lives in the client's
                # named segment; map it (cached per connection — the
                # ring reuses names) and view the tensors in place.
                # Batch formation copies rows into bucket buffers before
                # the reply, so the client reusing the slot after its
                # terminal reply can never race a live view.
                if not conn.shm_ok:
                    raise ValueError(
                        "FLAG_SHM request without a granted SHM_HELLO "
                        "on this connection")
                segobj = conn.shm_segs.get(seg)
                if segobj is None:
                    segobj = shm.attach(seg)
                    conn.shm_segs[seg] = segobj
                inputs = wire.tensors_from(descs, segobj.buf)
                with self._byte_lock:
                    self.shm_rx_bytes += sum(d.nbytes for d in descs)
            else:
                inputs = wire.tensors_from(descs, payload)
                with self._byte_lock:
                    self.payload_rx_bytes += len(payload)
            # the outputs request rides the tensor table as a reserved
            # key (no frame-format change); pop it before the net sees
            # the payload
            inputs, outputs = pop_outputs(inputs)
            model = self.adapter.resolve(model_s or None)
            self.adapter.coerce(model, inputs)
            if rec is not None:
                rt.stage(ctx, "decode", t_dec, rt.now_us() - t_dec,
                         shm=seg is not None)
            deadline_s = (deadline_ms / 1e3 if deadline_ms is not None
                          else self.default_deadline_s)
            fut = self.adapter.submit(model, inputs, deadline_s,
                                      priority=priority or None,
                                      outputs=outputs, trace=ctx)
        except BaseException as e:
            ck, msg = _exception_to_err(e)
            self._journal_row(jinfo, ck[1])
            if rec is not None:
                rt.finish(rec, ck[1])
            self._answer_error(conn, req_id, ck, msg)
            return
        bound = time.monotonic() + (
            deadline_s + 5.0 if deadline_s is not None
            else _DEFAULT_WAIT_S)
        with conn.lock:
            if conn.closed:
                return
            conn.inflight[req_id] = (bound, fut, model, jinfo, rec)
        fut.add_done_callback(
            lambda f, c=conn, r=req_id, s=stream, m=model:
            self._complete(c, r, s, m, f))

    # -- completion (forward-worker / proxy threads) --------------------------

    def _complete(self, conn: _Conn, req_id: int, stream: bool,
                  model: str, fut) -> None:
        with conn.lock:
            entry = conn.inflight.pop(req_id, None)
        if entry is None:
            return  # reaped (already answered) or connection gone
        jinfo, rec = entry[3], entry[4]
        rt = reqtrace.active()
        exc = fut.exception()
        if exc is not None:
            ck, msg = _exception_to_err(exc)
            self._journal_row(jinfo, ck[1])
            if rt is not None and rec is not None:
                rt.finish(rec, ck[1])
            self._answer_error(conn, req_id, ck, msg)
            return
        t_reply = rt.now_us() if (rt is not None
                                  and rec is not None) else 0.0
        # queue wait: stamped on the batcher future at batch formation
        # (server.py) — rides the response meta so clients can split
        # tail latency into queueing vs compute
        qw = getattr(fut, "_spkn_queue_wait_s", None)
        qw_ms = None if qw is None else qw * 1e3
        # the step whose weights computed this answer, stamped at forward
        # time (a swap after the forward must not relabel it)
        step = fut._spkn_step
        out = {k: np.asarray(v) for k, v in fut.result().items()}
        items = None
        if conn.shm_ok and not stream and conn.shm_ring is not None:
            # spkn-shm response: copy the payload into a ring slot and
            # send only the descriptor table. A full ring (all slots
            # awaiting SHM_RELEASE) falls back to inline — the protocol
            # never blocks on the ring.
            descs, views, total = wire.build_table(out)
            slot = conn.shm_ring.acquire(total) if total else None
            if slot is not None:
                name, view = slot
                shm.copy_into(view, views)
                with self._byte_lock:
                    self.shm_tx_bytes += total
                items = wire.pack_response(
                    req_id, model, step, out,
                    queue_wait_ms=qw_ms, shm_seg=name)
        if items is None:
            items = wire.pack_response(req_id, model, step, out,
                                       stream=stream,
                                       chunk_bytes=self.chunk_bytes,
                                       queue_wait_ms=qw_ms)
        self._journal_row(jinfo, "ok", queue_wait_ms=qw_ms)
        self._c_req.inc(code="200", transport=self.transport)
        self._enqueue(conn, items)
        if rt is not None and rec is not None:
            # pack + outbox enqueue; the socket write itself is async on
            # the io thread and belongs to the client's wire span
            rt.stage(rec["ctx"], "reply", t_reply,
                     rt.now_us() - t_reply, stream=stream)
            rt.finish(rec, "ok")

    def _journal_row(self, jinfo: Optional[dict], outcome: str,
                     queue_wait_ms: Optional[float] = None) -> None:
        """One JSONL row per answered request frame (--request-journal).
        Best-effort: a journal failure must never fail the data plane."""
        if jinfo is None or self.journal is None:
            return
        try:
            self.journal.metrics(0, kind="request", outcome=outcome,
                                 queue_wait_ms=queue_wait_ms, **jinfo)
        except Exception:
            pass

    # -- reply plumbing (any thread) ------------------------------------------

    def _answer_error(self, conn: _Conn, req_id: int,
                      code_kind: Tuple[int, str], msg: str,
                      close: bool = False) -> None:
        self._c_req.inc(code=str(code_kind[0]), transport=self.transport)
        if close:
            conn.close_after_flush = True
        self._enqueue(conn, [(wire.pack_error(req_id, code_kind, msg),
                              None)])

    def _enqueue(self, conn: _Conn,
                 items: List[Tuple[bytes, Optional[memoryview]]]) -> None:
        if conn.closed:
            return
        tx = 0
        with conn.lock:
            for head, view in items:
                if head:
                    conn.outbox.append((memoryview(head), True))
                    conn.copied_pending += len(head)
                if view is not None and len(view):
                    conn.outbox.append((view, False))
                    tx += len(view)
            conn.peak_copied = max(conn.peak_copied, conn.copied_pending)
            peak = conn.peak_copied
        if tx:
            with self._byte_lock:
                self.payload_tx_bytes += tx
        # the streaming tests' bounded-buffer check reads this
        # high-water mark: the max-update must not lose a racing larger
        # sample to an unsynchronized read-compare-write
        with self._active_lock:
            if peak > self.peak_buffered_bytes:
                self.peak_buffered_bytes = peak
        conn.loop.call_soon(lambda c=conn: c.loop.arm_write(c))


# ---------------------------------------------------------------------------
# the matching client
# ---------------------------------------------------------------------------

def _parse_address(address) -> Tuple[str, int]:
    """(host, port) | 'host:port' | 'spkn://host:port' -> (host, port)."""
    if isinstance(address, (tuple, list)):
        return str(address[0]), int(address[1])
    s = str(address)
    for scheme in ("spkn://", "tcp://", "http://"):
        if s.startswith(scheme):
            s = s[len(scheme):]
    s = s.rstrip("/")
    host, _, port = s.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"binary address {address!r} is not host:port")
    return host, int(port)


class BinaryClient:
    """Keep-alive, pipelined client for the binary frame transport.

    `submit` writes a request frame and returns its request-id without
    waiting; `collect` reads frames (in whatever completion order the
    server chose) until that id resolves — so N submits followed by N
    collects is a pipelined burst on one connection. `infer` is the
    one-shot convenience and records `last_timing` (first-byte /
    complete, seconds from submit; plus the server-reported
    `queue_wait_ms` when known).

    spkn-shm: `use_shm=None` auto-offers the shared-memory transport to
    loopback servers (SHM_HELLO handshake at connect); the server's
    same-host nonce check decides. Granted, tensor payloads ride named
    segments in both directions and zero payload bytes cross the
    socket; denied (remote peer, shm-less build), everything falls back
    inline transparently.

    Thread-safety: one connection, one user thread — except `cancel`,
    which the router's hedge scheduler may call from its own thread
    (all socket WRITES serialize on `_wlock`; reads stay single-owner).
    The thread-cached `binary_infer` below gives each thread its own
    client."""

    def __init__(self, host, port: Optional[int] = None,
                 timeout: float = 30.0,
                 use_shm: Optional[bool] = None):
        if port is None:
            host, port = _parse_address(host)
        self.addr = (host, int(port))
        self.timeout = float(timeout)
        self.sock = socket.create_connection(self.addr, timeout=timeout)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._rbuf = bytearray()
        self._ids = itertools.count(1)
        self._wlock = threading.Lock()
        # req_id -> reassembly state (supports out-of-order completion)
        self._pending: Dict[int, Dict[str, Any]] = {}
        self.last_timing: Optional[Dict[str, float]] = None
        # the served checkpoint step of the last reply (None = the
        # replica's initial weights, or unknown)
        self.last_step: Optional[int] = None
        self.closed = False
        # tensor payload bytes that crossed the socket, per direction
        self.payload_tx_bytes = 0
        self.payload_rx_bytes = 0
        self._shm_granted: Optional[bool] = None
        self._ring = None   # request-segment ring (ours; slots freed on
        #                     the rid's terminal reply)
        self._segs: Dict[str, Any] = {}  # attached response segments
        if use_shm is None:
            use_shm = host in ("127.0.0.1", "localhost", "::1")
        if use_shm and shm.shm_available():
            self._shm_handshake()

    def _shm_handshake(self) -> None:
        """Offer spkn-shm: write the same-host nonce, send SHM_HELLO,
        block (briefly) for the ack. Any failure — old server, remote
        filesystem, timeout — quietly leaves the connection inline."""
        path, nonce = shm.write_nonce()
        try:
            rid = next(self._ids)
            self.sock.settimeout(self.timeout)
            with self._wlock:
                self.sock.sendall(wire.pack_shm_hello(rid, path, nonce))
            deadline = time.perf_counter() + min(self.timeout, 5.0)
            while self._shm_granted is None:
                self._read_frame(deadline)
        except (OSError, TimeoutError, ConnectionError, wire.WireError):
            self._shm_granted = False
        finally:
            shm.cleanup_nonce(path)
        if self._shm_granted:
            self._ring = shm.ShmRing()

    def close(self) -> None:
        self.closed = True
        if self._ring is not None:
            self._ring.close()
            self._ring = None
        for seg in self._segs.values():
            try:
                seg.close()
            except Exception:
                pass  # a live tensor view pins the mapping; leave it
        self._segs.clear()
        try:
            self.sock.close()
        except OSError:
            pass

    # -- submit side ---------------------------------------------------------

    def submit(self, payload: Dict[str, np.ndarray],
               model: str = "", deadline_s: Optional[float] = None,
               tenant: Optional[str] = None,
               priority: Optional[str] = None,
               stream: bool = False,
               outputs: Optional[Tuple[str, ...]] = None,
               trace=None) -> int:
        rid = next(self._ids)
        # trace context: accepted as a TraceContext or its encoded wire
        # string; rides the REQUEST meta, and the local tracer (when on)
        # records this client's wait as the `wire:binary` span that
        # assembly matches against the server's request row
        ctx = reqtrace.parse_context(trace) if trace is not None else None
        rt = reqtrace.active() if ctx is not None else None
        arrays = {k: np.asarray(v)
                  for k, v in encode_outputs(payload, outputs).items()}
        seg_name = None
        if self._ring is not None:
            # spkn-shm: copy the payload into a ring slot; the frame
            # then carries only the descriptor table. Ring full -> None
            # -> this request goes inline (never blocks).
            descs, pviews, total = wire.build_table(arrays)
            slot = self._ring.acquire(total) if total else None
            if slot is not None:
                seg_name, view = slot
                shm.copy_into(view, pviews)
        head, views = wire.pack_request(
            rid, model, arrays,
            deadline_ms=None if deadline_s is None else deadline_s * 1e3,
            tenant=tenant, priority=priority, stream=stream,
            shm_seg=seg_name,
            trace=None if ctx is None else ctx.encoded())
        self._pending[rid] = {"t_submit": time.perf_counter(),
                              "t_first": None, "done": False,
                              "outputs": None, "exc": None,
                              "buf": None, "descs": None, "got": 0,
                              "total": 0, "model": None, "step": None,
                              "queue_wait_ms": None,
                              "shm_seg": seg_name,
                              "trace": ctx if rt is not None else None,
                              "t_submit_us": (rt.now_us()
                                              if rt is not None
                                              else 0.0)}
        # _fill shrinks the socket timeout toward a deadline; a cached
        # client's NEXT send must not inherit that sliver
        self.sock.settimeout(self.timeout)
        with self._wlock:
            self.sock.sendall(head)
            for v in views:
                self.sock.sendall(v)
        self.payload_tx_bytes += sum(len(v) for v in views)
        return rid

    def cancel(self, rid: int) -> None:
        """Fire-and-forget CANCEL for an in-flight request id (the
        hedging router's losing leg). If the server's batcher still
        holds the request, the rid resolves with the typed `cancelled`
        error; otherwise the normal reply arrives — either way exactly
        one terminal frame. Safe to call from a thread other than the
        connection's owner (write-locked); send failures are swallowed
        (cancel is an optimization, never a correctness dependency)."""
        if self.closed or rid not in self._pending:
            return
        try:
            with self._wlock:
                self.sock.sendall(wire.pack_cancel(rid))
        except OSError:
            pass

    # -- receive side --------------------------------------------------------

    def _fill(self, n: int, deadline: float) -> None:
        """Block until the read buffer holds >= n bytes."""
        while len(self._rbuf) < n:
            budget = deadline - time.perf_counter()
            if budget <= 0:
                raise TimeoutError(
                    f"binary_infer: no reply within the timeout "
                    f"({self.timeout:.1f}s)")
            self.sock.settimeout(min(budget, self.timeout))
            try:
                data = self.sock.recv(1 << 18)
            except socket.timeout:
                continue
            if not data:
                raise ConnectionError(
                    "binary transport: server closed the connection")
            self._rbuf += data

    def _read_frame(self, deadline: float) -> None:
        self._fill(wire.HEADER_LEN, deadline)
        ftype, flags, rid, meta_len, payload_len = \
            wire.parse_header(self._rbuf)
        inline = 0 if (ftype == wire.T_RESPONSE
                       and flags & wire.FLAG_STREAM) else payload_len
        self._fill(wire.HEADER_LEN + meta_len + inline, deadline)
        meta = bytes(self._rbuf[wire.HEADER_LEN:
                                wire.HEADER_LEN + meta_len])
        payload = bytes(self._rbuf[wire.HEADER_LEN + meta_len:
                                   wire.HEADER_LEN + meta_len + inline])
        del self._rbuf[:wire.HEADER_LEN + meta_len + inline]
        now = time.perf_counter()
        if ftype == wire.T_ERROR:
            code, kind, msg = wire.unpack_error_meta(meta)
            if rid == 0:
                # connection-level: the stream is done for — but the
                # error is still the server's TYPED answer (e.g. 503
                # over_capacity must surface as NoReplicaError exactly
                # as it would over HTTP, so router proxies stay
                # transport-blind)
                self.close()
                raise_for_error(code, kind, msg)
            st = self._pending.get(rid)
            if st is not None:
                st["exc"] = (code, kind, msg)
                st["done"] = True
                if st["t_first"] is None:
                    st["t_first"] = now
            return
        if ftype == wire.T_SHM_HELLO:
            # the handshake ack (FLAG_LAST); rid is the hello's own id
            try:
                self._shm_granted = wire.unpack_shm_hello_ack_meta(meta)
            except wire.WireError:
                self._shm_granted = False
            return
        st = self._pending.get(rid)
        if st is None:
            return  # reply to an abandoned id: drop it
        if st["t_first"] is None:
            st["t_first"] = now
        if ftype == wire.T_RESPONSE:
            model, step, queue_wait_ms, descs, seg = \
                wire.unpack_response_meta(meta)
            st["model"], st["step"], st["descs"] = model, step, descs
            st["queue_wait_ms"] = queue_wait_ms
            if flags & wire.FLAG_SHM and seg is not None:
                # spkn-shm response: map the server's segment, copy the
                # tensors OUT (np.array), then release the slot — the
                # returned arrays must outlive the server's reuse of it
                segobj = self._segs.get(seg)
                if segobj is None:
                    segobj = shm.attach(seg)
                    self._segs[seg] = segobj
                outs = wire.tensors_from(descs, segobj.buf)
                st["outputs"] = {k: np.array(v)
                                 for k, v in outs.items()}
                st["done"] = True
                try:
                    with self._wlock:
                        self.sock.sendall(wire.pack_shm_release(seg))
                except OSError:
                    pass  # a dead socket surfaces on the next read
            elif flags & wire.FLAG_STREAM:
                st["total"] = payload_len
                st["buf"] = bytearray(payload_len)
                if payload_len == 0:
                    st["outputs"] = wire.tensors_from(descs, b"")
                    st["done"] = True
            else:
                st["outputs"] = wire.tensors_from(descs, payload)
                st["done"] = True
                self.payload_rx_bytes += len(payload)
        elif ftype == wire.T_CHUNK:
            off = wire.unpack_chunk_meta(meta)
            if st["buf"] is None or off + len(payload) > st["total"]:
                raise wire.WireError(
                    f"chunk for request {rid} outside its announced "
                    f"payload")
            st["buf"][off:off + len(payload)] = payload
            st["got"] += len(payload)
            self.payload_rx_bytes += len(payload)
            if st["got"] >= st["total"] or flags & wire.FLAG_LAST:
                if st["got"] < st["total"]:
                    raise wire.WireError(
                        f"stream for request {rid} ended {st['total'] - st['got']} "
                        f"bytes short")
                # frombuffer views the bytearray directly — no full-blob
                # copy on the client side of the zero-copy wire either
                st["outputs"] = wire.tensors_from(st["descs"],
                                                  st["buf"])
                st["done"] = True
        # any other type from a server is a protocol error
        else:
            raise wire.WireError(f"unexpected frame type {ftype} "
                                 f"from server")

    def collect(self, rid: int, timeout: Optional[float] = None
                ) -> Dict[str, np.ndarray]:
        """Read until request `rid` resolves (other ids' replies are
        absorbed into their own pending states — pipelining)."""
        deadline = time.perf_counter() + (timeout if timeout is not None
                                          else self.timeout)
        while True:
            st = self._pending.get(rid)
            if st is None:
                raise KeyError(f"unknown request id {rid}")
            if st["done"]:
                self._pending.pop(rid)
                # terminal reply: the server is done reading our shm
                # request slot (formation copied the rows before the
                # forward) — free it for the next submit
                if st["shm_seg"] is not None and self._ring is not None:
                    self._ring.release(st["shm_seg"])
                self.last_step = st["step"]
                self.last_timing = {
                    "t_first_byte_s": st["t_first"] - st["t_submit"],
                    "t_complete_s":
                        time.perf_counter() - st["t_submit"],
                    "queue_wait_ms": st["queue_wait_ms"]}
                ctx = st.get("trace")
                if ctx is not None:
                    rt = reqtrace.active()
                    if rt is not None:
                        # the client-side wire span (submit -> terminal
                        # frame, typed errors included): its span id
                        # equals the server request row's — the hop
                        # assembly stitches and clock-aligns on
                        rt.stage(ctx, "wire:binary", st["t_submit_us"],
                                 rt.now_us() - st["t_submit_us"],
                                 kind="client",
                                 shm=st["shm_seg"] is not None)
                if st["exc"] is not None:
                    raise_for_error(*st["exc"])
                return st["outputs"]
            self._read_frame(deadline)

    def infer(self, payload: Dict[str, np.ndarray], model: str = "",
              deadline_s: Optional[float] = None,
              tenant: Optional[str] = None,
              priority: Optional[str] = None, stream: bool = False,
              timeout: Optional[float] = None,
              outputs: Optional[Tuple[str, ...]] = None,
              trace=None) -> Dict[str, np.ndarray]:
        rid = self.submit(payload, model=model, deadline_s=deadline_s,
                          tenant=tenant, priority=priority,
                          stream=stream, outputs=outputs, trace=trace)
        return self.collect(rid, timeout=timeout)


# -- thread-cached convenience client (the router proxy's entry point) -------

_client_cache = threading.local()
MAX_CACHED_CLIENTS = 8  # per thread; LRU-evicted past this


def _cached_client(host: str, port: int, timeout: float,
                   use_shm: Optional[bool] = None) -> BinaryClient:
    # use_shm is part of the key: an A/B run forcing the transport
    # per call must never be handed a cached client negotiated the
    # other way
    cli = lru_cache_get(
        _client_cache, "clients", (host, port, use_shm),
        lambda: BinaryClient(host, port, timeout=timeout,
                             use_shm=use_shm),
        MAX_CACHED_CLIENTS)
    cli.timeout = float(timeout)
    return cli


def _drop_client(host: str, port: int,
                 use_shm: Optional[bool] = None) -> None:
    lru_cache_drop(_client_cache, "clients", (host, port, use_shm))


def _submit_cancellable(cli: BinaryClient, cancel_box: dict, payload,
                        **kw) -> int:
    """Submit with the cancel callable in `cancel_box` BEFORE the request
    is on the wire: a cancel asked for while the request is being sent
    (the hedge scheduler decides on its own thread) is held and sent
    right after the request, never lost."""
    lock = threading.Lock()
    state: Dict[str, Any] = {"rid": None, "wanted": False}

    def cancel() -> None:
        with lock:
            rid = state["rid"]
            if rid is None:
                state["wanted"] = True
                return
        cli.cancel(rid)

    cancel_box["cancel"] = cancel
    rid = cli.submit(payload, **kw)
    with lock:
        state["rid"] = rid
        wanted = state["wanted"]
    if wanted:
        cli.cancel(rid)
    return rid


def binary_infer(address, model: str,
                 payload: Dict[str, np.ndarray],
                 deadline_s: Optional[float] = None,
                 timeout: float = 30.0,
                 tenant: Optional[str] = None,
                 priority: Optional[str] = None,
                 stream: bool = False,
                 cancel_box: Optional[dict] = None,
                 use_shm: Optional[bool] = None,
                 outputs: Optional[Tuple[str, ...]] = None,
                 trace=None, meta: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, np.ndarray]:
    """One inference request over the binary transport (thread-cached
    keep-alive client — the `http_infer` counterpart the router's
    binary remote replicas ride). The http_infer
    cache rules apply: ANY failure mid-exchange evicts this address's
    cached client (never re-use a stream in an unknown state); a stale
    server-closed socket gets ONE retry on a fresh connection.

    `cancel_box`: when given, a best-effort `cancel` callable for THIS
    request is stored under "cancel" once it is on the wire — the
    hedging router calls it (from its scheduler thread) to cancel the
    losing leg. `meta`, when given, receives the reply's "step" (None =
    the replica's initial weights) and "queue_wait_ms", as `http_infer`'s
    does."""
    host, port = _parse_address(address)
    for attempt in (0, 1):
        cli = _cached_client(host, port, timeout, use_shm)
        try:
            rid = _submit_cancellable(
                cli, {} if cancel_box is None else cancel_box, payload,
                model=model, deadline_s=deadline_s, tenant=tenant,
                priority=priority, stream=stream, outputs=outputs,
                trace=trace)
            out = cli.collect(rid, timeout=timeout)
            if meta is not None:
                meta["step"] = cli.last_step
                meta["queue_wait_ms"] = cli.last_timing["queue_wait_ms"]
            return out
        except (TenantLimitError, QueueFullError, DeadlineExpiredError,
                RequestCancelledError,
                NoReplicaError, UnknownModelError, ValueError):
            # typed sheds arrived ON the stream, which is usually still
            # good — except a connection-level frame (rid 0, e.g.
            # over_capacity), whose delivery closed the client
            if cli.closed:
                _drop_client(host, port, use_shm)
            raise
        except TimeoutError:
            _drop_client(host, port, use_shm)
            raise  # a slow server is not a stale socket: no retry
        except ConnectionError as e:
            # a server-closed cached connection: retry once fresh
            _drop_client(host, port, use_shm)
            if attempt:
                raise ConnectionError(
                    f"binary_infer to {address}: {e}") from e
        except BaseException:
            _drop_client(host, port, use_shm)
            raise
