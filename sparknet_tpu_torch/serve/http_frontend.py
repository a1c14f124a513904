"""The HTTP/1.1 inference data plane: the network front door of the
port's serving replica.

The counterpart of `sparknet_tpu/serve/http_frontend.py`: persistent
connections, wire decode on the accept threads, tenant and priority
admission, deadline-aware shedding, the request journal and trace-header
propagation, in front of an `InferenceServer` or a `ModelRouter`.
`BackendAdapter` is the seam both wires (this one and the binary frame
transport, binary_frontend.py) ride, so a request behaves identically
whichever wire carried it; another backend raises TypeError.

Wire protocol (all under `/v1`):

  POST /v1/models/<name>/infer      one inference request for <name>
  POST /v1/infer                    same, for the sole/default model
    Content-Type: application/json
      {"inputs": {"<input>": <nested lists>}, "deadline_ms": <float?>}
    Content-Type: application/x-npz
      body = np.savez archive of per-example input arrays (exact-dtype
      path; deadline via the X-Deadline-Ms header)
    -> 200, JSON {"model":..., "step":..., "outputs": {...lists...}}
       (or an npz archive of output arrays when the request was npz or
       `Accept: application/x-npz`)
  GET /v1/models                    {"models": {name: vitals-row}}
  GET /healthz                      liveness (200/503)

Error codes (every shed is ANSWERED — a client never hangs):
  400  undecodable body / not a net input / wrong shape
  404  unknown model or route
  408  socket timed out mid-body-read (the stream is desynced — the
       reply closes the connection)
  413  body over the size cap
  429  queue at capacity (QueueFullError backpressure), the tenant's
       token bucket is empty (error_kind "tenant_limit" — per-tenant
       admission via the X-Tenant header, serve/admission.py), or the
       request's priority class (X-Priority: high|normal|low) is below
       the admission-pressure cutoff the fleet controller set
       (error_kind "priority" — low sheds first under SLO burn) — all
       + Retry-After
  503  request shed: client deadline expired before a forward
       (DeadlineExpiredError), no routable replica (NoReplicaError),
       response-wait timeout, or the server is at its connection cap
       (error_kind "over_capacity") — all + Retry-After
  500  anything else (the error text rides the JSON body)

Design rules carried from the serving core:
  - DECODE ON THE ACCEPT THREADS: JSON/npz parse and dtype coercion run
    on the per-connection handler thread (ThreadingHTTPServer), never on
    the forward worker — the worker's time is bucket forwards only.
  - KEEP-ALIVE: HTTP/1.1 + Content-Length on every response keeps
    connections persistent; the connection/request counters let tests
    assert reuse (10k rps is unreachable through per-request TCP+TLS
    handshakes).
  - CONNECTION HYGIENE: thread-per-connection means every idle
    keep-alive connection pins one OS thread — so idle connections are
    closed after `idle_timeout_s`, the live set is capped at
    `max_connections` (excess answered 503 + Connection: close, never
    silently refused), and `http_connections_active{transport}` gauges
    the live count.
  - ADMISSION CONTROL: QueueFullError maps to 429 with Retry-After;
    expired deadlines are rejected at the door (never enqueued) and shed
    from the queue by the batcher before they pad into a bucket;
    per-tenant token buckets (when configured) shed a hot tenant's flood
    BEFORE it occupies queue slots.

Transport-labeled metrics: this frontend and the binary one register the
SAME request/connection families with `transport="http"` /
`transport="binary"`, so one scrape compares the two wires per code.

`http_infer` at the bottom is the matching client (thread-cached
keep-alive connections, npz wire format) — the router's remote-replica
proxy rides it. With `meta={}` it also reports the response's status,
served step and queue wait.
"""
from __future__ import annotations

import http.client
import io
import itertools
import json
import socket
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlsplit

import numpy as np

from ..obs import reqtrace
from ..utils.logger import Logger
from .admission import (PriorityShedError, TenantAdmission,
                        TenantLimitError)
from .batcher import DeadlineExpiredError, QueueFullError
from .router import ModelRouter, NoReplicaError, UnknownModelError
from .server import (InferenceServer, encode_outputs, net_input_specs,
                     pop_outputs)

NPZ_CONTENT_TYPE = "application/x-npz"

# a tenant-limited request's body is drained (keep-alive survives the
# 429) only up to this size; past it the reply closes the connection —
# shedding must not buy the flood full-body socket reads
TENANT_SHED_DRAIN_BYTES = 64 << 10


class _BodyReadTimeout(Exception):
    """The connection's socket timed out (or died) mid-body-read. The
    stream is DESYNCED — unread body bytes would be parsed as the next
    request line — so the reply must close the connection. A dedicated
    type because socket.timeout aliases shift across Python versions
    (3.10: distinct from futures.TimeoutError; 3.11+: the same class),
    and the except-ladder must not confuse a half-read body with a
    response-wait timeout."""


def _encode_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _decode_npz(body: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class BackendAdapter:
    """Normalizes an `InferenceServer` or a `ModelRouter` behind one
    resolve/submit/coerce surface. Both wire frontends (HTTP here, the
    binary frame transport in binary_frontend.py) ride this seam, so a
    request behaves identically whichever wire carried it. Another
    backend raises TypeError."""

    def __init__(self, backend):
        if not isinstance(backend, (InferenceServer, ModelRouter)):
            raise TypeError(
                f"BackendAdapter takes an InferenceServer or a ModelRouter "
                f"(got {type(backend).__name__})")
        self.backend = backend
        self.is_router = isinstance(backend, ModelRouter)
        # per-model input dtype coercion table (JSON floats arrive as
        # float64; coerce on the TRANSPORT thread so the worker never
        # pays)
        self.specs: Dict[str, Dict[str, np.dtype]] = {}
        for name, lane in self.lanes().items():
            self.specs[name] = {
                k: np.dtype(dt)
                for k, (_, dt) in net_input_specs(lane.net).items()}

    def lanes(self) -> Dict[str, InferenceServer]:
        if self.is_router:
            return self.backend.lanes
        return {self.backend.model_name: self.backend}

    def model_names(self) -> Tuple[str, ...]:
        if self.is_router:
            return tuple(sorted(set(self.backend.lanes)
                                | set(self.backend.replicas)))
        return (self.backend.model_name,)

    def resolve(self, model: Optional[str]) -> str:
        """None -> the sole served model; ambiguous None raises."""
        if model is not None:
            return model
        names = self.model_names()
        if len(names) != 1:
            raise UnknownModelError(
                f"the default-model route is ambiguous: this endpoint "
                f"serves {list(names)}; name the model explicitly")
        return names[0]

    def submit(self, model: str, payload: Dict[str, np.ndarray],
               deadline_s: Optional[float],
               priority: Optional[str] = None,
               outputs: Optional[Tuple[str, ...]] = None,
               trace=None):
        if self.is_router:
            # the router's remote legs only speak tensors — fold the
            # outputs request back into the payload (the terminal
            # frontend, or a local lane's submit, pops it again)
            return self.backend.submit(
                model, encode_outputs(payload, outputs),
                deadline_s=deadline_s, priority=priority, trace=trace)
        if model != self.backend.model_name:
            raise UnknownModelError(model)
        return self.backend.submit(payload, deadline_s=deadline_s,
                                   priority=priority, outputs=outputs,
                                   trace=trace)

    def coerce(self, model: Optional[str],
               payload: Dict[str, np.ndarray]) -> None:
        """Cast inputs to the net's schema dtypes IN PLACE, on the
        calling (transport) thread."""
        names = self.model_names()
        specs = self.specs.get(
            model if model is not None
            else (names[0] if len(names) == 1 else ""), {})
        for k, dt in specs.items():
            if k in payload and payload[k].dtype != dt:
                payload[k] = payload[k].astype(dt)

    def cancel(self, model: str, fut) -> bool:
        """Best-effort cancel of a submitted request BY ITS FUTURE:
        reaches the lane batcher's queue entry if the request hasn't
        formed into a batch yet. Returns False when the future is not a
        queued batcher future (already formed, remote-proxied, or a
        router-chained wrapper) — the caller drops the cancel and the
        request completes normally."""
        lane = self.lanes().get(model)
        if lane is None:
            return False
        return bool(lane.batcher.cancel(fut))

    def healthy(self) -> bool:
        return self.backend.healthy()


def register_transport_metrics(registry, transport: str):
    """The shared data-plane families, `transport`-labeled so HTTP and
    binary render side by side in one scrape. Returns (requests counter,
    connections counter, active-connections gauge, shed counter)."""
    c_req = registry.counter(
        "sparknet_serve_http_requests_total",
        "data-plane requests by status code and wire transport",
        labels=("code", "transport"))
    c_conn = registry.counter(
        "sparknet_serve_http_connections_total",
        "data-plane connections accepted (requests/connections >> 1 "
        "means keep-alive/pipelining reuse is working)",
        labels=("transport",))
    g_active = registry.gauge(
        "sparknet_serve_http_connections_active",
        "currently-open data-plane connections", labels=("transport",))
    c_shed = registry.counter(
        "sparknet_serve_shed_total",
        "requests shed before a forward, by reason (deadline = "
        "client deadline expired before batch formation)",
        labels=("model", "reason"))
    return c_req, c_conn, g_active, c_shed


class HttpFrontend:
    """HTTP/1.1 inference endpoint over an InferenceServer or a
    ModelRouter (the `backend`). Port 0 binds ephemeral; the bound
    address is `.address`."""

    transport = "http"

    def __init__(self, backend, port: int = 0, host: str = "127.0.0.1",
                 default_deadline_s: Optional[float] = None,
                 retry_after_s: float = 1.0,
                 max_body_bytes: int = 64 << 20,
                 idle_timeout_s: float = 60.0,
                 max_connections: int = 256,
                 tenants: Optional[TenantAdmission] = None,
                 logger: Optional[Logger] = None,
                 journal: Optional[Logger] = None):
        self.backend = backend
        self.adapter = BackendAdapter(backend)
        self.default_deadline_s = default_deadline_s
        # request journal: one JSONL row per decoded request — arrival
        # shape, not outcome — for trace replay
        self.journal = journal
        self.retry_after_s = float(retry_after_s)
        self.max_body_bytes = int(max_body_bytes)
        self.idle_timeout_s = float(idle_timeout_s)
        self.max_connections = int(max_connections)
        self.tenants = tenants
        self.log = logger
        self.registry = backend.registry
        self._c_http, self._c_conns, self._g_active, self._c_shed = \
            register_transport_metrics(self.registry, self.transport)
        self.connections = 0
        self.rejected_over_cap = 0
        self.requests = 0
        # journal correlation ids (trace_id pairs with request_id so the
        # replay lab can key rows even for untraced requests)
        self._rids = itertools.count(1)
        self._active = 0
        self._active_lock = threading.Lock()
        self._g_active.set_fn(lambda: self._active,
                              transport=self.transport)
        owner = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # the per-connection socket timeout: an idle keep-alive
            # connection times out its blocking readline, which
            # handle_one_request treats as close_connection — the
            # pinned thread is released instead of held forever by an
            # idle-connection flood
            timeout = owner.idle_timeout_s

            def setup(self):  # one Handler instance == one connection
                super().setup()
                owner.connections += 1
                owner._c_conns.inc(transport=owner.transport)
                with owner._active_lock:
                    owner._active += 1
                    self._over_cap = owner._active > owner.max_connections

            def finish(self):
                with owner._active_lock:
                    owner._active -= 1
                super().finish()

            def do_POST(self):  # noqa: N802 (stdlib casing)
                owner._handle_post(self)

            def do_GET(self):  # noqa: N802
                owner._handle_get(self)

            def log_message(self, *a):  # data plane: no per-request logs
                pass

        self._http = ThreadingHTTPServer((host, port), Handler)
        self._http.daemon_threads = True
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()
        if logger is not None:
            logger.log(f"serve: HTTP data plane at "
                       f"http://{self.address[0]}:{self.address[1]}/v1")

    # -- backend normalization (adapter passthroughs) ------------------------

    def _lanes(self) -> Dict[str, InferenceServer]:
        return self.adapter.lanes()

    def _model_names(self) -> Tuple[str, ...]:
        return self.adapter.model_names()

    def _submit(self, model: Optional[str],
                payload: Dict[str, np.ndarray],
                deadline_s: Optional[float],
                priority: Optional[str] = None,
                outputs: Optional[Tuple[str, ...]] = None,
                trace=None):
        model = self.adapter.resolve(model)
        return model, self.adapter.submit(model, payload, deadline_s,
                                          priority=priority,
                                          outputs=outputs, trace=trace)

    # -- request handling (accept threads) -----------------------------------

    def _read_body(self, h, length: int) -> bytes:
        """Read the request body on the accept thread; a socket timeout
        (or death) mid-read leaves the keep-alive stream desynced, so it
        surfaces as the typed _BodyReadTimeout whose reply closes."""
        try:
            return h.rfile.read(length)
        except (socket.timeout, OSError) as e:
            raise _BodyReadTimeout(str(e)) from e

    def _reject_over_cap(self, h, drain_len: int = 0) -> None:
        """503 + Connection: close for a connection accepted past the
        cap — answered through the normal reply path AFTER draining the
        request body (replying before the client finishes sending would
        RST the socket and destroy the answer in flight). Answered, not
        refused: the client learns WHY and backs off; `close=True`
        releases the pinned thread immediately after."""
        if 0 <= drain_len <= self.max_body_bytes:
            try:
                h.rfile.read(drain_len)
            except (socket.timeout, OSError):
                pass  # the reply below closes either way
        self.rejected_over_cap += 1
        self._reply(h, 503, {"error": "server at connection capacity",
                             "error_kind": "over_capacity"},
                    retry_after=True, close=True)

    def _handle_post(self, h: BaseHTTPRequestHandler) -> None:
        self.requests += 1
        t0 = time.perf_counter()
        # distributed trace: accept the client's X-Trace-Id (parsed even
        # when this process is not tracing, so the journal correlates);
        # this front door MINTS a context only when tracing is on and
        # none arrived. The record finishes in _reply_bytes — the one
        # funnel every terminal path (200, typed shed, 500) flows through.
        rt = reqtrace.active()
        ctx = rec = None
        ts_hdr = h.headers.get("X-Trace-Id")
        if ts_hdr:
            ctx = reqtrace.parse_context(ts_hdr)
        if rt is not None:
            if ctx is None:
                ctx = rt.mint()
            rec = rt.begin(ctx, transport="http")
            h._spkn_rec = rec
        try:
            if getattr(h, "_over_cap", False):
                try:
                    drain = int(h.headers.get("Content-Length") or 0)
                except ValueError:
                    drain = 0
                self._reject_over_cap(h, drain)
                return
            model = self._route_model(h.path)
            if model is NOT_AN_INFER_ROUTE:
                self._reply(h, 404, {"error": f"no route {h.path!r}",
                                     "error_kind": "not_found"})
                return
            try:
                length = int(h.headers.get("Content-Length") or -1)
            except ValueError:
                length = -1
            if length < 0:
                # no (or unparsable) Content-Length: any body the client
                # sent (e.g. chunked) is still in the socket and would
                # desync the keep-alive stream — close this connection
                self._reply(h, 411, {"error": "Content-Length required",
                                     "error_kind": "bad_request"},
                            close=True)
                return
            if length > self.max_body_bytes:
                # the body must still be drained for keep-alive to
                # survive; over the cap we close instead
                self._reply(h, 413, {"error": "body too large",
                                     "error_kind": "bad_request"},
                            close=True)
                return
            reason = (self.tenants.admit(h.headers.get("X-Tenant"),
                                         h.headers.get("X-Priority"))
                      if self.tenants is not None else None)
            if rec is not None:
                rt.stage(ctx, "admission", rec["ts"],
                         rt.now_us() - rec["ts"])
            if reason is not None:
                # shed the flood before DECODING or touching a queue
                # slot ("tenant_limit" = this tenant's bucket is empty;
                # "priority" = the fleet controller tightened the door
                # and this class is below the cutoff). A small body is
                # drained so keep-alive survives the 429; past the
                # threshold we close instead — a tenant flooding huge
                # bodies must not buy full-body socket reads on pinned
                # accept threads either
                drain = length <= TENANT_SHED_DRAIN_BYTES
                if drain:
                    self._read_body(h, length)
                # label with the model the CLIENT named; a default-route
                # request belongs to "" (blaming the alphabetically
                # first model would misattribute tenant floods)
                self._c_shed.inc(model=model or "", reason=reason)
                self._reply(h, 429, {
                    "error": ("tenant rate limit exceeded"
                              if reason == "tenant_limit" else
                              "shed by priority class under admission "
                              "pressure"),
                    "error_kind": reason}, retry_after=True,
                    close=not drain)
                return
            body = self._read_body(h, length)
            ctype = (h.headers.get("Content-Type") or "").split(";")[0]
            want_npz = ctype == NPZ_CONTENT_TYPE or \
                NPZ_CONTENT_TYPE in (h.headers.get("Accept") or "")
            t_dec = rt.now_us() if rec is not None else 0.0
            payload, deadline_ms, outputs = self._decode(
                model, body, ctype, h)
            if rec is not None:
                rt.stage(ctx, "decode", t_dec, rt.now_us() - t_dec)
            deadline_s = (deadline_ms / 1e3 if deadline_ms is not None
                          else self.default_deadline_s)
            if self.journal is not None:
                try:
                    self.journal.metrics(
                        0, kind="request", transport="http",
                        model=model or "",
                        tenant=h.headers.get("X-Tenant") or "",
                        priority=h.headers.get("X-Priority") or "",
                        deadline_ms=deadline_ms,
                        request_id=next(self._rids),
                        trace_id=ctx.trace_id if ctx else None,
                        sizes={k: int(np.asarray(v).nbytes)
                               for k, v in payload.items()})
                except Exception:
                    pass  # the journal must never fail the data plane
            model, fut = self._submit(
                model, payload, deadline_s,
                priority=h.headers.get("X-Priority"), outputs=outputs,
                trace=ctx)
            if rec is not None:
                rec["model"] = model or ""
            # shed-not-hang: the batcher fails the future at the deadline
            # (DeadlineExpiredError); without one we still bound the wait
            wait_s = deadline_s + 5.0 if deadline_s is not None else 30.0
            out = fut.result(timeout=wait_s)
            # time-in-queue before forward start, stamped on the future
            # at batch formation — lets a client split its observed
            # latency into queueing vs compute
            qw = getattr(fut, "_spkn_queue_wait_s", None)
            qw_hdr = ({} if qw is None
                      else {"X-Queue-Wait-Ms": f"{qw * 1e3:.3f}"})
            # the step whose weights computed this answer, stamped at
            # forward time (a swap after the forward must not relabel it)
            step = fut._spkn_step
            if want_npz:
                self._reply_bytes(h, 200, _encode_npz(out),
                                  NPZ_CONTENT_TYPE,
                                  extra={"X-Model": model,
                                         "X-Model-Step":
                                         str(-1 if step is None
                                             else step), **qw_hdr})
            else:
                self._reply(h, 200, {
                    "model": model, "step": step,
                    "latency_ms": round(
                        (time.perf_counter() - t0) * 1e3, 3),
                    "outputs": {k: np.asarray(v).tolist()
                                for k, v in out.items()}},
                    extra=qw_hdr)
        except _BodyReadTimeout:
            # half-read body: the stream is desynced — answer AND close
            self._reply(h, 408, {"error": "timed out reading the "
                                 "request body",
                                 "error_kind": "request_timeout"},
                        close=True)
        except UnknownModelError as e:
            self._reply(h, 404, {"error": str(e),
                                 "error_kind": "unknown_model"})
        except PriorityShedError as e:
            self._reply(h, 429, {"error": str(e),
                                 "error_kind": "priority"},
                        retry_after=True)
        except TenantLimitError as e:
            self._reply(h, 429, {"error": str(e),
                                 "error_kind": "tenant_limit"},
                        retry_after=True)
        except QueueFullError as e:
            self._reply(h, 429, {"error": str(e),
                                 "error_kind": "queue_full"},
                        retry_after=True)
        except DeadlineExpiredError as e:
            self._reply(h, 503, {"error": str(e),
                                 "error_kind": "deadline"},
                        retry_after=True)
        except NoReplicaError as e:
            self._reply(h, 503, {"error": str(e),
                                 "error_kind": "no_replica"},
                        retry_after=True)
        except FutureTimeoutError:
            self._reply(h, 503, {"error": "response wait timed out",
                                 "error_kind": "timeout"},
                        retry_after=True)
        except (ValueError, KeyError, TypeError) as e:
            self._reply(h, 400, {"error": str(e),
                                 "error_kind": "bad_request"})
        except Exception as e:  # the data plane must answer, not die
            self._reply(h, 500, {"error": f"{type(e).__name__}: {e}",
                                 "error_kind": "internal"})

    def _handle_get(self, h: BaseHTTPRequestHandler) -> None:
        try:
            if getattr(h, "_over_cap", False):
                self._reject_over_cap(h)
                return
            if h.path.startswith("/v1/models"):
                rows = {name: lane.model_row()
                        for name, lane in self._lanes().items()}
                for name in self._model_names():
                    rows.setdefault(name, {"remote_only": True})
                self._reply(h, 200, {"models": rows})
            elif h.path.startswith("/healthz"):
                ok = self.adapter.healthy()
                self._reply(h, 200 if ok else 503,
                            {"status": "ok" if ok else "unhealthy"})
            else:
                self._reply(h, 404, {"error": f"no route {h.path!r}",
                                     "error_kind": "not_found"})
        except Exception as e:
            self._reply(h, 500, {"error": str(e),
                                 "error_kind": "internal"})

    def _route_model(self, path: str):
        """'/v1/infer' -> None (default model); '/v1/models/<m>/infer'
        (or ':infer') -> '<m>'; anything else -> NOT_AN_INFER_ROUTE."""
        path = urlsplit(path).path
        if path == "/v1/infer":
            return None
        for sep in ("/infer", ":infer"):
            if path.startswith("/v1/models/") and path.endswith(sep):
                name = path[len("/v1/models/"):-len(sep)]
                if name and "/" not in name:
                    return name
        return NOT_AN_INFER_ROUTE

    def _decode(self, model: Optional[str], body: bytes, ctype: str,
                h: BaseHTTPRequestHandler
                ) -> Tuple[Dict[str, np.ndarray], Optional[float],
                           Optional[Tuple[str, ...]]]:
        """Wire -> per-example arrays, ON THIS (accept) THREAD. Returns
        (payload, deadline_ms, requested output blob names)."""
        hdr_deadline = h.headers.get("X-Deadline-Ms")
        deadline_ms = float(hdr_deadline) if hdr_deadline else None
        outputs: Optional[Tuple[str, ...]] = None
        if ctype in (NPZ_CONTENT_TYPE, "application/octet-stream"):
            # npz carries the outputs request as the reserved tensor key
            payload, outputs = pop_outputs(_decode_npz(body))
        else:
            d = json.loads(body)
            if not isinstance(d, dict) or \
                    not isinstance(d.get("inputs"), dict):
                raise ValueError(
                    'JSON body must be {"inputs": {<name>: array}, '
                    '"deadline_ms"?: number, "outputs"?: [names]}')
            if d.get("deadline_ms") is not None:
                deadline_ms = float(d["deadline_ms"])
            if d.get("outputs"):
                outputs = tuple(str(o) for o in d["outputs"])
            payload = {str(k): np.asarray(v)
                       for k, v in d["inputs"].items()}
        # dtype coercion per the net's input schema (JSON numbers land
        # float64/int64; the worker-side stack would cast anyway, but
        # HERE the cast runs on the accept thread)
        self.adapter.coerce(model, payload)
        return payload, deadline_ms, outputs

    # -- replies -------------------------------------------------------------

    def _reply(self, h, code: int, obj: Dict[str, Any],
               retry_after: bool = False, close: bool = False,
               extra: Optional[Dict[str, str]] = None) -> None:
        if getattr(h, "_spkn_rec", None) is not None:
            h._spkn_outcome = ("ok" if code == 200
                               else str(obj.get("error_kind") or code))
        self._reply_bytes(h, code, json.dumps(obj).encode(),
                          "application/json", retry_after=retry_after,
                          close=close, extra=extra)

    def _reply_bytes(self, h, code: int, data: bytes, ctype: str,
                     retry_after: bool = False, close: bool = False,
                     extra: Optional[Dict[str, str]] = None) -> None:
        # close this request's trace record (every POST outcome funnels
        # here) and echo the trace id so a client can go from a slow
        # response to its assembled trace without guessing
        rec = getattr(h, "_spkn_rec", None)
        if rec is not None:
            h._spkn_rec = None
            rt = reqtrace.active()
            if rt is not None:
                extra = {**(extra or {}),
                         "X-Trace-Id": rec["ctx"].encoded()}
                rt.finish(rec, getattr(h, "_spkn_outcome", None)
                          or ("ok" if code == 200 else "error"))
        self._c_http.inc(code=str(code), transport=self.transport)
        try:
            h.send_response(code)
            h.send_header("Content-Type", ctype)
            h.send_header("Content-Length", str(len(data)))
            if extra:
                for k, v in extra.items():
                    h.send_header(k, v)
            if retry_after:
                # RFC 9110 delta-seconds (integer); sub-second backpressure
                # still says "1" — the body's error_kind carries the why
                h.send_header("Retry-After",
                              str(max(1, round(self.retry_after_s))))
            if close:
                h.send_header("Connection", "close")
                h.close_connection = True
            h.end_headers()
            h.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up first; nothing to answer

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self._http.server_address[:2]

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()


class _NotAnInferRoute:
    pass


NOT_AN_INFER_ROUTE = _NotAnInferRoute()


# ---------------------------------------------------------------------------
# the matching client
# ---------------------------------------------------------------------------

_conn_cache = threading.local()
MAX_CACHED_CONNECTIONS = 8  # per thread; LRU-evicted past this


def lru_cache_get(tl: threading.local, attr: str, key, factory,
                  max_cached: int):
    """Thread-local keep-alive object cache with LRU bounding (dict
    insertion order is the LRU order; re-insertion moves to the tail).
    Shared by http_infer's connection cache and binary_infer's client
    cache — ONE copy of the cache-hygiene rules. Evictees get
    `.close()`d, exceptions swallowed (a dying socket must not fail the
    request that merely aged it out)."""
    cache = getattr(tl, attr, None)
    if cache is None:
        cache = {}
        setattr(tl, attr, cache)
    obj = cache.pop(key, None)
    if obj is None:
        obj = factory()
    cache[key] = obj
    while len(cache) > max_cached:
        oldest = next(k for k in cache if k != key)
        old = cache.pop(oldest)
        try:
            old.close()
        except Exception:
            pass
    return obj


def lru_cache_drop(tl: threading.local, attr: str, key) -> None:
    """Evict + close one cached object (ANY-transport-error hygiene:
    never re-use a stream in an unknown state)."""
    obj = getattr(tl, attr, {}).pop(key, None)
    if obj is not None:
        try:
            obj.close()
        except Exception:
            pass


def _connection(host: str, port: int, timeout: float):
    """Thread-cached keep-alive HTTPConnection (one per (host, port) per
    thread: an open-loop driver needs connection reuse to mean anything).
    LRU-BOUNDED: a client sweeping many replicas must not accumulate one
    socket per address it ever touched."""
    conn = lru_cache_get(
        _conn_cache, "conns", (host, port),
        lambda: http.client.HTTPConnection(host, port, timeout=timeout),
        MAX_CACHED_CONNECTIONS)
    conn.timeout = timeout
    return conn


def _drop_connection(host: str, port: int) -> None:
    lru_cache_drop(_conn_cache, "conns", (host, port))


def http_infer(base_url: str, model: str,
               payload: Dict[str, np.ndarray],
               deadline_s: Optional[float] = None,
               timeout: float = 30.0,
               tenant: Optional[str] = None,
               priority: Optional[str] = None,
               outputs: Optional[Tuple[str, ...]] = None,
               trace=None, meta: Optional[Dict[str, Any]] = None
               ) -> Dict[str, np.ndarray]:
    """POST one inference request (npz wire format, keep-alive) and
    return the output arrays. Maps the frontend's shed codes back to the
    serve exceptions, so a remote replica behaves like a local lane.
    `meta`, when given, receives "status", and for a 200 "step" (the
    served checkpoint step, -1 for initial weights) and "queue_wait_ms".

    Cache hygiene: ANY error between request and full response read —
    transport or otherwise — evicts this (host, port)'s thread-cached
    connection. A half-read reply left on a cached socket would desync
    every later request on it; better a fresh TCP handshake than a
    poisoned stream."""
    u = urlsplit(base_url if "//" in base_url else f"http://{base_url}")
    host, port = u.hostname, u.port or 80
    path = f"{u.path.rstrip('/')}/v1/models/{model}/infer"
    headers = {"Content-Type": NPZ_CONTENT_TYPE,
               "Accept": NPZ_CONTENT_TYPE}
    if deadline_s is not None:
        headers["X-Deadline-Ms"] = f"{deadline_s * 1e3:.3f}"
    if tenant is not None:
        headers["X-Tenant"] = tenant
    if priority is not None:
        headers["X-Priority"] = priority
    ctx = reqtrace.parse_context(trace) if trace is not None else None
    rt = reqtrace.active() if ctx is not None else None
    if ctx is not None:
        headers["X-Trace-Id"] = ctx.encoded()
    body = _encode_npz(encode_outputs(payload, outputs))
    t_wire = rt.now_us() if rt is not None else 0.0
    try:
        for attempt in (0, 1):
            conn = _connection(host, port, timeout)
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()  # full read keeps the conn reusable
                break
            except socket.timeout:
                _drop_connection(host, port)
                raise  # a slow server is not a stale socket: no retry
            except (ConnectionError, http.client.HTTPException,
                    OSError) as e:
                # a server-closed cached connection surfaces here: retry
                # once on a fresh socket, then give up loudly
                _drop_connection(host, port)
                if attempt:
                    raise ConnectionError(
                        f"http_infer to {base_url}: {e}") from e
            except BaseException:
                # ANY other failure mid-exchange (decode error raised by
                # a lower layer, KeyboardInterrupt, ...) leaves the
                # socket in an unknown read state: never re-use it
                _drop_connection(host, port)
                raise
        if meta is not None:
            meta["status"] = resp.status
            if resp.status == 200:
                step = resp.getheader("X-Model-Step")
                qw = resp.getheader("X-Queue-Wait-Ms")
                meta["step"] = None if step is None else int(step)
                meta["queue_wait_ms"] = None if qw is None else float(qw)
        if resp.status == 200:
            try:
                return _decode_npz(data)
            except Exception:
                # the reply was fully read, but undecodable — the stream
                # itself may be desynced; drop it before raising
                _drop_connection(host, port)
                raise
        try:
            err = json.loads(data)
        except Exception:
            err = {"error": data[:200].decode("utf-8", "replace")}
        kind, msg = err.get("error_kind"), err.get("error", "")
        if resp.status == 429 and kind == "tenant_limit":
            raise TenantLimitError(msg)
        if resp.status == 429 and kind == "priority":
            raise PriorityShedError(msg)
        if resp.status == 429:
            raise QueueFullError(msg)
        if resp.status == 503 and kind == "deadline":
            raise DeadlineExpiredError(msg)
        if resp.status == 503:
            raise NoReplicaError(msg or f"replica shed ({kind})")
        if resp.status == 404:
            raise UnknownModelError(msg or model)
        raise RuntimeError(f"http_infer: {resp.status} {msg}")
    finally:
        # the client-side wire span brackets the whole exchange; the
        # assembler subtracts the matched server record to expose pure
        # network + clock-offset time on this hop
        if rt is not None:
            rt.stage(ctx, "wire:http", t_wire, rt.now_us() - t_wire,
                     kind="client")
