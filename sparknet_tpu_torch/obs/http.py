"""One small HTTP status server for both roles (train and serve).

A copy of `sparknet_tpu/obs/http.py` (pure Python): the port imports
nothing of the JAX package.

Endpoints:
  /metrics   Prometheus text exposition rendered from the process's
             MetricsRegistry (text/plain; version=0.0.4) — the scrape
             surface, one metric-name schema for trainer and server.
  /healthz   {"status": "ok"|"unhealthy", ...} with 200/503 — liveness,
             from a caller-supplied probe.
  /status    free-form JSON vitals (the serve status dict, the trainer's
             round/loss view) — the human-curl surface the old serve-only
             /metrics JSON used to be.

The server runs on its own daemon threads (ThreadingHTTPServer) and every
handler reads CONSISTENT snapshots: the registry renders under its lock,
and the healthz/status callables are expected to read locked snapshots
too (see utils/metrics.py) — never live mutating attributes.

Port 0 binds an ephemeral port (tests, and multi-process hosts); the bound
address is `StatusServer.address`.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from .registry import MetricsRegistry

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _normalize_route(fn: Callable[..., Dict[str, Any]]
                     ) -> Callable[[str], Dict[str, Any]]:
    """Route callables come in two arities: zero-arg (the original
    contract, e.g. /pod/status) and one-arg taking the request path so
    query strings reach the handler (e.g. /timeseries?name=...). Decide
    ONCE at registration — dispatch must not guess with try/TypeError,
    which would swallow genuine TypeErrors inside the handler."""
    import inspect
    try:
        params = [p for p in inspect.signature(fn).parameters.values()
                  if p.default is p.empty
                  and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        takes_path = len(params) >= 1
    except (TypeError, ValueError):  # builtins / C callables: assume 0-arg
        takes_path = False
    if takes_path:
        return fn
    return lambda _path, _fn=fn: _fn()


class StatusServer:
    """Threaded HTTP server for /metrics, /healthz, /status."""

    def __init__(self, port: int, registry: Optional[MetricsRegistry] = None,
                 healthz: Optional[Callable[[], Tuple[bool,
                                                      Dict[str, Any]]]] = None,
                 status: Optional[Callable[[], Dict[str, Any]]] = None,
                 host: str = "127.0.0.1",
                 metrics_text: Optional[Callable[[], str]] = None,
                 routes: Optional[Dict[str,
                                       Callable[[], Dict[str, Any]]]] = None):
        """`metrics_text` overrides the registry render for /metrics —
        the pod aggregator serves a MERGED exposition no single registry
        holds. `routes` adds extra JSON GET endpoints (path prefix ->
        dict-returning callable), e.g. the aggregator's /pod/status."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        owner = self
        self.registry = registry
        self.healthz = healthz
        self.status = status
        self.metrics_text = metrics_text
        # longest prefix first so /pod/status cannot be shadowed by /pod
        self.routes = sorted(
            ((p, _normalize_route(fn)) for p, fn in (routes or {}).items()),
            key=lambda kv: -len(kv[0]))

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                try:
                    for prefix, fn in owner.routes:
                        if self.path.startswith(prefix):
                            try:
                                body = fn(self.path)
                            except ValueError as e:
                                # bad query params (e.g. /timeseries with an
                                # unknown metric) are the caller's fault
                                self._reply(400,
                                            json.dumps({"error": str(e)}))
                                return
                            self._reply(200, json.dumps(body))
                            return
                    if self.path.startswith("/metrics"):
                        if owner.metrics_text is not None:
                            self._reply(200, owner.metrics_text(),
                                        content_type=PROM_CONTENT_TYPE)
                            return
                        if owner.registry is None:
                            self._reply(404, '{"error": "no registry"}')
                            return
                        self._reply(200, owner.registry.render_prometheus(),
                                    content_type=PROM_CONTENT_TYPE)
                    elif self.path.startswith("/healthz"):
                        ok, body = (owner.healthz() if owner.healthz
                                    else (True, {}))
                        body = {"status": "ok" if ok else "unhealthy",
                                **body}
                        self._reply(200 if ok else 503, json.dumps(body))
                    elif self.path.startswith("/status"):
                        body = owner.status() if owner.status else {}
                        self._reply(200, json.dumps(body))
                    else:
                        self._reply(404, '{"error": "not found"}')
                except Exception as e:  # a broken probe must 500, not hang
                    try:
                        self._reply(500, json.dumps({"error": str(e)}))
                    except Exception:
                        pass

            def _reply(self, code: int, body: str,
                       content_type: str = "application/json") -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):  # quiet: scrapes are not log news
                pass

        self._http = ThreadingHTTPServer((host, port), Handler)
        self._http.daemon_threads = True
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        name="obs-status", daemon=True)
        self._thread.start()

    def add_route(self, prefix: str,
                  fn: Callable[..., Dict[str, Any]]) -> None:
        """Register an extra JSON GET endpoint after construction — the
        history/SLO layers attach to an already-running server this way.
        `fn` may take zero arguments, or one (the full request path,
        query string included) for routes that parse `?name=...` params;
        a ValueError raised by the route maps to a 400 reply."""
        routes = [kv for kv in self.routes if kv[0] != prefix]
        routes.append((prefix, _normalize_route(fn)))
        # rebuilt then swapped atomically: the handler thread iterates
        # whatever list object it read, never a half-sorted one
        self.routes = sorted(routes, key=lambda kv: -len(kv[0]))

    @property
    def address(self) -> Tuple[str, int]:
        """(host, port) actually bound (port 0 resolves here)."""
        return self._http.server_address[:2]

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
