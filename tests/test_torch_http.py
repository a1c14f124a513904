"""The port's HTTP/1.1 data plane (serve/http_frontend.py) against the JAX
package's.

The same good and bad requests go to the JAX `HttpFrontend` over its
`InferenceServer(JaxNet)` and to the port's over a `TorchNet` holding the
same weights (lenet, carried across as the JAX layouts), in JSON and npz:
the same status codes, `error_kind`s, `Retry-After` and
`Connection: close` headers and JSON keys, and outputs within 1e-5 of
each blob's largest magnitude (at least 1): atol 1e-5 for prob, and the
same relative bound for the hidden blob fc1 (magnitudes ~10), since the
convolutions' and products' sum order differs between the packages. Then, on
both: N requests on one keep-alive connection use one connection; 429
under a full queue; 503 for an expired deadline (at the door and in the
queue); 408 for a body that stalls mid-read; 413 over the body cap; the
connection cap; the idle timeout; a hot tenant that cannot starve a quiet
one (under an injected admission clock).

Every test binds port 0. Overload is made with a gate, not with time: the
net's forward blocks on an event until the test opens it, so the queue
fills exactly. Every blocking call has a timeout.
"""
import http.client
import io
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import sparknet_tpu.serve.admission as jax_adm
from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.serve.http_frontend import HttpFrontend as JaxFrontend
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig

import sparknet_tpu_torch.serve.admission as adm
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.model.net import params_to_jax
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve import http_frontend as hf
from sparknet_tpu_torch.serve.batcher import (DeadlineExpiredError,
                                              QueueFullError)
from sparknet_tpu_torch.serve.server import (InferenceServer, ServeConfig,
                                             zeros_batch)

torch.set_num_threads(2)

NPZ = "application/x-npz"


@pytest.fixture(scope="module")
def nets():
    jnet = JaxNet(jax_zoo.lenet(batch=4), seed=4)
    tnet = TorchNet(zoo.lenet(batch=4), device="cpu")
    tnet.load_jax_params({l: {p: np.asarray(v) for p, v in lp.items()}
                          for l, lp in jnet.params.items()})
    return {"jax": jnet, "port": tnet}


PKG = {"jax": (JaxServer, JaxServeConfig, JaxFrontend),
       "port": (InferenceServer, ServeConfig, hf.HttpFrontend)}


class GatedNet:
    """A net whose forward waits for `gate` (set by the test) after
    setting `entered`: overload without timing."""

    def __init__(self, inner):
        self._inner = inner
        self.gate = threading.Event()
        self.entered = threading.Event()

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def forward(self, *a, **kw):
        self.entered.set()
        assert self.gate.wait(timeout=60), "the test never opened the gate"
        return self._inner.forward(*a, **kw)


class _Lane:
    def __init__(self, k, net, cfg_kw, fe_kw):
        srv_cls, cfg_cls, fe_cls = PKG[k]
        self.server = srv_cls(net, cfg_cls(**cfg_kw)).start()
        self.fe = fe_cls(self.server, port=0, **fe_kw)
        self.address = self.fe.address

    def close(self):
        self.fe.stop()
        self.server.stop()


def _lanes(nets, cfg_kw=None, fe_kw=None, gated=False):
    cfg = {**dict(max_batch=4, max_wait_ms=2.0, outputs=("prob",),
                  metrics_every_batches=0), **(cfg_kw or {})}
    return {k: _Lane(k, GatedNet(n) if gated else n, cfg, fe_kw or {})
            for k, n in nets.items()}


def _close(lanes):
    for lane in lanes.values():
        if isinstance(lane.server.net, GatedNet):
            lane.server.net.gate.set()
        lane.close()


def _example(i):
    r = np.random.default_rng(2000 + i)
    return {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}


def _npz(arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _post(conn, path, body, ctype="application/json", headers=None):
    conn.request("POST", path, body=body,
                 headers={"Content-Type": ctype, **(headers or {})})
    resp = conn.getresponse()
    return resp, resp.read()


def _json(i, **extra):
    return json.dumps({"inputs": {"data": _example(i)["data"].tolist()},
                       **extra}).encode()


#: (name, method, path, body, content type, extra headers)
CASES = [
    ("json", "POST", "/v1/infer", _json(0), "application/json", {}),
    ("json-model", "POST", "/v1/models/default/infer", _json(1),
     "application/json", {}),
    ("json-colon", "POST", "/v1/models/default:infer", _json(2),
     "application/json", {}),
    ("json-outputs", "POST", "/v1/infer", _json(3, outputs=["fc1"]),
     "application/json", {}),
    ("json-accept-npz", "POST", "/v1/infer", _json(4), "application/json",
     {"Accept": NPZ}),
    ("npz", "POST", "/v1/infer", _npz(_example(5)), NPZ, {}),
    ("npz-outputs", "POST", "/v1/models/default/infer",
     _npz(hf.encode_outputs(_example(6), ("fc1", "prob"))), NPZ, {}),
    ("npz-deadline", "POST", "/v1/infer", _npz(_example(7)), NPZ,
     {"X-Deadline-Ms": "30000"}),
    ("not-json", "POST", "/v1/infer", b"not json", "application/json", {}),
    ("json-list", "POST", "/v1/infer", b"[1, 2]", "application/json", {}),
    ("not-npz", "POST", "/v1/infer", b"garbage", NPZ, {}),
    ("unknown-model", "POST", "/v1/models/nope/infer",
     json.dumps({"inputs": {}}).encode(), "application/json", {}),
    ("bogus-input", "POST", "/v1/infer",
     json.dumps({"inputs": {"bogus": [1.0]}}).encode(), "application/json",
     {}),
    ("wrong-shape", "POST", "/v1/infer",
     json.dumps({"inputs": {"data": [[1.0, 2.0]]}}).encode(),
     "application/json", {}),
    ("unknown-blob", "POST", "/v1/infer", _json(8, outputs=["nope"]),
     "application/json", {}),
    ("expired-deadline", "POST", "/v1/infer", _json(9, deadline_ms=0),
     "application/json", {}),
    ("no-route", "POST", "/v2/infer", _json(0), "application/json", {}),
    ("get-models", "GET", "/v1/models", None, None, {}),
    ("get-healthz", "GET", "/healthz", None, None, {}),
    ("get-nope", "GET", "/nope", None, None, {}),
]


def _tol(want) -> float:
    """1e-5 of the blob's largest magnitude, at least 1e-5."""
    return 1e-5 * max(1.0, float(np.abs(want).max()))


def _send(address, case):
    _, method, path, body, ctype, hdrs = case
    conn = http.client.HTTPConnection(*address, timeout=30)
    headers = dict(hdrs)
    if ctype:
        headers["Content-Type"] = ctype
    conn.request(method, path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def test_the_same_requests_get_the_jax_frontend_s_answers(nets):
    lanes = _lanes(nets)
    try:
        for case in CASES:
            got = {k: _send(lane.address, case) for k, lane in lanes.items()}
            (pr, pd), (jr, jd) = got["port"], got["jax"]
            name = case[0]
            assert pr.status == jr.status, (name, pr.status, jr.status, pd)
            for h in ("Retry-After", "Connection", "Content-Type"):
                assert pr.getheader(h) == jr.getheader(h), (name, h)
            if pr.getheader("Content-Type") == NPZ:
                assert pr.getheader("X-Model-Step") == \
                    jr.getheader("X-Model-Step") == "-1"
                with np.load(io.BytesIO(pd)) as zp, \
                        np.load(io.BytesIO(jd)) as zj:
                    assert sorted(zp.files) == sorted(zj.files), name
                    for f in zj.files:
                        assert zp[f].dtype == zj[f].dtype
                        np.testing.assert_allclose(zp[f], zj[f], rtol=0,
                                                   atol=_tol(zj[f]),
                                                   err_msg=name)
                continue
            p, j = json.loads(pd), json.loads(jd)
            assert set(p) == set(j), (name, set(p) ^ set(j))
            if "error_kind" in j:
                assert p["error_kind"] == j["error_kind"], name
            if "outputs" in j:
                assert p["step"] == j["step"] and p["model"] == j["model"]
                assert set(p["outputs"]) == set(j["outputs"])
                for b in j["outputs"]:
                    want = np.asarray(j["outputs"][b])
                    np.testing.assert_allclose(
                        np.asarray(p["outputs"][b]), want, rtol=0,
                        atol=_tol(want), err_msg=f"{name} {b}")
            if "models" in j:
                assert set(p["models"]) == set(j["models"]) == {"default"}
                assert set(p["models"]["default"]) == \
                    set(j["models"]["default"])
        # the same codes land in the transport-labeled counters
        for k, lane in lanes.items():
            text = lane.server.registry.render_prometheus()
            assert 'sparknet_serve_http_requests_total{code="200",' \
                'transport="http"}' in text, k
            assert 'sparknet_serve_shed_total' in text or k == "port"
    finally:
        _close(lanes)


def test_http_infer_round_trips_exact_dtypes_and_reports_the_step(nets):
    lanes = _lanes(nets, cfg_kw=dict(buckets=(4,), outputs=("fc2",)))
    try:
        lane = lanes["port"]
        x = _example(0)
        inproc = lane.server.infer(x)
        meta = {}
        url = f"http://{lane.address[0]}:{lane.address[1]}"
        out = hf.http_infer(url, "default", x, deadline_s=30.0, meta=meta)
        assert out["fc2"].dtype == np.float32
        np.testing.assert_array_equal(out["fc2"], inproc["fc2"])
        assert meta["status"] == 200 and meta["step"] == -1
        assert meta["queue_wait_ms"] >= 0.0
        jurl = f"http://{lanes['jax'].address[0]}:{lanes['jax'].address[1]}"
        jout = hf.http_infer(jurl, "default", x, deadline_s=30.0)
        np.testing.assert_allclose(out["fc2"], jout["fc2"], rtol=0,
                                   atol=_tol(jout["fc2"]))
        with pytest.raises(hf.UnknownModelError):
            hf.http_infer(url, "nope", x)
    finally:
        _close(lanes)


def test_n_requests_on_one_keepalive_connection_use_one_connection(nets):
    lanes = _lanes(nets)
    try:
        for k, lane in lanes.items():
            conn = http.client.HTTPConnection(*lane.address, timeout=30)
            for i in range(6):
                resp, data = _post(conn, "/v1/infer", _json(i))
                assert resp.status == 200, data
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            r.read()
            assert r.status == 200
            conn.close()
            assert lane.fe.requests == 6 and lane.fe.connections == 1, k
            c = lane.server.registry.counter(
                "sparknet_serve_http_connections_total",
                labels=("transport",))
            assert c.value(transport="http") == 1
    finally:
        _close(lanes)


def test_a_full_queue_answers_429_with_retry_after(nets):
    lanes = _lanes(nets, cfg_kw=dict(max_batch=1, max_queue=2),
                   gated=True)
    try:
        for k, lane in lanes.items():
            srv, net = lane.server, lane.server.net
            first = srv.submit(_example(0))
            assert net.entered.wait(timeout=30)   # the worker is held
            queued = [srv.submit(_example(i)) for i in (1, 2)]
            assert srv.batcher.depth() == 2
            conn = http.client.HTTPConnection(*lane.address, timeout=30)
            resp, data = _post(conn, "/v1/infer", _json(3))
            assert resp.status == 429, (k, data)
            assert json.loads(data)["error_kind"] == "queue_full"
            assert int(resp.getheader("Retry-After")) >= 1
            if k == "port":
                url = f"http://{lane.address[0]}:{lane.address[1]}"
                with pytest.raises(QueueFullError):
                    hf.http_infer(url, "default", _example(4))
            net.gate.set()
            for f in [first] + queued:
                assert f.result(timeout=30)["prob"].shape == (10,)
            resp, _ = _post(conn, "/v1/infer", _json(5))
            assert resp.status == 200
            conn.close()
    finally:
        _close(lanes)


def test_an_expired_deadline_answers_503_not_a_hang(nets):
    """At the door (deadline 0) and in the queue (a deadline that passes
    while the worker is held)."""
    lanes = _lanes(nets, cfg_kw=dict(max_batch=1), gated=True)
    try:
        for k, lane in lanes.items():
            srv, net = lane.server, lane.server.net
            conn = http.client.HTTPConnection(*lane.address, timeout=30)
            resp, data = _post(conn, "/v1/infer", _json(0, deadline_ms=0))
            assert resp.status == 503 and resp.getheader("Retry-After")
            assert json.loads(data)["error_kind"] == "deadline"
            blocker = srv.submit(_example(1))
            assert net.entered.wait(timeout=30)
            box = {}

            def client():
                c = http.client.HTTPConnection(*lane.address, timeout=30)
                box["resp"] = _post(c, "/v1/infer",
                                    _json(2, deadline_ms=50.0))
                c.close()

            t = threading.Thread(target=client)
            t.start()
            deadline = time.monotonic() + 30
            while srv.batcher.depth() < 1:   # the request is queued
                assert time.monotonic() < deadline
                time.sleep(0.001)
            # it was enqueued before it was seen: once 0.1 s have passed
            # since, its 50 ms deadline has certainly expired
            seen = time.monotonic()
            while time.monotonic() < seen + 0.1:
                time.sleep(0.01)
            net.gate.set()
            t.join(timeout=30)
            assert not t.is_alive(), "the client hung"
            resp, data = box["resp"]
            assert resp.status == 503, (k, data)
            assert json.loads(data)["error_kind"] == "deadline"
            assert resp.getheader("Retry-After") is not None
            assert blocker.result(timeout=30)["prob"].shape == (10,)
            assert srv.batcher.shed >= 2
            if k == "port":
                url = f"http://{lane.address[0]}:{lane.address[1]}"
                with pytest.raises(DeadlineExpiredError):
                    hf.http_infer(url, "default", _example(3),
                                  deadline_s=0.0)
            conn.close()
    finally:
        _close(lanes)


def test_a_body_that_stalls_answers_408_and_closes(nets):
    lanes = _lanes(nets, fe_kw=dict(idle_timeout_s=0.3))
    try:
        for k, lane in lanes.items():
            s = socket.create_connection(lane.address, timeout=10)
            s.sendall(b"POST /v1/infer HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Type: application/json\r\n"
                      b"Content-Length: 1000\r\n\r\n"
                      b'{"inputs"')  # 991 bytes never arrive
            data = b""
            while True:  # the server answers, then closes (EOF)
                chunk = s.recv(4096)
                if not chunk:
                    break
                data += chunk
            s.close()
            assert b" 408 " in data.split(b"\r\n")[0], (k, data[:80])
            assert b"request_timeout" in data
            assert b"Connection: close" in data
            conn = http.client.HTTPConnection(*lane.address, timeout=10)
            resp, _ = _post(conn, "/v1/infer", _json(0))
            assert resp.status == 200
            conn.close()
    finally:
        _close(lanes)


def test_a_body_over_the_cap_answers_413_and_closes(nets):
    lanes = _lanes(nets, fe_kw=dict(max_body_bytes=1000))
    try:
        for k, lane in lanes.items():
            conn = http.client.HTTPConnection(*lane.address, timeout=10)
            resp, data = _post(conn, "/v1/infer", _json(0))
            assert resp.status == 413, k
            assert json.loads(data)["error_kind"] == "bad_request"
            assert resp.getheader("Connection") == "close"
            conn.close()
            s = socket.create_connection(lane.address, timeout=10)
            s.sendall(b"POST /v1/infer HTTP/1.1\r\nHost: x\r\n\r\n")
            first = s.recv(4096).split(b"\r\n")[0]
            s.close()
            assert b" 411 " in first, (k, first)
    finally:
        _close(lanes)


def test_connections_past_the_cap_are_answered_503(nets):
    lanes = _lanes(nets, fe_kw=dict(max_connections=2, idle_timeout_s=30.0))
    try:
        for k, lane in lanes.items():
            held = []
            for i in range(2):
                c = http.client.HTTPConnection(*lane.address, timeout=10)
                resp, _ = _post(c, "/v1/infer", _json(i))
                assert resp.status == 200
                held.append(c)
            over = http.client.HTTPConnection(*lane.address, timeout=10)
            resp, data = _post(over, "/v1/infer", _json(2))
            assert resp.status == 503, k
            assert json.loads(data)["error_kind"] == "over_capacity"
            assert resp.getheader("Connection") == "close"
            assert resp.getheader("Retry-After") is not None
            over.close()
            assert lane.fe.rejected_over_cap == 1
            resp, _ = _post(held[0], "/v1/infer", _json(3))
            assert resp.status == 200
            for c in held:
                c.close()
    finally:
        _close(lanes)


def test_an_idle_keepalive_connection_is_released(nets):
    lanes = _lanes(nets, fe_kw=dict(idle_timeout_s=0.3))
    try:
        for k, lane in lanes.items():
            conn = http.client.HTTPConnection(*lane.address, timeout=10)
            resp, _ = _post(conn, "/v1/infer", _json(0))
            assert resp.status == 200
            gauge = lane.server.registry.gauge(
                "sparknet_serve_http_connections_active",
                labels=("transport",))
            deadline = time.monotonic() + 30
            while gauge.value(transport="http") != 0:
                assert time.monotonic() < deadline, (
                    f"{k}: the idle connection still pins its thread")
                time.sleep(0.01)
            conn.close()
    finally:
        _close(lanes)


class FakeClock:
    def __init__(self):
        self.now = 500.0

    def monotonic(self):
        return self.now


def test_a_hot_tenant_cannot_starve_a_quiet_one(nets, monkeypatch):
    """Per-tenant token buckets ahead of the queue, under a frozen clock:
    the hot tenant's flood past its burst is shed typed (429
    tenant_limit, counted reason="tenant_limit") while the quiet tenant's
    requests all serve; a second's refill readmits both; priority classes
    shed low first under pressure. Both packages, one script."""
    clocks = {"port": FakeClock(), "jax": FakeClock()}
    monkeypatch.setattr(adm, "time", clocks["port"])
    monkeypatch.setattr(jax_adm, "time", clocks["jax"])
    doors = {"port": adm.PriorityAdmission(rate_rps=2.0, burst=2.0),
             "jax": jax_adm.PriorityAdmission(rate_rps=2.0, burst=2.0)}
    lanes = {k: _Lane(k, n, dict(max_batch=4, max_wait_ms=2.0,
                                 outputs=("prob",),
                                 metrics_every_batches=0),
                      dict(tenants=doors[k]))
             for k, n in nets.items()}
    script = ([("hot", None)] * 6 + [("quiet", None)] * 2 + ["tick"]
              + [("quiet", None), ("hot", None), ("hot", None),
                 ("hot", None)]
              + ["press"] + [("quiet", "low"), ("quiet", "high"),
                             (None, "low")])
    try:
        codes = {}
        for k, lane in lanes.items():
            conn = http.client.HTTPConnection(*lane.address, timeout=30)
            seq = []
            for step in script:
                if step == "tick":
                    clocks[k].now += 1.0
                    continue
                if step == "press":
                    doors[k].set_pressure(0.6)
                    continue
                tenant, prio = step
                hdrs = {}
                if tenant:
                    hdrs["X-Tenant"] = tenant
                if prio:
                    hdrs["X-Priority"] = prio
                resp, data = _post(conn, "/v1/infer", _json(0),
                                   headers=hdrs)
                seq.append((resp.status,
                            json.loads(data).get("error_kind")))
            conn.close()
            codes[k] = seq
            assert lane.fe.connections == 1   # every 429 kept the conn
        assert codes["port"] == codes["jax"]
        seq = codes["port"]
        assert seq[:6] == [(200, None)] * 2 + [(429, "tenant_limit")] * 4
        assert seq[6:8] == [(200, None)] * 2            # quiet not starved
        assert seq[8:12] == [(200, None), (200, None), (200, None),
                             (429, "tenant_limit")]
        assert seq[12:] == [(429, "priority"), (200, None),
                            (429, "priority")]
        c = lanes["port"].server.registry.counter(
            "sparknet_serve_shed_total", labels=("model", "reason"))
        assert c.value(model="", reason="tenant_limit") == 5
        assert c.value(model="", reason="priority") == 2
    finally:
        _close(lanes)


# -- the client --------------------------------------------------------------

class _MidReplyCloser(threading.Thread):
    """Reads a request, then closes mid-reply (announces 100 body bytes,
    sends 5)."""

    def __init__(self):
        super().__init__(daemon=True)
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.address = self.sock.getsockname()
        self.running = True

    def run(self):
        while self.running:
            try:
                c, _ = self.sock.accept()
            except OSError:
                return
            try:
                c.settimeout(5.0)
                buf = b""
                while b"\r\n\r\n" not in buf:
                    buf += c.recv(4096)
                c.sendall(b"HTTP/1.1 200 OK\r\n"
                          b"Content-Type: application/x-npz\r\n"
                          b"Content-Length: 100\r\n\r\nxxxxx")
            except OSError:
                pass
            finally:
                c.close()

    def stop(self):
        self.running = False
        self.sock.close()


def test_http_infer_evicts_a_connection_closed_mid_reply():
    srv = _MidReplyCloser()
    srv.start()
    try:
        host, port = srv.address
        with pytest.raises((ConnectionError, OSError)):
            hf.http_infer(f"http://{host}:{port}", "m", _example(0),
                          timeout=5.0)
        assert (host, port) not in getattr(hf._conn_cache, "conns", {})
    finally:
        srv.stop()


def test_http_infer_connection_cache_is_lru_bounded():
    for p in range(20000, 20040):   # constructed, never connected
        hf._connection("127.0.0.1", p, timeout=1.0)
    cache = getattr(hf._conn_cache, "conns", {})
    assert sum(1 for (h, p) in cache if 20000 <= p < 20040) <= \
        hf.MAX_CACHED_CONNECTIONS
    assert ("127.0.0.1", 20039) in cache
    for p in range(20000, 20040):
        hf.lru_cache_drop(hf._conn_cache, "conns", ("127.0.0.1", p))
    assert not any(20000 <= p < 20040
                   for (h, p) in getattr(hf._conn_cache, "conns", {}))


def test_the_frontend_takes_an_inference_server_only(nets):
    with pytest.raises(TypeError, match="ROADMAP A10a"):
        hf.BackendAdapter(object())


def test_a_reply_carries_the_step_whose_weights_computed_it():
    """A swap that lands after a forward must not relabel that forward's
    answer. Here the swap runs on the worker thread inside the first
    forward, once its answer is computed: the reply still says the initial
    step (-1) with the initial weights' prob, and the next request says
    step 7 with the new weights' prob (atol 1e-6: the same CPU forward)."""
    net = TorchNet(zoo.lenet(batch=4), seed=0, device="cpu")
    new = TorchNet(zoo.lenet(batch=4), seed=7, device="cpu")
    flat = {f"{l}/{p}": v
            for l, lp in params_to_jax(new.net, new.params).items()
            for p, v in lp.items()}
    x = _example(0)
    padded = zeros_batch(net, 4)
    padded["data"][0] = x["data"]
    want_old = net.forward(padded, ["prob"])["prob"][0]
    want_new = new.forward(padded, ["prob"])["prob"][0]
    server = InferenceServer(net, ServeConfig(
        max_batch=4, buckets=(4,), max_wait_ms=2.0, outputs=("prob",),
        metrics_every_batches=0)).start()
    inner, swapped = net.forward, []

    def forward(*a, **kw):
        out = inner(*a, **kw)
        if not swapped:  # the canary forward of the install re-enters
            swapped.append(True)
            assert server.manager.install(flat, step=7)
        return out

    net.forward = forward
    fe = hf.HttpFrontend(server, port=0)
    url = f"http://{fe.address[0]}:{fe.address[1]}"
    try:
        meta = {}
        got = hf.http_infer(url, "default", x, deadline_s=30.0, meta=meta)
        assert swapped and server.manager.step == 7
        assert meta["step"] == -1
        np.testing.assert_allclose(got["prob"], want_old, rtol=0, atol=1e-6)
        conn = http.client.HTTPConnection(*fe.address, timeout=30)
        resp, body = _post(conn, "/v1/models/default/infer", _json(0))
        conn.close()
        reply = json.loads(body)
        assert resp.status == 200 and reply["step"] == 7
        np.testing.assert_allclose(reply["outputs"]["prob"], want_new,
                                   rtol=0, atol=1e-6)
    finally:
        fe.stop()
        server.stop()
