"""The port's binary data plane (serve/binary_frontend.py) against the JAX
package's.

Lenet on the CPU, the port's `TorchNet` holding the JAX net's weights
(carried across in the JAX layouts). Across packages: a JAX
`BinaryClient` is answered by the port's `BinaryFrontend` and a port
client by the JAX frontend; the same good and bad requests get the same
typed error frames (code and kind) from both frontends, and prob within
rtol 1e-4 / atol 1e-6 of the other package's (the convolutions' sum order
differs between the packages: lenet's logits, of magnitude ~10, differ by
~1e-5 relative, which moves a prob of 0.5 by ~1e-5). On the port: a
request through the binary wire and through HTTP is bit-equal, and equal
to a direct forward at the same bucket built as the server builds it; a pipelined burst on
one connection; a streamed multi-MB response reassembles equal, with the
server's copied buffering bounded by the chunk size; typed error frames
for every shed; malformed frames (bad magic, bad version, oversized,
truncated, a client gone mid-reply) fail their own connection only; the
connection cap answers typed; the frame's tenant field feeds the token
buckets (under a frozen admission clock); a CANCEL reaches a queued
request and is dropped for a formed one (a gated net, no sleeps); the
queue wait rides both wires; the request journal; the router's remote
replica over `spkn://`; the serve CLI with `--binary-port`.
"""
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import sparknet_tpu.serve.admission as jax_adm
from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.serve.binary_frontend import BinaryClient as JaxClient
from sparknet_tpu.serve.binary_frontend import \
    BinaryFrontend as JaxFrontend
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig

import sparknet_tpu_torch.serve.admission as adm
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.model.spec import (InputSpec, LayerSpec, NetSpec,
                                           PoolingParam)
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve import wire
from sparknet_tpu_torch.serve.batcher import (DeadlineExpiredError,
                                              RequestCancelledError)
from sparknet_tpu_torch.serve.binary_frontend import (BinaryClient,
                                                      BinaryFrontend,
                                                      binary_infer)
from sparknet_tpu_torch.serve.http_frontend import (NPZ_CONTENT_TYPE,
                                                    HttpFrontend,
                                                    _encode_npz, http_infer)
from sparknet_tpu_torch.serve.admission import (TenantAdmission,
                                                TenantLimitError)
from sparknet_tpu_torch.serve.router import (ModelRouter, NoReplicaError,
                                             RouterConfig,
                                             UnknownModelError)
from sparknet_tpu_torch.serve.server import (InferenceServer, ServeConfig,
                                             net_input_specs, zeros_batch)
from sparknet_tpu_torch.utils.logger import Logger

torch.set_num_threads(2)


def _example(i: int) -> dict:
    r = np.random.default_rng(3000 + i)
    return {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}


def _cfg(cls=ServeConfig, **kw):
    return cls(**{**dict(max_batch=4, max_wait_ms=2.0, outputs=("prob",),
                         metrics_every_batches=0), **kw})


@pytest.fixture(scope="module")
def nets():
    jnet = JaxNet(jax_zoo.lenet(batch=4), seed=4)
    tnet = TorchNet(zoo.lenet(batch=4), device="cpu")
    tnet.load_jax_params({l: {p: np.asarray(v) for p, v in lp.items()}
                          for l, lp in jnet.params.items()})
    return {"jax": jnet, "port": tnet}


@pytest.fixture()
def srv(nets):
    with InferenceServer(nets["port"], _cfg()) as s:
        yield s


class GatedNet:
    """A net whose forward waits for `gate` (set by the test) after
    setting `entered`: a queue held without timing."""

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


def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {timeout} s"
        time.sleep(0.001)


# -- across packages ----------------------------------------------------------

@pytest.mark.parametrize("use_shm", [False, True])
@pytest.mark.parametrize("direction", ["jax_client_port_frontend",
                                       "port_client_jax_frontend"])
def test_each_package_s_client_is_answered_by_the_other_s_frontend(
        nets, direction, use_shm):
    """The same requests through both clients against one frontend: the
    answers are bit-equal (one server, one bucket per request), and
    within rtol 1e-4 / atol 1e-6 of the other package's server."""
    servers = {"port": InferenceServer(nets["port"], _cfg()),
               "jax": JaxServer(nets["jax"], _cfg(JaxServeConfig))}
    fe_k = "port" if direction.endswith("port_frontend") else "jax"
    with servers["port"], servers["jax"]:
        fes = {"port": BinaryFrontend(servers["port"], port=0),
               "jax": JaxFrontend(servers["jax"], port=0)}
        other = "jax" if fe_k == "port" else "port"
        foreign = (JaxClient if fe_k == "port" else BinaryClient)(
            *fes[fe_k].address, use_shm=use_shm)
        native = (BinaryClient if fe_k == "port" else JaxClient)(
            *fes[fe_k].address, use_shm=False)
        ref = (JaxClient if other == "jax" else BinaryClient)(
            *fes[other].address, use_shm=False)
        try:
            for i in range(3):
                x = _example(i)
                got = foreign.infer(x, model="default", deadline_s=30.0)
                same = native.infer(x, model="default", deadline_s=30.0)
                theirs = ref.infer(x, model="default", deadline_s=30.0)
                assert got["prob"].dtype == np.float32
                np.testing.assert_array_equal(got["prob"], same["prob"])
                np.testing.assert_allclose(got["prob"], theirs["prob"],
                                           rtol=1e-4, atol=1e-6)
            assert foreign.last_timing["queue_wait_ms"] >= 0.0
            # a typed shed crosses packages as the same exception type
            with pytest.raises(KeyError):
                foreign.infer(_example(0), model="nope", deadline_s=30.0)
        finally:
            for c in (foreign, native, ref):
                c.close()
            for fe in fes.values():
                fe.stop()


#: (name, model, payload, deadline_s)
CASES = [
    ("ok", "default", _example(0), 30.0),
    ("unknown_model", "nope", _example(0), 30.0),
    ("expired_deadline", "default", _example(0), -1.0),
    ("not_an_input", "default", {"bogus": np.zeros(3, np.float32)}, 30.0),
    ("wrong_shape", "default",
     {"data": np.zeros((27, 28, 1), np.float32)}, 30.0),
    ("default_route", "", _example(1), 30.0),
    ("int_pixels", "default", {"data": np.ones((28, 28, 1), np.int32)},
     30.0),
    ("float64_pixels", "default", {"data": np.ones((28, 28, 1))}, 30.0),
]


def _frame_reply(address, model, payload, deadline_s):
    """One REQUEST frame over a raw socket -> (type, code, kind, outputs)."""
    head, views = wire.pack_request(1, model, payload,
                                    deadline_ms=deadline_s * 1e3)
    with socket.create_connection(address, timeout=30) as s:
        s.sendall(head + b"".join(bytes(v) for v in views))
        ftype, flags, rid, meta, payload_b = _recv_frame(s, with_payload=True)
    if ftype == wire.T_ERROR:
        code, kind, _ = wire.unpack_error_meta(meta)
        return ftype, code, kind, None
    _, _, _, descs, _ = wire.unpack_response_meta(meta)
    return ftype, 200, None, wire.tensors_from(descs, payload_b)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_same_frames_get_the_jax_frontend_s_answers(nets, case):
    _, model, payload, deadline_s = case
    replies = {}
    servers = {"port": InferenceServer(nets["port"], _cfg()),
               "jax": JaxServer(nets["jax"], _cfg(JaxServeConfig))}
    with servers["port"], servers["jax"]:
        for k, fe_cls in (("port", BinaryFrontend), ("jax", JaxFrontend)):
            fe = fe_cls(servers[k], port=0)
            try:
                replies[k] = _frame_reply(fe.address, model, payload,
                                          deadline_s)
            finally:
                fe.stop()
    assert replies["port"][:3] == replies["jax"][:3]
    if replies["port"][3] is not None:
        np.testing.assert_allclose(replies["port"][3]["prob"],
                                   replies["jax"][3]["prob"],
                                   rtol=1e-4, atol=1e-6)


# -- transport roundtrip + parity --------------------------------------------

def test_binary_bitwise_identical_to_http_same_bucket(nets, srv):
    net = nets["port"]
    bfe = BinaryFrontend(srv, port=0)
    hfe = HttpFrontend(srv, port=0)
    try:
        x = _example(0)
        meta = {}
        out_b = binary_infer(bfe.address, "default", x, deadline_s=30.0,
                             meta=meta)
        out_h = http_infer(f"http://{hfe.address[0]}:{hfe.address[1]}",
                           "default", x, deadline_s=30.0)
        assert out_b["prob"].dtype == np.float32
        np.testing.assert_array_equal(out_b["prob"], out_h["prob"])
        assert meta["step"] is None and meta["queue_wait_ms"] >= 0.0
        one = zeros_batch(net, 1)
        one["data"][0] = x["data"]
        direct = net.forward(one, blob_names=["prob"])
        np.testing.assert_array_equal(out_b["prob"], direct["prob"][0])
    finally:
        bfe.stop()
        hfe.stop()


def test_pipelined_burst_one_connection(nets, srv):
    net = nets["port"]
    bfe = BinaryFrontend(srv, port=0)
    cli = BinaryClient(*bfe.address)
    try:
        xs = [_example(i) for i in range(8)]
        rids = [cli.submit(x, model="default", deadline_s=30.0) for x in xs]
        outs = [cli.collect(rid) for rid in rids]
        direct = net.forward(
            {**zeros_batch(net, 8),
             "data": np.stack([x["data"] for x in xs])},
            blob_names=["prob"])
        for i, out in enumerate(outs):
            np.testing.assert_allclose(out["prob"], direct["prob"][i],
                                       rtol=1e-4, atol=1e-5)
        assert bfe.connections == 1, "pipelining opened extra connections"
        assert bfe.requests == 8
    finally:
        cli.close()
        bfe.stop()


def blob_net(c: int = 8, hw: int = 256) -> TorchNet:
    """A featurizer-shaped net whose per-example output is a 2 MB blob
    (a 1x1 max-pool is the identity)."""
    spec = NetSpec(
        name="blobber", inputs=(InputSpec("data", (1, c, hw, hw)),),
        layers=(LayerSpec(name="feat", type="Pooling", bottoms=("data",),
                          tops=("feat",),
                          pool=PoolingParam(pool="MAX", kernel_size=1,
                                            stride=1)),))
    return TorchNet(spec, device="cpu")


def test_streaming_blob_bounded_buffering():
    net2 = blob_net()
    cfg = ServeConfig(model_name="featurizer", max_batch=1, buckets=(1,),
                      max_wait_ms=1.0, outputs=("feat",),
                      metrics_every_batches=0)
    chunk = 128 << 10
    with InferenceServer(net2, cfg) as s2:
        bfe = BinaryFrontend(s2, port=0, chunk_bytes=chunk)
        cli = BinaryClient(*bfe.address, timeout=60.0, use_shm=False)
        try:
            shape, dt = net_input_specs(net2)["data"]
            r = np.random.default_rng(1)
            req = {"data": r.standard_normal(shape).astype(dt)}
            full = cli.infer(req, model="featurizer", deadline_s=60.0)
            streamed = cli.infer(req, model="featurizer", deadline_s=60.0,
                                 stream=True)
            assert streamed["feat"].nbytes > 1 << 20
            np.testing.assert_array_equal(streamed["feat"], full["feat"])
            np.testing.assert_array_equal(full["feat"], req["data"])
            t = cli.last_timing
            assert t["t_first_byte_s"] <= t["t_complete_s"]
            assert bfe.peak_buffered_bytes < chunk
        finally:
            cli.close()
            bfe.stop()


# -- typed error frames -------------------------------------------------------

def test_error_frames_map_to_typed_exceptions(srv):
    bfe = BinaryFrontend(srv, port=0)
    try:
        with pytest.raises(UnknownModelError):
            binary_infer(bfe.address, "nope", _example(0), deadline_s=30.0)
        with pytest.raises(DeadlineExpiredError):
            binary_infer(bfe.address, "default", _example(0),
                         deadline_s=-1.0)
        with pytest.raises(ValueError, match="bogus"):
            binary_infer(bfe.address, "default",
                         {"bogus": np.zeros(3, np.float32)},
                         deadline_s=30.0)
        assert bfe.connections == 1  # every typed shed kept the socket
        out = binary_infer(bfe.address, "default", _example(1),
                           deadline_s=30.0)
        assert out["prob"].shape == (10,)
        assert bfe.connections == 1
    finally:
        bfe.stop()


def test_a_cancel_reaches_a_queued_request_only(nets):
    """max_batch 1 and a gated forward: request 1 is inside the forward,
    request 2 waits in the queue. A CANCEL of 2 answers it with the typed
    `cancelled` frame; a CANCEL of 1 (already formed) is dropped and its
    normal reply arrives once the gate opens."""
    gated = GatedNet(nets["port"])
    with InferenceServer(gated, _cfg(max_batch=1, buckets=(1,))) as s:
        bfe = BinaryFrontend(s, port=0)
        cli = BinaryClient(*bfe.address, use_shm=False)
        try:
            r1 = cli.submit(_example(0), model="default", deadline_s=60.0)
            assert gated.entered.wait(timeout=30)
            r2 = cli.submit(_example(1), model="default", deadline_s=60.0)
            _wait(lambda: s.batcher.depth() == 1, "request 2 queued")
            cli.cancel(r2)
            cli.cancel(r1)
            with pytest.raises(RequestCancelledError):
                cli.collect(r2)
            gated.gate.set()
            assert cli.collect(r1)["prob"].shape == (10,)
            c = s.registry.counter("sparknet_serve_http_requests_total",
                                   labels=("code", "transport"))
            assert c.value(code="499", transport="binary") == 1
            assert c.value(code="200", transport="binary") == 1
        finally:
            gated.gate.set()
            cli.close()
            bfe.stop()


# -- malformed-wire robustness ------------------------------------------------

def _recv_frame(sock, timeout=10.0, with_payload=False):
    sock.settimeout(timeout)
    buf = b""
    while len(buf) < wire.HEADER_LEN:
        d = sock.recv(4096)
        if not d:
            return None
        buf += d
    ftype, flags, rid, meta_len, plen = wire.parse_header(buf)
    want = wire.HEADER_LEN + meta_len + plen
    while len(buf) < want:
        d = sock.recv(4096)
        if not d:
            return None
        buf += d
    meta = buf[wire.HEADER_LEN:wire.HEADER_LEN + meta_len]
    if with_payload:
        return ftype, flags, rid, meta, buf[wire.HEADER_LEN + meta_len:want]
    return ftype, flags, rid, meta


def _serves_fine(bfe):
    out = binary_infer(bfe.address, "default", _example(9),
                       deadline_s=30.0)
    assert out["prob"].shape == (10,)


def test_bad_magic_answered_typed_then_closed(srv):
    bfe = BinaryFrontend(srv, port=0)
    try:
        s = socket.create_connection(bfe.address, timeout=10)
        s.sendall(b"JUNKJUNKJUNKJUNK" + b"\0" * 16)
        ftype, flags, rid, meta = _recv_frame(s)
        assert ftype == wire.T_ERROR and rid == 0
        code, kind, msg = wire.unpack_error_meta(meta)
        assert (code, kind) == (400, "bad_magic")
        assert s.recv(4096) == b""
        s.close()
        _serves_fine(bfe)
    finally:
        bfe.stop()


@pytest.mark.parametrize("bad", [42, wire.VERSION - 1])
def test_bad_version_answered_typed(srv, bad):
    bfe = BinaryFrontend(srv, port=0)
    try:
        head, _ = wire.pack_request(1, "default", {})
        s = socket.create_connection(bfe.address, timeout=10)
        s.sendall(head[:4] + bytes([bad]) + head[5:])
        ftype, flags, rid, meta = _recv_frame(s)
        code, kind, _ = wire.unpack_error_meta(meta)
        assert ftype == wire.T_ERROR and (code, kind) == (400, "bad_version")
        assert s.recv(4096) == b""
        s.close()
        _serves_fine(bfe)
    finally:
        bfe.stop()


def test_oversized_frame_is_the_413_analog(srv):
    bfe = BinaryFrontend(srv, port=0, max_frame_bytes=1 << 20)
    try:
        hdr = wire.HEADER.pack(wire.MAGIC, wire.VERSION, wire.T_REQUEST,
                               0, 77, 0, (1 << 20) + 1)
        s = socket.create_connection(bfe.address, timeout=10)
        s.sendall(hdr)
        ftype, flags, rid, meta = _recv_frame(s)
        assert ftype == wire.T_ERROR and rid == 77
        code, kind, _ = wire.unpack_error_meta(meta)
        assert (code, kind) == (413, "too_large")
        assert s.recv(4096) == b""
        s.close()
        _serves_fine(bfe)
    finally:
        bfe.stop()


def test_truncated_header_and_midstream_disconnect(srv):
    bfe = BinaryFrontend(srv, port=0)
    try:
        s = socket.create_connection(bfe.address, timeout=10)
        head, _ = wire.pack_request(1, "default", _example(0))
        s.sendall(head[:10])
        s.close()
        s2 = socket.create_connection(bfe.address, timeout=10)
        head2, views2 = wire.pack_request(2, "default", _example(1),
                                          deadline_ms=30000.0, stream=True)
        s2.sendall(head2)
        for v in views2:
            s2.sendall(v)
        s2.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                      struct.pack("ii", 1, 0))  # RST on close
        s2.close()
        _serves_fine(bfe)
        assert all(lp.is_alive() for lp in bfe._loops)
    finally:
        bfe.stop()


def test_over_capacity_is_typed_no_replica_not_a_reset(srv):
    bfe = BinaryFrontend(srv, port=0, max_connections=1)
    try:
        cli = BinaryClient(*bfe.address)
        out = cli.infer(_example(0), model="default", deadline_s=30.0)
        assert out["prob"].shape == (10,)
        for i in range(3):
            with pytest.raises(NoReplicaError, match="capacity"):
                binary_infer(bfe.address, "default", _example(i),
                             deadline_s=10.0)
        assert bfe.rejected_over_cap == 3
        out = cli.infer(_example(1), model="default", deadline_s=30.0)
        assert out["prob"].shape == (10,)
        cli.close()
    finally:
        bfe.stop()


class FakeClock:
    def __init__(self):
        self.now = 500.0

    def monotonic(self):
        return self.now


def test_binary_tenant_field_shed_typed(nets, monkeypatch):
    """The frame's tenant field feeds the same token buckets as the HTTP
    X-Tenant header, in both packages, under a frozen admission clock:
    the burst of 2 serves, the rest of the flood sheds typed
    (tenant_limit), a quiet tenant still serves, and a second's refill
    readmits the hot one."""
    clocks = {"port": FakeClock(), "jax": FakeClock()}
    monkeypatch.setattr(adm, "time", clocks["port"])
    monkeypatch.setattr(jax_adm, "time", clocks["jax"])
    servers = {"port": InferenceServer(nets["port"], _cfg()),
               "jax": JaxServer(nets["jax"], _cfg(JaxServeConfig))}
    seqs = {}
    with servers["port"], servers["jax"]:
        for k, fe_cls, cli_cls, door in (
                ("port", BinaryFrontend, BinaryClient, TenantAdmission),
                ("jax", JaxFrontend, JaxClient, jax_adm.TenantAdmission)):
            fe = fe_cls(servers[k], port=0,
                        tenants=door(rate_rps=1.0, burst=2))
            cli = cli_cls(*fe.address, use_shm=False)
            seq = []
            try:
                for step in ["hot"] * 5 + ["quiet", "tick", "hot", "hot"]:
                    if step == "tick":
                        clocks[k].now += 1.0
                        continue
                    try:
                        cli.infer(_example(0), model="default",
                                  deadline_s=30.0, tenant=step)
                        seq.append("ok")
                    except Exception as e:  # noqa: BLE001 (recorded)
                        seq.append(type(e).__name__)
            finally:
                cli.close()
                fe.stop()
            seqs[k] = seq
        c = servers["port"].registry.counter("sparknet_serve_shed_total",
                                             labels=("model", "reason"))
        assert c.value(model="default", reason="tenant_limit") == 4
    assert seqs["port"] == seqs["jax"]
    assert seqs["port"] == ["ok", "ok"] + ["TenantLimitError"] * 3 + \
        ["ok", "ok", "TenantLimitError"]
    assert issubclass(TenantLimitError, adm.QueueFullError)


# -- queue wait, journal ------------------------------------------------------

def test_queue_wait_surfaces_on_both_wires(srv):
    import http.client
    bfe = BinaryFrontend(srv, port=0)
    hfe = HttpFrontend(srv, port=0)
    cli = BinaryClient(*bfe.address, use_shm=False)
    try:
        cli.infer(_example(0), model="default", deadline_s=30.0)
        qw = cli.last_timing["queue_wait_ms"]
        assert qw is not None and 0.0 <= qw < 60_000.0
        conn = http.client.HTTPConnection(*hfe.address, timeout=30)
        conn.request("POST", "/v1/models/default/infer",
                     body=_encode_npz(_example(1)),
                     headers={"Content-Type": NPZ_CONTENT_TYPE,
                              "Accept": NPZ_CONTENT_TYPE,
                              "X-Deadline-Ms": "30000"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 200
        hdr = resp.getheader("X-Queue-Wait-Ms")
        assert hdr is not None and 0.0 <= float(hdr) < 60_000.0
        conn.close()
    finally:
        cli.close()
        bfe.stop()
        hfe.stop()


def test_request_journal_rows_both_frontends(srv, tmp_path):
    import http.client
    jpath = tmp_path / "journal.jsonl"
    journal = Logger(jsonl_path=str(jpath), echo=False)
    bfe = BinaryFrontend(srv, port=0, journal=journal)
    hfe = HttpFrontend(srv, port=0, journal=journal)
    cli = BinaryClient(*bfe.address, use_shm=False)
    try:
        cli.infer(_example(0), model="default", deadline_s=30.0,
                  tenant="t1")
        with pytest.raises(UnknownModelError):
            cli.infer(_example(1), model="nope", deadline_s=30.0)
        conn = http.client.HTTPConnection(*hfe.address, timeout=30)
        conn.request("POST", "/v1/models/default/infer",
                     body=_encode_npz(_example(2)),
                     headers={"Content-Type": NPZ_CONTENT_TYPE,
                              "Accept": NPZ_CONTENT_TYPE})
        conn.getresponse().read()
        conn.close()
    finally:
        cli.close()
        bfe.stop()
        hfe.stop()
    journal.close()
    rows = [json.loads(l) for l in jpath.read_text().strip().splitlines()]
    assert all(r["kind"] == "request" for r in rows)
    by_transport = {}
    for r in rows:
        by_transport.setdefault(r["transport"], []).append(r)
    ok_bin = [r for r in by_transport["binary"] if r["outcome"] == "ok"]
    assert len(ok_bin) == 1
    assert ok_bin[0]["model"] == "default" and ok_bin[0]["tenant"] == "t1"
    assert ok_bin[0]["sizes"] == {"data": 28 * 28 * 4}
    assert ok_bin[0]["queue_wait_ms"] >= 0.0
    assert [r["outcome"] for r in by_transport["binary"]
            if r["outcome"] != "ok"] == ["unknown_model"]
    assert len(by_transport["http"]) == 1
    assert by_transport["http"][0]["model"] == "default"


# -- router integration, CLI --------------------------------------------------

def test_router_remote_replica_over_binary_transport(nets):
    """`add_remote_replica(..., "spkn://...")` proxies over the binary
    wire: drain the local replica and traffic keeps flowing through the
    remote router's BinaryFrontend, zero dropped; the remote answers carry
    the remote lane's step (None: its initial weights)."""
    rb = ModelRouter(RouterConfig(workers=1))
    rb.add_model("m", TorchNet(zoo.lenet(batch=4), seed=1, device="cpu"),
                 cfg=_cfg())
    ra = ModelRouter(RouterConfig(workers=1))
    ra.add_model("m", nets["port"], cfg=_cfg())
    with rb:
        fe_b = BinaryFrontend(rb, port=0)
        try:
            with ra:
                rep = ra.add_remote_replica(
                    "m", f"spkn://{fe_b.address[0]}:{fe_b.address[1]}")
                assert rep.transport == "binary"
                ra.infer("m", _example(0), timeout=30.0)
                ra.drain("m", "local:m")
                futs = [ra.submit("m", _example(i), deadline_s=30.0)
                        for i in range(5)]
                for f in futs:
                    p = np.asarray(f.result(timeout=30.0)["prob"])
                    assert p.shape == (10,) and np.isfinite(p).all()
                    assert f._spkn_step is None
                    assert f._spkn_queue_wait_s >= 0.0
                routed = ra.registry.counter(
                    "sparknet_serve_routed_total",
                    labels=("model", "replica"))
                assert routed.value(model="m", replica=rep.name) == 5
                assert fe_b.requests == 5
        finally:
            fe_b.stop()


def test_serve_cli_binary_port_demo(tmp_path, capsys):
    from sparknet_tpu_torch.serve.app import main
    main(["--model", "lenet", "--device", "cpu", "--outputs", "prob",
          "--max-batch", "4", "--binary-port", "0", "--no-shm",
          "--io-threads", "1", "--tenant-rate", "1000", "--demo", "4",
          "--workdir", str(tmp_path)])
    captured = capsys.readouterr()
    status = json.loads(captured.out.strip().splitlines()[-1])
    assert status["requests_ok"] == 4
    assert "binary data plane at spkn://127.0.0.1:" in captured.err
    assert "(1 io threads, shm off)" in captured.err
