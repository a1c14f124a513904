"""The port's multi-model router (serve/router.py) against the JAX
package's `ModelRouter`.

Lenet on the CPU; the port's nets hold the JAX nets' weights (carried
across in the JAX layouts, or installed from a JAX-format checkpoint step
through the port's store). The same requests go through a JAX router and a
port router built alike, and must get the same answers within rtol 1e-4 /
atol 1e-6 (prob; the convolutions' sum order differs between the
packages), the same per-model metric families and the same status keys:
- routing over two lanes of one shared pool, per-model buckets and
  metrics, the ambiguous default route (404), a lane's weights from a JAX
  checkpoint step;
- a remote replica over HTTP and over `spkn://` (the binary wire);
- a drain that drops nothing: requests queued on the local lane behind a
  gated forward when it drains are all answered, and later ones go to the
  remote replica only;
- the single failover: a remote replica that refuses the connection is
  demoted and its request served by the other replica, once;
- hedging: every request answered exactly once with the hedge budget
  holding, no second leg under drain or under admission pressure, and a
  hedge that wins against a primary held in a gated forward (the loser's
  cancel confirmed);
- coalesced formation, under an injected clock: one focus replica a
  window, rotating fairly, never a drained one, inactive on high fill or
  without a signal;
- NoReplicaError as a typed 503 on both wires; the serve CLI's --models
  demo; the idle lane's duties under traffic to another; the pool resize.
A `gpu` case runs the routed CaffeNet lane on the card and counts its
`lrn_fwd` launches.

Overload and slowness are made with gates (a forward that waits on an
event), not sleeps; every wait is bounded.
"""
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.serve.http_frontend import HttpFrontend as JaxHttp
from sparknet_tpu.serve.router import ModelRouter as JaxRouter
from sparknet_tpu.serve.router import RouterConfig as JaxRouterConfig
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig
from sparknet_tpu.utils import checkpoint as jax_ckpt

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.serve import app
from sparknet_tpu_torch.serve.admission import PriorityAdmission
from sparknet_tpu_torch.serve.binary_frontend import (BinaryFrontend,
                                                      binary_infer)
from sparknet_tpu_torch.serve.http_frontend import (BackendAdapter,
                                                    HttpFrontend, http_infer)
from sparknet_tpu_torch.serve.router import (ModelRouter, NoReplicaError,
                                             Replica, RouterConfig,
                                             UnknownModelError,
                                             heartbeat_fill,
                                             heartbeat_health)
from sparknet_tpu_torch.serve.server import (InferenceServer, ServeConfig,
                                             zeros_batch)
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.heartbeat import HeartbeatWriter

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-6)


def _example(i: int) -> dict:
    r = np.random.default_rng(2000 + i)
    return {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}


def _cfg(cls=ServeConfig, **kw):
    return cls(**{**dict(max_batch=4, max_wait_ms=2.0, outputs=("prob",),
                         metrics_every_batches=0), **kw})


def _port_net(jnet) -> TorchNet:
    net = TorchNet(zoo.lenet(batch=4), device="cpu")
    net.load_jax_params({l: {p: np.asarray(v) for p, v in lp.items()}
                         for l, lp in jnet.params.items()})
    return net


@pytest.fixture(scope="module")
def jnets():
    return {"a": JaxNet(jax_zoo.lenet(batch=4), seed=4),
            "b": JaxNet(jax_zoo.lenet(batch=4), seed=5)}


@pytest.fixture(scope="module")
def pnets(jnets):
    return {k: _port_net(n) for k, n in jnets.items()}


class GatedNet:
    """A net whose forward waits for `gate` after setting `entered`."""

    def __init__(self, inner):
        self._inner = inner
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.forwards = 0

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def forward(self, *a, **kw):
        self.forwards += 1
        self.entered.set()
        assert self.gate.wait(timeout=60), "the test never opened the gate"
        return self._inner.forward(*a, **kw)


def _wait(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} within {timeout} s"
        time.sleep(0.001)


def _routed(router, model, replica):
    return router.registry.counter(
        "sparknet_serve_routed_total",
        labels=("model", "replica")).value(model=model, replica=replica) \
        or 0.0


# -- the same router, both packages -------------------------------------------

def _two_lane_routers(jnets, pnets, outputs=("fc2",)):
    jr = JaxRouter(JaxRouterConfig(workers=2))
    pr = ModelRouter(RouterConfig(workers=2))
    for name in ("a", "b"):
        jr.add_model(name, jnets[name],
                     cfg=_cfg(JaxServeConfig, outputs=outputs))
        pr.add_model(name, pnets[name], cfg=_cfg(outputs=outputs))
    return {"jax": jr, "port": pr}


def test_two_lanes_answer_as_the_jax_router_does(jnets, pnets):
    """Two models over one shared pool: the same requests get the same
    fc2 from both packages' routers (the lanes' weights differ, and each
    answer is its own lane's), and the shared registry carries the same
    model-labeled families."""
    routers = _two_lane_routers(jnets, pnets)
    outs = {}
    for k, r in routers.items():
        with r:
            futs = [(name, r.submit(name, _example(i), deadline_s=30.0))
                    for i in range(6) for name in ("a", "b")]
            outs[k] = [(name, np.asarray(f.result(timeout=30)["fc2"]))
                       for name, f in futs]
            text = r.registry.render_prometheus()
            for name in ("a", "b"):
                for fam in (f'sparknet_serve_requests_total{{model="{name}",'
                            f'outcome="ok"}}',
                            f'sparknet_serve_routed_total{{model="{name}",'
                            f'replica="local:{name}"}} 6',
                            f'sparknet_serve_queue_depth{{model="{name}"}}'):
                    assert fam in text, (k, fam)
            assert "sparknet_serve_pool_workers 2" in text
    for (na, a), (nb, b) in zip(outs["port"], outs["jax"]):
        assert na == nb
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    a0, b0 = outs["port"][0][1], outs["port"][1][1]
    assert not np.allclose(a0, b0)  # each lane answered with its weights
    # and each is a forward of its own net (within 1e-5: the bucket its
    # batch formed in sets the CPU convolution's sum order)
    for i, name in ((0, "a"), (1, "b")):
        one = zeros_batch(pnets[name], 1)
        one["data"][0] = _example(0)["data"]
        direct = pnets[name].forward(one, ["fc2"])["fc2"][0]
        np.testing.assert_allclose(outs["port"][i][1], direct, rtol=1e-5,
                                   atol=1e-5)


def test_the_status_has_the_jax_router_s_keys(jnets, pnets):
    routers = _two_lane_routers(jnets, pnets, outputs=("prob",))
    st = {}
    for k, r in routers.items():
        with r:
            r.infer("a", _example(0))
            st[k] = r.status()
            assert r.healthy()
    # the port's status adds the lanes' device (PORT_ONLY_STATUS of
    # test_torch_serve_app.py); the rest is the JAX router's
    assert set(st["port"]) == set(st["jax"])
    assert st["port"]["router"] is True
    assert set(st["port"]["models"]) == {"a", "b"}
    assert set(st["port"]["models"]["a"]) == set(st["jax"]["models"]["a"])
    assert set(st["port"]["lanes"]["a"]) == \
        set(st["jax"]["lanes"]["a"]) | {"device"}
    assert st["port"]["replicas"] == st["jax"]["replicas"]
    assert st["port"]["hedging"] == st["jax"]["hedging"] == {}


def test_the_default_route_is_ambiguous_with_two_models(pnets):
    r = ModelRouter(RouterConfig(workers=1))
    r.add_model("a", pnets["a"], cfg=_cfg())
    r.add_model("b", pnets["b"], cfg=_cfg())
    with r:
        fe = HttpFrontend(r, port=0)
        try:
            url = f"http://{fe.address[0]}:{fe.address[1]}"
            out = http_infer(url, "b", _example(0), deadline_s=30.0)
            assert out["prob"].shape == (10,)
            conn = http.client.HTTPConnection(*fe.address, timeout=30)
            conn.request("POST", "/v1/infer", body=json.dumps(
                {"inputs": {"data": _example(0)["data"].tolist()}}
            ).encode(), headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
            assert resp.status == 404
            assert body["error_kind"] == "unknown_model"
            assert "ambiguous" in body["error"]
            conn = http.client.HTTPConnection(*fe.address, timeout=30)
            conn.request("GET", "/v1/models")
            rows = json.loads(conn.getresponse().read())["models"]
            conn.close()
            assert set(rows) == {"a", "b"}
        finally:
            fe.stop()


def test_a_lane_takes_a_jax_checkpoint_step(jnets, tmp_path):
    """A lane's initial weights come as a lone server's do: the newest
    verified step of its checkpoint_dir, here written by the JAX
    package's store. The lane then answers as the JAX router's lane over
    the same step."""
    flat = {f"params/{l}/{p}": np.asarray(v)[None] * 0.9
            for l, lp in jnets["b"].params.items() for p, v in lp.items()}
    jax_ckpt.save(str(tmp_path / "ck"), flat, step=3)
    jr = JaxRouter(JaxRouterConfig(workers=1))
    jr.add_model("m", JaxNet(jax_zoo.lenet(batch=4), seed=9),
                 cfg=_cfg(JaxServeConfig, checkpoint_dir=str(tmp_path / "ck")))
    pr = ModelRouter(RouterConfig(workers=1))
    pr.add_model("m", TorchNet(zoo.lenet(batch=4), seed=9, device="cpu"),
                 cfg=_cfg(checkpoint_dir=str(tmp_path / "ck")))
    got = {}
    for k, r in (("jax", jr), ("port", pr)):
        with r:
            assert r.lanes["m"].manager.step == 3
            fut = r.submit("m", _example(1), deadline_s=30.0)
            got[k] = np.asarray(fut.result(timeout=30)["prob"])
    np.testing.assert_allclose(got["port"], got["jax"], **TOL)
    assert fut._spkn_step == 3


# -- remote replicas, drain, failover -----------------------------------------

@pytest.mark.parametrize("transport", ["http", "binary"])
def test_a_drain_drops_nothing_and_moves_traffic_to_the_remote(pnets,
                                                               transport):
    """Model m: a local lane (held in a gated forward) and a remote
    replica (another router behind a frontend). Four requests queue on
    the local lane, then the lane drains: all four are answered once the
    gate opens, and every later request goes to the remote replica."""
    rb = ModelRouter(RouterConfig(workers=1))
    rb.add_model("m", pnets["b"], cfg=_cfg())
    gated = GatedNet(pnets["a"])
    ra = ModelRouter(RouterConfig(workers=1))
    ra.add_model("m", gated, cfg=_cfg(max_batch=1, buckets=(1,)))
    with rb:
        fe = (HttpFrontend if transport == "http" else BinaryFrontend)(
            rb, port=0)
        scheme = "http" if transport == "http" else "spkn"
        try:
            with ra:
                rep = ra.add_remote_replica(
                    "m", f"{scheme}://{fe.address[0]}:{fe.address[1]}")
                assert rep.transport == transport
                rep.drain()  # first: everything to the local lane
                held = [ra.submit("m", _example(i), deadline_s=60.0)
                        for i in range(4)]
                assert gated.entered.wait(timeout=30)
                _wait(lambda: ra.lanes["m"].batcher.depth() == 3,
                      "three requests queued behind the held forward")
                rep.undrain()
                ra.drain("m", "local:m")
                later = [ra.submit("m", _example(10 + i), deadline_s=60.0)
                         for i in range(6)]
                for f in later:  # served while the lane is still held
                    assert np.asarray(f.result(timeout=30)["prob"]).shape \
                        == (10,)
                assert not any(f.done() for f in held[1:])
                gated.gate.set()
                for f in held:
                    p = np.asarray(f.result(timeout=30)["prob"])
                    assert p.shape == (10,) and np.isfinite(p).all()
                assert _routed(ra, "m", "local:m") == 4
                assert _routed(ra, "m", rep.name) == 6
                assert fe.requests == 6
                drains = ra.registry.counter(
                    "sparknet_serve_replica_drains_total",
                    labels=("model", "replica"))
                assert drains.value(model="m", replica="local:m") == 1
        finally:
            gated.gate.set()
            fe.stop()


def _dead_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]  # nothing listens once it is closed


@pytest.mark.parametrize("transport", ["http", "binary"])
def test_a_refused_replica_fails_over_once(pnets, transport):
    """A remote replica whose port refuses connections: the request routed
    to it is served by the local lane (one failover, counted), the
    replica is demoted for conn_fail_cooldown_s and gets no more traffic;
    with only refusing replicas a request fails after ONE failover, typed,
    instead of looping."""
    scheme = "http" if transport == "http" else "spkn"
    r = ModelRouter(RouterConfig(workers=1, conn_fail_cooldown_s=600.0))
    r.add_model("m", pnets["a"], cfg=_cfg())
    with r:
        rep = r.add_remote_replica("m",
                                   f"{scheme}://127.0.0.1:{_dead_port()}")
        f1 = r.submit("m", _example(0), deadline_s=30.0)  # local
        f2 = r.submit("m", _example(1), deadline_s=30.0)  # the dead one
        for f in (f1, f2):
            assert np.asarray(f.result(timeout=30)["prob"]).shape == (10,)
        fo = r.registry.counter("sparknet_serve_replica_failovers_total",
                                labels=("model", "replica"))
        assert fo.value(model="m", replica=rep.name) == 1
        assert _routed(r, "m", rep.name) == 1
        assert _routed(r, "m", "local:m") == 2  # f1 and f2's failover
        assert rep.recently_failed(600.0) and not r._replica_routable(rep)
        for i in range(4):
            r.infer("m", _example(2 + i), timeout=30.0)
        assert _routed(r, "m", rep.name) == 1
    both_dead = ModelRouter(RouterConfig(workers=1))
    reps = [both_dead.add_remote_replica(
        "m", f"{scheme}://127.0.0.1:{_dead_port()}") for _ in range(2)]
    with both_dead:
        with pytest.raises(ConnectionError):
            both_dead.submit("m", _example(0)).result(timeout=30)
        fo = both_dead.registry.counter(
            "sparknet_serve_replica_failovers_total",
            labels=("model", "replica"))
        assert fo.value(model="m", replica=reps[0].name) == 1
        assert (fo.value(model="m", replica=reps[1].name) or 0) == 0
        assert all(rp.recently_failed(1.0) for rp in reps)


def test_the_remote_replica_matches_the_jax_router_over_binary(jnets,
                                                               pnets):
    """The port's router proxying to a JAX router's binary frontend, and
    the JAX router proxying to the port's: the same answers within TOL."""
    got = {}
    for k in ("port_to_jax", "jax_to_port"):
        if k == "port_to_jax":
            far = JaxRouter(JaxRouterConfig(workers=1))
            far.add_model("m", jnets["a"], cfg=_cfg(JaxServeConfig))
            from sparknet_tpu.serve.binary_frontend import \
                BinaryFrontend as JaxBinary
            fe_cls, near = JaxBinary, ModelRouter(RouterConfig(workers=1))
        else:
            far = ModelRouter(RouterConfig(workers=1))
            far.add_model("m", pnets["a"], cfg=_cfg())
            fe_cls, near = BinaryFrontend, JaxRouter(JaxRouterConfig(
                workers=1))
        with far:
            fe = fe_cls(far, port=0)
            try:
                near.add_remote_replica(
                    "m", f"spkn://{fe.address[0]}:{fe.address[1]}")
                with near:
                    got[k] = [np.asarray(near.infer(
                        "m", _example(i), timeout=30.0)["prob"])
                        for i in range(3)]
            finally:
                fe.stop()
    for a, b in zip(got["port_to_jax"], got["jax_to_port"]):
        np.testing.assert_allclose(a, b, **TOL)


def test_no_replica_is_a_typed_503_on_both_wires(pnets):
    r = ModelRouter(RouterConfig(workers=1))
    r.add_model("m", pnets["a"], cfg=_cfg())
    with r:
        hfe = HttpFrontend(r, port=0)
        bfe = BinaryFrontend(r, port=0)
        try:
            r.drain("m", "local:m")
            with pytest.raises(NoReplicaError):
                r.submit("m", _example(0))
            with pytest.raises(UnknownModelError):
                r.submit("nope", _example(0))
            conn = http.client.HTTPConnection(*hfe.address, timeout=30)
            conn.request("POST", "/v1/models/m/infer", body=json.dumps(
                {"inputs": {"data": _example(0)["data"].tolist()}}
            ).encode(), headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            conn.close()
            assert resp.status == 503
            assert resp.getheader("Retry-After") is not None
            assert data["error_kind"] == "no_replica"
            with pytest.raises(NoReplicaError):
                binary_infer(bfe.address, "m", _example(0), deadline_s=30.0)
        finally:
            hfe.stop()
            bfe.stop()


# -- hedging ------------------------------------------------------------------

def _replica(net, model="m", gated=False):
    n = GatedNet(net) if gated else net
    s = InferenceServer(n, _cfg(model_name=model)).start()
    return s, BinaryFrontend(s, port=0), n


@pytest.fixture()
def two_replicas(pnets):
    made = [_replica(pnets["a"]), _replica(pnets["a"])]
    yield [fe for _, fe, _ in made]
    for s, fe, _ in made:
        fe.stop()
        s.stop()


def _router_over(fes, **cfg_kw):
    router = ModelRouter(RouterConfig(workers=4, **cfg_kw))
    for fe in fes:
        router.add_remote_replica("m", f"spkn://127.0.0.1:{fe.address[1]}")
    return router.start()


def _hedged(router):
    c = router.registry.counter("sparknet_serve_hedged_total",
                                labels=("model", "won"))
    return {w: c.value(model="m", won=w) or 0.0
            for w in ("primary", "hedge")}


def test_hedge_exactly_once_under_max_pressure_to_hedge(two_replicas):
    """A zero delay fires the hedge decision at once on every request:
    most requests grow a second leg, yet every submit resolves exactly one
    result, and the hedged counter agrees with the status rollup."""
    router = _router_over(two_replicas, hedge=True,
                          hedge_min_delay_ms=0.0, hedge_budget=1.0)
    try:
        futs = [router.submit("m", _example(i), deadline_s=30.0)
                for i in range(24)]
        outs = [f.result(timeout=30.0) for f in futs]
        assert len(outs) == 24
        for out in outs:
            p = np.asarray(out["prob"])
            assert p.shape == (10,) and np.isfinite(p).all()
        hg = router.status()["hedging"]["m"]
        assert hg["routed"] == 24
        assert 0 < hg["hedged"] <= hg["routed"]
        assert sum(_hedged(router).values()) == hg["hedged"]
    finally:
        router.stop()


@pytest.mark.parametrize("budget", [0.0, 0.2, 0.5])
def test_hedge_budget_caps_second_legs(two_replicas, budget):
    router = _router_over(two_replicas, hedge=True,
                          hedge_min_delay_ms=0.0, hedge_budget=budget)
    try:
        futs = [router.submit("m", _example(i), deadline_s=30.0)
                for i in range(40)]
        for f in futs:
            f.result(timeout=30.0)
        hg = router.status()["hedging"]["m"]
        assert hg["routed"] == 40
        assert hg["hedged"] <= budget * hg["routed"]
    finally:
        router.stop()


def test_hedge_under_drain_primary_stands_alone(two_replicas):
    router = _router_over(two_replicas, hedge=True,
                          hedge_min_delay_ms=0.0, hedge_budget=1.0)
    try:
        router.replicas["m"][1].drain()
        futs = [router.submit("m", _example(i), deadline_s=30.0)
                for i in range(10)]
        outs = [f.result(timeout=30.0) for f in futs]
        assert all(np.asarray(o["prob"]).shape == (10,) for o in outs)
        hg = router.status()["hedging"]["m"]
        assert hg["routed"] == 10 and hg["hedged"] == 0
    finally:
        router.stop()


def test_hedge_disabled_under_admission_pressure(two_replicas):
    router = _router_over(two_replicas, hedge=True,
                          hedge_min_delay_ms=0.0, hedge_budget=1.0)
    door = PriorityAdmission(rate_rps=1000.0)
    router.attach_admission(door)
    try:
        door.set_pressure(0.7)  # the admission door's overload signal
        futs = [router.submit("m", _example(i), deadline_s=30.0)
                for i in range(10)]
        for f in futs:
            f.result(timeout=30.0)
        hg = router.status()["hedging"]["m"]
        assert hg["routed"] == 10 and hg["hedged"] == 0
    finally:
        router.stop()


def test_a_hedge_wins_against_a_held_primary(pnets):
    """Two binary replicas, both holding their forwards on gates, a zero
    hedge delay. Request f: its primary enters replica 0's forward, its
    hedge replica 1's. Request g: its primary waits in replica 0's queue,
    its hedge in replica 1's. Replica 1's gate opens: both requests are
    answered by their hedge legs, exactly once each; g's primary, still
    queued, is cancelled and the cancel confirmed; f's primary (already
    formed) completes unobserved once replica 0's gate opens."""
    made = [_replica(pnets["a"], gated=True) for _ in range(2)]
    (s0, fe0, slow), (s1, fe1, fast) = made
    router = ModelRouter(RouterConfig(workers=4, hedge=True,
                                      hedge_min_delay_ms=0.0,
                                      hedge_budget=1.0))
    for fe in (fe0, fe1):
        router.add_remote_replica("m", f"spkn://127.0.0.1:{fe.address[1]}")
    router.start()
    try:
        f = router.submit("m", _example(0), deadline_s=60.0)
        assert slow.entered.wait(timeout=30)
        assert fast.entered.wait(timeout=30)
        g = router.submit("m", _example(1), deadline_s=60.0)
        _wait(lambda: s0.batcher.depth() == 1 and s1.batcher.depth() == 1,
              "g's two legs queued")
        fast.gate.set()
        for fut in (f, g):
            assert np.asarray(fut.result(timeout=30)["prob"]).shape == (10,)
        cancelled = router.registry.counter(
            "sparknet_serve_hedge_cancelled_total", labels=("model",))
        _wait(lambda: (cancelled.value(model="m") or 0) == 1,
              "g's primary's confirmed cancel")
        assert _hedged(router) == {"primary": 0.0, "hedge": 2.0}
        hg = router.status()["hedging"]["m"]
        assert hg == {"routed": 2, "hedged": 2}
        slow.gate.set()
        _wait(lambda: s0.requests_ok == 1, "f's primary completed")
        assert s0.batcher.depth() == 0 and slow.forwards == 1
    finally:
        slow.gate.set()
        fast.gate.set()
        router.stop()
        for s, fe, _ in made:
            fe.stop()
            s.stop()


def test_the_jax_router_hedges_the_same_requests_exactly_once(jnets,
                                                             pnets):
    """Both packages' routers over two binary replicas of their own
    package, zero hedge delay, budget 1: every request answered exactly
    once, the same answers within TOL."""
    from sparknet_tpu.serve.binary_frontend import \
        BinaryFrontend as JaxBinary
    from sparknet_tpu.serve.server import InferenceServer as JaxServer
    got = {}
    for k in ("jax", "port"):
        if k == "jax":
            servers = [JaxServer(jnets["a"], _cfg(JaxServeConfig,
                                                  model_name="m")).start()
                       for _ in range(2)]
            fes = [JaxBinary(s, port=0) for s in servers]
            router = JaxRouter(JaxRouterConfig(
                workers=4, hedge=True, hedge_min_delay_ms=0.0,
                hedge_budget=1.0))
        else:
            servers = [InferenceServer(pnets["a"], _cfg(
                model_name="m")).start() for _ in range(2)]
            fes = [BinaryFrontend(s, port=0) for s in servers]
            router = ModelRouter(RouterConfig(
                workers=4, hedge=True, hedge_min_delay_ms=0.0,
                hedge_budget=1.0))
        for fe in fes:
            router.add_remote_replica("m",
                                      f"spkn://127.0.0.1:{fe.address[1]}")
        try:
            with router:
                futs = [router.submit("m", _example(i), deadline_s=30.0)
                        for i in range(12)]
                got[k] = [np.asarray(f.result(timeout=30)["prob"])
                          for f in futs]
                assert router.status()["hedging"]["m"]["routed"] == 12
        finally:
            for fe, s in zip(fes, servers):
                fe.stop()
                s.stop()
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("position", [0, 1, 2])
def test_a_cancel_reaches_any_queued_request(position):
    """The hedge loser's cancel: the port's batcher finds the request by
    identity wherever it waits in the queue. The JAX batcher's
    `deque.remove` compares requests field by field, and numpy refuses
    the truth value of their payloads: its cancel of any request behind
    the head raises ValueError (which its adapter swallows as "already
    formed"; ROADMAP C)."""
    from sparknet_tpu.serve.batcher import DynamicBatcher as JaxBatcher
    from sparknet_tpu_torch.serve.batcher import (DynamicBatcher,
                                                  RequestCancelledError)
    got = {}
    for k, cls in (("port", DynamicBatcher), ("jax", JaxBatcher)):
        b = cls(max_batch=8, max_wait_s=60.0)
        futs = [b.submit(_example(i)) for i in range(3)]
        try:
            got[k] = b.cancel(futs[position])
        except ValueError as e:
            got[k] = e
        if got[k] is True:
            exc = futs[position].exception(timeout=1)
            assert type(exc).__name__ == RequestCancelledError.__name__
            assert b.depth() == 2
            assert not any(f.done() for i, f in enumerate(futs)
                           if i != position)
    assert got["port"] is True
    if position == 0:
        assert got["jax"] is True
    else:
        assert isinstance(got["jax"], ValueError)


# -- coalesced formation ------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _stub_reps(n: int, fill):
    return [Replica(f"r{i}", url=f"spkn://h{i}:1", transport="binary",
                    health_fn=lambda: True, fill_fn=fill)
            for i in range(n)]


def _coalescer(window_ms=10.0):
    router = ModelRouter(RouterConfig(
        workers=1, coalesce=True, coalesce_window_ms=window_ms,
        coalesce_fill_threshold=0.5))
    router.clock = Clock()
    return router


def test_coalesce_one_focus_per_window_rotating_fairly():
    router = _coalescer()
    reps = _stub_reps(3, lambda: 0.1)
    focus_seq = []
    for _ in range(6):
        picks = {router._coalesce_pick("m", reps).name for _ in range(5)}
        router.clock.t += 0.004  # still inside the 10 ms window
        picks.add(router._coalesce_pick("m", reps).name)
        assert len(picks) == 1, picks  # ONE focus inside a window
        focus_seq.append(picks.pop())
        router.clock.t += 0.007  # past the window
    assert focus_seq == ["r0", "r1", "r2", "r0", "r1", "r2"]


def test_coalesce_inactive_on_high_fill_or_no_signal():
    router = _coalescer()
    assert router._coalesce_pick("m", _stub_reps(3, lambda: 0.9)) is None
    assert router._coalesce_pick("m2", _stub_reps(3, None)) is None
    # one replica at 0.9 vetoes: every reporting replica must be under
    assert router._coalesce_pick("m3", [
        *_stub_reps(2, lambda: 0.1), *_stub_reps(1, lambda: 0.9)]) is None


def test_coalesce_skips_unroutable_focus():
    router = _coalescer(window_ms=5.0)
    reps = _stub_reps(3, lambda: 0.1)
    reps[1].drain()
    leads = []
    for _ in range(6):
        rep = router._coalesce_pick("m", reps)
        assert rep is not None and rep.name != "r1"
        leads.append(rep.name)
        router.clock.t += 0.007
    assert leads == ["r0", "r2"] * 3


def test_coalesced_picks_route_consecutive_requests_to_one_lane(pnets):
    """Through submit, under an injected clock: a router over a local lane
    and a remote replica, both reporting low fill, sends every request of
    a window to ONE replica (counted as coalesced), and the next window's
    requests to the other."""
    rb = ModelRouter(RouterConfig(workers=1))
    rb.add_model("m", pnets["a"], cfg=_cfg())
    with rb:
        fe = BinaryFrontend(rb, port=0)
        try:
            r = ModelRouter(RouterConfig(workers=1, coalesce=True,
                                         coalesce_window_ms=10.0))
            r.clock = Clock()
            r.add_model("m", pnets["a"], cfg=_cfg())
            with r:
                rep = r.add_remote_replica(
                    "m", f"spkn://127.0.0.1:{fe.address[1]}")
                rep.fill_fn = lambda: 0.1
                r.lanes["m"].fill_signal = lambda: 0.1
                for window in range(2):
                    r.clock.t += 0.02
                    futs = [r.submit("m", _example(i), deadline_s=30.0)
                            for i in range(8)]
                    for f in futs:
                        f.result(timeout=30)
                co = r.registry.counter("sparknet_serve_coalesced_total",
                                        labels=("model",))
                assert co.value(model="m") == 16
                assert _routed(r, "m", "local:m") == 8
                assert _routed(r, "m", rep.name) == 8
        finally:
            fe.stop()


# -- health probes, pool, lifecycle -------------------------------------------

def test_heartbeat_probes_read_the_replica_s_beat(tmp_path):
    path = str(tmp_path / "hb.json")
    health = heartbeat_health(path, stale_after_s=60.0, min_refresh_s=0.0)
    fill = heartbeat_fill(path, "m", min_refresh_s=0.0)
    assert health() is False and fill() is None  # no beat yet
    hb = HeartbeatWriter(path, role="serve", interval_s=0.0)
    hb.beat(3, status="ok", force=True,
            models={"m": {"recent_occupancy": 0.25, "batch_fill": 0.9}})
    assert health() is True and fill() == 0.25
    hb.beat(3, status="ok", force=True,
            models={"m": {"batch_fill": 0.75}})
    assert fill() == 0.75  # an older replica beats only batch_fill
    hb.beat(3, status="done", force=True)
    assert health() is False


def test_set_pool_size_resizes_live(pnets):
    r = ModelRouter(RouterConfig(workers=1))
    r.add_model("m", pnets["a"], cfg=_cfg())
    with r:
        assert r.pool_size() == 1
        assert r.set_pool_size(3) == 3
        _wait(lambda: r.pool_size() == 3, "three pool threads")
        r.set_pool_size(1)
        _wait(lambda: r.pool_size() == 1, "the pool shrunk to one")
        assert r.infer("m", _example(0))["prob"].shape == (10,)


def test_busy_router_still_runs_idle_lane_duties(pnets, tmp_path):
    """One pool worker kept busy by lane a: lane b's hot-reload poll
    still lands a new step, and the router's heartbeat keeps beating."""
    from sparknet_tpu_torch.model.net import params_to_jax
    from sparknet_tpu_torch.utils.heartbeat import read_heartbeat
    net_b = TorchNet(zoo.lenet(batch=4), seed=6, device="cpu")
    flat = {"params": params_to_jax(net_b.net, net_b.params)}
    ckdir = str(tmp_path / "ck")
    ckpt.save(ckdir, flat, step=1)
    hb_path = str(tmp_path / "hb.json")
    r = ModelRouter(RouterConfig(workers=1, heartbeat_path=hb_path,
                                 heartbeat_every_s=0.05))
    r.add_model("a", pnets["a"], cfg=_cfg(max_wait_ms=1.0))
    r.add_model("b", net_b, cfg=_cfg(max_wait_ms=1.0, checkpoint_dir=ckdir,
                                     poll_interval_s=0.05))
    with r:
        assert r.lanes["b"].manager.step == 1
        stop = threading.Event()

        def hammer():
            i = 0
            while not stop.is_set():
                r.infer("a", _example(i), timeout=30.0)
                i += 1

        t = threading.Thread(target=hammer, daemon=True)
        t.start()
        try:
            _wait(lambda: r.lanes["a"].requests_ok >= 5, "lane a busy")
            ckpt.save(ckdir, flat, step=2)
            _wait(lambda: r.lanes["b"].manager.step == 2,
                  "lane b's hot reload under traffic to lane a")
            assert r.healthy()
        finally:
            stop.set()
            t.join(timeout=30)
        assert not t.is_alive()
        hb = read_heartbeat(hb_path)
        assert hb is not None and hb["age_s"] < 5.0
        assert set(hb["models"]) == {"a", "b"}


def test_refusals_name_their_gap(pnets):
    r = ModelRouter(RouterConfig())
    # the raw-pixel door passes through to the lane (no longer refused)
    door = object()
    lane = r.add_model("p", pnets["a"], cfg=_cfg(), preprocessor=door)
    assert lane.preprocessor is door and r.lanes["p"] is lane
    r.add_model("m", pnets["a"], cfg=_cfg())
    assert r.lanes["m"].preprocessor is None
    with pytest.raises(ValueError, match="already added"):
        r.add_model("m", pnets["a"], cfg=_cfg())
    with pytest.raises(ValueError, match="exactly one"):
        Replica("x")
    assert r._fleet_status() == {"enabled": False}


def test_the_adapter_takes_a_server_or_a_router(pnets):
    r = ModelRouter(RouterConfig())
    r.add_model("m", pnets["a"], cfg=_cfg())
    assert BackendAdapter(r).is_router
    s = InferenceServer(pnets["a"], _cfg())
    assert not BackendAdapter(s).is_router
    for other in (object(), JaxRouter(JaxRouterConfig())):
        with pytest.raises(TypeError, match="InferenceServer or a "
                                            "ModelRouter"):
            BackendAdapter(other)


def test_the_router_serves_the_jax_http_frontend_s_replies(jnets, pnets):
    """The JAX HTTP frontend over a JAX router and the port's over a port
    router: the same request answers with the same keys and prob."""
    replies = {}
    for k, router, fe_cls in (
            ("jax", JaxRouter(JaxRouterConfig(workers=1)), JaxHttp),
            ("port", ModelRouter(RouterConfig(workers=1)), HttpFrontend)):
        router.add_model("m", jnets["a"] if k == "jax" else pnets["a"],
                         cfg=_cfg(JaxServeConfig if k == "jax"
                                  else ServeConfig))
        with router:
            fe = fe_cls(router, port=0)
            try:
                conn = http.client.HTTPConnection(*fe.address, timeout=30)
                conn.request("POST", "/v1/models/m/infer", body=json.dumps(
                    {"inputs": {"data": _example(3)["data"].tolist()}}
                ).encode(), headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                replies[k] = (resp.status, json.loads(resp.read()))
                conn.close()
            finally:
                fe.stop()
    assert replies["port"][0] == replies["jax"][0] == 200
    assert set(replies["port"][1]) == set(replies["jax"][1])
    np.testing.assert_allclose(replies["port"][1]["outputs"]["prob"],
                               replies["jax"][1]["outputs"]["prob"], **TOL)


def test_serve_cli_router_demo(tmp_path, capsys):
    app.main(["--models", "a=lenet,b=lenet", "--router-workers", "2",
              "--device", "cpu", "--outputs", "prob", "--max-batch", "4",
              "--hedge", "--hedge-budget", "0.5", "--coalesce",
              "--http-port", "0", "--binary-port", "0", "--demo", "8",
              "--workdir", str(tmp_path)])
    captured = capsys.readouterr()
    status = json.loads(captured.out.strip().splitlines()[-1])
    assert status["router"] is True
    assert set(status["models"]) == {"a", "b"}
    lanes = status["lanes"]
    assert sum(lane["requests_ok"] for lane in lanes.values()) == 8
    assert all(lane["requests_failed"] == 0 for lane in lanes.values())
    assert "HTTP data plane at" in captured.err
    assert "binary data plane at spkn://" in captured.err


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_the_routed_caffenet_lane_launches_lrn_fwd_on_the_card():
    """Full-width CaffeNet as a router lane on the card beside lenet:
    every CaffeNet forward launches lrn_fwd twice (norm1, norm2), float32,
    and its answers equal a direct forward at the same bucket."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sparknet_tpu_torch import precision
    from sparknet_tpu_torch.ops.cuda_lrn import lrn_fwd
    precision.set_policy("float32")
    net = TorchNet(zoo.caffenet(batch=8, crop=227, n_classes=1000), seed=0,
                   device="cuda")
    r = ModelRouter(RouterConfig(workers=2, coalesce=True))
    r.add_model("caffenet", net, cfg=_cfg(max_batch=8, buckets=(1, 8)))
    r.add_model("lenet", TorchNet(zoo.lenet(batch=4), device="cuda"),
                cfg=_cfg())
    rng = np.random.default_rng(0)
    xs = [{"data": (50 * rng.standard_normal((227, 227, 3))
                    ).astype(np.float32)} for _ in range(12)]
    lrn_fwd.launches = lrn_fwd.bf16_launches = 0
    with r:
        futs = [r.submit("caffenet", x, deadline_s=120.0) for x in xs]
        lenet = [r.submit("lenet", _example(i), deadline_s=120.0)
                 for i in range(4)]
        outs = [np.asarray(f.result(timeout=300)["prob"]) for f in futs]
        for f in lenet:
            f.result(timeout=300)
        forwards = len(r.lanes["caffenet"].batch_log)
        launches, bf16 = lrn_fwd.launches, lrn_fwd.bf16_launches
    assert launches == 2 * forwards and bf16 == 0
    for p in outs:
        assert p.shape == (1000,) and np.isfinite(p).all()
        assert abs(float(p.sum()) - 1.0) < 1e-4
    one = zeros_batch(net, 1)
    one["data"][0] = xs[0]["data"]
    r2 = ModelRouter(RouterConfig(workers=1))
    r2.add_model("caffenet", net, cfg=_cfg(max_batch=8, buckets=(1, 8)))
    with r2:
        served = np.asarray(r2.infer("caffenet", xs[0])["prob"])
    direct = net.forward(one, ["prob"])["prob"][0]
    np.testing.assert_allclose(served, direct, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("spec,want", [
    ("a=lenet", [("a", "lenet")]),
    ("a=lenet, b = caffenet", [("a", "lenet"), ("b", "caffenet")]),
    ("m=nets/deploy.prototxt", [("m", "nets/deploy.prototxt")]),
    ("lenet", SystemExit), ("=lenet", SystemExit), ("a=", SystemExit),
    ("a=lenet,,b=lenet", SystemExit)])
def test_parse_models_arg_is_the_jax_cli_s(spec, want):
    from sparknet_tpu.serve.app import parse_models_arg as jax_parse
    if want is SystemExit:
        for fn in (app.parse_models_arg, jax_parse):
            with pytest.raises(SystemExit, match="name=model_source"):
                fn(spec)
    else:
        assert app.parse_models_arg(spec) == jax_parse(spec) == want


def test_a_zoo_caffenet_is_served_at_its_published_width():
    """The main path's command names no --n-classes: CaffeNet serves its
    1000 classes unless told otherwise."""
    def fc8(spec):
        return [l.inner_product.num_output for l in spec.layers
                if l.name == "fc8"]
    assert fc8(app.resolve_spec("caffenet", 8, None, 67)) == [1000]
    assert fc8(app.resolve_spec("caffenet", 8, 16, 67)) == [16]
