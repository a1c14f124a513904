"""The port's fleet control plane (fleet/) against the JAX package's.

- `utils/metrics`: `LatencyStats.quantile`, `.windowed` (under an
  injected clock) and `FillMeter.recent_ratio` equal the JAX package's on
  seeded sequences.
- `FleetPolicy` and `slo_burn`: the same decisions (`burn`,
  `pressure_from_burn`, `hot_reason`, `is_cold`, `online_queue_frac`,
  `batch_relief`) as the JAX package's over a seeded grid of 600
  `ModelSignals` under three policies; the same construction errors for
  `FleetPolicy` and `FleetConfig`.
- `FleetController`, one scripted trace for both packages: a LeNet lane
  on each package's router, an in-process provider (a fresh server behind
  a binary frontend per grow, as `tests/test_fleet.py`'s), each
  controller's `_signals` wrapped to the same scripted load, the same
  scripted pages and batch starvation, a kill at the same tick, and the
  controller modules' clock injected. Per tick the `fleet_scale` events
  (direction, reason, replica count and the other audit fields), the
  pressure, the pool target, the replica count and `status()` must be the
  JAX controller's; `/fleet/status` over HTTP answers with its keys.
- Live behaviour of the port's controller: a shrink drains with zero
  dropped (a request held in the grown replica's gated forward completes
  after the drain), a dead replica is replaced and named, `min_replicas`
  holds, a page lifts the pressure to `page_pressure` and batch-
  starvation relief still clamps it.
- Providers: `PodReplicaProvider`'s command sequence equals the JAX
  stub's but for the serve module; `SubprocessReplicaProvider` grows a
  LeNet child (`--device cpu`), the router routes to it over spkn://, and
  it retires within the stated timeouts.
- The serve CLI: `--autoscale` with `--fleet-provider none` and
  `--history` serves its demo; `--autoscale` needs `--models`.
- The training loop's `history` lever writes shards whose families are
  the JAX loop's, and serves `/timeseries` while it runs.
Every controller here is driven through `tick()`; waits are on events and
bounded.
"""
import json
import os
import threading
import time
import types
import urllib.request
from dataclasses import replace

import numpy as np
import pytest
import torch

from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from sparknet_tpu.fleet import controller as jctl
from sparknet_tpu.fleet import policy as jpol
from sparknet_tpu.fleet import provider as jprov
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.obs.history import read_history_shards as jax_read_shards
from sparknet_tpu.serve.binary_frontend import BinaryFrontend as JaxBinary
from sparknet_tpu.serve.router import ModelRouter as JaxRouter
from sparknet_tpu.serve.router import RouterConfig as JaxRouterConfig
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig
from sparknet_tpu.utils import metrics as jmetrics
from sparknet_tpu.utils.config import RunConfig as JaxRunConfig
from sparknet_tpu.utils.logger import Logger as JaxLogger
from sparknet_tpu.zoo import lenet as jax_lenet

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps.train_loop import train
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.fleet import controller as pctl
from sparknet_tpu_torch.fleet import policy as ppol
from sparknet_tpu_torch.fleet import provider as pprov
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.obs.history import read_history_shards
from sparknet_tpu_torch.serve import app
from sparknet_tpu_torch.serve.binary_frontend import BinaryFrontend
from sparknet_tpu_torch.serve.router import ModelRouter, RouterConfig
from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig
from sparknet_tpu_torch.utils import metrics as pmetrics
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.logger import Logger

torch.set_num_threads(2)
SLO_MS = 50.0


def _example(i: int) -> dict:
    r = np.random.default_rng(7000 + i)
    return {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}


class Clock:
    """The injected clock: `time.monotonic()` / `time.time()` of the
    module it is patched into."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def ns(self):
        return types.SimpleNamespace(monotonic=lambda: self.t,
                                     time=lambda: 1.7e9 + self.t,
                                     perf_counter=lambda: self.t)


# -- utils/metrics ------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_latency_quantile_and_window_equal_the_jax_package(seed,
                                                           monkeypatch):
    clock = Clock()
    monkeypatch.setattr(jmetrics, "time", clock.ns())
    monkeypatch.setattr(pmetrics, "time", clock.ns())
    rng = np.random.default_rng(seed)
    stats = [mod.LatencyStats(window=256, max_age_s=60.0)
             for mod in (jmetrics, pmetrics)]
    for x, dt in zip(rng.lognormal(-4, 1, 600), rng.exponential(0.3, 600)):
        clock.t += float(dt)
        for s in stats:
            s.add(float(x))
        if rng.uniform() < 0.05:
            for q in (0.0, 0.5, 0.95, 0.99, 1.0):
                assert stats[1].quantile(q) == stats[0].quantile(q)
            for w in (0.5, 5.0, 30.0, 120.0):
                assert stats[1].windowed(w) == stats[0].windowed(w)
                assert stats[1].windowed_quantile(0.95, w) == \
                    stats[0].windowed_quantile(0.95, w)
    clock.t += 1000.0
    assert stats[1].windowed(30.0) == stats[0].windowed(30.0) == \
        {"n": 0, "p50_ms": None, "p99_ms": None}
    stats[1].reset()
    assert stats[1].quantile(0.5) is None


@pytest.mark.parametrize("seed", range(3))
def test_recent_fill_ratio_equals_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    meters = [jmetrics.FillMeter(), pmetrics.FillMeter()]
    assert meters[1].recent_ratio() is meters[0].recent_ratio() is None
    for _ in range(200):
        bucket = int(rng.choice([1, 2, 4, 8, 16]))
        real = int(rng.integers(1, bucket + 1))
        for m in meters:
            m.add(real, bucket)
        for n in (1, 4, 16, 64, 100):
            assert meters[1].recent_ratio(n) == meters[0].recent_ratio(n)
        assert meters[1].recent_occupancy(16) == \
            meters[0].recent_occupancy(16)


# -- policy -------------------------------------------------------------------

POLICIES = [dict(), dict(burn_up=1.2, burn_down=0.5, queue_high=0.6,
                         queue_low=0.2, shed_high_per_s=3.0, min_window_n=4,
                         pressure_start=0.8, pressure_full=1.6),
            dict(burn_up=2.0, burn_down=1.0, min_window_n=32,
                 batch_max_starvation_s=10.0, batch_relief_pressure=0.3)]


def _signal_grid(mod, seed, n=200):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        slo = [None, 0.0, 25.0, 50.0, 100.0][int(rng.integers(0, 5))]
        p99 = None if rng.uniform() < 0.15 else \
            float(np.round(rng.lognormal(3.5, 0.8), 3))
        q = float(np.round(rng.uniform(0, 1), 3))
        out.append(mod.ModelSignals(
            model=f"m{i % 3}", p99_ms=p99, slo_p99_ms=slo,
            n_window=int(rng.integers(0, 64)), queue_frac=q,
            shed_per_s=float(np.round(rng.exponential(1.0), 3)),
            replicas=int(rng.integers(1, 5)),
            routable=int(rng.integers(0, 5)),
            low_queue_frac=float(np.round(rng.uniform(0, q), 3)),
            batch_starvation_s=float(np.round(rng.exponential(40), 2))))
    return out


@pytest.mark.parametrize("policy", range(len(POLICIES)))
@pytest.mark.parametrize("seed", range(3))
def test_policy_decisions_equal_the_jax_package(policy, seed):
    jp = jpol.FleetPolicy(**POLICIES[policy])
    pp = ppol.FleetPolicy(**POLICIES[policy])
    rng = np.random.default_rng(50 + seed)
    for js, ps in zip(_signal_grid(jpol, seed), _signal_grid(ppol, seed)):
        burn = pp.burn(ps)
        assert burn == jp.burn(js)
        assert ppol.slo_burn(ps.p99_ms, ps.slo_p99_ms) == \
            jpol.slo_burn(js.p99_ms, js.slo_p99_ms)
        assert pp.pressure_from_burn(burn) == jp.pressure_from_burn(burn)
        assert pp.hot_reason(ps) == jp.hot_reason(js)
        assert pp.is_cold(ps) == jp.is_cold(js)
        assert pp.online_queue_frac(ps) == jp.online_queue_frac(js)
        pressure = float(rng.uniform(0, 1))
        assert pp.batch_relief(ps.batch_starvation_s, pressure) == \
            jp.batch_relief(js.batch_starvation_s, pressure)


BAD_POLICIES = [dict(burn_up=0.0), dict(burn_down=1.0, burn_up=1.0),
                dict(queue_low=0.6, queue_high=0.5), dict(up_ticks=0),
                dict(pressure_full=1.0, pressure_start=1.0),
                dict(rollout_wave_size=0), dict(rollout_timeout_s=0.0),
                dict(batch_max_starvation_s=0.0),
                dict(batch_relief_pressure=1.0)]
BAD_CONFIGS = [dict(interval_s=0.0), dict(min_replicas=0),
               dict(min_replicas=3, max_replicas=2), dict(pool_min=0),
               dict(pool_min=3, pool_max=2), dict(dead_ticks=0),
               dict(page_pressure=1.5)]


@pytest.mark.parametrize("kind,kw", [("policy", k) for k in BAD_POLICIES]
                         + [("config", k) for k in BAD_CONFIGS])
def test_construction_refuses_as_the_jax_package(kind, kw):
    jcls = jpol.FleetPolicy if kind == "policy" else jctl.FleetConfig
    pcls = ppol.FleetPolicy if kind == "policy" else pctl.FleetConfig
    with pytest.raises(ValueError) as je:
        jcls(**kw)
    with pytest.raises(ValueError) as pe:
        pcls(**kw)
    assert str(pe.value) == str(je.value)


def test_a_config_dict_policy_is_coerced():
    cfg = pctl.FleetConfig(policy={"up_ticks": 3})
    assert isinstance(cfg.policy, ppol.FleetPolicy) and \
        cfg.policy.up_ticks == 3


# -- the controller -----------------------------------------------------------


class InProcessProvider:
    """Grow = a fresh server + binary frontend in THIS process, of the
    given package (the subprocess provider's job without the spawn).
    `gated` grown servers hold each forward until `gate` is set."""

    def __init__(self, pkg: str, gated: bool = False):
        self.pkg = pkg
        self.spawned = []
        self.retired = []
        self._dead = set()
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.gated = gated
        self.forwards = 0

    def _net(self):
        if self.pkg == "jax":
            return JaxNet(jax_lenet(batch=4))
        net = TorchNet(zoo.lenet(batch=4), device="cpu")
        if self.gated:
            inner = net.forward

            def forward(*a, **kw):
                self.forwards += 1
                self.entered.set()
                assert self.gate.wait(timeout=60), "gate never opened"
                return inner(*a, **kw)
            net.forward = forward
        return net

    def grow(self, model):
        if self.pkg == "jax":
            srv = JaxServer(self._net(), JaxServeConfig(**_lane_kw(model)))
            srv.start()
            fe = JaxBinary(srv, port=0)
            handle = jprov.ReplicaHandle
        else:
            srv = InferenceServer(self._net(), ServeConfig(**_lane_kw(model)))
            srv.start()
            fe = BinaryFrontend(srv, port=0)
            handle = pprov.ReplicaHandle
        h = handle(model, f"spkn://{fe.address[0]}:{fe.address[1]}",
                   meta={"i": len(self.spawned)})
        self.spawned.append((srv, fe, h))
        return h

    def kill(self, handle):
        self._dead.add(handle.meta["i"])
        self.spawned[handle.meta["i"]][1].stop()

    def retire(self, handle):
        self.retired.append(handle.meta["i"])

    def alive(self, handle):
        return handle.meta["i"] not in self._dead

    def stop(self):
        self.gate.set()
        for srv, fe, h in self.spawned:
            if h.meta["i"] not in self._dead:
                fe.stop()
            srv.stop()


def _lane_kw(name="m"):
    return dict(model_name=name, max_batch=4, max_wait_ms=2.0,
                outputs=("prob",), slo_p99_ms=SLO_MS,
                metrics_every_batches=0)


class Door:
    """The admission door the controller pushes pressure into, with a
    scripted batch-starvation clock."""

    def __init__(self):
        self.pressure = 0.0
        self.starv = 0.0

    def set_pressure(self, p):
        self.pressure = p

    def starvation_s(self):
        return self.starv

    def status(self):
        return {"pressure": self.pressure}


class Pager:
    def __init__(self):
        self.pages = []

    def firing_pages(self):
        return list(self.pages)


def _router(pkg, status_port=None, stale_after_s=0.6):
    if pkg == "jax":
        r = JaxRouter(JaxRouterConfig(workers=1, stale_after_s=0.6,
                                      health_refresh_s=0.02,
                                      conn_fail_cooldown_s=0.2,
                                      status_port=status_port))
        r.add_model("m", JaxNet(jax_lenet(batch=4)),
                    cfg=JaxServeConfig(**_lane_kw()))
    else:
        r = ModelRouter(RouterConfig(workers=1, stale_after_s=stale_after_s,
                                     health_refresh_s=0.02,
                                     conn_fail_cooldown_s=0.2,
                                     status_port=status_port))
        r.add_model("m", TorchNet(zoo.lenet(batch=4), device="cpu"),
                    cfg=ServeConfig(**_lane_kw()))
    return r


def _fleet_cfg(mod, polmod, **over):
    kw = dict(interval_s=0.05, window_s=30.0, min_replicas=1,
              max_replicas=3, up_cooldown_s=2.0, down_cooldown_s=3.0,
              drain_grace_s=2.0, dead_ticks=2, pool_min=1, pool_max=3,
              policy=polmod.FleetPolicy(up_ticks=2, down_ticks=3,
                                        min_window_n=8))
    kw.update(over)
    return mod.FleetConfig(**kw)


def _trace(seed: int):
    """Per-tick scripted load: quiet, a burn, a kill mid-burn, a queue
    spike (the pool lever), pages, a starved scavenger class, quiet."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(36):
        burning = 3 <= i < 12
        rows.append(dict(
            p99=float(SLO_MS * rng.uniform(1.3, 3.0)) if burning else
            (float(SLO_MS * rng.uniform(0.1, 0.5)) if i % 4 else None),
            n=int(rng.integers(16, 64)) if burning else
            int(rng.integers(0, 12)),
            q=float(rng.uniform(0.6, 0.95)) if 16 <= i < 21 else
            float(rng.uniform(0.0, 0.05)),
            shed=float(rng.uniform(1.5, 4.0)) if i == 9 else 0.0,
            pages=["m"] if 11 <= i < 15 else [],
            starv=75.0 if 10 <= i < 12 else 0.0,
            kill=(i == 8)))
    return rows


def _clean_event(ev):
    return {k: v for k, v in ev.items() if k not in ("t", "replica")}


def _clean_status(st):
    st = dict(st)
    st.pop("running")
    st["audit"] = [_clean_event(e) for e in st["audit"]]
    # live pool threads: a shrink retires a thread at its next sweep, so
    # the count lags the target by thread timing (the target is compared)
    st["pool"] = {k: v for k, v in st["pool"].items() if k != "size"}
    return st


def _run_trace(pkg, rows, clock, monkeypatch):
    ctl, pol = (jctl, jpol) if pkg == "jax" else (pctl, ppol)
    monkeypatch.setattr(ctl, "time", clock.ns())
    router = _router(pkg, status_port=0 if pkg == "port" else None)
    provider = InProcessProvider(pkg)
    door, pager = Door(), Pager()
    out = []
    with router:
        fc = ctl.FleetController(router, provider=provider,
                                 cfg=_fleet_cfg(ctl, pol), admission=door)
        fc.attach_alerter(pager)
        orig = fc._signals
        idx = [0]

        def signals(model, dt):
            row = rows[idx[0]]
            return replace(orig(model, dt), p99_ms=row["p99"],
                           n_window=row["n"], queue_frac=row["q"],
                           shed_per_s=row["shed"],
                           batch_starvation_s=row["starv"])
        fc._signals = signals
        seen = 0
        for i, row in enumerate(rows):
            idx[0] = i
            clock.t += 1.0
            pager.pages = row["pages"]
            door.starv = row["starv"]
            if row["kill"] and fc._owned.get("m"):
                provider.kill(fc._owned["m"][0][1])
            fc.tick()
            events = [_clean_event(e) for e in list(fc.audit)[seen:]]
            seen = len(fc.audit)
            out.append({"events": events, "pressure": fc.pressure,
                        "door": door.pressure,
                        "pool": router._pool_target,
                        "replicas": len(router.replicas["m"]),
                        "status": _clean_status(fc.status())})
        fleet_http = None
        if pkg == "port":
            host, port = router.status_address
            with urllib.request.urlopen(
                    f"http://{host}:{port}/fleet/status", timeout=10) as r:
                fleet_http = json.loads(r.read())
        # the grown replicas answer through the router
        for i in range(4):
            assert router.infer("m", _example(i),
                                timeout=30.0)["prob"].shape == (10,)
        fc.stop()
    provider.stop()
    return out, fleet_http


@pytest.mark.parametrize("seed", range(2))
def test_one_scripted_trace_gives_the_jax_controllers_decisions(
        seed, monkeypatch):
    rows = _trace(seed)
    jax_out, _ = _run_trace("jax", rows, Clock(), monkeypatch)
    port_out, fleet_http = _run_trace("port", rows, Clock(), monkeypatch)
    for i, (p, j) in enumerate(zip(port_out, jax_out)):
        assert p == j, f"tick {i}"
    events = [e for row in port_out for e in row["events"]]
    reasons = {(e["direction"], e["reason"]) for e in events}
    # the trace exercises every lever
    assert {("up", "slo_burn"), ("down", "dead"), ("up", "replace"),
            ("pressure", "slo_page"), ("relief", "batch_starvation"),
            ("up", "queue"), ("down", "quiet")} <= reasons, reasons
    assert max(r["pool"] for r in port_out) > 1
    assert port_out[-1]["replicas"] < max(r["replicas"] for r in port_out)
    assert set(fleet_http) == set(jax_out[-1]["status"]) | {"running"}
    assert fleet_http["enabled"] is True


def _port_fleet(router, provider, door=None, **over):
    return pctl.FleetController(router, provider=provider,
                                cfg=_fleet_cfg(pctl, ppol, **over),
                                admission=door)


@pytest.fixture()
def port_router():
    router = _router("port")
    with router:
        router.infer("m", _example(0), timeout=30.0)
        yield router


def _burn(router, n=32, seconds=0.2):
    for _ in range(n):
        router.latency["m"].add(seconds)


def test_a_shrink_drains_with_zero_dropped(port_router, monkeypatch):
    router = port_router
    clock = Clock()
    monkeypatch.setattr(pctl, "time", clock.ns())
    provider = InProcessProvider("port", gated=True)
    fc = _port_fleet(router, provider, drain_grace_s=5.0, pool_max=None,
                     policy=ppol.FleetPolicy(up_ticks=1, down_ticks=1,
                                             min_window_n=8))
    try:
        _burn(router)
        clock.t += 1.0
        fc.tick()
        assert len(router.replicas["m"]) == 2
        remote = fc._owned["m"][0][0]
        # requests until one is held in the grown replica's forward
        futs = []
        for i in range(4):
            futs.append(router.submit("m", _example(i)))
            if provider.entered.wait(timeout=0.5):
                break
        assert provider.entered.is_set(), "nothing reached the replica"
        router.latency["m"].reset()
        clock.t += 10.0
        fc.tick()                     # quiet: drain, retire in 5 s
        assert remote.draining
        assert fc.audit[-1]["reason"] == "quiet"
        # traffic during the drain goes to the local lane only
        during = [router.submit("m", _example(10 + i)) for i in range(6)]
        for f in during:
            assert f.result(timeout=30)["prob"].shape == (10,)
        assert provider.forwards == 1
        provider.gate.set()           # the held request completes
        for f in futs:
            assert f.result(timeout=30)["prob"].shape == (10,)
        clock.t += 2.0
        fc.tick()
        assert len(router.replicas["m"]) == 2   # the grace still runs
        clock.t += 4.0
        fc.tick()
        assert len(router.replicas["m"]) == 1
        assert provider.retired == [0]
    finally:
        fc.stop()
        provider.stop()


def test_a_dead_replica_is_replaced_and_named(port_router, monkeypatch):
    router = port_router
    clock = Clock()
    monkeypatch.setattr(pctl, "time", clock.ns())
    provider = InProcessProvider("port")
    fc = _port_fleet(router, provider, pool_max=None)
    try:
        _burn(router)
        for _ in range(2):
            clock.t += 1.0
            fc.tick()
        assert len(router.replicas["m"]) == 2
        victim, handle = fc._owned["m"][0]
        provider.kill(handle)
        clock.t += 1.0
        fc.tick()
        names = [r.name for r in router.replicas["m"]]
        assert victim.name not in names and len(names) == 2
        dead = [a for a in fc.audit if a["reason"] == "dead"]
        assert dead and dead[0]["replica"] == victim.name
        assert dead[0]["proc_dead"] is True
        assert fc.audit[-1]["reason"] == "replace"
        for i in range(4):
            assert router.infer("m", _example(i),
                                timeout=30.0)["prob"].shape == (10,)
    finally:
        fc.stop()
        provider.stop()


def test_min_replicas_holds(port_router, monkeypatch):
    router = port_router
    clock = Clock()
    monkeypatch.setattr(pctl, "time", clock.ns())
    provider = InProcessProvider("port")
    fc = _port_fleet(router, provider, min_replicas=2, pool_max=None,
                     down_cooldown_s=0.0)
    try:
        clock.t += 1.0
        fc.tick()
        assert len(router.replicas["m"]) == 2
        assert fc.audit[-1]["reason"] == "min_bound"
        for _ in range(8):            # quiet ticks never go below min
            clock.t += 5.0
            fc.tick()
        assert len(router.replicas["m"]) == 2
        assert [a["reason"] for a in fc.audit] == ["min_bound"]
    finally:
        fc.stop()
        provider.stop()


def test_a_page_lifts_pressure_and_relief_still_clamps(port_router,
                                                      monkeypatch):
    router = port_router
    clock = Clock()
    monkeypatch.setattr(pctl, "time", clock.ns())
    door, pager = Door(), Pager()
    fc = _port_fleet(router, None, door=door, pool_max=None)
    fc.attach_alerter(pager)
    try:
        clock.t += 1.0
        fc.tick()
        assert fc.pressure == door.pressure == 0.0
        pager.pages = ["m"]
        fc.tick()
        assert fc.pressure == door.pressure == fc.cfg.page_pressure == 0.9
        ev = fc.audit[-1]
        assert (ev["model"], ev["direction"], ev["reason"]) == \
            ("_slo", "pressure", "slo_page")
        fc.tick()                     # the edge is audited once
        assert sum(a["reason"] == "slo_page" for a in fc.audit) == 1
        door.starv = 61.0             # past batch_max_starvation_s
        fc.tick()
        assert fc.pressure == door.pressure == \
            fc.policy.batch_relief_pressure
        assert fc.audit[-1]["reason"] == "batch_starvation"
        door.starv = 0.0
        pager.pages = []
        fc.tick()
        assert fc.pressure == door.pressure == 0.0
        st = fc.status()
        assert st["pressure"] == 0.0 and st["admission"] == \
            {"pressure": 0.0}
        g = router.registry.gauge("sparknet_fleet_admission_pressure")
        assert g.value() == 0.0
    finally:
        fc.stop()


# -- providers ----------------------------------------------------------------


def test_the_pod_provider_runs_the_jax_stubs_commands():
    calls = {"jax": [], "port": []}
    provs = {"jax": jprov.PodReplicaProvider(
        {"m": "lenet"}, zone="us-east5-b", accel_type="v5e-8",
        runner=calls["jax"].append),
        "port": pprov.PodReplicaProvider(
        {"m": "lenet"}, zone="us-east5-b", accel_type="v5e-8",
        runner=calls["port"].append)}
    handles = {k: [p.grow("m"), p.grow("m")] for k, p in provs.items()}
    for k, p in provs.items():
        p.retire(handles[k][0])
        p.stop()
        with pytest.raises(KeyError):
            p.grow("unknown")
    assert [h.url for h in handles["port"]] == \
        [h.url for h in handles["jax"]]
    swap = ("sparknet-serve", "python -m sparknet_tpu_torch.serve.app")
    want = [[a.replace(*swap) for a in argv] for argv in calls["jax"]]
    assert calls["port"] == want
    assert [c[1] for c in calls["port"]] == \
        ["create", "setup", "run"] * 2 + ["delete", "delete"]


def test_the_subprocess_provider_grows_routes_and_retires(tmp_path):
    """A LeNet child on the CPU: up within spawn_timeout_s (120 s), routed
    over spkn://, retired (SIGTERM, then SIGKILL after 5 s)."""
    cache = str(tmp_path / "kernel-cache")
    prov = pprov.SubprocessReplicaProvider(
        {"m": "lenet"}, workdir=str(tmp_path), max_batch=4,
        compile_cache_dir=cache, heartbeat_every_s=0.2,
        spawn_timeout_s=120.0, extra_args=("--device", "cpu"))
    # a loaded box may write the child's 0.2 s beat late: a generous
    # staleness bound keeps the only routable replica routable
    router = _router("port", stale_after_s=30.0)
    try:
        with pytest.raises(KeyError):
            prov.grow("nope")
        h = prov.grow("m")
        assert h.url.startswith("spkn://127.0.0.1:") and prov.alive(h)
        cmd = h.meta["proc"].args
        assert cmd[1:3] == ["-m", "sparknet_tpu_torch.serve.app"]
        # the children share the warm-up cache, as the JAX provider's
        # share the XLA compile cache
        i = cmd.index("--compile-cache")
        assert cmd[i + 1] == cache and os.path.isdir(cache)
        with router:
            rep = router.add_remote_replica("m", h.url,
                                            heartbeat_path=h.heartbeat_path)
            router.drain("m", "local:m")   # every request to the child
            deadline = time.monotonic() + 60
            while not router._replica_routable(rep):
                assert time.monotonic() < deadline, "no heartbeat"
                time.sleep(0.05)
            for i in range(3):
                out = router.infer("m", _example(i), timeout=60.0)
                assert out["prob"].shape == (10,)
            assert router.status()["replicas"]["m"][1]["url"] == h.url
            router.remove_replica("m", rep.name)
        t0 = time.monotonic()
        prov.retire(h)
        assert not prov.alive(h) and time.monotonic() - t0 < 15.0
    finally:
        prov.stop()


# -- the serve CLI ------------------------------------------------------------


def test_the_serve_cli_autoscales_its_demo(tmp_path, capsys):
    hist = tmp_path / "history"
    app.main(["--models", "m=lenet", "--autoscale", "--fleet-provider",
              "none", "--binary-port", "0", "--slo-p99-ms", "50",
              "--history", "--history-dir", str(hist), "--demo", "4",
              "--device", "cpu", "--workdir", str(tmp_path)])
    status = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert status["autoscale"] is True
    assert status["models"]["m"]["requests_ok"] == 4
    assert status["slo"]["budget_remaining"] == {"m": 1.0}
    assert os.listdir(hist)


def test_the_serve_cli_refuses_autoscale_without_models(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        app.main(["--model", "lenet", "--autoscale", "--device", "cpu",
                  "--workdir", str(tmp_path)])
    assert e.value.code == 2
    assert "--autoscale requires --models" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        app.main(["--models", "m=lenet", "--autoscale", "--fleet-provider",
                  "pod", "--device", "cpu", "--workdir", str(tmp_path)])
    assert "--pod-zone" in capsys.readouterr().err


# -- the training loop's history lever ----------------------------------------

#: families only the JAX loop registers (tests/test_torch_pod.py): an
#: eager process has no jit cache whose entries the round could count,
#: and holds no live jax arrays; and the caching allocator's reserved
#: bytes, which only the port reports
JAX_ONLY = {"sparknet_train_round_compiled_variants",
            "sparknet_device_live_arrays"}
PORT_ONLY = {"sparknet_device_hbm_bytes_reserved"}


def test_the_train_loop_history_is_the_jax_loop_s(tmp_path):
    r = np.random.default_rng(0)
    data = {"data": r.standard_normal((96, 1, 28, 28)).astype(np.float32),
            "label": r.integers(0, 10, (96, 1)).astype(np.int32)}
    out = {}
    for k in ("jax", "port"):
        root = str(tmp_path / k)
        os.makedirs(root)
        common = dict(model="lenet", local_batch=16, tau=2, max_rounds=3,
                      eval_every=0, workdir=root, status_port=0,
                      history=True, history_dir=os.path.join(root, "h"),
                      history_interval_s=0.05)
        cfg = (RunConfig(**common) if k == "port" else
               JaxRunConfig(n_devices=1, trainer_impl="shard_map",
                            **common))
        scraped = {}

        def hook(rnd, state, cfg=cfg, scraped=scraped):
            if rnd != 2:
                return
            host, port = cfg.status_address
            base = f"http://{host}:{port}/timeseries"
            deadline = time.monotonic() + 60
            while True:   # until a sample saw the first flushed round
                body = json.loads(urllib.request.urlopen(
                    base, timeout=10).read())
                if "sparknet_train_round_seconds" in body["families"]:
                    break
                assert time.monotonic() < deadline, body
                time.sleep(0.02)
            scraped["families"] = body
            scraped["round"] = json.loads(urllib.request.urlopen(
                base + "?name=sparknet_train_round_seconds&window=60",
                timeout=10).read())

        log = (Logger if k == "port" else JaxLogger)(
            echo=False, jsonl_path=os.path.join(root, "m.jsonl"))
        if k == "port":
            train(cfg, zoo.lenet(batch=16), ArrayDataset(data), None,
                  logger=log, round_hook=hook, device="cpu")
        else:
            jax_train(cfg, jax_lenet(batch=16), JaxArrayDataset(data), None,
                      logger=log, round_hook=hook)
        out[k] = (scraped, os.path.join(root, "h"))
    fams = {}
    for k, (scraped, hdir) in out.items():
        fams[k] = set(read_history_shards(hdir)[0])
        assert fams[k] == set(jax_read_shards(hdir)[0])
        assert set(scraped["families"]) == \
            {"families", "rings", "samples_total"}
        assert set(scraped["round"]) == {"name", "kind", "window_s",
                                         "res_s", "agg", "points"}
    assert fams["port"] == (fams["jax"] - JAX_ONLY) | PORT_ONLY, \
        fams["port"] ^ fams["jax"]
    assert "sparknet_train_round_seconds" in fams["port"]
