"""Multi-model serving: one ModelManager + forward lane per model over a
shared worker pool, with health-aware replica routing.

The counterpart of `sparknet_tpu/serve/router.py`. The single-model
`InferenceServer` owns one net and one worker thread. Serving several
models that way costs one idle thread (and one idle CUDA stream of work)
per cold model; the router instead owns N LANES (each an `InferenceServer`
started with `thread=False` — batcher + ModelManager + bucket-padded
forwards, but no thread) and K POOL threads that drive whichever lanes
have queued work. Exactly one pool thread drives a lane at a time
(`lane_lock`), preserving the lane's single-writer params contract: a hot
swap still never interleaves with a forward. All lanes share ONE
MetricsRegistry; the `model` label keeps their families apart, so
`/metrics` is one exposition for the whole router.

REPLICAS: each model maps to a replica set — the local lane and/or remote
replicas (other processes' HTTP or binary frontends). Routing is
round-robin over HEALTHY replicas, where healthy means: not draining (an
operator `drain()` or a stale heartbeat — the shared `stale_after_s`
rule), not in hot-swap cooldown (a replica that just REJECTED a checkpoint
gets `swap_cooldown_s` of reduced load), and not just refused at the
transport level (`conn_fail_cooldown_s`). Draining only gates NEW
routing: everything already queued on a replica is served to completion,
so a drain drops zero in-flight responses. When no replica is healthy the
router degrades in order: any non-draining replica (serve stale rather
than refuse), then `NoReplicaError` — which both frontends map to 503,
never a hang. A proxy hop that fails at the transport level fails over
to another replica once.

HEDGING (`hedge`): after an adaptive delay (the model's live routed
latency quantile) a still-unanswered request gets a second leg on another
healthy replica; the first answer wins, the loser is cancelled
best-effort, the budget caps second legs, and admission pressure
(`attach_admission`) disables them. COALESCING (`coalesce`): while every
replica reports under-filled batches, consecutive requests in one window
go to one focus replica, rotated per window.

The step whose weights answered and the request's queue wait ride every
future the router returns (`_spkn_step`, `_spkn_queue_wait_s`, set before
it resolves), whichever replica or leg answered, so the frontends put
them on the wire as they do for a lone server.

The SLO ledger (`history`): one metrics-history sampler over the shared
registry (the `/timeseries` route, JSONL shards in `history_dir`) and
one burn-rate alerter holding an `SloSpec` per lane that declares an
objective (`/slo/status`, the `slo` block of `status()`, the fleet
controller's page escalation). `/fleet/status` answers the bound
`fleet.FleetController`'s view (`attach_fleet`), {"enabled": false}
without one; `remove_replica` is the controller's retire step.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs import reqtrace
from ..obs.http import StatusServer
from ..obs.meta import register_build_info
from ..obs.registry import MetricsRegistry
from ..utils.heartbeat import HeartbeatWriter, read_heartbeat, staleness_s
from ..utils.logger import Logger
from ..utils.metrics import LatencyStats
from .batcher import RequestCancelledError
from .server import InferenceServer, ServeConfig


def _copy_reply_meta(src: Future, dst: Future) -> None:
    """Carry the served step and queue wait from a leg's future to the
    future the caller holds (before it resolves: its callbacks read
    them)."""
    dst._spkn_step = src._spkn_step
    dst._spkn_queue_wait_s = getattr(src, "_spkn_queue_wait_s", None)


class UnknownModelError(KeyError):
    """Request names a model this router does not serve (HTTP 404)."""


class NoReplicaError(RuntimeError):
    """Every replica of the model is draining or dead (HTTP 503 +
    Retry-After — load shedding, never a hang)."""


def heartbeat_health(path: str, stale_after_s: float = 60.0,
                     min_refresh_s: float = 1.0) -> Callable[[], bool]:
    """A replica health probe over the pod heartbeat plumbing: fresh beat
    with a non-terminal status == healthy. Reads are cached
    `min_refresh_s` so a busy router doesn't hammer the file/bucket."""
    state = {"t": 0.0, "ok": False}
    lock = threading.Lock()

    def probe() -> bool:
        with lock:
            now = time.monotonic()
            if now - state["t"] >= min_refresh_s:
                hb = read_heartbeat(path)
                age = staleness_s(hb)
                state["ok"] = bool(
                    hb is not None and hb.get("status") != "done"
                    and age is not None and age <= stale_after_s)
                state["t"] = now
            return state["ok"]
    return probe


def heartbeat_fill(path: str, model: str, min_refresh_s: float = 1.0
                   ) -> Callable[[], Optional[float]]:
    """A replica batch-fill probe over the same heartbeat rows health
    rides on: reads `models[model].recent_occupancy` (falling back to
    `batch_fill` for older replicas) from the beat, cached
    `min_refresh_s` — the coalescing trigger's remote signal."""
    state = {"t": 0.0, "fill": None}
    lock = threading.Lock()

    def probe() -> Optional[float]:
        with lock:
            now = time.monotonic()
            if now - state["t"] >= min_refresh_s:
                hb = read_heartbeat(path)
                row = ((hb or {}).get("models") or {}).get(model) or {}
                # prefer the occupancy signal (capacity-relative, what
                # coalescing improves); older replicas only beat the
                # bucket-relative cumulative fill
                fill = row.get("recent_occupancy")
                if fill is None:
                    fill = row.get("batch_fill")
                state["fill"] = float(fill) if fill is not None else None
                state["t"] = now
            return state["fill"]
    return probe


class Replica:
    """One serving copy of a model: the local lane, or a remote frontend
    address. `health_fn` (remote) answers "is it alive" — typically
    `heartbeat_health` over the replica's pod heartbeat. `transport`
    picks the remote wire: "http" (http_infer) or "binary" (the
    length-prefixed frame protocol via binary_infer — cross-replica
    proxy hops drop the npz/JSON re-encode tax)."""

    def __init__(self, name: str, lane: Optional[InferenceServer] = None,
                 url: Optional[str] = None,
                 health_fn: Optional[Callable[[], bool]] = None,
                 transport: str = "http",
                 fill_fn: Optional[Callable[[], Optional[float]]] = None):
        if (lane is None) == (url is None):
            raise ValueError("a replica is exactly one of: local lane, "
                             "remote url")
        if transport not in ("http", "binary"):
            raise ValueError(f"transport must be 'http' or 'binary' (got "
                             f"{transport!r})")
        self.name = name
        self.lane = lane
        self.url = url.rstrip("/") if url else None
        self.transport = transport
        self.health_fn = health_fn
        # batch-fill signal for coalesced formation: local lanes read
        # their FillMeter's recent window; remotes read batch_fill out
        # of the same cached heartbeat rows health rides on. None =
        # no signal (this replica neither triggers nor vetoes)
        self.fill_fn = fill_fn
        self._draining = False
        self._fail_t = 0.0  # monotonic time of the last transport error

    def fill_signal(self) -> Optional[float]:
        """Recent batch occupancy in [0,1], or None with no signal."""
        if self.lane is not None:
            return self.lane.fill_signal()
        if self.fill_fn is not None:
            try:
                return self.fill_fn()
            except Exception:
                return None
        return None

    def note_failure(self) -> None:
        """A proxy hop to this replica just failed at the transport
        level (connection refused/reset). The router demotes it for
        `conn_fail_cooldown_s` — faster than the heartbeat can go
        stale — so a just-died replica stops eating round-robin turns
        within one failed request, not one staleness window."""
        self._fail_t = time.monotonic()

    def recently_failed(self, cooldown_s: float) -> bool:
        return (time.monotonic() - self._fail_t) < cooldown_s

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Stop routing NEW requests here; in-flight work still completes
        (a drain must drop zero responses)."""
        self._draining = True

    def undrain(self) -> None:
        self._draining = False

    def as_dict(self) -> Dict[str, Any]:
        return {"replica": self.name,
                "kind": "local" if self.lane is not None else "remote",
                "draining": self._draining,
                **({"url": self.url, "transport": self.transport}
                   if self.url else {})}


@dataclass
class RouterConfig:
    """Knobs for the multi-model router (the serve CLI's `--models`
    CLI mirrors these)."""

    workers: int = 2                    # shared pool threads (initial;
    #                                     set_pool_size resizes live)
    # a replica that just REJECTED a checkpoint swap is deprioritized
    # for this long (its peers absorb the load while it settles)
    swap_cooldown_s: float = 3.0
    # staleness rule for remote-replica heartbeats (the same threshold
    # the pod aggregator and elastic controller use)
    stale_after_s: float = 60.0
    # heartbeat probe read-cache (heartbeat_health min_refresh_s): a
    # busy router must not hammer the file/bucket per request, but the
    # fleet tests/controller need sub-second demotion
    health_refresh_s: float = 1.0
    # a replica whose proxy hop just FAILED at the transport level is
    # demoted for this long (note_failure): the fast complement of the
    # heartbeat staleness rule
    conn_fail_cooldown_s: float = 1.0
    # -- request hedging (Dean & Barroso's tied requests, on the
    # pipelined wire): after an adaptive delay a still-unanswered
    # request is re-issued to a SECOND healthy replica; first answer
    # wins, the loser is cancelled best-effort (batcher removal locally,
    # a CANCEL frame remotely). Needs >= 2 replicas to do anything.
    hedge: bool = False
    # the adaptive delay: this quantile of the model's live windowed
    # routed latency (requests slower than p95 are, by construction, the
    # tail worth re-issuing), floored at hedge_min_delay_ms (also the
    # delay used before the window has any signal)
    hedge_quantile: float = 0.95
    hedge_window_s: float = 30.0
    hedge_min_delay_ms: float = 2.0
    # hedges are capped at this fraction of routed requests so hedging
    # can't melt an overloaded fleet — and they are disabled entirely
    # while admission pressure is nonzero (attach_admission): an
    # overload signal means extra copies are the LAST thing to add
    hedge_budget: float = 0.05
    # -- coalesced batch formation: when every replica reporting a fill
    # signal shows recent fill below the threshold, route consecutive
    # requests to ONE focus replica per formation window (rotated per
    # window for fairness) instead of round-robin spraying a trickle
    # into N fragmented batches
    coalesce: bool = False
    coalesce_window_ms: float = 25.0
    coalesce_fill_threshold: float = 0.5
    # observability (shared across all lanes)
    status_port: Optional[int] = None   # None = no HTTP; 0 = ephemeral
    status_host: str = "127.0.0.1"
    heartbeat_path: Optional[str] = None
    heartbeat_every_s: float = 10.0
    registry: Optional[MetricsRegistry] = None
    # SLO ledger over the SHARED registry: one history sampler for every
    # lane (the /timeseries route), one burn-rate alerter holding a
    # SloSpec per lane that declares an objective (slo_p99_ms /
    # slo_availability on its ServeConfig) — /slo/status, the slo status
    # section, and the fleet controller's page escalation
    history: bool = False
    history_dir: Optional[str] = None
    history_interval_s: float = 1.0

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1 (got {self.workers})")
        if self.history_interval_s <= 0:
            raise ValueError(f"history_interval_s must be > 0 "
                             f"(got {self.history_interval_s})")


class ModelRouter:
    """N model lanes + replica sets over K shared worker threads."""

    def __init__(self, cfg: Optional[RouterConfig] = None,
                 logger: Optional[Logger] = None):
        self.cfg = cfg = cfg if cfg is not None else RouterConfig()
        self.log = logger
        self.registry = cfg.registry or MetricsRegistry()
        register_build_info(self.registry)
        self.lanes: Dict[str, InferenceServer] = {}
        self.replicas: Dict[str, List[Replica]] = {}
        # round-robin state: index (into the FULL replica list) of the
        # last replica picked, per model. _pick scans forward from it,
        # skipping unroutable replicas — so a drained-then-undrained
        # replica deterministically re-enters the rotation at its own
        # position and resumes its fair share (a count-modulo over the
        # FILTERED list could park on a parity that starves a flapping
        # replica forever; tests pin both properties)
        self._rr: Dict[str, int] = {}
        self._rr_lock = threading.Lock()
        self._order: List[str] = []             # lane rotation order
        self._rot = 0
        self._wakeup = threading.Condition()
        # shared worker pool, resizable live (the fleet controller's
        # in-process lever): thread idx -> thread; a thread retires when
        # its idx >= _pool_target
        self._pool: Dict[int, threading.Thread] = {}
        self._pool_target = 0
        self._pool_lock = threading.Lock()
        # per-model END-TO-END latency from the router's vantage (submit
        # -> future resolution, local lane or remote proxy alike): the
        # fleet controller's SLO-burn signal must cover whichever
        # replica served, not just the local lane's forwards
        self.latency: Dict[str, LatencyStats] = {}
        # remote proxying must not block router callers: a small executor
        # carries the HTTP round-trips (bounded by pool size + margin)
        self._proxy: Optional[ThreadPoolExecutor] = None
        self._running = False
        self._http = None
        # SLO ledger handles (started with the router when cfg.history)
        self.history = None
        self.alerter = None
        self.fleet = None  # FleetController attaches here (attach_fleet)
        # PriorityAdmission attaches here (attach_admission): its
        # .pressure gates hedging — no extra copies under overload
        self.admission = None
        # hedging: pending (fire_t, seq, entry) heap drained by one
        # scheduler thread; per-model [routed, hedged] counts enforce
        # the budget
        self._hedge_heap: List[Any] = []
        self._hedge_cv = threading.Condition()
        self._hedge_seq = itertools.count()
        self._hedge_counts: Dict[str, List[int]] = {}
        self._hedge_thread: Optional[threading.Thread] = None
        # coalesced formation: per-model {"until", "focus", "active"};
        # windows are timed on `clock` (tests inject their own)
        self._co: Dict[str, Dict[str, Any]] = {}
        self._co_lock = threading.Lock()
        self.clock: Callable[[], float] = time.monotonic
        self.heartbeat = (HeartbeatWriter(cfg.heartbeat_path, role="serve",
                                          interval_s=cfg.heartbeat_every_s,
                                          registry=self.registry)
                          if cfg.heartbeat_path else None)
        self._c_routed = self.registry.counter(
            "sparknet_serve_routed_total",
            "requests routed, by model and chosen replica",
            labels=("model", "replica"))
        self._c_drains = self.registry.counter(
            "sparknet_serve_replica_drains_total",
            "replica drain events", labels=("model", "replica"))
        self._g_healthy = self.registry.gauge(
            "sparknet_serve_replica_healthy",
            "1 = replica currently routable (not draining/stale/cooling)",
            labels=("model", "replica"))
        self._c_failovers = self.registry.counter(
            "sparknet_serve_replica_failovers_total",
            "proxy hops that failed at the transport level and were "
            "retried on another replica", labels=("model", "replica"))
        self._c_hedged = self.registry.counter(
            "sparknet_serve_hedged_total",
            "hedged requests by which leg answered first "
            "(won=primary|hedge)", labels=("model", "won"))
        self._c_hedge_cancelled = self.registry.counter(
            "sparknet_serve_hedge_cancelled_total",
            "hedge losers confirmed cancelled before forming into a "
            "batch (a cancel that lost the race is just dropped)",
            labels=("model",))
        self._c_coalesced = self.registry.counter(
            "sparknet_serve_coalesced_total",
            "requests routed by coalesced formation (focus replica "
            "instead of round-robin)", labels=("model",))
        self.registry.gauge(
            "sparknet_serve_pool_workers",
            "live shared-pool worker threads (set_pool_size resizes)"
        ).set_fn(self.pool_size)

    # -- assembly ------------------------------------------------------------

    def add_model(self, name: str, net,
                  cfg: Optional[ServeConfig] = None, preprocessor=None
                  ) -> InferenceServer:
        """Add a locally-served model: builds its lane (forced onto the
        router's shared registry, named `name`) and registers it as the
        model's first replica. The lane takes its initial weights as a
        lone server does (`ModelManager.load_initial` at start: the newest
        verified step of its `checkpoint_dir`, else the net's own). Call
        before start(). `preprocessor` is the lane's raw-pixel door
        (`InferenceServer`'s: each formed batch is decoded before it is
        padded)."""
        if name in self.lanes:
            raise ValueError(f"model {name!r} already added")
        cfg = replace(cfg if cfg is not None else ServeConfig(),
                      model_name=name, registry=self.registry,
                      status_port=None, heartbeat_path=None)
        lane = InferenceServer(net, cfg, preprocessor=preprocessor,
                               logger=self.log)
        lane.batcher.on_submit = self._wake
        self.lanes[name] = lane
        self._order.append(name)
        self.replicas.setdefault(name, []).append(
            Replica(f"local:{name}", lane=lane))
        self._rr.setdefault(name, -1)
        self._ensure_latency(name)
        return lane

    def _ensure_latency(self, model: str) -> LatencyStats:
        if model not in self.latency:
            self.latency[model] = LatencyStats(
                registry=self.registry,
                name="sparknet_serve_routed_latency_seconds",
                model=model)
        return self.latency[model]

    def add_remote_replica(self, model: str, url: str,
                           health_fn: Optional[Callable[[], bool]] = None,
                           heartbeat_path: Optional[str] = None,
                           transport: Optional[str] = None
                           ) -> Replica:
        """Register another pod worker's frontend as a replica of
        `model`. `url` is an HTTP base URL, or `spkn://host:port` for
        the binary frame transport (`transport` overrides; the scheme
        decides otherwise). Health comes from `health_fn`, or from
        `heartbeat_path` through the shared staleness rule; with
        neither, the replica is trusted until drained."""
        fill_fn = None
        if health_fn is None and heartbeat_path is not None:
            health_fn = heartbeat_health(heartbeat_path,
                                         self.cfg.stale_after_s,
                                         self.cfg.health_refresh_s)
        if heartbeat_path is not None:
            fill_fn = heartbeat_fill(heartbeat_path, model,
                                     self.cfg.health_refresh_s)
        if transport is None:
            transport = "binary" if url.startswith("spkn://") else "http"
        rep = Replica(f"remote:{url}", url=url, health_fn=health_fn,
                      transport=transport, fill_fn=fill_fn)
        self.replicas.setdefault(model, []).append(rep)
        self._rr.setdefault(model, -1)
        self._ensure_latency(model)
        return rep

    def remove_replica(self, model: str, replica: str) -> Replica:
        """Unregister a replica (by name or url) — the fleet
        controller's retire step, after a drain has gated new routing
        and the grace window let in-flight work finish. Raises
        UnknownModelError when nothing matches."""
        reps = self.replicas.get(model, [])
        for i, r in enumerate(reps):
            if r.name == replica or r.url == replica:
                if r.lane is not None:
                    raise ValueError(
                        f"{model}/{r.name}: the local lane cannot be "
                        f"removed (drain it instead)")
                del reps[i]
                if self.log is not None:
                    self.log.log(f"serve: removed replica "
                                 f"{model}/{r.name}")
                return r
        raise UnknownModelError(f"{model}/{replica}")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ModelRouter":
        if self._running:
            raise RuntimeError("the router is already started")
        if not (self.lanes or any(self.replicas.values())):
            raise ValueError("the router has no models")
        self._running = True
        for lane in self.lanes.values():
            lane.start(thread=False)
        self._proxy = ThreadPoolExecutor(
            max_workers=max(4, 2 * self.cfg.workers),
            thread_name_prefix="serve-proxy")
        self.set_pool_size(self.cfg.workers)
        if self.cfg.hedge:
            self._hedge_thread = threading.Thread(
                target=self._hedge_run, name="serve-hedge", daemon=True)
            self._hedge_thread.start()
        if self.cfg.status_port is not None:
            self._http = StatusServer(
                self.cfg.status_port, self.registry,
                host=self.cfg.status_host,
                healthz=self._healthz, status=self.status,
                routes={"/fleet/status": self._fleet_status})
        if self.cfg.history:
            self._start_history()
        return self

    def _start_history(self) -> None:
        """One SLO ledger for the whole router: the shared registry's
        `model` labels keep lanes apart, so a single history + alerter
        covers every lane (specs from each lane's declared objectives)."""
        from ..obs.history import HistoryConfig, MetricsHistory
        from ..obs.slo import BurnRateAlerter, SloSpec
        self.history = MetricsHistory(
            self.registry,
            HistoryConfig(sample_interval_s=self.cfg.history_interval_s,
                          persist_dir=self.cfg.history_dir),
            logger=self.log)
        specs = []
        for name, lane in sorted(self.lanes.items()):
            if lane.cfg.slo_spec is not None:
                specs.append(lane.cfg.slo_spec)
            elif lane.cfg.slo_p99_ms is not None or \
                    lane.cfg.slo_availability is not None:
                specs.append(SloSpec(
                    model=name, latency_ms=lane.cfg.slo_p99_ms,
                    availability=lane.cfg.slo_availability))
        if specs:
            self.alerter = BurnRateAlerter(self.history, specs,
                                           logger=self.log).attach()
            for name in (s.model for s in specs):
                lane = self.lanes.get(name)
                if lane is not None:
                    lane.alerter = self.alerter  # model_row slo fields
        if self._http is not None:
            self.history.attach_http(self._http)
            if self.alerter is not None:
                self.alerter.attach_http(self._http)
        self.history.start()

    def attach_fleet(self, controller) -> None:
        """Bind a fleet controller (`fleet.FleetController`):
        /fleet/status starts answering with its view (the route itself is
        always registered and answers {"enabled": false} until then)."""
        self.fleet = controller

    def attach_admission(self, admission) -> None:
        """Bind the PriorityAdmission whose `.pressure` gates hedging:
        under any admission pressure the fleet is already shedding, and
        a hedge is an extra copy of exactly the load being shed."""
        self.admission = admission

    def _pressure(self) -> float:
        adm = self.admission
        try:
            return float(getattr(adm, "pressure", 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def _fleet_status(self) -> Dict[str, Any]:
        if self.fleet is None:
            return {"enabled": False}
        return self.fleet.status()

    # -- pool sizing (the fleet controller's in-process lever) ---------------

    def pool_size(self) -> int:
        return sum(t.is_alive() for t in self._pool.values())

    def set_pool_size(self, n: int) -> int:
        """Resize the shared worker pool LIVE, within [1, ...]. Growth
        spawns threads immediately; shrink is cooperative — a thread
        whose idx falls past the target retires at its next sweep (mid-
        forward work always completes; a shrink never drops a batch).
        Returns the new target."""
        n = max(1, int(n))
        with self._pool_lock:
            self._pool_target = n
            if self._running:
                for i in range(n):
                    t = self._pool.get(i)
                    if t is None or not t.is_alive():
                        t = threading.Thread(target=self._pool_run,
                                             args=(i,),
                                             name=f"serve-pool-{i}",
                                             daemon=True)
                        self._pool[i] = t
                        t.start()
        self._wake()  # retiring threads notice the new target promptly
        return n

    def stop(self, drain_s: float = 5.0) -> None:
        """Drain queued work (bounded), then stop lanes and the pool."""
        deadline = time.monotonic() + drain_s
        while any(l.batcher.depth() for l in self.lanes.values()) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        self._running = False
        for lane in self.lanes.values():
            lane._running = False
            lane.batcher.close()
        with self._wakeup:
            self._wakeup.notify_all()
        with self._hedge_cv:
            self._hedge_cv.notify_all()
        if self._hedge_thread is not None:
            self._hedge_thread.join(timeout=2.0)
            self._hedge_thread = None
        with self._pool_lock:
            # snapshot under the lock: a racing set_pool_size (a fleet
            # controller not yet stopped) must not mutate the dict
            # mid-iteration
            pool, self._pool = list(self._pool.values()), {}
        for t in pool:
            t.join(timeout=max(drain_s, 1.0))
        if self._proxy is not None:
            self._proxy.shutdown(wait=False)
            self._proxy = None
        if self.history is not None:
            self.history.stop()
            self.history = None
            self.alerter = None
        if self._http is not None:
            self._http.stop()
            self._http = None
        if self.heartbeat is not None:
            try:
                self.heartbeat.beat(self._max_step(), status="done",
                                    rollbacks=self._swap_failures(),
                                    force=True,
                                    models=self._model_rows())
            except OSError:
                pass

    def __enter__(self) -> "ModelRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- routing -------------------------------------------------------------

    def _replica_routable(self, rep: Replica) -> bool:
        if rep.draining:
            return False
        if rep.lane is not None:
            return rep.lane._running and not \
                rep.lane.manager.swap_cooldown_active(
                    self.cfg.swap_cooldown_s)
        if rep.recently_failed(self.cfg.conn_fail_cooldown_s):
            return False  # transport just refused/reset: demote fast
        if rep.health_fn is not None:
            try:
                return bool(rep.health_fn())
            except Exception:
                return False  # a broken probe reads as unhealthy
        return True

    def _update_replica_gauges(self) -> None:
        """Refresh sparknet_serve_replica_healthy for EVERY replica —
        called from the pool's duty cadence, not per request: gauge
        writes stay off the routing hot path, and idle models' replicas
        still report fresh health. (Not a scrape-time set_fn: a remote
        health probe may read a heartbeat file/bucket, which must never
        run under the registry lock.)"""
        for model, reps in self.replicas.items():
            for r in reps:
                self._g_healthy.set(
                    1.0 if self._replica_routable(r) else 0.0,
                    model=model, replica=r.name)

    def _pick(self, model: str,
              exclude: Optional[Replica] = None) -> Replica:
        """Next replica by deterministic rotation: scan the FULL replica
        list forward from the last pick, skipping unroutable entries —
        each routable replica gets consecutive turns regardless of how
        the routable subset flaps between picks (a count-modulo over the
        filtered list can alias against a flapping replica's phase and
        starve it; regression-tested). `exclude` skips one replica (the
        failover retry must not re-pick the replica that just refused)."""
        reps = self.replicas.get(model)
        if not reps:
            raise UnknownModelError(model)
        reps = list(reps)  # snapshot: the fleet controller may
        #                    add/remove replicas concurrently

        def scan(ok) -> Optional[Replica]:
            # probes FIRST, lock SECOND: a heartbeat health_fn may read
            # a file or a gs:// object — that I/O must never run under
            # the shared rotation lock, or one stalling replica's probe
            # serializes routing for every model
            flags = [r is not exclude and ok(r) for r in reps]
            if not any(flags):
                return None
            with self._rr_lock:
                start = self._rr.get(model, -1)
                n = len(reps)
                for i in range(1, n + 1):
                    j = (start + i) % n
                    if flags[j]:
                        self._rr[model] = j
                        return reps[j]
            return None

        if self.cfg.coalesce and exclude is None and len(reps) > 1:
            rep = self._coalesce_pick(model, reps)
            if rep is not None:
                self._c_coalesced.inc(model=model)
                return rep

        rep = scan(self._replica_routable)
        if rep is None:
            # degrade before refusing: a cooling-down or stale-beat
            # replica that is NOT draining may still answer (freshness
            # degrades, availability does not)
            rep = scan(lambda r: not r.draining
                       and (r.lane is None or r.lane._running))
        if rep is None:
            raise NoReplicaError(
                f"model {model!r}: every replica is draining or down")
        return rep

    def _coalesce_pick(self, model: str,
                       reps: List[Replica]) -> Optional[Replica]:
        """Coalesced formation: when every replica REPORTING a fill
        signal shows recent fill under the threshold (and at least one
        reports), consecutive requests inside one formation window all
        go to a single FOCUS replica — a trickle that round-robin would
        fragment into N under-filled batches forms one fuller batch
        instead. The focus rotates to the next routable replica every
        window, so over W windows each replica leads ~W/n of them
        (fairness; pinned in tests). Returns None when coalescing is
        inactive this window — the caller falls through to round-robin."""
        now = self.clock()
        with self._co_lock:
            st = self._co.setdefault(
                model, {"until": 0.0, "focus": -1, "active": False})
            if now >= st["until"]:
                st["until"] = now + self.cfg.coalesce_window_ms / 1e3
                fills = [f for f in (r.fill_signal() for r in reps)
                         if f is not None]
                st["active"] = bool(fills) and all(
                    f < self.cfg.coalesce_fill_threshold for f in fills)
                if st["active"]:
                    # rotate focus to the NEXT routable replica (probe
                    # outside any hot lock is the _pick rule; this lock
                    # is coalescing-private and probes are cached)
                    n = len(reps)
                    for i in range(1, n + 1):
                        j = (st["focus"] + i) % n
                        if self._replica_routable(reps[j]):
                            st["focus"] = j
                            break
                    else:
                        st["active"] = False
            if not st["active"]:
                return None
            rep = reps[st["focus"] % len(reps)]
        # re-check outside the window decision: a focus replica that
        # went unroutable MID-window falls back to round-robin rather
        # than eating requests it cannot serve
        return rep if self._replica_routable(rep) else None

    def _issue(self, rep: Replica, model: str, payload: Dict[str, Any],
               deadline_s: Optional[float],
               priority: Optional[str] = None, trace=None
               ) -> Tuple[Future, Callable[[], None]]:
        """Issue one request LEG on a specific replica -> (future,
        cancel_fn). cancel_fn is best-effort and idempotent: locally it
        pulls the request out of the lane's batcher queue (a no-op once
        it formed into a batch); remotely over the binary wire it sends
        a CANCEL frame on the leg's request id (http legs have no cancel
        — the loser just completes unobserved). A confirmed cancel
        resolves the leg future with RequestCancelledError either way,
        which is what the hedge accounting counts."""
        if rep.lane is not None:
            fut = rep.lane.submit(payload, deadline_s=deadline_s,
                                  priority=priority, trace=trace)
            lane = rep.lane
            return fut, (lambda: (lane.batcher.cancel(fut), None)[1])
        proxy = self._proxy
        if proxy is None or not self._running:
            # racing stop() (or called before start): a typed shed,
            # not an AttributeError surfacing as a 500
            raise NoReplicaError(
                f"model {model!r}: router is not running")
        fut = Future()
        cancel_box: Dict[str, Any] = {}
        proxy.submit(self._proxy_call, rep, model, payload,
                     deadline_s, fut, False, cancel_box, priority, trace)

        def cancel() -> None:
            fn = cancel_box.get("cancel")
            if fn is not None:
                try:
                    fn()
                except Exception:
                    pass  # best-effort: a dead socket drops the cancel
        return fut, cancel

    def submit(self, model: str, payload: Dict[str, Any],
               deadline_s: Optional[float] = None,
               priority: Optional[str] = None,
               _exclude: Optional[Replica] = None,
               trace=None) -> Future:
        """Route one request; returns its response future. Raises
        UnknownModelError / NoReplicaError synchronously; QueueFullError
        propagates from the chosen local lane (backpressure is
        per-replica — the caller may retry, which re-routes). Served
        requests feed the per-model `self.latency` window (the fleet
        controller's SLO-burn signal) whichever replica answered.

        With hedging enabled (and >= 2 replicas, no admission pressure)
        the returned future is an OUTER future: if the primary leg has
        not answered within the adaptive delay, a second leg is issued
        to another replica and the first answer wins — the loser's
        cancel is best-effort and exactly-once delivery is the outer
        future's first-resolution-wins."""
        rep = self._pick(model, exclude=_exclude)
        self._c_routed.inc(model=model, replica=rep.name)
        # trace context: a router fronted directly (no HTTP/binary front
        # door, e.g. in-process use) MINTS the context
        # and owns the request record; when a frontend minted it, the
        # router is a pass-through hop and must NOT start a second
        # record (record owner = minter — one request row per process
        # per request)
        rt = reqtrace.active()
        ctx = (reqtrace.parse_context(trace) if trace is not None
               else None)
        rec = None
        if rt is not None and ctx is None:
            ctx = rt.mint()
            rec = rt.begin(ctx, transport="router", model=model)
        hedging = (self.cfg.hedge and _exclude is None
                   and (priority or "normal").lower() != "low"
                   and len(self.replicas.get(model, ())) >= 2)
        # each LEG gets a child context (fresh span id, same trace id):
        # the wire span a leg emits then matches exactly one server-side
        # record, so assembly tells hedge duplicates apart. The leg tag
        # is only set when hedging can engage — a plain child otherwise.
        leg = (ctx.child(leg="primary") if hedging
               else ctx.child()) if ctx is not None else None
        fut, cancel = self._issue(rep, model, payload, deadline_s,
                                  priority, trace=leg)
        ret = fut
        # low-priority (scavenger/batch) requests never hedge: a hedge
        # duplicates exactly the load the admission stack exists to
        # shed, and a scavenger's tail is free to be long
        if hedging:
            counts = self._hedge_counts.setdefault(model, [0, 0])
            counts[0] += 1
            ret = self._hedge_arm(model, payload, deadline_s, rep,
                                  fut, cancel, priority, trace=ctx)
        t0 = time.perf_counter()
        lat = self._ensure_latency(model)

        def _done(f: Future) -> None:
            exc = f.exception()
            if exc is None:
                lat.add(time.perf_counter() - t0)
            if rec is not None:
                rt.finish_exc(rec, exc) if exc is not None \
                    else rt.finish(rec, "ok")
        ret.add_done_callback(_done)
        return ret

    # -- hedging (tail-at-scale tied requests) --------------------------------

    def _hedge_arm(self, model: str, payload: Dict[str, Any],
                   deadline_s: Optional[float], rep: Replica,
                   fut: Future, cancel: Callable[[], None],
                   priority: Optional[str] = None,
                   trace=None) -> Future:
        """Wrap the primary leg in an OUTER future and schedule the
        hedge decision. At fire time (adaptive delay past submit) an
        unanswered request gets a second leg on another replica; the
        first leg to complete resolves the outer future (exactly-once:
        the winner is chosen under one lock) and the loser is cancelled
        best-effort. The loser's confirmed cancellation — its future
        resolving with RequestCancelledError — feeds
        hedge_cancelled_total; a cancel that lost the race to batch
        formation just means two computed answers, one delivered."""
        outer: Future = Future()
        lock = threading.Lock()
        state: Dict[str, Any] = {"won": None, "hedged": False}
        cancels: Dict[str, Optional[Callable[[], None]]] = {
            "primary": cancel, "hedge": None}

        def leg_done(which: str, f: Future) -> None:
            loser_cancel = None
            with lock:
                won = state["won"] is None
                if won:
                    state["won"] = which
                    other = "hedge" if which == "primary" else "primary"
                    loser_cancel = cancels.get(other)
                hedged = state["hedged"]
            if not won:
                # the losing leg: meter a CONFIRMED cancellation
                if isinstance(f.exception(), RequestCancelledError):
                    self._c_hedge_cancelled.inc(model=model)
                return
            self._chain_once(f, outer)
            if hedged:
                self._c_hedged.inc(model=model, won=which)
            if loser_cancel is not None:
                loser_cancel()

        fut.add_done_callback(lambda f: leg_done("primary", f))

        def fire() -> None:
            if outer.done() or not self._running:
                return
            if self._pressure() > 0:
                return  # the fleet is shedding: no extra copies
            counts = self._hedge_counts.setdefault(model, [0, 0])
            if counts[1] + 1 > self.cfg.hedge_budget * counts[0]:
                return  # budget-capped: hedges can't melt the fleet
            try:
                rep2 = self._pick(model, exclude=rep)
            except Exception:
                return  # hedge target draining/down: primary stands alone
            try:
                # the hedge leg's child context is tagged leg=hedge —
                # the trace shows exactly which copy of the work each
                # span belongs to, and which leg won
                leg2 = (trace.child(leg="hedge")
                        if trace is not None else None)
                fut2, cancel2 = self._issue(rep2, model, payload,
                                            deadline_s, priority,
                                            trace=leg2)
            except Exception:
                return  # a refused hedge leg must never hurt the primary
            counts[1] += 1
            self._c_routed.inc(model=model, replica=rep2.name)
            with lock:
                state["hedged"] = True
                cancels["hedge"] = cancel2
                won = state["won"]
            if won is not None:
                cancel2()  # primary won while the leg was being issued
            fut2.add_done_callback(lambda f: leg_done("hedge", f))

        lat = self._ensure_latency(model)
        delay = lat.windowed_quantile(self.cfg.hedge_quantile,
                                      self.cfg.hedge_window_s)
        delay = max(delay or 0.0, self.cfg.hedge_min_delay_ms / 1e3)
        self._hedge_schedule(time.monotonic() + delay, fire)
        return outer

    def _hedge_schedule(self, fire_t: float,
                        fn: Callable[[], None]) -> None:
        with self._hedge_cv:
            heapq.heappush(self._hedge_heap,
                           (fire_t, next(self._hedge_seq), fn))
            self._hedge_cv.notify()

    def _hedge_run(self) -> None:
        """The one scheduler thread: pops due hedge decisions off the
        time heap. Decisions are cheap (a pick + an issue), so one
        thread keeps up with any request rate the pool itself survives."""
        while True:
            with self._hedge_cv:
                if not self._running:
                    return
                now = time.monotonic()
                if not self._hedge_heap:
                    self._hedge_cv.wait(timeout=0.5)
                    continue
                fire_t = self._hedge_heap[0][0]
                if fire_t > now:
                    self._hedge_cv.wait(timeout=min(fire_t - now, 0.5))
                    continue
                _, _, fn = heapq.heappop(self._hedge_heap)
            try:
                fn()
            except Exception:
                pass  # a failed hedge decision never takes routing down

    @staticmethod
    def _chain_once(src: Future, dst: Future) -> None:
        """_chain, tolerant of a concurrently-resolved destination (the
        hedging first-wins path)."""
        try:
            exc = src.exception()
            if exc is not None:
                dst.set_exception(exc)
            else:
                _copy_reply_meta(src, dst)
                dst.set_result(src.result())
        except InvalidStateError:
            pass

    def infer(self, model: str, payload: Dict[str, Any],
              timeout: float = 30.0) -> Dict[str, Any]:
        """The timeout IS the request deadline (InferenceServer.infer
        semantics): the wait gets a small grace past it so the shed
        lands as its honest DeadlineExpiredError — the batcher (or a
        remote replica's 503) resolves the future moments after expiry,
        and a bare futures TimeoutError still bounds a wedged worker."""
        fut = self.submit(model, payload, deadline_s=timeout)
        return fut.result(timeout=timeout + 5.0)

    def _proxy_call(self, rep: Replica, model: str,
                    payload: Dict[str, Any],
                    deadline_s: Optional[float], fut: Future,
                    retried: bool = False,
                    cancel_box: Optional[Dict[str, Any]] = None,
                    priority: Optional[str] = None,
                    trace=None) -> None:
        meta: Dict[str, Any] = {}
        try:
            if rep.transport == "binary":
                from .binary_frontend import binary_infer  # cycle guard
                out = binary_infer(rep.url, model, payload,
                                   deadline_s=deadline_s,
                                   priority=priority,
                                   cancel_box=cancel_box,
                                   trace=trace, meta=meta)
            else:
                from .http_frontend import http_infer  # cycle guard
                out = http_infer(rep.url, model, payload,
                                 deadline_s=deadline_s,
                                 priority=priority, trace=trace,
                                 meta=meta)
            # the remote replica's served step and queue wait, as a local
            # lane stamps them on its batcher futures
            qw, step = meta.get("queue_wait_ms"), meta.get("step")
            fut._spkn_step = None if step is None or step < 0 else step
            fut._spkn_queue_wait_s = None if qw is None else qw / 1e3
            fut.set_result(out)
        except RequestCancelledError as e:
            fut.set_exception(e)  # a hedge loser's confirmed cancel —
            #                       never a failover (nothing failed)
        except ConnectionError as e:
            # the replica refused/reset at the transport level (a kill
            # -9'd process does this long before its heartbeat goes
            # stale): demote it and fail the request OVER to another
            # replica, once — the detection window of a dying replica
            # costs a retry, not a dropped response. (Timeouts do NOT
            # failover: a slow server already did the work.)
            rep.note_failure()
            if retried or not self._running:
                fut.set_exception(e)
                return
            self._c_failovers.inc(model=model, replica=rep.name)
            try:
                rep2 = self._pick(model, exclude=rep)
            except Exception:
                fut.set_exception(e)  # nowhere to fail over to
                return
            self._c_routed.inc(model=model, replica=rep2.name)
            if rep2.lane is not None:
                try:
                    f2 = rep2.lane.submit(payload, deadline_s=deadline_s,
                                          priority=priority, trace=trace)
                except Exception as e2:
                    fut.set_exception(e2)
                    return
                f2.add_done_callback(lambda f: self._chain(f, fut))
            else:
                self._proxy_call(rep2, model, payload, deadline_s, fut,
                                 retried=True, cancel_box=cancel_box,
                                 priority=priority, trace=trace)
        except Exception as e:
            fut.set_exception(e)

    @staticmethod
    def _chain(src: Future, dst: Future) -> None:
        if dst.done():
            return
        exc = src.exception()
        if exc is not None:
            dst.set_exception(exc)
        else:
            _copy_reply_meta(src, dst)
            dst.set_result(src.result())

    def drain(self, model: str, replica: str) -> Replica:
        """Operator drain by replica name (or bare 'local:<model>' /
        url). In-flight and already-queued work still completes."""
        for r in self.replicas.get(model, []):
            if r.name == replica or r.url == replica:
                r.drain()
                self._c_drains.inc(model=model, replica=r.name)
                if self.log is not None:
                    self.log.log(f"serve: draining {model}/{r.name}")
                return r
        raise UnknownModelError(f"{model}/{replica}")

    # -- the shared worker pool ----------------------------------------------

    def _wake(self) -> None:
        with self._wakeup:
            self._wakeup.notify_all()

    def _rotation(self) -> List[str]:
        """Lane order rotated per call: under contention every lane gets
        first-look equally often (no fixed-priority starvation)."""
        self._rot = (self._rot + 1) % max(len(self._order), 1)
        return self._order[self._rot:] + self._order[:self._rot]

    def _pool_run(self, idx: int = 0) -> None:
        duty = min([l._duty_s for l in self.lanes.values()] or [1.0])
        next_duty = 0.0
        while self._running and idx < self._pool_target:
            progressed = False
            for name in self._rotation():
                lane = self.lanes[name]
                if not lane.batcher.depth():
                    continue
                if not lane.lane_lock.acquire(blocking=False):
                    continue  # another pool thread is driving this lane
                try:
                    progressed |= bool(
                        lane.serve_tick(wake_at=time.perf_counter()))
                finally:
                    lane.lane_lock.release()
            # periodic duties run on their own TIME-GATED cadence, not
            # only on idle sweeps: under sustained traffic to one lane
            # the others must still hot-reload poll / tick liveness, and
            # the router heartbeat must keep beating (a busy router that
            # reads as dead gets drained by its peers — exactly wrong)
            now = time.monotonic()
            if now >= next_duty:
                next_duty = now + duty
                for name in self._rotation():
                    lane = self.lanes[name]
                    if lane.lane_lock.acquire(blocking=False):
                        try:
                            lane.duty_tick()
                        finally:
                            lane.lane_lock.release()
                self._update_replica_gauges()
                self._beat()
            if progressed:
                continue
            # no progress this sweep: park until a submit notifies or
            # the duty alarm. With queued work owned by ANOTHER pool
            # thread (its lane_lock held through the batch-open park and
            # forward), a short bounded nap paces the recheck — nothing
            # notifies on lock release, and spinning on try-acquire
            # would burn a core for the whole busy period
            with self._wakeup:
                if not self._running:
                    break
                busy = any(l.batcher.depth()
                           for l in self.lanes.values())
                self._wakeup.wait(timeout=0.002 if busy else duty)

    # -- status / heartbeat --------------------------------------------------

    def _max_step(self) -> int:
        steps = [l.manager.step for l in self.lanes.values()
                 if l.manager.step is not None]
        return max(steps) if steps else 0

    def _swap_failures(self) -> int:
        return sum(l.manager.swap_failures for l in self.lanes.values())

    def _model_rows(self) -> Dict[str, Any]:
        return {name: lane.model_row()
                for name, lane in self.lanes.items()}

    def _beat(self) -> None:
        if self.heartbeat is None:
            return
        degraded = any(l.manager.last_error for l in self.lanes.values())
        try:
            self.heartbeat.beat(self._max_step(),
                                status="degraded" if degraded else "ok",
                                rollbacks=self._swap_failures(),
                                models=self._model_rows())
        except OSError:
            pass  # observability must not take serving down

    def _healthz(self):
        ok = self._running and all(l.healthy()
                                   for l in self.lanes.values())
        return ok, {"models": sorted(self.lanes),
                    "queue_depth": {n: l.batcher.depth()
                                    for n, l in self.lanes.items()}}

    def healthy(self) -> bool:
        return self._healthz()[0]

    def status(self) -> Dict[str, Any]:
        """/status JSON: per-model lane vitals + replica sets. The
        `models` key is the same compact-row schema single-model servers
        emit, so /pod/status renders per-model rows either way."""
        out: Dict[str, Any] = {
            "role": "serve",
            "router": True,
            "pool_workers": self.pool_size(),
            "pool_target": self._pool_target,
            # train->serve staleness at a glance (full per-model rows —
            # model_step, step_lag — live under "models")
            "freshness_s": {n: l.manager.freshness_s()
                            for n, l in self.lanes.items()},
            "models": self._model_rows(),
            "lanes": {n: lane.status() for n, lane in self.lanes.items()},
            "replicas": {m: [r.as_dict() for r in reps]
                         for m, reps in self.replicas.items()},
            "routed_latency": {m: s.summary()
                               for m, s in self.latency.items()},
            "hedging": {m: {"routed": c[0], "hedged": c[1]}
                        for m, c in self._hedge_counts.items()},
            "autoscale": self.fleet is not None,
        }
        if self.alerter is not None:
            out["slo"] = self.alerter.summary()
        rt = reqtrace.active()
        if rt is not None:
            ex = rt.exemplars()
            if ex:
                out["slow_requests"] = ex
            out["reqtrace"] = rt.stats()
        return out

    @property
    def status_address(self):
        return None if self._http is None else self._http.address
