"""The fleet control plane: close the loop from serve signals to serve
actions.

A copy of `sparknet_tpu/fleet/controller.py` over the port's
`ModelRouter` (pure Python): the port imports nothing of the JAX
package. Its levers, audit rows, metric families and `/fleet/status`
body are the JAX controller's.

Every input already exists — per-model latency windows, queue depth,
shed counters, replica heartbeat health (the obs stack's exports) — but
without a controller nothing acts on them: a flood means an operator
watching /metrics. `FleetController` is the loop (SparkNet shipped
cluster provisioning as part of the framework; this is the
replica-controller analog over the serve stack):

  every `interval_s`, on its own thread:
    1. gather per-model signals (fleet/policy.ModelSignals) from the
       ModelRouter's meters;
    2. compute **SLO burn** (windowed p99 / objective) per model and
       push admission pressure into `PriorityAdmission` — the FAST
       lever: low-priority traffic sheds first, tenant refill tightens,
       within one tick of the burn appearing;
    3. drive the SLOW levers under hysteresis + cooldowns:
         - grow/retire remote replicas through a pluggable
           `ReplicaProvider` (serve children over spkn://; the
           pod-launcher stub), bounded by
           [min_replicas, max_replicas] per model. Scale-DOWN always
           drains first (router.drain — new routing gated, in-flight
           completes) and retires only after `drain_grace_s`: a shrink
           drops zero responses, pinned.
         - resize the router's shared worker pool within
           [pool_min, pool_max] (the in-process lane lever).
    4. replace dead replicas: a provider-owned replica whose process is
       gone (kill -9) or whose heartbeat probe stays false `dead_ticks`
       ticks is evicted from the router, retired, named in the audit
       trail, and regrown (reason="replace") — death is an incident,
       not a scale-down decision.

Observability: `sparknet_fleet_replicas{model}`,
`sparknet_fleet_slo_burn{model}`,
`sparknet_fleet_scale_events_total{model,direction,reason}`,
`sparknet_fleet_admission_pressure`, a bounded audit deque served at
`/fleet/status` (the router's StatusServer), and `event="fleet_scale"`
JSONL rows + periodic `fleet_replicas` rows (the JAX package's
`sparknet-metrics` fleet view reads them).

`tick()` is public and thread-free: tests drive the whole control law
deterministically by feeding the router's meters and calling it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..utils.heartbeat import read_heartbeat
from ..utils.logger import Logger
from .policy import FleetPolicy, ModelSignals
from .provider import ReplicaHandle, ReplicaProvider
from .rollout import ReplicaView, RolloutManager


@dataclass
class FleetConfig:
    """Controller knobs (`sparknet-serve --autoscale` mirrors these)."""

    interval_s: float = 1.0         # control cadence
    window_s: float = 30.0          # the sliding p99 window (SLO burn)
    min_replicas: int = 1           # per model, local lane included
    max_replicas: int = 4
    # shared-pool bounds; None pool_min = the router's configured
    # workers, None pool_max = pool_min (pool lever off)
    pool_min: Optional[int] = None
    pool_max: Optional[int] = None
    drain_grace_s: float = 5.0      # drain -> retire gap on scale-down
    dead_ticks: int = 2             # consecutive failed health probes
    up_cooldown_s: float = 5.0      # min gap between grows (per model)
    down_cooldown_s: float = 20.0   # min gap between shrinks (per model)
    # fallback objective for lanes without ServeConfig.slo_p99_ms
    slo_p99_ms: Optional[float] = None
    # admission-pressure floor while a burn-rate PAGE is firing (the
    # SLO alerter, attach_alerter): the fast lever jumps ahead of the
    # slow replica lever the moment the ledger pages — never below what
    # the burn signal already asks for, and still subject to the batch-
    # starvation relief clamp
    page_pressure: float = 0.9
    replace_dead: bool = True
    status_row_every: int = 10      # fleet_replicas JSONL cadence, ticks
    policy: FleetPolicy = field(default_factory=FleetPolicy)

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError(f"interval_s must be > 0 "
                             f"(got {self.interval_s})")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas (got "
                f"{self.min_replicas}, {self.max_replicas})")
        if self.pool_min is not None and self.pool_min < 1:
            raise ValueError(f"pool_min must be >= 1 (got "
                             f"{self.pool_min})")
        if (self.pool_min is not None and self.pool_max is not None
                and self.pool_max < self.pool_min):
            raise ValueError(
                f"pool_max ({self.pool_max}) < pool_min "
                f"({self.pool_min})")
        if self.dead_ticks < 1:
            raise ValueError("dead_ticks must be >= 1")
        if not 0.0 <= self.page_pressure <= 1.0:
            raise ValueError(f"page_pressure must be in [0, 1] "
                             f"(got {self.page_pressure})")
        if isinstance(self.policy, dict):
            self.policy = FleetPolicy(**self.policy)


class _ModelState:
    __slots__ = ("hot", "cold", "last_up", "last_down", "burn")

    def __init__(self) -> None:
        self.hot = 0
        self.cold = 0
        self.last_up = -1e18
        self.last_down = -1e18
        self.burn = 0.0


class FleetController:
    """The control loop over one ModelRouter (module doc)."""

    def __init__(self, router, provider: Optional[ReplicaProvider] = None,
                 cfg: Optional[FleetConfig] = None,
                 admission=None, logger: Optional[Logger] = None):
        self.router = router
        self.provider = provider
        self.cfg = cfg = cfg if cfg is not None else FleetConfig()
        self.policy = cfg.policy
        self.admission = admission
        self.log = logger
        router.attach_fleet(self)
        self.registry = router.registry
        self._g_replicas = self.registry.gauge(
            "sparknet_fleet_replicas",
            "registered replicas per model (local lane included)",
            labels=("model",))
        self._g_burn = self.registry.gauge(
            "sparknet_fleet_slo_burn",
            "windowed p99 / slo_p99_ms per model (1.0 = at objective)",
            labels=("model",))
        self._c_events = self.registry.counter(
            "sparknet_fleet_scale_events_total",
            "fleet actions by model, direction (up/down/error) and "
            "reason (slo_burn/queue/shed/quiet/dead/replace/...)",
            labels=("model", "direction", "reason"))
        self._g_pressure = self.registry.gauge(
            "sparknet_fleet_admission_pressure",
            "the fast lever: [0,1] overload level pushed into "
            "priority admission each tick")
        self._g_pressure.set(0.0)
        self._g_starvation = self.registry.gauge(
            "sparknet_fleet_batch_starvation_s",
            "seconds the low (scavenger/batch) class has been "
            "continuously admission-shed with nothing admitted")
        self._g_starvation.set(0.0)
        self._batch_relieving = False  # audit edge detector
        # SLO burn-rate alerter (attach_alerter): firing pages escalate
        # the fast lever; edge-detected for the audit trail
        self.alerter = None
        self._page_escalating = False
        self._state: Dict[str, _ModelState] = {}
        # provider-grown replicas: model -> [(router Replica, handle)]
        self._owned: Dict[str, List[Tuple[Any, ReplicaHandle]]] = {}
        # draining replicas awaiting retire: (retire_at, model, rep,
        # handle)
        self._retiring: List[Tuple[float, str, Any,
                                   Optional[ReplicaHandle]]] = []
        self._unhealthy: Dict[Tuple[str, str], int] = {}
        self._prev_shed: Dict[str, float] = {}
        self._prev_tick_t: Optional[float] = None
        self._pool_hot = 0
        self._pool_cold = 0
        self._last_pool_t = -1e18
        self.pressure = 0.0
        self.ticks = 0
        self.scale_events = 0
        # rollout duty: one wave sequencer per model whose local lane
        # watches a checkpoint dir through a rollout gate (lazily built
        # on the first tick that sees such a lane)
        self._rollouts: Dict[str, RolloutManager] = {}
        self.audit: deque = deque(maxlen=200)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._tick_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetController":
        assert self._thread is None, "already started"
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="fleet-controller",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, retire_owned: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, 3 * self.cfg.interval_s))
            self._thread = None
        if retire_owned and self.provider is not None:
            # a tick may be mid-grow (a subprocess spawn blocks up to
            # spawn_timeout_s): wait a bounded moment for the graceful
            # drain-then-retire path, then fall back to provider.stop()
            # — terminating every child it owns needs no lock
            if self._tick_lock.acquire(timeout=10.0):
                try:
                    for _, model, rep, handle in self._retiring:
                        self._finish_retire(model, rep, handle)
                    self._retiring = []
                    for model, pairs in list(self._owned.items()):
                        for rep, handle in list(pairs):
                            try:
                                self.router.drain(model, rep.name)
                            except Exception:
                                pass
                            self._finish_retire(model, rep, handle)
                    self._owned = {}
                finally:
                    self._tick_lock.release()
            else:
                self._log("fleet: stop() could not take the tick lock "
                          "(grow in flight?); force-stopping the "
                          "provider")
            try:
                self.provider.stop()
            except Exception as e:
                self._log(f"fleet: provider stop failed: {e}")

    def attach_alerter(self, alerter) -> "FleetController":
        """Wire a `BurnRateAlerter`: its `firing_pages()` becomes a fast
        admission-pressure input each tick (cfg.page_pressure)."""
        self.alerter = alerter
        return self

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception as e:
                # the control loop must outlive any one bad tick — a
                # probe hiccup must not leave the fleet pilotless
                self._log(f"fleet: tick failed ({type(e).__name__}: "
                          f"{e}); continuing")

    # -- signals -------------------------------------------------------------

    def _models(self) -> List[str]:
        return sorted(set(self.router.lanes) | set(self.router.replicas))

    def _slo_for(self, model: str) -> Optional[float]:
        lane = self.router.lanes.get(model)
        if lane is not None and lane.cfg.slo_p99_ms is not None:
            return lane.cfg.slo_p99_ms
        return self.cfg.slo_p99_ms

    def _signals(self, model: str, dt_s: float) -> ModelSignals:
        lat = self.router.latency.get(model)
        win = (lat.windowed(self.cfg.window_s) if lat is not None
               else {"n": 0, "p99_ms": None})
        lane = self.router.lanes.get(model)
        queue_frac = 0.0
        low_queue_frac = 0.0
        shed_total = 0.0
        if lane is not None:
            queue_frac = lane.batcher.depth() / max(
                lane.cfg.max_queue, 1)
            low_queue_frac = lane.batcher.low_depth() / max(
                lane.cfg.max_queue, 1)
            shed_total = float(lane.batcher.shed)
            rej = self.registry.counter(
                "sparknet_serve_queue_rejected_total",
                labels=("model",)).value(model=model)
            shed_total += float(rej or 0.0)
        prev = self._prev_shed.get(model, shed_total)
        self._prev_shed[model] = shed_total
        # divided by ACTUAL elapsed time, not the configured cadence: a
        # tick delayed by a blocking grow accumulates a whole spawn's
        # worth of sheds, and interval_s in the denominator would read
        # that as a rate spike and cascade further grows
        shed_per_s = max(0.0, shed_total - prev) / max(dt_s, 1e-3)
        reps = self.router.replicas.get(model, [])
        routable = sum(1 for r in reps
                       if self.router._replica_routable(r))
        return ModelSignals(model=model, p99_ms=win["p99_ms"],
                            slo_p99_ms=self._slo_for(model),
                            n_window=int(win["n"]),
                            queue_frac=queue_frac,
                            shed_per_s=shed_per_s,
                            replicas=len(reps), routable=routable,
                            low_queue_frac=low_queue_frac,
                            batch_starvation_s=self._starvation_s())

    def _starvation_s(self) -> float:
        """How long the low class has been continuously pressure-shed
        at the attached admission door (0 without one)."""
        if self.admission is not None and \
                hasattr(self.admission, "starvation_s"):
            return float(self.admission.starvation_s())
        return 0.0

    # -- the control step ----------------------------------------------------

    def tick(self) -> Dict[str, ModelSignals]:
        """One control step (the loop calls this every interval; tests
        call it directly). Returns the signals it acted on."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> Dict[str, ModelSignals]:
        now = time.monotonic()
        dt_s = (now - self._prev_tick_t
                if self._prev_tick_t is not None else self.cfg.interval_s)
        self._prev_tick_t = now
        self.ticks += 1
        sigs: Dict[str, ModelSignals] = {}
        burn_max = 0.0
        for model in self._models():
            sig = self._signals(model, dt_s)
            sigs[model] = sig
            st = self._state.setdefault(model, _ModelState())
            st.burn = self.policy.burn(sig)
            burn_max = max(burn_max, st.burn)
            self._g_burn.set(round(st.burn, 4), model=model)
        # fast lever: admission pressure, every tick, no hysteresis —
        # shedding low-priority load is cheap and instantly reversible
        self.pressure = self.policy.pressure_from_burn(burn_max)
        # SLO page escalation: a firing burn-rate page floors the fast
        # lever at page_pressure IMMEDIATELY, ahead of the replica
        # lever's cooldowns — only admission, never the hysteresis-
        # guarded levers, and the batch-relief clamp below still wins
        pages = self.alerter.firing_pages() if self.alerter is not None \
            else []
        if pages and self.cfg.page_pressure > self.pressure:
            if not self._page_escalating:
                self._page_escalating = True
                self._event("_slo", "pressure", "slo_page",
                            models=",".join(pages),
                            pressure=round(self.pressure, 4),
                            escalated=self.cfg.page_pressure)
            self.pressure = self.cfg.page_pressure
        elif not pages:
            self._page_escalating = False
        # scavenger relief: sustained pressure must not weld the door
        # shut on the low class forever. Past the policy's starvation
        # bound the pressure is clamped just under low's shed threshold
        # for the tick — online traffic still outranks batch at every
        # queue, the door just stops being airtight.
        starvation = self._starvation_s()
        self._g_starvation.set(round(starvation, 3))
        if self.policy.batch_relief(starvation, self.pressure):
            if not self._batch_relieving:
                self._batch_relieving = True
                self._event("_batch", "relief", "batch_starvation",
                            starvation_s=round(starvation, 3),
                            pressure=round(self.pressure, 4),
                            clamped=self.policy.batch_relief_pressure)
            self.pressure = self.policy.batch_relief_pressure
        else:
            self._batch_relieving = False
        self._g_pressure.set(round(self.pressure, 4))
        if self.admission is not None and \
                hasattr(self.admission, "set_pressure"):
            self.admission.set_pressure(self.pressure)
        # slow levers
        self._process_retiring(now)
        if self.provider is not None:
            for model, sig in sigs.items():
                self._replace_dead(model, sig, now)
            for model, sig in sigs.items():
                self._scale_model(model, sigs[model], now)
        self._scale_pool(sigs, now)
        self._rollout_duty(sigs, now)
        # POST-action counts: the gauge a grow lands in shows the grown
        # fleet, not the pre-grow signal snapshot
        for model in sigs:
            self._g_replicas.set(
                len(self.router.replicas.get(model, [])), model=model)
        if self.log is not None and self.cfg.status_row_every and \
                self.ticks % self.cfg.status_row_every == 0:
            # post-action counts: the row a grow lands in shows the
            # grown fleet, not the pre-grow signal snapshot
            self.log.metrics(self.ticks, fleet_replicas={
                m: len(self.router.replicas.get(m, []))
                for m in sigs},
                fleet_pressure=round(self.pressure, 4))
        return sigs

    def _scale_model(self, model: str, sig: ModelSignals,
                     now: float) -> None:
        st = self._state[model]
        pending = sum(1 for _, m, _, _ in self._retiring if m == model)
        if (sig.replicas - pending < self.cfg.min_replicas
                and now - st.last_up >= self.cfg.up_cooldown_s):
            # the floor is not a load decision: below min_replicas the
            # fleet grows regardless of temperature (paced by the up
            # cooldown so a failing grow cannot hot-loop spawns)
            st.last_up = now
            self._grow(model, "min_bound")
            return
        reason = self.policy.hot_reason(sig)
        if reason is not None:
            st.hot += 1
            st.cold = 0
        else:
            st.hot = 0
            st.cold = st.cold + 1 if self.policy.is_cold(sig) else 0
        if (reason is not None and st.hot >= self.policy.up_ticks
                and sig.replicas < self.cfg.max_replicas
                and now - st.last_up >= self.cfg.up_cooldown_s):
            st.last_up = now
            st.hot = 0
            self._grow(model, reason)
        elif (st.cold >= self.policy.down_ticks and pending == 0
                and sig.replicas - pending > self.cfg.min_replicas
                and self._owned.get(model)
                and now - st.last_down >= self.cfg.down_cooldown_s):
            st.last_down = now
            st.cold = 0
            self._shrink(model, now)

    def _grow(self, model: str, reason: str) -> None:
        try:
            handle = self.provider.grow(model)
        except Exception as e:
            self._event(model, "error", "grow_failed", error=str(e))
            self._log(f"fleet: grow {model} failed: {e}")
            return
        rep = self.router.add_remote_replica(
            model, handle.url, heartbeat_path=handle.heartbeat_path)
        self._owned.setdefault(model, []).append((rep, handle))
        self._event(model, "up", reason, replica=rep.name,
                    replicas=len(self.router.replicas.get(model, [])))
        self._log(f"fleet: scaled {model} UP ({reason}) -> "
                  f"{handle.url}")

    def _shrink(self, model: str, now: float) -> None:
        pairs = self._owned.get(model, [])
        for rep, handle in reversed(pairs):  # LIFO: newest goes first
            if not rep.draining:
                self.router.drain(model, rep.name)
                self._retiring.append(
                    (now + self.cfg.drain_grace_s, model, rep, handle))
                self._event(model, "down", "quiet", replica=rep.name,
                            replicas=len(self.router.replicas.get(
                                model, [])) - 1)
                self._log(f"fleet: scaling {model} DOWN (quiet): "
                          f"draining {rep.name}")
                return

    def _process_retiring(self, now: float) -> None:
        due = [e for e in self._retiring if e[0] <= now]
        self._retiring = [e for e in self._retiring if e[0] > now]
        for _, model, rep, handle in due:
            self._finish_retire(model, rep, handle)

    def _finish_retire(self, model: str, rep, handle) -> None:
        try:
            self.router.remove_replica(model, rep.name)
        except Exception:
            pass  # already evicted (e.g. by the dead-replica path)
        pairs = self._owned.get(model, [])
        self._owned[model] = [p for p in pairs if p[0] is not rep]
        if handle is not None and self.provider is not None:
            try:
                self.provider.retire(handle)
            except Exception as e:
                self._log(f"fleet: retire of {rep.name} failed: {e}")

    def _replace_dead(self, model: str, sig: ModelSignals,
                      now: float) -> None:
        for rep, handle in list(self._owned.get(model, [])):
            if rep.draining:
                continue  # already on its way out
            key = (model, rep.name)
            proc_dead = not self.provider.alive(handle)
            probe_dead = False
            if rep.health_fn is not None:
                try:
                    probe_dead = not rep.health_fn()
                except Exception:
                    probe_dead = True
            if probe_dead or proc_dead:
                self._unhealthy[key] = self._unhealthy.get(key, 0) + 1
            else:
                self._unhealthy.pop(key, None)
                continue
            if not proc_dead and \
                    self._unhealthy[key] < self.cfg.dead_ticks:
                continue  # stale beat: give it dead_ticks to recover
            self._unhealthy.pop(key, None)
            cause = "process gone" if proc_dead else "stale heartbeat"
            self._event(model, "down", "dead", replica=rep.name,
                        proc_dead=proc_dead)
            self._log(f"fleet: replica {model}/{rep.name} is dead "
                      f"({cause}); evicting")
            self._finish_retire(model, rep, handle)
            if self.cfg.replace_dead and \
                    len(self.router.replicas.get(model, [])) < \
                    self.cfg.max_replicas:
                self._grow(model, "replace")

    def _scale_pool(self, sigs: Dict[str, ModelSignals],
                    now: float) -> None:
        pool_min = (self.cfg.pool_min
                    if self.cfg.pool_min is not None
                    else self.router.cfg.workers)
        pool_max = (self.cfg.pool_max
                    if self.cfg.pool_max is not None else pool_min)
        if pool_max <= pool_min:
            return  # lever off
        lanes = [s for m, s in sigs.items()
                 if m in self.router.lanes]
        hot = any(s.queue_frac >= self.policy.queue_high for s in lanes)
        quiet = all(s.queue_frac < self.policy.queue_low for s in lanes)
        target = self.router._pool_target
        if hot:
            self._pool_hot += 1
            self._pool_cold = 0
        elif quiet:
            self._pool_cold += 1
            self._pool_hot = 0
        else:
            self._pool_hot = self._pool_cold = 0
        if (self._pool_hot >= self.policy.up_ticks
                and target < pool_max
                and now - self._last_pool_t >= self.cfg.up_cooldown_s):
            self._last_pool_t = now
            self._pool_hot = 0
            self.router.set_pool_size(target + 1)
            self._event("_pool", "up", "queue", pool=target + 1)
        elif (self._pool_cold >= self.policy.down_ticks
                and target > pool_min
                and now - self._last_pool_t >=
                self.cfg.down_cooldown_s):
            self._last_pool_t = now
            self._pool_cold = 0
            self.router.set_pool_size(target - 1)
            self._event("_pool", "down", "quiet", pool=target - 1)

    # -- rollout duty --------------------------------------------------------

    def _rollout_duty(self, sigs: Dict[str, ModelSignals],
                      now: float) -> None:
        """Staggered checkpoint adoption (fleet/rollout.py): for each
        model whose LOCAL lane watches a checkpoint dir through a
        rollout gate, feed the sequencer this tick's adoption views —
        the lane's manager read directly (it doubles as the canary,
        first in the list), the provider-owned children through their
        heartbeats' per-model rows — plus the newest committed step and
        the model's SLO burn (the wave health gate)."""
        for model in sigs:
            lane = self.router.lanes.get(model)
            mgr = getattr(lane, "manager", None) if lane is not None \
                else None
            if mgr is None or not getattr(mgr, "rollout_gate", None) \
                    or not mgr.checkpoint_dir:
                continue
            ro = self._rollouts.get(model)
            if ro is None:
                ro = RolloutManager(
                    mgr.rollout_gate,
                    wave_size=self.policy.rollout_wave_size,
                    halt_burn=self.policy.rollout_halt_burn,
                    timeout_s=self.policy.rollout_timeout_s,
                    event=(lambda direction, reason, _m=model, **ex:
                           self._event(_m, direction, reason, **ex)),
                    logger=self.log)
                self._rollouts[model] = ro
            st = self._state.get(model)
            ro.tick(self._rollout_views(model, mgr), mgr.latest_seen,
                    st.burn if st else 0.0, now)

    def _rollout_views(self, model: str, mgr) -> List[ReplicaView]:
        views = [ReplicaView(mgr.replica, mgr.step, mgr.swap_failures)]
        for rep, handle in self._owned.get(model, []):
            key = (getattr(handle, "meta", None) or {}).get("tag",
                                                            rep.name)
            step = None
            rollbacks = 0
            hb = (read_heartbeat(handle.heartbeat_path)
                  if handle.heartbeat_path else None)
            if hb:
                row = (hb.get("models") or {}).get(model) or {}
                step = row.get("model_step", row.get("step"))
                rollbacks = int(row.get("swap_failures",
                                        hb.get("rollbacks", 0)) or 0)
            views.append(ReplicaView(key, step, rollbacks))
        return views

    # -- bookkeeping ---------------------------------------------------------

    def _event(self, model: str, direction: str, reason: str,
               **extra: Any) -> None:
        self.scale_events += 1
        self._c_events.inc(model=model, direction=direction,
                           reason=reason)
        entry = {"t": round(time.time(), 3), "tick": self.ticks,
                 "model": model, "direction": direction,
                 "reason": reason, **extra}
        self.audit.append(entry)
        if self.log is not None:
            # "t" stays out of the kv: Logger.metrics stamps its own
            # run-relative t (+ wall-clock ts) on every record, and the
            # audit entry's epoch t would clobber the timeline key
            kv = {k: v for k, v in entry.items()
                  if k not in ("tick", "t")}
            if "step" in kv:
                # rollout events carry the checkpoint step; Logger.metrics
                # reserves "step" for its positional (the tick counter)
                kv["ckpt_step"] = kv.pop("step")
            self.log.metrics(self.ticks, event="fleet_scale", **kv)

    def _log(self, msg: str) -> None:
        if self.log is not None:
            self.log.log(msg)

    def status(self) -> Dict[str, Any]:
        """The /fleet/status JSON. Taken WITHOUT the tick lock when a
        tick is in flight (a grow may block the loop for a subprocess
        spawn; the status endpoint must answer through it) — the reads
        are each individually consistent, the dict is best-effort."""
        locked = self._tick_lock.acquire(timeout=0.25)
        try:
            return self._status_inner()
        except RuntimeError:
            # unlocked read raced a tick's dict mutation: degrade, the
            # next scrape wins
            return {"enabled": True, "busy": True, "ticks": self.ticks}
        finally:
            if locked:
                self._tick_lock.release()

    def _status_inner(self) -> Dict[str, Any]:
        models: Dict[str, Any] = {}
        for model in self._models():
            st = self._state.get(model)
            lat = self.router.latency.get(model)
            win = (lat.windowed(self.cfg.window_s)
                   if lat is not None else {"n": 0, "p99_ms": None})
            reps = list(self.router.replicas.get(model, []))
            models[model] = {
                "replicas": len(reps),
                "routable": sum(
                    1 for r in reps
                    if self.router._replica_routable(r)),
                "owned": len(self._owned.get(model, [])),
                "min": self.cfg.min_replicas,
                "max": self.cfg.max_replicas,
                "slo_p99_ms": self._slo_for(model),
                "p99_ms": win["p99_ms"],
                "window_n": win["n"],
                "burn": round(st.burn, 4) if st else 0.0,
                "hot_ticks": st.hot if st else 0,
                "cold_ticks": st.cold if st else 0,
            }
        out = {
            "enabled": True,
            "running": self._thread is not None,
            "interval_s": self.cfg.interval_s,
            "window_s": self.cfg.window_s,
            "ticks": self.ticks,
            "pressure": round(self.pressure, 4),
            "batch_starvation_s": round(self._starvation_s(), 3),
            "provider": (type(self.provider).__name__
                         if self.provider is not None else None),
            "pool": {"size": self.router.pool_size(),
                     "target": self.router._pool_target,
                     "min": self.cfg.pool_min,
                     "max": self.cfg.pool_max},
            "models": models,
            "retiring": len(self._retiring),
            "scale_events": self.scale_events,
            "audit": list(self.audit)[-20:],
        }
        if self._rollouts:
            out["rollout"] = {m: ro.status()
                              for m, ro in self._rollouts.items()}
        if self.admission is not None and \
                hasattr(self.admission, "status"):
            out["admission"] = self.admission.status()
        return out
