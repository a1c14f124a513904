"""Per-tenant, priority-aware admission control AHEAD of the queue.

A copy of `sparknet_tpu/serve/admission.py` (pure Python): the port
imports nothing of the JAX package. The HTTP frontend
(`serve/http_frontend.py`) reads the door; the binary wire and the fleet
controller that sets `pressure` arrive with ROADMAP A10.

The 429 path (QueueFullError backpressure) is capacity-fair, not
CLIENT-fair: one hot tenant can keep the queue at its cap and starve
every quiet tenant into 429s. This module sits in the frontends — HTTP
reads `X-Tenant` / `X-Priority` headers, the binary wire carries tenant
and priority fields in the request frame — and answers the flood BEFORE
it occupies queue slots: each tenant owns a token bucket (`rate_rps`
steady, `burst` depth), and a request that finds its tenant's bucket
empty is shed typed (`tenant_limit`, HTTP 429 / binary error frame 429)
and counted on `sparknet_serve_shed_total{model,reason="tenant_limit"}`
— the same family the batcher's deadline sheds ride, so one scrape
shows who is shedding whom and why.

Requests with no tenant share the "" bucket (an anonymous flood must
not out-compete named tenants by dropping the header). The tracked-
tenant table is bounded: past `max_tenants`, the stalest bucket is
evicted — an eviction forgives at most one burst, it never grows
memory without bound under a tenant-id spray. An evicted tenant that
RETURNS gets a fresh full burst (its bucket is rebuilt at its own
burst depth), never a stale empty one.

`PriorityAdmission` is the fleet control plane's FAST lever
(fleet/controller.py sets `pressure` each tick from SLO burn): requests
carry a priority class (high / normal / low; unknown or absent reads as
normal), per-tenant budgets are WEIGHTED (`weights[tenant]` scales both
rate and burst), and under pressure the admission tightens dynamically
— low-priority traffic sheds FIRST (typed `priority`, counted as
`shed_total{reason="priority"}`) and every tenant's refill rate
throttles toward `rate_floor`, so the door closes smoothly from the
bottom of the priority ladder up while replicas (the slow lever) grow.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional

from .batcher import QueueFullError

#: priority classes, most- to least-important. Requests name them via
#: the X-Priority header / the binary frame's priority field; anything
#: unrecognized (or absent) is "normal" — a typo'd class must degrade to
#: the default, never crash the door or jump the queue.
PRIORITIES = ("high", "normal", "low")

#: default pressure thresholds at which each class sheds ("priority"
#: reason): low gives way first, normal under sustained burn, high only
#: at the explicit cap (inf = never admission-shed by pressure; the
#: queue's own 429 still bounds it).
DEFAULT_SHED_AT = {"high": math.inf, "normal": 0.9, "low": 0.5}


def parse_priority(value: Optional[str]) -> str:
    """Header/frame string -> a canonical priority class name."""
    v = (value or "").strip().lower()
    return v if v in PRIORITIES else "normal"


class TenantLimitError(QueueFullError):
    """This tenant's token bucket is empty — shed ahead of the queue
    (HTTP 429 / binary error frame, error_kind "tenant_limit"). A
    QueueFullError subclass: clients that already back off on 429 keep
    working unchanged."""


class PriorityShedError(QueueFullError):
    """Shed by priority class under admission pressure (HTTP 429 /
    binary error frame, error_kind "priority"): the fleet controller
    tightened the door and this request's class is below the cutoff.
    Low-priority traffic gives way first; retrying after Retry-After
    (or re-submitting at a higher class) is the intended response."""


class _Bucket:
    __slots__ = ("tokens", "t")

    def __init__(self, tokens: float, t: float):
        self.tokens = tokens
        self.t = t


class TenantAdmission:
    """Token-bucket admission keyed on tenant id (header / frame field).

    `allow(tenant)` refills that tenant's bucket at `rate_rps` up to
    `burst`, then spends one token — False means shed. Thread-safe (the
    frontends call it from accept threads / io loops concurrently).
    `admit(tenant, priority)` is the uniform frontend surface: None
    when admitted, else the shed-reason string (`"tenant_limit"` here;
    the PriorityAdmission subclass adds `"priority"`). `rate_rps=None`
    disables tenant buckets entirely (the priority-only door)."""

    def __init__(self, rate_rps: Optional[float],
                 burst: Optional[float] = None,
                 max_tenants: int = 4096):
        if rate_rps is not None and rate_rps <= 0:
            raise ValueError(f"tenant rate must be > 0 (got {rate_rps})")
        self.rate_rps = None if rate_rps is None else float(rate_rps)
        self.burst = float(burst if burst is not None
                           else max(2.0 * (rate_rps or 0.0), 1.0))
        if self.burst < 1.0:
            raise ValueError(f"burst must be >= 1 (got {self.burst})")
        self.max_tenants = int(max_tenants)
        self._buckets: Dict[str, _Bucket] = {}
        self._lock = threading.Lock()
        self.shed = 0  # lifetime admission sheds (all tenants/reasons)

    # -- per-tenant knobs (PriorityAdmission overrides) ----------------------

    def _rate_for(self, key: str) -> float:
        """This tenant's CURRENT refill rate (tokens/sec)."""
        return self.rate_rps or 0.0

    def _burst_for(self, key: str) -> float:
        """This tenant's bucket depth. Every cap in allow() uses the
        PER-TENANT depth — a weighted tenant's refill must saturate at
        ITS burst, and a fresh (or evicted-then-returning) tenant's
        bucket starts at ITS full depth, not the base one."""
        return self.burst

    def allow(self, tenant: Optional[str]) -> bool:
        if self.rate_rps is None:
            return True  # no tenant budgets configured
        key = tenant or ""
        now = time.monotonic()
        with self._lock:
            # pop + reinsert keeps dict order == recency order, so
            # eviction is O(1) next(iter(...)) — a tenant-id SPRAY (the
            # attack max_tenants bounds) must not turn each allow()
            # into a full-table scan under the shared lock
            b = self._buckets.pop(key, None)
            if b is None:
                if len(self._buckets) >= self.max_tenants:
                    # evict the least-recently-seen bucket (bounded
                    # memory; the evictee regains at most one burst)
                    del self._buckets[next(iter(self._buckets))]
                b = _Bucket(self._burst_for(key), now)
            else:
                b.tokens = min(self._burst_for(key),
                               b.tokens + (now - b.t) * self._rate_for(key))
                b.t = now
            self._buckets[key] = b
            if b.tokens >= 1.0:
                b.tokens -= 1.0
                return True
            self.shed += 1
            return False

    def admit(self, tenant: Optional[str],
              priority: Optional[str] = None) -> Optional[str]:
        """None = admitted; else the shed reason ("tenant_limit").
        The base class ignores `priority` (no pressure machinery)."""
        return None if self.allow(tenant) else "tenant_limit"

    def tracked_tenants(self) -> int:
        with self._lock:
            return len(self._buckets)

    def snapshot(self) -> Dict[str, float]:
        """{tenant: tokens} — a consistent copy (status/debugging)."""
        with self._lock:
            return {k: b.tokens for k, b in self._buckets.items()}


class PriorityAdmission(TenantAdmission):
    """The fleet-aware door: priority classes + weighted tenant budgets
    + pressure-driven tightening (module doc).

    `pressure` is a dimensionless overload level in [0, 1] set by the
    fleet controller each tick (policy.pressure_from_burn maps SLO burn
    onto it; 0 with no controller attached — the class/weight machinery
    still works statically). Under pressure:

      - a request whose class's `shed_at` threshold is <= pressure is
        shed with reason "priority" BEFORE any bucket is touched (the
        cheapest possible no);
      - every tenant's refill rate is throttled by
        `max(rate_floor, 1 - tighten * pressure)` — the whole door
        narrows, not just the bottom class.

    `weights[tenant]` scales that tenant's rate AND burst (a weight-2
    tenant owns twice the steady rate and twice the depth); unknown
    tenants get `default_weight`."""

    def __init__(self, rate_rps: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_tenants: int = 4096,
                 weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0,
                 shed_at: Optional[Dict[str, float]] = None,
                 tighten: float = 0.8, rate_floor: float = 0.1):
        super().__init__(rate_rps, burst, max_tenants)
        self.weights = {str(k): float(v)
                        for k, v in (weights or {}).items()}
        if any(w <= 0 for w in self.weights.values()):
            raise ValueError(f"tenant weights must be > 0 "
                             f"(got {self.weights})")
        self.default_weight = float(default_weight)
        self.shed_at = dict(DEFAULT_SHED_AT)
        for k, v in (shed_at or {}).items():
            if k not in PRIORITIES:
                raise ValueError(f"unknown priority class {k!r} "
                                 f"(classes: {PRIORITIES})")
            self.shed_at[k] = float(v)
        if not 0.0 <= tighten <= 1.0:
            raise ValueError(f"tighten must be in [0, 1] (got {tighten})")
        if not 0.0 < rate_floor <= 1.0:
            raise ValueError(f"rate_floor must be in (0, 1] "
                             f"(got {rate_floor})")
        self.tighten = float(tighten)
        self.rate_floor = float(rate_floor)
        self.pressure = 0.0
        self.shed_priority = 0     # lifetime "priority" sheds
        self.shed_tenant_limit = 0
        # scavenger-starvation clock: monotonic time since the LAST
        # low-priority request was admitted while at least one has been
        # pressure-shed since — the fleet controller's batch_starvation_s
        # signal. None = low traffic is flowing (or none has been shed).
        self._low_starved_since: Optional[float] = None

    def set_pressure(self, p: float) -> None:
        """The fleet controller's fast lever (clamped to [0, 1])."""
        self.pressure = min(1.0, max(0.0, float(p)))

    def _weight(self, key: str) -> float:
        return self.weights.get(key, self.default_weight)

    def _rate_for(self, key: str) -> float:
        throttle = max(self.rate_floor,
                       1.0 - self.tighten * self.pressure)
        return (self.rate_rps or 0.0) * self._weight(key) * throttle

    def _burst_for(self, key: str) -> float:
        # depth scales with weight but NOT with pressure: tightening
        # slows the refill, it does not confiscate already-earned burst
        return self.burst * self._weight(key)

    def admit(self, tenant: Optional[str],
              priority: Optional[str] = None) -> Optional[str]:
        cls = parse_priority(priority)
        if self.pressure >= self.shed_at.get(cls, math.inf):
            with self._lock:
                self.shed += 1
                self.shed_priority += 1
                if cls == "low" and self._low_starved_since is None:
                    self._low_starved_since = time.monotonic()
            return "priority"
        if cls == "low":
            # a low request made it past the pressure gate: the
            # scavenger class is flowing again, whatever the tenant
            # bucket says next (tenant_limit is that tenant's own
            # budget, not class starvation)
            with self._lock:
                self._low_starved_since = None
        if self.rate_rps is None:
            return None
        if self.allow(tenant):
            return None
        with self._lock:
            self.shed_tenant_limit += 1
        return "tenant_limit"

    def starvation_s(self) -> float:
        """Seconds the "low" class has been continuously pressure-shed
        with nothing admitted — 0 while scavenger traffic flows. The
        fleet controller exports this as `batch_starvation_s` and
        relieves pressure when it exceeds the policy bound."""
        with self._lock:
            since = self._low_starved_since
        return 0.0 if since is None else max(0.0,
                                             time.monotonic() - since)

    def status(self) -> Dict[str, object]:
        """The /fleet/status admission row."""
        return {"pressure": round(self.pressure, 4),
                "rate_rps": self.rate_rps, "burst": self.burst,
                "tighten": self.tighten, "rate_floor": self.rate_floor,
                "shed_at": {k: (None if math.isinf(v) else v)
                            for k, v in self.shed_at.items()},
                "weights": dict(self.weights),
                "tracked_tenants": self.tracked_tenants(),
                "shed_priority": self.shed_priority,
                "shed_tenant_limit": self.shed_tenant_limit,
                "batch_starvation_s": round(self.starvation_s(), 3)}
