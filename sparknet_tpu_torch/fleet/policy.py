"""Decision logic for the fleet control plane: signals in, verdicts out.

A copy of `sparknet_tpu/fleet/policy.py` (pure Python): the port imports
nothing of the JAX package.

The controller (fleet/controller.py) OWNS the loop — gathering signals,
driving the router and the replica provider, bookkeeping cooldowns. This
module owns the POLICY: pure functions of the signals, so every
threshold is unit-testable without a router, a thread, or a clock.

Signals per model (`ModelSignals`), all from meters the obs stack
already exports:

  - `p99_ms` / `slo_p99_ms`: the router-vantage end-to-end p99 over a
    TIME-sliding window (utils/metrics.LatencyStats.windowed) against
    the model's objective (`--slo-p99-ms`). Their ratio is the **SLO
    burn** — burn 1.0 = exactly at objective, 2.0 = tail twice the
    objective. Quiet models (fewer than `min_window_n` observations)
    read as burn 0: an autoscaler must never act on a three-request
    p99.
  - `queue_frac`: local lane queue depth / max_queue — the leading
    indicator (the queue fills before the tail degrades).
  - `shed_per_s`: deadline/backpressure sheds per second — the trailing
    indicator (by the time requests shed, capacity is already gone).

Two levers, two speeds:

  - **fast** — admission pressure (`pressure_from_burn`): a [0, 1]
    overload level the controller pushes into `PriorityAdmission` every
    tick. Pressure starts rising at `pressure_start` burn and saturates
    at `pressure_full`; under it, low-priority traffic sheds first and
    every tenant's refill tightens (serve/admission.py).
  - **slow** — replicas (`hot_reason` / `is_cold` + the controller's
    hysteresis): `up_ticks` consecutive hot ticks grow the fleet,
    `down_ticks` consecutive cold ticks shrink it, bounded by the
    per-model min/max and the up/down cooldowns — a burst can tighten
    admission instantly but cannot flap replicas.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelSignals:
    """One model's control inputs for one tick (controller-gathered)."""

    model: str
    p99_ms: Optional[float]         # windowed router-vantage p99
    slo_p99_ms: Optional[float]     # the objective (None = no SLO)
    n_window: int                   # observations inside the window
    queue_frac: float               # lane queue depth / max_queue
    shed_per_s: float               # sheds per second since last tick
    replicas: int                   # registered replicas (incl. local)
    routable: int                   # currently routable replicas
    # scavenger (batch-tenant) pressure: the fraction of the queue that
    # is low-priority work, and how long the low class has been
    # continuously admission-shed. Low backlog must never read as
    # online demand (the autoscaler would grow the fleet to chase work
    # that exists precisely to soak SLACK) — but neither may pressure
    # pin the door shut on it forever.
    low_queue_frac: float = 0.0
    batch_starvation_s: float = 0.0


def slo_burn(p99_ms: Optional[float],
             slo_p99_ms: Optional[float]) -> float:
    """Observed p99 / objective. 0.0 when either side is unknown: a
    model with no SLO (or no traffic) must read as NOT burning — the
    controller's other signals (queue, shed) still cover it."""
    if p99_ms is None or not slo_p99_ms or slo_p99_ms <= 0:
        return 0.0
    return float(p99_ms) / float(slo_p99_ms)


@dataclass
class FleetPolicy:
    """Thresholds + hysteresis shape (the `sparknet-serve --autoscale`
    CLI and FleetConfig carry these)."""

    # slow lever: replica scale-up triggers (any one suffices)
    burn_up: float = 1.0            # SLO burn at/over this = hot
    queue_high: float = 0.5         # lane queue fraction = hot
    shed_high_per_s: float = 1.0    # sheds/sec = hot
    # scale-down gate (ALL must hold)
    burn_down: float = 0.7          # burn strictly under this = cool
    queue_low: float = 0.1
    # ignore the p99 of a near-empty window (a three-request tail is
    # noise, not a signal)
    min_window_n: int = 16
    # hysteresis: consecutive ticks required before acting
    up_ticks: int = 2
    down_ticks: int = 5
    # fast lever: admission pressure ramps linearly from 0 at
    # pressure_start burn to 1 at pressure_full burn
    pressure_start: float = 1.0
    pressure_full: float = 2.0
    # rollout duty (fleet/rollout.py): staggered checkpoint adoption.
    # After the canary, at most rollout_wave_size replicas swap per
    # wave; a wave only opens while SLO burn sits under
    # rollout_halt_burn, and a phase that hasn't fully adopted within
    # rollout_timeout_s halts the rollout (deny + revert).
    rollout_wave_size: int = 2
    rollout_halt_burn: float = 1.5
    rollout_timeout_s: float = 30.0
    # scavenger coexistence: the low class may be pressure-starved for
    # at most batch_max_starvation_s; past that the controller clamps
    # admission pressure to batch_relief_pressure (just UNDER low's
    # default shed threshold, 0.5) until scavenger traffic flows again.
    # Online work still outranks batch at every queue and bucket — the
    # relief only stops the door being welded shut.
    batch_max_starvation_s: float = 60.0
    batch_relief_pressure: float = 0.45

    def __post_init__(self) -> None:
        # fail at construction, not mid-control-loop (the ElasticConfig
        # rule)
        if self.burn_up <= 0 or self.burn_down <= 0:
            raise ValueError(f"burn thresholds must be > 0 (got "
                             f"up={self.burn_up} down={self.burn_down})")
        if self.burn_down >= self.burn_up:
            raise ValueError(
                f"burn_down ({self.burn_down}) must sit strictly below "
                f"burn_up ({self.burn_up}) — equal thresholds flap")
        if not 0 < self.queue_low < self.queue_high <= 1.0:
            raise ValueError(
                f"need 0 < queue_low < queue_high <= 1 (got "
                f"{self.queue_low}, {self.queue_high})")
        if self.up_ticks < 1 or self.down_ticks < 1:
            raise ValueError("up_ticks/down_ticks must be >= 1")
        if self.pressure_full <= self.pressure_start:
            raise ValueError(
                f"pressure_full ({self.pressure_full}) must exceed "
                f"pressure_start ({self.pressure_start})")
        if self.rollout_wave_size < 1:
            raise ValueError(f"rollout_wave_size must be >= 1 (got "
                             f"{self.rollout_wave_size})")
        if self.rollout_halt_burn <= 0 or self.rollout_timeout_s <= 0:
            raise ValueError(
                f"rollout_halt_burn/rollout_timeout_s must be > 0 (got "
                f"{self.rollout_halt_burn}, {self.rollout_timeout_s})")
        if self.batch_max_starvation_s <= 0:
            raise ValueError(f"batch_max_starvation_s must be > 0 (got "
                             f"{self.batch_max_starvation_s})")
        if not 0.0 <= self.batch_relief_pressure < 1.0:
            raise ValueError(
                f"batch_relief_pressure must be in [0, 1) (got "
                f"{self.batch_relief_pressure})")

    # -- signal -> verdict ---------------------------------------------------

    def burn(self, sig: ModelSignals) -> float:
        """This model's SLO burn, window-size gated."""
        if sig.n_window < self.min_window_n:
            return 0.0
        return slo_burn(sig.p99_ms, sig.slo_p99_ms)

    def pressure_from_burn(self, burn: float) -> float:
        """Admission pressure in [0, 1] (the fast lever's setting)."""
        span = self.pressure_full - self.pressure_start
        return min(1.0, max(0.0, (burn - self.pressure_start) / span))

    @staticmethod
    def online_queue_frac(sig: ModelSignals) -> float:
        """Queue fraction attributable to ONLINE (non-low) work. The
        scale verdicts read this, not the raw fraction: a scavenger job
        keeping the queue full of low-priority units is soaking slack,
        not demanding capacity."""
        return max(0.0, sig.queue_frac - sig.low_queue_frac)

    def hot_reason(self, sig: ModelSignals) -> Optional[str]:
        """The scale-up trigger that fired, or None. Named because the
        reason lands in `fleet_scale_events_total{reason}` and the audit
        trail — "the fleet grew" is not actionable, "it grew because
        shed_rate" is."""
        if self.burn(sig) >= self.burn_up:
            return "slo_burn"
        if self.online_queue_frac(sig) >= self.queue_high:
            return "queue"
        if sig.shed_per_s >= self.shed_high_per_s:
            return "shed"
        return None

    def is_cold(self, sig: ModelSignals) -> bool:
        """Quiet enough to consider giving a replica back: below every
        hot trigger with margin. (An UNKNOWN p99 — idle model — is cold:
        idleness is exactly when shrink should happen. A queue full of
        scavenger units does NOT hold replicas: only online depth
        counts, same as hot_reason.)"""
        burn = self.burn(sig)
        return (burn < self.burn_down
                and self.online_queue_frac(sig) < self.queue_low
                and sig.shed_per_s < self.shed_high_per_s / 2.0)

    def batch_relief(self, starvation_s: float, pressure: float) -> bool:
        """True when admission pressure should be clamped to
        batch_relief_pressure this tick: the low class has been starved
        past the bound AND the computed pressure would keep shedding it."""
        return (starvation_s >= self.batch_max_starvation_s
                and pressure > self.batch_relief_pressure)
