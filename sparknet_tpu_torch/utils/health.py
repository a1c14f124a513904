"""Training health supervision: anomaly classification + recovery policy.

The reference's loop was `while(true)` with `task.maxFailures=1` (SURVEY
§5.3): a diverging or numerically-poisoned run had no answer — a NaN loss
sailed through the round, silently corrupted every replica via the
τ-averaging pmean (one bad worker poisons all after one sync), and was
checkpointed over the last good state until retention had deleted every
clean snapshot. Large-scale practice (PaLM's restart-and-skip response to
loss spikes; the local-SGD robustness line descending from the SparkNet
τ-averaging scheme) treats anomaly detection + rollback as a first-class
subsystem. This module is the host-side half:

  - `HealthConfig`   — the knobs (rolling window, MAD threshold, rollback
                       budget, LR backoff, deterministic fault injection).
  - `HealthMonitor`  — rolling ROBUST loss statistics (median + MAD over a
                       window of healthy rounds only), classifying each
                       round as ok / spike / nonfinite and deciding
                       skip-and-continue vs rollback.
  - `TrainingHealthError` — the loud hard-fail after `max_rollbacks`.

The device-side half lives in the trainer: `ParallelTrainer.train_round`
computes a global gradient norm and a per-worker nonfinite count and
all-reduces them with the round's other scalars.

A copy of `sparknet_tpu/utils/health.py` (pure Python): the port imports
nothing of the JAX package. The port's loop has no checkpoints yet, so it
uses the classification only and stops on a nonfinite round.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

OK = "ok"
SPIKE = "spike"
NONFINITE = "nonfinite"


class TrainingHealthError(RuntimeError):
    """Unrecoverable training-health failure (rollback budget exhausted, or
    recovery impossible — no verified checkpoint to roll back to)."""


@dataclass
class HealthConfig:
    """Knobs for the training health supervisor (RunConfig.health).

    Classification: a round is `nonfinite` when the on-device flag tripped
    (NaN/Inf in the loss, gradients, or post-round params anywhere on the
    mesh) and `spike` when its loss exceeds the rolling median by
    `spike_mad` robust sigmas (MAD * 1.4826) over a window of the last
    `window` HEALTHY rounds (spikes/nonfinites never enter the window, so
    one outlier cannot inflate the scale estimate and mask the next).

    Recovery (driven by the train loop): an isolated spike is skipped —
    logged, excluded from the statistics, training continues. `nonfinite`,
    or `spike_patience` consecutive spikes, triggers a rollback to the
    newest VERIFIED non-anomalous checkpoint with the learning rate scaled
    by `lr_backoff` and the retried rounds' data order advanced (round-keyed
    rngs make the retried window deterministic-but-different). After
    `max_rollbacks` rollbacks the run hard-fails loudly.
    """

    enabled: bool = True
    # rolling robust statistics
    window: int = 32            # healthy-loss window for median/MAD
    min_history: int = 8        # rounds of history before spikes classify
    spike_mad: float = 10.0     # spike threshold, in robust sigmas
    # recovery policy
    spike_patience: int = 3     # consecutive spikes that force a rollback
    max_rollbacks: int = 3      # hard-fail budget
    lr_backoff: float = 0.5     # lr multiplier applied per rollback (1.0 =
    #                             off; only trainers with supports_lr_scale)
    # deterministic fault injection (chaos tests): on the FIRST pass over
    # these rounds (rounds above the loop's high-water mark of executed
    # rounds) the prepared batch is poisoned — float inputs forced to NaN
    # (inject_nan_rounds) or scaled by inject_spike_scale
    # (inject_spike_rounds). Retried passes after a rollback are clean
    # while LATER configured rounds still fire, so the detect -> rollback
    # -> recover path is exercised without flakiness. Inert when
    # `enabled` is False.
    inject_nan_rounds: Tuple[int, ...] = ()
    inject_spike_rounds: Tuple[int, ...] = ()
    inject_spike_scale: float = 1e3

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "HealthConfig":
        import dataclasses
        known = {f.name for f in dataclasses.fields(HealthConfig)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown health config keys: {sorted(unknown)}")
        kw = dict(d)
        for k in ("inject_nan_rounds", "inject_spike_rounds"):
            if k in kw:
                kw[k] = tuple(kw[k])
        return HealthConfig(**kw)


def _is_finite(x: Optional[float]) -> bool:
    return x is None or math.isfinite(x)


class HealthMonitor:
    """Classifies flushed round metrics and drives the recovery decision.

    Purely host-side and deterministic: feed it the (round, loss,
    grad_norm, nonfinite_count) tuples in round order via `observe`; it
    returns the classification and latches `rollback_needed` when the
    policy demands one (consumed by the loop via `consume_rollback`).
    Multi-host safe by construction: the inputs are mesh-reduced scalars
    (identical on every process), so every process reaches the same
    decision without extra communication.
    """

    def __init__(self, cfg: HealthConfig, registry=None):
        self.cfg = cfg
        self._window: deque = deque(maxlen=max(2, cfg.window))
        self._consecutive_spikes = 0
        self._rollback_needed: Optional[str] = None  # reason, when latched
        self.last_anomaly_round: Optional[int] = None
        self.rollbacks = 0
        self.counts = {OK: 0, SPIKE: 0, NONFINITE: 0}
        # shared-schema telemetry (obs.MetricsRegistry): classification
        # counts and the rollback budget as scrapeable counters/gauges
        self._c_rounds = self._c_rollbacks = self._g_gnorm = None
        if registry is not None:
            self._c_rounds = registry.counter(
                "sparknet_health_rounds_total",
                "rounds by health classification", labels=("cls",))
            self._c_rollbacks = registry.counter(
                "sparknet_health_rollbacks_total",
                "recoveries consumed from the rollback budget")
            self._g_gnorm = registry.gauge(
                "sparknet_health_grad_norm",
                "last flushed global gradient norm")

    # -- rolling robust statistics -------------------------------------------

    def stats(self) -> Tuple[Optional[float], Optional[float]]:
        """(median, robust sigma = MAD * 1.4826) of the healthy window, or
        (None, None) with insufficient history."""
        n = len(self._window)
        if n < max(2, self.cfg.min_history):
            return None, None
        xs = sorted(self._window)
        med = _median(xs)
        mad = _median(sorted(abs(x - med) for x in xs))
        return med, 1.4826 * mad

    # -- classification + policy ---------------------------------------------

    def observe(self, rnd: int, loss: float,
                grad_norm: Optional[float] = None,
                nonfinite_count: float = 0.0) -> str:
        """Classify round `rnd` and update policy state. Returns
        'ok' | 'spike' | 'nonfinite'."""
        cls = OK
        if (nonfinite_count and nonfinite_count > 0) or not _is_finite(loss):
            cls = NONFINITE
        elif not _is_finite(grad_norm):
            # loss/params finite but the grad-norm scalar is not: either a
            # f32 overflow in the squared-norm accumulation (violent-but-
            # finite divergence) or a transient Inf gradient the update
            # absorbed. Not numerically poisoned state — classify as a
            # spike so the skip/patience policy applies, not as nonfinite
            # (the device flag over losses+params is the authority there).
            cls = SPIKE
        else:
            med, sigma = self.stats()
            # sigma floor at 1e-3 of the loss scale: a plateaued window
            # (many bit-identical losses -> MAD = 0) must not turn every
            # ordinary fluctuation above the median into a spike
            if med is not None and loss > med + self.cfg.spike_mad * max(
                    sigma, 1e-3 * max(abs(med), 1.0)):
                cls = SPIKE
        self.counts[cls] += 1
        if self._c_rounds is not None:
            self._c_rounds.inc(cls=cls)
            if grad_norm is not None and _is_finite(grad_norm):
                self._g_gnorm.set(grad_norm)
        if cls == OK:
            self._window.append(float(loss))
            self._consecutive_spikes = 0
        else:
            self.last_anomaly_round = rnd
            if cls == NONFINITE:
                self._rollback_needed = NONFINITE
            else:
                self._consecutive_spikes += 1
                if self._consecutive_spikes >= max(1, self.cfg.spike_patience):
                    self._rollback_needed = "repeated spikes"
        return cls

    @property
    def rollback_needed(self) -> Optional[str]:
        """Reason string when the policy wants a rollback, else None."""
        return self._rollback_needed

    def consume_rollback(self) -> str:
        """Acknowledge the latched rollback (the loop is about to perform
        it): counts it against the budget, resets the spike streak, and
        raises TrainingHealthError once the budget is exhausted."""
        reason = self._rollback_needed or "unknown"
        self._rollback_needed = None
        self._consecutive_spikes = 0
        # the restored state predates the anomaly: don't tag post-recovery
        # checkpoints anomalous for an incident that was rolled away
        self.last_anomaly_round = None
        self.rollbacks += 1
        if self._c_rollbacks is not None:
            self._c_rollbacks.inc()
        if self.rollbacks > max(0, self.cfg.max_rollbacks):
            raise TrainingHealthError(
                f"training health: rollback budget exhausted "
                f"({self.cfg.max_rollbacks} rollbacks) — last trigger: "
                f"{reason}; anomalies: {self.counts[SPIKE]} spikes, "
                f"{self.counts[NONFINITE]} nonfinite rounds. The run is "
                f"not recovering; inspect the data/lr before relaunching.")
        return reason

    def recently_anomalous(self, rnd: int) -> bool:
        """True when an anomaly was classified within the last `window`
        rounds — checkpoints taken here are tagged `anomalous` so rollback
        skips them (the state may embed the spike)."""
        return (self.last_anomaly_round is not None
                and rnd - self.last_anomaly_round < max(1, self.cfg.window))


def _median(xs) -> float:
    n = len(xs)
    m = n // 2
    return float(xs[m]) if n % 2 else 0.5 * (xs[m - 1] + xs[m])


def mad_classify(values, thresh_sigma: float = 5.0,
                 rel_floor: float = 0.25):
    """Median+MAD outlier flags over one cross-sectional sample — the same
    robust-sigma rule `HealthMonitor.observe` applies to its rolling loss
    window, packaged for the pod aggregator's per-worker round times and
    the summary tool's per-round skew audit.

    Returns (median, robust_sigma, [flag per value]): value i is flagged
    when it exceeds median + thresh_sigma * sigma, with sigma =
    MAD * 1.4826 floored at rel_floor * |median| — a degenerate MAD
    (identical values, the healthy-pod common case) must not turn
    measurement noise into straggler flags, and a zero median must not
    zero the floor (the max(|med|, tiny) guard). Fewer than 3 values
    returns all-False: with n == 2 both deviations EQUAL the MAD, so the
    rule mathematically cannot fire — callers wanting a 2-sample verdict
    need a ratio rule (see obs/pod.py) instead of a fake sigma.
    """
    xs = [float(v) for v in values]
    if len(xs) < 3:
        med = _median(sorted(xs)) if xs else 0.0
        return med, 0.0, [False] * len(xs)
    s = sorted(xs)
    med = _median(s)
    mad = _median(sorted(abs(x - med) for x in s))
    sigma = max(1.4826 * mad, rel_floor * max(abs(med), 1e-12))
    return med, sigma, [x > med + thresh_sigma * sigma for x in xs]


def liveness_classify(hb: Optional[Dict[str, Any]],
                      stale_after_s: float) -> str:
    """THE dead-vs-slow rule, shared by straggler naming (obs/pod.py), the
    elastic MembershipController, and anything probing a heartbeat dict
    (utils/heartbeat.read_heartbeat output — `age_s` is stamped at read
    time). One threshold, one vocabulary:

      "missing"  no readable heartbeat at all (file/object gone, torn,
                 or carrying no timestamp) — a candidate-dead worker
      "done"     the worker said goodbye (status "done"): a graceful
                 leave, not a failure
      "stale"    a beat exists but is older than `stale_after_s` — the
                 writer stopped writing: candidate-dead, subject to the
                 controller's re-probe policy (never evict on one look)
      "sick"     fresh beat, anomalous status (spike/nonfinite/rollback/
                 degraded): alive but unhealthy — a health-supervisor
                 problem, NOT a membership problem
      "ok"       fresh beat, healthy status — mere slowness shows up in
                 round_s/straggler attribution, never here

    A slow worker is "ok" here by construction: slowness is the straggler
    attributor's verdict (median+MAD over round_s), deadness is this
    one's, and conflating them is how pods evict their stragglers."""
    if hb is None:
        return "missing"
    status = str(hb.get("status", "ok"))
    if status == "done":
        return "done"
    age = hb.get("age_s")
    if age is None:
        try:
            age = max(0.0, time.time() - float(hb["t"]))
        except (KeyError, TypeError, ValueError):
            return "missing"
    if float(age) > float(stale_after_s):
        return "stale"
    if status in (SPIKE, NONFINITE, "rollback", "degraded"):
        return "sick"
    return "ok"


def poison_batch(batches: Dict[str, Any], mode: str,
                 scale: float = 1e3) -> Dict[str, Any]:
    """Deterministically poison one round's prepared batch (fault-injection
    hook): float arrays get NaN ('nan') or a *scale blowup ('spike');
    integer arrays (labels) are left intact. Returns a new dict — the
    original arrays are not mutated. A floating torch tensor (the port's
    bfloat16 host batches) is poisoned too, where the JAX package leaves
    its `ml_dtypes.bfloat16` arrays intact (numpy does not count them as
    floating): ROADMAP C records the difference."""
    import numpy as np
    import torch

    out = {}
    for k, v in batches.items():
        if isinstance(v, torch.Tensor):
            out[k] = (v if not v.is_floating_point()
                      else torch.full_like(v, float("nan")) if mode == "nan"
                      else v * scale)
            continue
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.floating):
            out[k] = (np.full_like(a, np.nan) if mode == "nan"
                      else a * a.dtype.type(scale))
        else:
            out[k] = v
    return out
