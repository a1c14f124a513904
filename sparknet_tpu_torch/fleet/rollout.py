"""Staggered checkpoint adoption: the fleet rollout duty + its gate file.

A copy of `sparknet_tpu/fleet/rollout.py` (pure Python): the port imports
nothing of the JAX package. The gate file is byte-for-byte the JAX
package's, so either package's serving replicas obey either package's
rollout duty; bucket gates go through the port's
`utils/checkpoint.py:_bucket_ops`.

Without this module every ModelManager polls the checkpoint store
independently, so a freshly committed step goes live on EVERY replica
within one poll interval — a checkpoint that passes digests but fails
the canary/parity gates would be rejected fleet-wide *simultaneously*,
putting every replica into swap-cooldown shedding at once. The rollout
duty turns adoption into a sequenced wave plan:

    canary (one replica, the local lane when present)
      -> wave 1 (<= wave_size replicas)  [health gate]
      -> wave 2 ...                      [health gate]
      -> done (gate opens the step to everyone, future replicas too)

and on a canary rejection or a wave health-gate breach it HALTS: the
step is denied fleet-wide, approvals revert to the pre-rollout step
(replicas that already adopted swap back DOWN), and the audit trail
records why. A bad step therefore reaches at most the canary — the
existing parity/nonfinite canary + swap-cooldown shedding contain the
blast radius to one replica, never the fleet.

Coordination is a single atomically-replaced JSON file (`ROLLOUT.json`,
local path or gs://|s3:// — the same stores checkpoints live in, so a
fleet of subprocess replicas needs no extra RPC surface):

    {"v": 1, "target": 12, "all": 8, "state": "wave", "wave": 1,
     "approved": {"lenet-1": 12}, "denied": [11]}

ModelManager reads it during poll (`serve/model_manager.py`): a replica
adopts `approved[replica]` when present, else `all`, and never a step in
`denied`; no entry at all means HOLD. A missing/unreadable gate degrades
to ungated independent polling — the pre-rollout behavior — so the gate
can be introduced (or lost to a store blip) without stranding a fleet.

`RolloutManager` runs as a FleetController duty (one instance per model
whose lane watches a checkpoint dir with a gate configured); the
controller feeds it replica adoption views each tick and it rewrites the
gate. Everything is tick-driven and clock-injected: tests step the whole
state machine deterministically.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

IDLE = "idle"
CANARY = "canary"
WAVE = "wave"


def read_gate(path: str) -> Optional[Dict[str, Any]]:
    """The rollout gate dict, or None when missing/unreadable/torn (the
    caller degrades to ungated polling). Accepts gs://|s3:// like the
    checkpoint store."""
    try:
        if isinstance(path, str) and path.startswith(("gs://", "s3://")):
            from ..utils.checkpoint import _bucket_ops
            gate = json.loads(_bucket_ops(path).read(path))
        else:
            with open(path) as f:
                gate = json.load(f)
    except Exception:
        return None
    return gate if isinstance(gate, dict) else None


def write_gate(path: str, gate: Dict[str, Any]) -> None:
    """Atomic replace (tmp + os.replace locally, one-object PUT on a
    bucket — both atomic) so a polling replica never reads a torn
    plan."""
    if isinstance(path, str) and path.startswith(("gs://", "s3://")):
        from ..utils.checkpoint import _bucket_ops
        _bucket_ops(path).write(path, json.dumps(gate).encode())
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".rollout-")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(gate, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ReplicaView:
    """One replica's adoption state as the controller sees it this tick:
    `key` is the gate identity (ModelManager.replica — "local" for the
    in-process lane, the provider tag for children), `step` the
    checkpoint it currently serves (None = unknown, e.g. a heartbeat not
    yet landed), `rollbacks` its rejected/rolled-back swap count (a
    rising count during a rollout = the step was refused)."""

    __slots__ = ("key", "step", "rollbacks")

    def __init__(self, key: str, step: Optional[int],
                 rollbacks: int = 0) -> None:
        self.key = str(key)
        self.step = None if step is None else int(step)
        self.rollbacks = int(rollbacks)


class RolloutManager:
    """The wave sequencer for ONE model's checkpoint adoption (module
    doc). `tick(views, newest_step, burn, now)` advances the state
    machine one step and rewrites the gate when the plan changed;
    `event` (the controller's audit hook) receives every transition."""

    def __init__(self, gate_path: str, wave_size: int = 2,
                 halt_burn: float = 1.5, timeout_s: float = 30.0,
                 event: Optional[Callable[..., None]] = None,
                 logger=None):
        if wave_size < 1:
            raise ValueError(f"wave_size must be >= 1 (got {wave_size})")
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0 (got {timeout_s})")
        self.gate_path = gate_path
        self.wave_size = int(wave_size)
        self.halt_burn = float(halt_burn)
        self.timeout_s = float(timeout_s)
        self.event = event
        self.log = logger
        self.state = IDLE
        self.target: Optional[int] = None
        self.fallback: Optional[int] = None   # the pre-rollout "all"
        self.canary: Optional[str] = None
        self.wave = 0                          # 0 = canary phase
        self.waves_done = 0                    # completed rollouts' waves
        self.rollouts = 0                      # completed rollouts
        self.halts = 0
        self.denied: List[int] = []
        self._approved: Dict[str, int] = {}
        self._wave_keys: List[str] = []
        self._rollbacks0: Dict[str, int] = {}
        self._phase_t0 = 0.0
        self._all: Optional[int] = None

    # -- gate ----------------------------------------------------------------

    def _write(self) -> None:
        gate: Dict[str, Any] = {"v": 1, "state": self.state,
                                "wave": self.wave,
                                "approved": dict(self._approved),
                                "denied": list(self.denied)}
        if self.target is not None:
            gate["target"] = self.target
        if self._all is not None:
            gate["all"] = self._all
        write_gate(self.gate_path, gate)

    def _emit(self, reason: str, **extra: Any) -> None:
        if self.event is not None:
            self.event("rollout", reason, **extra)
        if self.log is not None:
            kv = " ".join(f"{k}={v}" for k, v in extra.items())
            self.log.log(f"rollout: {reason} {kv}")

    # -- the duty ------------------------------------------------------------

    def tick(self, views: List[ReplicaView], newest_step: Optional[int],
             burn: float, now: Optional[float] = None) -> str:
        """One sequencing step; returns the (possibly new) state. The
        controller passes every replica's adoption view (canary
        preference = list order: put the local lane first), the newest
        COMMITTED step in the store, and the model's current SLO burn
        (the wave health gate)."""
        now = time.monotonic() if now is None else now
        if self.state == IDLE:
            self._tick_idle(views, newest_step, now)
        elif self.state == CANARY:
            self._tick_canary(views, burn, now)
        elif self.state == WAVE:
            self._tick_wave(views, burn, now)
        return self.state

    def _tick_idle(self, views: List[ReplicaView],
                   newest_step: Optional[int], now: float) -> None:
        if newest_step is None or not views:
            return
        if newest_step in self.denied:
            return
        if self._all is not None and newest_step <= self._all:
            return
        # a new committed step: open a rollout with the first view as
        # canary, everyone else held at the current "all"
        self.target = int(newest_step)
        self.canary = views[0].key
        self.fallback = self._all if self._all is not None \
            else views[0].step
        self.wave = 0
        self._approved = {self.canary: self.target}
        self._wave_keys = [self.canary]
        self._rollbacks0 = {v.key: v.rollbacks for v in views}
        self._phase_t0 = now
        self.state = CANARY
        self._write()
        self._emit("canary", step=self.target, replica=self.canary,
                   fallback=self.fallback)

    def _rejected(self, views: List[ReplicaView]) -> Optional[str]:
        """The wave member whose rollback count rose since the phase
        opened (= it refused the target step), or None."""
        for v in views:
            if v.key in self._wave_keys and \
                    v.rollbacks > self._rollbacks0.get(v.key, v.rollbacks):
                return v.key
        return None

    def _adopted(self, views: List[ReplicaView]) -> bool:
        got = {v.key: v.step for v in views}
        return all(got.get(k) == self.target for k in self._wave_keys)

    def _tick_canary(self, views: List[ReplicaView], burn: float,
                     now: float) -> None:
        bad = self._rejected(views)
        if bad is not None:
            self._halt(f"canary {bad} rejected step")
            return
        if not self._adopted(views):
            if now - self._phase_t0 > self.timeout_s:
                self._halt(f"canary {self.canary} never adopted within "
                           f"{self.timeout_s}s")
            return
        if burn >= self.halt_burn:
            self._halt(f"burn {burn:.2f} >= {self.halt_burn} on the "
                       f"canary")
            return
        self._next_wave(views, now)

    def _tick_wave(self, views: List[ReplicaView], burn: float,
                   now: float) -> None:
        bad = self._rejected(views)
        if bad is not None:
            self._halt(f"replica {bad} rejected step in wave "
                       f"{self.wave}")
            return
        if burn >= self.halt_burn:
            self._halt(f"burn {burn:.2f} >= {self.halt_burn} in wave "
                       f"{self.wave}")
            return
        if not self._adopted(views):
            if now - self._phase_t0 > self.timeout_s:
                self._halt(f"wave {self.wave} never adopted within "
                           f"{self.timeout_s}s")
            return
        self._next_wave(views, now)

    def _next_wave(self, views: List[ReplicaView], now: float) -> None:
        pending = [v.key for v in views
                   if self._approved.get(v.key) != self.target]
        if not pending:
            self._finish()
            return
        self.wave += 1
        batch = pending[:self.wave_size]
        for k in batch:
            self._approved[k] = self.target
        self._wave_keys = batch
        self._rollbacks0 = {v.key: v.rollbacks for v in views}
        self._phase_t0 = now
        self.state = WAVE
        self._write()
        self._emit("wave", step=self.target, wave=self.wave,
                   replicas=batch)

    def _finish(self) -> None:
        self.waves_done += self.wave
        self.rollouts += 1
        self._all = self.target
        self._approved = {}
        self._wave_keys = []
        done_step = self.target
        self.target = None
        self.canary = None
        self.state = IDLE
        self._write()
        self._emit("done", step=done_step, waves=self.wave)
        self.wave = 0

    def _halt(self, why: str) -> None:
        """Deny the step fleet-wide and revert every approval: replicas
        that already adopted it (at most the current wave + earlier
        waves — one canary in the worst and common case) swap back DOWN
        to the pre-rollout step; nobody else ever sees it."""
        self.halts += 1
        if self.target is not None and self.target not in self.denied:
            self.denied.append(self.target)
        self._all = self.fallback
        self._approved = {}
        self._wave_keys = []
        halted_step = self.target
        self.target = None
        self.canary = None
        self.state = IDLE
        self._write()
        self._emit("halt", step=halted_step, wave=self.wave, why=why)
        self.wave = 0

    def status(self) -> Dict[str, Any]:
        return {"state": self.state, "target": self.target,
                "all": self._all, "wave": self.wave,
                "canary": self.canary,
                "approved": dict(self._approved),
                "denied": list(self.denied),
                "rollouts": self.rollouts,
                "waves_done": self.waves_done,
                "halts": self.halts}
