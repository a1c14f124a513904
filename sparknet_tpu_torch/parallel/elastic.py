"""Elastic pod membership: survive losing and gaining workers mid-run.

A copy of `sparknet_tpu/parallel/elastic.py` (pure Python): the port
imports nothing of the JAX package. A "worker" is a machine — the JAX
package's process, a group of the port's ranks (`parallel/mesh.py:
machine_topology`) whose local rank 0 writes its heartbeat.

The paper's claim is that τ-interval parameter averaging tolerates slow,
unreliable communication (SparkNet, arXiv:1511.06051); this module
extends that tolerance to unreliable workers — spot capacity, where the
membership changes while the run is live:

  - liveness comes from the per-worker heartbeats the loop writes under
    `RunConfig.pod_dir` (utils/heartbeat.py — a local/NFS dir or a
    gs://|s3:// prefix);
  - dead-vs-slow is `utils.health.liveness_classify`, the rule the pod
    aggregator's straggler naming uses, so a merely slow worker can be
    flagged a straggler but never evicted for slowness;
  - recovery goes through the verified checkpoint store: the resumed run
    restores every rank from the newest verified step, params exact and
    momentum per `momentum_policy` (`ParallelTrainer.adapt_state`).

`MembershipController` is the host-side decision maker: it polls the
heartbeat prefix, classifies every known worker, and emits a
`MembershipEvent` when the membership actually changes. Deadness is never
declared on a single missed beat: a stale worker becomes suspect and is
re-probed with full-jitter backoff (uniform in [0, reprobe_backoff_s *
2^k]); only `dead_probes` consecutive stale probes evict. A fresh beat at
any point clears the suspicion. A worker that said status="done" left
gracefully and is removed without probing.

The train loop (apps/train_loop.py) consumes events at the τ boundary.
A port process drives one card and a torch process group cannot drop or
add a member in place, so every membership change takes the JAX
package's relaunch branches: on one machine the loop drains its pipeline,
writes the boundary checkpoint and raises `ElasticRelaunch` (exit 75);
over several machines it raises without the boundary save and the
relaunch resumes from the newest periodic step. Below `min_workers` it
raises `TrainingHealthError` instead — degrade loudly, never hang. The
relaunched run resumes elastically at its new size. Before it raises,
each machine's local rank 0 writes the new membership to the file the
relaunch supervisor (`parallel/supervise.py`) named in
$SPARKNET_RELAUNCH_RECORD (`write_relaunch_record`, the port's own
addition: the JAX package's launcher re-issues the same command), and
the supervisor sizes the next launch from it.
"""
from __future__ import annotations

import json
import os
import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.config import ElasticConfig
from ..utils.health import _median, liveness_classify
from ..utils.heartbeat import worker_sort_key  # noqa: F401  (re-export)

#: EX_TEMPFAIL — the launcher's "relaunch me at the new pod size" code
ELASTIC_RELAUNCH_EXIT = 75

#: set by the relaunch supervisor (`parallel/supervise.py`) on every
#: launch: the file where each machine's local rank 0 writes the
#: membership its exit 75 leaves behind (`write_relaunch_record`)
RELAUNCH_RECORD_ENV = "SPARKNET_RELAUNCH_RECORD"
#: set to "1" by the supervisor on a launch that follows an exit 75: the
#: resume is an elastic one even at the same world size
RELAUNCHED_ENV = "SPARKNET_ELASTIC_RELAUNCH"


class ElasticRelaunch(SystemExit):
    """Raised by the train loop at a membership change: a port process
    cannot change its world in place. Exits with code 75 (EX_TEMPFAIL):
    a supervisor relaunches the job at the new size instead of counting
    a failure, and the relaunched job resumes elastically from the
    checkpoint store.

    What the resumed state is depends on the world: on one machine the
    loop writes the τ-boundary checkpoint first, so nothing is lost; over
    several machines it raises without the boundary save (the JAX
    package's multi-host rule) and the relaunch resumes from the newest
    periodic checkpoint (up to checkpoint_every rounds are re-trained)."""

    def __init__(self, reason: str):
        super().__init__(ELASTIC_RELAUNCH_EXIT)
        self.reason = reason

    def __str__(self) -> str:  # SystemExit.__str__ would print "75"
        return f"elastic relaunch requested: {self.reason}"


def write_relaunch_record(ev: "MembershipEvent", world: int, machine: int,
                          n_machines: int, local_size: int
                          ) -> Optional[str]:
    """Write the membership a relaunch leaves behind to the file named by
    $SPARKNET_RELAUNCH_RECORD (a no-op without it): the event's epoch, the
    new members and the previous ones (worker ids), and where this rank's
    machine sat in the world that exits. The supervisor sizes the next
    launch from it. Atomic (a temporary file renamed); returns the path."""
    path = os.environ.get(RELAUNCH_RECORD_ENV)
    if not path:
        return None
    previous = (set(ev.alive) - set(ev.joined)) | set(ev.dead)
    rec = {"epoch": int(ev.epoch), "members": list(ev.alive),
           "previous": sorted(previous, key=worker_sort_key),
           "world": int(world), "machine": int(machine),
           "n_machines": int(n_machines), "local_size": int(local_size)}
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    os.replace(tmp, path)
    return path


@dataclass(frozen=True)
class MembershipEvent:
    """One membership change, emitted at most once per poll."""

    epoch: int                 # monotonically increasing per change
    alive: Tuple[str, ...]     # the NEW membership (sorted worker ids)
    dead: Tuple[str, ...]      # evicted this event (stale/missing/done)
    joined: Tuple[str, ...]    # adopted this event
    reasons: Dict[str, str]    # worker id -> liveness verdict that did it

    @property
    def n_workers(self) -> int:
        return len(self.alive)


class MembershipController:
    """Declares workers dead or joined from their pod-dir heartbeats.

    `self_worker` is this process's own worker id: it is always a member
    and never probed (its heartbeat is written by the very loop running
    this controller — a self-eviction would be a deadlock with extra
    steps). Initial membership is the DECLARED launch size — worker ids
    0..expected_workers-1 (cfg.expected_workers, defaulting to the
    caller's process count) — plus any extra worker with a fresh beat at
    the first poll. A launched worker that never beats is candidate-dead
    and takes the normal suspect → re-probe → evict path. A leftover
    STALE (or done) heartbeat from a previous incarnation never seeds
    membership just to be evicted — in or out of the declared range:
    excluding an in-range leftover is what stops a relaunched pod from
    re-evicting a permanently-lost worker and exit-75-bouncing forever
    (the worker rejoins through adopt once it beats fresh).

    `now` / `rng` are injectable for deterministic tests; production uses
    the wall clock and the process-global PRNG.
    """

    def __init__(self, cfg: ElasticConfig, pod_dir: str,
                 self_worker: int = 0, expected_workers: Optional[int] = None,
                 registry=None,
                 now: Callable[[], float] = time.time,
                 rng: Optional[random.Random] = None):
        self.cfg = cfg
        self.pod_dir = pod_dir
        self.self_worker = str(int(self_worker))
        self.expected_workers = int(cfg.expected_workers
                                    or expected_workers or 1)
        self._now = now
        self._rng = rng or random.Random()
        self.epoch = 0
        self.members: set = set()
        #: worker id -> {"probes": stale probes so far,
        #:               "next_probe_t": monotonic-ish deadline}
        self._suspect: Dict[str, Dict[str, float]] = {}
        self._denied_logged: set = set()
        self._last_views: Optional[Dict[str, Any]] = None
        self._last_poll_t = 0.0
        self._started = False
        self.audit: deque = deque(maxlen=256)  # event dicts, newest last
        self._g_epoch = self._c_evict = self._c_rejoin = None
        self._g_members = None
        if registry is not None:
            self._g_epoch = registry.gauge(
                "sparknet_pod_membership_epoch",
                "membership epoch (bumped on every evict/join)")
            self._g_epoch.set(0)
            self._g_members = registry.gauge(
                "sparknet_pod_members",
                "workers currently in the elastic membership")
            self._c_evict = registry.counter(
                "sparknet_pod_worker_evictions_total",
                "workers declared dead (stale heartbeat survived the "
                "full-jitter re-probes) or departed (status done)",
                labels=("worker",))
            self._c_rejoin = registry.counter(
                "sparknet_pod_worker_rejoins_total",
                "workers adopted into a live membership",
                labels=("worker",))

    # -- heartbeat views -----------------------------------------------------

    def _read_views(self) -> Dict[str, Optional[Dict[str, Any]]]:
        from ..obs.pod import discover_worker_heartbeats
        from ..utils.heartbeat import read_heartbeat
        return {w: read_heartbeat(p)
                for w, p in discover_worker_heartbeats(self.pod_dir).items()}

    def _verdict(self, hb: Optional[Dict[str, Any]]) -> str:
        return liveness_classify(hb, self.cfg.stale_after_s)

    # -- the poll ------------------------------------------------------------

    def poll(self, rnd: Optional[int] = None,
             force: bool = False) -> Optional[MembershipEvent]:
        """One membership check; returns an event IFF membership changed.
        Rate-limited to `cfg.poll_interval_s` unless `force` (the loop
        calls this once per round; the listing+reads are cheap but a
        bucket prefix should not be listed at kHz)."""
        now = self._now()
        if not force and self._started and \
                now - self._last_poll_t < self.cfg.poll_interval_s:
            return None
        self._last_poll_t = now
        views = self._last_views = self._read_views()
        if not self._started:
            self._started = True
            declared = {str(i) for i in range(self.expected_workers)}
            # a declared worker whose prefix heartbeat already reads
            # stale (or done) is a LEFTOVER of a previous incarnation —
            # it died before this (re)launch. Seeding it anyway would
            # re-evict it and, on a relaunch-only pod, raise exit 75
            # again: an endless relaunch bounce after a permanent
            # preemption. It is NOT seeded; it rejoins through the adopt
            # path the moment it beats fresh. A declared worker with NO
            # heartbeat may merely not have started yet: seeded, and
            # probed as candidate-dead like any other silence.
            leftover = {w for w in declared
                        if self._verdict(views.get(w)) in ("stale", "done")}
            self.members = declared - leftover
            self.members |= {w for w, hb in views.items()
                             if self._verdict(hb) in ("ok", "sick")}
            self.members.add(self.self_worker)
            if leftover:
                self.audit.append({"ts": round(self._now(), 3),
                                   "round": rnd, "epoch": self.epoch,
                                   "seed_leftovers": sorted(leftover)})
            if self._g_members is not None:
                self._g_members.set(len(self.members))
            return None

        dead: List[str] = []
        joined: List[str] = []
        reasons: Dict[str, str] = {}

        for w in sorted(self.members - {self.self_worker}):
            verdict = self._verdict(views.get(w))
            if verdict in ("ok", "sick"):
                self._suspect.pop(w, None)  # fresh beat clears suspicion
                continue
            if verdict == "done":  # graceful goodbye: no probes needed
                self._suspect.pop(w, None)
                dead.append(w)
                reasons[w] = verdict
                continue
            # stale/missing -> suspect with full-jitter re-probe: the
            # first sighting only STARTS the clock; eviction needs
            # cfg.dead_probes consecutive stale re-probes
            s = self._suspect.get(w)
            if s is None:
                self._suspect[w] = {
                    "probes": 0,
                    "next_probe_t": now + self._rng.uniform(
                        0.0, self.cfg.reprobe_backoff_s)}
                continue
            if now < s["next_probe_t"]:
                continue
            s["probes"] += 1
            if s["probes"] >= max(1, self.cfg.dead_probes):
                self._suspect.pop(w, None)
                dead.append(w)
                reasons[w] = verdict
            else:
                s["next_probe_t"] = now + self._rng.uniform(
                    0.0, self.cfg.reprobe_backoff_s * (2 ** s["probes"]))

        for w in sorted(set(views) - self.members):
            if self._verdict(views[w]) not in ("ok", "sick"):
                continue
            if self.cfg.rejoin == "deny":
                if w not in self._denied_logged:
                    self._denied_logged.add(w)
                    import warnings
                    warnings.warn(
                        f"elastic: worker {w} offered a fresh heartbeat "
                        f"but rejoin policy is 'deny' — ignoring",
                        RuntimeWarning)
                continue
            joined.append(w)
            reasons[w] = "joined"

        if not dead and not joined:
            return None
        self.members = (self.members - set(dead)) | set(joined)
        self.epoch += 1
        for w in dead:
            if self._c_evict is not None:
                self._c_evict.inc(worker=w)
        for w in joined:
            self._denied_logged.discard(w)
            if self._c_rejoin is not None:
                self._c_rejoin.inc(worker=w)
        if self._g_epoch is not None:
            self._g_epoch.set(self.epoch)
            self._g_members.set(len(self.members))
        ev = MembershipEvent(epoch=self.epoch,
                             alive=tuple(sorted(self.members,
                                                key=worker_sort_key)),
                             dead=tuple(dead), joined=tuple(joined),
                             reasons=reasons)
        self.audit.append({"ts": round(self._now(), 3), "round": rnd,
                           "epoch": ev.epoch, "dead": list(ev.dead),
                           "joined": list(ev.joined),
                           "reasons": dict(reasons),
                           "n_workers": ev.n_workers})
        return ev

    # -- per-worker τ adaptation --------------------------------------------

    def tau_by_worker(self, tau: int) -> Optional[Dict[str, int]]:
        """Heterogeneous-pod τ budgets (cfg.tau_adapt): worker i gets
        clip(round(tau * median_round_s / round_s_i), tau_min, tau)
        local steps, so a chronically slow worker contributes a shorter
        (but still averaged-in) trajectory instead of stalling the τ
        barrier for everyone. Returns {worker id: tau_i} — the train
        loop expands it to the per-data-group vector the trainer takes
        (a worker may own several device groups). None when adaptation
        is off, the heartbeats carry no round times yet, or every budget
        comes out at the full τ. The median is `utils.health._median` —
        the same estimator the straggler attribution uses, so a 2-worker
        pod's midpoint sits BETWEEN the two times and the slow worker
        actually gets a shorter budget."""
        if not self.cfg.tau_adapt:
            return None
        # reuse the poll's cached views: τ adaptation rides the same
        # rate-limited heartbeat reads, it never adds listing traffic
        views = (self._last_views if self._last_views is not None
                 else self._read_views())
        times: Dict[str, float] = {}
        for w in self.members:
            hb = views.get(w)
            if hb and self._verdict(hb) in ("ok", "sick") and \
                    hb.get("round_s"):
                times[w] = float(hb["round_s"])
        if len(times) < 2:
            return None
        med = _median(sorted(times.values()))
        out: Dict[str, int] = {}
        for w in sorted(self.members, key=worker_sort_key):
            r = times.get(w)
            if not r or r <= 0 or med <= 0:
                out[w] = tau
                continue
            out[w] = int(min(tau, max(self.cfg.tau_min,
                                      round(tau * med / r))))
        return out if any(t != tau for t in out.values()) else None
