"""Serving-side weight lifecycle: load, watch, verify, hot-swap, rollback.

The counterpart of `sparknet_tpu/serve/model_manager.py`. The manager owns
the net's weights while the server owns its traffic. It watches a
`checkpoint_dir` — the same store layer training writes through
(`utils/checkpoint.py`: a local path or a gs://|s3:// prefix, the JAX
package's steps as well as the port's) — and hot-swaps weights between
batches:

  - a new step is loaded through `restore_flat(step=...)`, which
    re-verifies every digest: a torn upload or a byte flipped at rest is
    REJECTED (`CheckpointCorruptError`) and the server keeps answering
    from the current weights; the bad step goes on a cooldown so the poll
    does not download it again every interval. A step that is gone by the
    time it is read (`CheckpointVanishedError`, e.g. `retain` pruned it)
    is neither a rejection nor a cooldown. A step of either file layout
    (monolithic state.npz, or per-shard files under a manifest) restores
    to the same flat map; a per-shard save whose meta.json has not
    landed yet is not a checkpoint, so a poll skips it until it commits.
  - the swap itself runs on the server's worker thread between batches,
    so queued requests never race a half-installed weight set. The new
    tensors are copied to the card on the worker thread's current stream,
    the stream every later forward of that thread runs on, so the next
    forward reads them only after the copies; the old tensors are
    released on that same stream once the last reference drops, so the
    caching allocator cannot hand their memory to anything a queued
    forward still reads.
  - after installing, an optional CANARY forward runs (zeros batch at
    the smallest bucket): nonfinite outputs roll the swap back to the
    previous weights.
  - with `quant`, every install quantizes the f32 weights
    (`model/quant.py`) and gates on the PARITY canary: the quantized
    forward of `parity_batch` must be finite and allclose the f32 forward
    within the QuantConfig tolerance, else the swap rolls back.
  - transient store trouble (an outage mid-poll) is counted as
    `store_error` and retried after a full-jitter backoff; it degrades
    freshness, never availability, and cools no step down.

Weight-swap events reuse the training heartbeat schema
(`utils/heartbeat.py`, role="serve"): step = served checkpoint step,
rollbacks = rejected/rolled-back swaps.

`forwards` counts the canary and parity forwards the manager ran (of
them, `reference_forwards` the f32 parity references), so a caller can
tell them from traffic forwards; `install_ts` and `last_canary_s` time
the last install.

With `rollout_gate` (a ROLLOUT.json path, local or gs://|s3://, written
by the fleet rollout duty, `fleet/rollout.py`) the poll adopts
`approved[replica]` when present, else `all`, and never a step in
`denied`; a gate that approves nothing for this replica holds the
current weights, and a missing or unreadable gate degrades to ungated
polling. The approved step may be older than the served one (a halted
rollout swaps back down).
"""
from __future__ import annotations

import random
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np

from ..model.net import jax_param_shapes, params_from_jax, params_to_jax
from ..model.quant import QuantConfig, quant_params_to_port, quantize_params
from ..obs import trace as obs_trace
from ..utils import checkpoint as ckpt
from ..utils.heartbeat import HeartbeatWriter
from ..utils.logger import Logger


class ServeModelError(RuntimeError):
    """A checkpoint cannot be served (missing or mis-shaped leaves that no
    known layout — bare params, replica-axis TrainState, TP column shards,
    logical NamedSharding state — explains)."""


def jax_params_from_checkpoint_flat(flat: Mapping[str, np.ndarray], net,
                                    tp: int = 1
                                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """Training-checkpoint flat keys -> the net's params in the JAX
    package's layouts, as numpy (`net` is a TorchNet).

    Accepts every layout the JAX package's store holds: a full
    replica-axis TrainState (`params/<layer>/<param>` with a leading
    [n_devices] axis; post-round replicas are identical, shard 0 is THE
    value), the NamedSharding trainer's logical layout (no leading axis),
    and a bare params tree (`<layer>/<param>`). Momentum/it keys are
    ignored. `tp` (checkpoint `extra["tp"]`): replica-axis
    tensor-parallel column shards are concatenated back along the column
    dim (w: 1, b: 0). Missing or shape-mismatched leaves fail loudly with
    the leaf path."""
    jax_params: Dict[str, Dict[str, np.ndarray]] = {}
    for lname, pshapes in jax_param_shapes(net.net).items():
        jax_params[lname] = {}
        for pname, want in pshapes.items():
            arr = None
            for key in (f"params/{lname}/{pname}", f"{lname}/{pname}"):
                if key in flat:
                    arr = np.asarray(flat[key])
                    break
            if arr is None:
                raise ServeModelError(
                    f"checkpoint has no weights for {lname}/{pname}")
            if tuple(arr.shape) != want:
                if arr.ndim == len(want) + 1 and \
                        tuple(arr.shape[1:]) == want:
                    arr = arr[0]  # leading replica axis, replicated leaf
                elif tp > 1 and arr.ndim == len(want) + 1 \
                        and arr.shape[0] >= tp:
                    axis = 1 if pname == "w" and len(want) > 1 else 0
                    cand = np.concatenate([arr[j] for j in range(tp)],
                                          axis=axis)
                    if tuple(cand.shape) != want:
                        raise ServeModelError(
                            f"{lname}/{pname}: tp={tp} shards "
                            f"{arr.shape} do not reassemble to net "
                            f"{want}")
                    arr = cand
                else:
                    raise ServeModelError(
                        f"{lname}/{pname}: checkpoint shape {arr.shape} "
                        f"!= net {want}")
            jax_params[lname][pname] = arr
    return jax_params


def params_from_checkpoint_flat(flat: Mapping[str, np.ndarray], net,
                                tp: int = 1):
    """Training-checkpoint flat keys -> port params for `net` (a TorchNet)
    on the net's device (`jax_params_from_checkpoint_flat`, then
    `model.net.params_from_jax`)."""
    return params_from_jax(
        net.net, jax_params_from_checkpoint_flat(flat, net, tp=tp),
        net.device)


class ModelManager:
    """Owns weight load / watch / swap for one net (see module doc)."""

    def __init__(self, net, checkpoint_dir: Optional[str] = None,
                 poll_interval_s: float = 2.0,
                 canary_batch: Optional[Dict[str, Any]] = None,
                 canary_outputs: Optional[tuple] = None,
                 logger: Optional[Logger] = None,
                 heartbeat: Optional[HeartbeatWriter] = None,
                 bad_step_retry_s: float = 30.0, registry=None,
                 model: str = "default",
                 quant: Optional[QuantConfig] = None,
                 parity_batch: Optional[Dict[str, np.ndarray]] = None,
                 replica: str = "local", poll_jitter: float = 0.0,
                 rollout_gate: Optional[str] = None,
                 seed: Optional[int] = None):
        if checkpoint_dir and not hasattr(net, "params"):
            raise ServeModelError(
                "checkpoint hot-reload needs a layer-IR TorchNet (exposes "
                ".params); serve a graph net from a weights file instead")
        if quant is not None and not (hasattr(net, "params")
                                      and hasattr(net, "set_quant")):
            raise ServeModelError(
                "quantized serving needs a layer-IR TorchNet (exposes "
                ".params/.set_quant); the graph backend serves f32")
        #: weight-only quantization at load time (model/quant.py): every
        #: install — initial weights included — quantizes the f32 params
        #: and gates on the parity canary against the f32 forward
        self.quant = quant
        self.parity_batch = parity_batch
        self.last_parity_drift: Optional[float] = None
        self.net = net
        self.checkpoint_dir = checkpoint_dir
        self.poll_interval_s = float(poll_interval_s)
        self.canary_batch = canary_batch
        self.canary_outputs = canary_outputs
        self.log = logger
        self.heartbeat = heartbeat
        self.bad_step_retry_s = float(bad_step_retry_s)
        self.model = str(model)
        #: fleet identity: the key this replica looks itself up under in
        #: the rollout gate and the `replica` label on the freshness gauges
        self.replica = str(replica)
        #: optional ROLLOUT.json gate path (local or gs://|s3://): when
        #: set, only adopt checkpoint steps the fleet rollout duty
        #: approved for this replica; missing gate = ungated polling
        self.rollout_gate = rollout_gate
        #: ± fraction of poll_interval_s each poll's NEXT deadline is
        #: jittered by: N replicas watching one bucket must not list it in
        #: lockstep on every commit. `seed` seeds the jitter (and the
        #: store-error backoff): the same seed, the same schedule.
        self.poll_jitter = float(poll_jitter)
        if not 0.0 <= self.poll_jitter < 1.0:
            raise ValueError(f"poll_jitter must be in [0, 1), "
                             f"got {poll_jitter}")
        self._rng = random.Random(seed)
        self.step: Optional[int] = None   # served checkpoint step
        #: wall-clock commit instant (meta.json commit_ts) of the SERVING
        #: step; None until a stamped checkpoint installs
        self.commit_ts: Optional[float] = None
        #: newest committed step the poll has seen in the store
        self.latest_seen: Optional[int] = None
        self.swaps = 0                    # successful hot swaps
        self.swap_failures = 0            # rejected or rolled-back swaps
        self.forwards = 0                 # canary + parity forwards run
        self.reference_forwards = 0       # of them, f32 parity references
        #: wall clock of the last install, and its canary forward's
        #: seconds (None without a canary)
        self.install_ts: Optional[float] = None
        self.last_canary_s: Optional[float] = None
        self.last_error: Optional[str] = None
        #: monotonic time of the last rejected/rolled-back swap
        self.last_reject_t: float = 0.0
        self._next_poll = 0.0
        self._bad: Dict[int, float] = {}  # step -> retry-not-before time
        self._c_swaps = None
        if registry is not None:
            self._c_swaps = registry.counter(
                "sparknet_serve_swaps_total",
                "weight-swap attempts by outcome",
                labels=("model", "outcome"))
            registry.gauge(
                "sparknet_serve_model_step",
                "checkpoint step currently serving (-1 = initial weights)",
                labels=("model",)
            ).set_fn(lambda: -1 if self.step is None else self.step,
                     model=self.model)
            registry.gauge(
                "sparknet_serve_model_freshness_seconds",
                "now - commit_ts of the serving step (-1 = no stamped "
                "checkpoint installed)",
                labels=("model", "replica")
            ).set_fn(lambda: (-1.0 if (f := self.freshness_s()) is None
                              else f),
                     model=self.model, replica=self.replica)
            registry.gauge(
                "sparknet_serve_model_step_lag",
                "newest committed step minus the serving step (-1 = "
                "unknown)",
                labels=("model", "replica")
            ).set_fn(lambda: (-1 if (lag := self.step_lag()) is None
                              else lag),
                     model=self.model, replica=self.replica)

    # -- lifecycle -----------------------------------------------------------

    def load_initial(self, flat: Optional[Mapping[str, np.ndarray]] = None,
                     step: int = 0, extra: Optional[Dict[str, Any]] = None
                     ) -> Optional[int]:
        """Serve `flat` (a checkpoint's flat map) when given — it must
        install, there is no earlier good state to fall back to. Else the
        newest verified step of the watched dir, if it has one (the net's
        fresh weights otherwise: a server may come up before its
        trainer's first save). Returns the served step or None. With
        quant the serving weights are ALWAYS quantized, the initial ones
        too."""
        if flat is not None:
            if not self.install(flat, step, extra, initial=True):
                raise ServeModelError(f"initial weights rejected: "
                                      f"{self.last_error}")
            return self.step
        if not self.checkpoint_dir:
            self._quantize_initial()
            return None
        for s in reversed(ckpt._list_steps(self.checkpoint_dir)):
            try:
                got = ckpt.restore_flat(self.checkpoint_dir, step=s)
            except ckpt.CheckpointCorruptError:
                continue
            flat, got_step, extra = got
            if not self.install(flat, got_step, extra, initial=True):
                # the newest verified checkpoint failed the install gates:
                # keep serving (quantized) initial weights; the poll
                # retries newer steps as they land
                self._quantize_initial()
            return self.step
        self._log("serve: no verified checkpoint under "
                  f"{self.checkpoint_dir!r} yet — serving initial weights")
        self._quantize_initial()
        return None

    def _quantize_initial(self) -> None:
        """Quantize the fresh-init weights in place (quant mode only).
        Failing the parity gate here is a configuration error — there is
        no earlier good state to serve — so it raises."""
        if self.quant is None or getattr(self.net, "quant", None) is not None:
            return
        ok, why = self._quant_swap(self.net.params)
        if not ok:
            raise ServeModelError(
                f"initial weights failed the quantization parity gate: "
                f"{why} — check QuantConfig tolerances")

    def poll(self, now: Optional[float] = None) -> bool:
        """Time-gated reload check (the server calls this between batches
        and on idle ticks; store traffic happens at most once per
        poll_interval_s, de-synchronized across replicas by poll_jitter).
        Returns True when a swap was installed."""
        if not self.checkpoint_dir:
            return False
        now = time.monotonic() if now is None else now
        if now < self._next_poll:
            return False
        self._schedule_next_poll(now)
        try:
            latest = ckpt.latest_step(self.checkpoint_dir)
        except Exception as e:
            # store outage: freshness degrades, serving does not — and a
            # transient listing error cools no step down
            self._store_error(f"poll: {e}", now=now)
            return False
        if latest is not None:
            self.latest_seen = latest
        target = latest
        if self.rollout_gate:
            held, want = self._gate_target()
            if held:
                return False  # gated: no step approved for this replica
            if want is not None:
                target = want  # may be < self.step: rollback swap-down
        if target is None or target == self.step:
            return False
        if now < self._bad.get(target, 0.0):
            return False  # known-bad step, still cooling down
        return self._try_swap(target)

    def _schedule_next_poll(self, now: float) -> None:
        j = self.poll_jitter
        scale = 1.0 + self._rng.uniform(-j, j) if j > 0.0 else 1.0
        self._next_poll = now + self.poll_interval_s * scale

    def _store_error(self, msg: str, now: Optional[float] = None) -> None:
        """Transient store trouble: counted under its own outcome, retried
        after a FULL-jitter backoff (uniform within one interval), and
        never a cooldown (the step is probably fine)."""
        now = time.monotonic() if now is None else now
        self.last_error = msg
        if self._c_swaps is not None:
            self._c_swaps.inc(model=self.model, outcome="store_error")
        self._next_poll = now + self._rng.uniform(0.0,
                                                  self.poll_interval_s)
        self._log(f"serve: transient store error ({msg}); retrying with "
                  f"jittered backoff")

    def _gate_target(self) -> tuple:
        """(held, step) under the rollout gate: held=True means the gate
        exists but approves nothing for this replica (hold the current
        weights); step is the approved target otherwise. A missing or
        unreadable gate degrades to ungated independent polling."""
        from ..fleet.rollout import read_gate
        gate = read_gate(self.rollout_gate)
        if not gate:
            return False, None
        # per-replica approval wins; "all" is the completed-rollout (or
        # post-halt fallback) step open to every replica, including ones
        # grown after the rollout finished
        want = gate.get("approved", {}).get(self.replica, gate.get("all"))
        if want is None:
            return True, None
        want = int(want)
        if want in set(int(d) for d in gate.get("denied", ())):
            return True, None  # approval raced a deny; hold
        return False, want

    # -- swap machinery ------------------------------------------------------

    def _try_swap(self, step: int) -> bool:
        # the span puts the whole fetch+verify+install+canary on the
        # serve worker's trace lane — the gap where no batch can run
        with obs_trace.span("hot_swap", step=step):
            try:
                # restore IS the verification: every digest is recomputed
                # over the fetched bytes
                flat, got, extra = ckpt.restore_flat(self.checkpoint_dir,
                                                     step=step)
            except ckpt.CheckpointVanishedError as e:
                # gone between listing and fetch: NOT a rejection; the
                # next poll re-targets whatever is newest
                self.last_error = f"step {step}: vanished ({e})"
                if self._c_swaps is not None:
                    self._c_swaps.inc(model=self.model, outcome="vanished")
                self._log(f"serve: checkpoint step {step} vanished before "
                          f"fetch — continuing on step {self.step}")
                return False
            except ckpt.CheckpointCorruptError as e:
                self._reject(step, f"corrupt: {e}")
                return False
            except Exception as e:
                # NOT corruption: store trouble (ConnectionError, timeouts,
                # non-404 HTTP) — no cooldown, it loads once the store
                # answers again
                self._store_error(f"load step {step}: {e}")
                return False
            return self.install(flat, got, extra)

    def install(self, flat: Mapping[str, np.ndarray], step: int,
                extra: Optional[Dict[str, Any]] = None,
                initial: bool = False) -> bool:
        """Extract + install + canary a flat map; rolls back and returns
        False on a rejected checkpoint. Call only from the thread that
        runs the net's forwards (the server's worker, or before
        start())."""
        extra = extra or {}
        with obs_trace.span("install", step=step):
            old_params = self.net.params
            old_quant = getattr(self.net, "quant", None)
            try:
                jax_params = jax_params_from_checkpoint_flat(
                    flat, self.net, tp=int(extra.get("tp", 1)))
                f32_params = params_from_jax(self.net.net, jax_params,
                                             self.net.device)
            except (ServeModelError, ValueError) as e:
                self._reject(step, str(e))
                return False
            if self.quant is not None:
                ok, why = self._quant_swap(f32_params, jax_params)
                if not ok:
                    # a quantization that fails parity NEVER serves
                    self.net.params = old_params
                    self.net.set_quant(old_quant)
                    self._reject(step, f"quantization rejected: {why} — "
                                       f"swap rolled back")
                    return False
            else:
                self.net.params = f32_params
            try:
                canary_ok = self._canary_ok()
            except Exception as e:
                # a canary that crashes must roll back too: unvetted
                # weights must not stay installed because the vet failed
                canary_ok = False
                self._log(f"serve: canary forward raised: {e}")
            if not canary_ok:
                self.net.params = old_params
                if self.quant is not None:
                    self.net.set_quant(old_quant)
                self._reject(step, "canary forward failed (nonfinite "
                                   "outputs or crash) — swap rolled back")
                return False
        self.step = step
        self.install_ts = time.time()
        ts = extra.get("commit_ts")
        self.commit_ts = float(ts) if ts is not None else None
        if self.latest_seen is None or step > self.latest_seen:
            self.latest_seen = step
        if not initial:
            self.swaps += 1
        if self._c_swaps is not None:
            self._c_swaps.inc(model=self.model,
                              outcome="initial" if initial else "ok")
        self.last_error = None
        self._log(f"serve: weights {'loaded' if initial else 'hot-swapped'}"
                  f" from checkpoint step {step}")
        self._beat(step, "ok")
        return True

    def _forward(self, batch) -> Dict[str, np.ndarray]:
        self.forwards += 1
        return self.net.forward(batch,
                                blob_names=list(self.canary_outputs or ()))

    def _quant_swap(self, f32_params, jax_params=None) -> tuple:
        """Quantize + parity-gate + install (quant mode's install tail).
        Runs the f32 forward of `parity_batch` as the reference, installs
        the quantized tree, and compares the quantized forward against
        it: every per-row output blob must be finite and allclose within
        the QuantConfig tolerance. `jax_params`: the same weights in the
        JAX layouts when the caller has them (a checkpoint's), else they
        are read back from `f32_params`. Returns (ok, why); on ok the net
        holds the quantized params. The caller owns rollback."""
        net = self.net
        try:
            net.params = f32_params
            net.set_quant(None)
            ref = {}
            if self.parity_batch is not None:
                self.reference_forwards += 1
                ref = self._forward(self.parity_batch)
            if jax_params is None:
                jax_params = params_to_jax(net.net, f32_params)
            qparams = quant_params_to_port(
                net.net, quantize_params(jax_params, self.quant),
                net.device)
            net.params = qparams
            net.set_quant(self.quant)
            if self.parity_batch is None:
                return True, None
            out = self._forward(self.parity_batch)
        except Exception as e:
            return False, f"quantized forward raised: {e}"
        drift = 0.0
        # compare the per-row blobs clients consume; batch-aggregate
        # scalars (the zoo heads' loss/accuracy over zero labels) are
        # argmax-discontinuous and dropped from responses anyway
        keys = [k for k in ref if np.ndim(ref[k]) >= 1] or list(ref)
        for k in keys:
            q = out.get(k)
            if q is None:
                return False, f"quantized forward lost blob {k!r}"
            r = np.asarray(ref[k], dtype=np.float32)
            q = np.asarray(q, dtype=np.float32)
            if not np.isfinite(q).all():
                return False, f"nonfinite quantized outputs in {k!r}"
            if r.size:
                drift = max(drift, float(np.max(np.abs(q - r))))
            if not np.allclose(q, r, rtol=self.quant.rtol,
                               atol=self.quant.atol):
                return False, (
                    f"parity drift vs f32 forward in {k!r}: max "
                    f"{np.max(np.abs(q - r)):.4g} exceeds rtol="
                    f"{self.quant.rtol}/atol={self.quant.atol}")
        self.last_parity_drift = drift
        return True, None

    def _canary_ok(self) -> bool:
        if self.canary_batch is None:
            self.last_canary_s = None
            return True
        t0 = time.perf_counter()
        out = self._forward(self.canary_batch)
        self.last_canary_s = time.perf_counter() - t0
        return all(np.isfinite(np.asarray(v, dtype=np.float32)).all()
                   for v in out.values())

    # -- freshness -----------------------------------------------------------

    def freshness_s(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds between the serving step's COMMIT (meta.json commit_ts,
        wall clock) and now; None until a stamped checkpoint installs."""
        if self.commit_ts is None:
            return None
        now = time.time() if now is None else now
        return round(max(0.0, now - self.commit_ts), 3)

    def step_lag(self) -> Optional[int]:
        """Newest committed step seen in the store minus the serving step
        (0 = fully fresh); None before the first poll/install."""
        if self.latest_seen is None or self.step is None:
            return None
        return max(0, int(self.latest_seen) - int(self.step))

    def swap_cooldown_active(self, cooldown_s: float) -> bool:
        """True within `cooldown_s` of the last rejected/rolled-back
        swap."""
        return (self.last_reject_t > 0.0 and
                time.monotonic() - self.last_reject_t < cooldown_s)

    def _reject(self, step: int, why: str) -> None:
        self.swap_failures += 1
        self.last_reject_t = time.monotonic()
        if self._c_swaps is not None:
            self._c_swaps.inc(model=self.model, outcome="rejected")
        self.last_error = f"step {step}: {why}"
        self._bad[step] = time.monotonic() + self.bad_step_retry_s
        self._log(f"serve: REJECTED checkpoint step {step}: {why} — "
                  f"continuing on step {self.step}")
        self._beat(self.step or 0, "degraded")

    def _beat(self, step: int, status: str) -> None:
        if self.heartbeat is None:
            return
        try:
            self.heartbeat.beat(step, status=status,
                                rollbacks=self.swap_failures, force=True,
                                swaps=self.swaps)
        except OSError as e:  # observability must not take serving down
            self._log(f"serve: heartbeat write failed: {e}")

    def _log(self, msg: str) -> None:
        if self.log is not None:
            self.log.log(msg)
