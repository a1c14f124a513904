"""Serving-side weight lifecycle: initial load and the nonfinite canary.

The counterpart of `sparknet_tpu/serve/model_manager.py`, first part. The
manager owns the net's weights while the server owns its traffic. This
slice keeps:
  - `params_from_checkpoint_flat`: a training checkpoint's flat map (the
    JAX package's layouts and keys) -> port params, through
    `model.net.params_from_jax`;
  - `load_initial`: serve a given flat map, or the net's fresh weights;
  - the CANARY: after installing, a forward of an all-zeros batch must be
    finite, or the install rolls back to the previous weights.
Checkpoint watching, hot swap, quantized serving and the rollout gate need
the checkpoint store, which arrives with a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from ..model.net import jax_param_shapes, params_from_jax
from ..obs import trace as obs_trace
from ..utils.logger import Logger


class ServeModelError(RuntimeError):
    """A checkpoint cannot be served (missing or mis-shaped leaves that no
    known layout — bare params, replica-axis TrainState, TP column shards,
    logical NamedSharding state — explains)."""


def params_from_checkpoint_flat(flat: Mapping[str, np.ndarray], net,
                                tp: int = 1):
    """Training-checkpoint flat keys -> port params for `net` (a TorchNet),
    on the net's device.

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
    return params_from_jax(net.net, jax_params, net.device)


class ModelManager:
    """Owns the initial weight load and the canary for one net."""

    def __init__(self, net, canary_batch: Optional[Dict[str, np.ndarray]]
                 = None, canary_outputs: Optional[tuple] = None,
                 logger: Optional[Logger] = None, registry=None,
                 model: str = "default"):
        self.net = net
        self.canary_batch = canary_batch
        self.canary_outputs = canary_outputs
        self.log = logger
        self.model = str(model)
        self.step: Optional[int] = None   # served checkpoint step
        self.swap_failures = 0            # rejected or rolled-back installs
        self.last_error: Optional[str] = None
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

    def load_initial(self, flat: Optional[Mapping[str, np.ndarray]] = None,
                     step: int = 0, extra: Optional[Dict[str, Any]] = None
                     ) -> Optional[int]:
        """Serve `flat` (a checkpoint's flat map) when given, else the
        net's fresh weights. A flat map that fails extraction or the
        canary raises: there is no earlier good state to fall back to."""
        if flat is None:
            return None
        if not self.install(flat, step, extra or {}, initial=True):
            raise ServeModelError(f"initial weights rejected: "
                                  f"{self.last_error}")
        return self.step

    def install(self, flat: Mapping[str, np.ndarray], step: int,
                extra: Optional[Dict[str, Any]] = None,
                initial: bool = False) -> bool:
        """Extract + install + canary; rolls back and returns False on a
        rejected checkpoint. Call only from the thread that runs the
        net's forwards (the server's worker, or before start())."""
        extra = extra or {}
        with obs_trace.span("install", step=step):
            old_params = self.net.params
            try:
                self.net.params = params_from_checkpoint_flat(
                    flat, self.net, tp=int(extra.get("tp", 1)))
            except (ServeModelError, ValueError) as e:
                self._reject(step, str(e))
                return False
            try:
                canary_ok = self._canary_ok()
            except Exception as e:
                # a canary that crashes must roll back too: unvetted weights
                # must not stay installed because the vet itself failed
                canary_ok = False
                self._log(f"serve: canary forward raised: {e}")
            if not canary_ok:
                self.net.params = old_params
                self._reject(step, "canary forward failed (nonfinite "
                                   "outputs or crash) — install rolled back")
                return False
        self.step = step
        self.last_error = None
        if self._c_swaps is not None:
            self._c_swaps.inc(model=self.model,
                              outcome="initial" if initial else "ok")
        self._log(f"serve: weights loaded from checkpoint step {step}")
        return True

    def _canary_ok(self) -> bool:
        if self.canary_batch is None:
            return True
        out = self.net.forward(self.canary_batch,
                               blob_names=list(self.canary_outputs or ()))
        return all(np.isfinite(np.asarray(v, dtype=np.float32)).all()
                   for v in out.values())

    def _reject(self, step: int, why: str) -> None:
        self.swap_failures += 1
        if self._c_swaps is not None:
            self._c_swaps.inc(model=self.model, outcome="rejected")
        self.last_error = f"step {step}: {why}"
        self._log(f"serve: REJECTED checkpoint step {step}: {why} — "
                  f"continuing on step {self.step}")

    def _log(self, msg: str) -> None:
        if self.log is not None:
            self.log.log(msg)
