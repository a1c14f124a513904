"""Data-parallel trainer: τ local steps, then the param average.

The counterpart of `sparknet_tpu/parallel/trainer.py` (`ParallelTrainer`;
the round math of `_round_math`, l.502-681, and `evaluate`). One round on
each rank of the data group:

  - τ local steps, each a TRAIN-phase forward, autograd and
    `SgdSolver.update` (in place); "sync_sgd" instead averages each step's
    gradients (and loss) over the group, with τ = 1;
  - "local_sgd": the params are averaged over the group — all_reduce(SUM)
    then a division by the world size, `lax.pmean`'s order. They live in
    one flat buffer (every param tensor is a view into it), so the average
    is one collective;
  - momentum is never averaged (the reference averaged only net blobs);
  - the mean loss is the group mean of each rank's τ-mean;
  - health: grad_norm = sqrt(sum over ranks of each rank's largest
    per-step f32 squared gradient norm); nonfinite_by_worker is a one-hot
    row per rank, set when its pre-average losses, params or momentum went
    NaN/Inf; the flag for the averaged params rides the same collective in
    the last slot, and nonfinite = max(sum of rows, min(that flag, 1)).

The scalars of a round (mean loss, grad norm, the nonfinite rows and flag)
are one small all-reduce after the param average.

Not ported yet: elastic τ, tensor parallelism and `resized`; asking for
any of them raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import precision
from ..model.layers import OpsImpl, seeded_generator
from ..model.net import CompiledNet, ParamTree
from ..solver import SgdSolver, SolverConfig, SolverState, value_and_grad
from .mesh import DataGroup

@dataclasses.dataclass
class TrainState:
    """One rank's training state. `params` and `momentum` are trees of
    views into `flat_params` / `flat_momentum`; the round updates them in
    place."""

    params: ParamTree
    momentum: ParamTree
    it: int
    flat_params: torch.Tensor
    flat_momentum: torch.Tensor


def _flat_tree(tree: ParamTree, dtype: torch.dtype, device: torch.device,
               zeros: bool = False) -> Tuple[torch.Tensor, ParamTree]:
    """A flat buffer holding `tree`'s tensors (or zeros of their shapes),
    and the tree of views into it."""
    total = sum(t.numel() for lp in tree.values() for t in lp.values())
    flat = torch.zeros(total, dtype=dtype, device=device)
    views: ParamTree = {}
    off = 0
    for lname, lp in tree.items():
        views[lname] = {}
        for pname, t in lp.items():
            v = flat[off:off + t.numel()].view(t.shape)
            if not zeros:
                v.copy_(t)
            views[lname][pname] = v
            off += t.numel()
    return flat, views


class ParallelTrainer:
    """τ-round data-parallel trainer over a `DataGroup`.

    mode: "local_sgd" (τ steps then the param average — the reference's
    scheme) or "sync_sgd" (per-step gradient average, τ must be 1).
    """

    def __init__(self, net: CompiledNet, solver_cfg: SolverConfig,
                 group: DataGroup, tau: int = 10, mode: str = "local_sgd",
                 loss_blob: str = "loss", acc_blob: Optional[str] = None,
                 compute_health: bool = True, elastic_tau: bool = False,
                 tp: int = 1, ops: Optional[OpsImpl] = None):
        if mode not in ("local_sgd", "sync_sgd"):
            raise ValueError(f"unknown mode {mode!r}: expected 'local_sgd' "
                             f"or 'sync_sgd'")
        if mode == "sync_sgd" and tau != 1:
            raise ValueError("sync_sgd averages every step; tau must be 1")
        if elastic_tau:
            raise NotImplementedError("elastic τ is not ported yet")
        if tp != 1:
            raise NotImplementedError("tensor parallelism is not ported yet")
        if solver_cfg.iter_size != 1:
            raise ValueError(
                "iter_size > 1 is a single-net accumulation feature "
                "(SgdSolver.step); in the distributed trainer scale "
                "local_batch or tau instead")
        self.net = net
        self.solver = SgdSolver(net, solver_cfg, loss_blob=loss_blob,
                                ops=ops)
        self.group = group
        self.device = group.device
        self.tau = tau
        self.mode = mode
        self.loss_blob = loss_blob
        self.acc_blob = acc_blob
        self.compute_health = bool(compute_health)
        self.ops = ops or OpsImpl()
        #: {"grad_norm", "nonfinite", "nonfinite_by_worker"} of the last
        #: round as device tensors (None when compute_health is off)
        self.last_health: Optional[Dict[str, torch.Tensor]] = None

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """Caffe-filler params from `seed` (drawn on the CPU, so every rank
        starts from the same weights)."""
        return self.state_from_params(self.net.init_params(
            torch.Generator().manual_seed(seed), torch.device("cpu")))

    def state_from_params(self, params: ParamTree,
                          momentum: Optional[ParamTree] = None,
                          it: int = 0) -> TrainState:
        """A TrainState on this rank's device from one logical copy of the
        params (PyTorch layouts), momentum zeros unless given."""
        flat_p, views = _flat_tree(params, torch.float32, self.device)
        for lp in views.values():
            for v in lp.values():
                v.requires_grad_(True)  # leaves of autograd, views of flat_p
        vdt = precision.DTYPES[self.solver.cfg.velocity_dtype]
        flat_m, mom = _flat_tree(momentum or params, vdt, self.device,
                                 zeros=momentum is None)
        return TrainState(views, mom, int(it), flat_p, flat_m)

    # -- one round -----------------------------------------------------------

    def place_batches(self, batches: Mapping[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """This rank's [tau, local_batch, ...] host arrays on the device:
        float inputs in the compute dtype (the JAX package's
        `cast_host_inputs`), the rest in the net's declared dtype."""
        for name, arr in batches.items():
            if arr.shape[0] != self.tau:
                raise ValueError(f"{name}: leading dim {arr.shape[0]} != "
                                 f"tau {self.tau}")
        return self._to_device(batches)

    def _to_device(self, batch: Mapping[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        out = {}
        for name, dt in self.net.input_dtypes.items():
            if name not in batch:
                raise ValueError(f"batch missing net input {name!r}")
            t = torch.as_tensor(np.ascontiguousarray(batch[name])).to(
                self.device)
            out[name] = t.to(precision.compute_dtype() if dt == "float32"
                             else precision.DTYPES[dt])
        return out

    def train_round(self, state: TrainState,
                    batches: Mapping[str, np.ndarray],
                    rng: Union[int, Sequence[int]], lr_scale: float = 1.0
                    ) -> Tuple[TrainState, torch.Tensor]:
        """One outer round on this rank: τ local steps on its own
        [tau, local_batch, ...] batches, then the average. `rng` keys the
        round (the loop passes (seed, round)); step t draws its dropout
        masks from (rng..., rank, t). Returns (state, mean loss) — the
        state updated in place; the health scalars land in `last_health`.
        """
        keys = (rng,) if isinstance(rng, int) else tuple(rng)
        placed = self.place_batches(batches)
        loss_fn = self.net.loss_fn(self.loss_blob, ops=self.ops)
        sstate = SolverState(momentum=state.momentum, it=state.it)
        g = self.group
        losses, grad_sqs = [], []
        for t in range(self.tau):
            batch = {k: v[t] for k, v in placed.items()}
            gen = seeded_generator(keys + (g.rank, t))
            loss, grads = value_and_grad(loss_fn, state.params, batch, gen)
            if self.compute_health:
                # this step's LOCAL squared norm, before any average, in
                # the JAX package's leaf order (sorted names)
                grad_sqs.append(sum(
                    torch.sum(torch.square(grads[l][p].float()))
                    for l in sorted(grads) for p in sorted(grads[l])))
            if self.mode == "sync_sgd":
                grads, loss = self._mean_grads(grads, loss)
            self.solver.update(state.params, sstate, grads,
                               lr_scale=lr_scale)
            losses.append(loss.float())
        state.it = sstate.it
        losses = torch.stack(losses)
        with torch.no_grad():
            if self.compute_health:
                # pre-average: after the average one rank's NaN is every
                # rank's, so attribution reads the local state first
                finite_local = (torch.isfinite(losses).all()
                                & torch.isfinite(state.flat_params).all()
                                & torch.isfinite(
                                    state.flat_momentum.float()).all())
            if self.mode == "local_sgd":
                g.all_reduce_mean_(state.flat_params)
            parts = [losses.mean()[None]]
            if self.compute_health:
                finite_avg = torch.isfinite(state.flat_params).all()
                row = torch.zeros(g.size, device=self.device)
                row[g.rank] = 1.0
                parts += [torch.stack(grad_sqs).max()[None],
                          row * (~finite_local).float(),
                          (~finite_avg).float()[None]]
            scalars = g.all_reduce_sum_(torch.cat(parts))
        mean_loss = scalars[0] / g.size
        self.last_health = None
        if self.compute_health:
            by_worker = scalars[2:2 + g.size]
            self.last_health = {
                "grad_norm": torch.sqrt(scalars[1]),
                "nonfinite": torch.maximum(
                    by_worker.sum(), torch.clamp(scalars[-1], max=1.0)),
                "nonfinite_by_worker": by_worker}
        return state, mean_loss

    def _mean_grads(self, grads: ParamTree, loss: torch.Tensor):
        """sync_sgd: the group mean of one step's grads (one flat
        collective) and loss."""
        order = [(l, p) for l in grads for p in grads[l]]
        flat = torch.cat([grads[l][p].reshape(-1) for l, p in order]
                         + [loss.float().reshape(1)])
        self.group.all_reduce_mean_(flat)
        out: ParamTree = {}
        off = 0
        for l, p in order:
            n = grads[l][p].numel()
            out.setdefault(l, {})[p] = flat[off:off + n].view(
                grads[l][p].shape)
            off += n
        return out, flat[-1]

    # -- eval ----------------------------------------------------------------

    def evaluate(self, state: TrainState,
                 batch: Mapping[str, np.ndarray]) -> float:
        """Accuracy over the group: psum(correct) / psum(n), this rank
        contributing its own `batch` (the reference's eval reduce)."""
        acc_blob = self.acc_blob or _find_accuracy_blob(self.net)
        placed = self._to_device(batch)
        with torch.no_grad():
            blobs = self.net.apply(state.params, placed, train=False,
                                   ops=self.ops)
            n = next(iter(placed.values())).shape[0]
            tot = torch.stack([blobs[acc_blob].float() * n,
                               torch.tensor(float(n), device=self.device)])
            self.group.all_reduce_sum_(tot)
        return float(tot[0] / tot[1])

    def resized(self, n_devices: int) -> "ParallelTrainer":
        raise NotImplementedError("elastic resize is not ported yet")


def _find_accuracy_blob(net: CompiledNet) -> str:
    for layer in net.spec.layers:
        if layer.type == "Accuracy":
            return layer.tops[0]
    raise ValueError("net has no Accuracy layer; pass acc_blob=")
