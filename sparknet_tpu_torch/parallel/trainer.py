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

Placement (`place_batches`, the H2D half of a round; the JAX package's
l.809-889). A round's host arrays are cast to the compute dtype, staged in
pinned host memory and copied with `non_blocking=True` on a copy stream of
the trainer's own; an event recorded after the copies is what the compute
stream waits on before the round's first step reads the batch. So the train
loop's round-prep thread can place round R+1 while round R computes, and
`train_round` takes either host arrays (placed inline) or a
`PlacedBatches`. Buffer lifetimes across the two streams:
  - pinned staging buffers come from PyTorch's pinned-memory cache, which
    keeps a block until the copy that read it has completed;
  - `donate_batches=True` (the JAX package's buffer donation): placed
    rounds rotate through two device slots. Round R+1 is copied into the
    slot round R-1 used, after the copy stream has waited on the event
    the compute stream recorded when round R-1's last step was queued; the
    slot of round R is untouched while round R runs;
  - `donate_batches=False`: each round gets fresh device buffers,
    allocated on the copy stream and marked (`record_stream`) as used by
    the compute stream, so the caching allocator cannot hand them to a
    later copy while round R still reads them.
With a `phase_timers` installed (the train loop's, under telemetry) a round
splits its wall time into "h2d" (placement; a pass-through for a placed
round) and "dispatch" (queueing the τ steps and the average).

At the checkpoint boundary (`checkpoint_tree` / `state_from_checkpoint`)
the state takes the JAX package's replica layout: every leaf has a leading
[world] axis, params in the JAX layouts (conv HWIO, inner product (in,
out)) and replicated, momentum gathered per rank (row r is rank r's own,
never averaged), `it` as [world] int32. Each package restores the other's
checkpoints. A step of another world size restores through `adapt_state`
(the elastic resume): the params are row 0 and exact, and each rank's
momentum is reconstructed from all the old rows (`reduce_momentum_rows`).

Per-worker τ (`elastic_tau=True`; the JAX package's masked round): with
`train_round(..., tau_by_worker=[τ_r per rank])` rank r runs its first
τ_r steps and skips the rest — where the JAX package runs them as masked
no-ops — with the same per-step dropout generators; `it` still advances
by the nominal τ, the loss is each rank's sum(losses) / τ_r averaged over
the ranks, and the grad norm takes each rank's worst executed step. A full
vector runs the unmasked round.

Not ported: tensor parallelism (raises NotImplementedError), and `resized`
— a port process drives one card and cannot change its world in place, so
a membership change relaunches the run (`parallel/elastic.py`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import precision
from ..model.layers import OpsImpl, seeded_generator
from ..model.net import (CompiledNet, ParamTree, jax_param_shapes,
                         params_from_jax)
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


class PlacedBatches(dict):
    """One round's batches on the trainer's device, as `place_batches`
    returns them: {input: [tau, local_batch, ...] tensor}, float inputs in
    the compute dtype. `ready` is the CUDA event recorded on the copy
    stream after the copies (None on the CPU), `slot` the device slot the
    round occupies under `donate_batches` (else None), `nbytes` the bytes
    copied to the device."""

    def __init__(self, tensors: Dict[str, torch.Tensor], ready=None,
                 slot: Optional[int] = None, nbytes: int = 0):
        super().__init__(tensors)
        self.ready = ready
        self.slot = slot
        self.nbytes = nbytes


class ParallelTrainer:
    """τ-round data-parallel trainer over a `DataGroup`.

    mode: "local_sgd" (τ steps then the param average — the reference's
    scheme) or "sync_sgd" (per-step gradient average, τ must be 1).
    """

    def __init__(self, net: CompiledNet, solver_cfg: SolverConfig,
                 group: DataGroup, tau: int = 10, mode: str = "local_sgd",
                 loss_blob: str = "loss", acc_blob: Optional[str] = None,
                 compute_health: bool = True, elastic_tau: bool = False,
                 tp: int = 1, ops: Optional[OpsImpl] = None,
                 donate_batches: bool = False):
        if mode not in ("local_sgd", "sync_sgd"):
            raise ValueError(f"unknown mode {mode!r}: expected 'local_sgd' "
                             f"or 'sync_sgd'")
        if mode == "sync_sgd" and tau != 1:
            raise ValueError("sync_sgd averages every step; tau must be 1")
        if elastic_tau and mode != "local_sgd":
            raise ValueError("elastic_tau (per-worker local steps) only "
                             "makes sense in local_sgd mode")
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
        self.elastic_tau = bool(elastic_tau)
        self.ops = ops or OpsImpl()
        #: {"grad_norm", "nonfinite", "nonfinite_by_worker"} of the last
        #: round as device tensors, fresh each round (None when
        #: compute_health is off)
        self.last_health: Optional[Dict[str, torch.Tensor]] = None
        self.donate_batches = bool(donate_batches)
        #: optional PhaseTimers: train_round then times "h2d" and "dispatch"
        self.phase_timers = None
        # placement state (CUDA): the copy stream, the two donated slots
        # ({input: tensor} each) and the event that frees each one
        self._copy_stream = None
        self._slots = [None, None]
        self._slot_free = [None, None]
        self._next_slot = 0
        self._place_lock = threading.Lock()
        #: bytes the last round copied to the device (0 on the CPU)
        self.h2d_bytes = 0

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

    # -- the checkpoint boundary ---------------------------------------------

    def _host_leaves(self, host_flat: torch.Tensor, like: ParamTree
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
        """[rows, total] host copy of a flat buffer laid out as `like` (a
        state's tree of views) -> {layer: {param: [rows, *JAX shape]}}, in
        sorted order (the JAX package's leaf order), contiguous."""
        types = {l.name: l.type for l in self.net.spec.layers}
        rows = host_flat.shape[0]
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        off = 0
        for lname, lp in like.items():
            for pname, v in lp.items():
                t = host_flat[:, off:off + v.numel()].view((rows,) + v.shape)
                off += v.numel()
                if pname == "w" and types[lname] == "Convolution":
                    t = t.permute(0, 3, 4, 2, 1)   # OIHW -> HWIO
                elif pname == "w" and types[lname] == "InnerProduct":
                    t = t.permute(0, 2, 1)         # (out, in) -> (in, out)
                out.setdefault(lname, {})[pname] = t.contiguous()
        return {l: dict(sorted(out[l].items())) for l in sorted(out)}

    def checkpoint_tree(self, state: TrainState) -> Dict[str, Any]:
        """The state in the JAX package's replica layout, as host memory
        this call owns (a later round's in-place update cannot tear it):
        {"params": {layer: {param: [world, ...]}}, "momentum": ...,
        "it": [world] int32}. f32 leaves are numpy; a bfloat16 momentum
        stays a CPU tensor (the checkpoint store keeps its bits). A
        collective: every rank must call it (the momentum all-gather)."""
        world = self.group.size
        with torch.no_grad():
            mom_dev = self.group.all_gather(state.flat_momentum)
            p_host = state.flat_params.detach().to("cpu", copy=True)[None]
            m_host = mom_dev.to("cpu", copy=True)
        params = {l: {p: np.broadcast_to(t.numpy(), (world,) + t.shape[1:])
                      for p, t in lp.items()}
                  for l, lp in self._host_leaves(p_host,
                                                 state.params).items()}
        momentum = {l: {p: (t if t.dtype == torch.bfloat16 else t.numpy())
                        for p, t in lp.items()}
                    for l, lp in self._host_leaves(m_host,
                                                   state.momentum).items()}
        return {"params": params, "momentum": momentum,
                "it": np.full((world,), state.it, np.int32)}

    def saved_world(self, flat: Mapping[str, Any],
                     extra: Mapping[str, Any]) -> int:
        """The world size that wrote a checkpoint (from `extra`, else the
        leading axis of `it`); raise ValueError unless the rest of its
        topology — tp, layout, state sharding — is this trainer's (the
        reference's `_restore_state` test; those trainers are ROADMAP
        A11)."""
        saved = extra.get("n_devices")
        if saved is None and "it" in flat and np.ndim(flat["it"]):
            saved = np.shape(flat["it"])[0]
        rest = (int(extra.get("tp", 1)), extra.get("layout", "replica"),
                extra.get("state_sharding", "replicated"))
        if rest != (1, "replica", "replicated"):
            raise ValueError(
                f"checkpoint topology (tp, layout, state_sharding) = {rest} "
                f"!= this run's (1, 'replica', 'replicated'): the tensor-"
                f"parallel and NamedSharding trainers are not ported "
                f"(ROADMAP A11)")
        return int(saved or self.group.size)

    def state_from_checkpoint(self, flat: Mapping[str, Any],
                              extra: Optional[Mapping[str, Any]] = None,
                              momentum_policy: str = "norm_rescale"
                              ) -> TrainState:
        """A restored flat map (`checkpoint.restore_flat`, either package's)
        -> this rank's TrainState. A step of this world size restores the
        params row of this rank, its own momentum row and `it`, as
        written; a step of another world size takes `adapt_state` with
        `momentum_policy` (the elastic resume). Another tp, layout or
        state sharding raises ValueError."""
        self.saved_world(flat, extra or {})
        return self.adapt_state(flat, momentum_policy=momentum_policy)

    def adapt_state(self, flat: Mapping[str, Any], old_tp: int = 1,
                    momentum_policy: str = "norm_rescale",
                    old_layout: str = "replica") -> TrainState:
        """The elastic resume (the JAX package's `adapt_state`): this
        rank's TrainState from a replica-layout step written by another
        world size. The params are row 0, exact: after the round's
        average every row is the same model. Momentum is rank-local
        state with no continuity across a topology change, so every rank
        takes the same reconstruction from all the old rows,
        `reduce_momentum_rows(rows, momentum_policy)` in numpy:
        "norm_rescale" (the mean rescaled to the rows' mean norm),
        "average" or "zero". A step of this world size restores each
        rank's own row as written, whatever the policy. `it` is row 0's.

        `old_layout="logical"` (the NamedSharding trainer's steps) and
        `old_tp > 1` raise NotImplementedError: those trainers are ROADMAP
        A11."""
        if momentum_policy not in ("average", "zero", "norm_rescale"):
            raise ValueError(f"unknown momentum_policy {momentum_policy!r}")
        if old_layout != "replica" or old_tp != 1:
            raise NotImplementedError(
                f"adapt_state of a {old_layout!r}-layout step at tp="
                f"{old_tp}: the NamedSharding and tensor-parallel trainers "
                f"are not ported (ROADMAP A11)")
        old_n = int(np.shape(flat["it"])[0]) if np.ndim(flat["it"]) else 1
        if old_n == self.group.size:
            r = self.group.rank
            return self._state_from_rows(
                flat, lambda kind, rows: rows[r],
                int(np.asarray(flat["it"]).reshape(-1)[r]))

        def pick(kind, rows):
            if kind == "params":
                return rows[0]
            if isinstance(rows, torch.Tensor):  # a bfloat16 momentum
                return torch.from_numpy(reduce_momentum_rows(
                    rows.float().numpy(), momentum_policy)).to(rows.dtype)
            return reduce_momentum_rows(np.asarray(rows), momentum_policy)

        return self._state_from_rows(
            flat, pick, int(np.asarray(flat["it"]).reshape(-1)[0]))

    def _state_from_rows(self, flat: Mapping[str, Any], pick, it: int
                         ) -> TrainState:
        """A TrainState from a replica-layout flat map: `pick(kind,
        [rows, *JAX shape])` gives each leaf's one JAX-layout value."""
        types = {l.name: l.type for l in self.net.spec.layers}
        vdt = precision.DTYPES[self.solver.cfg.velocity_dtype]
        rows = {}
        for l, lp in jax_param_shapes(self.net).items():
            rows[l] = {}
            for p in lp:
                if f"params/{l}/{p}" not in flat:
                    raise ValueError(f"checkpoint missing leaf "
                                     f"'params/{l}/{p}'")
                rows[l][p] = pick("params",
                                  np.asarray(flat[f"params/{l}/{p}"]))
        params = params_from_jax(self.net, rows, torch.device("cpu"))
        momentum: ParamTree = {}
        for lname, lp in params.items():
            momentum[lname] = {}
            for pname, w in lp.items():
                key = f"momentum/{lname}/{pname}"
                if key not in flat:
                    raise ValueError(f"checkpoint missing leaf {key!r}")
                m = pick("momentum", flat[key])
                m = m if isinstance(m, torch.Tensor) else torch.from_numpy(
                    np.ascontiguousarray(m))
                if m.dtype != vdt:
                    raise ValueError(
                        f"{key}: checkpoint dtype {m.dtype} != the solver's "
                        f"velocity_dtype {self.solver.cfg.velocity_dtype}")
                if pname == "w" and types[lname] == "Convolution":
                    m = m.permute(3, 2, 0, 1)  # HWIO -> OIHW
                elif pname == "w" and types[lname] == "InnerProduct":
                    m = m.t()
                if tuple(m.shape) != tuple(w.shape):
                    raise ValueError(f"{key}: shape {tuple(m.shape)} != net "
                                     f"{tuple(w.shape)} (port layout)")
                momentum[lname][pname] = m
        return self.state_from_params(params, momentum, it)

    # -- one round -----------------------------------------------------------

    def place_batches(self, batches: Mapping[str, Any],
                      compute_dt: Optional[torch.dtype] = None
                      ) -> PlacedBatches:
        """This rank's [tau, local_batch, ...] batches on the device (see
        the module docstring). Float inputs take the compute dtype
        `compute_dt` (pass it from a thread other than the one that set
        the policy: the policy is thread-local), the rest their declared
        dtype. A `PlacedBatches` passes through. A tensor already on a
        device (on the CPU trainer: any tensor) counts as placed and must
        already have this trainer's device, dtype and shape: a mismatch
        raises ValueError rather than being fixed by a hidden copy."""
        if isinstance(batches, PlacedBatches):
            return batches
        dt = compute_dt if compute_dt is not None \
            else precision.compute_dtype()
        host = precision.cast_host_inputs(
            {k: v for k, v in batches.items()
             if not isinstance(v, torch.Tensor) or v.device.type == "cpu"},
            dt)
        placed: Dict[str, torch.Tensor] = {}
        todo: Dict[str, Tuple[torch.Tensor, torch.dtype]] = {}
        for name, decl in self.net.input_dtypes.items():
            if name not in batches:
                raise ValueError(f"batch missing net input {name!r}")
            want = dt if decl == "float32" else precision.DTYPES[decl]
            v = batches[name]
            if isinstance(v, torch.Tensor) and (
                    v.device.type != "cpu" or self.device.type == "cpu"):
                self._check_placed(name, v, want)
                placed[name] = v
                continue
            v = host[name]
            t = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(v))
            if t.ndim == 0 or t.shape[0] != self.tau:
                raise ValueError(f"{name}: leading dim "
                                 f"{tuple(t.shape)[:1]} != tau {self.tau}")
            todo[name] = (t, want)
        if self.device.type == "cpu":
            placed.update({k: t.to(want) for k, (t, want) in todo.items()})
            return PlacedBatches(placed)
        if not todo:
            return PlacedBatches(placed)
        return self._copy_to_device(placed, todo)

    def _check_placed(self, name: str, t: torch.Tensor,
                      want: torch.dtype) -> None:
        if t.device != self.device:
            raise ValueError(f"{name}: placed tensor is on {t.device}, the "
                             f"trainer on {self.device}; pass host arrays "
                             f"or place them with place_batches")
        if t.dtype != want:
            raise ValueError(f"{name}: placed tensor has dtype {t.dtype}, "
                             f"but the compute dtype is {want}: place via "
                             f"place_batches (it casts), or cast first")
        if t.ndim == 0 or t.shape[0] != self.tau:
            raise ValueError(f"{name}: leading dim {tuple(t.shape)[:1]} != "
                             f"tau {self.tau}")

    def _copy_to_device(self, placed: Dict[str, torch.Tensor],
                        todo: Dict[str, Tuple[torch.Tensor, torch.dtype]]
                        ) -> PlacedBatches:
        """Pinned staging, then async copies on the copy stream into the
        next donated slot or fresh buffers; an input whose host dtype is
        not the one the net takes (int8 pixels) crosses in its own dtype
        and is cast on the card. Returns the round with the event the
        compute stream waits on."""
        with self._place_lock, torch.cuda.device(self.device):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            stream = self._copy_stream
            slot = None
            if self.donate_batches:
                slot = self._next_slot
                self._next_slot ^= 1
                if self._slot_free[slot] is not None:
                    # the round that last read this slot has been queued;
                    # its copy waits for it on the device, not the host
                    stream.wait_event(self._slot_free[slot])
            nbytes = 0
            with torch.cuda.stream(stream):
                for name, (t, want) in todo.items():
                    stage = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                    if not stage.is_pinned():
                        raise RuntimeError(f"{name}: pinned staging "
                                           f"failed; refusing a pageable "
                                           f"copy")
                    stage.copy_(t)
                    nbytes += stage.numel() * stage.element_size()
                    dev = None
                    if slot is not None:
                        cur = (self._slots[slot] or {}).get(name)
                        if cur is not None and cur.shape == t.shape and \
                                cur.dtype == want:
                            dev = cur
                    if dev is None:
                        dev = torch.empty(t.shape, dtype=want,
                                          device=self.device)
                        if slot is not None:
                            self._slots[slot] = dict(self._slots[slot] or {},
                                                     **{name: dev})
                    if t.dtype == want:
                        dev.copy_(stage, non_blocking=True)
                    else:
                        dev.copy_(stage.to(self.device, non_blocking=True))
                    placed[name] = dev
                ready = torch.cuda.Event()
                ready.record(stream)
            return PlacedBatches(placed, ready=ready, slot=slot,
                                 nbytes=nbytes)

    def _to_device(self, batch: Mapping[str, Any]
                   ) -> Dict[str, torch.Tensor]:
        """One (eval) batch on the device, synchronously: float inputs in
        the compute dtype, the rest in the net's declared dtype."""
        out = {}
        for name, dt in self.net.input_dtypes.items():
            if name not in batch:
                raise ValueError(f"batch missing net input {name!r}")
            v = batch[name]
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                np.ascontiguousarray(v))
            out[name] = t.to(self.device).to(
                precision.compute_dtype() if dt == "float32"
                else precision.DTYPES[dt])
        return out

    def train_round(self, state: TrainState, batches: Mapping[str, Any],
                    rng: Union[int, Sequence[int]], lr_scale: float = 1.0,
                    tau_by_worker: Optional[Sequence[int]] = None
                    ) -> Tuple[TrainState, torch.Tensor]:
        """One outer round on this rank: τ local steps on its own
        [tau, local_batch, ...] batches (host arrays, or a round placed by
        `place_batches`), then the average. `rng` keys the round (the loop
        passes (seed, round)); step t draws its dropout masks from
        (rng..., rank, t). Returns (state, mean loss) — the state updated
        in place; the health scalars land in `last_health`. On the card
        the call returns once the round is queued.

        `tau_by_worker` (elastic_tau trainers only): one local-step budget
        per rank, clipped to [1, tau]; this rank runs its first budget's
        steps (module docstring). None = full τ everywhere."""
        my_tau = None
        if self.elastic_tau:
            if tau_by_worker is not None:
                vec = [int(min(self.tau, max(1, t))) for t in tau_by_worker]
                if len(vec) != self.group.size:
                    raise ValueError(
                        f"tau_by_worker has {len(vec)} entries for "
                        f"{self.group.size} ranks")
                my_tau = vec[self.group.rank]
        elif tau_by_worker is not None:
            raise ValueError("tau_by_worker requires a trainer built with "
                             "elastic_tau=True")
        timers = self.phase_timers
        if timers is None:
            placed = self.place_batches(batches)
            return self._round(state, placed, rng, lr_scale, my_tau)
        with timers.phase("h2d"):
            placed = self.place_batches(batches)
        with timers.phase("dispatch"):
            return self._round(state, placed, rng, lr_scale, my_tau)

    def _round(self, state: TrainState, placed: PlacedBatches,
               rng: Union[int, Sequence[int]], lr_scale: float,
               my_tau: Optional[int] = None
               ) -> Tuple[TrainState, torch.Tensor]:
        keys = (rng,) if isinstance(rng, int) else tuple(rng)
        # this rank's executed steps: a budget below τ skips the rest
        n_steps = self.tau if my_tau is None else my_tau
        it0 = state.it
        self.h2d_bytes = placed.nbytes
        if placed.ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(placed.ready)
            for t in placed.values():
                t.record_stream(compute)
        loss_fn = self.net.loss_fn(self.loss_blob, ops=self.ops)
        sstate = SolverState(momentum=state.momentum, it=state.it)
        g = self.group
        losses, grad_sqs = [], []
        for t in range(n_steps):
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
        # the schedule clock advances by the nominal τ on every rank: the
        # lr policy must not diverge across the group
        state.it = it0 + self.tau
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
            # a budget below τ: the mean over the steps this rank ran
            parts = [(losses.mean() if n_steps == self.tau
                      else losses.sum() / max(n_steps, 1))[None]]
            if self.compute_health:
                finite_avg = torch.isfinite(state.flat_params).all()
                row = torch.zeros(g.size, device=self.device)
                row[g.rank] = 1.0
                parts += [torch.stack(grad_sqs).max()[None],
                          row * (~finite_local).float(),
                          (~finite_avg).float()[None]]
            scalars = g.all_reduce_sum_(torch.cat(parts))
        mean_loss = scalars[0] / g.size
        if placed.slot is not None:
            free = torch.cuda.Event()
            free.record(torch.cuda.current_stream(self.device))
            self._slot_free[placed.slot] = free
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
        """The JAX package's live resize has no counterpart: a port process
        drives one card, and a torch process group cannot drop or add a
        member in place. A membership change relaunches the run instead
        (`ElasticRelaunch`, exit 75) and the relaunched world restores
        through `state_from_checkpoint` / `adapt_state`."""
        raise NotImplementedError(
            f"resized({n_devices}): a port process drives one card and "
            f"cannot change its world in place; a membership change "
            f"relaunches the run (ElasticRelaunch, exit 75), which resumes "
            f"at the new size through adapt_state")


def reduce_momentum_rows(rows: np.ndarray, policy: str) -> np.ndarray:
    """Reconstruct one momentum from k per-rank velocity rows — the
    elastic resume's reconstruction (a copy of the JAX package's, numpy).
    f32 accumulator: a bf16 velocity must not be averaged in bf16."""
    avg = rows.mean(axis=0, dtype=np.float32)
    if policy == "zero":
        return np.zeros_like(avg).astype(rows.dtype)
    if policy == "norm_rescale":
        # averaging k partially decorrelated velocities shrinks the norm
        # ~1/sqrt(k); rescale the mean back to the mean per-rank norm so
        # the first steps after the resume keep their step size
        target = float(np.mean([np.linalg.norm(
            r.astype(np.float32)) for r in rows]))
        cur = float(np.linalg.norm(avg))
        if cur > 0:
            avg = avg * (target / cur)
    return avg.astype(rows.dtype)


def _find_accuracy_blob(net: CompiledNet) -> str:
    for layer in net.spec.layers:
        if layer.type == "Accuracy":
            return layer.tops[0]
    raise ValueError("net has no Accuracy layer; pass acc_blob=")
