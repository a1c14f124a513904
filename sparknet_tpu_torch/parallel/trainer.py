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
checkpoints. A step of another topology (world size, tp, or the logical
layout of `parallel/sharded.py`) restores through `adapt_state` (the
elastic resume): the params are data group 0's, put back together across
the old model ranks, and exact; each rank's momentum is reconstructed
from the old rows (`reduce_momentum_rows`), or taken as written where the
rows map one to one.

Per-worker τ (`elastic_tau=True`; the JAX package's masked round): with
`train_round(..., tau_by_worker=[τ_r per rank])` rank r runs its first
τ_r steps and skips the rest — where the JAX package runs them as masked
no-ops — with the same per-step dropout generators; `it` still advances
by the nominal τ, the loss is each rank's sum(losses) / τ_r averaged over
the ranks, and the grad norm takes each rank's worst executed step. A full
vector runs the unmasked round.

Tensor parallelism (`tp` > 1; the JAX package's ("data", "model") mesh):
the world is n_data x tp ranks on a `mesh.ProcessGrid`, rank r at data
index r // tp and model index r % tp. The InnerProducts `tp_shards_layer`
names hold a column shard (rows of the port's (out, in) w) and gather
their features over the model group (`model/layers.py:_GatherColumns`,
whose backward reduce-scatters the cotangent); every other layer is
replicated across it. A model group sees one batch and one dropout key
(the data index's). `_fix_tp_grads` makes the gradients exact, as the
JAX package's `fix_tp_grads` does: shard gradients / tp, the replicated
layers' gradients summed over the model group / tp (`lax.pmean`'s order).
The params are averaged over the data group only, so each model rank
averages its own shard with its peers; the loss, grad norm, nonfinite
flags and eval accuracy are then averaged over the model group. At the
checkpoint boundary row r of a leaf is rank r's, so a sharded layer's
rows are its column shards in the JAX layout; `averaged_params` puts
them back together (a collective above tp = 1).

Not ported: `resized` — a port process drives one card and cannot change
its world in place, so a membership change relaunches the run
(`parallel/elastic.py`).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import precision
from ..model.layers import OpsImpl, seeded_generator, tp_shards_layer
from ..model.net import (CompiledNet, ParamTree, jax_leaf, jax_param_shapes,
                         port_leaf)
from ..solver import SgdSolver, SolverConfig, SolverState, value_and_grad
from .mesh import DataGroup, make_grid, plan_state_shards



@dataclasses.dataclass
class TrainState:
    """One rank's training state at rest. `params` and `momentum` are trees
    of views into `flat_params` / `flat_momentum`; the round updates them
    in place. Under TP a sharded layer's leaves are this rank's column
    shard; under a ZeRO state sharding (`parallel/sharded.py`) a split
    leaf is this rank's piece. `head` is the first element of the first
    param leaf where the params at rest are split ("full"), else None."""

    params: ParamTree
    momentum: ParamTree
    it: int
    flat_params: torch.Tensor
    flat_momentum: torch.Tensor
    head: Optional[torch.Tensor] = None


def _host(t: Any) -> Any:
    """A CPU tensor as the checkpoint stores it: numpy, a bfloat16 tensor
    as itself (numpy has no bfloat16)."""
    if isinstance(t, torch.Tensor) and t.dtype != torch.bfloat16:
        return t.numpy()
    return t


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
        #: the (data, model) grid: `data` averages, `model` gathers (None
        #: at tp = 1, where `data` is the world)
        self.grid = make_grid(group, int(tp))
        self.data = self.grid.data
        self.model = self.grid.model
        self.tp = int(tp)
        self.n_devices = group.size
        self.n_data = self.grid.n_data
        self._tp_layers = self._tp_sharded_layers()
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

    #: the checkpoint layout: every leaf carries the leading [world] axis
    #: (the sharded trainer's is "logical"), stamped into `extra["layout"]`
    #: by the train loop when it is not this one
    state_layout = "replica"
    #: the ZeRO split of the state at rest (the sharded trainer's knob;
    #: every rank here holds all of its own state)
    state_sharding = "replicated"

    def _tp_sharded_layers(self) -> set:
        """Layer names whose params are column-sharded over the model group
        (the shared `tp_shards_layer` convention)."""
        return {l.name for l in self.net.spec.layers
                if tp_shards_layer(l, self.tp)}

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """Caffe-filler params from `seed` (drawn on the CPU, so every rank
        starts from the same weights)."""
        return self.state_from_params(self.net.init_params(
            torch.Generator().manual_seed(seed), torch.device("cpu")))

    def _split_tp(self, tree: Optional[ParamTree]) -> Optional[ParamTree]:
        """This model rank's column shard of each sharded layer's leaves in
        a logical (full) port-layout tree: rows [m*out/tp, (m+1)*out/tp) of
        w (out, in) and of b."""
        if tree is None or self.tp == 1:
            return tree
        m = self.model.rank
        return {l: {p: (t.chunk(self.tp, 0)[m] if l in self._tp_layers
                        else t) for p, t in lp.items()}
                for l, lp in tree.items()}

    def state_from_params(self, params: ParamTree,
                          momentum: Optional[ParamTree] = None,
                          it: int = 0) -> TrainState:
        """A TrainState on this rank's device from one logical copy of the
        params (PyTorch layouts), momentum zeros unless given (one logical
        tree, split as the params are)."""
        return self._make_state(self._split_tp(params),
                                self._split_tp(momentum), it)

    def _make_state(self, params: ParamTree, momentum: Optional[ParamTree],
                    it: int) -> TrainState:
        """A TrainState from this rank's own leaves, copied into flat
        buffers on the device."""
        flat_p, views = _flat_tree(params, torch.float32, self.device)
        for lp in views.values():
            for v in lp.values():
                v.requires_grad_(True)  # leaves of autograd, views of flat_p
        vdt = precision.DTYPES[self.solver.cfg.velocity_dtype]
        flat_m, mom = _flat_tree(momentum or params, vdt, self.device,
                                 zeros=momentum is None)
        return TrainState(views, mom, int(it), flat_p, flat_m)

    def averaged_params(self, state: TrainState) -> ParamTree:
        """One logical copy of the (synchronized) params, PyTorch layouts:
        the state's own at tp = 1; under TP each sharded layer's column
        shards put back together over the model group (a collective: every
        rank calls it). Detached; at tp = 1 they share the state's
        storage."""
        params = {l: {p: t.detach() for p, t in lp.items()}
                  for l, lp in state.params.items()}
        return self._gather_tp(params)

    def _gather_tp(self, tree: ParamTree) -> ParamTree:
        """A tree whose sharded layers hold this rank's column shards ->
        the logical tree, all shards in one all-gather over the model
        group."""
        if self.tp == 1:
            return tree
        keys = [(l, p) for l in tree if l in self._tp_layers
                for p in tree[l]]
        if not keys:
            return tree
        mine = torch.cat([tree[l][p].reshape(-1) for l, p in keys])
        rows = self.model.all_gather_flat(mine).view(self.tp, -1)
        out = {l: dict(lp) for l, lp in tree.items()}
        off = 0
        for l, p in keys:
            t = tree[l][p]
            out[l][p] = torch.cat([rows[j, off:off + t.numel()].view(t.shape)
                                   for j in range(self.tp)])
            off += t.numel()
        return out

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
                out.setdefault(lname, {})[pname] = jax_leaf(
                    types[lname], pname, t)
        return {l: dict(sorted(out[l].items())) for l in sorted(out)}

    def checkpoint_tree(self, state: TrainState) -> Dict[str, Any]:
        """The state in the JAX package's replica layout, as host memory
        this call owns (a later round's in-place update cannot tear it):
        {"params": {layer: {param: [world, ...]}}, "momentum": ...,
        "it": [world] int32}; under TP row r of a sharded layer is rank r's
        column shard. f32 leaves are numpy; a bfloat16 momentum stays a
        CPU tensor (the checkpoint store keeps its bits). A collective:
        every rank must call it (the momentum all-gather, and the params'
        under TP)."""
        world = self.group.size
        with torch.no_grad():
            mom_dev = self.group.all_gather(state.flat_momentum)
            if self.tp == 1:
                p_host = state.flat_params.detach().to("cpu", copy=True)[None]
            else:
                p_host = self.group.all_gather(
                    state.flat_params.detach()).to("cpu", copy=True)
            m_host = mom_dev.to("cpu", copy=True)
        params = {l: {p: (np.broadcast_to(t.numpy(),
                                          (world,) + t.shape[1:])
                          if self.tp == 1 else t.numpy())
                      for p, t in lp.items()}
                  for l, lp in self._host_leaves(p_host,
                                                 state.params).items()}
        momentum = {l: {p: _host(t) for p, t in lp.items()}
                    for l, lp in self._host_leaves(m_host,
                                                   state.momentum).items()}
        return {"params": params, "momentum": momentum,
                "it": np.full((world,), state.it, np.int32)}

    def checkpoint_shards(self, state: TrainState) -> Dict[str, Any]:
        """Stage 1 of a per-shard save: this rank's row of every leaf of
        the replica layout — its params, its momentum and `it` — as host
        memory the snapshot owns, in the piece plan of
        `mesh.plan_state_shards` (file r is rank r's). No collective and
        no gather: each rank copies only its own state off the card. A
        bfloat16 momentum stays a CPU tensor."""
        with torch.no_grad():
            p_host = state.flat_params.detach().to("cpu", copy=True)[None]
            m_host = state.flat_momentum.detach().to("cpu", copy=True)[None]
        rows: Dict[str, Any] = {"it": np.full((1,), state.it, np.int32)}
        for kind, host, like in (("params", p_host, state.params),
                                 ("momentum", m_host, state.momentum)):
            for l, lp in self._host_leaves(host, like).items():
                for p, t in lp.items():
                    rows[f"{kind}/{l}/{p}"] = _host(t)
        return plan_state_shards(rows, rank=self.group.rank,
                                 world=self.group.size)

    def saved_world(self, flat: Mapping[str, Any],
                    extra: Mapping[str, Any]) -> int:
        """The world size that wrote a checkpoint (from `extra`, else the
        leading axis of `it`)."""
        saved = extra.get("n_devices")
        if saved is None and "it" in flat and np.ndim(flat["it"]):
            saved = np.shape(flat["it"])[0]
        return int(saved or self.group.size)

    def same_topology(self, flat: Mapping[str, Any],
                      extra: Mapping[str, Any]) -> bool:
        """Whether a checkpoint was written by this trainer's topology:
        world size, tp, layout and state sharding (the JAX loop's
        `_restore_state` test). Another one is an elastic or cross-layout
        resume."""
        return (self.saved_world(flat, extra) == self.group.size
                and int(extra.get("tp", 1)) == self.tp
                and extra.get("layout", "replica") == self.state_layout
                and extra.get("state_sharding", "replicated")
                == self.state_sharding)

    def state_from_checkpoint(self, flat: Mapping[str, Any],
                              extra: Optional[Mapping[str, Any]] = None,
                              momentum_policy: str = "norm_rescale"
                              ) -> TrainState:
        """A restored flat map (`checkpoint.restore_flat`, either package's)
        -> this rank's TrainState, through `adapt_state` with the saved
        tp and layout (`extra["tp"]`, `extra["layout"]`): a step of this
        topology restores each rank's own rows as written, another one
        takes the elastic resume with `momentum_policy`."""
        extra = extra or {}
        return self.adapt_state(flat, old_tp=int(extra.get("tp", 1)),
                                momentum_policy=momentum_policy,
                                old_layout=extra.get("layout", "replica"))

    def adapt_state(self, flat: Mapping[str, Any], old_tp: int = 1,
                    momentum_policy: str = "norm_rescale",
                    old_layout: str = "replica") -> TrainState:
        """The elastic resume (the JAX package's `adapt_state`): this
        rank's TrainState from a step of any topology.

        Replica layout of this world size and tp: each rank's own rows as
        written, whatever the policy. Otherwise the params are data group
        0's, exact (after the round's average every data group holds the
        same model), a sharded layer's put back together from the old
        model ranks' column shards; momentum is rank-local state with no
        continuity across a topology change, so every rank takes the same
        reconstruction, `reduce_momentum_rows(rows, momentum_policy)` in
        numpy — "norm_rescale" (the mean rescaled to the rows' mean
        norm), "average" or "zero" — over all the old rows (a sharded
        layer: over the rows of each old model index). `it` is row 0's.

        `old_layout="logical"` (the sharded trainer's steps): the params as
        stored; momentum rows map one to one onto the ranks when there is
        one per rank (tp = 1), a ZeRO step's one logical momentum is taken
        as it is, and other rows are reduced per the policy."""
        if momentum_policy not in ("average", "zero", "norm_rescale"):
            raise ValueError(f"unknown momentum_policy {momentum_policy!r}")
        params, momentum, it = split_flat(flat)
        if old_layout == "logical":
            rows_exact = self.tp == 1 and momentum and all(
                np.ndim(m) == np.ndim(params[l][p]) + 1
                and np.shape(m)[0] == self.n_devices
                for l, lp in momentum.items() for p, m in lp.items())
            if rows_exact:
                r = self.group.rank
                return self._state_from_jax(
                    params, {l: {p: m[r] for p, m in lp.items()}
                             for l, lp in momentum.items()},
                    _first(it), own=False)
            return self._state_from_jax(params, {
                l: {p: (reduce_rows(m, momentum_policy)
                        if np.ndim(m) == np.ndim(params[l][p]) + 1 else m)
                    for p, m in lp.items()}
                for l, lp in momentum.items()} or None, _first(it),
                own=False)
        if old_layout != "replica":
            raise ValueError(f"unknown checkpoint layout {old_layout!r}")
        it_rows = np.asarray(it).reshape(-1)
        if it_rows.shape[0] == self.n_devices and old_tp == self.tp:
            r = self.group.rank
            return self._state_from_jax(
                {l: {p: a[r] for p, a in lp.items()}
                 for l, lp in params.items()},
                {l: {p: m[r] for p, m in lp.items()}
                 for l, lp in momentum.items()}, int(it_rows[r]), own=True)
        old_tp_layers = {l.name for l in self.net.spec.layers
                         if tp_shards_layer(l, old_tp)}

        def reassemble(tree, reduce):
            return {l: {p: from_replica_rows(x, old_tp, l in old_tp_layers,
                                             p, reduce)
                        for p, x in lp.items()} for l, lp in tree.items()}

        return self._state_from_jax(
            reassemble(params, first_row),
            reassemble(momentum,
                       lambda rows: reduce_rows(rows, momentum_policy))
            or None, int(it_rows[0]), own=False)

    def _jax_shapes(self, own: bool) -> Dict[str, Dict[str, tuple]]:
        """The JAX-layout shape of each leaf: logical, or (`own`) this
        rank's, where a sharded layer holds out/tp columns."""
        shapes = jax_param_shapes(self.net)
        if not own or self.tp == 1:
            return shapes
        return {l: {p: (((s[0], s[1] // self.tp) if p == "w"
                         else (s[0] // self.tp,))
                        if l in self._tp_layers else s)
                    for p, s in lp.items()}
                for l, lp in shapes.items()}

    def _port_trees(self, params: Mapping, momentum: Optional[Mapping],
                    own: bool) -> Tuple[ParamTree, Optional[ParamTree]]:
        """JAX-layout params and momentum -> port-layout CPU trees, every
        leaf of the net checked against its shape (`_jax_shapes(own)`) and
        the momentum against the solver's velocity dtype."""
        types = {l.name: l.type for l in self.net.spec.layers}
        vdt = precision.DTYPES[self.solver.cfg.velocity_dtype]
        out_p: ParamTree = {}
        out_m: Optional[ParamTree] = {} if momentum is not None else None
        for l, lp in self._jax_shapes(own).items():
            out_p[l] = {}
            if out_m is not None:
                out_m[l] = {}
            for p, shape in lp.items():
                if p not in params.get(l, {}):
                    raise ValueError(f"checkpoint missing leaf "
                                     f"'params/{l}/{p}'")
                a = np.array(params[l][p], dtype=np.float32)  # a copy
                if tuple(a.shape) != tuple(shape):
                    raise ValueError(f"params/{l}/{p}: shape {a.shape} != "
                                     f"net {tuple(shape)} (JAX layout)")
                out_p[l][p] = port_leaf(types[l], p, a)
                if out_m is None:
                    continue
                key = f"momentum/{l}/{p}"
                if p not in momentum.get(l, {}):
                    raise ValueError(f"checkpoint missing leaf {key!r}")
                m = port_leaf(types[l], p, momentum[l][p])
                if m.dtype != vdt:
                    raise ValueError(
                        f"{key}: checkpoint dtype {m.dtype} != the solver's "
                        f"velocity_dtype {self.solver.cfg.velocity_dtype}")
                if tuple(m.shape) != tuple(out_p[l][p].shape):
                    raise ValueError(f"{key}: shape {tuple(m.shape)} != net "
                                     f"{tuple(out_p[l][p].shape)} (port "
                                     f"layout)")
                out_m[l][p] = m
        return out_p, out_m

    def _state_from_jax(self, params: Mapping, momentum: Optional[Mapping],
                        it: int, own: bool) -> TrainState:
        """A TrainState from JAX-layout trees: this rank's own leaves
        (`own`, a same-topology row), or one logical copy to split."""
        p, m = self._port_trees(params, momentum, own)
        if own:
            return self._make_state(p, m, it)
        return self.state_from_params(p, m, it)

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
        (rng..., data index, t). Returns (state, mean loss) — the state updated
        in place; the health scalars land in `last_health`. On the card
        the call returns once the round is queued.

        `tau_by_worker` (elastic_tau trainers only): one local-step budget
        per data group, clipped to [1, tau]; this rank runs its first budget's
        steps (module docstring). None = full τ everywhere."""
        my_tau = None
        if self.elastic_tau:
            if tau_by_worker is not None:
                vec = [int(min(self.tau, max(1, t))) for t in tau_by_worker]
                if len(vec) != self.n_data:
                    raise ValueError(
                        f"tau_by_worker has {len(vec)} entries for "
                        f"{self.n_data} ranks (one per data group)")
                my_tau = vec[self.data.rank]
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
        loss_fn = self.net.loss_fn(self.loss_blob, ops=self.ops,
                                   tp_group=self.model, tp_size=self.tp)
        # the buffers the steps update: the state's own, or (a ZeRO state
        # sharding) the logical ones gathered for the round
        work = self._round_state(state)
        sstate = SolverState(momentum=work.momentum, it=state.it)
        d = self.data
        losses, grad_sqs = [], []
        for t in range(n_steps):
            batch = {k: v[t] for k, v in placed.items()}
            # a model group shares its data index's dropout key
            gen = seeded_generator(keys + (d.rank, t))
            loss, grads = value_and_grad(loss_fn, work.params, batch, gen)
            grads = self._fix_tp_grads(grads)
            if self.compute_health:
                # this step's LOCAL squared norm, before any average, in
                # the JAX package's leaf order (sorted names)
                grad_sqs.append(sum(
                    torch.sum(torch.square(grads[l][p].float()))
                    for l in sorted(grads) for p in sorted(grads[l])))
            if self.mode == "sync_sgd":
                grads, loss = self._mean_grads(grads, loss)
            self.solver.update(work.params, sstate, grads,
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
                                & torch.isfinite(work.flat_params).all()
                                & torch.isfinite(
                                    work.flat_momentum.float()).all())
            self._round_end(state, work)
            # a budget below τ: the mean over the steps this rank ran
            parts = [(losses.mean() if n_steps == self.tau
                      else losses.sum() / max(n_steps, 1))[None]]
            if self.compute_health:
                finite_avg = torch.isfinite(state.flat_params).all()
                row = torch.zeros(d.size, device=self.device)
                row[d.rank] = 1.0
                parts += [torch.stack(grad_sqs).max()[None],
                          row * (~finite_local).float(),
                          (~finite_avg).float()[None]]
            n_parts = sum(p.numel() for p in parts)
            parts += self._head_part(state)
            scalars = d.all_reduce_sum_(torch.cat(parts))
        if scalars.numel() > n_parts:
            state.head = scalars[n_parts]
        mean_loss = scalars[0] / d.size
        if placed.slot is not None:
            free = torch.cuda.Event()
            free.record(torch.cuda.current_stream(self.device))
            self._slot_free[placed.slot] = free
        self.last_health = None
        health = None
        if self.compute_health:
            by_worker = scalars[2:2 + d.size]
            health = [torch.sqrt(scalars[1]),
                      torch.maximum(by_worker.sum(), torch.clamp(
                          scalars[2 + d.size], max=1.0)), by_worker]
        if self.model is not None:
            # the model group's ranks computed the same scalars: their
            # mean, as the JAX package takes it over the model axis
            with torch.no_grad():
                both = torch.cat([mean_loss[None]] + [h.reshape(-1)
                                                      for h in health or []])
                self.model.all_reduce_mean_(both)
            mean_loss = both[0]
            if health is not None:
                health = [both[1], both[2], both[3:]]
        if health is not None:
            self.last_health = dict(zip(
                ("grad_norm", "nonfinite", "nonfinite_by_worker"), health))
        return state, mean_loss

    def _round_state(self, state: TrainState) -> TrainState:
        """The buffers a round's steps update (the state itself here)."""
        return state

    def _round_end(self, state: TrainState, work: TrainState) -> None:
        """After the τ steps: "local_sgd" averages the params over the data
        group, all_reduce(SUM) then a division — `lax.pmean`'s order."""
        if self.mode == "local_sgd":
            self.data.all_reduce_mean_(state.flat_params)

    def _head_part(self, state: TrainState) -> list:
        """Extra slots of the round's scalar all-reduce (none here)."""
        return []

    def _fix_tp_grads(self, grads: ParamTree) -> ParamTree:
        """The JAX package's `fix_tp_grads`: the feature gather's backward
        (a reduce-scatter) brings a sharded layer's gradient back x tp, and
        a replicated layer's holds only this rank's shard term x tp. The
        exact gradient is shards / tp, and the rest summed over the model
        group / tp (one all-reduce of the flat replicated gradients)."""
        if self.model is None:
            return grads
        rest = [(l, p) for l in grads if l not in self._tp_layers
                for p in grads[l]]
        out: ParamTree = {l: ({p: g / self.tp for p, g in lp.items()}
                              if l in self._tp_layers else {})
                          for l, lp in grads.items()}
        if rest:
            flat = torch.cat([grads[l][p].reshape(-1) for l, p in rest])
            self.model.all_reduce_mean_(flat)
            off = 0
            for l, p in rest:
                n = grads[l][p].numel()
                out[l][p] = flat[off:off + n].view(grads[l][p].shape)
                off += n
        return out

    def _mean_grads(self, grads: ParamTree, loss: torch.Tensor):
        """sync_sgd: the data group's mean of one step's grads (one flat
        collective) and loss."""
        order = [(l, p) for l in grads for p in grads[l]]
        flat = torch.cat([grads[l][p].reshape(-1) for l, p in order]
                         + [loss.float().reshape(1)])
        self.data.all_reduce_mean_(flat)
        out: ParamTree = {}
        off = 0
        for l, p in order:
            n = grads[l][p].numel()
            out.setdefault(l, {})[p] = flat[off:off + n].view(
                grads[l][p].shape)
            off += n
        return out, flat[-1]

    # -- eval ----------------------------------------------------------------

    def _eval_params(self, state: TrainState) -> ParamTree:
        """The params an eval forward reads (this rank's own here)."""
        return state.params

    def evaluate(self, state: TrainState,
                 batch: Mapping[str, np.ndarray]) -> float:
        """Accuracy over the data group: psum(correct) / psum(n), this rank
        contributing its own `batch` (the reference's eval reduce); under
        TP a model group's ranks take the same batch, and their accuracies
        are averaged, as the JAX package averages over the model axis."""
        acc_blob = self.acc_blob or _find_accuracy_blob(self.net)
        placed = self._to_device(batch)
        with torch.no_grad():
            blobs = self.net.apply(self._eval_params(state), placed,
                                   train=False, ops=self.ops,
                                   tp_group=self.model, tp_size=self.tp)
            n = next(iter(placed.values())).shape[0]
            tot = torch.stack([blobs[acc_blob].float() * n,
                               torch.tensor(float(n), device=self.device)])
            self.data.all_reduce_sum_(tot)
            acc = tot[0] / tot[1]
            if self.model is not None:
                acc = self.model.all_reduce_mean_(acc.reshape(1))[0]
        return float(acc)

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


def split_flat(flat: Mapping[str, Any]) -> Tuple[Dict, Dict, Any]:
    """A restored flat map ('params/<layer>/<param>', 'momentum/...',
    'it') -> (params, momentum, it) trees of its arrays, as stored."""
    trees: Dict[str, Dict] = {"params": {}, "momentum": {}}
    it: Any = np.zeros((), np.int32)
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "it":
            it = arr
            continue
        kind, lname, pname = parts
        trees[kind].setdefault(lname, {})[pname] = (
            arr if isinstance(arr, torch.Tensor) else np.asarray(arr))
    return trees["params"], trees["momentum"], it


def _first(it: Any) -> int:
    return int(np.asarray(it).reshape(-1)[0])


def first_row(rows: Any) -> Any:
    """Row 0: a replica step's params are data group 0's copy (after the
    round's average every data group holds the same model)."""
    return rows[0]


def from_replica_rows(x: Any, old_tp: int, sharded: bool, pname: str,
                      reduce) -> Any:
    """One leaf of a replica-layout step — [world, ...] rows, rank r at
    data index r // old_tp and model index r % old_tp — in the logical
    layout. A column-sharded layer (`sharded`): `reduce` takes the rows
    of each old model index, and the results are put back together along
    the param's column axis (past the row axes `reduce` keeps). Any other
    layer: `reduce` takes all the rows. Both trainers' `adapt_state` and
    the logical `checkpoint_tree` read a replica step through it."""
    if not sharded:
        return reduce(x)
    parts = [reduce(x[j::old_tp]) for j in range(old_tp)]
    return concat_rows(parts, (1 if pname == "w" else 0)
                       + parts[0].ndim - x.ndim + 1)


def reduce_rows(rows: Any, policy: str) -> Any:
    """`reduce_momentum_rows` of numpy rows or of a bfloat16 CPU tensor's
    (which stays a bfloat16 tensor)."""
    if isinstance(rows, torch.Tensor):
        return torch.from_numpy(reduce_momentum_rows(
            rows.float().numpy(), policy)).to(rows.dtype)
    return reduce_momentum_rows(np.asarray(rows), policy)


def concat_rows(parts: Sequence[Any], axis: int) -> Any:
    """np.concatenate, or torch.cat for bfloat16 CPU tensors."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts), axis)
    return np.concatenate(parts, axis=axis)


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
