"""The logical-layout trainer with ZeRO-1 state sharding.

The counterpart of `sparknet_tpu/parallel/sharded.py` (`ShardedTrainer`).
Where `ParallelTrainer`'s checkpoint gives every leaf a leading [world]
replica axis, this trainer's checkpoint is the LOGICAL state (`extra`
layout "logical"): params as one full copy, `it` as one scalar, and the
momentum by `state_sharding`:

  "replicated"  every rank keeps its own momentum, as `ParallelTrainer`
                does; the round is `ParallelTrainer`'s, so the two trainers
                give the same numbers bit for bit. The checkpoint holds the
                momentum as [n_data] rows, one per data group. Under TP the
                params and rows are the logical (gathered) values.
  "momentum"    one logical momentum, held at rest as this rank's ZeRO
                shard. A round all-gathers it over the data group, runs the
                τ local steps, then averages the ranks' velocities back
                into the shard: a reduce-scatter of the sum, then a
                division by n_data (`lax.pmean`'s order). So momentum is
                averaged across the data group once per round — the JAX
                package's semantic opt-in.
  "full"        "momentum", and the params held at rest as a shard too
                (gathered for the round, averaged back by a reduce-scatter).

The shard dimension is the JAX package's `_zero1_dims`: the first
dimension of a leaf's JAX-layout shape (conv HWIO, inner product (in,
out)) that n_data divides; a leaf with none stays whole, and is averaged
by an all-reduce. The port's OIHW and (out, in) leaves are split on the
mapped dimension, so a rank's pieces are the index slices the JAX package
stores on that device, and its at-rest sizes are the JAX package's per
device bytes. A round runs one all-gather and one reduce-scatter per
state buffer, each on a buffer packed rank-major.

What reads the logical params between rounds sees the whole value:
`averaged_params`, `evaluate` and `checkpoint_tree` gather a "full"
state's shards (collectives: every rank calls them), and the round leaves
the first param element in `TrainState.head` for the train loop's probe.
`place` holds a logical state in this trainer's layout (the JAX
package's `place`). `checkpoint_shards` writes each rank's own pieces
with no gather
(`mesh.plan_state_shards(zero=...)`), the JAX package's per-shard files
of the same state.

"momentum" and "full" need tp = 1, as in the JAX package. `adapt_live`
(the JAX package's live re-placement) is not ported: a membership change
relaunches the run, as `ParallelTrainer.resized` says.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import precision
from ..model.layers import OpsImpl, tp_shards_layer
from ..model.net import (FROM_JAX, TO_JAX, CompiledNet, ParamTree,
                         jax_leaf, jax_param_shapes)
from ..solver import SolverConfig
from .mesh import DataGroup, plan_state_shards
from .trainer import (ParallelTrainer, TrainState, _first, _flat_tree,
                      _host, first_row, from_replica_rows, reduce_rows,
                      split_flat)

STATE_SHARDINGS = ("replicated", "momentum", "full")


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One leaf of the ZeRO plan: its port shape, and the port and JAX dims
    it is split on (None: kept whole)."""

    lname: str
    pname: str
    ltype: str
    shape: Tuple[int, ...]
    pdim: Optional[int]
    jdim: Optional[int]

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape))


def _views(flat: torch.Tensor, leaves, shape_of) -> ParamTree:
    """A tree of views into `flat`, one per leaf in order, of shape
    `shape_of(leaf)`."""
    out: ParamTree = {}
    off = 0
    for leaf in leaves:
        shape = shape_of(leaf)
        n = int(np.prod(shape))
        out.setdefault(leaf.lname, {})[leaf.pname] = \
            flat[off:off + n].view(shape)
        off += n
    return out


class ShardedTrainer(ParallelTrainer):
    """`ParallelTrainer` with the logical checkpoint layout and the ZeRO-1
    `state_sharding` of the module docstring."""

    state_layout = "logical"

    def __init__(self, net: CompiledNet, solver_cfg: SolverConfig,
                 group: DataGroup, tau: int = 10, mode: str = "local_sgd",
                 loss_blob: str = "loss", acc_blob: Optional[str] = None,
                 compute_health: bool = True, elastic_tau: bool = False,
                 tp: int = 1, ops: Optional[OpsImpl] = None,
                 donate_batches: bool = False,
                 state_sharding: str = "replicated"):
        if state_sharding not in STATE_SHARDINGS:
            raise ValueError(f"unknown state_sharding {state_sharding!r}: "
                             f"expected one of {STATE_SHARDINGS}")
        if state_sharding != "replicated" and tp != 1:
            raise NotImplementedError(
                "ZeRO-style state sharding splits over the DATA axis; "
                "combining it with tensor parallelism is future work — "
                "use state_sharding='replicated' with tp > 1")
        self.state_sharding = state_sharding
        super().__init__(net, solver_cfg, group, tau=tau, mode=mode,
                         loss_blob=loss_blob, acc_blob=acc_blob,
                         compute_health=compute_health,
                         elastic_tau=elastic_tau, tp=tp, ops=ops,
                         donate_batches=donate_batches)
        self._zero = state_sharding != "replicated"
        self._full = state_sharding == "full"
        types = {l.name: l.type for l in net.spec.layers}
        plan: List[_Leaf] = []
        for lname, lp in jax_param_shapes(net).items():
            for pname, jshape in lp.items():
                jdim = next((i for i, s in enumerate(jshape)
                             if s > 0 and s % self.n_data == 0), None)
                w = pname == "w" and types[lname] in TO_JAX
                pdim = (None if jdim is None
                        else TO_JAX[types[lname]][jdim] if w else jdim)
                shape = (tuple(jshape[i] for i in FROM_JAX[types[lname]])
                         if w else tuple(jshape))
                plan.append(_Leaf(lname, pname, types[lname], shape, pdim,
                                  jdim))
        #: every leaf in the params' tree order
        self._plan = plan
        self._split = [l for l in plan if l.pdim is not None]
        self._whole = [l for l in plan if l.pdim is None]
        self._n_split = sum(l.numel // self.n_data for l in self._split)

    # -- the ZeRO layout -----------------------------------------------------

    def _piece_shape(self, leaf: _Leaf) -> Tuple[int, ...]:
        if leaf.pdim is None:
            return leaf.shape
        s = list(leaf.shape)
        s[leaf.pdim] //= self.n_data
        return tuple(s)

    def _shard_views(self, flat: torch.Tensor) -> ParamTree:
        """A shard buffer's tree of views in the params' tree order: this
        rank's piece of each split leaf (packed first), then the whole
        leaves."""
        views = _views(flat, self._split + self._whole, self._piece_shape)
        ordered: ParamTree = {}
        for l in self._plan:
            ordered.setdefault(l.lname, {})[l.pname] = views[l.lname][l.pname]
        return ordered

    def _pack(self, tree: ParamTree) -> Tuple[torch.Tensor, torch.Tensor]:
        """Logical leaves -> ([n_data, split numel / n_data] rows, row k the
        pieces data rank k holds, packed; [whole numel] the whole
        leaves)."""
        n = self.n_data
        t0 = tree[self._plan[0].lname][self._plan[0].pname]
        rows = [tree[l.lname][l.pname].unflatten(l.pdim, (n, -1))
                .movedim(l.pdim, 0).reshape(n, -1) for l in self._split]
        whole = [tree[l.lname][l.pname].reshape(-1) for l in self._whole]
        return (torch.cat(rows, 1) if rows
                else t0.new_empty((n, 0)),
                torch.cat(whole) if whole else t0.new_empty(0))

    def _gathered(self, shard: torch.Tensor, dtype: torch.dtype,
                  grad: bool = False) -> Tuple[torch.Tensor, ParamTree]:
        """The logical flat buffer (the params' tree order) and its views,
        from this rank's shard: the split part all-gathered over the data
        group (one collective), the whole leaves copied."""
        flat = torch.empty(sum(l.numel for l in self._plan), dtype=dtype,
                           device=self.device)
        views = _views(flat, self._plan, lambda l: l.shape)
        n = self.n_data
        with torch.no_grad():
            rows = self.data.all_gather_flat(
                shard[:self._n_split]).view(n, self._n_split)
            off = 0
            for l in self._split:
                q = l.numel // n
                views[l.lname][l.pname].copy_(
                    rows[:, off:off + q].reshape(
                        (n,) + self._piece_shape(l))
                    .movedim(0, l.pdim).flatten(l.pdim, l.pdim + 1))
                off += q
            for l in self._whole:
                v = views[l.lname][l.pname]
                v.copy_(shard[off:off + l.numel].view(v.shape))
                off += l.numel
        if grad:
            for lp in views.values():
                for v in lp.values():
                    v.requires_grad_(True)
        return flat, views

    def _scatter_mean(self, tree: ParamTree, shard: torch.Tensor) -> None:
        """The data group's mean of the logical leaves into this rank's
        shard: a reduce-scatter (SUM) of the packed rows, then a division
        by n_data; the whole leaves by an all-reduce mean."""
        rows, whole = self._pack(tree)
        shard[:self._n_split].copy_(
            self.data.reduce_scatter_sum(rows).div_(self.n_data))
        if whole.numel():
            shard[self._n_split:].copy_(self.data.all_reduce_mean_(whole))

    def _own_shard(self, tree: ParamTree, dtype: torch.dtype
                   ) -> torch.Tensor:
        """This rank's shard buffer of logical leaves (no collective)."""
        rows, whole = self._pack(tree)
        return torch.cat([rows[self.data.rank], whole]).to(
            device=self.device, dtype=dtype)

    # -- state ---------------------------------------------------------------

    def state_from_params(self, params: ParamTree,
                          momentum: Optional[ParamTree] = None,
                          it: int = 0) -> TrainState:
        """A TrainState from one logical copy of the params (PyTorch
        layouts) and this rank's logical momentum (zeros unless given),
        held at rest in this trainer's layout."""
        if not self._zero:
            return super().state_from_params(params, momentum, it)
        vdt = precision.DTYPES[self.solver.cfg.velocity_dtype]
        if momentum is None:
            momentum = {l: {p: torch.zeros(t.shape, dtype=vdt)
                            for p, t in lp.items()}
                        for l, lp in params.items()}
        flat_m = self._own_shard(momentum, vdt)
        if self._full:
            flat_p = self._own_shard(params, torch.float32)
            p_views = self._shard_views(flat_p)
            head = params[self._plan[0].lname][self._plan[0].pname] \
                .reshape(-1)[:1].to(self.device, torch.float32).clone()[0]
            return TrainState(p_views, self._shard_views(flat_m), int(it),
                              flat_p, flat_m, head=head)
        flat_p, views = _flat_tree(params, torch.float32, self.device)
        for lp in views.values():
            for v in lp.values():
                v.requires_grad_(True)
        return TrainState(views, self._shard_views(flat_m), int(it),
                          flat_p, flat_m)

    def place(self, state: TrainState) -> TrainState:
        """A logical-layout state — `params` one logical copy, `momentum`
        this rank's logical momentum, host or device tensors, PyTorch
        layouts — held at rest in this trainer's layout on its device, the
        momentum cast to the solver's velocity dtype (the JAX package's
        `place`)."""
        vdt = precision.DTYPES[self.solver.cfg.velocity_dtype]
        return self.state_from_params(
            {l: {p: t.detach().cpu() for p, t in lp.items()}
             for l, lp in state.params.items()},
            {l: {p: t.detach().cpu().to(vdt) for p, t in lp.items()}
             for l, lp in state.momentum.items()}, state.it)

    def _round_state(self, state: TrainState) -> TrainState:
        if not self._zero:
            return state
        vdt = precision.DTYPES[self.solver.cfg.velocity_dtype]
        flat_m, mom = self._gathered(state.flat_momentum, vdt)
        if self._full:
            flat_p, params = self._gathered(state.flat_params,
                                            torch.float32, grad=True)
        else:
            flat_p, params = state.flat_params, state.params
        return TrainState(params, mom, state.it, flat_p, flat_m)

    def _round_end(self, state: TrainState, work: TrainState) -> None:
        if not self._zero:
            return super()._round_end(state, work)
        with torch.no_grad():
            if not self._full:
                super()._round_end(state, work)
            elif self.mode == "local_sgd":
                self._scatter_mean(work.params, state.flat_params)
            else:  # sync_sgd: every rank holds the same params already
                state.flat_params.copy_(
                    self._own_shard(work.params, torch.float32))
            self._scatter_mean(work.momentum, state.flat_momentum)

    def _head_part(self, state: TrainState) -> list:
        """"full": the first param element rides the round's scalar
        all-reduce — data rank 0 holds it (the first piece of a split leaf;
        every rank holds a whole one) and adds it to the others' zeros."""
        if not self._full:
            return []
        first = self._plan[0]
        off = 0 if first.pdim is not None else self._n_split + sum(
            l.numel for l in self._whole[:self._whole.index(first)])
        v = state.flat_params[off:off + 1].float()
        return [v if self.data.rank == 0 else torch.zeros_like(v)]

    def averaged_params(self, state: TrainState) -> ParamTree:
        """The logical params: a "full" state's shards gathered (a
        collective), else `ParallelTrainer.averaged_params`."""
        if self._full:
            return self._gathered(state.flat_params, torch.float32)[1]
        return super().averaged_params(state)

    def logical_momentum(self, state: TrainState) -> ParamTree:
        """The logical momentum (PyTorch layouts): the ZeRO shards gathered,
        or ("replicated") this rank's own, its column shards gathered
        under TP. A collective."""
        if self._zero:
            vdt = precision.DTYPES[self.solver.cfg.velocity_dtype]
            return self._gathered(state.flat_momentum, vdt)[1]
        return self._gather_tp({l: {p: t for p, t in lp.items()}
                                for l, lp in state.momentum.items()})

    def _eval_params(self, state: TrainState) -> ParamTree:
        if self._full:
            return self._gathered(state.flat_params, torch.float32)[1]
        return state.params

    # -- the checkpoint boundary ---------------------------------------------

    def _jax_host(self, tree: ParamTree) -> Dict[str, Dict[str, Any]]:
        """Logical port-layout leaves -> JAX-layout host leaves, in sorted
        order (numpy; a bfloat16 leaf stays a CPU tensor)."""
        out: Dict[str, Dict[str, Any]] = {}
        for l in self._plan:
            t = tree[l.lname][l.pname].detach().to("cpu", copy=True)
            out.setdefault(l.lname, {})[l.pname] = _host(
                jax_leaf(l.ltype, l.pname, t))
        return {k: dict(sorted(out[k].items())) for k in sorted(out)}

    def checkpoint_tree(self, state: TrainState) -> Dict[str, Any]:
        """The state in the JAX package's logical layout, as host memory
        this call owns: {"params": logical, "momentum": [n_data] rows
        ("replicated") or one logical tree (ZeRO), "it": scalar int32}. A
        collective: every rank must call it."""
        it = np.asarray(state.it, np.int32)
        if self._zero:
            with torch.no_grad():
                params = self._jax_host(self.averaged_params(state))
                momentum = self._jax_host(self.logical_momentum(state))
            return {"params": params, "momentum": momentum, "it": it}
        rows = super().checkpoint_tree(state)

        def one_per_data_group(r):
            return r[::len(r) // self.n_data]

        def logical(kind, reduce):
            return {l: {p: from_replica_rows(x, self.tp,
                                             l in self._tp_layers, p, reduce)
                        for p, x in lp.items()}
                    for l, lp in rows[kind].items()}

        params = {l: {p: np.array(a) for p, a in lp.items()}
                  for l, lp in logical("params", first_row).items()}
        return {"params": params,
                "momentum": logical("momentum", one_per_data_group),
                "it": it}

    def checkpoint_shards(self, state: TrainState) -> Dict[str, Any]:
        """Stage 1 of a per-shard save in the logical layout, with no
        gather: the params and the whole leaves as replicated values
        (chunked over the files), "replicated" momentum as this rank's
        row, and each split leaf's piece in this rank's file. tp > 1
        raises NotImplementedError (write it monolithic)."""
        if self.tp != 1:
            raise NotImplementedError(
                "a per-shard step of the tensor-parallel sharded trainer; "
                "save it monolithic (checkpoint_sharded='off')")
        rank, world = self.data.rank, self.n_data
        replicated: Dict[str, Any] = {"it": np.asarray(state.it, np.int32)}
        rows: Dict[str, Any] = {}
        zero: Dict[str, Any] = {}
        with torch.no_grad():
            for kind, tree, split in (
                    ("params", state.params, self._full),
                    ("momentum", state.momentum, self._zero)):
                for l in self._plan:
                    key = f"{kind}/{l.lname}/{l.pname}"
                    t = jax_leaf(l.ltype, l.pname, tree[l.lname][l.pname]
                                  .detach().to("cpu", copy=True))
                    if kind == "momentum" and not self._zero:
                        rows[key] = _host(t[None])
                    elif split and l.pdim is not None:
                        jshape = tuple(t.shape[:l.jdim]) + (
                            t.shape[l.jdim] * world,) + tuple(
                                t.shape[l.jdim + 1:])
                        zero[key] = (jshape, l.jdim, _host(t))
                    else:
                        replicated[key] = _host(t)
        return plan_state_shards(rows, replicated, rank=rank, world=world,
                                 zero=zero)

    def adapt_state(self, flat: Mapping[str, Any], old_tp: int = 1,
                    momentum_policy: str = "norm_rescale",
                    old_layout: str = "replica") -> TrainState:
        """A step of any topology or layout -> this rank's state (the JAX
        package's `ShardedTrainer.adapt_state`).

        `old_layout="replica"`: params take data group 0's copy, put back
        together across the old model ranks' column shards; a sharded
        layer's momentum collapses to one row per old data group.
        `"logical"`: params as stored, momentum rows or one logical tree
        per the saved state sharding. Then `_momentum_rows` maps them to
        this trainer's layout: rows kept exactly when there is one per
        data group ("replicated"), else reduced per `momentum_policy`; a
        logical momentum is broadcast ("replicated") or taken as it is."""
        if momentum_policy not in ("average", "zero", "norm_rescale"):
            raise ValueError(f"unknown momentum_policy {momentum_policy!r}")
        if old_layout not in ("replica", "logical"):
            raise ValueError(f"unknown checkpoint layout {old_layout!r}")
        params, momentum, it = split_flat(flat)
        if old_layout == "replica":
            old_tp_layers = {l.name for l in self.net.spec.layers
                             if tp_shards_layer(l, old_tp)}

            def logical(tree, reduce):
                return {l: {p: from_replica_rows(x, old_tp,
                                                 l in old_tp_layers, p,
                                                 reduce)
                            for p, x in lp.items()}
                        for l, lp in tree.items()}

            # a sharded layer's momentum: one row per old data group
            params = logical(params, first_row)
            momentum = logical(momentum, lambda rows: rows)
        if not momentum:
            p, _ = self._port_trees(params, None, own=False)
            return self.state_from_params(p, it=_first(it))
        mine = self._momentum_rows(momentum, params, momentum_policy)
        p, m = self._port_trees(params, mine, own=False)
        return self.state_from_params(p, m, _first(it))

    def _momentum_rows(self, mom: Mapping, params: Mapping,
                       policy: str) -> Dict[str, Dict[str, Any]]:
        """This rank's logical momentum (JAX layout) from an incoming tree:
        a leaf with one more dim than its param is a stack of rows, kept
        exactly when there is one per data group ("replicated": this
        rank's data group's row), else reduced per `policy`; a logical
        leaf is every data group's ("replicated") or the one momentum
        (ZeRO)."""
        out: Dict[str, Dict[str, Any]] = {}
        for l, lp in mom.items():
            for p, m in lp.items():
                if np.ndim(m) == np.ndim(params[l][p]) + 1:
                    if not self._zero and np.shape(m)[0] == self.n_data:
                        m = m[self.data.rank]
                    else:
                        m = reduce_rows(m, policy)
                out.setdefault(l, {})[p] = m
        return out

    def adapt_live(self, state: TrainState,
                   momentum_policy: str = "norm_rescale") -> TrainState:
        """Not ported: the port relaunches on a change of membership
        (`ParallelTrainer.resized`)."""
        return self.resized(self.n_devices)
