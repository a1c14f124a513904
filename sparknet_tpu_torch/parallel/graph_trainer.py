"""Distributed τ-averaging for the serialized-graph backend.

The counterpart of `sparknet_tpu/parallel/graph_trainer.py`: the reference's
SECOND backend trained inside the averaging loop (`apps/MnistApp.scala:
98-138`: per-worker `TensorFlowNet.step` τ times, then the weight
averaging). One process per card on the port's data group
(`parallel/mesh.py`: NCCL on the card, gloo on the CPU); a round on each
rank is τ applications of `GraphNet.make_train_step` on its own batches,
then the average.

Averaging semantics, as the reference's weight exchange and the JAX
trainer's:
  - FLOAT variables are averaged over the group: all_reduce(SUM), then a
    division by the world size (`lax.pmean`'s order), one collective per
    dtype. For an imported TF graph that includes the `<var>/Momentum`
    slot variables.
  - INT variables (the global-step counter) stay local; they advance in
    lockstep (τ increments everywhere).
  - `slots` (native-graph velocity) stay rank-local and are never reset.

The health scalars of a round (`last_health`), the JAX trainer's: the
applied-update norm of the float variables, sqrt(sum over ranks of each
rank's own squared change over its τ steps, before the average), as
"grad_norm" (the gradients live inside the graph's optimizer); and
"nonfinite", the count of ranks whose losses or averaged float variables
went NaN/Inf, with "nonfinite_by_worker" the one-hot row per rank. The
mean loss and these ride one all-reduce after the average.

With a tracer on (`obs/trace.py`), step t of round r (it // τ) is a
"step" span (round=r, step=t) around the train step's card-timed
"forward", "backward" and "solver" spans (`GraphNet.make_train_step`),
and the round's "exchange" span runs from the average through the
scalars' all-reduce.

Placement (`place_batches`) on a card is `ParallelTrainer`'s, through the
same `BatchPlacer`: pinned staging, a copy stream of the trainer's own,
two donated device slots under `donate_batches` (else fresh buffers), and
the `ready` event the compute stream waits on before step 0. Only the
dtype rule is the graph's: each input crosses in its host dtype and is
cast on the card to its placeholder's dtype.

State: {"variables": {name: tensor}, "slots": {name: tensor}, "it": int},
this rank's own. At the checkpoint boundary (`checkpoint_tree`) it takes
the JAX package's replica layout, keys `variables/<name>`, `slots/<name>`
and `it` with the leading [world] axis, so a step written by either
package restores in the other. Checkpoints are monolithic, as in the JAX
package (the per-shard layout needs a layer-IR trainer). A step of another
world size restores through `adapt_state`: variables from row 0 (they are
replica-identical after a round), float slots plain-averaged over the old
rows in float64, int slots from row 0; a checkpoint of another graph or of
the layer backend, or one written at tp ≠ 1, is refused.

The in-graph optimizer owns the learning rate: there is no lr backoff
(`supports_lr_scale = False`), no per-worker τ and no tensor parallelism.
A membership change relaunches the run (the train loop's exit 75), as for
every trainer of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..backend.graph_net import GraphNet, TrainState
from ..backend.graphdef import torch_dtype
from ..obs import trace as obs_trace
from .mesh import DataGroup
from .trainer import BatchPlacer, PlacedBatches, _host


class GraphTrainer:
    """τ-local-step parameter-averaging trainer over a `DataGroup` for a
    GraphNet (a serialized or imported graph with its in-graph
    optimizer)."""

    #: the checkpoint layout (every leaf carries the leading [world] axis)
    state_layout = "replica"
    state_sharding = "replicated"
    #: the in-graph optimizer owns the LR — no runtime backoff knob
    supports_lr_scale = False
    elastic_tau = False
    tp = 1

    def __init__(self, net: GraphNet, group: DataGroup, tau: int = 10,
                 loss_name: Optional[str] = None,
                 acc_name: Optional[str] = "accuracy",
                 compute_health: bool = True, donate_batches: bool = False):
        a, b = net.device, group.device
        if a.type != b.type or None not in (a.index, b.index) \
                and a.index != b.index:
            raise ValueError(f"the net is on {a}, the data group on {b}")
        self.net = net
        self.group = group
        self.device = group.device
        self.n_devices = group.size
        self.tau = int(tau)
        self.loss_name = net.resolve_loss(loss_name)
        self.acc_name = acc_name
        self.compute_health = bool(compute_health)
        self._step = net.make_train_step(self.loss_name)
        #: {"grad_norm", "nonfinite", "nonfinite_by_worker"} of the last
        #: round as device tensors (None when compute_health is off)
        self.last_health: Optional[Dict[str, torch.Tensor]] = None
        #: optional PhaseTimers: train_round then times "h2d" and "dispatch"
        self.phase_timers = None
        self._placer = BatchPlacer(self.device, donate_batches)
        #: bytes the last round copied to the device (0 on the CPU)
        self.h2d_bytes = 0
        #: of those, the bytes that crossed through pinned staging on the
        #: copy stream
        self.h2d_async_bytes = 0

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """The net's current train state, the same on every rank (the
        reference seeds all workers from worker 0). `seed` is accepted for
        the trainer interface and ignored: a graph's initial values are
        seeded when the GraphNet is built."""
        return self.net.init_train_state(self.loss_name)

    def averaged_state(self, state: TrainState) -> TrainState:
        """The single-replica view for export: this rank's state (its float
        variables are the group's after a round)."""
        return state

    def load_into_net(self, state: TrainState) -> None:
        self.net.load_train_state(state)

    # -- the checkpoint boundary ---------------------------------------------

    def checkpoint_tree(self, state: TrainState) -> Dict[str, Any]:
        """The state in the JAX package's replica layout, as host memory
        this call owns: {"variables": {name: [world, ...]}, "slots": {name:
        [world, ...]}, "it": [world] int32}. Variables are replica-
        identical after a round, so each is this rank's row broadcast; the
        slots are gathered, row r rank r's own. A collective: every rank
        calls it."""
        world = self.group.size
        with torch.no_grad():
            variables = {
                k: np.broadcast_to(_host(v.detach().to("cpu", copy=True)),
                                   (world,) + tuple(v.shape))
                for k, v in state["variables"].items()}
            slots = {k: _host(self.group.all_gather(v.detach()).to(
                "cpu", copy=True)) for k, v in state["slots"].items()}
        return {"variables": variables, "slots": slots,
                "it": np.full((world,), int(state["it"]), np.int32)}

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
        return (self.saved_world(flat, extra) == self.group.size
                and int(extra.get("tp", 1)) == 1
                and extra.get("layout", "replica") == "replica")

    def state_from_checkpoint(self, flat: Mapping[str, Any],
                              extra: Optional[Mapping[str, Any]] = None,
                              momentum_policy: str = "norm_rescale"
                              ) -> TrainState:
        """A restored flat map (either package's) -> this rank's state: its
        own rows on the same topology, else `adapt_state`. The momentum
        policy of the layer-IR trainers does not apply (the graph backend
        plain-averages its slots)."""
        extra = extra or {}
        layout = extra.get("layout", "replica")
        if layout != "replica":
            raise ValueError(
                f"checkpoint layout {layout!r} needs a layer-IR trainer to "
                f"adapt; GraphTrainer only reads replica checkpoints")
        if not self.same_topology(flat, extra):
            return self.adapt_state(flat, old_tp=int(extra.get("tp", 1)))
        r = self.group.rank
        rows = self._parse(flat, lambda a: a[r], lambda a: a[r])
        rows["it"] = int(np.asarray(flat["it"]).reshape(-1)[r])
        return self._put_state(rows)

    def adapt_state(self, flat: Mapping[str, Any],
                    old_tp: int = 1) -> TrainState:
        """The elastic resume from a checkpoint of another world size
        (keys 'variables/<name>', 'slots/<name>', 'it'). Variables are
        replica-identical after a round, so row 0 is THE value; rank-local
        float slots are plain-averaged over the old rows in float64 (the
        JAX graph trainer's policy), int slots taken from row 0. A
        checkpoint that does not cover this graph's variables (another
        backend or graph) fails loudly."""
        if old_tp != 1:
            raise ValueError(
                f"checkpoint has tp={old_tp}; the graph backend has no "
                f"tensor parallelism — resume on the original topology")

        def slot(a):
            if np.issubdtype(a.dtype, np.floating):
                # accumulate in float64 so a float64 slot loses nothing
                return a.mean(axis=0, dtype=np.float64).astype(a.dtype)
            return a[0]  # replica-identical counters: no truncation

        out = self._parse(flat, lambda a: a[0], slot)
        out["it"] = (int(np.asarray(flat["it"]).reshape(-1)[0])
                     if "it" in flat else None)
        return self._put_state(out)

    def _parse(self, flat: Mapping[str, Any], var_row, slot_row
               ) -> Dict[str, Any]:
        """{"variables", "slots"} of a flat map through the row pickers,
        checked against this graph's variables."""
        out: Dict[str, Any] = {"variables": {}, "slots": {}}
        for key, arr in flat.items():
            parts = key.split("/", 1)
            a = (arr.float().numpy() if isinstance(arr, torch.Tensor)
                 else np.asarray(arr))
            if parts[0] == "variables" and len(parts) == 2:
                out["variables"][parts[1]] = var_row(a)
            elif parts[0] == "slots" and len(parts) == 2:
                out["slots"][parts[1]] = slot_row(a)
        want = set(self.net.variable_names)
        missing = want - set(out["variables"])
        extra = set(out["variables"]) - want
        if missing or extra or "it" not in flat:
            raise ValueError(
                f"checkpoint does not match this graph's train state "
                f"(missing variables {sorted(missing)[:5]}, unknown "
                f"variables {sorted(extra)[:5]}"
                f"{', no it counter' if 'it' not in flat else ''}) — a "
                f"layer-backend or different-graph checkpoint cannot be "
                f"adapted")
        out["slots"] = {k: v for k, v in out["slots"].items() if k in want}
        return out

    def _put_state(self, tree: Dict[str, Any]) -> TrainState:
        """Host rows -> this rank's state on the device, each variable in
        its current dtype and shape."""
        def put(name, a, like):
            t = torch.from_numpy(np.array(a))
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(t.shape)} != graph "
                                 f"{tuple(like.shape)}")
            return t.to(self.device, like.dtype)

        cur = self.net.variables
        return {"variables": {k: put(f"variables/{k}",
                                     tree["variables"][k], cur[k])
                              for k in self.net.variable_names},
                "slots": {k: put(f"slots/{k}", v, cur[k])
                          for k, v in tree["slots"].items()},
                "it": int(tree["it"])}

    # -- one round -----------------------------------------------------------

    def _inputs(self, batch: Mapping[str, Any], lead: int):
        """(name, tensor, placeholder dtype) of each graph input of `batch`,
        the tensor where the caller left it. `lead` > 0 checks the leading
        (τ) dim."""
        dtypes = self.net.input_dtypes()
        for name in self.net.input_names:
            if name not in batch:
                raise ValueError(f"batch missing graph input {name!r}")
            v = batch[name]
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            if lead and (t.ndim == 0 or t.shape[0] != lead):
                raise ValueError(f"{name}: leading dim "
                                 f"{tuple(t.shape)[:1]} != tau {lead}")
            yield name, t, torch_dtype(dtypes[name])

    def _place_inputs(self, batch: Mapping[str, Any], lead: int
               ) -> Tuple[Dict[str, torch.Tensor], int]:
        """The graph's inputs of `batch` on the device in the
        placeholders' dtypes, and the bytes copied, in blocking copies on
        the current stream (an eval batch; a round on the CPU): each input
        crosses in its host dtype (int8 pixels, a bfloat16 round) and is
        cast on the device (the graph's ops cast their operands to the
        compute dtype themselves)."""
        out, nbytes = {}, 0
        for name, t, want in self._inputs(batch, lead):
            if t.device.type == "cpu" and self.device.type == "cuda":
                nbytes += t.numel() * t.element_size()
            out[name] = t.to(self.device).to(want)
        return out, nbytes

    def place_batches(self, batches: Mapping[str, Any],
                      compute_dt: Optional[torch.dtype] = None
                      ) -> PlacedBatches:
        """This rank's [tau, local_batch, ...] batches on the device, in the
        graph's input dtypes. On a card, host inputs go as
        `ParallelTrainer`'s do (`BatchPlacer`): pinned staging, copies in
        their host dtype on the trainer's copy stream into a donated slot
        (`donate_batches`) or fresh buffers, the cast there, and the
        `ready` event that `train_round` makes the compute stream wait on;
        so the train loop's round-prep thread places round R+1 while round
        R computes. Inputs already on the card are cast where they are; on
        the CPU every input is. A `PlacedBatches` passes through.
        `compute_dt` is accepted for the trainer interface: the graph's ops
        cast to the compute dtype themselves."""
        if isinstance(batches, PlacedBatches):
            return batches
        if self.device.type != "cuda":
            placed, nbytes = self._place_inputs(batches, self.tau)
            return PlacedBatches(placed, nbytes=nbytes)
        placed: Dict[str, torch.Tensor] = {}
        todo: Dict[str, Tuple[torch.Tensor, torch.dtype]] = {}
        for name, t, want in self._inputs(batches, self.tau):
            if t.device.type == "cpu":
                todo[name] = (t, want)
            else:
                placed[name] = t.to(self.device).to(want)
        if not todo:
            return PlacedBatches(placed)
        return self._placer.copy(placed, todo)

    def train_round(self, state: TrainState, batches: Mapping[str, Any],
                    rng: Any = None, lr_scale: float = 1.0,
                    tau_by_worker=None) -> Tuple[TrainState, torch.Tensor]:
        """One outer round: τ in-graph-optimizer steps on this rank's
        [tau, local_batch, ...] batches (host arrays or placed), then the
        average. Returns (state, mean loss as a device scalar); the health
        scalars land in `last_health`. `rng` is accepted for the trainer
        interface and ignored (graph execution is deterministic)."""
        if lr_scale != 1.0:
            raise ValueError("the graph backend's in-graph optimizer owns "
                             "the learning rate: no lr_scale (backoff)")
        if tau_by_worker is not None:
            raise ValueError("the graph backend runs the full τ on every "
                             "rank (no per-worker τ)")
        timers = self.phase_timers
        if timers is None:
            return self._round(state, self.place_batches(batches))
        with timers.phase("h2d"):
            placed = self.place_batches(batches)
        with timers.phase("dispatch"):
            return self._round(state, placed)

    def _round(self, state: TrainState, placed: PlacedBatches
               ) -> Tuple[TrainState, torch.Tensor]:
        self.h2d_bytes = placed.nbytes
        self.h2d_async_bytes = self._placer.begin(placed)
        g = self.group
        old = state["variables"]
        floats = sorted(k for k, v in old.items() if v.is_floating_point())
        rnd = state["it"] // self.tau
        losses = []
        for t in range(self.tau):
            with obs_trace.span("step", round=rnd, step=t):
                state, loss = self._step(state, {k: v[t]
                                                 for k, v in placed.items()})
            losses.append(loss.float())
        self._placer.end(placed)
        losses = torch.stack(losses)
        with torch.no_grad():
            new = state["variables"]
            if self.compute_health:
                # each rank's OWN change over its τ steps, before the
                # average (after it the sum would count the mean n times)
                delta_sq = sum((torch.sum(torch.square(
                    new[k].float() - old[k].float())) for k in floats),
                    torch.zeros((), device=self.device))
            with obs_trace.card_span("exchange", round=rnd):
                state = dict(state, variables=self._average(new, floats))
                parts = [losses.mean()[None]]
                if self.compute_health:
                    finite = torch.isfinite(losses).all()
                    for k in floats:
                        finite = finite & torch.isfinite(
                            state["variables"][k]).all()
                    row = torch.zeros(g.size, device=self.device)
                    row[g.rank] = 1.0
                    parts += [delta_sq.reshape(1).float(),
                              row * (~finite).float()]
                scalars = g.all_reduce_sum_(torch.cat(parts))
        self.last_health = None
        if self.compute_health:
            by_worker = scalars[2:]
            self.last_health = {"grad_norm": torch.sqrt(scalars[1]),
                                "nonfinite": by_worker.sum(),
                                "nonfinite_by_worker": by_worker}
        return state, scalars[0] / g.size

    def _average(self, variables: Dict[str, torch.Tensor], floats
                 ) -> Dict[str, torch.Tensor]:
        """The float variables averaged over the group, one flat buffer and
        one collective per dtype; the rest as they are."""
        out = dict(variables)
        by_dtype: Dict[torch.dtype, list] = {}
        for k in floats:
            by_dtype.setdefault(variables[k].dtype, []).append(k)
        for names in by_dtype.values():
            flat = torch.cat([variables[k].reshape(-1) for k in names])
            self.group.all_reduce_mean_(flat)
            off = 0
            for k in names:
                n = variables[k].numel()
                out[k] = flat[off:off + n].view(variables[k].shape)
                off += n
        return out

    # -- eval ----------------------------------------------------------------

    def evaluate(self, state: TrainState,
                 batch: Mapping[str, np.ndarray]) -> float:
        """Accuracy over the group: psum(acc * n) / psum(n), this rank
        contributing its own `batch` (NHWC, the graph's layout)."""
        placed, _ = self._place_inputs(batch, 0)
        with torch.no_grad():
            (acc,) = self.net.fetch(state["variables"], placed,
                                    (self.acc_name,))
            n = next(iter(placed.values())).shape[0]
            tot = torch.stack([acc.float() * n,
                               torch.tensor(float(n), device=self.device)])
            self.group.all_reduce_sum_(tot)
        return float(tot[0] / tot[1])
