"""GraphNet: execute a serialized GraphDef under the NetInterface API.

The counterpart of `sparknet_tpu/backend/graph_net.py`, an executor over
explicit tensors (like the port's `CompiledNet`), not an `nn.Module`.
Parity with the reference's `libs/TensorFlowNet.scala`:
  - introspection discovers inputs, weights and the train op by the naming
    convention (no side metadata), and checks the schema's columns against
    the graph's inputs;
  - `forward(batch, fetches)` fetches named tensors;
  - `step(batch)` runs the in-graph optimizer. Its hyperparameters, lr
    schedules included (the reference mnist graph's
    tf.train.exponential_decay), live in the graph: the graph's own lr
    subgraph is evaluated each step;
  - `get_weights` fetches every FLOAT variable: for an imported TF graph
    that includes the `<var>/Momentum` slot variables, as the reference's
    averaging loop exchanged them; the int global-step counter is skipped;
  - `set_weights` assigns exactly the variables named in the collection and
    touches nothing else: it never resets optimizer slots.

Execution: the graph is interpreted topologically, lazily per fetch set,
with an explicit stack (an imported chain can be far deeper than Python's
recursion limit). Training state is an explicit dict
  {"variables": {name: tensor}, "slots": {name: tensor}, "it": int}
so one pure step function (`make_train_step`, gradients by
`torch.autograd.grad`) drives both `step()` and the distributed trainer
(`parallel/graph_trainer.py`). Imported TF graphs keep their momentum
accumulators as variables (`<var>/Momentum`) and have no slots; native
`Train`-protocol graphs keep them in `slots`.

Variables keep the graph's own layouts (NHWC / HWIO / (in, out)) and the
dtypes JAX gives them with 64-bit types off (`graphdef.jax_dtype`): a
float64 initializer is float32, an int64 counter int32. Initial values
the graph does not carry (a `Variable` with only a shape) are drawn from
a seeded `torch.Generator` on the CPU, so a seed gives the same values on
every device; they cannot equal `jax.random`'s, so tests carry variables
across with `set_weights` / `load_train_state`.

`forward` takes NHWC host batches (4-D NCHW ones are recognised and
transposed, as the JAX `_prep` does) and returns numpy arrays; a bfloat16
blob comes back as float32. Entry points run on the card unless the caller
passes `device="cpu"`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..model.weights import WeightCollection
from ..schema import Field, Schema
from .graphdef import (ASSIGN_SUFFIX, GraphDef, NodeDef, OPS, TRAIN_STEP,
                       UPDATE_SUFFIX, jax_dtype, to_tensor, torch_dtype)

TrainState = Dict[str, Any]


@dataclass
class GraphOptimizer:
    """Introspected in-graph optimizer description.

    For imported TF graphs this mirrors the ApplyMomentum nodes: `slot_of`
    names the `<var>/Momentum` accumulator VARIABLE per trainable var, and
    `counter` is the global-step variable bumped by `train//step`
    (TF::AssignAdd). For native `Train`-protocol graphs the accumulators
    live in the train state's `slots` and `counter` is None (the state
    carries `it` instead).

    Update rule is TF MomentumOptimizer semantics (the engine the reference
    embedded): accum' = momentum·accum + grad; var' = var − lr·accum'.
    """

    trainable: List[str]
    slot_of: Dict[str, str] = field(default_factory=dict)
    momentum: float = 0.0
    counter: Optional[str] = None
    counter_inc: int = 1
    #: lr_fn(variables, it) -> 0-d tensor: the graph's own lr subgraph for
    #: imported graphs, the Train node's declared policy for native ones
    lr_fn: Callable[[Dict[str, torch.Tensor], int], torch.Tensor] = None


class GraphNet:
    def __init__(self, graph: GraphDef, schema: Optional[Schema] = None,
                 seed: int = 0, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        self._nodes = {n.name: n for n in graph.nodes}
        # -- introspection (TensorFlowNet.scala:24-49) --
        self.input_names = [
            n.name for n in graph.nodes
            if n.op == "Placeholder" and not n.name.endswith(UPDATE_SUFFIX)]
        self.variable_names = [n.name for n in graph.nodes
                               if n.op == "Variable"]
        self._train_node = self._nodes.get(TRAIN_STEP)
        # protocol check: every variable has its update/assign pair if any do
        for v in self.variable_names:
            upd, asg = v + UPDATE_SUFFIX, v + ASSIGN_SUFFIX
            if (upd in self._nodes) != (asg in self._nodes):
                raise ValueError(f"variable {v!r}: incomplete "
                                 f"update/assign pair in graph")
        if schema is not None:
            cols = set(schema.names())
            gin = set(self.input_names)
            if cols != gin:
                raise ValueError(
                    f"schema columns {sorted(cols)} != graph inputs "
                    f"{sorted(gin)} (TensorFlowNet-parity validation)")
        self.schema = schema
        self._consts: Dict[Tuple[str, str], torch.Tensor] = {}
        # -- init//all_vars (TensorFlowNet.scala:10-19) --
        self.variables: Dict[str, torch.Tensor] = {}
        gen = torch.Generator().manual_seed(int(seed))
        for v in self.variable_names:
            node = self._nodes[v]
            init = node.attrs.get("init")
            if init is None:
                init = self._resolve_initializer(v)
            if init is not None:
                t = to_tensor(init)
            else:
                shape = tuple(int(d) for d in node.attrs["shape"])
                dtype = str(node.attrs.get("dtype", "float32"))
                if dtype.startswith(("int", "uint")):
                    t = torch.zeros(shape, dtype=torch_dtype(dtype))
                else:
                    std = float(node.attrs.get("stddev", 0.1))
                    t = std * torch.randn(shape, generator=gen)
            self.variables[v] = t.to(self.device)
        self._step_fn = None
        self._step_loss: Optional[str] = None
        self._slots: Optional[Dict[str, torch.Tensor]] = None
        self._it = 0

    def _resolve_initializer(self, v: str) -> Optional[np.ndarray]:
        """Imported graphs carry initial values as `<var>/Assign <- const`
        subgraphs (tf.zeros / tf.constant); evaluate those eagerly, on the
        CPU. Random initializers (TruncatedNormal) are opaque -> None (the
        seeded generator)."""
        asg = self._nodes.get(v + "/Assign")
        if asg is None or len(asg.inputs) != 2:
            return None
        try:
            val = self._eval({}, {}, (asg.inputs[1],), device="cpu")[0]
            val = val.numpy()
        except Exception:
            return None
        shape = tuple(self._nodes[v].attrs.get("shape", ()))
        if shape and val.shape != shape:
            return None
        return val

    # -- execution core ------------------------------------------------------

    def _topo_order(self, fetches: Sequence[str]) -> List[NodeDef]:
        """Topological order of the ANCESTORS of `fetches` only — lazy, like
        a session run: unrelated subgraphs (an imported TF graph's gradient
        machinery) are never touched. Explicit-stack DFS."""
        order, seen = [], set()
        for f in fetches:
            stack = [(f, False)]
            while stack:
                name, expanded = stack.pop()
                if expanded:
                    order.append(self._nodes[name])
                    continue
                if name in seen:
                    continue
                seen.add(name)
                n = self._nodes.get(name)
                if n is None:
                    raise KeyError(f"graph references unknown node {name!r}")
                stack.append((name, True))  # emit after the inputs
                for i in reversed(n.inputs):  # visit in declaration order
                    stack.append((i, False))
        return order

    def _const(self, n: NodeDef, device) -> torch.Tensor:
        """A Const node's value on `device`, made once per device."""
        key = (n.name, str(device))
        t = self._consts.get(key)
        if t is None:
            # a normal tensor even under forward()'s inference mode: a
            # later training step may save it for its backward
            with torch.inference_mode(False):
                t = self._consts[key] = OPS["Const"](n, ()).to(device)
        return t

    def _eval(self, variables: Mapping[str, torch.Tensor],
              batch: Mapping[str, torch.Tensor], fetches: Sequence[str],
              device=None) -> Tuple[torch.Tensor, ...]:
        device = self.device if device is None else torch.device(device)
        values: Dict[str, torch.Tensor] = {}
        for n in self._topo_order(fetches):
            if n.op == "Placeholder":
                if n.name in batch:
                    values[n.name] = batch[n.name]
                continue  # unfed update placeholders stay absent
            if n.op == "Variable":
                values[n.name] = variables[n.name]
                continue
            if n.op in ("Assign", "NoOp", "Train"):
                continue  # protocol nodes, not part of forward dataflow
            if n.op == "Const":
                values[n.name] = self._const(n, device)
                continue
            impl = OPS.get(n.op)
            if impl is None:
                raise ValueError(f"unsupported graph op {n.op!r} "
                                 f"(node {n.name!r})")
            try:
                ins = [values[i] for i in n.inputs]
            except KeyError as e:
                raise ValueError(f"node {n.name!r}: missing input {e}") from e
            values[n.name] = impl(n, ins)
        return tuple(values[f] for f in fetches)

    # -- optimizer introspection --------------------------------------------

    def resolve_loss(self, loss_name: Optional[str] = None) -> str:
        """The node to differentiate. Explicit name wins; a native `Train`
        node declares its loss input; otherwise the `loss` naming
        convention both reference graph generators used."""
        if loss_name is not None:
            if loss_name not in self._nodes:
                raise ValueError(f"loss node {loss_name!r} not in graph")
            return loss_name
        if self._train_node is not None and self._train_node.op == "Train":
            return self._train_node.inputs[0]
        if "loss" in self._nodes:
            return "loss"
        raise ValueError(
            f"graph has no native {TRAIN_STEP!r} Train node and no node "
            f"named 'loss' — pass loss_name= to train it")

    def _float_variables(self) -> List[str]:
        return [v for v in self.variable_names
                if self.variables[v].is_floating_point()]

    def discover_optimizer(self, loss_name: Optional[str] = None
                           ) -> GraphOptimizer:
        loss = self.resolve_loss(loss_name)
        apply_nodes = [n for n in self.graph.nodes
                       if n.op in ("TF::ApplyMomentum",
                                   "TF::ApplyGradientDescent")]
        if apply_nodes:
            return self._discover_imported(apply_nodes)
        if self._train_node is not None and self._train_node.op == "Train":
            return self._discover_native(loss)
        raise ValueError(
            "graph has neither a Train protocol node nor imported "
            "Apply{Momentum,GradientDescent} nodes — cannot infer an "
            "optimizer; supported graphs carry one in-graph "
            "(TensorFlowNet parity: the optimizer lives in the graph)")

    def _scalar(self, name: str) -> np.ndarray:
        """A variable-free node's value, evaluated on the CPU."""
        return self._eval({}, {}, (name,), device="cpu")[0].numpy()

    def _discover_imported(self, apply_nodes) -> GraphOptimizer:
        trainable, slot_of = [], {}
        lr_nodes = set()
        momentum_nodes = set()
        for n in apply_nodes:
            if n.op == "TF::ApplyMomentum":
                var, slot, lr, _grad, mom = n.inputs[:5]
                slot_of[var] = slot
                momentum_nodes.add(mom)
            else:  # ApplyGradientDescent: var, alpha, delta
                var, lr = n.inputs[0], n.inputs[1]
            trainable.append(var)
            lr_nodes.add(lr)
        if len(lr_nodes) != 1:
            raise ValueError(f"multiple lr subgraphs {sorted(lr_nodes)} — "
                             f"unsupported")
        lr_node = next(iter(lr_nodes))
        momentum = 0.0
        if momentum_nodes:
            if len(momentum_nodes) != 1:
                raise ValueError("per-variable momentum values unsupported")
            momentum = float(self._scalar(next(iter(momentum_nodes))))
        counter, counter_inc = None, 1
        if self._train_node is not None and \
                self._train_node.op == "TF::AssignAdd":
            counter = self._train_node.inputs[0]
            try:
                counter_inc = int(self._scalar(self._train_node.inputs[1]))
            except Exception:
                counter_inc = 1

        def lr_fn(variables, it):
            return self._eval(variables, {}, (lr_node,))[0]

        return GraphOptimizer(trainable=trainable, slot_of=slot_of,
                              momentum=momentum, counter=counter,
                              counter_inc=counter_inc, lr_fn=lr_fn)

    def _discover_native(self, loss: str) -> GraphOptimizer:
        attrs = self._train_node.attrs
        base_lr = float(attrs.get("learning_rate", 0.01))
        momentum = float(attrs.get("momentum", 0.9))
        policy = str(attrs.get("lr_policy", "fixed"))
        dev = self.device
        if policy == "fixed":
            def lr_fn(variables, it):
                return torch.tensor(base_lr, dtype=torch.float32, device=dev)
        elif policy == "exp_decay":
            decay_rate = float(attrs["decay_rate"])
            decay_steps = float(attrs["decay_steps"])
            staircase = bool(attrs.get("staircase", True))

            def lr_fn(variables, it):
                # the JAX order: it as f32, / steps, floor, rate ** p
                p = torch.tensor(int(it), dtype=torch.float32,
                                 device=dev) / decay_steps
                if staircase:
                    p = torch.floor(p)
                return base_lr * torch.pow(decay_rate, p)
        else:
            raise ValueError(f"unknown Train lr_policy {policy!r} "
                             f"(expected 'fixed' or 'exp_decay')")
        return GraphOptimizer(trainable=self._float_variables(),
                              momentum=momentum, lr_fn=lr_fn)

    # -- pure training step --------------------------------------------------

    def init_train_state(self, loss_name: Optional[str] = None
                         ) -> TrainState:
        """{"variables", "slots", "it"} seeded from the current variables.
        Slots start at zero for native graphs; imported graphs keep their
        accumulators inside `variables` (they ARE `<var>/Momentum` vars)."""
        opt = self.discover_optimizer(loss_name)
        slots = {v: torch.zeros_like(self.variables[v])
                 for v in opt.trainable if v not in opt.slot_of}
        return {"variables": dict(self.variables), "slots": slots, "it": 0}

    def make_train_step(self, loss_name: Optional[str] = None
                        ) -> Callable[[TrainState, Dict],
                                      Tuple[TrainState, torch.Tensor]]:
        """Pure (state, batch) -> (state, loss): ONE optimizer application,
        what one reference `session.Run([train//step])` did. It returns
        new tensors and leaves the given state's untouched. Used by both
        `step()` and the distributed trainer; `batch` holds device tensors
        in the graph's input dtypes."""
        loss_name = self.resolve_loss(loss_name)
        opt = self.discover_optimizer(loss_name)

        def step_fn(state, batch):
            variables, slots, it = (state["variables"], state["slots"],
                                    state["it"])
            with torch.no_grad():
                lr = opt.lr_fn(variables, it)
            train_vars = {v: variables[v].detach().requires_grad_(True)
                          for v in opt.trainable}
            merged = dict(variables)
            merged.update(train_vars)
            with torch.enable_grad():
                loss = self._eval(merged, batch, (loss_name,))[0]
                grads = torch.autograd.grad(
                    loss, [train_vars[v] for v in opt.trainable],
                    allow_unused=True)
            new_vars = dict(variables)
            new_slots = dict(slots)
            with torch.no_grad():
                for v, g in zip(opt.trainable, grads):
                    if g is None:  # no path to the loss: JAX's zero grad
                        g = torch.zeros_like(variables[v])
                    slot_var = opt.slot_of.get(v)
                    accum = (variables[slot_var] if slot_var is not None
                             else slots[v])  # per-var: mixed Apply* graphs
                    accum = opt.momentum * accum + g
                    if slot_var is not None:
                        new_vars[slot_var] = accum
                    else:
                        new_slots[v] = accum
                    new_vars[v] = variables[v] - lr * accum
                if opt.counter is not None:
                    new_vars[opt.counter] = (variables[opt.counter]
                                             + opt.counter_inc)
            return ({"variables": new_vars, "slots": new_slots,
                     "it": it + 1}, loss.detach())

        return step_fn

    # -- public introspection / execution ------------------------------------

    def input_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Placeholder name -> declared shape (incl. the batch dim; () when
        the graph declares none)."""
        return {i: tuple(self._nodes[i].attrs.get("shape", ()))
                for i in self.input_names}

    def input_dtypes(self) -> Dict[str, str]:
        """Placeholder name -> declared dtype string (default float32)."""
        return {i: str(self._nodes[i].attrs.get("dtype", "float32"))
                for i in self.input_names}

    def fetch(self, variables: Mapping[str, torch.Tensor],
              batch: Mapping[str, torch.Tensor],
              names: Sequence[str]) -> Tuple[torch.Tensor, ...]:
        """Fetch named nodes given explicit variables (device tensors in,
        device tensors out) — the functional core of `forward()`, public
        so external trainers can call it."""
        return self._eval(variables, batch, tuple(names))

    # -- NetInterface --------------------------------------------------------

    def forward(self, batch: Mapping[str, Any],
                fetches: Optional[Sequence[str]] = None, *,
                blob_names: Optional[Sequence[str]] = None
                ) -> Dict[str, np.ndarray]:
        """`blob_names` is accepted as an alias for `fetches` — the
        NetInterface spelling TorchNet uses, so backend-generic callers
        (the featurizer, the server) work unchanged. Blocking: the
        outputs are host arrays when it returns."""
        fetches = tuple(fetches or blob_names or self.output_names())
        with torch.inference_mode():
            vals = self._eval(self.variables, self._prep(batch), fetches)
            return {f: _to_host(v) for f, v in zip(fetches, vals)}

    def step(self, batch: Mapping[str, Any],
             loss_name: Optional[str] = None) -> float:
        """Run the in-graph optimizer once (reference `step`), honoring the
        graph's own hyperparameters and lr schedule."""
        key = self.resolve_loss(loss_name)
        if self._step_fn is not None and self._step_loss != key:
            self._step_fn = None
        if self._step_fn is None:
            self._step_loss = key
            self._step_fn = self.make_train_step(key)
            if self._slots is None:
                self._slots = self.init_train_state(key)["slots"]
        state = {"variables": dict(self.variables), "slots": self._slots,
                 "it": self._it}
        state, loss = self._step_fn(state, self._prep(batch))
        self.variables = dict(state["variables"])
        self._slots = state["slots"]
        self._it = state["it"]
        return float(loss)

    def train_state(self, loss_name: Optional[str] = None) -> TrainState:
        """Current state as the pure step's dict (for external trainers)."""
        if self._slots is None:
            return self.init_train_state(loss_name)
        return {"variables": dict(self.variables), "slots": self._slots,
                "it": self._it}

    def load_train_state(self, state: TrainState) -> None:
        self.variables = dict(state["variables"])
        self._slots = dict(state["slots"])
        self._it = int(state["it"])

    def get_weights(self) -> WeightCollection:
        """Every float variable — including, for imported TF graphs, the
        `<var>/Momentum` slots (reference getWeights DT_FLOAT filter: slots
        are plain float Variables and crossed the wire; the int
        global-step counter did not)."""
        names = self._float_variables()
        return WeightCollection(
            {v: [_to_host(self.variables[v])] for v in names}, names)

    def set_weights(self, weights: WeightCollection) -> None:
        """Assign exactly the named variables (reference setWeights runs one
        `//assign` per key). Optimizer slots that are NOT in the
        collection keep their values: nothing is reset."""
        for v in weights.layer_names:
            if v not in self.variables:
                raise KeyError(f"graph has no variable {v!r}")
            arr = weights[v][0]
            if arr.shape != tuple(self.variables[v].shape):
                raise ValueError(f"{v}: {arr.shape} != "
                                 f"{tuple(self.variables[v].shape)}")
            self.variables[v] = to_tensor(arr, self.device)

    def output_names(self) -> List[str]:
        """Terminal nodes that are actually evaluable: excludes protocol
        nodes, opaque imported ops (TF::*), and any terminal whose ancestor
        closure touches an opaque op or a multi-output ref ('node:1')."""
        consumed = {i for n in self.graph.nodes for i in n.inputs}
        out = []
        for n in self.graph.nodes:
            if n.name in consumed or n.op in (
                    "Placeholder", "Variable", "Assign", "NoOp", "Train"):
                continue
            if self._evaluable(n.name):
                out.append(n.name)
        return out

    def _evaluable(self, name: str) -> bool:
        """True iff no ancestor is opaque (TF::*) or an unknown ref.
        Explicit-stack DFS."""
        seen, stack = set(), [name]
        while stack:
            nm = stack.pop()
            if nm in seen:
                continue
            seen.add(nm)
            n = self._nodes.get(nm)
            if n is None:  # unknown ref, e.g. 'node:1'
                return False
            if n.op.startswith("TF::"):
                return False
            if n.op not in ("Placeholder", "Variable", "Const"):
                stack.extend(n.inputs)
        return True

    def output_schema(self) -> Schema:
        outs = self.forward_shapes(self.output_names())
        return Schema(*[Field(name, "float32", tuple(s[1:]) if s else ())
                        for name, s in outs.items()])

    def forward_shapes(self, names: Sequence[str]) -> Dict[str, Tuple]:
        """Shape inference: the graph run on meta tensors (no data, no
        device work)."""
        meta = torch.device("meta")
        batch = {}
        for iname in self.input_names:
            node = self._nodes[iname]
            batch[iname] = torch.empty(
                tuple(node.attrs["shape"]), device=meta,
                dtype=torch_dtype(node.attrs.get("dtype", "float32")))
        variables = {k: torch.empty(v.shape, dtype=v.dtype, device=meta)
                     for k, v in self.variables.items()}
        with torch.no_grad():
            out = self._eval(variables, batch, tuple(names), device=meta)
        return {n: tuple(o.shape) for n, o in zip(names, out)}

    def _prep(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """Host arrays -> device tensors in the placeholders' dtypes (as
        JAX holds them); a 4-D NCHW array is transposed to NHWC."""
        out = {}
        for iname in self.input_names:
            if iname not in batch:
                raise ValueError(f"batch missing graph input {iname!r}")
            node = self._nodes[iname]
            arr = np.asarray(batch[iname])
            want = tuple(node.attrs.get("shape", arr.shape))
            if len(want) == 4 and arr.ndim == 4 and \
                    tuple(arr.shape[1:]) != tuple(want[1:]) and \
                    (arr.shape[2], arr.shape[3], arr.shape[1]) == \
                    tuple(want[1:]):
                arr = np.transpose(arr, (0, 2, 3, 1))  # NCHW -> NHWC
            dt = jax_dtype(node.attrs.get("dtype", "float32"))
            out[iname] = torch.from_numpy(np.ascontiguousarray(
                arr.astype(dt, copy=False))).to(self.device)
        return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Blocking device->host fetch; bf16 comes back as float32 (numpy has
    no bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
