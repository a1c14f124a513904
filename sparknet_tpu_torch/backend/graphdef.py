"""Portable serialized dataflow-graph format and its ops on tensors.

The counterpart of `sparknet_tpu/backend/graphdef.py`: the second backend's
file format (the JSON a `GraphDef` writes is byte-for-byte the JAX
package's, so either package reads the other's graphs) and the `OPS` table,
here as functions of PyTorch tensors.

Format (JSON):
    {"version": 1, "name": ...,
     "nodes": [{"name": ..., "op": ..., "inputs": [...], "attrs": {...}}]}

Conventions, the naming protocol of the reference's TF models:
  - inputs         = Placeholder nodes NOT named `*//update_placeholder`
  - weights        = Variable nodes (attrs carry the initial value)
  - per-variable   `<var>//update_placeholder` + `<var>//assign` pairs
  - `train//step`  = the in-graph optimizer application node
  - `init//all_vars` initializes variables

Layouts are the graph's own: tensors between ops are NHWC, conv weights
HWIO and matmul weights (in, out), so a graph's variables carry across
packages as they are. An op permutes at its call: `x.permute(0, 3, 1, 2)`
of an NHWC tensor is the channels-last NCHW view cuDNN takes without a
copy, and `w.permute(3, 2, 0, 1)` is OIHW.

Where PyTorch's defaults differ from the JAX ops, the ops follow JAX:
  - TF "SAME" padding is asymmetric (low side total // 2, high side the
    rest); `F.conv2d(padding="same")` refuses stride > 1, so the ops pad
    explicitly, MaxPool with -inf;
  - `Relu`, `Maximum` and `Minimum` are `torch.maximum` / `torch.minimum`,
    which split a tie's gradient 0.5 / 0.5 as `jnp.maximum` does
    (`torch.relu` gives 0 at 0);
  - dtypes: JAX runs with 64-bit types off, so a float64 or int64 constant,
    initializer or cast becomes float32 or int32 (`jax_dtype`), and the
    binary ops promote both operands to a common dtype first (PyTorch lets
    a 0-d tensor's dtype lose to a dimensioned one's, JAX does not);
  - the cross-entropy runs in float32 under the bfloat16 policy too.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import precision

UPDATE_SUFFIX = "//update_placeholder"
ASSIGN_SUFFIX = "//assign"
TRAIN_STEP = "train//step"
INIT_ALL_VARS = "init//all_vars"


@dataclass
class NodeDef:
    name: str
    op: str
    inputs: List[str] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class GraphDef:
    name: str
    nodes: List[NodeDef]
    version: int = 1

    def node(self, name: str) -> NodeDef:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def to_json(self) -> str:
        def enc(v):
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            return v
        return json.dumps({
            "version": self.version, "name": self.name,
            "nodes": [{"name": n.name, "op": n.op, "inputs": n.inputs,
                       "attrs": {k: enc(v) for k, v in n.attrs.items()}}
                      for n in self.nodes]})

    @staticmethod
    def from_json(text: str) -> "GraphDef":
        def dec(v):
            if isinstance(v, dict) and "__ndarray__" in v:
                return np.asarray(v["__ndarray__"], dtype=v["dtype"])
            return v
        d = json.loads(text)
        if d.get("version") != 1:
            raise ValueError(f"unsupported graph version {d.get('version')!r}")
        return GraphDef(
            name=d.get("name", "graph"),
            nodes=[NodeDef(name=n["name"], op=n["op"],
                           inputs=list(n.get("inputs", [])),
                           attrs={k: dec(v)
                                  for k, v in n.get("attrs", {}).items()})
                   for n in d["nodes"]])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "GraphDef":
        with open(path) as f:
            return GraphDef.from_json(f.read())


# ---------------------------------------------------------------------------
# dtypes as JAX sees them (64-bit types off)
# ---------------------------------------------------------------------------

_NARROW = {np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32)}


def jax_dtype(dtype: Any) -> np.dtype:
    """The numpy dtype JAX gives an array of `dtype` with 64-bit types
    off: float64 -> float32, int64 -> int32, uint64 -> uint32."""
    dt = np.dtype(dtype)
    return _NARROW.get(dt, dt)


def torch_dtype(dtype: Any) -> torch.dtype:
    """`jax_dtype(dtype)` as a torch dtype ("bfloat16" included)."""
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), jax_dtype(dtype))).dtype


def to_tensor(value: Any, device=None) -> torch.Tensor:
    """`jnp.asarray(value)` as a tensor on `device`: a copy, in the dtype
    JAX would hold it in."""
    arr = np.asarray(value)
    return torch.from_numpy(arr.astype(jax_dtype(arr.dtype))).to(device)


def _promote(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both operands in their common dtype, whatever their ranks (JAX's
    promotion of two typed arrays)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _binary(fn):
    def op(n, ins):
        return fn(*_promote(ins[0], ins[1]))
    return op


# ---------------------------------------------------------------------------
# Op kernels: node -> value, given evaluated inputs
# ---------------------------------------------------------------------------

def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF/XLA "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _op_conv2d(n, ins):
    x, w = ins
    sh, sw = (int(v) for v in n.attrs.get("strides", (1, 1)))
    kh, kw = int(w.shape[0]), int(w.shape[1])
    xc = precision.cast_in(x).permute(0, 3, 1, 2)  # NHWC -> NCHW view
    wc = precision.cast_in(w).permute(3, 2, 0, 1)  # HWIO -> OIHW
    pad = (0, 0)
    if n.attrs.get("padding", "SAME") == "SAME":
        (t, b), (l, r) = (same_pads(x.shape[1], kh, sh),
                          same_pads(x.shape[2], kw, sw))
        if (t, l) == (b, r):
            pad = (t, l)
        else:
            xc = F.pad(xc, (l, r, t, b))
    y = F.conv2d(xc, wc, None, stride=(sh, sw), padding=pad,
                 groups=int(n.attrs.get("groups", 1)))
    return y.permute(0, 2, 3, 1)


def _op_matmul(n, ins):
    x, w = ins
    return torch.matmul(precision.cast_in(x), precision.cast_in(w))


def _op_max_pool(n, ins):
    (x,) = ins
    k = int(n.attrs.get("ksize", 2))
    s = int(n.attrs.get("strides", 2))
    xc = x.permute(0, 3, 1, 2)
    if n.attrs.get("padding", "SAME") == "SAME":
        t, b = same_pads(x.shape[1], k, s)
        l, r = same_pads(x.shape[2], k, s)
        if t or b or l or r:
            xc = F.pad(xc, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(xc, k, s).permute(0, 2, 3, 1)


def _op_reshape(n, ins):
    (x,) = ins
    shape = [int(d) for d in n.attrs["shape"]]
    total = int(np.prod([d for d in shape if d != -1]))
    if -1 not in shape and total != x.numel():
        # serialized graphs bake the training batch size into reshape consts
        # (e.g. [64, 3136] in the reference's mnist_graph.pb); treat the
        # leading dim as the batch when the tail divides evenly.
        tail = int(np.prod(shape[1:]))
        if tail > 0 and x.numel() % tail == 0:
            shape = [x.numel() // tail] + shape[1:]
    return x.reshape(shape)


def _labels(labels: torch.Tensor) -> torch.Tensor:
    """int32 labels, (B, 1) -> (B,)."""
    labels = labels.to(torch.int32)
    if labels.ndim == 2 and labels.shape[1] == 1:
        labels = labels[:, 0]
    return labels


def _op_sparse_softmax_ce(n, ins):
    logits, labels = ins
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, _labels(labels).long()[:, None])[:, 0]
    return -torch.mean(picked)


def _op_accuracy(n, ins):
    logits, labels = ins
    pred = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.mean((pred == _labels(labels)).float())


def _op_mean(n, ins):
    (x,) = ins
    if x.ndim == 0:
        return x
    if not x.is_floating_point():
        x = x.float()
    axis = n.attrs.get("axis")
    return torch.mean(x) if axis is None else torch.mean(
        x, dim=tuple(int(a) for a in axis))


def _op_relu(n, ins):
    (x,) = ins
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _op_add_n(n, ins):
    out = ins[0]
    for x in ins[1:]:
        out = torch.add(*_promote(out, x))
    return out


def _op_cast(n, ins):
    return ins[0].to(torch_dtype(n.attrs.get("dtype", "float32")))


OPS: Dict[str, Callable[[NodeDef, Sequence[torch.Tensor]], torch.Tensor]] = {
    "Conv2D": _op_conv2d,
    "MatMul": _op_matmul,
    "MaxPool": _op_max_pool,
    "BiasAdd": lambda n, ins: ins[0] + ins[1].to(ins[0].dtype),
    "Add": _binary(torch.add),
    "Sub": _binary(torch.sub),
    "Mul": _binary(torch.mul),
    "Relu": _op_relu,
    "Tanh": lambda n, ins: torch.tanh(ins[0]),
    "Softmax": lambda n, ins: torch.softmax(ins[0], dim=-1),
    "Reshape": _op_reshape,
    "Flatten": lambda n, ins: ins[0].reshape(ins[0].shape[0], -1),
    "Dropout": lambda n, ins: ins[0],  # eval semantics, as in the JAX op
    "SparseSoftmaxCrossEntropy": _op_sparse_softmax_ce,
    "Accuracy": _op_accuracy,
    "Identity": lambda n, ins: ins[0],
    # on the CPU here; the executor places (and caches) constants itself
    "Const": lambda n, ins: to_tensor(n.attrs["value"]),
    # TF-import support set; 'axis' attr baked from const operands at import
    "Mean": _op_mean,
    "L2Loss": lambda n, ins: 0.5 * torch.sum(torch.square(ins[0])),
    "AddN": _op_add_n,
    "ArgMax": lambda n, ins: torch.argmax(
        ins[0], dim=int(n.attrs.get("axis", -1))).to(torch.int32),
    "Equal": lambda n, ins: ins[0] == ins[1].to(ins[0].dtype),
    "Cast": _op_cast,
    # scalar/elementwise math: enough to evaluate in-graph optimizer
    # hyperparameter subgraphs (the reference mnist graph's
    # tf.train.exponential_decay: Cast/Div/Floor/Pow/Mul chain)
    "Div": lambda n, ins: torch.true_divide(*_promote(ins[0], ins[1])),
    "Floor": lambda n, ins: torch.floor(ins[0]),
    "Pow": _binary(torch.pow),
    "Maximum": _binary(torch.maximum),
    "Minimum": _binary(torch.minimum),
    "Neg": lambda n, ins: -ins[0],
    "Exp": lambda n, ins: torch.exp(ins[0]),
    "Sqrt": lambda n, ins: torch.sqrt(ins[0]),
}
