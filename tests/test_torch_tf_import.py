"""The port's TF GraphDef importer (`sparknet_tpu_torch/backend/tf_import.py`)
and the GraphNet it feeds, against the JAX package's.

No TensorFlow and no file from outside the repo: `_tf_graph_bytes` writes a
small TF GraphDef in the protobuf wire format here, the shape of the
reference's mnist graph at 8x8: `Placeholder`s (float data, int64
labels), `VariableV2` + `Assign` from `Const` (tensor_content, repeated
float_val, a one-value splat, int_val) and one from an opaque
`TruncatedNormal`, `Conv2D` (SAME, packed strides), `BiasAdd`, `Relu`,
`MaxPool` (SAME, unpacked ksize), a `Reshape` whose shape constant bakes
the batch size in, `MatMul`, `AddV2`, `SparseSoftmaxCrossEntropyWithLogits`
then `Mean` over its (already scalar) output, the accuracy as
`ArgMax` / `Equal` / `Cast` / `Mean`, an `exponential_decay` chain
(Cast / RealDiv / Floor / Pow / Mul of the int32 global step), one
`ApplyMomentum` per variable with `<var>/Momentum` slot variables, the
`//update_placeholder` / `//assign` protocol pairs and `train//step` as
an `AssignAdd` of the global step.
- Both packages' `import_tf_graphdef` give the same GraphDef (equal JSON).
- Both GraphNets (the opaque initializer's random values carried across
  with `set_weights`) agree on the forward at the graph's batch and at
  another one (the baked reshape), on the discovered optimizer, and over
  three `step`s: losses, every variable (slots and the int counter
  included) within 1e-4 x the largest magnitude + 1e-6 per tensor
  (float32 sums in another order); the lr subgraph's value at each step
  within 1e-6 relative.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.backend.graph_net import GraphNet as JaxGraphNet
from sparknet_tpu.backend.tf_import import import_tf_graphdef as jax_import
from sparknet_tpu.backend.tf_import import parse_wire as jax_parse_wire

from sparknet_tpu_torch.backend.graph_net import GraphNet
from sparknet_tpu_torch.backend.tf_import import (import_tf_graphdef,
                                                  parse_tf_graphdef,
                                                  parse_wire)
from sparknet_tpu_torch.model.weights import WeightCollection

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-6)
B = 4  # the batch the graph's reshape constant bakes in

# -- the protobuf wire format, written by hand ------------------------------

_DT = {"float32": 1, "int32": 3, "int64": 9}


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _vi(field: int, n: int) -> bytes:
    return _varint(field << 3) + _varint(n)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _f32(field: int, x: float) -> bytes:
    return _varint((field << 3) | 5) + struct.pack("<f", x)


def _shape(dims) -> bytes:
    return b"".join(_ld(2, _vi(1, int(d))) for d in dims)


def _tensor(arr: np.ndarray, how: str) -> bytes:
    out = _vi(1, _DT[str(arr.dtype)]) + _ld(2, _shape(arr.shape))
    flat = arr.reshape(-1)
    if how == "content":
        return out + _ld(4, arr.tobytes())
    if how == "float_val":
        return out + b"".join(_f32(5, float(x)) for x in flat)
    if how == "splat":  # one value for the whole shape
        return out + _f32(5, float(flat[0]))
    if how == "int_val":
        return out + b"".join(_vi(7, int(x)) for x in flat)
    raise ValueError(how)


def _a_s(s: str) -> bytes:
    return _ld(2, s.encode())


def _a_type(dt: str) -> bytes:
    return _vi(6, _DT[dt])


def _a_shape(dims) -> bytes:
    return _ld(7, _shape(dims))


def _a_tensor(arr, how) -> bytes:
    return _ld(8, _tensor(np.asarray(arr), how))


def _a_ints(values, packed: bool) -> bytes:
    if packed:
        return _ld(1, _ld(3, b"".join(_varint(v) for v in values)))
    return _ld(1, b"".join(_vi(3, v) for v in values))


def _node(name, op, inputs=(), **attrs) -> bytes:
    b = _ld(1, name.encode()) + _ld(2, op.encode())
    b += b"".join(_ld(3, i.encode()) for i in inputs)
    for k, v in attrs.items():
        b += _ld(5, _ld(1, k.encode()) + _ld(2, v))
    return _ld(1, b)


def _const(name, arr, how):
    arr = np.asarray(arr)
    return _node(name, "Const", dtype=_a_type(str(arr.dtype)),
                 value=_a_tensor(arr, how))


def _tf_graph_bytes(seed: int = 0) -> bytes:
    r = np.random.default_rng(seed)
    n = []
    n.append(_node("data", "Placeholder", dtype=_a_type("float32"),
                   shape=_a_shape([B, 8, 8, 1])))
    n.append(_node("label", "Placeholder", dtype=_a_type("int64"),
                   shape=_a_shape([B])))
    inits = {
        "conv_w": ((3, 3, 1, 4), "content",
                   (0.3 * r.standard_normal((3, 3, 1, 4))).astype(
                       np.float32)),
        "conv_b": ((4,), "splat", np.full(4, 0.1, np.float32)),
        "fc_w": ((64, 10), None, None),  # TruncatedNormal: opaque
        "fc_b": ((10,), "float_val",
                 (0.1 * r.standard_normal(10)).astype(np.float32)),
    }
    variables = list(inits)
    for v, (shape, how, val) in inits.items():
        n.append(_node(v, "VariableV2", dtype=_a_type("float32"),
                       shape=_a_shape(shape)))
        if how is None:
            n.append(_const(f"{v}/shape", np.asarray(shape, np.int32),
                            "int_val"))
            n.append(_node(f"{v}/initial_value", "TruncatedNormal",
                           [f"{v}/shape"], dtype=_a_type("float32")))
        else:
            n.append(_const(f"{v}/initial_value", val, how))
        n.append(_node(f"{v}/Assign", "Assign", [v, f"{v}/initial_value"]))
        n.append(_node(f"{v}/Momentum", "VariableV2",
                       dtype=_a_type("float32"), shape=_a_shape(shape)))
        n.append(_const(f"{v}/Momentum/zeros", np.zeros(shape, np.float32),
                        "splat"))
        n.append(_node(f"{v}/Momentum/Assign", "Assign",
                       [f"{v}/Momentum", f"{v}/Momentum/zeros"]))
    n.append(_node("global_step", "VariableV2", dtype=_a_type("int32"),
                   shape=_a_shape([])))
    n.append(_const("global_step/zero", np.asarray(0, np.int32), "int_val"))
    n.append(_node("global_step/Assign", "Assign",
                   ["global_step", "global_step/zero"]))
    # the forward
    n.append(_node("Conv2D", "Conv2D", ["data", "conv_w"],
                   strides=_a_ints([1, 1, 1, 1], packed=True),
                   padding=_a_s("SAME")))
    n.append(_node("BiasAdd", "BiasAdd", ["Conv2D", "conv_b"]))
    n.append(_node("Relu", "Relu", ["BiasAdd"]))
    n.append(_node("MaxPool", "MaxPool", ["Relu"],
                   ksize=_a_ints([1, 2, 2, 1], packed=False),
                   strides=_a_ints([1, 2, 2, 1], packed=True),
                   padding=_a_s("SAME")))
    n.append(_const("Reshape/shape", np.asarray([B, 64], np.int32),
                    "content"))
    n.append(_node("Reshape", "Reshape", ["MaxPool", "Reshape/shape"]))
    n.append(_node("MatMul", "MatMul", ["Reshape", "fc_w"]))
    n.append(_node("logits", "AddV2", ["MatMul", "fc_b"]))
    n.append(_node("prob", "Softmax", ["logits"]))
    n.append(_node("xent", "SparseSoftmaxCrossEntropyWithLogits",
                   ["logits", "label"]))
    n.append(_const("Const_axis", np.asarray([0], np.int32), "int_val"))
    n.append(_node("loss", "Mean", ["xent:0", "Const_axis"]))
    n.append(_const("ArgMax/dimension", np.asarray(1, np.int32), "int_val"))
    n.append(_node("ArgMax", "ArgMax", ["logits", "ArgMax/dimension"]))
    n.append(_node("Equal", "Equal", ["ArgMax", "label"]))
    n.append(_node("Cast", "Cast", ["Equal"], DstT=_a_type("float32")))
    n.append(_node("accuracy", "Mean", ["Cast", "Const_axis"]))
    # tf.train.exponential_decay(0.1, global_step, 2, 0.5, staircase=True)
    n.append(_node("ExponentialDecay/Cast", "Cast", ["global_step"],
                   DstT=_a_type("float32")))
    n.append(_const("ExponentialDecay/decay_steps",
                    np.asarray(2.0, np.float32), "float_val"))
    n.append(_node("ExponentialDecay/truediv", "RealDiv",
                   ["ExponentialDecay/Cast", "ExponentialDecay/decay_steps"]))
    n.append(_node("ExponentialDecay/Floor", "Floor",
                   ["ExponentialDecay/truediv"]))
    n.append(_const("ExponentialDecay/decay_rate",
                    np.asarray(0.5, np.float32), "float_val"))
    n.append(_node("ExponentialDecay/Pow", "Pow",
                   ["ExponentialDecay/decay_rate", "ExponentialDecay/Floor"]))
    n.append(_const("ExponentialDecay/lr0", np.asarray(0.1, np.float32),
                    "content"))
    n.append(_node("learning_rate", "Mul",
                   ["ExponentialDecay/lr0", "ExponentialDecay/Pow"]))
    # the optimizer: TF's gradient machinery stays opaque
    n.append(_const("Momentum/momentum", np.asarray(0.9, np.float32),
                    "float_val"))
    n.append(_node("gradients/Fill", "Fill", ["loss"]))
    for v in variables:
        n.append(_node(f"gradients/{v}_grad", "ZerosLike",
                       ["gradients/Fill"]))
        n.append(_node(f"Momentum/update_{v}/ApplyMomentum", "ApplyMomentum",
                       [v, f"{v}/Momentum", "learning_rate",
                        f"gradients/{v}_grad:0", "Momentum/momentum",
                        "^gradients/Fill"]))
    n.append(_const("train/one", np.asarray(1, np.int32), "int_val"))
    n.append(_node("train//step", "AssignAdd",
                   ["global_step", "train/one"] +
                   [f"^Momentum/update_{v}/ApplyMomentum"
                    for v in variables]))
    for v in variables + [f"{v}/Momentum" for v in variables]:
        shape = inits[v.split("/")[0]][0]
        n.append(_node(v + "//update_placeholder", "Placeholder",
                       dtype=_a_type("float32"), shape=_a_shape(shape)))
        n.append(_node(v + "//assign", "Assign",
                       [v, v + "//update_placeholder"]))
    n.append(_node("init//all_vars", "NoOp",
                   [f"^{v}/Assign" for v in variables]))
    return b"".join(n)


def _batch(n=B, seed=0):
    r = np.random.default_rng(seed)
    return {"data": r.standard_normal((n, 8, 8, 1)).astype(np.float32),
            "label": r.integers(0, 10, (n,)).astype(np.int64)}


def _close(got, want, what):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want), initial=0.0))
    bound = TOL["rtol"] * float(np.max(np.abs(want), initial=0.0)) \
        + TOL["atol"]
    assert err <= bound, f"{what}: max abs err {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module")
def pb():
    return _tf_graph_bytes()


def test_the_wire_parser_reads_what_the_helper_writes(pb):
    buf = _vi(1, 150) + _ld(2, b"abc") + _f32(3, 1.5) + _vi(4, -1)
    for parse in (parse_wire, jax_parse_wire):
        f = parse(buf)
        assert f[1][0][1] == 150 and f[2][0][1] == b"abc"
        assert struct.unpack("<f", f[3][0][1])[0] == 1.5
        assert f[4][0][1] == (1 << 64) - 1
    nodes = {d["name"]: d for d in parse_tf_graphdef(pb)}
    assert nodes["data"]["attrs"]["shape"] == [B, 8, 8, 1]
    assert nodes["MaxPool"]["attrs"]["ksize"] == [1, 2, 2, 1]
    assert nodes["conv_b/initial_value"]["attrs"]["value"].tolist() == \
        pytest.approx([0.1] * 4)


def test_both_importers_give_the_same_graphdef(pb):
    port, jax_ = import_tf_graphdef(pb, "g"), jax_import(pb, "g")
    assert port.to_json() == jax_.to_json()
    ops = {n.name: n.op for n in port.nodes}
    assert ops["Reshape"] == "Reshape" and ops["loss"] == "Mean"
    assert ops["train//step"] == "TF::AssignAdd"
    assert ops["Momentum/update_conv_w/ApplyMomentum"] == "TF::ApplyMomentum"


def _nets(pb):
    jnet = JaxGraphNet(jax_import(pb, "g"))
    pnet = GraphNet(import_tf_graphdef(pb, "g"), device="cpu")
    # the opaque initializer's random values cannot match: carry them over
    names = ["fc_w"]
    pnet.set_weights(WeightCollection(
        {v: [np.asarray(jnet.variables[v])] for v in names}, names))
    return jnet, pnet


def test_forward_and_the_optimizer_match_the_jax_graph_net(pb):
    jnet, pnet = _nets(pb)
    assert pnet.variable_names == jnet.variable_names
    for v in jnet.variable_names:
        _close(pnet.variables[v], jnet.variables[v], f"init {v}")
        assert pnet.variables[v].numpy().dtype == \
            np.asarray(jnet.variables[v]).dtype, v
    assert pnet.output_names() == jnet.output_names()
    names = ["Conv2D", "MaxPool", "Reshape", "logits", "prob", "loss",
             "ArgMax", "accuracy"]
    for n in (B, 6):  # 6: the baked [4, 64] reshape takes the batch
        b = _batch(n)
        want, got = jnet.forward(b, names), pnet.forward(b, names)
        for k in names:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            _close(got[k], want[k], f"{k} at batch {n}")
    jopt, popt = jnet.discover_optimizer(), pnet.discover_optimizer()
    assert (popt.trainable, popt.slot_of, popt.counter, popt.counter_inc) \
        == (jopt.trainable, jopt.slot_of, jopt.counter, jopt.counter_inc)
    assert popt.momentum == pytest.approx(jopt.momentum)
    assert pnet.get_weights().layer_names == jnet.get_weights().layer_names


def test_three_steps_match_the_jax_graph_net(pb):
    jnet, pnet = _nets(pb)
    jopt, popt = jnet.discover_optimizer(), pnet.discover_optimizer()
    for s in range(3):
        lr_want = float(jopt.lr_fn(jnet.variables, None))
        lr_got = float(popt.lr_fn(pnet.variables, None))
        assert lr_got == pytest.approx(lr_want, rel=1e-6), s
        b = _batch(seed=10 + s)
        _close(pnet.step(b), jnet.step(b), f"loss {s}")
    assert float(popt.lr_fn(pnet.variables, None)) == pytest.approx(0.05)
    for v in jnet.variable_names:
        _close(pnet.variables[v], jnet.variables[v], v)
    assert int(pnet.variables["global_step"]) == \
        int(jnet.variables["global_step"]) == 3
    assert float(jnp.abs(jnet.variables["conv_w/Momentum"]).sum()) > 0
