"""TF GraphDef (.pb) importer — no TensorFlow dependency.

A copy of `sparknet_tpu/backend/tf_import.py` for the port (its code is
pure numpy; the copy imports the port's `graphdef`, so the port imports
nothing of the JAX package). Both packages' `import_tf_graphdef` give
the same `GraphDef` for the same bytes.

Capability parity target: the reference consumed frozen TF GraphDefs
generated by `models/tensorflow/*/​*_graph.py` and executed them natively
(`libs/TensorFlowNet.scala:15-19`). This importer reads the same .pb files
with a hand-rolled protobuf *wire-format* decoder (no protoc, no TF), maps
the forward-path op subset onto our portable GraphDef, and preserves the
`//update_placeholder` / `//assign` / `train//step` protocol nodes.

Gradient/optimizer subgraphs (`gradients/...`, `ApplyMomentum`, shape-math
helpers) are carried through as opaque nodes: execution is lazy per fetch, so
they only matter if fetched — training uses our autodiff (`GraphNet.step`)
against the graph's loss node instead of TF's baked gradient ops.

Proto schema subset (field numbers from tensorflow/core/framework):
  GraphDef:  node=1 (NodeDef)
  NodeDef:   name=1 op=2 input=3 attr=5(map: key=1 value=2)
  AttrValue: s=2 i=3 f=4 b=5 type=6 shape=7 tensor=8 list=1
  TensorShapeProto: dim=2 (size=1)
  TensorProto: dtype=1 tensor_shape=2 tensor_content=4
               float_val=5 double_val=6 int_val=7 int64_val=10
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .graphdef import GraphDef, NodeDef

# ---------------------------------------------------------------------------
# Protobuf wire-format decoding (generic)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def parse_wire(buf: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Decode one message into {field_number: [(wire_type, raw_value), ...]}."""
    fields: Dict[int, List[Tuple[int, Any]]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")
        fields.setdefault(fno, []).append((wt, val))
    return fields


def _one(fields, fno, default=None):
    v = fields.get(fno)
    return v[-1][1] if v else default


# ---------------------------------------------------------------------------
# TF proto interpretation
# ---------------------------------------------------------------------------

_DT = {1: "float32", 3: "int32", 6: "int8", 7: "string", 9: "int64",
       10: "bool", 4: "uint8", 2: "float64"}
_DT_NP = {"float32": np.float32, "int32": np.int32, "int64": np.int64,
          "uint8": np.uint8, "float64": np.float64, "bool": np.bool_,
          "int8": np.int8}


def _parse_shape(buf: bytes) -> List[int]:
    dims = []
    for _, d in parse_wire(buf).get(2, []):
        size = _one(parse_wire(d), 1, 0)
        # zigzag not used; sizes are plain varints (may be 2**64-1 for -1)
        dims.append(size - (1 << 64) if size > (1 << 63) else size)
    return dims


def _parse_tensor(buf: bytes) -> Optional[np.ndarray]:
    f = parse_wire(buf)
    dtype = _DT.get(_one(f, 1, 1), "float32")
    if dtype not in _DT_NP:
        return None
    shape = _parse_shape(_one(f, 2, b""))
    def varints(entries):
        out: List[int] = []
        for wt, v in entries:
            if wt == 2:  # packed
                pos = 0
                while pos < len(v):
                    x, pos = _read_varint(v, pos)
                    out.append(x - (1 << 64) if x > (1 << 63) else x)
            else:
                out.append(v - (1 << 64) if v > (1 << 63) else v)
        return out

    content = _one(f, 4)
    if content is not None:
        arr = np.frombuffer(content, dtype=_DT_NP[dtype])
    elif 5 in f and dtype == "float32":
        arr = np.array([struct.unpack("<f", v)[0] for _, v in f[5]],
                       np.float32)
    elif 7 in f and dtype == "int32":
        arr = np.array(varints(f[7]), np.int32)
    elif 10 in f and dtype == "int64":
        arr = np.array(varints(f[10]), np.int64)
    else:
        arr = np.zeros(shape or (), _DT_NP[dtype])
    if shape:
        if arr.size == 1 and int(np.prod(shape)) > 1:
            arr = np.full(shape, arr.reshape(-1)[0])  # splat encoding
        arr = arr.reshape(shape)
    elif arr.size == 1:
        arr = arr.reshape(())
    return arr


def _parse_attr(buf: bytes) -> Any:
    f = parse_wire(buf)
    if 2 in f:
        return _one(f, 2).decode("utf-8", "replace")  # s (bytes->str)
    if 3 in f:
        v = _one(f, 3)
        return v - (1 << 64) if v > (1 << 63) else v  # i
    if 4 in f:
        return struct.unpack("<f", _one(f, 4))[0]  # f
    if 5 in f:
        return bool(_one(f, 5))  # b
    if 6 in f:
        return _DT.get(_one(f, 6), "unknown")  # type
    if 7 in f:
        return _parse_shape(_one(f, 7))  # shape
    if 8 in f:
        return _parse_tensor(_one(f, 8))  # tensor
    if 1 in f:  # list
        lf = parse_wire(_one(f, 1))
        if 3 in lf:  # ints: possibly packed (wt=2) or individual varints
            out: List[int] = []
            for wt, v in lf[3]:
                if wt == 2:  # packed
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        out.append(x - (1 << 64) if x > (1 << 63) else x)
                else:
                    out.append(v - (1 << 64) if v > (1 << 63) else v)
            return out
        if 2 in lf:
            return [v.decode("utf-8", "replace") for _, v in lf[2]]
        if 4 in lf:  # floats: packed or fixed32
            out_f: List[float] = []
            for wt, v in lf[4]:
                if wt == 2:
                    out_f.extend(struct.unpack(f"<{len(v)//4}f", v))
                else:
                    out_f.append(struct.unpack("<f", v)[0])
            return out_f
    return None


def parse_tf_graphdef(data: bytes) -> List[Dict[str, Any]]:
    """.pb bytes -> [{name, op, inputs, attrs}] raw node dicts."""
    nodes = []
    for _, node_buf in parse_wire(data).get(1, []):
        nf = parse_wire(node_buf)
        name = (_one(nf, 1) or b"").decode()
        op = (_one(nf, 2) or b"").decode()
        inputs = [v.decode() for _, v in nf.get(3, [])]
        attrs: Dict[str, Any] = {}
        for _, attr_buf in nf.get(5, []):
            af = parse_wire(attr_buf)
            key = (_one(af, 1) or b"").decode()
            attrs[key] = _parse_attr(_one(af, 2, b""))
        nodes.append({"name": name, "op": op, "inputs": inputs,
                      "attrs": attrs})
    return nodes


# ---------------------------------------------------------------------------
# Conversion to our GraphDef
# ---------------------------------------------------------------------------

_DIRECT = {"Relu": "Relu", "Softmax": "Softmax", "BiasAdd": "BiasAdd",
           "Add": "Add", "AddV2": "Add", "Sub": "Sub", "Mul": "Mul",
           "MatMul": "MatMul", "Identity": "Identity", "Tanh": "Tanh",
           "Div": "Div", "RealDiv": "Div", "Floor": "Floor", "Pow": "Pow",
           "Maximum": "Maximum", "Minimum": "Minimum", "Neg": "Neg",
           "Exp": "Exp", "Sqrt": "Sqrt"}


def import_tf_graphdef(data: bytes, name: str = "tf_import") -> GraphDef:
    raw = parse_tf_graphdef(data)
    consts: Dict[str, np.ndarray] = {
        n["name"]: n["attrs"].get("value") for n in raw if n["op"] == "Const"}

    def clean_inputs(ins):
        # drop control deps (^node); keep output-index refs as-is (":1" refs
        # belong to gradient paths we don't execute)
        return [i for i in ins if not i.startswith("^")]

    def base(i):
        return i.split(":")[0]

    out: List[NodeDef] = []
    for n in raw:
        nm, op, ins = n["name"], n["op"], clean_inputs(n["inputs"])
        ins = [base(i) if i.endswith(":0") else i for i in ins]
        a = n["attrs"]
        if op == "Placeholder":
            out.append(NodeDef(nm, "Placeholder", [], {
                "shape": a.get("shape", []),
                "dtype": a.get("dtype", "float32")}))
        elif op in ("Variable", "VariableV2"):
            out.append(NodeDef(nm, "Variable", [], {
                "shape": a.get("shape", []),
                "dtype": a.get("dtype", "float32"),
                "init": None}))
        elif op == "Const":
            out.append(NodeDef(nm, "Const", [], {"value": a.get("value")}))
        elif op == "Conv2D":
            strides = a.get("strides", [1, 1, 1, 1])
            out.append(NodeDef(nm, "Conv2D", ins, {
                "strides": [strides[1], strides[2]],
                "padding": a.get("padding", "SAME")}))
        elif op == "MaxPool":
            k = a.get("ksize", [1, 2, 2, 1])
            s = a.get("strides", [1, 2, 2, 1])
            out.append(NodeDef(nm, "MaxPool", ins, {
                "ksize": k[1], "strides": s[1],
                "padding": a.get("padding", "SAME")}))
        elif op == "Reshape":
            shape = consts.get(base(ins[1])) if len(ins) > 1 else None
            if shape is not None:
                out.append(NodeDef(nm, "Reshape", ins[:1],
                                   {"shape": [int(x) for x in shape]}))
            else:
                out.append(NodeDef(nm, "Flatten", ins[:1], {}))
        elif op == "SparseSoftmaxCrossEntropyWithLogits":
            # TF returns per-example losses; our op returns the mean — any
            # downstream Mean over it is then a no-op on a scalar, handled
            # by Mean's scalar passthrough.
            out.append(NodeDef(nm, "SparseSoftmaxCrossEntropy", ins, {}))
        elif op == "Mean":
            # reduction indices come as a const operand; bake into attrs
            axis = consts.get(base(ins[1])) if len(ins) > 1 else None
            axis_attr = ([int(x) for x in np.atleast_1d(axis)]
                         if axis is not None else None)
            out.append(NodeDef(nm, "Mean", ins[:1], {"axis": axis_attr}))
        elif op == "L2Loss":
            out.append(NodeDef(nm, "L2Loss", ins, {}))
        elif op == "AddN":
            out.append(NodeDef(nm, "AddN", ins, {}))
        elif op == "ArgMax":
            dim = consts.get(base(ins[1])) if len(ins) > 1 else None
            out.append(NodeDef(nm, "ArgMax", ins[:1],
                               {"axis": int(dim) if dim is not None else -1}))
        elif op == "Equal":
            out.append(NodeDef(nm, "Equal", ins, {}))
        elif op == "Cast":
            out.append(NodeDef(nm, "Cast", ins,
                               {"dtype": a.get("DstT", "float32")}))
        elif op == "Assign":
            out.append(NodeDef(nm, "Assign", ins, {}))
        elif op == "NoOp":
            out.append(NodeDef(nm, "NoOp", [], {}))
        elif op in _DIRECT:
            out.append(NodeDef(nm, _DIRECT[op], ins, {}))
        else:
            # opaque (gradient/optimizer/shape machinery): fails only if
            # something fetches through it
            out.append(NodeDef(nm, f"TF::{op}", ins, {}))
    return GraphDef(name=name, nodes=out)


def import_tf_graphdef_file(path: str, name: Optional[str] = None) -> GraphDef:
    with open(path, "rb") as f:
        return import_tf_graphdef(f.read(), name or path)
