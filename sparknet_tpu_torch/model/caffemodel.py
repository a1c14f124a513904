"""Binary `.caffemodel` (Caffe NetParameter protobuf) import/export.

Capability parity with reference `libs/CaffeNet.scala`:
  - `copyTrainedLayersFrom` (152-157): load trained blobs from a binary
    NetParameter file -> here `load_caffemodel` -> `WeightCollection`
    (Caffe layouts: conv OIHW, inner-product (out,in)); feed a net via
    `caffe_compat.collection_to_params` / `JaxNet.set_weights`.
  - `saveWeightsToFile` (159-165: net.ToProto -> WriteProtoToBinaryFile)
    -> here `save_caffemodel`.

No protoc and no Caffe dependency: decoding uses the generic protobuf
wire parser of `protowire.py`, plus a ~40-line wire ENCODER for export.

A copy of `sparknet_tpu/model/caffemodel.py`; only its import of the wire
parser differs (the reference takes it from `backend/tf_import.py`, which
imports jax through `backend/graphdef.py`).

Proto schema subset (field numbers from caffe.proto):
  NetParameter:     name=1  layers=2 (V1LayerParameter)  layer=100 (LayerParameter)
  LayerParameter:   name=1  type=2 (string)  blobs=7
  V1LayerParameter: blobs=6  name=4  type=5 (enum)
  BlobProto:        num=1 channels=2 height=3 width=4 (legacy 4-D shape)
                    data=5 (packed float)  shape=7 (BlobShape)  double_data=8
  BlobShape:        dim=1 (packed int64)
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .protowire import _read_varint, parse_wire
from .weights import WeightCollection

# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _packed_varints(entries) -> List[int]:
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


def _parse_blob(buf: bytes) -> np.ndarray:
    f = parse_wire(buf)
    floats: List[float] = []
    data = f.get(5, [])
    arrs = []
    for wt, v in data:
        if wt == 2:  # packed floats
            arrs.append(np.frombuffer(v, dtype="<f4"))
        else:  # individual fixed32
            arrs.append(np.array([struct.unpack("<f", v)[0]], np.float32))
    if arrs:
        arr = np.concatenate(arrs).astype(np.float32)
    elif 8 in f:  # double_data
        darrs = [np.frombuffer(v, dtype="<f8") for wt, v in f[8] if wt == 2]
        arr = (np.concatenate(darrs) if darrs else
               np.array([], np.float64)).astype(np.float32)
    else:
        arr = np.array([], np.float32)
    # shape: BlobShape (field 7) wins; else legacy num/channels/height/width
    if 7 in f:
        dims = _packed_varints(parse_wire(f[7][-1][1]).get(1, []))
    else:
        legacy = [f.get(i) for i in (1, 2, 3, 4)]
        dims = [v[-1][1] for v in legacy if v is not None]
        # Caffe keeps legacy blobs 4-D (Blob::FromProto); only pure VECTORS
        # ((1,1,1,N) biases) canonicalize to (N,). Stripping leading 1s from
        # anything wider would corrupt e.g. a num_output=1 conv (1,C,H,W) —
        # layer-aware reshaping happens in caffe_compat, which knows types.
        if len(dims) > 1 and int(np.prod(dims[:-1])) == 1:
            dims = dims[-1:]
    if dims:
        if int(np.prod(dims)) != arr.size:
            raise ValueError(f"blob shape {dims} != {arr.size} values")
        arr = arr.reshape(dims)
    return arr


def load_caffemodel(data: bytes) -> WeightCollection:
    """Binary NetParameter -> WeightCollection (Caffe blob layouts).
    Parameter-free layers (ReLU, Pooling, ...) carry no blobs and are
    omitted, mirroring reference getWeights' per-layer blob copy
    (CaffeNet.scala:123-137)."""
    f = parse_wire(data)
    weights: Dict[str, List[np.ndarray]] = {}
    order: List[str] = []
    # new-style `layer` (100) preferred; fall back to V1 `layers` (2)
    for field_no, name_no, blob_no in ((100, 1, 7), (2, 4, 6)):
        for _, layer_buf in f.get(field_no, []):
            lf = parse_wire(layer_buf)
            name_entries = lf.get(name_no)
            if not name_entries:
                continue
            name = name_entries[-1][1].decode("utf-8", "replace")
            blobs = [_parse_blob(b) for _, b in lf.get(blob_no, [])]
            if not blobs:
                continue
            if name in weights:
                continue  # layer field preferred over layers duplicate
            weights[name] = blobs
            order.append(name)
        if weights:
            break
    if not weights:
        raise ValueError("no parametrized layers found in NetParameter "
                         "(not a .caffemodel, or weights-free net)")
    return WeightCollection(weights, order)


def load_caffemodel_file(path: str) -> WeightCollection:
    with open(path, "rb") as fh:
        return load_caffemodel(fh.read())


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_no: int, wire_type: int) -> bytes:
    return _varint((field_no << 3) | wire_type)


def _len_delim(field_no: int, payload: bytes) -> bytes:
    return _tag(field_no, 2) + _varint(len(payload)) + payload


def _encode_blob(arr: np.ndarray) -> bytes:
    dims = b"".join(_varint(int(d)) for d in arr.shape)
    blob_shape = _len_delim(7, _len_delim(1, dims))  # BlobShape{dim packed}
    data = arr.astype("<f4").tobytes()               # packed float data=5
    return _len_delim(5, data) + blob_shape


def _encode_layer(name: str, blobs: List[np.ndarray]) -> bytes:
    payload = _len_delim(1, name.encode()) + _len_delim(2, b"Parameter")
    for b in blobs:
        payload += _len_delim(7, _encode_blob(b))
    return payload


def save_caffemodel(coll: WeightCollection, path: str,
                    net_name: str = "sparknet_tpu") -> None:
    """WeightCollection -> binary NetParameter file readable by Caffe's
    CopyTrainedLayersFrom (blob matching in Caffe is BY LAYER NAME, so the
    layer `type` here is cosmetic)."""
    out = _len_delim(1, net_name.encode())
    for name in coll.layer_names:
        out += _len_delim(100, _encode_layer(name, coll[name]))
    with open(path, "wb") as fh:
        fh.write(out)
