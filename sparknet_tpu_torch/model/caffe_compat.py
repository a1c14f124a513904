"""Device params <-> Caffe-layout WeightCollection.

The counterpart of `sparknet_tpu/model/caffe_compat.py`. The port's params
already use Caffe's layouts (conv OIHW, inner product (out, in) over the
NCHW flatten order), so both directions are copies with shape checks; a
get_weights -> set_weights round trip is bit-identical.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .net import CompiledNet, ParamTree
from .weights import WeightCollection


def params_to_collection(net: CompiledNet, params: ParamTree
                         ) -> WeightCollection:
    """Device params -> host WeightCollection, in the spec's layer order."""
    weights: Dict[str, List[np.ndarray]] = {}
    order: List[str] = []
    for layer in net.spec.layers:
        if layer.name not in params:
            continue
        order.append(layer.name)
        lp = params[layer.name]
        weights[layer.name] = [lp[k].detach().to("cpu", torch.float32).numpy()
                               for k in ("w", "b") if k in lp]
    return WeightCollection(weights, order)


def collection_to_params(net: CompiledNet, coll: WeightCollection,
                         like: ParamTree) -> ParamTree:
    """Caffe-layout WeightCollection -> device params shaped and placed
    like `like` (the net's current params). Legacy `.caffemodel`
    inner-product blobs (4-D (1, 1, out, in), or 1-D for num_output=1)
    are canonicalised; any other shape mismatch names the blob."""
    params: ParamTree = {}
    for lname, lp in like.items():
        if lname not in coll:
            raise ValueError(f"weights missing layer {lname!r}")
        blobs = coll[lname]
        names = [k for k in ("w", "b") if k in lp]
        if len(blobs) != len(names):
            raise ValueError(f"{lname}: {len(blobs)} blobs, net has "
                             f"{len(names)}")
        params[lname] = {}
        for pname, blob in zip(names, blobs):
            ref = lp[pname]
            a = np.asarray(blob, dtype=np.float32)
            if pname == "w" and ref.ndim == 2 and a.ndim == 4 \
                    and a.shape[:2] == (1, 1):
                a = a.reshape(a.shape[2:])
            elif pname == "w" and ref.ndim == 2 and a.ndim == 1:
                a = a.reshape(1, -1)
            elif pname == "b":
                a = a.reshape(-1)
            if tuple(a.shape) != tuple(ref.shape):
                raise ValueError(f"{lname}/{pname}: shape {a.shape} != net "
                                 f"{tuple(ref.shape)}")
            params[lname][pname] = torch.from_numpy(
                np.ascontiguousarray(a)).to(ref.device)
    return params
