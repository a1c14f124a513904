"""WeightCollection: the host-side unit of weight exchange, Caffe layout.

Parity with reference `libs/WeightCollection.scala` (and
`TensorFlowWeightCollection.scala`): an ordered mapping
layer name -> list of blobs (numpy, Caffe shapes: conv OIHW, inner-product
(out, in), biases 1-D), with `add`, `scalar_divide`, `check_equal` — the
operations the driver used for parameter averaging
(`apps/CifarApp.scala:145-146`).

This class is the host-side API surface: weight export/import and tests.
The port's device params already use Caffe's layouts (conv OIHW, inner
product (out, in)); `caffe_compat` moves them to and from the host.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np


class WeightCollection:
    def __init__(self, weights: Dict[str, List[np.ndarray]],
                 layer_names: List[str] | None = None):
        self.weights = {k: [np.asarray(b, dtype=np.float32) for b in v]
                        for k, v in weights.items()}
        self.layer_names = list(layer_names or weights.keys())

    def __getitem__(self, name: str) -> List[np.ndarray]:
        return self.weights[name]

    def __contains__(self, name: str) -> bool:
        return name in self.weights

    def __iter__(self) -> Iterator[str]:
        return iter(self.layer_names)

    def blobs(self) -> Iterator[Tuple[str, int, np.ndarray]]:
        for name in self.layer_names:
            for j, blob in enumerate(self.weights[name]):
                yield name, j, blob

    def scalar_divide(self, v: float) -> None:
        """In-place divide (reference `WeightCollection.scala:9-15`)."""
        for name in self.layer_names:
            for blob in self.weights[name]:
                blob /= v

    @staticmethod
    def add(a: "WeightCollection", b: "WeightCollection") -> "WeightCollection":
        """Elementwise sum with shape checks (`WeightCollection.scala:19-38`)."""
        assert a.layer_names == b.layer_names, (
            f"layer sets differ: {a.layer_names} vs {b.layer_names}")
        out: Dict[str, List[np.ndarray]] = {}
        for name in a.layer_names:
            ab, bb = a.weights[name], b.weights[name]
            assert len(ab) == len(bb), f"{name}: blob count differs"
            for x, y in zip(ab, bb):
                assert x.shape == y.shape, (
                    f"{name}: shape mismatch {x.shape} vs {y.shape}")
            out[name] = [x + y for x, y in zip(ab, bb)]
        return WeightCollection(out, a.layer_names)

    @staticmethod
    def check_equal(a: "WeightCollection", b: "WeightCollection",
                    tol: float = 1e-6) -> bool:
        """Tolerant equality (`WeightCollection.scala:40-59`)."""
        if a.layer_names != b.layer_names:
            return False
        for name in a.layer_names:
            ab, bb = a.weights[name], b.weights[name]
            if len(ab) != len(bb):
                return False
            for x, y in zip(ab, bb):
                if x.shape != y.shape or not np.allclose(x, y, atol=tol):
                    return False
        return True

    # -- serialization (npz) -------------------------------------------------

    def save(self, path: str) -> None:
        arrays = {f"{name}/{j}": blob for name, j, blob in self.blobs()}
        arrays["__layer_names__"] = np.array(self.layer_names)
        np.savez(path, **arrays)

    @staticmethod
    def load(path: str) -> "WeightCollection":
        with np.load(path, allow_pickle=False) as z:
            layer_names = [str(s) for s in z["__layer_names__"]]
            weights: Dict[str, List[np.ndarray]] = {n: [] for n in layer_names}
            keys = sorted((k for k in z.files if k != "__layer_names__"),
                          key=lambda k: (k.rsplit("/", 1)[0],
                                         int(k.rsplit("/", 1)[1])))
            for k in keys:
                name, _ = k.rsplit("/", 1)
                weights[name].append(z[k])
        return WeightCollection(weights, layer_names)
