"""The net API surface — NetInterface parity, on PyTorch.

The counterpart of `sparknet_tpu/net_api.py` (`JaxNet`). `TorchNet` owns a
`CompiledNet` and its params on one device and exposes forward /
forward_backward / step / get_weights / set_weights / output_schema, plus
`load_jax_params` to carry weights over from the JAX package. Save and
load of weight files wait for the model-file port.

Host batches and returned blobs are NHWC numpy arrays, as in the JAX
package; NCHW batches are recognised and transposed (`_maybe_nhwc`).
`forward` copies the batch host->device synchronously and fetches outputs
with a blocking device->host copy, so the caller's host buffers are free
for reuse when it returns (the inference server's pad buffers rely on it).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from . import precision
from .device import resolve_device
from .model.caffe_compat import collection_to_params, params_to_collection
from .model.layers import OpsImpl
from .model.net import CompiledNet, ParamTree, params_from_jax
from .model.spec import NetSpec
from .model.weights import WeightCollection
from .model.layers import seeded_generator
from .schema import Field, Schema
from .solver import SgdSolver, SolverConfig, SolverState, value_and_grad

def _maybe_nhwc(arr: np.ndarray, want_shape: Tuple[int, ...]) -> np.ndarray:
    """Accept NCHW host batches and transpose to NHWC, recognised by
    matching the expected NHWC element shape, so both reference-style NCHW
    batches and native NHWC batches just work."""
    want = tuple(want_shape[1:])
    if arr.ndim == 4 and tuple(arr.shape[1:]) != want and \
            (arr.shape[2], arr.shape[3], arr.shape[1]) == want:
        return np.transpose(arr, (0, 2, 3, 1))
    return arr


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Blocking device->host fetch; bf16 blobs come back as float32
    (numpy has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class TorchNet:
    """Stateful net: CompiledNet + params on one device.

    device: "cuda" by default; raises without a card unless the caller
    passes device="cpu". seed: the torch.Generator seed for Caffe-filler
    init (drawn on the CPU, so a seed gives the same weights on any
    device) and of the TRAIN-phase dropout generators. solver: makes
    `step` available. ops: the kernel routes of forward_backward and step.
    """

    def __init__(self, spec: NetSpec, *, seed: int = 0,
                 device: Optional[str] = None,
                 solver: Optional[SolverConfig] = None,
                 loss_blob: str = "loss", ops: Optional[OpsImpl] = None):
        self.device = resolve_device(device)
        self.net = CompiledNet.compile(spec)
        self.params: ParamTree = self.net.init_params(
            torch.Generator().manual_seed(seed), self.device)
        self.loss_blob = loss_blob
        self.ops = ops
        self.solver: Optional[SgdSolver] = None
        self.solver_state: Optional[SolverState] = None
        if solver is not None:
            self.solver = SgdSolver(self.net, solver, loss_blob=loss_blob,
                                    ops=ops)
            self.solver_state = self.solver.init_state(self.params)
        self._seed = seed ^ 0x5EED
        self._calls = 0  # forward_backward / step calls: the generator key

    # -- data plumbing ------------------------------------------------------

    def _prep(self, batch: Mapping[str, np.ndarray]
              ) -> Dict[str, torch.Tensor]:
        out = {}
        for name, want in self.net.input_shapes.items():
            if name not in batch:
                raise ValueError(f"batch missing net input {name!r}")
            arr = _maybe_nhwc(np.asarray(batch[name]), want)
            if tuple(arr.shape[1:]) != tuple(want[1:]):
                raise ValueError(
                    f"input {name!r}: got {arr.shape}, net expects "
                    f"(N,)+{tuple(want[1:])} (layout NHWC)")
            dt = precision.DTYPES[self.net.input_dtypes[name]]
            out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                self.device, dt)
        return out

    # -- NetInterface parity -------------------------------------------------

    def forward(self, batch: Mapping[str, np.ndarray],
                blob_names: Optional[List[str]] = None, *,
                ops: Optional[OpsImpl] = None) -> Dict[str, np.ndarray]:
        """Test-phase forward. Returns the output blobs plus any requested
        hidden blobs, as NHWC numpy arrays. `ops` selects the kernels
        (default `OpsImpl()`: the CUDA kernels on the card)."""
        with torch.inference_mode():
            blobs = self.net.apply(self.params, self._prep(batch), ops=ops)
            want = set(self.net.output_names) | set(blob_names or [])
            return {k: _to_host(v) for k, v in blobs.items() if k in want}

    def _generator(self) -> torch.Generator:
        self._calls += 1
        return seeded_generator((self._seed, self._calls))

    def _trainable(self) -> ParamTree:
        for lp in self.params.values():
            for w in lp.values():
                w.requires_grad_(True)
        return self.params

    def forward_backward(self, batch: Mapping[str, np.ndarray]
                         ) -> ParamTree:
        """TRAIN-phase forward + backward; returns the grads ({layer:
        {param: tensor}}, PyTorch layouts) and does NOT update the
        weights (the reference's `forwardBackward`)."""
        loss_fn = self.net.loss_fn(self.loss_blob, ops=self.ops)
        _, grads = value_and_grad(loss_fn, self._trainable(),
                                  self._prep(batch), self._generator())
        return grads

    def step(self, batch: Mapping[str, np.ndarray]) -> float:
        """One SGD step (the reference's `CaffeSolver.step`); returns the
        loss. With iter_size = k the batch holds k x net-batch examples."""
        if self.solver is None:
            raise ValueError("construct TorchNet with solver= to train")
        self.params, self.solver_state, loss = self.solver.step(
            self._trainable(), self.solver_state, self._prep(batch),
            self._generator())
        return float(loss)

    def load_jax_params(self, jax_params: Mapping[str, Mapping[str, np.ndarray]]
                        ) -> None:
        """Install weights in the JAX package's layouts ({layer: {param:
        array}}, e.g. a JaxNet's params as numpy)."""
        self.params = params_from_jax(self.net, jax_params, self.device)

    def get_weights(self) -> WeightCollection:
        return params_to_collection(self.net, self.params)

    def set_weights(self, weights: WeightCollection) -> None:
        self.params = collection_to_params(self.net, weights, self.params)

    def output_schema(self) -> Schema:
        """Schema of output blobs (parity `outputSchema`)."""
        fields = []
        for name in self.net.output_names:
            shape = self.net.blob_shapes[name]
            fields.append(Field(name=name, dtype="float32",
                                shape=tuple(shape[1:]) if shape else ()))
        return Schema(*fields)
