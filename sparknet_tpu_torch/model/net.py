"""NetSpec -> PyTorch forward compiler.

The counterpart of `sparknet_tpu/model/net.py`. A `CompiledNet` holds
  - `init_params(generator, device) -> params`
    ({layer_name: {"w": tensor, "b": tensor}}, PyTorch layouts)
  - `apply(params, batch, train=..., generator=...) -> {blob_name: tensor}`
    (TEST or TRAIN phase; differentiable with autograd)
  - `loss_fn(loss_blob) -> f(params, batch, generator) -> (loss, blobs)`
and the shape bookkeeping of the JAX package: `input_shapes` (NHWC),
`blob_shapes` and `output_names`.

Layout: `apply` takes and returns NHWC tensors, as the JAX package's
`CompiledNet.apply` does, so the two compare blob for blob. Inside, 4-D
blobs are NCHW in channels_last memory; the permutes at the boundary are
views, not copies.

Weights cross between the packages through `params_from_jax` and
`params_to_jax`: conv HWIO `(kh, kw, cin/g, O)` <-> OIHW, inner product
`(in, out)` <-> `(out, in)`. This is the one place that knows both layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import precision
from .layers import LAYER_IMPLS, ApplyCtx, OpsImpl, Params, _flat_dim
from .quant import QuantConfig
from .spec import NetSpec, validate

ParamTree = Dict[str, Params]


def _to_nhwc_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    if len(shape) == 4:
        n, c, h, w = shape
        return (n, h, w, c)
    return shape


@dataclasses.dataclass(frozen=True)
class CompiledNet:
    spec: NetSpec
    #: blob name -> NHWC shape for every net input
    input_shapes: Dict[str, Tuple[int, ...]]
    #: blob name -> dtype string
    input_dtypes: Dict[str, str]
    #: blob name -> NHWC shape for every top (() = scalar)
    blob_shapes: Dict[str, Tuple[int, ...]]
    #: names of output blobs (tops never consumed by a later layer)
    output_names: Tuple[str, ...]

    # -- construction -------------------------------------------------------

    @staticmethod
    def compile(spec: NetSpec) -> "CompiledNet":
        validate(spec)
        input_shapes = {i.name: _to_nhwc_shape(i.shape) for i in spec.inputs}
        input_dtypes = {i.name: i.dtype for i in spec.inputs}
        blob_shapes: Dict[str, Tuple[int, ...]] = dict(input_shapes)
        consumed: set = set()
        produced: List[str] = list(input_shapes)
        for layer in spec.layers:
            if layer.type not in LAYER_IMPLS:
                raise ValueError(f"unsupported layer type {layer.type!r} "
                                 f"(layer {layer.name!r})")
            _, _, infer = LAYER_IMPLS[layer.type]
            in_shapes = tuple(blob_shapes[b] for b in layer.bottoms)
            for t, s in zip(layer.tops, infer(layer, in_shapes)):
                blob_shapes[t] = s
                produced.append(t)
            consumed.update(b for b in layer.bottoms if b not in layer.tops)
        outputs = tuple(
            dict.fromkeys(t for t in produced
                          if t not in consumed and t not in input_shapes))
        return CompiledNet(spec=spec, input_shapes=input_shapes,
                           input_dtypes=input_dtypes, blob_shapes=blob_shapes,
                           output_names=outputs)

    # -- parameters ---------------------------------------------------------

    def _param_layer_inputs(self):
        """(layer, NHWC input shapes) for each parametric layer."""
        shapes: Dict[str, Tuple[int, ...]] = dict(self.input_shapes)
        for layer in self.spec.layers:
            init, _, infer = LAYER_IMPLS[layer.type]
            in_shapes = tuple(shapes[b] for b in layer.bottoms)
            if init is not None:
                yield layer, in_shapes
            for t, s in zip(layer.tops, infer(layer, in_shapes)):
                shapes[t] = s

    def init_params(self, generator: torch.Generator,
                    device: torch.device) -> ParamTree:
        """Fresh Caffe-filler params, drawn layer by layer (weight, then
        bias) from `generator` on the CPU and moved to `device`, so one
        seed gives the same weights on every device."""
        return {layer.name: LAYER_IMPLS[layer.type][0](generator, layer,
                                                       in_shapes, device)
                for layer, in_shapes in self._param_layer_inputs()}

    def param_layers(self) -> List[str]:
        return [l.name for l in self.spec.layers
                if LAYER_IMPLS[l.type][0] is not None]

    # -- execution ----------------------------------------------------------

    def apply(self, params: ParamTree, batch: Mapping[str, torch.Tensor], *,
              train: bool = False, phase: Optional[str] = None,
              generator: Optional[torch.Generator] = None,
              ops: Optional[OpsImpl] = None,
              quant: Optional[QuantConfig] = None
              ) -> Dict[str, torch.Tensor]:
        """Run the net. `batch` maps input blob names to NHWC tensors;
        returns every blob produced (inputs excluded), 4-D blobs as NHWC
        views — parity with the JAX package's `CompiledNet.apply`, hidden
        blobs included. `phase` defaults to TRAIN when `train` else TEST;
        `generator` seeds the TRAIN phase's dropout masks (ApplyCtx.fold).
        `quant`: serving-side weight-only quantization (model/quant.py);
        `params` may then hold int8 `w_q` + per-channel `w_scale` for the
        parametric layers, which dequantize at use into its activation
        dtype. Gradients flow to `params` through autograd."""
        precision.apply_backend_flags()
        phase = phase or ("TRAIN" if train else "TEST")
        ctx = ApplyCtx(ops=ops or OpsImpl(), train=train,
                       generator=generator, quant=quant)
        blobs: Dict[str, torch.Tensor] = {
            k: (v.permute(0, 3, 1, 2) if v.ndim == 4 else v)
            for k, v in batch.items()}
        all_tops = set()
        for layer in self.spec.layers_for_phase(phase):
            _, apply_fn, _ = LAYER_IMPLS[layer.type]
            inputs = tuple(blobs[b] for b in layer.bottoms)
            outputs = apply_fn(layer, params.get(layer.name), inputs, ctx)
            for t, v in zip(layer.tops, outputs):
                blobs[t] = v
                all_tops.add(t)
        return {k: (v.permute(0, 2, 3, 1) if v.ndim == 4 else v)
                for k, v in blobs.items() if k in all_tops}

    def loss_fn(self, loss_blob: str = "loss",
                ops: Optional[OpsImpl] = None):
        """`f(params, batch, generator=None) -> (loss, blobs)`, a TRAIN-phase
        apply for autograd (the JAX package's `loss_fn` for jax.grad)."""

        def f(params, batch, generator=None):
            blobs = self.apply(params, batch, train=True,
                               generator=generator, ops=ops)
            return blobs[loss_blob], blobs

        return f


# ---------------------------------------------------------------------------
# Weights across packages
# ---------------------------------------------------------------------------


def _jax_layout(layer_type: str, pname: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().to("cpu", torch.float32).numpy()
    if pname == "w" and layer_type == "Convolution":
        return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
    if pname == "w" and layer_type == "InnerProduct":
        return np.ascontiguousarray(a.T)
    return a


def params_to_jax(net: CompiledNet, params: ParamTree
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """Port params -> the JAX package's layouts as numpy: conv OIHW ->
    HWIO, inner product (out, in) -> (in, out). Exact permutations."""
    types = {l.name: l.type for l in net.spec.layers}
    return {lname: {pname: _jax_layout(types[lname], pname, t)
                    for pname, t in lp.items()}
            for lname, lp in params.items()}


def jax_param_shapes(net: CompiledNet) -> Dict[str, Dict[str, tuple]]:
    """The JAX package's param shapes for this net, without building any
    weights: conv w HWIO (kh, kw, cin/g, O), inner product w (in, out)."""
    out: Dict[str, Dict[str, tuple]] = {}
    for layer, in_shapes in net._param_layer_inputs():
        if layer.type == "Convolution":
            p = layer.conv
            w = (p.kernel_size, p.kernel_size, in_shapes[0][-1] // p.group,
                 p.num_output)
        else:
            p = layer.inner_product
            w = (_flat_dim(in_shapes[0]), p.num_output)
        out[layer.name] = {"w": w}
        if p.bias_term:
            out[layer.name]["b"] = (p.num_output,)
    return out


def params_from_jax(net: CompiledNet,
                    jax_params: Mapping[str, Mapping[str, np.ndarray]],
                    device: torch.device) -> ParamTree:
    """JAX-layout params ({layer: {param: array}}) -> port params on
    `device`: conv HWIO -> OIHW (`permute(3, 2, 0, 1)`), inner product
    (in, out) -> (out, in). Every layer and param the net has must be
    present with the JAX package's shape; a mismatch names it."""
    want = jax_param_shapes(net)
    types = {l.name: l.type for l in net.spec.layers}
    out: ParamTree = {}
    for lname, pshapes in want.items():
        if lname not in jax_params:
            raise ValueError(f"weights missing layer {lname!r}")
        lp = jax_params[lname]
        extra = set(lp) - set(pshapes)
        if extra:
            raise ValueError(f"{lname}: unexpected params {sorted(extra)}")
        out[lname] = {}
        for pname, shape in pshapes.items():
            if pname not in lp:
                raise ValueError(f"weights missing {lname}/{pname}")
            a = np.array(lp[pname], dtype=np.float32, order="C")  # a copy
            if tuple(a.shape) != shape:
                raise ValueError(f"{lname}/{pname}: shape {a.shape} != "
                                 f"net {shape} (JAX layout)")
            t = torch.from_numpy(a)
            if pname == "w" and types[lname] == "Convolution":
                t = t.permute(3, 2, 0, 1)
            elif pname == "w" and types[lname] == "InnerProduct":
                t = t.t()
            out[lname][pname] = t.contiguous().to(device)
    return out
