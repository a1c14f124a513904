"""PyTorch implementations of the Caffe layer set (TEST and TRAIN phases).

The counterpart of `sparknet_tpu/model/layers.py`. Each layer type
provides:
  - `init_<type>(generator, layer, in_shapes, device) -> params dict`
    (parametric layers; fillers draw from an explicit torch.Generator)
  - `apply_<type>(layer, params, inputs, ctx) -> outputs tuple`
  - `infer_<type>(layer, in_shapes) -> out_shapes tuple`

Layout. Shapes (`infer_*`, `in_shapes`) follow the JAX package's public
convention, NHWC. Inside the net, image tensors are NCHW in channels_last
memory — `x_nhwc.permute(0, 3, 1, 2)` is exactly that — so convolutions
and pools run in PyTorch's own axis order while the bytes stay NHWC, and
an LRN input's `.permute(0, 2, 3, 1)` is a contiguous (rows, C) view the
CUDA kernel reads with no copy. Parameters use PyTorch's (and Caffe's)
layouts: conv weights OIHW with I = C_in / group, inner-product weights
(out, in) with Caffe's NCHW flatten order. `model/net.py` converts to and
from the JAX package's HWIO / (in, out).

Not ported: the space-to-depth stem rewrite of the JAX conv
(`sparknet_tpu/model/layers.py:203-256`), an exact rewrite for the TPU's
matrix unit; the parity tests hold conv1's output instead.

Gradients are autograd's, except where the JAX package has a Pallas
kernel: LRN and MAX pooling are `torch.autograd.Function`s whose
backwards are the CUDA kernels (`ops/lrn.py`, `ops/pooling.py`).

Dropout is the identity in the TEST phase. In the TRAIN phase it keeps
each element with probability 1 - ratio and scales it by 1/keep (Caffe's
train-time scaling). Its masks come from a `torch.Generator` on the
tensor's device, seeded from the step's generator and the crc32 of the
layer name (`ApplyCtx.fold`, the counterpart of the JAX package's
`jax.random.fold_in`); they cannot equal `jax.random`'s bits.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import precision
from ..ops.lrn import IMPLS as LRN_IMPLS
from ..ops.lrn import lrn as lrn_op
from ..ops.pooling import IMPLS as POOL_IMPLS
from ..ops.pooling import caffe_pool_output_size, global_pool2d, pool2d
from .quant import QuantConfig, dequantize_weight
from .spec import Filler, LayerSpec

Params = Dict[str, torch.Tensor]


def tp_shards_layer(layer: "LayerSpec", tp_size: int) -> bool:
    """The tensor-parallel sharding convention (the JAX package's, shared
    by the forward and the trainers' state): an InnerProduct layer is
    column-sharded iff tp_size divides its num_output; every other layer
    is replicated across the model group."""
    return (tp_size > 1 and layer.type == "InnerProduct"
            and layer.inner_product.num_output % tp_size == 0)


class _GatherColumns(torch.autograd.Function):
    """The column-parallel InnerProduct's feature gather over the model
    group: [N, out/tp] on each model rank -> [N, out], blocks in model-rank
    order. Its backward is the JAX package's transpose of the gather, a
    reduce-scatter (SUM) of the cotangent: every model rank computes the
    same downstream loss, so a shard's gradient comes back x tp and a
    replicated layer's gradient holds only this shard's term x tp, which
    `ParallelTrainer._fix_tp_grads` turns exact (shards / tp, the rest
    summed over the model group / tp). A backward that only sliced its own
    columns would be wrong for two sharded layers in a row: the cotangent
    reaching the first is then a partial sum."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        n, k = y.shape
        flat = group.all_gather_flat(y.contiguous())
        return flat.view(group.size, n, k).permute(1, 0, 2).reshape(
            n, group.size * k)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        n, full = g.shape
        k = full // group.size
        blocks = g.reshape(n, group.size, k).permute(1, 0, 2).contiguous()
        return group.reduce_scatter_sum(blocks).view(n, k), None


@dataclasses.dataclass(frozen=True)
class OpsImpl:
    """Kernel selection for the ops that have a hand-written kernel.

    lrn:  "auto" — the CUDA kernels for CUDA tensors, the plain versions
          for CPU tensors (`ops/cuda_lrn.py`: forward and backward);
          "plain" — the plain PyTorch versions everywhere (the reference
          run on the card).
    pool: the MAX-pool backward, the same two routes
          (`ops/cuda_pool.py`). Both default to "auto" (see
          `ops/pooling.py` for why pool differs from the JAX package).
    """

    lrn: str = "auto"
    pool: str = "auto"

    def __post_init__(self) -> None:
        for op, impls in (("lrn", LRN_IMPLS), ("pool", POOL_IMPLS)):
            if getattr(self, op) not in impls:
                raise ValueError(f"unknown {op} impl "
                                 f"{getattr(self, op)!r}: expected one of "
                                 f"{impls}")


@dataclasses.dataclass
class ApplyCtx:
    """Per-call context threaded through layer application.

    train: the TRAIN phase (dropout active). generator: the step's
    torch.Generator, from which `fold` derives each dropout layer's own.
    quant: serve-side weight-only quantization (model/quant.py) — the
    activation dtype quantized layers dequantize into; consulted only
    when a layer's params carry the (w_q, w_scale) pair.
    tp_group / tp_size: the model group (`parallel/mesh.py:DataGroup`) of a
    tensor-parallel run. InnerProduct layers that `tp_shards_layer` names
    then hold their output rows [m*out/tp, (m+1)*out/tp) of w (out, in)
    and of b — the JAX package's column shard (in, out/tp) — and gather
    the feature axis after the product.
    """

    ops: OpsImpl = dataclasses.field(default_factory=OpsImpl)
    train: bool = False
    generator: Optional[torch.Generator] = None
    quant: Optional[QuantConfig] = None
    tp_group: Optional[Any] = None
    tp_size: int = 1

    def tp_shards(self, layer: LayerSpec) -> bool:
        return self.tp_group is not None and tp_shards_layer(layer,
                                                             self.tp_size)

    def fold(self, name: str, device: torch.device) -> torch.Generator:
        """A generator on `device` seeded from (the step generator's seed,
        crc32(name)) — crc32, not hash(): Python string hashing is
        randomized per process."""
        if self.generator is None:
            raise ValueError(f"dropout layer {name!r} in the TRAIN phase "
                             f"needs a generator")
        return seeded_generator((self.generator.initial_seed(),
                                 zlib.crc32(name.encode())), device)


def seeded_generator(keys, device="cpu") -> torch.Generator:
    """A torch.Generator on `device` seeded from a tuple of non-negative
    ints through numpy's SeedSequence (the port's `fold_in`)."""
    seq = np.random.SeedSequence([int(k) for k in keys])
    return torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0]))


def _cdim(x: torch.Tensor) -> int:
    """The channel axis: 1 for NCHW image tensors, last otherwise."""
    return 1 if x.ndim == 4 else -1


# ---------------------------------------------------------------------------
# Fillers (Caffe FillerParameter semantics)
# ---------------------------------------------------------------------------


def fill(gen: torch.Generator, filler: Filler, shape: Tuple[int, ...],
         fan_in: int) -> torch.Tensor:
    """A float32 CPU tensor drawn from `gen` (the caller moves it)."""
    t = filler.type
    if t == "constant":
        return torch.full(shape, filler.value, dtype=torch.float32)
    if t == "gaussian":
        return filler.mean + filler.std * torch.randn(shape, generator=gen)
    if t == "xavier":
        scale = float(np.sqrt(3.0 / fan_in))
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * scale
    if t == "msra":
        return float(np.sqrt(2.0 / fan_in)) * torch.randn(shape, generator=gen)
    if t == "uniform":
        return filler.min + (filler.max - filler.min) * torch.rand(
            shape, generator=gen)
    raise ValueError(f"unknown filler type {t!r}")


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------


def infer_convolution(layer: LayerSpec, in_shapes):
    (n, h, w, c), = in_shapes[:1]
    p = layer.conv
    oh = (h + 2 * p.pad - p.kernel_size) // p.stride + 1
    ow = (w + 2 * p.pad - p.kernel_size) // p.stride + 1
    return ((n, oh, ow, p.num_output),)


def init_convolution(gen, layer: LayerSpec, in_shapes, device) -> Params:
    p = layer.conv
    c_in = in_shapes[0][-1]
    fan_in = (c_in // p.group) * p.kernel_size * p.kernel_size
    # OIHW with I = c_in / group (PyTorch's grouped-conv layout)
    w = fill(gen, p.weight_filler,
             (p.num_output, c_in // p.group, p.kernel_size, p.kernel_size),
             fan_in)
    params = {"w": w.to(device)}
    if p.bias_term:
        params["b"] = fill(gen, p.bias_filler, (p.num_output,),
                           fan_in).to(device)
    return params


def resolve_quantized(params: Params, x: torch.Tensor, ctx: ApplyCtx):
    """(x, w) for a quantized layer (int8 `w_q` + per-channel `w_scale`,
    installed by the serve ModelManager): the weight dequantized at use
    into the quant activation dtype, `(w_q.float() * w_scale).to(act)`,
    and the activations cast to match — the JAX package's
    `resolve_weight` (`sparknet_tpu/model/layers.py:159-163`)."""
    dt = (ctx.quant or QuantConfig()).act_dtype()
    return x.to(dt), dequantize_weight(params["w_q"],
                                       params["w_scale"]).to(dt)


def apply_convolution(layer: LayerSpec, params: Params, inputs,
                      ctx: ApplyCtx):
    p = layer.conv
    (x,) = inputs
    b = params.get("b")
    if "w_q" in params:
        # the JAX package's order: the product in the activation dtype,
        # then the bias cast to it and added
        x, w = resolve_quantized(params, x, ctx)
        y = F.conv2d(x, w, None, stride=p.stride, padding=p.pad,
                     groups=p.group)
        return (y if b is None else y + b.to(y.dtype).view(1, -1, 1, 1),)
    y = F.conv2d(precision.cast_in(x), precision.cast_in(params["w"]),
                 None if b is None else precision.cast_in(b),
                 stride=p.stride, padding=p.pad, groups=p.group)
    return (y,)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------


def infer_pooling(layer: LayerSpec, in_shapes):
    n, h, w, c = in_shapes[0]
    p = layer.pool
    if p.global_pooling:
        return ((n, 1, 1, c),)
    oh = caffe_pool_output_size(h, p.kernel_size, p.stride, p.pad)
    ow = caffe_pool_output_size(w, p.kernel_size, p.stride, p.pad)
    return ((n, oh, ow, c),)


def apply_pooling(layer: LayerSpec, params, inputs, ctx: ApplyCtx):
    p = layer.pool
    (x,) = inputs
    if p.global_pooling:
        return (global_pool2d(x, p.pool),)
    return (pool2d(x, p.pool, p.kernel_size, p.stride, p.pad,
                   impl=ctx.ops.pool),)


# ---------------------------------------------------------------------------
# LRN
# ---------------------------------------------------------------------------


def infer_lrn(layer: LayerSpec, in_shapes):
    return (in_shapes[0],)


def apply_lrn(layer: LayerSpec, params, inputs, ctx: ApplyCtx):
    p = layer.lrn
    (x,) = inputs
    # the channels-last view: free when x is in channels_last memory
    rows = x.permute(0, 2, 3, 1).contiguous() if x.ndim == 4 else x
    y = lrn_op(rows, p.local_size, alpha=p.alpha, beta=p.beta, k=p.k,
               impl=ctx.ops.lrn)
    return (y.permute(0, 3, 1, 2) if x.ndim == 4 else y,)


# ---------------------------------------------------------------------------
# ReLU
# ---------------------------------------------------------------------------


def infer_relu(layer: LayerSpec, in_shapes):
    return (in_shapes[0],)


def apply_relu(layer: LayerSpec, params, inputs, ctx: ApplyCtx):
    (x,) = inputs
    return (F.relu(x),)


# ---------------------------------------------------------------------------
# InnerProduct
# ---------------------------------------------------------------------------


def _flat_dim(shape: Tuple[int, ...]) -> int:
    d = 1
    for s in shape[1:]:
        d *= s
    return d


def infer_innerproduct(layer: LayerSpec, in_shapes):
    n = in_shapes[0][0]
    return ((n, layer.inner_product.num_output),)


def init_innerproduct(gen, layer: LayerSpec, in_shapes, device) -> Params:
    p = layer.inner_product
    fan_in = _flat_dim(in_shapes[0])
    params = {"w": fill(gen, p.weight_filler, (p.num_output, fan_in),
                        fan_in).to(device)}
    if p.bias_term:
        params["b"] = fill(gen, p.bias_filler, (p.num_output,),
                           fan_in).to(device)
    return params


def apply_innerproduct(layer: LayerSpec, params: Params, inputs,
                       ctx: ApplyCtx):
    (x,) = inputs
    # Caffe flattens in NCHW order, which is the logical order of the
    # NCHW tensors here (reshape copies out of channels_last memory)
    x = x.reshape(x.shape[0], -1)
    b = params.get("b")
    if "w_q" in params:
        x, w = resolve_quantized(params, x, ctx)
        y = F.linear(x, w)
        return (y if b is None else y + b.to(y.dtype),)
    y = F.linear(precision.cast_in(x), precision.cast_in(params["w"]),
                 None if b is None else precision.cast_in(b))
    if ctx.tp_shards(layer):
        y = _GatherColumns.apply(y, ctx.tp_group)
    return (y,)


# ---------------------------------------------------------------------------
# Softmax / SoftmaxWithLoss / Accuracy
# ---------------------------------------------------------------------------


def infer_softmax(layer: LayerSpec, in_shapes):
    return (in_shapes[0],)


def apply_softmax(layer: LayerSpec, params, inputs, ctx: ApplyCtx):
    (x,) = inputs
    # Caffe softmax axis=1 == the channel axis
    return (F.softmax(x, dim=_cdim(x)),)


def _squeeze_label(label: torch.Tensor) -> torch.Tensor:
    if label.ndim == 2 and label.shape[1] == 1:
        label = label[:, 0]
    return label.long()


def infer_softmaxwithloss(layer: LayerSpec, in_shapes):
    return ((),)


def apply_softmaxwithloss(layer: LayerSpec, params, inputs, ctx: ApplyCtx):
    logits, label = inputs
    label = _squeeze_label(label)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, label[:, None])[:, 0]
    return (nll.mean(),)


def infer_accuracy(layer: LayerSpec, in_shapes):
    return ((),)


def apply_accuracy(layer: LayerSpec, params, inputs, ctx: ApplyCtx):
    logits, label = inputs
    label = _squeeze_label(label)
    k = layer.accuracy.top_k if layer.accuracy else 1
    if k == 1:
        correct = torch.argmax(logits, dim=-1) == label
    else:
        topk = torch.topk(logits, k, dim=-1).indices
        correct = (topk == label[:, None]).any(dim=-1)
    return (correct.float().mean(),)


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------


def infer_dropout(layer: LayerSpec, in_shapes):
    return (in_shapes[0],)


def apply_dropout(layer: LayerSpec, params, inputs, ctx: ApplyCtx):
    (x,) = inputs
    ratio = layer.dropout.dropout_ratio if layer.dropout else 0.5
    if not ctx.train or ratio == 0.0:
        return (x,)
    keep = 1.0 - ratio
    mask = torch.rand(x.shape, generator=ctx.fold(layer.name, x.device),
                      device=x.device) < keep
    # Caffe scales at train time by 1/keep so eval needs no rescale
    return (torch.where(mask, x / keep, 0.0).to(x.dtype),)


# ---------------------------------------------------------------------------
# Concat / Flatten
# ---------------------------------------------------------------------------


def infer_concat(layer: LayerSpec, in_shapes):
    base = list(in_shapes[0])
    base[-1] = sum(s[-1] for s in in_shapes)
    return (tuple(base),)


def apply_concat(layer: LayerSpec, params, inputs, ctx: ApplyCtx):
    return (torch.cat(inputs, dim=_cdim(inputs[0])),)


def infer_flatten(layer: LayerSpec, in_shapes):
    return ((in_shapes[0][0], _flat_dim(in_shapes[0])),)


def apply_flatten(layer: LayerSpec, params, inputs, ctx: ApplyCtx):
    (x,) = inputs
    return (x.reshape(x.shape[0], -1),)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

LAYER_IMPLS = {
    "Convolution": (init_convolution, apply_convolution, infer_convolution),
    "Pooling": (None, apply_pooling, infer_pooling),
    "LRN": (None, apply_lrn, infer_lrn),
    "ReLU": (None, apply_relu, infer_relu),
    "InnerProduct": (init_innerproduct, apply_innerproduct,
                     infer_innerproduct),
    "Softmax": (None, apply_softmax, infer_softmax),
    "SoftmaxWithLoss": (None, apply_softmaxwithloss, infer_softmaxwithloss),
    "Accuracy": (None, apply_accuracy, infer_accuracy),
    "Dropout": (None, apply_dropout, infer_dropout),
    "Concat": (None, apply_concat, infer_concat),
    "Flatten": (None, apply_flatten, infer_flatten),
}
