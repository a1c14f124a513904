"""Declarative model IR: the port's equivalent of Caffe's NetParameter.

A copy of `sparknet_tpu/model/spec.py` (pure Python); the port keeps its own
so that it never imports the JAX package.

The reference framework consumed Caffe prototxt (parsed natively via
`ReadProtoFromTextFileOrDie`, see reference `apps/CifarApp.scala:83-88`) and TF
GraphDefs. Here the IR is a plain-Python dataclass graph that a compiler
(`sparknet_tpu_torch.model.net`) lowers to an `apply(params, batch)` on tensors.

Layer set = exactly what the reference model zoo uses
(reference `models/*.prototxt`): Convolution, Pooling, LRN, ReLU, InnerProduct,
Softmax, SoftmaxWithLoss, Accuracy, Dropout — plus Input declarations.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Filler:
    """Parameter initializer spec (Caffe `FillerParameter` semantics).

    type: "constant" (value), "gaussian" (std), "xavier" (uniform +-sqrt(3/fan_in)),
    "uniform" (min/max), "msra" (He normal).
    """

    type: str = "constant"
    value: float = 0.0
    std: float = 0.01
    mean: float = 0.0
    min: float = 0.0
    max: float = 1.0


@dataclass(frozen=True)
class ParamSpec:
    """Per-blob training hyperparameters (Caffe `ParamSpec`)."""

    lr_mult: float = 1.0
    decay_mult: float = 1.0


@dataclass(frozen=True)
class ConvolutionParam:
    num_output: int = 0
    kernel_size: int = 1
    stride: int = 1
    pad: int = 0
    group: int = 1
    bias_term: bool = True
    weight_filler: Filler = field(default_factory=Filler)
    bias_filler: Filler = field(default_factory=Filler)


@dataclass(frozen=True)
class PoolingParam:
    pool: str = "MAX"  # MAX | AVE
    kernel_size: int = 1
    stride: int = 1
    pad: int = 0
    global_pooling: bool = False


@dataclass(frozen=True)
class LRNParam:
    local_size: int = 5
    alpha: float = 1.0
    beta: float = 0.75
    k: float = 1.0
    norm_region: str = "ACROSS_CHANNELS"


@dataclass(frozen=True)
class InnerProductParam:
    num_output: int = 0
    bias_term: bool = True
    weight_filler: Filler = field(default_factory=Filler)
    bias_filler: Filler = field(default_factory=Filler)


@dataclass(frozen=True)
class DropoutParam:
    dropout_ratio: float = 0.5


@dataclass(frozen=True)
class AccuracyParam:
    top_k: int = 1


@dataclass(frozen=True)
class LayerSpec:
    name: str
    type: str
    bottoms: Tuple[str, ...] = ()
    tops: Tuple[str, ...] = ()
    params: Tuple[ParamSpec, ...] = ()
    include_phase: Optional[str] = None  # None = both; "TRAIN" | "TEST"
    conv: Optional[ConvolutionParam] = None
    pool: Optional[PoolingParam] = None
    lrn: Optional[LRNParam] = None
    inner_product: Optional[InnerProductParam] = None
    dropout: Optional[DropoutParam] = None
    accuracy: Optional[AccuracyParam] = None


@dataclass(frozen=True)
class InputSpec:
    """A declared net input (Caffe `input:` + `input_shape` blocks).

    Shape is the Caffe-declared shape: (N, C, H, W) for images, (N, D) for
    tabular/labels. Batch dim included, as in the reference prototxts.
    """

    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"


@dataclass(frozen=True)
class NetSpec:
    name: str
    inputs: Tuple[InputSpec, ...]
    layers: Tuple[LayerSpec, ...]

    def input_names(self) -> List[str]:
        return [i.name for i in self.inputs]

    def layer_by_name(self, name: str) -> LayerSpec:
        for l in self.layers:
            if l.name == name:
                return l
        raise KeyError(name)

    def layers_for_phase(self, phase: str) -> List[LayerSpec]:
        return [
            l
            for l in self.layers
            if l.include_phase is None or l.include_phase == phase
        ]

    def replace(self, **kw) -> "NetSpec":
        return dataclasses.replace(self, **kw)


# Layer types that carry trainable parameters.
PARAMETRIC_LAYER_TYPES = ("Convolution", "InnerProduct")


def validate(spec: NetSpec) -> None:
    """Structural validation: every bottom must be produced before use."""
    available = set(spec.input_names())
    for l in spec.layers:
        for b in l.bottoms:
            if b not in available:
                raise ValueError(
                    f"layer {l.name!r}: bottom {b!r} not produced by any "
                    f"earlier layer or input (have {sorted(available)})"
                )
        available.update(l.tops)
