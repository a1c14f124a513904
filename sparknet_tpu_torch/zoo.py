"""Model zoo: programmatic NetSpec builders for the reference's model set.

Mirrors the architectures of the reference zoo (reference `models/`):
  - cifar10_quick  <- models/cifar10/cifar10_quick_train_test.prototxt
  - caffenet       <- models/bvlc_reference_caffenet/train_val.prototxt
                      (AlexNet variant: 5 conv + 2 LRN + 3 FC + dropout)
  - lenet          <- models/tensorflow/mnist/mnist_graph.py (LeNet-style)
  - adult_mlp      <- models/adult/adult.prototxt

Specs are built in code (the "declarative model" is data either way). A
copy of `sparknet_tpu/zoo.py`: both packages build equal specs (tests pin it).
"""
from __future__ import annotations

from typing import Optional, Tuple

from .model.spec import (AccuracyParam, ConvolutionParam, DropoutParam,
                         Filler, InnerProductParam, InputSpec, LayerSpec,
                         LRNParam, NetSpec, ParamSpec, PoolingParam)

_GAUSS = lambda std: Filler(type="gaussian", std=std)
_CONST = lambda v=0.0: Filler(type="constant", value=v)
_LRMULT = (ParamSpec(lr_mult=1.0), ParamSpec(lr_mult=2.0))
# AlexNet convention: bias lr_mult 2, bias decay 0
_LRMULT_WD = (ParamSpec(lr_mult=1.0, decay_mult=1.0),
              ParamSpec(lr_mult=2.0, decay_mult=0.0))


def _conv(name, bottom, n_out, k, *, stride=1, pad=0, group=1, std=0.01,
          bias=0.0, params=_LRMULT):
    return LayerSpec(
        name=name, type="Convolution", bottoms=(bottom,), tops=(name,),
        params=params,
        conv=ConvolutionParam(num_output=n_out, kernel_size=k, stride=stride,
                              pad=pad, group=group, weight_filler=_GAUSS(std),
                              bias_filler=_CONST(bias)))


def _relu(name, blob):
    return LayerSpec(name=name, type="ReLU", bottoms=(blob,), tops=(blob,))


def _pool(name, bottom, mode, k, stride):
    return LayerSpec(name=name, type="Pooling", bottoms=(bottom,), tops=(name,),
                     pool=PoolingParam(pool=mode, kernel_size=k, stride=stride))


def _lrn(name, bottom, *, local_size=5, alpha=1e-4, beta=0.75):
    return LayerSpec(name=name, type="LRN", bottoms=(bottom,), tops=(name,),
                     lrn=LRNParam(local_size=local_size, alpha=alpha, beta=beta))


def _ip(name, bottom, n_out, *, std=0.01, bias=0.0, filler=None,
        params=_LRMULT):
    return LayerSpec(
        name=name, type="InnerProduct", bottoms=(bottom,), tops=(name,),
        params=params,
        inner_product=InnerProductParam(
            num_output=n_out,
            weight_filler=filler or _GAUSS(std),
            bias_filler=_CONST(bias)))


def _dropout(name, blob, ratio=0.5):
    return LayerSpec(name=name, type="Dropout", bottoms=(blob,), tops=(blob,),
                     dropout=DropoutParam(dropout_ratio=ratio))


def _heads(logits_blob, label_blob="label"):
    return (
        LayerSpec(name="prob", type="Softmax", bottoms=(logits_blob,),
                  tops=("prob",)),
        LayerSpec(name="accuracy", type="Accuracy",
                  bottoms=(logits_blob, label_blob), tops=("accuracy",),
                  accuracy=AccuracyParam()),
        LayerSpec(name="loss", type="SoftmaxWithLoss",
                  bottoms=(logits_blob, label_blob), tops=("loss",)),
    )


def cifar10_quick(batch: int = 100) -> NetSpec:
    """3×(conv5x5 pad2 + pool3/2) + 2 FC, CIFAR-10."""
    return NetSpec(
        name="CIFAR10_quick",
        inputs=(InputSpec("data", (batch, 3, 32, 32)),
                InputSpec("label", (batch, 1), "int32")),
        layers=(
            _conv("conv1", "data", 32, 5, pad=2, std=0.0001),
            _pool("pool1", "conv1", "MAX", 3, 2),
            _relu("relu1", "pool1"),
            _conv("conv2", "pool1", 32, 5, pad=2, std=0.01),
            _relu("relu2", "conv2"),
            _pool("pool2", "conv2", "AVE", 3, 2),
            _conv("conv3", "pool2", 64, 5, pad=2, std=0.01),
            _relu("relu3", "conv3"),
            _pool("pool3", "conv3", "AVE", 3, 2),
            _ip("ip1", "pool3", 64, std=0.1),
            _ip("ip2", "ip1", 10, std=0.1),
        ) + _heads("ip2"),
    )


def caffenet(batch: int = 256, crop: int = 227,
             n_classes: int = 1000) -> NetSpec:
    """BVLC reference CaffeNet (AlexNet variant), the flagship model."""
    return NetSpec(
        name="CaffeNet",
        inputs=(InputSpec("data", (batch, 3, crop, crop)),
                InputSpec("label", (batch, 1), "int32")),
        layers=(
            _conv("conv1", "data", 96, 11, stride=4, std=0.01,
                  params=_LRMULT_WD),
            _relu("relu1", "conv1"),
            _pool("pool1", "conv1", "MAX", 3, 2),
            _lrn("norm1", "pool1"),
            _conv("conv2", "norm1", 256, 5, pad=2, group=2, std=0.01, bias=1.0,
                  params=_LRMULT_WD),
            _relu("relu2", "conv2"),
            _pool("pool2", "conv2", "MAX", 3, 2),
            _lrn("norm2", "pool2"),
            _conv("conv3", "norm2", 384, 3, pad=1, std=0.01,
                  params=_LRMULT_WD),
            _relu("relu3", "conv3"),
            _conv("conv4", "conv3", 384, 3, pad=1, group=2, std=0.01, bias=1.0,
                  params=_LRMULT_WD),
            _relu("relu4", "conv4"),
            _conv("conv5", "conv4", 256, 3, pad=1, group=2, std=0.01, bias=1.0,
                  params=_LRMULT_WD),
            _relu("relu5", "conv5"),
            _pool("pool5", "conv5", "MAX", 3, 2),
            _ip("fc6", "pool5", 4096, std=0.005, bias=1.0, params=_LRMULT_WD),
            _relu("relu6", "fc6"),
            _dropout("drop6", "fc6"),
            _ip("fc7", "fc6", 4096, std=0.005, bias=1.0, params=_LRMULT_WD),
            _relu("relu7", "fc7"),
            _dropout("drop7", "fc7"),
            _ip("fc8", "fc7", n_classes, std=0.01, params=_LRMULT_WD),
        ) + _heads("fc8"),
    )


def lenet(batch: int = 64) -> NetSpec:
    """LeNet-style MNIST convnet (conv5x5x32 + conv5x5x64 + fc512 + fc10),
    mirroring the reference's TF mnist graph."""
    return NetSpec(
        name="LeNet",
        inputs=(InputSpec("data", (batch, 1, 28, 28)),
                InputSpec("label", (batch, 1), "int32")),
        layers=(
            _conv("conv1", "data", 32, 5, pad=2, std=0.1),
            _relu("relu1", "conv1"),
            _pool("pool1", "conv1", "MAX", 2, 2),
            _conv("conv2", "pool1", 64, 5, pad=2, std=0.1),
            _relu("relu2", "conv2"),
            _pool("pool2", "conv2", "MAX", 2, 2),
            _ip("fc1", "pool2", 512, std=0.1, bias=0.1),
            _relu("relu3", "fc1"),
            _ip("fc2", "fc1", 10, std=0.1, bias=0.1),
        ) + _heads("fc2"),
    )


def adult_mlp(batch: int = 64, n_features: int = 1) -> NetSpec:
    """Tiny tabular net (test fixture parity: models/adult/adult.prototxt)."""
    return NetSpec(
        name="adult",
        inputs=(InputSpec("C0", (batch, n_features)),),
        layers=(
            _ip("ip", "C0", 10, filler=Filler(type="xavier")),
            LayerSpec(name="prob", type="Softmax", bottoms=("ip",),
                      tops=("prob",)),
        ),
    )
