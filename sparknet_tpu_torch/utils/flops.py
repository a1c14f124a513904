"""Analytic FLOP counting for MFU reporting.

The counterpart of `sparknet_tpu/utils/flops.py`, rewritten on the port's
`CompiledNet` (the JAX module imports its net, and with it jax). It counts
the matrix work — convolutions and inner products, where essentially all
of a convnet's FLOPs live — from the compiled net's NHWC blob shapes.
Elementwise layers (ReLU, LRN, pooling, softmax) are under 1% of
CaffeNet's FLOPs and are left out, so an MFU from these counts is
slightly conservative.

`peak_bf16_flops` keeps the JAX module's TPU rows and adds NVIDIA's
datasheet numbers for the H100's dense bf16 peak, matched on
`torch.cuda.get_device_name()`.
"""
from __future__ import annotations

import numpy as np

from ..model.net import CompiledNet

#: peak dense bf16 TFLOP/s by device-name substring (public specs), the
#: first match wins: the H100 (NVIDIA's datasheet: 989.4 for the SXM5
#: part, 756 for PCIe), then the JAX module's TPU rows
PEAK_BF16_TFLOPS = (
    ("h100 pcie", 756.0),
    ("h100 80gb hbm3", 989.4),   # SXM5
    ("h100 sxm", 989.4),
    ("v6", 918.0),   # Trillium
    ("v5p", 459.0),
    ("v5", 197.0),   # v5e / "TPU v5 lite"
    ("v4", 275.0),
    ("v3", 123.0),
    ("v2", 46.0),
)

#: fwd+bwd FLOPs as a multiple of forward FLOPs: backward computes both the
#: data gradient and the weight gradient, each a conv/matmul of forward cost.
TRAIN_FWD_MULT = 3.0


def forward_flops_per_image(net: CompiledNet) -> float:
    """Conv + inner-product forward FLOPs for ONE example (2·MACs)."""
    total = 0.0
    for layer in net.spec.layers:
        if layer.type == "Convolution":
            n, h, w, c_out = net.blob_shapes[layer.tops[0]]
            c_in = net.blob_shapes[layer.bottoms[0]][-1]
            k, g = layer.conv.kernel_size, layer.conv.group
            total += 2.0 * h * w * k * k * (c_in // g) * c_out
        elif layer.type == "InnerProduct":
            out_f = net.blob_shapes[layer.tops[0]][-1]
            in_f = int(np.prod(net.blob_shapes[layer.bottoms[0]][1:]))
            total += 2.0 * in_f * out_f
    return total


def train_flops_per_image(net: CompiledNet) -> float:
    return TRAIN_FWD_MULT * forward_flops_per_image(net)


def peak_bf16_flops(device_kind: str) -> float:
    """Peak dense bf16 FLOP/s for a device name (a TPU `device_kind` such
    as 'TPU v5 lite', or `torch.cuda.get_device_name()` such as 'NVIDIA
    H100 80GB HBM3'); 0.0 when unknown (callers then omit MFU rather than
    make one up)."""
    kind = device_kind.lower()
    for key, tflops in PEAK_BF16_TFLOPS:
        if key in kind:
            return tflops * 1e12
    return 0.0
