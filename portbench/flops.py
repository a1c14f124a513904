"""The yardstick's arithmetic: training FLOPs per sample, the card's peaks,
and the bytes and operations a kernel's work needs.

A sample is what `local_batch` counts in the traffic: one image, or, for
a configuration of sequences of one fixed length L, one sequence (then
tokens = L x samples). The metrics keep the names they were given for
images (`train_img_per_s`, `ctx.images`).

FLOPs: each configuration backend counts its forward for one sample,
`forward_flops_per_sample` of reference/<backend>.py, read from the
configuration's layer list. The `caffe` and `graph` counts are a frozen
copy of `sparknet_tpu_torch/utils/flops.py`'s rule: every convolution
2·OH·OW·k²·(Cin/group)·Cout, every inner product or MatMul 2·in·out,
forward. Training is three times the forward (the backward's data and
weight gradients are each a product of the forward's size). Elementwise
layers are left out, so a share of the peak from these counts is slightly
low.

Peaks: NVIDIA's H100 datasheet, dense (SXM: 989.4 TFLOP/s bf16, 3.35 TB/s
HBM3; PCIe: 756 TFLOP/s, 2.0 TB/s) and 67 TFLOP/s in float32 outside
the tensor cores (SXM), matched on `torch.cuda.get_device_name()`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from . import load

TRAIN_FWD_MULT = 3.0

#: (name substring, bf16 TFLOP/s, HBM TB/s, f32 TFLOP/s); first match wins
PEAKS = (
    ("h100 pcie", 756.0, 2.0, 51.2),
    ("h100 80gb hbm3", 989.4, 3.35, 67.0),
    ("h100 sxm", 989.4, 3.35, 67.0),
)


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """{"bf16_flops", "hbm_bytes", "f32_flops"} per second, or None."""
    kind = device_name.lower()
    for key, bf16, hbm, f32 in PEAKS:
        if key in kind:
            return {"bf16_flops": bf16 * 1e12, "hbm_bytes": hbm * 1e12,
                    "f32_flops": f32 * 1e12}
    return None


def forward_flops_per_image(config: dict) -> float:
    """The forward's FLOPs for one sample (module docstring)."""
    return load.reference(config).forward_flops_per_sample(config)


def train_flops_per_image(config: dict) -> float:
    """Training FLOPs for one sample: three times the forward's."""
    return TRAIN_FWD_MULT * forward_flops_per_image(config)


def window_terms(c: int, local_size: int):
    half = (local_size - 1) // 2
    return [min(ch + half, c - 1) - max(ch - half, 0) + 1 for ch in range(c)]


def lrn_work(shape, itemsize: int, local_size: int) -> Dict[str, float]:
    """One LRN layer's forward and backward at an NHWC `shape`: bytes (the
    forward reads x and writes y; the backward reads x and dy and writes
    dx) and f32 operations (chip_smoke's counts: forward 2 per window
    term + 5 an element; backward with the scale recomputed)."""
    rows = math.prod(shape[:-1])
    c = shape[-1]
    terms = window_terms(c, local_size)
    fwd_ops = rows * sum(2 * t + 5 for t in terms)
    bwd_ops = rows * sum((2 * t - 1) + 2 + 3 + 5 + (t - 1) + 4
                         for t in terms)
    n = rows * c
    return {"fwd_bytes": 2 * n * itemsize, "bwd_bytes": 3 * n * itemsize,
            "fwd_ops": fwd_ops, "bwd_ops": bwd_ops}


def maxpool_bwd_work(x_shape, y_shape, kernel: int,
                     itemsize: int) -> Dict[str, float]:
    """A MAX pool's backward: reads x, y and dy once, writes dx once;
    operations: each window's first-max search over k*k and one add."""
    nx, ny = math.prod(x_shape), math.prod(y_shape)
    return {"bytes": 2 * (nx + ny) * itemsize,
            "ops": ny * (kernel * kernel + 1)}


def bound_ms(nbytes: float, ops: float, pk: Dict[str, float]) -> float:
    """The least time: the larger of bytes over HBM bandwidth and f32
    operations over the f32 peak, ms."""
    return max(nbytes / pk["hbm_bytes"], ops / pk["f32_flops"]) * 1e3
