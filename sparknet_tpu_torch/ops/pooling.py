"""Caffe-semantics spatial pooling (forward) on NCHW tensors.

The counterpart of `sparknet_tpu/ops/pooling.py`. Caffe's PoolingLayer
differs from framework defaults in two ways this module reproduces by
padding explicitly (torch's `ceil_mode` / `count_include_pad` are not
used, so their rules cannot drift from Caffe's):

1. **Ceil-mode output size**: out = ceil((H + 2*pad - k) / stride) + 1, then
   if pad > 0 and the last window would start past H + pad, drop it. The
   input is padded by `pad` in front and by whatever the last window needs
   at the end, and an ordinary floor-mode pool runs over that.
2. **AVE divisor includes padding**: the divisor is the window area clipped
   to the *padded* extent [0 - pad, H + pad), not to the real image. The
   window sums are divided by a divisor map built with numpy.

MAX pads with -inf. Only the forward exists: MAX-pool backward (the Pallas
kernel `sparknet_tpu/ops/pallas_pool.py:_bwd_kernel`) belongs to training.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def caffe_pool_output_size(size: int, kernel: int, stride: int,
                           pad: int) -> int:
    out = int(np.ceil((size + 2 * pad - kernel) / stride)) + 1
    if pad > 0 and (out - 1) * stride >= size + pad:
        out -= 1
    return out


def _ave_divisor_1d(size: int, kernel: int, stride: int, pad: int,
                    out: int) -> np.ndarray:
    starts = np.arange(out) * stride - pad
    ends = np.minimum(starts + kernel, size + pad)
    return (ends - starts).astype(np.float32)


def pool2d(x: torch.Tensor, mode: str, kernel: int, stride: int,
           pad: int) -> torch.Tensor:
    """Pool an NCHW tensor with Caffe semantics. mode: 'MAX' | 'AVE'."""
    if mode not in ("MAX", "AVE"):
        raise ValueError(f"unknown pool mode {mode!r}")
    h, w = x.shape[2], x.shape[3]
    oh = caffe_pool_output_size(h, kernel, stride, pad)
    ow = caffe_pool_output_size(w, kernel, stride, pad)
    end_h = max((oh - 1) * stride + kernel - h - pad, 0)
    end_w = max((ow - 1) * stride + kernel - w - pad, 0)
    padding = (pad, end_w, pad, end_h)
    if mode == "MAX":
        if any(padding):
            x = F.pad(x, padding, value=float("-inf"))
        return F.max_pool2d(x, kernel, stride)
    # f32 window sums (divisor_override=1 makes avg_pool2d a plain sum)
    xf = x.float()
    if any(padding):
        xf = F.pad(xf, padding)
    s = F.avg_pool2d(xf, kernel, stride, divisor_override=1)
    div = np.outer(_ave_divisor_1d(h, kernel, stride, pad, oh),
                   _ave_divisor_1d(w, kernel, stride, pad, ow))
    return (s / torch.from_numpy(div).to(s.device)).to(x.dtype)


def global_pool2d(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "MAX":
        return torch.amax(x, dim=(2, 3), keepdim=True)
    return torch.mean(x, dim=(2, 3), keepdim=True)
