"""Caffe-semantics spatial pooling on NCHW tensors, forward and backward.

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

MAX pads with -inf and runs `F.max_pool2d` forward. Its gradient is an
autograd Function that saves the unpadded x and y and routes each window's
dy to the window's FIRST element equal to y, in row-major window order,
ties included — Caffe's recorded argmax and XLA's select-and-scatter, the
`won` mask of the Pallas kernel `sparknet_tpu/ops/pallas_pool.py:61`.
Windows are clipped to the real image, so no padded copy is needed.
Routes (`impl`): "auto" — the CUDA kernel (`ops/cuda_pool.py`) for CUDA
tensors, the plain version `maxpool_bwd_plain` for CPU tensors; "plain" —
the plain version everywhere. The port defaults to "auto" where the JAX
package defaults to XLA: its kernel lost 10% end to end on the TPU only
because the custom call broke XLA's fusion, and eager PyTorch has no such
fusion to break. AVE and global pooling take autograd of the plain forward.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMPLS = ("auto", "plain")


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


def _padding(h: int, w: int, kernel: int, stride: int, pad: int):
    """(oh, ow, F.pad widths) so a floor-mode pool emits Caffe's windows."""
    oh = caffe_pool_output_size(h, kernel, stride, pad)
    ow = caffe_pool_output_size(w, kernel, stride, pad)
    end_h = max((oh - 1) * stride + kernel - h - pad, 0)
    end_w = max((ow - 1) * stride + kernel - w - pad, 0)
    return oh, ow, (pad, end_w, pad, end_h)


def pool2d(x: torch.Tensor, mode: str, kernel: int, stride: int,
           pad: int, impl: str = "auto") -> torch.Tensor:
    """Pool an NCHW tensor with Caffe semantics. mode: 'MAX' | 'AVE'.
    impl picks the MAX backward's route (module docstring)."""
    if mode not in ("MAX", "AVE"):
        raise ValueError(f"unknown pool mode {mode!r}")
    if impl not in IMPLS:
        raise ValueError(f"unknown pool impl {impl!r}: expected one of "
                         f"{IMPLS}")
    if mode == "MAX":
        if torch.is_grad_enabled() and x.requires_grad:
            return _MaxPool.apply(x, kernel, stride, pad, impl)
        return _max_forward(x, kernel, stride, pad)
    h, w = x.shape[2], x.shape[3]
    oh, ow, padding = _padding(h, w, kernel, stride, pad)
    # f32 window sums (divisor_override=1 makes avg_pool2d a plain sum)
    xf = x.float()
    if any(padding):
        xf = F.pad(xf, padding)
    s = F.avg_pool2d(xf, kernel, stride, divisor_override=1)
    div = np.outer(_ave_divisor_1d(h, kernel, stride, pad, oh),
                   _ave_divisor_1d(w, kernel, stride, pad, ow))
    return (s / torch.from_numpy(div).to(s.device)).to(x.dtype)


def _max_forward(x: torch.Tensor, kernel: int, stride: int,
                 pad: int) -> torch.Tensor:
    _, _, padding = _padding(x.shape[2], x.shape[3], kernel, stride, pad)
    if any(padding):
        x = F.pad(x, padding, value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride, pad, impl):
        y = _max_forward(x, kernel, stride, pad)
        ctx.geometry = (kernel, stride, pad, impl)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        kernel, stride, pad, impl = ctx.geometry

        def nhwc(t):  # a view, free for the layers' channels_last tensors
            return t.permute(0, 2, 3, 1).contiguous()

        if impl == "plain":
            dx = maxpool_bwd_plain(nhwc(x), nhwc(y), nhwc(dy), kernel,
                                   stride, pad)
        else:
            from .cuda_pool import maxpool_bwd
            dx = maxpool_bwd(nhwc(x), nhwc(y), nhwc(dy), kernel, stride,
                             pad)
        return dx.permute(0, 3, 1, 2), None, None, None, None


def maxpool_bwd_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                      kernel: int, stride: int, pad: int) -> torch.Tensor:
    """dx of a Caffe MAX pool with first-max routing, in plain PyTorch.

    x (N, H, W, C), y and dy (N, OH, OW, C), NHWC. The windows run over x
    padded with NaN (never equal to y, so only real elements win). For each
    window offset (ki, kj) in row-major order, `wins` marks the windows
    whose first element equal to y sits there; dy is then added in f32 at
    the offsets in reverse order, so each element sums its won windows in
    ascending (oh, ow) order — the CUDA kernel's order, bit for bit. dx is
    returned in x's dtype."""
    n, h, w, c = x.shape
    oh, ow = y.shape[1], y.shape[2]
    hp = max(pad + h, (oh - 1) * stride + kernel)
    wp = max(pad + w, (ow - 1) * stride + kernel)
    xp = torch.full((n, hp, wp, c), float("nan"), dtype=x.dtype,
                    device=x.device)
    xp[:, pad:pad + h, pad:pad + w] = x

    def at(t, ki, kj):  # the (oh, ow) grid of window offset (ki, kj)
        return t[:, ki:ki + stride * (oh - 1) + 1:stride,
                 kj:kj + stride * (ow - 1) + 1:stride]

    won = torch.zeros(y.shape, dtype=torch.bool, device=x.device)
    wins = {}
    for ki in range(kernel):
        for kj in range(kernel):
            hit = at(xp, ki, kj) == y
            wins[ki, kj] = hit & ~won
            won |= hit
    dyf = dy.float()
    dxp = torch.zeros((n, hp, wp, c), dtype=torch.float32, device=x.device)
    for ki in reversed(range(kernel)):
        for kj in reversed(range(kernel)):
            at(dxp, ki, kj).add_(torch.where(wins[ki, kj], dyf, 0.0))
    return dxp[:, pad:pad + h, pad:pad + w].to(x.dtype)


def global_pool2d(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "MAX":
        return torch.amax(x, dim=(2, 3), keepdim=True)
    return torch.mean(x, dim=(2, 3), keepdim=True)
