"""Local Response Normalization (across channels), Caffe semantics.

    out[c] = x[c] / (k + (alpha / n) * sum_{c' in window(c, n)} x[c']^2) ^ beta

window(c, n) = channels [c - (n-1)/2, c + (n-1)/2] clipped to [0, C).

Tensors here are channels-last views, (..., C) with C innermost: the
layers hand over `x.permute(0, 2, 3, 1)` of an NCHW activation held in
channels_last memory, which is a contiguous (rows, C) array.

`lrn_plain` is the fused formula in plain PyTorch, the counterpart of
`sparknet_tpu/ops/lrn.py:_lrn_fused` with the Pallas kernel's `scale^-beta`
specialisations (`sparknet_tpu/ops/pallas_lrn.py:_pow_neg_beta`). It is the
CPU path and the reference the CUDA kernel (`ops/cuda_lrn.py`) is held to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

IMPLS = ("auto", "plain")


def lrn(x: torch.Tensor, local_size: int = 5, *, alpha: float = 1e-4,
        beta: float = 0.75, k: float = 1.0, impl: str = "auto"
        ) -> torch.Tensor:
    """LRN across the last axis of a channels-last tensor.

    impl:
      "auto"  — `cuda_lrn.lrn_fwd`: the CUDA kernel for a CUDA tensor, the
                plain version for a CPU tensor.
      "plain" — the plain version on any device (the reference the kernel
                is compared with on the card).
    """
    if impl == "plain":
        return lrn_plain(x, local_size, alpha, beta, k)
    if impl != "auto":
        raise ValueError(f"unknown LRN impl {impl!r}: expected one of "
                         f"{IMPLS}")
    from .cuda_lrn import lrn_fwd
    return lrn_fwd(x, local_size, alpha, beta, k)


def window_sum(v: torch.Tensor, half: int) -> torch.Tensor:
    """Windowed sum over the last axis with zero edge padding (Caffe clips
    the window at the channel edges): the centre, then the +j and -j
    shifts for j = 1..half, in that order — the order of
    `sparknet_tpu/ops/lrn.py:window_sum` and of the CUDA kernel."""
    c = v.shape[-1]
    acc = v
    for j in range(1, min(half, c - 1) + 1):
        acc = acc + F.pad(v[..., j:], (0, j))
        acc = acc + F.pad(v[..., :c - j], (j, 0))
    return acc


def pow_neg_beta(scale: torch.Tensor, beta: float) -> torch.Tensor:
    """scale^-beta; beta = 0.75 (every reference net) and 0.5 specialise
    to rsqrt/sqrt as the Pallas kernel does, anything else is
    exp(-beta * log(scale)) (scale >= k > 0)."""
    if abs(beta - 0.75) < 1e-12:
        r = torch.rsqrt(scale)
        return r * torch.sqrt(r)
    if abs(beta - 0.5) < 1e-12:
        return torch.rsqrt(scale)
    return torch.exp(-beta * torch.log(scale))


def lrn_plain(x: torch.Tensor, local_size: int = 5, alpha: float = 1e-4,
              beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """The fused LRN formula: f32 normalizer, output in x's dtype."""
    half = (local_size - 1) // 2
    xf = x.float()
    scale = k + (alpha / local_size) * window_sum(xf * xf, half)
    return (xf * pow_neg_beta(scale, beta)).to(x.dtype)
