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

The gradient (Caffe's LRNLayer backward, across channels):

    ratio = dy * x * scale^-beta / scale
    dx    = dy * scale^-beta - (2 * alpha/n * beta) * x * window_sum(ratio)

It has two routes, one for each of the JAX package's Pallas paths
(`sparknet_tpu/ops/pallas_lrn.py:lrn_pallas`): a 4-D NHWC input with
N % 128 == 0 and H*W > 1 takes the **recompute** route (`_bwd_kernel3`:
the forward saves x only, the backward recomputes the scale); any other
input takes the **saved-scale** route (`_bwd_kernel`: the forward also
writes the scale, in x's dtype, and the backward reads it). The plain
backwards `lrn_bwd_plain_saved` / `lrn_bwd_plain_recompute` repeat those
kernels' arithmetic in f32 and return dx in x's dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

IMPLS = ("auto", "plain")
#: the N-minor lane width of the JAX package's route rule
NMIN_LANES = 128


def lrn(x: torch.Tensor, local_size: int = 5, *, alpha: float = 1e-4,
        beta: float = 0.75, k: float = 1.0, impl: str = "auto"
        ) -> torch.Tensor:
    """LRN across the last axis of a channels-last tensor.

    impl:
      "auto"  — the CUDA kernels (`cuda_lrn.lrn_fwd` / `lrn_bwd`) for a
                CUDA tensor, the plain versions for a CPU tensor.
      "plain" — the plain versions on any device (the reference the
                kernels are compared with on the card).

    Without autograd (TEST phase, `torch.no_grad`) only y is computed;
    with it, the forward saves what `lrn_route(x)` says its backward reads.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown LRN impl {impl!r}: expected one of "
                         f"{IMPLS}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _LRN.apply(x, local_size, alpha, beta, k, impl)
    return _forward(x, local_size, alpha, beta, k, impl, False)[0]


def lrn_route(x: torch.Tensor) -> str:
    """"recompute" where the JAX package takes the N-minor kernel (4-D,
    N % 128 == 0, H*W > 1), "saved" (the row kernel's saved scale)
    everywhere else."""
    if x.ndim == 4 and x.shape[0] % NMIN_LANES == 0 and \
            x.shape[1] * x.shape[2] > 1:
        return "recompute"
    return "saved"


def _forward(x, local_size, alpha, beta, k, impl, want_scale):
    if impl == "plain":
        if want_scale:
            return lrn_plain_with_scale(x, local_size, alpha, beta, k)
        return lrn_plain(x, local_size, alpha, beta, k), None
    from .cuda_lrn import lrn_fwd
    if want_scale:
        return lrn_fwd(x, local_size, alpha, beta, k, with_scale=True)
    return lrn_fwd(x, local_size, alpha, beta, k), None


class _LRN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, local_size, alpha, beta, k, impl):
        route = lrn_route(x)
        y, scale = _forward(x, local_size, alpha, beta, k, impl,
                            route == "saved")
        ctx.params = (local_size, alpha, beta, k, impl)
        ctx.save_for_backward(x, scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        local_size, alpha, beta, k, impl = ctx.params
        # autograd hands dy in y's dtype; its layout is the downstream
        # op's, so make it the (rows, C) layout x has (free when it is)
        dy = dy.contiguous()
        if impl == "plain":
            dx = lrn_bwd_plain(x, dy, scale, local_size, alpha, beta, k)
        else:
            from .cuda_lrn import lrn_bwd
            dx = lrn_bwd(x, dy, scale, local_size, alpha, beta, k)
        return dx, None, None, None, None, None


def window_sum(v: torch.Tensor, half: int) -> torch.Tensor:
    """Windowed sum over the last axis with zero edge padding (Caffe clips
    the window at the channel edges): the centre, then the +j and -j
    shifts for j = 1..half, in that order — the order of
    `sparknet_tpu/ops/lrn.py:window_sum` and of the CUDA kernels."""
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


def _scale_f32(xf: torch.Tensor, local_size: int, alpha: float,
               k: float) -> torch.Tensor:
    """The f32 normalizer k + alpha/n * window_sum(x^2)."""
    return k + (alpha / local_size) * window_sum(xf * xf,
                                                 (local_size - 1) // 2)


def lrn_plain(x: torch.Tensor, local_size: int = 5, alpha: float = 1e-4,
              beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """The fused LRN formula: f32 normalizer, output in x's dtype."""
    xf = x.float()
    scale = _scale_f32(xf, local_size, alpha, k)
    return (xf * pow_neg_beta(scale, beta)).to(x.dtype)


def lrn_plain_with_scale(x: torch.Tensor, local_size: int = 5,
                         alpha: float = 1e-4, beta: float = 0.75,
                         k: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, scale) as the Pallas row kernel `_fwd_kernel` writes them: y as
    `lrn_plain` computes it, and the f32 scale rounded to x's dtype."""
    xf = x.float()
    scale = _scale_f32(xf, local_size, alpha, k)
    return ((xf * pow_neg_beta(scale, beta)).to(x.dtype),
            scale.to(x.dtype))


def lrn_bwd_plain_saved(x: torch.Tensor, scale: torch.Tensor,
                        dy: torch.Tensor, local_size: int = 5,
                        alpha: float = 1e-4, beta: float = 0.75
                        ) -> torch.Tensor:
    """dx from the saved scale: the arithmetic of `pallas_lrn.py:62`
    `_bwd_kernel`, in f32, dx in x's dtype."""
    xf, s, dyf = x.float(), scale.float(), dy.float()
    inv_beta = pow_neg_beta(s, beta)
    ratio = dyf * xf * inv_beta / s
    acc = window_sum(ratio, (local_size - 1) // 2)
    coef = 2.0 * (alpha / local_size) * beta
    return (dyf * inv_beta - (coef * xf) * acc).to(x.dtype)


def lrn_bwd_plain_recompute(x: torch.Tensor, dy: torch.Tensor,
                            local_size: int = 5, alpha: float = 1e-4,
                            beta: float = 0.75, k: float = 1.0
                            ) -> torch.Tensor:
    """dx with the scale recomputed from x: the arithmetic of
    `pallas_lrn.py:216` `_bwd_kernel3` (`/scale` as rsqrt(scale)^2), in
    f32, dx in x's dtype."""
    xf, dyf = x.float(), dy.float()
    s = _scale_f32(xf, local_size, alpha, k)
    inv_beta = pow_neg_beta(s, beta)
    inv_scale = torch.rsqrt(s)
    ratio = dyf * xf * inv_beta * (inv_scale * inv_scale)
    acc = window_sum(ratio, (local_size - 1) // 2)
    coef = 2.0 * (alpha / local_size) * beta
    return (dyf * inv_beta - (coef * xf) * acc).to(x.dtype)


def lrn_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                  scale: Optional[torch.Tensor], local_size: int = 5,
                  alpha: float = 1e-4, beta: float = 0.75, k: float = 1.0
                  ) -> torch.Tensor:
    """The plain backward of either route: saved scale when given, else
    recomputed — the counterpart of `cuda_lrn.lrn_bwd`."""
    if scale is not None:
        return lrn_bwd_plain_saved(x, scale, dy, local_size, alpha, beta)
    return lrn_bwd_plain_recompute(x, dy, local_size, alpha, beta, k)
