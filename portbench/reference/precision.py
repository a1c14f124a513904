"""Operand precisions of the plain reference.

  "float32"   float32 operands and products, TF32 off;
  "tf32"      float32 whose product operands, forward and backward, are
              rounded to TF32's 10 mantissa bits: the control of a
              float32 configuration.

`operand(x, mode)` rounds a product's input (its backward passes the
gradient through); `output(y, mode)` leaves the forward alone and rounds
the gradient that reaches the product in the backward.
"""
from __future__ import annotations

import torch

MODES = ("float32", "tf32")
#: the control of each configuration precision: a precision below it
CONTROL = {"float32": "tf32"}


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (ties to even), as float32."""
    i = t.float().contiguous().view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32).view(t.shape)


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    """A product's operand in `mode`'s precision, as float32."""
    x = x.float()
    return _Operand.apply(x) if mode == "tf32" else x


def output(y: torch.Tensor, mode: str) -> torch.Tensor:
    """A product's result; under the control the gradient arriving at it
    is rounded first."""
    return _Output.apply(y) if mode == "tf32" else y


class exact_float32:
    """Context: float32 products stay float32 (TF32 off) on the card."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False
