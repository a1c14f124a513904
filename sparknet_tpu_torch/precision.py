"""Numeric policy: compute dtype for convolutions and matrix products.

Two modes, as in `sparknet_tpu/precision.py`:
  - "float32" (default): f32 operands in full f32 — the counterpart of the
    JAX package's `Precision.HIGHEST`. PyTorch runs f32 convolutions
    through cuDNN in TF32 unless told otherwise, so every forward under
    this policy turns BOTH `torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` off (`apply_backend_flags`).
  - "bfloat16": operands cast to bf16, outputs left in bf16 (the card's
    tensor cores accumulate in f32 inside the product).

The mode is thread-local (set_policy / policy(...)); the backend flags are
process-wide, so they are re-applied at the start of every f32 forward.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()

#: torch dtypes by the names specs and configs use
DTYPES = {"float32": torch.float32, "int32": torch.int32,
          "bfloat16": torch.bfloat16}


def _get() -> str:
    return getattr(_state, "mode", "float32")


def set_policy(mode: str) -> None:
    if mode not in ("float32", "bfloat16"):
        raise ValueError(f"unknown precision policy {mode!r}: expected "
                         f"'float32' or 'bfloat16'")
    _state.mode = mode
    apply_backend_flags()


@contextlib.contextmanager
def policy(mode: str):
    prev = _get()
    set_policy(mode)
    try:
        yield
    finally:
        set_policy(prev)


def compute_dtype() -> torch.dtype:
    return torch.bfloat16 if _get() == "bfloat16" else torch.float32


def apply_backend_flags() -> None:
    """Under "float32", forbid TF32 in matmuls and cuDNN convolutions."""
    if _get() == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def cast_in(x: torch.Tensor) -> torch.Tensor:
    """Cast a floating operand to the compute dtype (others untouched)."""
    dt = compute_dtype()
    if x.dtype in (torch.float32, torch.bfloat16) and x.dtype != dt:
        return x.to(dt)
    return x
