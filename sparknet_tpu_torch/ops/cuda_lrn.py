"""The LRN-forward CUDA kernel (`csrc/lrn_fwd.cu`): ctypes binding and wrapper.

Replaces the two Pallas TPU forward kernels of
`sparknet_tpu/ops/pallas_lrn.py`: `_fwd_kernel` (line 51, the row kernel,
which the TPU ran for batch sizes N % 128 != 0 and 2-D inputs) and
`_fwd_kernel3` (line 206, the N-minor kernel for N % 128 == 0). One Hopper
kernel serves both, on the contiguous (rows, C) view of an NCHW activation
held in channels_last memory. The scale output of `_fwd_kernel`, which only
its backward reads, is left to the training slice.

The kernel is bound by HBM bytes (one read of x, one write of y; ~11 f32
operations per element): one warp stages a row's C channels in shared
memory and computes every clipped window from there. See the source.

`lrn_fwd` launches the kernel for a CUDA tensor and counts the launch in
`lrn_fwd.launches`; a CPU tensor takes the plain version
(`ops/lrn.py:lrn_plain`) and is not counted. Anything the kernel does not
take — another dtype or device, a non-contiguous tensor, an even window,
too many channels — raises. There is no fallback from a CUDA tensor to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .lrn import lrn_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lrn_fwd")
        lib.lrn_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.lrn_fwd.restype = ctypes.c_int
        lib.lrn_fwd_max_channels.argtypes = []
        lib.lrn_fwd_max_channels.restype = ctypes.c_int
        lib.lrn_fwd_error_string.argtypes = [ctypes.c_int]
        lib.lrn_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def beta_mode(beta: float) -> int:
    """The kernel's scale^-beta specialisation: 1 for 0.75, 2 for 0.5,
    0 (exp/log) otherwise — the same cases as `ops/lrn.py:pow_neg_beta`."""
    if abs(beta - 0.75) < 1e-12:
        return 1
    if abs(beta - 0.5) < 1e-12:
        return 2
    return 0


def lrn_fwd(x: torch.Tensor, local_size: int = 5, alpha: float = 1e-4,
            beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """LRN forward over the last axis of a contiguous channels-last tensor."""
    if local_size < 1 or local_size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd and positive "
                         f"(got {local_size})")
    if x.ndim < 1:
        raise ValueError("LRN needs a tensor with a channel axis")
    if x.device.type == "cpu":
        return lrn_plain(x, local_size, alpha, beta, k)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_fwd runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"lrn_fwd takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"lrn_fwd needs a contiguous (..., C) tensor with "
                         f"C innermost, got strides {x.stride()} for shape "
                         f"{tuple(x.shape)}")
    lib = _library()
    c = x.shape[-1]
    if c > lib.lrn_fwd_max_channels():
        raise ValueError(f"lrn_fwd stages at most "
                         f"{lib.lrn_fwd_max_channels()} channels per row, "
                         f"got {c}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.lrn_fwd(x.data_ptr(), y.data_ptr(), x.numel() // c, c,
                          code, (local_size - 1) // 2, alpha / local_size, k,
                          beta, beta_mode(beta), stream)
    if err != 0:
        raise RuntimeError(f"lrn_fwd launch failed: "
                           f"{lib.lrn_fwd_error_string(err).decode()} "
                           f"(cudaError {err})")
    lrn_fwd.launches += 1
    return y


#: kernel launches since the last reset (CPU calls are not launches)
lrn_fwd.launches = 0
