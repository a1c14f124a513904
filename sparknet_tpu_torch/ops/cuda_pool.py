"""The MAX-pool backward CUDA kernel (`csrc/maxpool_bwd.cu`): ctypes binding
and wrapper.

Replaces the Pallas TPU kernel `sparknet_tpu/ops/pallas_pool.py:61`
`_bwd_kernel`: each window's dy goes to the window's first element equal
to its max (row-major window order, ties included). The kernel is a
gather — one thread per element of dx, no atomics — over NHWC memory, with
windows clipped to the real image, so any kernel, stride and pad and
Caffe's ceil-mode end windows take it. It is bound by HBM bytes (x, y and
dy read once, dx written once). See the source.

`maxpool_bwd` launches the kernel for CUDA tensors and counts the launch
in `maxpool_bwd.launches`; CPU tensors take the plain version
(`ops/pooling.py:maxpool_bwd_plain`) and are not counted. Anything the
kernel does not take — another dtype or device, a non-contiguous tensor,
shapes that do not match the pooling geometry — raises. There is no
fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .pooling import caffe_pool_output_size, maxpool_bwd_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("maxpool_bwd")
        lib.maxpool_bwd.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.maxpool_bwd.restype = ctypes.c_int
        lib.maxpool_bwd_error_string.argtypes = [ctypes.c_int]
        lib.maxpool_bwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def maxpool_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                kernel: int, stride: int, pad: int) -> torch.Tensor:
    """dx of a Caffe MAX pool. x (N, H, W, C), y and dy (N, OH, OW, C),
    contiguous NHWC; returns dx (N, H, W, C) in x's dtype."""
    if x.ndim != 4 or y.ndim != 4 or dy.shape != y.shape:
        raise ValueError(f"maxpool_bwd needs NHWC x and y/dy of one shape, "
                         f"got {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(dy.shape)}")
    n, h, w, c = x.shape
    want = (n, caffe_pool_output_size(h, kernel, stride, pad),
            caffe_pool_output_size(w, kernel, stride, pad), c)
    if tuple(y.shape) != want:
        raise ValueError(f"maxpool_bwd: y {tuple(y.shape)} is not the "
                         f"pool of x {tuple(x.shape)} with kernel {kernel}, "
                         f"stride {stride}, pad {pad} ({want})")
    if not 0 <= pad < kernel or stride < 1:
        raise ValueError(f"maxpool_bwd needs 0 <= pad < kernel and stride "
                         f">= 1 (kernel {kernel}, stride {stride}, pad "
                         f"{pad})")
    tensors = (x, y, dy)
    if all(t.device.type == "cpu" for t in tensors):
        return maxpool_bwd_plain(x, y, dy, kernel, stride, pad)
    if any(t.device != x.device for t in tensors) or \
            x.device.type != "cuda":
        raise ValueError(f"maxpool_bwd runs on CUDA or CPU tensors, all on "
                         f"one device; got {[str(t.device) for t in tensors]}")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None or any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"maxpool_bwd takes float32 or bfloat16 x, y and dy "
                        f"of one dtype, got {[t.dtype for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"maxpool_bwd needs contiguous NHWC tensors, "
                             f"got strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"maxpool_bwd indexes with 32-bit integers: "
                         f"{x.numel()} elements is too many")
    lib = _library()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.maxpool_bwd(x.data_ptr(), y.data_ptr(), dy.data_ptr(),
                              dx.data_ptr(), n, h, w, c, want[1], want[2],
                              kernel, stride, pad, code, stream)
    if err != 0:
        raise RuntimeError(f"maxpool_bwd launch failed: "
                           f"{lib.maxpool_bwd_error_string(err).decode()} "
                           f"(cudaError {err})")
    maxpool_bwd.launches += 1
    return dx


#: kernel launches since the last reset (CPU calls are not launches)
maxpool_bwd.launches = 0
