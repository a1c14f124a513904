"""The LRN CUDA kernels (`csrc/lrn_fwd.cu`, `csrc/lrn_bwd.cu`): ctypes
bindings and wrappers.

`lrn_fwd` replaces the two Pallas TPU forward kernels of
`sparknet_tpu/ops/pallas_lrn.py`: `_fwd_kernel` (line 51, the row kernel,
which the TPU ran for batch sizes N % 128 != 0 and 2-D inputs, and which
also writes the scale its backward reads) and `_fwd_kernel3` (line 206, the
N-minor kernel for N % 128 == 0). `lrn_bwd` replaces their backwards,
`_bwd_kernel` (line 62, from the saved scale) and `_bwd_kernel3` (line 216,
scale recomputed). Each kernel serves both routes on the contiguous
(rows, C) view of an NCHW activation held in channels_last memory.

Both kernels are bound by HBM bytes and take tiles of whole rows, one
contiguous run each, with every thread busy whatever C is. `lrn_fwd` keeps
its data in registers: each thread loads two 16-byte groups of x (8 KB a
tile), takes the window's halo from the neighbouring lanes with warp
shuffles, and stores y (and the scale) with 16-byte stores. `lrn_bwd`
(at most 4 KB of each input a tile) runs a persistent grid that copies
each tile into shared memory with 16-byte `cp.async` copies,
double-buffered so the next tile loads while this one computes, runs both
passes over the tile, and stores dx with 16-byte stores. See the sources.

A wrapper launches its kernel for a CUDA tensor and counts the launch
(`lrn_fwd.launches`, `lrn_bwd.launches`; `lrn_fwd.scale_launches` counts
the launches that also wrote the scale, `lrn_fwd.bf16_launches` those on
bfloat16 tensors); a CPU tensor takes the plain
version (`ops/lrn.py`) and is not counted. Anything a kernel does not
take — another dtype or device, a non-contiguous tensor, an even window,
too many channels, mismatched inputs — raises. There is no fallback from a
CUDA tensor to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from . import _build
from .lrn import lrn_bwd_plain, lrn_plain, lrn_plain_with_scale

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_libs = {}
#: each library's channel limit (`<name>_max_channels()`), read at load
_max_channels = {}


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        fn = getattr(lib, name)
        if name == "lrn_fwd":
            fn.argtypes = [_P, _P, _P, _L, _I, _I, _I, _F, _F, _F, _I, _P]
        else:
            fn.argtypes = [_P, _P, _P, _P, _L, _I, _I, _I, _F, _F, _F, _I,
                           _F, _P]
        fn.restype = ctypes.c_int
        getattr(lib, f"{name}_max_channels").argtypes = []
        getattr(lib, f"{name}_max_channels").restype = ctypes.c_int
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        # a constant of the build: read once, not on every call
        _max_channels[name] = getattr(lib, f"{name}_max_channels")()
        _libs[name] = lib
    return lib


def _launch(device: torch.device, fn, *args) -> int:
    """fn(*args, stream) on `device`'s current stream. The kernels launch
    on the thread's current device, so the device context is entered only
    for a tensor on another card."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def beta_mode(beta: float) -> int:
    """The kernels' scale^-beta specialisation: 1 for 0.75, 2 for 0.5,
    0 (exp/log) otherwise — the same cases as `ops/lrn.py:pow_neg_beta`."""
    if abs(beta - 0.75) < 1e-12:
        return 1
    if abs(beta - 0.5) < 1e-12:
        return 2
    return 0


def _check_window(local_size: int) -> None:
    if local_size < 1 or local_size % 2 == 0:
        raise ValueError(f"LRN local_size must be odd and positive "
                         f"(got {local_size})")


def _check_cuda(name: str, x: torch.Tensor) -> int:
    """The dtype code of x after checking what the kernel takes."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous (..., C) tensor with "
                         f"C innermost, got strides {x.stride()} for shape "
                         f"{tuple(x.shape)}")
    cmax = _max_channels[name]
    if x.shape[-1] > cmax:
        raise ValueError(f"{name} stages at most {cmax} channels per row, "
                         f"got {x.shape[-1]}")
    return code


def _raise_on(name: str, lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")


def lrn_fwd(x: torch.Tensor, local_size: int = 5, alpha: float = 1e-4,
            beta: float = 0.75, k: float = 1.0, with_scale: bool = False
            ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """LRN forward over the last axis of a contiguous channels-last tensor.
    With `with_scale`, returns (y, scale), the scale in x's dtype."""
    _check_window(local_size)
    if x.ndim < 1:
        raise ValueError("LRN needs a tensor with a channel axis")
    if x.device.type == "cpu":
        if with_scale:
            return lrn_plain_with_scale(x, local_size, alpha, beta, k)
        return lrn_plain(x, local_size, alpha, beta, k)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_fwd runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    lib = _library("lrn_fwd")
    code = _check_cuda("lrn_fwd", x)
    y = torch.empty_like(x)
    scale = torch.empty_like(x) if with_scale else None
    if x.numel() == 0:
        return (y, scale) if with_scale else y
    c = x.shape[-1]
    err = _launch(x.device, lib.lrn_fwd, x.data_ptr(), y.data_ptr(),
                  scale.data_ptr() if with_scale else None, x.numel() // c,
                  c, code, (local_size - 1) // 2, alpha / local_size, k,
                  beta, beta_mode(beta))
    _raise_on("lrn_fwd", lib, err)
    lrn_fwd.launches += 1
    if x.dtype == torch.bfloat16:
        lrn_fwd.bf16_launches += 1
    if with_scale:
        lrn_fwd.scale_launches += 1
        return y, scale
    return y


#: kernel launches since the last reset (CPU calls are not launches), and
#: those of them that also wrote the scale (the saved-scale route) and
#: those on bfloat16 tensors
lrn_fwd.launches = 0
lrn_fwd.scale_launches = 0
lrn_fwd.bf16_launches = 0


def lrn_bwd(x: torch.Tensor, dy: torch.Tensor,
            scale: Optional[torch.Tensor] = None, local_size: int = 5,
            alpha: float = 1e-4, beta: float = 0.75, k: float = 1.0
            ) -> torch.Tensor:
    """dx of the LRN over the last axis: from the saved `scale` (the
    forward's, in x's dtype) when given, else with the scale recomputed
    from x. x, dy and scale are contiguous, of one shape and dtype."""
    _check_window(local_size)
    if dy.shape != x.shape or (scale is not None and scale.shape != x.shape):
        raise ValueError(f"lrn_bwd: x {tuple(x.shape)}, dy "
                         f"{tuple(dy.shape)} and scale must share a shape")
    if x.ndim < 1:
        raise ValueError("LRN needs a tensor with a channel axis")
    tensors = [t for t in (x, dy, scale) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return lrn_bwd_plain(x, dy, scale, local_size, alpha, beta, k)
    if any(t.device != x.device for t in tensors) or \
            x.device.type != "cuda":
        raise ValueError(f"lrn_bwd runs on CUDA or CPU tensors, all on one "
                         f"device; got {[str(t.device) for t in tensors]}")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"lrn_bwd: x, dy and scale must share a dtype, got "
                        f"{[t.dtype for t in tensors]}")
    lib = _library("lrn_bwd")
    code = 0
    for t in tensors:
        code = _check_cuda("lrn_bwd", t)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    c = x.shape[-1]
    alpha_n = alpha / local_size
    err = _launch(x.device, lib.lrn_bwd, x.data_ptr(), dy.data_ptr(),
                  scale.data_ptr() if scale is not None else None,
                  dx.data_ptr(), x.numel() // c, c, code,
                  (local_size - 1) // 2, alpha_n, k, beta, beta_mode(beta),
                  2.0 * alpha_n * beta)
    _raise_on("lrn_bwd", lib, err)
    lrn_bwd.launches += 1
    return dx


#: kernel launches since the last reset (CPU calls are not launches)
lrn_bwd.launches = 0
