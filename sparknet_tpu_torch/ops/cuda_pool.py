"""The MAX-pool backward CUDA kernel (`csrc/maxpool_bwd.cu`): ctypes binding,
tile plan and wrapper.

Replaces the Pallas TPU kernel `sparknet_tpu/ops/pallas_pool.py:61`
`_bwd_kernel`: each window's dy goes to the window's first element equal
to its max (row-major window order, ties included), over NHWC memory with
windows clipped to the real image, so any kernel, stride and pad and
Caffe's ceil-mode end windows take it. It is bound by HBM bytes (x, y and
dy read once, dx written once). A block owns a tile of dx (`plan`: rows,
columns, channels of one image) and stages the x its windows read, and
their y and dy, in shared memory; it finds each window's first max once
(a 1- or 2-byte offset per window and channel in shared memory), then
writes each dx element once with the dy of the windows it wins, summed in
ascending (oh, ow) order. Loads and stores are 16 bytes wide where the
channel count and the pointers allow it. No atomics. See the source.

`maxpool_bwd` launches the kernel for CUDA tensors and counts the launch
in `maxpool_bwd.launches`; CPU tensors take the plain version
(`ops/pooling.py:maxpool_bwd_plain`) and are not counted. Anything the
kernel does not take — another dtype or device, a non-contiguous tensor,
shapes that do not match the pooling geometry — raises. There is no
fallback from a CUDA tensor to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .pooling import caffe_pool_output_size, maxpool_bwd_plain

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
#: a block's shared memory: preferred (three blocks fit on an SM), and the
#: most one block can have
SMEM_PREFERRED = 64 * 1024
SMEM_MAX = 227 * 1024


class Plan(NamedTuple):
    """A launch's tile: dx rows `hb`, columns `wb` and channels `cb` of one
    image per block; `vec`: 16-byte accesses (else one element per
    thread); `staged`: x, y, dy and the window offsets live in shared
    memory (else each element searches its covering windows again in
    device memory); `smem`: the block's shared bytes."""
    hb: int
    wb: int
    cb: int
    vec: bool
    staged: bool
    smem: int


def _extent(tile: int, n_in: int, n_out: int, kernel: int, stride: int):
    """(windows touching `tile` consecutive rows at most, the input rows
    they read) — the kernel's `extent`."""
    nwin = min(n_out, (tile + kernel - 2) // stride + 1)
    return nwin, min(n_in, (nwin - 1) * stride + kernel)


def smem_bytes(h: int, w: int, oh: int, ow: int, kernel: int, stride: int,
               itemsize: int, hb: int, wb: int, cb: int,
               staged: bool) -> int:
    """Shared bytes of one block (`smem_bytes` in the source, which
    refuses a launch above `SMEM_MAX`): the covering-window tables; when
    staged, also the x region, the windows' y and dy, and one offset per
    (window, channel)."""
    def up16(b):
        return (b + 15) // 16 * 16
    nbytes = up16(8 * (hb + wb))
    if not staged:
        return nbytes
    nwr, xr = _extent(hb, h, oh, kernel, stride)
    nwc, xc = _extent(wb, w, ow, kernel, stride)
    windows = nwr * nwc * cb
    nbytes += up16(xr * xc * cb * itemsize) + 2 * up16(windows * itemsize)
    return nbytes + windows * (2 if kernel * kernel >= 255 else 1)


@functools.lru_cache(maxsize=256)
def plan(h: int, w: int, c: int, oh: int, ow: int, kernel: int,
         stride: int, itemsize: int, aligned: bool = True) -> Plan:
    """The tile a launch takes. Channels go in 16-byte vectors when `c`
    and the pointers allow it (`aligned`), one element per thread
    otherwise; a block takes a power-of-two number (at most 32) of them
    that divides the channel count, at most 128 bytes. A staged tile is
    preferred, and among those, in order: a block within `SMEM_PREFERRED`
    bytes, then within `SMEM_MAX`; at least 64 bytes of channels (two
    sectors); strips of 16, 8, 4, 2 or 1 rows; the full width, then halves
    of it; more channels. A geometry that no staged tile fits rescans: at
    stride 1, windows wider than 94 in f32 or 129 in bf16, and any
    window wider than 255 (its offsets would not fit 2 bytes)."""
    vw = 16 // itemsize
    vec = aligned and c % vw == 0
    v = vw if vec else 1
    nvec = c // v
    lanes = 1
    while lanes < 32 and nvec % (2 * lanes) == 0 and \
            2 * lanes * v * itemsize <= 128:
        lanes *= 2
    lane_opts = [lanes >> i for i in range(lanes.bit_length())]
    heights = sorted({min(t, h) for t in (16, 8, 4, 2, 1)}, reverse=True)
    widths = []
    t = w
    while t not in widths:
        widths.append(t)
        t = max(1, (t + 1) // 2)
    budgets = (SMEM_PREFERRED, SMEM_MAX) if kernel <= 255 else ()
    for budget in budgets:
        for min_bytes in (min(64, c * itemsize), 1):
            for hb in heights:
                for wb in widths:
                    for ln in lane_opts:
                        cb = ln * v
                        if cb * itemsize < min_bytes:
                            break
                        smem = smem_bytes(h, w, oh, ow, kernel, stride,
                                          itemsize, hb, wb, cb, True)
                        if smem <= budget:
                            return Plan(hb, wb, cb, vec, True, smem)
    hb, wb = heights[0], min(w, 64)
    return Plan(hb, wb, lanes * v, vec, False,
                smem_bytes(h, w, oh, ow, kernel, stride, itemsize, hb, wb,
                           lanes * v, False))


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("maxpool_bwd")
        lib.maxpool_bwd.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 15 + [ctypes.c_void_p]
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, y, dy, dx))
    p = plan(h, w, c, want[1], want[2], kernel, stride, x.element_size(),
             aligned)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.maxpool_bwd(x.data_ptr(), y.data_ptr(), dy.data_ptr(),
                              dx.data_ptr(), n, h, w, c, want[1], want[2],
                              kernel, stride, pad, code, p.hb, p.wb, p.cb,
                              int(p.vec), int(p.staged), stream)
    if err != 0:
        raise RuntimeError(f"maxpool_bwd launch failed: "
                           f"{lib.maxpool_bwd_error_string(err).decode()} "
                           f"(cudaError {err})")
    maxpool_bwd.launches += 1
    return dx


#: kernel launches since the last reset (CPU calls are not launches)
maxpool_bwd.launches = 0
