"""The port's LRN (ops/lrn.py, ops/cuda_lrn.py) against the JAX package.

Same numpy inputs, made from a seed, go through the JAX LRN paths — the
reduce_window form `_lrn_xla`, the fused form `_lrn_fused`, the Pallas row
kernel under the interpreter (`lrn_pallas(..., interpret=True)`) and the
N-minor Pallas kernel under the interpreter (`_lrn_nmin`) — and through the
port's plain version. Tolerances:
  - float32: rtol 1e-5, atol 1e-6 (the JAX package's own LRN tolerance;
    the forms differ only in how scale^-beta is evaluated);
  - bfloat16: one bf16 ulp of the reference (both sides do f32 math on
    the same bf16 input and round once at the end). `_lrn_xla` rounds its
    normalizer to bf16 mid-way, so it is compared in float32 only.
The kernel itself runs only on a card: the `gpu` cases hold its y and
scale to the plain version's there bit for bit, and skip elsewhere.
"""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparknet_tpu.ops.lrn import _lrn_fused, _lrn_xla
from sparknet_tpu.ops.lrn import window_sum as jax_window_sum
from sparknet_tpu.ops.pallas_lrn import _lrn_nmin, lrn_pallas

from sparknet_tpu_torch.ops import cuda_lrn
from sparknet_tpu_torch.ops.lrn import (lrn, lrn_plain,
                                        lrn_plain_with_scale, window_sum)

torch.set_num_threads(2)

ALPHA, K, N = 1e-4, 1.0, 5
BETAS = (0.75, 0.5, 0.6)
ROW_SHAPES = ((2, 7, 7, 96), (300, 256))
JAX_REFS = {
    "xla": lambda x, b: _lrn_xla(x, N, alpha=ALPHA, beta=b, k=K),
    "fused": lambda x, b: _lrn_fused(x, N, ALPHA, b, K),
    "pallas": lambda x, b: lrn_pallas(x, N, ALPHA, b, K, interpret=True),
}


def _inputs(shape, seed=0):
    # x50: the normalizer then moves well away from k (CaffeNet's pooled
    # activations are of this order), so beta matters
    return (50.0 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    _, e = np.frexp(ref.astype(np.float32))
    return np.where(ref == 0, 0.0, np.ldexp(1.0, e - 8))


def _compare(x: np.ndarray, dtype: str, jax_fn, beta: float) -> None:
    if dtype == "float32":
        want = np.asarray(jax_fn(jnp.asarray(x), beta))
        got = lrn_plain(torch.from_numpy(x), N, ALPHA, beta, K).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        return
    want = np.asarray(jax_fn(jnp.asarray(x).astype(jnp.bfloat16), beta)
                      ).astype(np.float32)
    got = lrn_plain(torch.from_numpy(x).to(torch.bfloat16), N, ALPHA, beta,
                    K).float().numpy()
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))


# _lrn_xla rounds its normalizer to bf16 mid-way: float32 only
ROW_CASES = [(ref, shape, beta, dtype)
             for ref in sorted(JAX_REFS) for shape in ROW_SHAPES
             for beta in BETAS for dtype in ("float32", "bfloat16")
             if not (ref == "xla" and dtype == "bfloat16")]


@pytest.mark.parametrize("ref,shape,beta,dtype", ROW_CASES)
def test_plain_lrn_matches_jax_row_paths(ref, shape, beta, dtype):
    _compare(_inputs(shape), dtype, JAX_REFS[ref], beta)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("beta", BETAS)
def test_plain_lrn_matches_jax_nmin_kernel(beta, dtype):
    """The N-minor Pallas kernel (the TPU's bucket-128 path) computes the
    same function the port serves at every batch size."""
    _compare(_inputs((128, 3, 3, 8), seed=1), dtype,
             lambda x, b: _lrn_nmin(x, N, ALPHA, b, K, True), beta)


@pytest.mark.parametrize("c", [3, 5, 8, 96])
def test_window_sum_matches_jax(c):
    v = np.random.default_rng(c).random((4, c)).astype(np.float32)
    want = np.asarray(jax_window_sum(jnp.asarray(v), 2))
    got = window_sum(torch.from_numpy(v), 2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("local_size,c", [(5, 1), (5, 2), (5, 7), (3, 4),
                                          (7, 16), (1, 6)])
def test_plain_lrn_matches_caffe_definition(local_size, c):
    """Against Caffe's definition written as a loop, including windows
    wider than the channel count (every channel's window is clipped)."""
    x = _inputs((3, c), seed=local_size * 10 + c).astype(np.float64)
    half = (local_size - 1) // 2
    want = np.empty_like(x)
    for ch in range(c):
        lo, hi = max(ch - half, 0), min(ch + half, c - 1)
        scale = K + ALPHA / local_size * np.sum(x[:, lo:hi + 1] ** 2, axis=1)
        want[:, ch] = x[:, ch] * scale ** -0.75
    got = lrn_plain(torch.from_numpy(x.astype(np.float32)), local_size,
                    ALPHA, 0.75, K).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


def test_lrn_dispatch_on_cpu_is_the_plain_version():
    x = torch.from_numpy(_inputs((2, 5, 5, 16)))
    np.testing.assert_array_equal(lrn(x, N, alpha=ALPHA, impl="auto").numpy(),
                                  lrn(x, N, alpha=ALPHA, impl="plain").numpy())
    with pytest.raises(ValueError, match="unknown LRN impl"):
        lrn(x, impl="pallas")


@pytest.mark.parametrize("local_size", [0, 4, -1])
def test_wrapper_rejects_even_or_empty_window(local_size):
    with pytest.raises(ValueError, match="odd"):
        cuda_lrn.lrn_fwd(torch.zeros(2, 8), local_size)


def test_beta_mode_matches_plain_specialisations():
    assert [cuda_lrn.beta_mode(b) for b in BETAS] == [1, 2, 0]


def test_channel_limit_is_read_once_when_the_library_loads(monkeypatch):
    """A library's channel limit is a constant of its build: the wrappers
    read it through ctypes when the library loads, not on every call."""
    reads = []

    class Fn:  # a ctypes function: takes argtypes and restype
        def __init__(self, value):
            self.value = value

        def __call__(self, *args):
            reads.append(args)
            return self.value

    class Lib:
        lrn_fwd, lrn_fwd_error_string = Fn(0), Fn(b"")
        lrn_fwd_max_channels = Fn(2048)

    monkeypatch.setattr(cuda_lrn, "_libs", {})
    monkeypatch.setattr(cuda_lrn, "_max_channels", {})
    monkeypatch.setattr(cuda_lrn._build, "load", lambda name: Lib)
    assert cuda_lrn._library("lrn_fwd") is Lib
    assert cuda_lrn._library("lrn_fwd") is Lib
    for c in (1, 96, 2048):
        assert cuda_lrn._check_cuda("lrn_fwd", torch.zeros(2, c)) == 0
    with pytest.raises(ValueError, match="at most 2048 channels"):
        cuda_lrn._check_cuda("lrn_fwd", torch.zeros(2, 2049))
    assert len(reads) == 1


# -- on the card ------------------------------------------------------------

# (shape, local_size). C = 1, 3, 7, 96, 256 and 1536 (the kernel takes up
# to `lrn_fwd_max_channels()`, 2048); row counts that are not a multiple of
# the kernel's tile (a tile is at most 2048 f32 or 4096 bf16 elements of
# whole rows: 21 or 42 rows of 96, 8 or 16 of 256, one or two of 1536) and
# single rows; local_size 3 and 7 (any window other than 5 reads its
# neighbours from memory) beside the zoo's 5
GPU_CASES = [((1, 27, 27, 96), 5), ((8, 13, 13, 256), 5),
             ((128, 3, 3, 8), 5), ((300, 256), 5), ((7, 5), 5),
             ((3, 1536), 5), ((1, 1536), 5), ((1, 96), 5), ((43, 96), 5),
             ((17, 256), 5), ((333, 1), 5), ((1001, 3), 5), ((513, 7), 5),
             ((1, 7), 5), ((43, 96), 3), ((17, 256), 7), ((1001, 3), 3),
             ((513, 7), 7), ((3, 1536), 7), ((333, 1), 3)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


class _CuLoc(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _CuAllocProp(ctypes.Structure):  # CUmemAllocationProp
    _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                ("location", _CuLoc), ("win32_metadata", ctypes.c_void_p),
                ("compression", ctypes.c_ubyte),
                ("rdma_capable", ctypes.c_ubyte), ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _CuAccess(ctypes.Structure):  # CUmemAccessDesc
    _fields_ = [("location", _CuLoc), ("flags", ctypes.c_int)]


@contextlib.contextmanager
def _at_end_of_mapping(t):
    """t's values in a tensor whose last byte is the last mapped byte of
    its device memory: the CUDA driver's virtual memory calls reserve two
    stretches of address space and map memory to the first only, so a
    read past the tensor's end faults (an illegal-address error) instead
    of reading a neighbour's bytes."""
    cu = ctypes.CDLL("libcuda.so.1")
    u64, size_t = ctypes.c_uint64, ctypes.c_size_t

    def call(name, *args):
        err = getattr(cu, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: CUresult {err}")

    dev = _CuLoc(1, torch.cuda.current_device())  # a device's memory
    prop = _CuAllocProp(type=1, location=dev)  # pinned: plain device memory
    gran = size_t()
    call("cuMemGetAllocationGranularity", ctypes.byref(gran),
         ctypes.byref(prop), 0)
    nbytes = t.numel() * t.element_size()
    size = -(-nbytes // gran.value) * gran.value
    va, handle = u64(), u64()
    call("cuMemAddressReserve", ctypes.byref(va), size_t(2 * size),
         size_t(0), u64(0), u64(0))
    try:
        call("cuMemCreate", ctypes.byref(handle), size_t(size),
             ctypes.byref(prop), u64(0))
        try:
            call("cuMemMap", va, size_t(size), size_t(0), handle, u64(0))
            try:
                call("cuMemSetAccess", va, size_t(size),
                     ctypes.byref(_CuAccess(dev, 3)), size_t(1))  # rw

                class Span:
                    __cuda_array_interface__ = {
                        "shape": (size,), "typestr": "|u1", "version": 2,
                        "data": (va.value, False)}

                buf = torch.as_tensor(Span(), device=t.device)
                assert buf.data_ptr() == va.value  # no copy
                x = buf[size - nbytes:].view(t.dtype).view(t.shape)
                x.copy_(t)
                yield x
                torch.cuda.synchronize()
                del buf, x
            finally:
                call("cuMemUnmap", va, size_t(size))
        finally:
            call("cuMemRelease", handle)
    finally:
        call("cuMemAddressFree", va, size_t(2 * size))


@contextlib.contextmanager
def _placed(t, where):
    """t's values in a contiguous tensor: t itself (0); in a slice that
    starts 3 elements into a larger buffer, off the 16-byte grid (3); or
    at the end of its device memory ("end")."""
    if where == "end":
        with _at_end_of_mapping(t) as x:
            yield x
        return
    if where == 0:
        yield t
        return
    buf = torch.empty(t.numel() + where, dtype=t.dtype, device=t.device)
    out = buf[where:].view(t.shape)
    out.copy_(t)
    yield out


def _same(got, want):
    """Bit for bit where `want` is a number, NaN where it is NaN."""
    nan = torch.isnan(want)
    return got.dtype == want.dtype and got.shape == want.shape and \
        torch.equal(torch.isnan(got), nan) and \
        torch.equal(got.masked_fill(nan, 0), want.masked_fill(nan, 0))


def _kernel_vs_plain(x, local_size, beta):
    """lrn_fwd y-only and with the scale against the plain versions on the
    same input: y with the scale equals y without it, both equal the
    plain y, and the scale equals the plain scale."""
    before = (cuda_lrn.lrn_fwd.launches, cuda_lrn.lrn_fwd.scale_launches)
    y = cuda_lrn.lrn_fwd(x, local_size, ALPHA, beta, K)
    ys, scale = cuda_lrn.lrn_fwd(x, local_size, ALPHA, beta, K,
                                 with_scale=True)
    assert (cuda_lrn.lrn_fwd.launches, cuda_lrn.lrn_fwd.scale_launches) == (
        before[0] + 2, before[1] + 1)
    py, pscale = lrn_plain_with_scale(x, local_size, ALPHA, beta, K)
    torch.cuda.synchronize()
    assert _same(y, py) and _same(ys, py) and _same(scale, pscale)
    assert _same(y, lrn_plain(x, local_size, ALPHA, beta, K))
    return y, py


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 3, "end"])
@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,local_size", GPU_CASES)
def test_kernel_matches_plain_on_card(shape, local_size, dtype, beta,
                                      offset):
    """Kernel vs plain version on the card, same inputs: y and the scale
    bit for bit. With offset 3, x starts off the 16-byte grid; with
    "end", x ends where its device memory ends, so a read past x (as
    from a tile that holds fewer rows than the others) faults."""
    _need_card()
    t = torch.from_numpy(_inputs(shape)).to("cuda", getattr(torch, dtype))
    with _placed(t, offset) as x:
        _kernel_vs_plain(x, local_size, beta)


@pytest.mark.gpu
@pytest.mark.parametrize("local_size", [3, 5, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 13, 13, 256), (4, 5, 5, 96),
                                   (65, 7)])
def test_kernel_matches_plain_on_nonfinite_input_on_card(shape, dtype,
                                                          local_size):
    """x holding inf, -inf and NaN: the kernel's y and scale are
    non-finite exactly where the plain version's are, and equal it
    elsewhere."""
    _need_card()
    a = _inputs(shape, seed=5)
    r = np.random.default_rng(6)
    for v in (np.inf, -np.inf, np.nan):
        a.reshape(-1)[r.choice(a.size, max(1, a.size // 50),
                               replace=False)] = v
    x = torch.from_numpy(a).to("cuda", getattr(torch, dtype))
    y, py = _kernel_vs_plain(x, local_size, 0.75)
    assert torch.equal(torch.isfinite(y), torch.isfinite(py))
    assert not bool(torch.isfinite(py).all())


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take_on_card():
    _need_card()
    x = torch.zeros(4, 6, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lrn.lrn_fwd(x.transpose(1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_lrn.lrn_fwd(x.half())
    cmax = cuda_lrn._library("lrn_fwd").lrn_fwd_max_channels()
    assert cmax >= 1536
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="channels"):
            cuda_lrn.lrn_fwd(torch.zeros(2, cmax + 1, device="cuda",
                                         dtype=dt))
        widest = torch.from_numpy(_inputs((2, cmax))).to("cuda", dt)
        _kernel_vs_plain(widest, N, 0.75)
    assert cuda_lrn.lrn_fwd(torch.zeros(0, 8, device="cuda")).shape == (0, 8)
