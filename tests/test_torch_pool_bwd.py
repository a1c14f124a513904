"""The port's MAX-pool gradient (ops/pooling.py, ops/cuda_pool.py) against
the JAX package.

Inputs are tie-heavy — a few integer levels, clipped at 0 as post-ReLU
activations are (`tests/test_pallas_pool.py:_tie_heavy`) — so nearly every
window holds ties and the first-max rule decides where dy goes. The same
numpy x and dy go through the port's autograd Function (whose CPU backward
is `maxpool_bwd_plain`) and through three references:
  - `maxpool_bwd_reference` (`sparknet_tpu/ops/pallas_pool.py:232`, numpy,
    pad 0 and floor windows only);
  - `jax.vjp` of `pool2d(..., impl="xla")` — select-and-scatter, at every
    zoo pool shape, Caffe's ceil-mode windows and pad > 0;
  - `maxpool_pallas(..., interpret=True)`, the Pallas `_bwd_kernel`, at a
    shape its gate takes (N = 128, C = 8).
The positions that receive gradient must match exactly; the values within
rtol 1e-6 / atol 1e-6 (each element sums at most four dy, in another
order or precision on the other side). The CUDA kernel runs only on a
card: the `gpu` cases hold it to the plain version there, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.ops.pallas_pool import (kernel_api_available,
                                          maxpool_bwd_reference,
                                          maxpool_pallas)
from sparknet_tpu.ops.pooling import pool2d as jax_pool2d

from sparknet_tpu_torch.ops import cuda_pool
from sparknet_tpu_torch.ops.pooling import (caffe_pool_output_size,
                                            maxpool_bwd_plain, pool2d)

torch.set_num_threads(2)

# (NHWC shape, kernel, stride, pad)
ZOO_CASES = [
    ((2, 32, 32, 4), 3, 2, 0),    # cifar10_quick pool1: a ceil-mode window
    ((1, 55, 55, 3), 3, 2, 0),    # caffenet pool1
    ((2, 27, 27, 4), 3, 2, 0),    # caffenet pool2
    ((2, 13, 13, 4), 3, 2, 0),    # caffenet pool5
    ((2, 28, 28, 3), 2, 2, 0),    # lenet pool1
    ((2, 14, 14, 3), 2, 2, 0),    # lenet pool2
]
EDGE_CASES = [
    ((2, 7, 9, 3), 3, 2, 0),      # odd sizes, ceil windows in both axes
    ((2, 7, 7, 3), 3, 2, 1),      # pad > 0
    ((1, 6, 6, 2), 3, 2, 2),      # pad > 0, last window dropped
    ((1, 5, 5, 2), 2, 2, 1),
    ((2, 9, 9, 3), 3, 1, 1),      # stride 1: nine windows per element
    ((1, 8, 8, 2), 2, 3, 0),      # stride > kernel: uncovered elements
]
CASES = ZOO_CASES + EDGE_CASES


def _tie_heavy(rng, shape, levels=4):
    return np.maximum(rng.integers(-2, levels, shape), 0).astype(np.float32)


def _data(shape, k, s, pad, seed):
    r = np.random.default_rng(seed)
    x = _tie_heavy(r, shape)
    oshape = np.asarray(jax_pool2d(jnp.asarray(x), "MAX", k, s, pad,
                                   impl="xla")).shape
    return x, r.standard_normal(oshape).astype(np.float32)


def _port_dx(x, dy, k, s, pad, dtype=torch.float32, impl="auto"):
    xt = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = pool2d(xt, "MAX", k, s, pad, impl=impl)
    (dx,) = torch.autograd.grad(
        y, xt, torch.from_numpy(dy).to(dtype).permute(0, 3, 1, 2))
    return dx.permute(0, 2, 3, 1).float().numpy()


def _same(got, want):
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,k,s,pad", CASES)
def test_backward_matches_select_and_scatter(shape, k, s, pad):
    x, dy = _data(shape, k, s, pad, seed=sum(shape) + k + pad)
    _, vjp = jax.vjp(lambda a: jax_pool2d(a, "MAX", k, s, pad, impl="xla"),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    _same(_port_dx(x, dy, k, s, pad), want)


@pytest.mark.parametrize("shape,k,s,pad",
                         [c for c in CASES if c[3] == 0 and
                          (c[0][1] - c[1]) % c[2] == 0 and
                          (c[0][2] - c[1]) % c[2] == 0])
def test_backward_matches_numpy_oracle(shape, k, s, pad):
    """The JAX package's own first-max oracle (floor windows, pad 0)."""
    x, dy = _data(shape, k, s, pad, seed=7 * sum(shape))
    _same(_port_dx(x, dy, k, s, pad), maxpool_bwd_reference(x, dy, k, s))


@pytest.mark.parametrize("h,k,s", [(13, 3, 2), (12, 2, 2)])
def test_backward_matches_pallas_kernel(h, k, s):
    if not kernel_api_available():
        pytest.skip("the Pallas pool kernel needs pl.Element (newer jax)")
    x, dy = _data((128, h, h, 8), k, s, 0, seed=h)
    _, vjp = jax.vjp(lambda a: maxpool_pallas(a, k, s, True), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    _same(_port_dx(x, dy, k, s, 0), want)


def test_backward_bfloat16_matches_select_and_scatter():
    """bf16 x, y and dy. The port sums an element's (at most four) dy in
    f32 and rounds once; select-and-scatter rounds each of up to three
    additions to bf16: within atol 3 * 2^-8 * max|dx|, positions exact."""
    x, dy = _data((2, 27, 27, 4), 3, 2, 0, seed=11)
    dyb = np.asarray(jnp.asarray(dy).astype(jnp.bfloat16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_pool2d(a, "MAX", 3, 2, 0, impl="xla"),
                     jnp.asarray(x).astype(jnp.bfloat16))
    want = np.asarray(vjp(jnp.asarray(dyb).astype(jnp.bfloat16))[0]
                      ).astype(np.float32)
    got = _port_dx(x, dyb, 3, 2, 0, dtype=torch.bfloat16)
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3 * 2 ** -8 * np.abs(want).max())


def test_plain_routes_nonfinite_like_the_forward():
    """A window whose max is NaN routes nowhere (no element equals NaN);
    an all -inf window routes to its first -inf, as Caffe's argmax does."""
    x = np.zeros((1, 3, 3, 1), np.float32)
    x[0, 0, 0, 0] = np.nan
    y = torch.full((1, 1, 1, 1), float("nan"))
    dx = maxpool_bwd_plain(torch.from_numpy(x), y, torch.ones(1, 1, 1, 1),
                           3, 1, 0)
    assert not dx.any()
    xi = torch.full((1, 2, 2, 1), float("-inf"))
    dx = maxpool_bwd_plain(xi, torch.full((1, 1, 1, 1), float("-inf")),
                           torch.ones(1, 1, 1, 1), 2, 1, 0)
    assert dx.flatten().tolist() == [1.0, 0.0, 0.0, 0.0]


def test_cpu_backward_launches_nothing_and_plain_equals_auto():
    before = cuda_pool.maxpool_bwd.launches
    x, dy = _data((2, 32, 32, 4), 3, 2, 0, seed=3)
    assert np.array_equal(_port_dx(x, dy, 3, 2, 0),
                          _port_dx(x, dy, 3, 2, 0, impl="plain"))
    assert cuda_pool.maxpool_bwd.launches == before


def test_no_grad_forward_builds_no_graph():
    x = torch.ones(1, 2, 5, 5, requires_grad=True)
    with torch.no_grad():
        assert pool2d(x, "MAX", 3, 2, 0).grad_fn is None
    with pytest.raises(ValueError, match="unknown pool impl"):
        pool2d(x, "MAX", 3, 2, 0, impl="xla")


def test_wrapper_rejects_wrong_geometry():
    x = torch.zeros(1, 7, 7, 2)
    with pytest.raises(ValueError, match="is not the pool"):
        cuda_pool.maxpool_bwd(x, torch.zeros(1, 4, 4, 2),
                              torch.zeros(1, 4, 4, 2), 3, 2, 0)
    with pytest.raises(ValueError, match="pad < kernel"):
        cuda_pool.maxpool_bwd(x, torch.zeros(1, 5, 5, 2),
                              torch.zeros(1, 5, 5, 2), 2, 2, 2)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape,k,s,pad", CASES + [
    ((256, 55, 55, 96), 3, 2, 0), ((256, 27, 27, 256), 3, 2, 0),
    ((256, 13, 13, 256), 3, 2, 0), ((100, 32, 32, 32), 3, 2, 0),
    ((4, 28, 28, 20), 2, 2, 0), ((4, 14, 14, 50), 2, 2, 0),
    ((1, 260, 260, 1), 130, 1, 0)])
def test_plan_tiles_fit_shared_memory(shape, k, s, pad, itemsize):
    """Every tile the wrapper plans fits an SM's shared memory, splits the
    channels into power-of-two lane groups, and takes 16-byte vectors
    exactly where C * itemsize allows; CaffeNet's and cifar10_quick's
    pools stage in 64 KB (three blocks an SM) with at least 64 bytes of
    channels and strips of at least 8 rows."""
    _, h, w, c = shape
    oh = caffe_pool_output_size(h, k, s, pad)
    ow = caffe_pool_output_size(w, k, s, pad)
    p = cuda_pool.plan(h, w, c, oh, ow, k, s, itemsize)
    v = 16 // itemsize if p.vec else 1
    assert p.vec == (c % (16 // itemsize) == 0)
    lanes = p.cb // v
    assert p.cb % v == 0 and c % p.cb == 0
    assert lanes & (lanes - 1) == 0 and lanes <= 32
    assert p.smem == cuda_pool.smem_bytes(h, w, oh, ow, k, s, itemsize,
                                          p.hb, p.wb, p.cb, p.staged)
    assert p.smem <= cuda_pool.SMEM_MAX
    if c % 32 == 0 and k <= 3:
        assert p.staged and p.vec
        assert p.smem <= cuda_pool.SMEM_PREFERRED
        assert p.cb * itemsize >= 64 and p.hb >= min(h, 8)
    if k == 130:  # x too large to stage: each element rescans
        assert not p.staged


def test_plan_falls_back_to_one_element_when_unaligned():
    p = cuda_pool.plan(27, 27, 96, 13, 13, 3, 2, 2, aligned=False)
    assert not p.vec and p.staged
    assert p.smem <= cuda_pool.SMEM_PREFERRED


def test_plan_rescans_only_windows_it_cannot_stage():
    """A 20-wide window stages (2-byte offsets); at stride 1 a 94-wide one
    stages in f32 but not a 95-wide one, and a 129-wide one in bf16 but not
    a 130-wide one; a window wider than 255 always rescans (offsets are at
    most 2 bytes)."""
    def staged(hw, k, itemsize):
        return cuda_pool.plan(hw, hw, 1, hw - k + 1, hw - k + 1, k, 1,
                              itemsize).staged
    assert staged(40, 20, 4) and staged(40, 20, 2)
    assert staged(300, 94, 4) and not staged(300, 95, 4)
    assert staged(300, 129, 2) and not staged(300, 130, 2)
    assert not staged(300, 256, 2)


# -- on the card ---------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


# beside CASES on the card: CaffeNet's pool2 and cifar10_quick's pool1 at
# full width, a pad-1 shape, and shapes aimed at the kernel's tiling —
# 17 rows (a one-row last strip of 16), 27 rows (a strip of 11), C = 20 and
# 50 (one element per thread in bf16), 32 and 96 (16-byte vectors), a dx
# element covered by 4 windows (kernel 2, stride 1), a kernel of 20 (2-byte
# window offsets) and one of 130 (x too large to stage: each element
# rescans). The fifth entry, True, forces the rescan on a shape the plan
# would stage.
CARD_CASES = [c + (False,) for c in CASES] + [
    ((256, 27, 27, 96), 3, 2, 0, None),
    ((100, 32, 32, 32), 3, 2, 0, None),
    ((8, 13, 13, 64), 3, 2, 1, None),
    ((2, 17, 17, 32), 3, 2, 0, None),
    ((4, 27, 27, 96), 3, 2, 0, None),
    ((4, 28, 28, 20), 2, 2, 0, None),
    ((4, 14, 14, 50), 2, 2, 0, None),
    ((2, 10, 10, 8), 2, 1, 0, None),
    ((2, 40, 40, 8), 20, 1, 0, None),
    ((1, 260, 260, 1), 130, 1, 0, None),
    ((4, 27, 27, 96), 3, 2, 0, True),
    ((2, 9, 9, 3), 3, 1, 1, True),
    ((1, 8, 8, 2), 2, 3, 0, True),
]


def _card_x(r, shape, inputs):
    """tie-heavy; dense (ReLU of a Gaussian: ties only among zeros); or
    tie-heavy with NaNs (NaN windows route nowhere: one at (0, 0), which
    the first window always covers, and 1% of the rest) and a last channel
    of -inf (its windows route to their first element)."""
    if inputs == "dense":
        return np.maximum(r.standard_normal(shape), 0).astype(np.float32)
    x = _tie_heavy(r, shape)
    if inputs == "nonfinite":
        x[r.random(shape) < 0.01] = np.nan
        x[..., -1] = -np.inf
        x[:, 0, 0, 0] = np.nan
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["ties", "dense", "nonfinite"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k,s,pad,rescan", CARD_CASES)
def test_kernel_matches_plain_bitwise_on_card(shape, k, s, pad, rescan,
                                              dtype, inputs, monkeypatch):
    _need_card()
    if rescan:
        planned = cuda_pool.plan

        def forced(*args, **kw):
            p = planned(*args, **kw)
            return p._replace(staged=False, smem=cuda_pool.smem_bytes(
                *args[:2], *args[3:8], p.hb, p.wb, p.cb, False))

        monkeypatch.setattr(cuda_pool, "plan", forced)
    dt = getattr(torch, dtype)
    r = np.random.default_rng(sum(shape))
    x = torch.from_numpy(_card_x(r, shape, inputs)).to("cuda", dt)
    y = pool2d(x.permute(0, 3, 1, 2), "MAX", k, s, pad).permute(
        0, 2, 3, 1).contiguous()
    dy = torch.from_numpy(r.standard_normal(tuple(y.shape)).astype(
        np.float32)).to("cuda", dt)
    before = cuda_pool.maxpool_bwd.launches
    got = cuda_pool.maxpool_bwd(x, y, dy, k, s, pad)
    assert cuda_pool.maxpool_bwd.launches == before + 1
    want = maxpool_bwd_plain(x, y, dy, k, s, pad)
    torch.cuda.synchronize()
    if inputs == "nonfinite":
        assert bool(y.isnan().any()) and bool((y == float("-inf")).any())
    assert torch.equal(got != 0, want != 0)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_autograd_takes_the_kernel_on_card():
    _need_card()
    x, dy = _data((4, 32, 32, 8), 3, 2, 0, seed=5)
    xt = torch.from_numpy(x).cuda().permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    dyt = torch.from_numpy(dy).cuda().permute(0, 3, 1, 2)
    before = cuda_pool.maxpool_bwd.launches
    out = []
    for impl in ("auto", "plain"):
        xg = xt.clone().requires_grad_()
        (dx,) = torch.autograd.grad(pool2d(xg, "MAX", 3, 2, 0, impl=impl),
                                    xg, dyt)
        out.append(dx)
    assert cuda_pool.maxpool_bwd.launches == before + 1
    assert torch.equal(out[0], out[1])


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take_on_card():
    _need_card()
    x = torch.zeros(2, 7, 7, 4, device="cuda")
    y = torch.zeros(2, 3, 3, 4, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pool.maxpool_bwd(x.transpose(1, 2), y, y, 3, 2, 0)
    with pytest.raises(TypeError, match="one dtype"):
        cuda_pool.maxpool_bwd(x, y.bfloat16(), y, 3, 2, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_pool.maxpool_bwd(x.half(), y.half(), y.half(), 3, 2, 0)
    with pytest.raises(ValueError, match="one device"):
        cuda_pool.maxpool_bwd(x, y.cpu(), y, 3, 2, 0)
