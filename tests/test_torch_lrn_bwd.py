"""The port's LRN gradient (ops/lrn.py, ops/cuda_lrn.py) against the JAX
package's VJPs.

The same numpy x and dy, made from a seed, go through `jax.vjp` of the JAX
LRN paths and through the port's autograd Function (`ops.lrn.lrn`), whose
backward on the CPU is the plain version of the route the input takes:
  - `_lrn_fused` (exp/log normalizer, recomputed in its VJP);
  - `lrn_pallas(..., interpret=True)` on the row route — the Pallas
    `_bwd_kernel`, reading the scale its forward saved;
  - `_lrn_nmin(..., interpret=True)` at N = 128 — the Pallas
    `_bwd_kernel3`, recomputing the scale.
Tolerances: float32 within rtol 1e-5 / atol 1e-5 (the forms evaluate
scale^-beta and 1/scale differently; |dx| is of order 1-10 here). In
bfloat16 (x, dy and the saved scale in bf16, f32 math inside) against the
Pallas paths, whose arithmetic the port repeats op for op: within one
bf16 ulp of the reference plus 1e-3 of its largest magnitude (an f32
difference in the last bit can flip the final rounding, and dx cancels
to near zero in places).
The kernels run only on a card: the `gpu` cases hold them to the plain
versions there, bit for bit, and skip elsewhere.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparknet_tpu.ops.lrn import _lrn_fused
from sparknet_tpu.ops.pallas_lrn import LANES, _lrn_nmin, lrn_pallas

from sparknet_tpu_torch.ops import cuda_lrn
from sparknet_tpu_torch.ops.lrn import (lrn, lrn_bwd_plain,
                                        lrn_bwd_plain_recompute,
                                        lrn_bwd_plain_saved, lrn_plain,
                                        lrn_plain_with_scale, lrn_route)

torch.set_num_threads(2)

ALPHA, K, N = 1e-4, 1.0, 5
BETAS = (0.75, 0.5, 0.6)
ROW_SHAPES = ((2, 7, 7, 96), (300, 256))
NMIN_SHAPE = (128, 3, 3, 8)


def _inputs(shape, seed=0):
    r = np.random.default_rng(seed)
    # x50: the normalizer moves well away from k, so beta matters
    x = (50.0 * r.standard_normal(shape)).astype(np.float32)
    dy = r.standard_normal(shape).astype(np.float32)
    return x, dy


def _jax_dx(fn, x, dy, dtype):
    xj = jnp.asarray(x).astype(dtype)
    _, vjp = jax.vjp(fn, xj)
    return np.asarray(vjp(jnp.asarray(dy).astype(dtype))[0]).astype(
        np.float32)


def _port_dx(x, dy, beta, dtype, impl="plain"):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    y = lrn(xt, N, alpha=ALPHA, beta=beta, k=K, impl=impl)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy).to(dtype))
    return dx.float().numpy()


def _bf16_ulp(ref):
    _, e = np.frexp(ref.astype(np.float32))
    return np.where(ref == 0, 0.0, np.ldexp(1.0, e - 8))


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = _bf16_ulp(want) + 1e-3 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol)


JAX_PATHS = {
    "fused": lambda b: (lambda a: _lrn_fused(a, N, ALPHA, b, K)),
    "pallas": lambda b: (lambda a: lrn_pallas(a, N, ALPHA, b, K,
                                              interpret=True)),
}


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("shape", ROW_SHAPES + (NMIN_SHAPE,))
@pytest.mark.parametrize("path", sorted(JAX_PATHS))
def test_plain_backward_matches_jax_vjp_f32(path, shape, beta):
    """f32: the fused VJP everywhere; the Pallas dispatch, which takes
    `_bwd_kernel` on the row shapes and `_bwd_kernel3` at N = 128."""
    x, dy = _inputs(shape, seed=len(shape))
    want = _jax_dx(JAX_PATHS[path](beta), x, dy, jnp.float32)
    _close(_port_dx(x, dy, beta, torch.float32), want, "float32")


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_plain_backward_matches_pallas_row_kernel_bf16(shape, beta):
    """bf16 on the row route: both sides save a bf16 scale."""
    x, dy = _inputs(shape, seed=3)
    want = _jax_dx(JAX_PATHS["pallas"](beta), x, dy, jnp.bfloat16)
    _close(_port_dx(x, dy, beta, torch.bfloat16), want, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("beta", BETAS)
def test_plain_backward_matches_nmin_kernel(beta, dtype):
    """`_bwd_kernel3` (interpreted) against the recompute route."""
    x, dy = _inputs(NMIN_SHAPE, seed=4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = _jax_dx(lambda a: _lrn_nmin(a, N, ALPHA, beta, K, True), x, dy,
                   jdt)
    _close(_port_dx(x, dy, beta, getattr(torch, dtype)), want, dtype)


SHAPES_FOR_ROUTES = [(128, 3, 3, 8), (256, 2, 1, 4), (128, 1, 1, 8),
                     (100, 3, 3, 8), (64, 5, 5, 8), (2, 7, 7, 96),
                     (300, 256), (128, 16), (384, 13, 13, 4)]


@pytest.mark.parametrize("shape", SHAPES_FOR_ROUTES)
def test_route_rule_picks_recompute_where_pallas_picks_nmin(shape):
    """Recompute exactly where `lrn_pallas` takes the N-minor kernel; the
    Function then saves x alone, else x and the scale."""
    nmin = (len(shape) == 4 and shape[0] % LANES == 0
            and shape[1] * shape[2] > 1)
    x = torch.ones(shape, requires_grad=True)
    assert lrn_route(x) == ("recompute" if nmin else "saved")
    saved = lrn(x, N, alpha=ALPHA, beta=0.75, k=K).grad_fn.saved_tensors
    assert (saved[1] is None) == nmin
    if not nmin:
        torch.testing.assert_close(saved[1], lrn_plain_with_scale(
            x.detach(), N, ALPHA, 0.75, K)[1], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_scale_output_leaves_y_unchanged(dtype):
    x, _ = _inputs((3, 5, 5, 16), seed=5)
    xt = torch.from_numpy(x).to(dtype)
    y, scale = lrn_plain_with_scale(xt, N, ALPHA, 0.75, K)
    assert torch.equal(y, lrn_plain(xt, N, ALPHA, 0.75, K))
    assert scale.dtype == dtype
    xr = xt.double().numpy()  # the input as the dtype rounded it
    want = K + ALPHA / N * np.stack(
        [np.sum(np.square(xr[..., max(c - 2, 0):c + 3]), axis=-1)
         for c in range(16)], axis=-1)
    np.testing.assert_allclose(scale.float().numpy(), want,
                               rtol=1e-6 if dtype == torch.float32
                               else 2 ** -8)


def test_recompute_and_saved_forms_agree():
    """The two plain backwards compute one function (they differ in
    1/scale vs rsqrt^2): rtol 1e-5."""
    x, dy = _inputs((4, 3, 3, 32), seed=6)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    _, scale = lrn_plain_with_scale(xt, N, ALPHA, 0.75, K)
    a = lrn_bwd_plain_saved(xt, scale, dyt, N, ALPHA, 0.75)
    b = lrn_bwd_plain_recompute(xt, dyt, N, ALPHA, 0.75, K)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(lrn_bwd_plain(xt, dyt, scale, N, ALPHA, 0.75, K), a)
    assert torch.equal(lrn_bwd_plain(xt, dyt, None, N, ALPHA, 0.75, K), b)


def test_cpu_backward_launches_nothing():
    before = (cuda_lrn.lrn_fwd.launches, cuda_lrn.lrn_bwd.launches)
    x, dy = _inputs((2, 7, 7, 96), seed=7)
    got = _port_dx(x, dy, 0.75, torch.float32, impl="auto")
    assert np.array_equal(got, _port_dx(x, dy, 0.75, torch.float32))
    dx = cuda_lrn.lrn_bwd(torch.from_numpy(x), torch.from_numpy(dy))
    assert np.array_equal(dx.numpy(), lrn_bwd_plain_recompute(
        torch.from_numpy(x), torch.from_numpy(dy)).numpy())
    assert (cuda_lrn.lrn_fwd.launches, cuda_lrn.lrn_bwd.launches) == before


def test_no_grad_forward_saves_nothing():
    x = torch.ones(128, 3, 3, 8, requires_grad=True)
    with torch.no_grad():
        y = lrn(x, N, alpha=ALPHA, beta=0.75, k=K)
    assert y.grad_fn is None
    assert torch.equal(y, lrn_plain(x.detach(), N, ALPHA, 0.75, K))


def test_backward_wrapper_rejects_mismatched_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="share a shape"):
        cuda_lrn.lrn_bwd(x, torch.zeros(4, 9))
    with pytest.raises(ValueError, match="odd"):
        cuda_lrn.lrn_bwd(x, x, None, 4)


# -- on the card ---------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


# beside the training shapes: row counts that are not a multiple of the
# kernel's tile (72900 rows of 96; 333 rows of 1), and C = 1, 5, 7, 256 and
# 768
GPU_SHAPES = [(100, 27, 27, 96), (128, 13, 13, 256), (7, 5), (3, 768),
              (333, 1), (1001, 7), (513, 768)]


def _at_offset(t, offset):
    """t's values in a contiguous slice that starts `offset` elements into
    a larger buffer (a data pointer off the 16-byte grid for offset 3)."""
    if offset == 0:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernels_match_plain_bitwise_on_card(shape, dtype, beta, offset):
    """lrn_fwd's scale output and both lrn_bwd modes equal their plain
    versions bit for bit; y with the scale equals y without it. With
    offset 3, x, dy and the scale start off the 16-byte grid."""
    _need_card()
    dt = getattr(torch, dtype)
    x, dy = (_at_offset(torch.from_numpy(a).to("cuda", dt), offset)
             for a in _inputs(shape, seed=8))
    before = (cuda_lrn.lrn_fwd.launches, cuda_lrn.lrn_bwd.launches)
    y, scale = cuda_lrn.lrn_fwd(x, N, ALPHA, beta, K, with_scale=True)
    y_only = cuda_lrn.lrn_fwd(x, N, ALPHA, beta, K)
    scale = _at_offset(scale, offset)
    dx_saved = cuda_lrn.lrn_bwd(x, dy, scale, N, ALPHA, beta, K)
    dx_re = cuda_lrn.lrn_bwd(x, dy, None, N, ALPHA, beta, K)
    assert (cuda_lrn.lrn_fwd.launches, cuda_lrn.lrn_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    py, pscale = lrn_plain_with_scale(x, N, ALPHA, beta, K)
    torch.cuda.synchronize()
    assert torch.equal(y, y_only) and torch.equal(y, py)
    assert torch.equal(scale, pscale)
    assert torch.equal(dx_saved, lrn_bwd_plain_saved(x, pscale, dy, N, ALPHA,
                                                     beta))
    assert torch.equal(dx_re, lrn_bwd_plain_recompute(x, dy, N, ALPHA, beta,
                                                      K))


@pytest.mark.gpu
def test_autograd_takes_the_kernels_on_card():
    _need_card()
    for shape, route in (((128, 3, 3, 8), "recompute"),
                         ((100, 3, 3, 8), "saved")):
        x, dy = (torch.from_numpy(a).cuda() for a in _inputs(shape, 9))
        before = (cuda_lrn.lrn_fwd.scale_launches,
                  cuda_lrn.lrn_bwd.launches)
        xg = x.clone().requires_grad_()
        (dx,) = torch.autograd.grad(lrn(xg, N, alpha=ALPHA, beta=0.75, k=K),
                                    xg, dy)
        assert cuda_lrn.lrn_bwd.launches == before[1] + 1
        assert cuda_lrn.lrn_fwd.scale_launches == before[0] + (
            route == "saved")
        xp = x.clone().requires_grad_()
        (want,) = torch.autograd.grad(
            lrn(xp, N, alpha=ALPHA, beta=0.75, k=K, impl="plain"), xp, dy)
        assert torch.equal(dx, want)


@pytest.mark.gpu
def test_backward_kernel_refuses_what_it_cannot_take_on_card():
    _need_card()
    x = torch.zeros(4, 6, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lrn.lrn_bwd(x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(TypeError, match="share a dtype"):
        cuda_lrn.lrn_bwd(x, x.bfloat16())
    with pytest.raises(ValueError, match="one device"):
        cuda_lrn.lrn_bwd(x, x.cpu())
    with pytest.raises(ValueError, match="channels"):
        wide = torch.zeros(2, 4096, device="cuda")
        cuda_lrn.lrn_bwd(wide, wide)
    assert cuda_lrn.lrn_bwd(torch.zeros(0, 8, device="cuda"),
                            torch.zeros(0, 8, device="cuda")).shape == (0, 8)
