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
The kernel itself runs only on a card: the `gpu` cases compare it with the
plain version there and skip elsewhere.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparknet_tpu.ops.lrn import _lrn_fused, _lrn_xla
from sparknet_tpu.ops.lrn import window_sum as jax_window_sum
from sparknet_tpu.ops.pallas_lrn import _lrn_nmin, lrn_pallas

from sparknet_tpu_torch.ops import cuda_lrn
from sparknet_tpu_torch.ops.lrn import lrn, lrn_plain, window_sum

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


# -- on the card ------------------------------------------------------------

GPU_CASES = [((1, 27, 27, 96), "float32", 0.75),
             ((8, 13, 13, 256), "bfloat16", 0.75),
             ((128, 3, 3, 8), "float32", 0.5),
             ((300, 256), "float32", 0.6),
             ((7, 5), "bfloat16", 0.6),
             ((3, 1536), "float32", 0.75)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,beta", GPU_CASES)
def test_kernel_matches_plain_on_card(shape, dtype, beta):
    """Kernel vs plain version on the card, same inputs: float32 within
    rtol 1e-5 / atol 1e-6, bfloat16 within one bf16 ulp."""
    _need_card()
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_inputs(shape)).to("cuda", dt)
    before = cuda_lrn.lrn_fwd.launches
    got = cuda_lrn.lrn_fwd(x, N, ALPHA, beta, K)
    assert cuda_lrn.lrn_fwd.launches == before + 1
    want = lrn_plain(x, N, ALPHA, beta, K)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == x.shape
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        ref = want.float().cpu().numpy()
        diff = np.abs(got.float().cpu().numpy() - ref)
        assert np.all(diff <= _bf16_ulp(ref))


@pytest.mark.gpu
def test_kernel_refuses_what_it_cannot_take_on_card():
    _need_card()
    x = torch.zeros(4, 6, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_lrn.lrn_fwd(x.transpose(1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_lrn.lrn_fwd(x.half())
    with pytest.raises(ValueError, match="channels"):
        cuda_lrn.lrn_fwd(torch.zeros(2, 4096, device="cuda"))
    assert cuda_lrn.lrn_fwd(torch.zeros(0, 8, device="cuda")).shape == (0, 8)
