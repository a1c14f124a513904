"""The port's Caffe pooling forward (ops/pooling.py) against JAX `pool2d`.

Same numpy inputs through `sparknet_tpu.ops.pooling.pool2d` (NHWC,
reduce_window) and the port's `pool2d` (NCHW in channels_last memory, with
explicit padding). Cases: every pooling layer of the zoo at its own shape
(channels cut), odd sizes where Caffe's ceil-mode adds a window, pad > 0
where the last window is dropped, and the AVE divisor over the padded
extent. MAX must match exactly; AVE within rtol 1e-6 / atol 1e-6 (the
window sum's order differs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparknet_tpu.ops.pooling import caffe_pool_output_size as jax_out_size
from sparknet_tpu.ops.pooling import global_pool2d as jax_global_pool2d
from sparknet_tpu.ops.pooling import pool2d as jax_pool2d

from sparknet_tpu_torch.ops.pooling import (caffe_pool_output_size,
                                            global_pool2d, pool2d)

torch.set_num_threads(2)

# (NHWC shape, mode, kernel, stride, pad)
CASES = [
    # cifar10_quick pool1-3: 32 -> 16 takes a ceil-mode window
    ((2, 32, 32, 4), "MAX", 3, 2, 0),
    ((2, 16, 16, 4), "AVE", 3, 2, 0),
    ((2, 8, 8, 4), "AVE", 3, 2, 0),
    # caffenet pool1, pool2, pool5
    ((1, 55, 55, 3), "MAX", 3, 2, 0),
    ((2, 27, 27, 4), "MAX", 3, 2, 0),
    ((2, 13, 13, 4), "MAX", 3, 2, 0),
    # lenet pool1, pool2
    ((2, 28, 28, 3), "MAX", 2, 2, 0),
    ((2, 14, 14, 3), "MAX", 2, 2, 0),
    # odd sizes
    ((2, 7, 9, 3), "MAX", 3, 2, 0),
    ((2, 7, 9, 3), "AVE", 3, 2, 0),
    ((1, 5, 5, 2), "MAX", 2, 2, 0),
    ((1, 5, 5, 2), "AVE", 2, 2, 0),
    ((1, 11, 6, 3), "AVE", 3, 3, 0),
    # pad > 0: the divisor counts the padded extent; last window dropped
    ((2, 7, 7, 3), "MAX", 3, 2, 1),
    ((2, 7, 7, 3), "AVE", 3, 2, 1),
    ((1, 6, 6, 2), "AVE", 3, 2, 2),
    ((1, 6, 6, 2), "MAX", 3, 2, 2),
    ((1, 5, 5, 2), "MAX", 2, 2, 1),
    ((1, 13, 13, 4), "AVE", 3, 2, 1),
    ((1, 4, 4, 2), "AVE", 3, 1, 1),
]


def _inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port(x_nhwc: np.ndarray, fn, dtype=torch.float32) -> np.ndarray:
    t = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
    return fn(t).permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("shape,mode,k,s,pad", CASES)
def test_pool_matches_jax(shape, mode, k, s, pad):
    x = _inputs(shape, seed=sum(shape) + k + pad)
    want = np.asarray(jax_pool2d(jnp.asarray(x), mode, k, s, pad,
                                 impl="xla"))
    got = _port(x, lambda t: pool2d(t, mode, k, s, pad))
    assert got.shape == want.shape
    if mode == "MAX":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["MAX", "AVE"])
def test_pool_bfloat16_matches_jax(mode):
    """bf16 in, bf16 out; AVE sums in f32 on both sides, then rounds once:
    within one bf16 ulp (rtol 2^-8 of the result)."""
    x = _inputs((2, 27, 27, 4), seed=3)
    want = np.asarray(jax_pool2d(jnp.asarray(x).astype(jnp.bfloat16), mode,
                                 3, 2, 0, impl="xla")).astype(np.float32)
    got = _port(x, lambda t: pool2d(t, mode, 3, 2, 0), torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("mode", ["MAX", "AVE"])
def test_global_pool_matches_jax(mode):
    x = _inputs((2, 5, 6, 3), seed=4)
    want = np.asarray(jax_global_pool2d(jnp.asarray(x), mode))
    got = _port(x, lambda t: global_pool2d(t, mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_output_size_matches_jax():
    for size in range(1, 40):
        for k in (1, 2, 3, 5):
            for s in (1, 2, 3):
                for pad in (0, 1, 2):
                    if k > size + 2 * pad:
                        continue
                    assert caffe_pool_output_size(size, k, s, pad) == \
                        jax_out_size(size, k, s, pad)


def test_pool_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown pool mode"):
        pool2d(torch.zeros(1, 1, 4, 4), "MIN", 2, 2, 0)
