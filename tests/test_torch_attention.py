"""The port's attention ops (`sparknet_tpu_torch/ops/attention.py`) against
the JAX package's (`sparknet_tpu/ops/attention.py`) on the same seeded
arrays, [B, L, H, D] = [2, 12, 3, 8] (d = 8, so sqrt(d) is no power of
two and a division rounded in bfloat16 would show).

Tolerances:
  - "float32": outputs, the running (o, m, l) state after every block and
    the gradients of sum(out**2) (against `jax.vjp`) within rtol and atol
    1e-5 (the JAX package's own ring test allows 2e-5 against exact
    attention);
  - "bfloat16": the output dtypes equal JAX's for float32 and bfloat16
    inputs; float32 outputs within 1e-5 (both packages round the scores at
    the same points, so only the products' summation order differs),
    bfloat16 outputs within one bfloat16 ulp (rtol 2**-7); the gradients
    of float32 inputs within 1e-5 of the largest |gradient| (the backward
    products run on the same bfloat16 operands in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu import precision as jax_precision
from sparknet_tpu.ops import attention as jattn

from sparknet_tpu_torch import precision
from sparknet_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

B, L, H, D = 2, 12, 3, 8
F32 = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed, n=3, shape=(B, L, H, D), ties=False):
    r = np.random.default_rng(seed)
    if ties:  # a few integer levels: many exactly equal scores
        return [r.integers(-1, 2, shape).astype(np.float32)
                for _ in range(n)]
    return [r.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _t(a, dtype=torch.float32, grad=False):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


def _np(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_grads(fn, xs):
    """fn's output and the gradients of sum(out**2) in each of xs."""
    ts = [_t(a, grad=True) for a in xs]
    out = fn(*ts)
    torch.sum(out.float() ** 2).backward()
    return out, [t.grad for t in ts]


def _jax_grads(fn, xs):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, xs))
    return out, vjp(2 * out)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_attention_and_its_gradients_match_jax(causal, with_bias):
    xs = _arrays(0)
    if with_bias:
        xs += _arrays(1, 1, (1, H, L, L))

    def port(q, k, v, *bias):
        return tattn.attention(q, k, v, causal=causal,
                               bias=bias[0] if bias else None)

    def ref(q, k, v, *bias):
        return jattn.attention(q, k, v, causal=causal,
                               bias=bias[0] if bias else None)

    got, g_got = _port_grads(port, xs)
    want, g_want = _jax_grads(ref, xs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


#: (q_offset, q rows, KV block offsets in chain order, block length,
#: causal): the ring's order for a middle shard with a block past the
#: queries; a fully masked FIRST block (m = -inf, l = 0 after it); rows
#: that never see a key (l == 0 at the end, output 0); the unmasked chain
CHAINS = {
    "ring_order": (4, 4, (4, 0, 8), 4, True),
    "masked_first": (4, 4, (8, 0, 4), 4, True),
    "rows_see_no_key": (2, 6, (8, 4), 4, True),
    "unmasked": (0, 4, (0, 4, 8), 4, False),
}


def _chain(mod, q, k, v, q_off, offs, lk, causal, states=None):
    """init, one `block_accumulate` per KV block offset, finalize; each
    running (o, m, l) appended to `states`."""
    o, m, l = mod.init_accumulator(tuple(q.shape))
    for off in offs:
        o, m, l = mod.block_accumulate(o, m, l, q, k[:, off:off + lk],
                                       v[:, off:off + lk], k_offset=off,
                                       q_offset=q_off, causal=causal)
        if states is not None:
            states.append((o, m, l))
    return mod.finalize_accumulator(o, m, l, q.dtype)


@pytest.mark.parametrize("ties", [False, True], ids=["gauss", "ties"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_block_chains_match_jax(chain, ties):
    """Chains of `block_accumulate` through `finalize_accumulator`: every
    running (o, m, l), the output and the gradients of sum(out**2) in q
    and the whole k and v, within 1e-5 (-inf maxima equal); nothing
    non-finite where JAX is finite. "ties" draws integer levels, so many
    scores of a row are equal: the running max's tie gradient is split
    evenly in both packages."""
    q_off, lq, offs, lk, causal = CHAINS[chain]
    q, k, v = _arrays(2, ties=ties)
    q = q[:, q_off:q_off + lq]
    args = (q_off, offs, lk, causal)
    got, g_got = _port_grads(lambda *x: _chain(tattn, *x, *args), (q, k, v))
    want, g_want = _jax_grads(lambda *x: _chain(jattn, *x, *args), (q, k, v))
    t_states, j_states = [], []
    _chain(tattn, *(_t(a) for a in (q, k, v)), *args, t_states)
    _chain(jattn, *map(jnp.asarray, (q, k, v)), *args, j_states)
    for (to, tm, tl), (jo, jm, jl) in zip(t_states, j_states):
        for a, b in ((to, jo), (tm, jm), (tl, jl)):
            np.testing.assert_allclose(_np(a), _np(b), **F32)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    for a, b in zip(g_got, g_want):
        a, b = _np(a), _np(b)
        assert (np.isfinite(a) | ~np.isfinite(b)).all()
        np.testing.assert_allclose(a, b, **F32)
    if chain == "rows_see_no_key":
        np.testing.assert_array_equal(_np(got)[:, :2], 0.0)
        assert _np(t_states[-1][2])[:, :, :2].max() == 0.0


def test_init_and_finalize_are_the_jax_packages():
    o, m, l = tattn.init_accumulator((B, 5, H, D), torch.device("cpu"))
    jo, jm, jl = jattn.init_accumulator((B, 5, H, D))
    for a, b in ((o, jo), (m, jm), (l, jl)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_np(a), _np(b))
    r = np.random.default_rng(3)
    o = r.standard_normal((B, 5, H, D)).astype(np.float32)
    l = np.abs(r.standard_normal((B, H, 5))).astype(np.float32)
    l[0, 1, 2] = 0.0
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = tattn.finalize_accumulator(_t(o), None, _t(l), dt)
        want = jattn.finalize_accumulator(jnp.asarray(o), None,
                                          jnp.asarray(l), jdt)
        assert got.dtype == dt
        np.testing.assert_array_equal(_np(got), _np(want))


_BF16_OUT = dict(rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_bfloat16_policy_rounds_where_jax_rounds(in_dtype, causal):
    """Under "bfloat16": `attention` and a ring-order block chain return
    JAX's dtype for each input dtype (float32 inputs: an f32 x bf16 PV
    product, float32 out; bfloat16 inputs: bfloat16), at JAX's values."""
    xs = _arrays(4)
    tdt = torch.float32 if in_dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if in_dtype == "float32" else jnp.bfloat16
    q_off, lq, offs, lk, _ = CHAINS["ring_order"]
    with precision.policy("bfloat16"), jax_precision.policy("bfloat16"):
        tq, tk, tv = (_t(a, tdt) for a in xs)
        jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in xs)
        pairs = [
            (tattn.attention(tq, tk, tv, causal=causal),
             jattn.attention(jq, jk, jv, causal=causal)),
            (_chain(tattn, tq[:, q_off:q_off + lq], tk, tv, q_off, offs,
                    lk, causal),
             _chain(jattn, jq[:, q_off:q_off + lq], jk, jv, q_off, offs,
                    lk, causal))]
    for got, want in pairs:
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        tol = F32 if in_dtype == "float32" else _BF16_OUT
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bfloat16_policy_gradients_match_jax(causal):
    xs = _arrays(5)
    with precision.policy("bfloat16"), jax_precision.policy("bfloat16"):
        got, g_got = _port_grads(
            lambda q, k, v: tattn.attention(q, k, v, causal=causal), xs)
        want, g_want = _jax_grads(
            lambda q, k, v: jattn.attention(q, k, v, causal=causal), xs)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    for a, b in zip(g_got, g_want):
        a, b = _np(a), _np(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_float32_policy_turns_tf32_off():
    """Every f32 call re-applies the backend flags (TF32 off), as every f32
    forward of the port does."""
    xs = [_t(a) for a in _arrays(6)]
    for fn in (lambda: tattn.attention(*xs),
               lambda: tattn.block_accumulate(
                   *tattn.init_accumulator(tuple(xs[0].shape)), *xs,
                   k_offset=0, q_offset=0, causal=True)):
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            fn()
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
