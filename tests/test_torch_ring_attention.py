"""The port's sequence-parallel attention (`sparknet_tpu_torch/parallel/
ring_attention.py`) against the JAX package's `make_ring_attention` on a
("seq",) mesh of as many conftest CPU devices as the port has ranks.

The ranks are gloo processes spawned with torch.multiprocessing
(`tests/torch_attention_worker.py:run_parity`, torch and the port only),
2 and 4 of them, at the JAX test's shape B, L, H, D = 2, 64, 8, 16 on
seeded arrays. For ring and Ulysses, causal and not: the gathered output
and the gradients of sum(out**2) in q, k and v against `jax.grad`
through the JAX wrapper, within rtol and atol 2e-5 (the JAX test's own
bound against exact attention). Also: the permute moves each rank's
(k, v) to the next and its backward is the inverse permutation; Ulysses
refuses heads that do not split over the ranks; a world of one runs
in-process with no collective; a tensor on the wrong device for the
group's backend raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from sparknet_tpu.parallel.ring_attention import (
    make_ring_attention as jax_make_ring_attention)

import torch_attention_worker
from sparknet_tpu_torch.ops.attention import attention
from sparknet_tpu_torch.parallel.mesh import DataGroup
from sparknet_tpu_torch.parallel.ring_attention import (
    SEQ_AXIS, make_ring_attention, ring_attention, ring_permute,
    ulysses_attention)

torch.set_num_threads(2)

B, L, H, D = 2, 64, 8, 16
TOL = dict(rtol=2e-5, atol=2e-5)
SPAWN_TIMEOUT_S = 240
CASES = [(impl, causal) for impl in ("ring", "ulysses")
         for causal in (False, True)]


def spawn(fn, world, tmp_path, *args):
    """Run `fn(rank, world, store, *args, out_dir)` on `world` ranks; their
    npz results."""
    ctx = mp.spawn(fn, args=(world, str(tmp_path / "store")) + args
                   + (str(tmp_path),), nprocs=world, join=False)
    waited = 0
    while not ctx.join(timeout=5):
        waited += 5
        if waited >= SPAWN_TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _qkv(seed):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((B, L, H, D)).astype(np.float32)
                 for _ in range(3))


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world_run(request, tmp_path_factory):
    world = request.param
    qkv = _qkv(world)
    res = spawn(torch_attention_worker.run_parity, world,
                tmp_path_factory.mktemp(f"attn{world}"), qkv)
    return world, qkv, res


def _jax_case(world, qkv, impl, causal):
    mesh = Mesh(np.array(jax.devices()[:world]), (SEQ_AXIS,))
    fn = jax_make_ring_attention(mesh, causal=causal, impl=impl)
    q, k, v = map(jnp.asarray, qkv)
    out = np.asarray(fn(q, k, v))
    grads = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    return out, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl,causal", CASES,
                         ids=[f"{i}-{'causal' if c else 'full'}"
                              for i, c in CASES])
def test_matches_the_jax_wrapper(world_run, impl, causal):
    world, qkv, res = world_run
    want, grads = _jax_case(world, qkv, impl, causal)
    key = f"{impl}/{int(causal)}"
    for r, got in enumerate(res):
        np.testing.assert_allclose(got[f"out/{key}"], want, **TOL,
                                   err_msg=f"rank {r} output")
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[f"{name}/{key}"], g, **TOL,
                                       err_msg=f"rank {r} {name}")


def test_the_permute_and_its_inverse(world_run):
    """Rank j's (k, v) lands on rank j+1; the backward takes the gradient
    of rank j+1's loss (weights 100 + (j+1)) back to rank j."""
    world, _, res = world_run
    for r, got in enumerate(res):
        src, dst = (r - 1) % world, (r + 1) % world
        np.testing.assert_array_equal(got["perm/k"], np.full((2, 3), src))
        np.testing.assert_array_equal(got["perm/v"], np.full(4, 10.0 + src))
        np.testing.assert_array_equal(got["perm/dk"],
                                      np.full((2, 3), 100.0 + dst))
        np.testing.assert_array_equal(got["perm/dv"],
                                      np.full(4, 2 * (100.0 + dst)))


def test_ulysses_refuses_heads_that_do_not_split(world_run):
    _, _, res = world_run
    assert all(int(got["odd_heads_raised"]) == 1 for got in res)


def test_a_gloo_group_refuses_another_device_type(world_run):
    """The live gloo group taken for a group of another device's ranks
    raises before any collective."""
    _, _, res = world_run
    assert all(int(got["backend_mismatch_raised"]) == 1 for got in res)


def test_a_world_of_one_is_exact_attention_without_a_collective():
    """A world of one formed without a process group: the ring is one
    block and the permute the identity, Ulysses exact attention; within
    1e-5 of `attention`, gradients too."""
    group = DataGroup(0, 1, torch.device("cpu"))
    q, k, v = (torch.from_numpy(a[:, :16]) for a in _qkv(1))
    assert ring_permute(group, k, v) == (k, v)
    for causal in (False, True):
        want = attention(q, k, v, causal=causal)
        for fn in (ring_attention, ulysses_attention):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            got = fn(*xs, group=group, causal=causal)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            torch.sum(got ** 2).backward()
            ys = [x.clone().requires_grad_() for x in (q, k, v)]
            torch.sum(attention(*ys, causal=causal) ** 2).backward()
            for x, y in zip(xs, ys):
                torch.testing.assert_close(x.grad, y.grad, rtol=1e-5,
                                           atol=1e-5)
        apply = make_ring_attention(group, causal=causal)
        torch.testing.assert_close(apply(q, k, v), want, rtol=1e-5,
                                   atol=1e-5)


def test_a_tensor_off_the_groups_device_raises():
    """No silent fallback: a non-CPU tensor on a group of CPU (gloo) ranks
    and a CPU tensor on a group of CUDA (NCCL) ranks raise before any
    collective."""
    x = torch.zeros((1, 4, 2, 8))
    cpu = DataGroup(0, 2, torch.device("cpu"))
    cuda = DataGroup(0, 2, torch.device("cuda", 0))
    meta = torch.zeros((1, 4, 2, 8), device="meta")
    with pytest.raises(ValueError, match="meta tensor on a group of cpu"):
        ring_attention(meta, meta, meta, group=cpu)
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(ValueError, match="cpu tensor on a group of cuda"):
            fn(x, x, x, group=cuda)
    with pytest.raises(ValueError, match="cpu tensor on a group of cuda"):
        ring_permute(cuda, x, x)
    with pytest.raises(ValueError, match="unknown impl"):
        make_ring_attention(cpu, impl="tree")
