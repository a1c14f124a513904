"""The port's multi-rank dry run (`sparknet_tpu_torch/dryrun.py`), the
counterpart of `__graft_entry__.py:dryrun_multichip`, on 2 gloo CPU ranks.

- Every loss is finite, the accuracy in [0, 1], the graph backend's float
  variables equal on both ranks after the round (within 1e-5, the JAX
  dry run's bound), and the summary line has the JAX line's fields.
- The attention loss and its three gradients equal the JAX package's on
  the same `default_rng(0)` draws within rtol 1e-5, and atol 1e-5 of the
  largest |gradient| (~0.02): the test computes them with
  `shard_map(ring_attention)` over a ("seq",) mesh of 2 conftest CPU
  devices, as `__graft_entry__.py:117-130` does, without calling the JAX
  dry run (which rewrites XLA_FLAGS).
- An odd rank count or one below 2 raises; so does a CUDA dry run without
  the cards it needs.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.parallel.mesh import shard_map
from sparknet_tpu.parallel.ring_attention import ring_attention

from sparknet_tpu_torch import dryrun

torch.set_num_threads(2)

N = 2


@pytest.fixture(scope="module")
def run():
    return dryrun.dryrun_multichip(N, device="cpu")


def _jax_attention(n):
    """The JAX dry run's attention value and gradients on its draws."""
    rng = np.random.default_rng(0)
    rng.standard_normal((2, n * 2, 67, 67, 3))  # the DP round's batches
    rng.integers(0, 16, (2, n * 2, 1))
    B, L, H, D = 2, 4 * n, 2, 8
    qkv = [rng.standard_normal((B, L, H, D)).astype(np.float32)
           for _ in range(3)]
    seq_mesh = make_mesh(n, axis_names=("seq",))
    spec = P(None, "seq")

    def sp_loss(q, k, v):
        inner = shard_map(
            lambda q, k, v: ring_attention(q, k, v, axis_name="seq"),
            mesh=seq_mesh, in_specs=(spec, spec, spec), out_specs=spec)
        return jnp.mean(inner(q, k, v) ** 2)

    val, grads = jax.jit(jax.value_and_grad(sp_loss, argnums=(0, 1, 2)))(
        *qkv)
    return float(val), [np.asarray(g) for g in grads]


def test_every_number_is_in_range(run):
    for key in ("loss", "tp_loss", "sp_loss", "graph_loss"):
        assert np.isfinite(run[key]), key
    assert 0.0 <= run["acc"] <= 1.0
    assert all(np.isfinite(g).all() for g in run["sp_grads"])
    assert run["graph_replica_spread"] <= 1e-5


def test_the_summary_line_has_the_jax_fields(run):
    assert re.fullmatch(
        r"dryrun_multichip\(2\): round loss=\S+ acc=\S+ tp_loss=\S+ "
        r"sp_loss=\S+ graph_loss=\S+ OK meta=\{.*\}", run["line"])
    assert set(run["meta"]) == {"torch_version", "backend", "device_kind",
                                "git_rev"}
    assert run["meta"]["backend"] == run["meta"]["device_kind"] == "cpu"
    assert run["meta"]["torch_version"] == torch.__version__


def test_the_attention_loss_and_gradients_are_the_jax_packages(run):
    val, grads = _jax_attention(N)
    assert run["sp_loss"] == pytest.approx(val, rel=1e-5)
    for got, want in zip(run["sp_grads"], grads):
        assert got.shape == want.shape == (2, 4 * N, 2, 8)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n", [0, 1, 3])
def test_an_odd_or_small_world_raises(n):
    with pytest.raises(ValueError, match="even n_ranks >= 2"):
        dryrun.dryrun_multichip(n, device="cpu")
    with pytest.raises(ValueError, match="even n_ranks >= 2"):
        dryrun.main(["--ranks", str(n), "--device", "cpu"])


def test_a_card_dry_run_without_the_cards_raises():
    """The default device is the card; without enough of them the dry run
    raises rather than fall back to the CPU."""
    if not torch.cuda.is_available():
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                dryrun.dryrun_multichip(2, device)
        return
    n = torch.cuda.device_count() + 2 - torch.cuda.device_count() % 2
    with pytest.raises(RuntimeError, match=f"needs {n} CUDA cards"):
        dryrun.dryrun_multichip(n)
