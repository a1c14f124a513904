"""The port's checkpoint store (`sparknet_tpu_torch/utils/checkpoint.py`)
and its state boundary (`ParallelTrainer.checkpoint_tree` /
`state_from_checkpoint`), against the JAX package's store.

The integrity cases are those of `tests/test_health.py` on the port's
store. The cross-package cases hold the two stores to one format: a step
either package writes, the other verifies and restores with equal keys,
dtypes, shapes and bytes (a bfloat16 momentum leaf and `ext_dtypes`
included), and a JAX-written cifar10_quick step (a mesh of one, and a
mesh of two with checkpoint_sharded="off") loads into the port's state
exactly: the layouts are permutations, so no tolerance is needed.
"""
import json
import os

import numpy as np
import pytest
import torch

from sparknet_tpu.apps import cifar_app as jax_cifar_app
from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve_spec
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.utils import checkpoint as jck

from fake_stores import corrupt_npz_bytes
from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.data.cifar import write_synthetic
from sparknet_tpu_torch.model.net import CompiledNet, params_to_jax
from sparknet_tpu_torch.obs.registry import MetricsRegistry
from sparknet_tpu_torch.parallel.mesh import DataGroup
from sparknet_tpu_torch.parallel.trainer import (ParallelTrainer,
                                                 reduce_momentum_rows)
from sparknet_tpu_torch.solver import SolverConfig
from sparknet_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)


def _save_steps(d, n=3, seed=0):
    r = np.random.default_rng(seed)
    trees = {}
    for s in range(1, n + 1):
        trees[s] = {"a": {"w": r.standard_normal((4, 3)).astype(np.float32)},
                    "it": np.asarray([s] * 2)}
        ckpt.save(str(d), trees[s], step=s)
    return trees


def _trainer(rank=0, world=1, velocity="float32", batch=2):
    """A cifar10_quick trainer on a data group that is never formed:
    the boundary functions of one rank need no collective at world 1,
    and state_from_checkpoint needs none at any world."""
    net = CompiledNet.compile(zoo.cifar10_quick(batch=batch))
    group = DataGroup(rank, world, torch.device("cpu"))
    return ParallelTrainer(net, SolverConfig(velocity_dtype=velocity),
                           group, tau=1)


def _filled_state(tr, seed=1):
    """init params and a momentum of seeded values, it = 7."""
    state = tr.init_state(0)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        state.flat_momentum.copy_(torch.randn(
            state.flat_momentum.shape, generator=g).to(
                state.flat_momentum.dtype))
    state.it = 7
    return state


def _bits(leaf):
    """(dtype name, shape, bytes) of a restored leaf of either store."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).replace("torch.", "")
        raw = (leaf.view(torch.int16) if leaf.dtype == torch.bfloat16
               else leaf).numpy().tobytes()
        return name, tuple(leaf.shape), raw
    return np.dtype(leaf.dtype).name, tuple(leaf.shape), leaf.tobytes()


# -- integrity (the cases of tests/test_health.py) --------------------------


def test_digest_verification_rejects_flipped_byte(tmp_path):
    trees = _save_steps(tmp_path / "ck", n=3)
    npz = tmp_path / "ck" / "step-3" / "state.npz"
    npz.write_bytes(corrupt_npz_bytes(npz.read_bytes()))
    assert not ckpt.verify(str(tmp_path / "ck" / "step-3"))
    assert ckpt.verify(str(tmp_path / "ck" / "step-2"))
    with pytest.warns(RuntimeWarning):
        flat, step, _ = ckpt.restore_flat(str(tmp_path / "ck"))
    assert step == 2
    np.testing.assert_array_equal(flat["a/w"], trees[2]["a"]["w"])
    with pytest.raises(ckpt.CheckpointCorruptError, match="digest"):
        ckpt.restore_flat(str(tmp_path / "ck"), step=3)
    assert ckpt.newest_verified_step(str(tmp_path / "ck")) == 2


def test_truncated_npz_rejected_and_falls_back(tmp_path):
    trees = _save_steps(tmp_path / "ck", n=2)
    npz = tmp_path / "ck" / "step-2" / "state.npz"
    npz.write_bytes(npz.read_bytes()[:40])  # torn copy
    with pytest.warns(RuntimeWarning):
        flat, step, _ = ckpt.restore_flat(str(tmp_path / "ck"))
    assert step == 1
    np.testing.assert_array_equal(flat["a/w"], trees[1]["a"]["w"])


def test_bad_meta_json_is_not_a_checkpoint(tmp_path):
    _save_steps(tmp_path / "ck", n=2)
    meta = tmp_path / "ck" / "step-2" / "meta.json"
    meta.write_text("{ torn json")
    with pytest.warns(RuntimeWarning):
        assert ckpt.latest_step(str(tmp_path / "ck")) == 1
    with pytest.warns(RuntimeWarning):
        _, step, _ = ckpt.restore_flat(str(tmp_path / "ck"))
    assert step == 1
    os.remove(meta)  # missing entirely: same story
    with pytest.warns(RuntimeWarning):
        assert ckpt.latest_step(str(tmp_path / "ck")) == 1


def test_digestless_legacy_checkpoint_still_restores(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32)}
    path = ckpt.save(str(tmp_path / "ck"), tree, step=1)
    meta = json.load(open(os.path.join(path, "meta.json")))
    del meta["digests"]  # a step of the format before digests
    json.dump(meta, open(os.path.join(path, "meta.json"), "w"))
    assert ckpt.verify(path)
    flat, step, _ = ckpt.restore_flat(str(tmp_path / "ck"))
    assert step == 1
    np.testing.assert_array_equal(flat["a"], tree["a"])


def test_retain_protects_newest_verified(tmp_path):
    _save_steps(tmp_path / "ck", n=5)
    for s in (4, 5):  # corrupt the two newest
        npz = tmp_path / "ck" / f"step-{s}" / "state.npz"
        raw = bytearray(npz.read_bytes())
        raw[-10] ^= 0x01
        npz.write_bytes(bytes(raw))
    ckpt.invalidate_written_cache()
    ckpt.retain(str(tmp_path / "ck"), keep=2)
    assert sorted(os.listdir(tmp_path / "ck")) == \
        ["step-3", "step-4", "step-5"]


def test_retain_keeps_the_newest_non_anomalous_step(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, {"a": np.zeros(2)}, step=1)
    for s in (2, 3, 4):
        ckpt.save(d, {"a": np.full(2, s)}, step=s, extra={"anomalous": True})
    ckpt.retain(d, keep=2)
    assert sorted(os.listdir(d)) == ["step-1", "step-3", "step-4"]


def test_save_sweeps_stale_tmp_dirs(tmp_path):
    d = tmp_path / "ck"
    os.makedirs(d / ".tmp-deadbeef")  # a killed writer's leftovers
    (d / ".tmp-deadbeef" / "state.npz").write_bytes(b"partial")
    os.makedirs(d / "step-9")  # never committed: no meta.json
    ckpt.save(str(d), {"a": np.zeros(2)}, step=1)
    assert sorted(os.listdir(d)) == ["step-1"]


def test_anomalous_checkpoints_skipped_by_rollback_selector(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, {"a": np.zeros(2)}, step=1)
    ckpt.save(d, {"a": np.ones(2)}, step=2, extra={"anomalous": True})
    assert ckpt.newest_verified_step(d) == 2
    assert ckpt.newest_verified_step(d, skip_anomalous=True) == 1
    _, step, extra = ckpt.restore_newest_verified(d, skip_anomalous=True)
    assert step == 1 and "commit_ts" in extra


def test_a_per_shard_step_is_refused_not_reported_corrupt(tmp_path):
    d = tmp_path / "ck"
    ckpt.save(str(d), {"a": np.zeros(2)}, step=1)
    os.makedirs(d / "step-2")
    (d / "step-2" / "meta.json").write_text(json.dumps(
        {"step": 2, "keys": ["a"], "shards": [
            {"file": "shard-00000-of-00001.npz", "entries": {}}]}))
    for call in (lambda: ckpt.restore_flat(str(d)),
                 lambda: ckpt.verify(str(d / "step-2")),
                 lambda: ckpt.restore_newest_verified(str(d))):
        with pytest.raises(NotImplementedError, match="per-shard"):
            call()


# -- the writers ------------------------------------------------------------


def test_async_and_sync_writers_give_identical_digests(tmp_path):
    tr = _trainer(velocity="bfloat16")
    tree = tr.checkpoint_tree(_filled_state(tr))
    reg = MetricsRegistry()
    w = ckpt.AsyncCheckpointWriter(registry=reg)
    try:
        w.submit(ckpt.save, str(tmp_path / "a"), tree, step=3,
                 extra={"n_devices": 1})
        w.wait()
    finally:
        w.close()
    ckpt.save(str(tmp_path / "s"), tree, step=3, extra={"n_devices": 1})
    ma, ms = (json.load(open(tmp_path / d / "step-3" / "meta.json"))
              for d in ("a", "s"))
    assert ma["digests"] == ms["digests"] and ma["keys"] == ms["keys"]
    assert ma["ext_dtypes"] == ms["ext_dtypes"]
    assert 'sparknet_checkpoint_writes_total{outcome="ok",scope="snapshot"} 1' \
        in reg.render_prometheus()


def test_async_writer_reraises_a_failed_write(tmp_path):
    w = ckpt.AsyncCheckpointWriter()

    def boom():
        raise OSError("disk full")

    w.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    w.close()


# -- the state boundary -----------------------------------------------------


@pytest.mark.parametrize("velocity", ["float32", "bfloat16"])
def test_checkpoint_tree_round_trips_the_state_bit_for_bit(tmp_path,
                                                           velocity):
    tr = _trainer(velocity=velocity)
    state = _filled_state(tr)
    tree = tr.checkpoint_tree(state)
    assert list(tree) == ["params", "momentum", "it"]
    assert tree["params"]["conv1"]["w"].shape == (1, 5, 5, 3, 32)  # HWIO
    assert tree["params"]["ip1"]["w"].shape == (1, 1024, 64)  # (in, out)
    want_p = state.flat_params.detach().clone()
    want_m = state.flat_momentum.clone()
    with torch.no_grad():  # the snapshot owns its bytes
        state.flat_params.add_(1.0)
        state.flat_momentum.add_(1.0)
    ckpt.save(str(tmp_path), tree, step=5, extra={"n_devices": 1, "tp": 1})
    flat, step, extra = ckpt.restore_flat(str(tmp_path))
    back = tr.state_from_checkpoint(flat, extra)
    assert step == 5 and back.it == 7
    assert torch.equal(back.flat_params, want_p)
    assert back.flat_momentum.dtype == want_m.dtype
    assert torch.equal(back.flat_momentum, want_m)


def test_port_step_verifies_and_restores_equal_in_the_jax_store(tmp_path):
    tr = _trainer(velocity="bfloat16")
    ckpt.save(str(tmp_path), tr.checkpoint_tree(_filled_state(tr)), step=2,
              extra={"n_devices": 1, "tp": 1})
    assert jck.verify(str(tmp_path / "step-2"))
    mine, s1, e1 = ckpt.restore_flat(str(tmp_path))
    theirs, s2, e2 = jck.restore_flat(str(tmp_path))
    assert (s1, e1) == (s2, e2)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert _bits(mine[k]) == _bits(theirs[k]), k
    assert _bits(mine["momentum/conv1/w"])[0] == "bfloat16"
    meta = json.load(open(tmp_path / "step-2" / "meta.json"))
    assert meta["ext_dtypes"] == {k: "bfloat16" for k in mine
                                  if k.startswith("momentum/")}


def test_jax_bfloat16_step_restores_equal_in_the_port(tmp_path):
    import ml_dtypes
    r = np.random.default_rng(3)
    tree = {"momentum": {"ip": {"w": r.standard_normal((2, 4, 3)).astype(
                ml_dtypes.bfloat16)}},
            "it": np.asarray([4, 4], np.int32)}
    jck.save(str(tmp_path), tree, step=4)
    assert ckpt.verify(str(tmp_path / "step-4"))
    mine, _, _ = ckpt.restore_flat(str(tmp_path))
    theirs, _, _ = jck.restore_flat(str(tmp_path))
    for k in theirs:
        assert _bits(mine[k]) == _bits(theirs[k]), k


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """cifar10_quick steps the JAX package wrote: 2 rounds on a mesh of
    one, and on a mesh of two with checkpoint_sharded="off"."""
    root = tmp_path_factory.mktemp("jaxck")
    write_synthetic(str(root / "cifar"), n_per_file=100)
    out = {}
    for n in (1, 2):
        cfg = jax_cifar_app.default_config().with_overrides(
            "max_rounds=2", "tau=2", "local_batch=4", "eval_every=0",
            f"data_dir={root / 'cifar'}", f"workdir={root / f'w{n}'}",
            f"checkpoint_dir={root / f'ck{n}'}", "checkpoint_every=2",
            f"n_devices={n}", "trainer_impl=shard_map",
            "checkpoint_sharded=off", "checkpoint_async=false")
        spec = jax_resolve_spec(cfg, data=(4, 3, 32, 32), label=(4, 1))
        jax_train(cfg, spec, *jax_cifar_app.build_datasets(cfg))
        out[n] = str(root / f"ck{n}")
    return out


@pytest.mark.parametrize("world", [1, 2])
def test_jax_step_loads_into_each_rank_exactly(jax_steps, world):
    assert jck.latest_step(jax_steps[world]) == 2
    flat, step, extra = ckpt.restore_flat(jax_steps[world])
    assert extra["n_devices"] == world and "shards" not in extra
    rows = []
    for rank in range(world):
        tr = _trainer(rank, world, batch=4)
        st = tr.state_from_checkpoint(flat, extra)
        assert st.it == int(flat["it"][rank]) == 4
        for kind, tree in (("params", st.params), ("momentum", st.momentum)):
            conv = params_to_jax(tr.net, tree)
            for l, lp in conv.items():
                for p, a in lp.items():
                    np.testing.assert_array_equal(
                        a, flat[f"{kind}/{l}/{p}"][rank])
        rows.append(st.flat_momentum)
    if world == 2:  # each rank took its own row, and the rows differ
        assert not torch.equal(rows[0], rows[1])


def test_a_checkpoint_of_another_topology_names_elastic_resize(jax_steps):
    """Another world size takes the elastic resize (`adapt_state`): the
    params of row 0 exactly, every rank the same momentum
    reconstruction. Another tp or layout still raises, naming the
    trainers that are not ported (ROADMAP A11)."""
    flat, _, extra = ckpt.restore_flat(jax_steps[2])
    tr = _trainer(0, 1, batch=4)
    st = tr.state_from_checkpoint(flat, extra)
    assert st.it == 4
    conv = {kind: params_to_jax(tr.net, getattr(st, kind))
            for kind in ("params", "momentum")}
    for l, lp in conv["params"].items():
        for p, a in lp.items():
            np.testing.assert_array_equal(a, flat[f"params/{l}/{p}"][0])
            np.testing.assert_array_equal(
                conv["momentum"][l][p], reduce_momentum_rows(
                    flat[f"momentum/{l}/{p}"], "norm_rescale"))
    with pytest.raises(ValueError, match="A11"):
        _trainer(0, 2, batch=4).state_from_checkpoint(
            flat, dict(extra, layout="logical"))
    with pytest.raises(ValueError, match="A11"):
        _trainer(0, 1, batch=4).state_from_checkpoint(flat,
                                                      dict(extra, tp=2))
    with pytest.raises(ValueError, match="velocity_dtype"):
        _trainer(0, 2, velocity="bfloat16", batch=4).state_from_checkpoint(
            flat, extra)
