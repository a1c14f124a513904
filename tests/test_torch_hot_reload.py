"""Checkpoint hot reload of the port's serving manager against the JAX
package's.

Two stores are written by the two train loops — the JAX package's
`train` (its `checkpoint.save` of the trainer state) and the port's
`run_loop` — lenet, batch 16, τ = 2, 2 rounds, a step every 2 rounds.
Both packages' managers (and servers) watch each store:

- both install the same step, and both servers' answers then agree
  within atol 1e-5 (the convolutions' sum order differs between the
  packages); the port's installed weights equal the step's bit for bit;
- a step with one value flipped at rest (a valid archive, a wrong
  digest) is rejected by both and cooled down; serving stays on the good
  step;
- a step that vanished between listing and fetch is not a rejection in
  either (`CheckpointVanishedError`), and no step cools down;
- a store outage (the fake GCS and S3 of `tests/fake_stores.py`, stopped)
  counts `store_error` in both, cools nothing down, and reschedules the
  poll inside one interval;
- per-shard steps, the port's and the JAX package's, install under
  traffic with no failed request; a torn per-shard write (its shards
  there, meta.json not yet) is skipped until meta.json commits;
- the same seed gives the port the same jitter schedule, and it is the
  JAX manager's under the same random stream.
Reload timing is driven with `poll(now=...)` where it matters; waits on
the worker thread are bounded.
"""
import contextlib
import json
import os
import random
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from fake_stores import bucket_store, corrupt_npz_bytes, stop_serving
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from sparknet_tpu.net_api import JaxNet
from sparknet_tpu.obs import MetricsRegistry as JaxRegistry
from sparknet_tpu.serve.model_manager import ModelManager as JaxManager
from sparknet_tpu.serve.server import InferenceServer as JaxServer
from sparknet_tpu.serve.server import ServeConfig as JaxServeConfig
from sparknet_tpu.utils import checkpoint as jck
from sparknet_tpu.utils.config import RunConfig as JaxRunConfig
from sparknet_tpu.utils.logger import Logger as JaxLogger
from sparknet_tpu.zoo import lenet as jax_lenet

from sparknet_tpu_torch import zoo
from sparknet_tpu_torch.apps.train_loop import train
from sparknet_tpu_torch.data import gcs, s3
from sparknet_tpu_torch.data.dataset import ArrayDataset
from sparknet_tpu_torch.model.net import params_to_jax
from sparknet_tpu_torch.net_api import TorchNet
from sparknet_tpu_torch.obs.registry import MetricsRegistry
from sparknet_tpu_torch.serve.model_manager import ModelManager
from sparknet_tpu_torch.serve.server import InferenceServer, ServeConfig
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils.config import RunConfig
from sparknet_tpu_torch.utils.logger import Logger

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """{"jax": dir, "port": dir}: step 2 of each package's train loop."""
    r = np.random.default_rng(0)
    data = {"data": r.standard_normal((64, 1, 28, 28)).astype(np.float32),
            "label": r.integers(0, 10, (64, 1)).astype(np.int32)}
    out = {}
    for k in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(f"train_{k}"))
        common = dict(model="lenet", local_batch=16, tau=2, max_rounds=2,
                      eval_every=0, workdir=root,
                      checkpoint_dir=os.path.join(root, "ck"),
                      checkpoint_every=2, checkpoint_sharded="off")
        log_kw = dict(echo=False, jsonl_path=os.path.join(root, "m.jsonl"))
        if k == "port":
            train(RunConfig(**common), zoo.lenet(batch=16),
                  ArrayDataset(data), None, logger=Logger(**log_kw),
                  device="cpu")
        else:
            jax_train(JaxRunConfig(n_devices=1, trainer_impl="shard_map",
                                   **common),
                      jax_lenet(batch=16), JaxArrayDataset(data), None,
                      logger=JaxLogger(**log_kw))
        out[k] = os.path.join(root, "ck")
        assert ckpt.latest_step(out[k]) == 2
    return out


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _example(i):
    r = np.random.default_rng(500 + i)
    return {"data": r.standard_normal((28, 28, 1)).astype(np.float32)}


def _managers(d, poll_interval_s=0.0, **kw):
    """{package: manager} over fresh lenet nets watching `d`."""
    return {"port": ModelManager(TorchNet(zoo.lenet(batch=4), device="cpu"),
                                 checkpoint_dir=d,
                                 poll_interval_s=poll_interval_s, **kw),
            "jax": JaxManager(JaxNet(jax_lenet(batch=4)), checkpoint_dir=d,
                              poll_interval_s=poll_interval_s, **kw)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_servers_install_the_step_and_agree(stores, writer):
    d = stores[writer]
    cfg = dict(max_batch=4, max_wait_ms=2.0, outputs=("prob",),
               checkpoint_dir=d, metrics_every_batches=0)
    xs = [_example(i) for i in range(6)]
    tnet = TorchNet(zoo.lenet(batch=4), device="cpu")
    with JaxServer(JaxNet(jax_lenet(batch=4)), JaxServeConfig(**cfg)) as js:
        assert js.manager.step == 2
        want = [js.infer(x)["prob"] for x in xs]
    with InferenceServer(tnet, ServeConfig(**cfg)) as srv:
        assert srv.manager.step == 2
        assert srv.status()["model_step"] == 2
        got = [srv.infer(x)["prob"] for x in xs]
        fresh = srv.manager.freshness_s()
        assert fresh is not None and fresh >= 0.0
        assert srv.manager.step_lag() == 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    # the installed weights are the step's, bit for bit
    flat, _, _ = ckpt.restore_flat(d, step=2)
    mine = params_to_jax(tnet.net, tnet.params)
    for lname, lp in mine.items():
        for pname, v in lp.items():
            stored = np.asarray(flat[f"params/{lname}/{pname}"])
            stored = stored[0] if stored.ndim == v.ndim + 1 else stored
            np.testing.assert_array_equal(v, stored)


def _publish_corrupt(d, tmp_path, step):
    """A copy of step 2 as `step`, one value flipped at rest (the zip
    stays valid, the digest does not match), staged then renamed in."""
    flat, _, extra = ckpt.restore_flat(d, step=2)
    stage = tmp_path / f"stage{step}"
    path = ckpt.save(str(stage), flat, step=step)
    npz = os.path.join(path, "state.npz")
    with open(npz, "rb") as f:
        raw = f.read()
    with open(npz, "wb") as f:
        f.write(corrupt_npz_bytes(raw))
    os.rename(path, os.path.join(d, f"step-{step}"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_flipped_value_is_rejected_by_both(stores, tmp_path, writer):
    d = _copy(stores[writer], tmp_path / "ck")
    mgrs = _managers(d)
    for m in mgrs.values():
        assert m.load_initial() == 2
    _publish_corrupt(d, tmp_path, 4)
    t0 = time.monotonic()
    for k, m in mgrs.items():
        assert m.poll(now=t0) is False, k
        assert m.step == 2 and m.swap_failures == 1, k
        assert "corrupt" in m.last_error and 4 in m._bad, k
        # cooled down: the next poll does not fetch it again
        assert m.poll(now=t0 + 1e-3) is False and m.swap_failures == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_vanished_step_is_not_a_rejection(stores, tmp_path, writer,
                                            monkeypatch):
    d = _copy(stores[writer], tmp_path / "ck")
    mgrs = _managers(d)
    for m in mgrs.values():
        assert m.load_initial() == 2
    # the listing says 6; by the fetch it is gone (retain pruned it)
    for mod in (ckpt, jck):
        monkeypatch.setattr(mod, "latest_step", lambda _d: 6)
    for k, m in mgrs.items():
        assert m.poll(now=time.monotonic()) is False
        assert m.step == 2 and m.swap_failures == 0 and m._bad == {}, k
        assert "vanished" in m.last_error, k


def test_the_race_between_listing_a_step_and_reading_it(tmp_path,
                                                       monkeypatch):
    """`CheckpointVanishedError` (a CheckpointCorruptError): a listed
    step deleted before its meta.json is read, and one deleted between
    the meta.json read and the state.npz read. Only a missing state under
    a still-present meta.json is corruption."""
    d = str(tmp_path / "ck")
    for s in (1, 2, 3):
        ckpt.save(d, {"w": np.full(4, s, np.float32)}, step=s)
    listed = ckpt._list_steps(d)
    assert listed == [1, 2, 3]
    shutil.rmtree(os.path.join(d, "step-3"))
    with pytest.raises(ckpt.CheckpointVanishedError, match="meta.json"):
        ckpt.restore_flat(d, step=listed[-1])
    # the JAX package raises the same type for the same race
    with pytest.raises(jck.CheckpointVanishedError):
        jck.restore_flat(d, step=3)
    assert issubclass(ckpt.CheckpointVanishedError,
                      ckpt.CheckpointCorruptError)
    # deleted while being read: meta.json seen, then the whole step gone
    real = ckpt._load_meta
    calls = []

    def meta_then_delete(path):
        meta = real(path)
        if not calls:
            calls.append(path)
            shutil.rmtree(path)
        return meta

    monkeypatch.setattr(ckpt, "_load_meta", meta_then_delete)
    with pytest.raises(ckpt.CheckpointVanishedError, match="deleted while"):
        ckpt.restore_flat(d, step=2)
    monkeypatch.setattr(ckpt, "_load_meta", real)
    # state.npz missing under a committed meta.json: corrupt, not gone
    os.remove(os.path.join(d, "step-1", "state.npz"))
    with pytest.raises(ckpt.CheckpointCorruptError) as e:
        ckpt.restore_flat(d, step=1)
    assert not isinstance(e.value, ckpt.CheckpointVanishedError)


def _clear_port_caches():
    for m in (gcs, s3):
        m._CLIENTS.clear()
        m._SIZE_CACHE.clear()
        m._STAT_CACHE.clear()


@contextlib.contextmanager
def _bucket(kind, monkeypatch):
    with bucket_store(kind) as (url, srv):
        _clear_port_caches()
        monkeypatch.setattr(gcs, "BACKOFF_S", 0.01)
        try:
            yield url, srv
        finally:
            _clear_port_caches()


@pytest.mark.parametrize("kind", ["gs", "s3"])
def test_a_store_outage_is_a_store_error_in_both(stores, kind,
                                                 monkeypatch):
    flat, step, _ = ckpt.restore_flat(stores["port"], step=2)
    regs = {"port": MetricsRegistry(), "jax": JaxRegistry()}
    with _bucket(kind, monkeypatch) as (url, srv):
        d = f"{url}/ck"
        ckpt.save(d, flat, step=1)
        mgrs = {"port": ModelManager(TorchNet(zoo.lenet(batch=4),
                                              device="cpu"),
                                     checkpoint_dir=d, poll_interval_s=5.0,
                                     registry=regs["port"]),
                "jax": JaxManager(JaxNet(jax_lenet(batch=4)),
                                  checkpoint_dir=d, poll_interval_s=5.0,
                                  registry=regs["jax"])}
        for m in mgrs.values():
            assert m.load_initial() == 1
        ckpt.save(d, flat, step=2)
        stop_serving(srv)
        srv.server_close()
        t0 = time.monotonic()
        for k, m in mgrs.items():
            assert m.poll(now=t0) is False, k
    for k, m in mgrs.items():
        assert m.step == 1 and m.swap_failures == 0 and m._bad == {}, k
        assert t0 <= m._next_poll <= t0 + 5.0, k
        text = regs[k].render_prometheus()
        assert 'outcome="store_error"} 1' in text, k
        assert 'outcome="rejected"' not in text, k


def test_a_transient_fetch_error_then_the_same_step_installs(
        stores, tmp_path, monkeypatch):
    d = _copy(stores["port"], tmp_path / "ck")
    m = _managers(d, poll_interval_s=2.0)["port"]
    assert m.load_initial() == 2
    flat, _, _ = ckpt.restore_flat(d, step=2)
    ckpt.save(d, flat, step=3)
    real, tries = ckpt.restore_flat, []

    def flaky(*a, **kw):
        if not tries:
            tries.append(1)
            raise TimeoutError("store busy")
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "restore_flat", flaky)
    t0 = time.monotonic()
    assert m.poll(now=t0) is False
    assert m.step == 2 and m.swap_failures == 0 and m._bad == {}
    assert "busy" in m.last_error and t0 <= m._next_poll <= t0 + 2.0
    assert m.poll(now=m._next_poll + 1e-3) is True and m.step == 3


def _scaled_rows(flat, scale, rows):
    """The step's params as `rows` replica rows, scaled: {key: [rows, ...]}."""
    out = {}
    for k, v in flat.items():
        if k.startswith("params/"):
            a = np.asarray(v)[:1] * np.float32(scale)
            out[k] = np.ascontiguousarray(np.broadcast_to(
                a, (rows,) + a.shape[1:]))
    return out


def _installed_is(tnet, rows):
    mine = params_to_jax(tnet.net, tnet.params)
    for lname, lp in mine.items():
        for pname, v in lp.items():
            np.testing.assert_array_equal(
                v, rows[f"params/{lname}/{pname}"][0])


def test_a_per_shard_step_installs_under_traffic(stores, tmp_path):
    """Per-shard steps — one the port writes (a world of one) and one the
    JAX package writes (`fetch_state_shards` on a mesh of 2) — install
    while 2 client threads keep requesting: the weights are the step's,
    bit for bit, and no request fails."""
    import threading

    from jax.sharding import NamedSharding, PartitionSpec as P
    from sparknet_tpu.parallel.mesh import fetch_state_shards, make_mesh
    from sparknet_tpu_torch.parallel.mesh import plan_state_shards
    d = _copy(stores["port"], tmp_path / "ck")
    flat, _, _ = ckpt.restore_flat(d, step=2)
    cfg = ServeConfig(max_batch=4, max_wait_ms=2.0, outputs=("prob",),
                      checkpoint_dir=d, poll_interval_s=0.0,
                      metrics_every_batches=0)
    tnet = TorchNet(zoo.lenet(batch=4), device="cpu")
    with InferenceServer(tnet, cfg) as srv:
        assert srv.manager.step == 2
        before = srv.infer(_example(0))["prob"]
        stop, answered, errors = threading.Event(), [0], []

        def client(i):
            while not stop.is_set():
                try:
                    srv.infer(_example(i))
                    answered[0] += 1
                except Exception as e:  # a failed request fails the test
                    errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        try:
            port_rows = _scaled_rows(flat, 0.5, 1)
            ckpt.save_sharded(d, plan_state_shards(
                port_rows, rank=0, world=1), step=8)
            mesh = make_mesh(2)
            jax_rows = _scaled_rows(flat, 0.25, 2)
            tree = {"params": {}}
            for k, a in jax_rows.items():
                _, l, pn = k.split("/")
                tree["params"].setdefault(l, {})[pn] = jax.device_put(
                    a, NamedSharding(mesh, P("data")))
            for step, rows, writer in (
                    (8, port_rows, None),
                    (9, jax_rows, lambda: jck.save_sharded(
                        d, fetch_state_shards(tree, mesh), step=9))):
                if writer is not None:
                    writer()
                assert "shards" in json.load(open(os.path.join(
                    d, f"step-{step}", "meta.json")))
                deadline = time.monotonic() + 60
                while srv.manager.step != step:
                    assert time.monotonic() < deadline, \
                        f"step {step} never installed"
                    time.sleep(0.005)
                _installed_is(tnet, rows)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert not errors and answered[0] > 0
        assert srv.manager.swap_failures == 0
        assert srv.status()["requests_failed"] == 0
        after = srv.infer(_example(0))["prob"]
        assert not np.array_equal(after, before)


def test_a_torn_per_shard_write_is_skipped_until_meta_commits(stores,
                                                              tmp_path):
    """A poll that lands inside a per-shard save (the shard files there,
    meta.json not yet) sees no checkpoint: no install, no rejection, no
    cooldown; once meta.json lands, the same poll path installs it."""
    from sparknet_tpu_torch.parallel.mesh import plan_state_shards
    d = _copy(stores["port"], tmp_path / "ck")
    flat, _, _ = ckpt.restore_flat(d, step=2)
    tnet = TorchNet(zoo.lenet(batch=4), device="cpu")
    m = ModelManager(tnet, checkpoint_dir=d, poll_interval_s=0.0)
    assert m.load_initial() == 2
    rows = _scaled_rows(flat, 0.25, 1)
    stage = str(tmp_path / "stage")
    ckpt.save_sharded(stage, plan_state_shards(rows, rank=0, world=1),
                      step=9)
    src, dst = os.path.join(stage, "step-9"), os.path.join(d, "step-9")
    os.makedirs(dst)
    for f in os.listdir(src):
        if f != "meta.json":  # the commit marker stays out
            shutil.copy(os.path.join(src, f), os.path.join(dst, f))
    with pytest.warns(RuntimeWarning, match="meta.json"):
        assert m.poll() is False
    assert m.step == 2 and m.swap_failures == 0 and m._bad == {}
    shutil.copy(os.path.join(src, "meta.json"), os.path.join(dst,
                                                             "meta.json"))
    assert m.poll() is True and m.step == 9
    _installed_is(tnet, rows)


def test_the_same_seed_gives_the_same_jitter_schedule(stores):
    d = stores["port"]
    net = TorchNet(zoo.lenet(batch=4), device="cpu")

    def schedule(m, n=6):
        out, now = [], 100.0
        for _ in range(n):
            m._schedule_next_poll(now)
            out.append(m._next_poll)
            now = m._next_poll
        return out

    a = schedule(ModelManager(net, checkpoint_dir=d, poll_interval_s=10.0,
                              poll_jitter=0.4, seed=5))
    b = schedule(ModelManager(net, checkpoint_dir=d, poll_interval_s=10.0,
                              poll_jitter=0.4, seed=5))
    c = schedule(ModelManager(net, checkpoint_dir=d, poll_interval_s=10.0,
                              poll_jitter=0.4, seed=6))
    assert a == b != c
    # the JAX manager's formula under the same random stream
    jm = JaxManager(JaxNet(jax_lenet(batch=4)), checkpoint_dir=d,
                    poll_interval_s=10.0, poll_jitter=0.4)
    jm._rng = random.Random(5)
    assert schedule(jm) == a
    # spread within ± jitter, and the exact interval without jitter
    first = [ModelManager(net, checkpoint_dir=d, poll_interval_s=10.0,
                          poll_jitter=0.4, seed=s) for s in range(8)]
    for m in first:
        m.poll(now=100.0)
    nexts = [m._next_poll for m in first]
    assert all(106.0 <= t <= 114.0 for t in nexts) and len(set(nexts)) == 8
    plain = ModelManager(net, checkpoint_dir=d, poll_interval_s=10.0)
    plain.poll(now=100.0)
    assert plain._next_poll == 110.0
    errs = []
    for cls, n in ((ModelManager, net),
                   (JaxManager, JaxNet(jax_lenet(batch=4)))):
        with pytest.raises(ValueError) as e:
            cls(n, checkpoint_dir=d, poll_jitter=1.0)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
