"""A world over several machines: four gloo ranks spawned as two machines
of two (`LOCAL_WORLD_SIZE=2`, `tests/torch_multimachine_worker.py`),
against the JAX package built in this process, on the CPU.

The corpus: 8 train shards of 3 JPEGs and 3 val shards of 4, written by
`write_synthetic_shards`; the tiny LRN + MAX-pool net of
`test_torch_imagenet.py` at crop 32, local batch 2, τ = 2, float32, from
the JAX package's init.
- `machine_topology` places rank r on machine r // 2, local rank r % 2.
- Streaming (`--stream always`, `ingest_sources=2`): each rank's raw
  rounds and cursors equal block `local_rank` of the JAX
  `make_parallel_source` of its machine's shards (`host_shards`, 4
  readers: the JAX-equivalent setting), bit for bit; the checkpoint's
  `extra["stream"]` after two trained rounds is the two JAX hosts' rows.
- The combined mean image, streamed and cached, is within 1 float32 ulp
  of the whole corpus's `compute_mean_image`, the same on every rank.
- Eval: machine 0 holds val shards 0 and 2 (8 images), machine 1 shard 1
  (4); every rank keeps the first 4 of its machine's.
- Cached (`--stream never`): the four ranks' two rounds equal a JAX mesh
  of four devices fed both machines' host shards — each machine's
  `RoundSampler` of two workers, preprocessed per machine, concatenated
  in machine order: losses within rtol 1e-4, params and momentum within
  1e-4 × max |JAX| + 1e-6 (the tolerances of `test_torch_resume.py`).
- The CIFAR, MNIST and adult apps: each rank hands `train()` its
  machine's `host_shard` of the set, equal to the JAX app's for that host
  bit for bit (the machines' shares are disjoint). CIFAR's two rounds
  (cifar10_quick, local batch 5, τ = 2) equal a JAX mesh of four devices
  fed both machines' samplers, within the same tolerances; the test
  accuracies over both machines' halves count the same correct examples
  (the float32 ratios, weighted in another order, within 1e-6).
- The default layout (`checkpoint_sharded="auto"`): the same CIFAR world
  writes per-shard steps to a fake `gs://` bucket, one shard file per
  rank from both machines, which restore bit for bit to the monolithic
  step of the run above.
"""
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sparknet_tpu.apps import cifar_app as jax_cifar_app
from sparknet_tpu.apps import imagenet_app as jax_app
from sparknet_tpu.apps import mnist_app as jax_mnist_app
from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve_spec
from sparknet_tpu.apps.train_loop import train as jax_train
from sparknet_tpu.data import imagenet as jax_imagenet
from sparknet_tpu.data.adult import AdultLoader as JaxAdultLoader
from sparknet_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from sparknet_tpu.data.dataset import RoundSampler as JaxRoundSampler
from sparknet_tpu.data.preprocess import ImagePreprocessor as JaxPre
from sparknet_tpu.data.streaming import make_parallel_source
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.schema import Field as JaxField
from sparknet_tpu.schema import Schema as JaxSchema
from sparknet_tpu.utils import checkpoint as jck

from fake_stores import bucket_store

import torch_multimachine_worker
from sparknet_tpu_torch.apps import cifar_app, imagenet_app
from sparknet_tpu_torch.apps.train_loop import resolve_spec
from sparknet_tpu_torch.data import adult, cifar, imagenet, mnist
from sparknet_tpu_torch.data.preprocess import compute_mean_image
from sparknet_tpu_torch.model.net import CompiledNet, params_from_jax
from sparknet_tpu_torch.utils import checkpoint as ckpt
from test_torch_imagenet import NET
from test_torch_train import jax_params

torch.set_num_threads(2)
SPAWN_TIMEOUT_S = 240
WORLD, LOCAL = 4, 2
LB, TAU = 2, 2
OVERRIDES = ("crop=32", f"local_batch={LB}", f"tau={TAU}", "max_rounds=2",
             "eval_every=2", "eval_batch=4", "n_classes=4",
             "precision=float32", "ingest_sources=2", "checkpoint_every=2",
             "checkpoint_sharded=off", "checkpoint_async=false", "seed=0",
             'solver={"base_lr": 0.001, "momentum": 0.9, '
             '"lr_policy": "fixed"}')
CIFAR_LB = 5
N_TEST = 100  # cifar.write_synthetic's test file
CIFAR_OVERRIDES = ("max_rounds=2", f"tau={TAU}", f"local_batch={CIFAR_LB}",
                   "eval_every=1", "eval_batch=20", "checkpoint_every=2",
                   "checkpoint_sharded=off", "checkpoint_async=false")


def _start(tspec, jspec):
    """The JAX package's init as the port's numpy param tree."""
    start = params_from_jax(CompiledNet.compile(tspec),
                            jax_params(JaxCompiledNet.compile(jspec)),
                            torch.device("cpu"))
    return {l: {p: t.numpy() for p, t in lp.items()}
            for l, lp in start.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The corpus, the four ranks' results and the JAX init."""
    d = tmp_path_factory.mktemp("multimachine")
    data = d / "data"
    imagenet.write_synthetic_shards(str(data), n_shards=8, per_shard=3,
                                    n_classes=4, size=40, seed=11)
    imagenet.write_synthetic_shards(str(data), n_shards=3, per_shard=4,
                                    n_classes=4, size=40, seed=12,
                                    prefix="val")
    (d / "tiny.prototxt").write_text(NET)
    overrides = (*OVERRIDES, f"model={d / 'tiny.prototxt'}")
    shapes = dict(data=(LB, 3, 32, 32), label=(LB, 1))
    jspec = jax_resolve_spec(jax_app.default_config().with_overrides(
        *overrides), **shapes)
    tspec = resolve_spec(imagenet_app.default_config().with_overrides(
        *overrides), **shapes)
    cifar.write_synthetic(str(d / "cifar"), n_per_file=N_TEST)
    mnist.write_synthetic(str(d / "mnist"), n_train=256, n_test=64)
    adult.write_synthetic(str(d / "adult.data"), n=200)
    cshapes = dict(data=(CIFAR_LB, 3, 32, 32), label=(CIFAR_LB, 1))
    apps = {"cifar": str(d / "cifar"), "mnist": str(d / "mnist"),
            "adult": str(d / "adult.data"),
            "cifar_overrides": CIFAR_OVERRIDES,
            "cifar_params": _start(
                resolve_spec(cifar_app.default_config().with_overrides(
                    *CIFAR_OVERRIDES), **cshapes),
                jax_resolve_spec(jax_cifar_app.default_config()
                                 .with_overrides(*CIFAR_OVERRIDES),
                                 **cshapes))}
    out = d / "out"
    out.mkdir()
    ctx = mp.spawn(torch_multimachine_worker.run,
                   args=(WORLD, LOCAL, str(d / "store"),
                         _start(tspec, jspec), str(data), overrides,
                         str(out), apps),
                   nprocs=WORLD, join=False)
    deadline = SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        deadline -= 5
        if deadline <= 0:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the four ranks did not finish in "
                        f"{SPAWN_TIMEOUT_S} s")
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"dir": d, "data": data, "out": out, "ranks": ranks,
            "overrides": overrides, "apps": apps}


def _host_shards(data, prefix, m):
    return jax_imagenet.host_shards(
        jax_imagenet.list_shards(str(data), prefix), m, WORLD // LOCAL)


def _jax_host_source(data, m):
    labels = jax_imagenet.load_label_map(str(data / "train.txt"))
    return make_parallel_source(_host_shards(data, "train.", m), labels,
                                LOCAL, LB, TAU, 2 * LOCAL)


def test_each_rank_knows_its_machine(world):
    assert [r["topology"] for r in world["ranks"]] == [
        (0, 2, 0, 2), (0, 2, 1, 2), (1, 2, 0, 2), (1, 2, 1, 2)]


def test_streamed_rounds_are_the_jax_hosts_blocks(world):
    for m in range(WORLD // LOCAL):
        with _jax_host_source(world["data"], m) as src:
            want = [src.next_round(round_index=r) for r in range(3)]
            want = [({k: v.copy() for k, v in b.items()},
                     src.cursor_at(r)) for r, b in enumerate(want)]
        for l in range(LOCAL):
            got = world["ranks"][m * LOCAL + l]
            assert len(got["readers"]) == 2  # ingest_sources=2 a rank
            for r, (b, cur) in enumerate(want):
                for k in b:
                    np.testing.assert_array_equal(
                        got["stream_rounds"][r][k],
                        b[k][:, l * LB:(l + 1) * LB], err_msg=f"{m} {l} {r}")
                assert got["stream_cursors"][r] == cur[l * 2:(l + 1) * 2]


def test_the_streamed_checkpoint_holds_the_jax_hosts_rows(world):
    want = []
    for m in range(WORLD // LOCAL):
        with _jax_host_source(world["data"], m) as src:
            for r in range(2):
                src.next_round(round_index=r)
            want.append([[s, e, ep] for (s, e), ep in src.cursor_at(1)])
    _, step, extra = ckpt.restore_flat(str(world["out"] / "ck_stream"))
    assert step == 2 and extra["stream"] == want
    assert extra["n_devices"] == WORLD


def test_the_combined_mean_is_the_whole_corpus_mean(world):
    loader = imagenet.ShardedTarLoader(
        imagenet.list_shards(str(world["data"]), "train."),
        imagenet.load_label_map(str(world["data"] / "train.txt")))
    images, _ = loader.load_all()
    want = compute_mean_image(images)
    for key in ("stream_mean", "cached_mean"):
        means = [r[key] for r in world["ranks"]]
        for got in means:
            np.testing.assert_array_equal(got, means[0])
        np.testing.assert_array_max_ulp(means[0], want, maxulp=1)


def test_eval_is_cut_to_the_smallest_machine(world):
    labels = jax_imagenet.load_label_map(str(world["data"] / "val.txt"))
    for r, got in enumerate(world["ranks"]):
        m = r // LOCAL
        want = jax_imagenet.ShardedTarLoader(
            _host_shards(world["data"], "val.", m), labels).load_all()
        assert len(want[0]) == (8 if m == 0 else 4)
        assert len(got["test"]["data"]) == 4
        np.testing.assert_array_equal(got["test"]["data"], want[0][:4])
        np.testing.assert_array_equal(got["test"]["label"][:, 0],
                                      want[1][:4])


class _Machines:
    """The JAX package's view of the two machines in one process: each
    machine's cached round (its RoundSampler of two workers, its
    preprocessing keyed (seed, round, slice)), concatenated in machine
    order on the batch axis of a mesh of four."""

    def __init__(self, data, pp):
        self.samplers = []
        for m in range(WORLD // LOCAL):
            cfg = jax_app.default_config().with_overrides(
                f"data_dir={data}")
            images, labels = jax_app.load_corpus(cfg, "train.", "train.txt",
                                                 host_id=m, host_count=2)
            self.samplers.append(JaxRoundSampler(
                JaxArrayDataset({"data": images, "label": labels[:, None]}),
                LOCAL, LB, TAU, seed=0))
        self.pp = pp

    def next_round(self, round_index=None):
        parts = []
        for s in self.samplers:
            raw = s.next_round(round_index=round_index)
            sl = [self.pp.convert_batch(
                {k: v[t] for k, v in raw.items()}, train=True,
                rng=np.random.default_rng((0, round_index, t)))
                for t in range(TAU)]
            parts.append({k: np.stack([x[k] for x in sl]) for k in sl[0]})
        return {k: np.concatenate([p[k] for p in parts], axis=1)
                for k in parts[0]}


class _AsIs:
    def convert_batch(self, batch, train=True, rng=None):
        return batch


def test_the_cached_world_is_a_jax_mesh_of_four(world, tmp_path):
    mean = world["ranks"][0]["cached_mean"]
    pp = JaxPre(JaxSchema(JaxField("data", "float32", (32, 32, 3)),
                          JaxField("label", "int32", (1,))),
                mean_image=mean, crop=32, seed=0, out_dtype="float32")
    cfg = jax_app.default_config().with_overrides(
        *world["overrides"], "n_devices=4", "trainer_impl=shard_map",
        "eval_every=0", f"workdir={tmp_path}",
        f"checkpoint_dir={tmp_path / 'ck'}")
    spec = jax_resolve_spec(cfg, data=(LB, 3, 32, 32), label=(LB, 1))
    jax_train(cfg, spec, _Machines(world["data"], pp), None,
              batch_transform=_AsIs())
    _assert_flat_close(world["out"] / "ck_cached", tmp_path / "ck")
    want = _metric(tmp_path, "loss")
    for r in range(WORLD):
        got = _metric(world["out"] / f"cached_w{r}", "loss")
        assert len(got) == len(want) == 2
        np.testing.assert_allclose(got, want, rtol=1e-4)


def _metric(workdir, key):
    return [json.loads(x)[key] for p in Path(workdir).glob("*.jsonl")
            for x in p.read_text().splitlines() if f'"{key}"' in x]


def _assert_flat_close(got_dir, want_dir):
    jflat, jstep, _ = jck.restore_flat(str(want_dir))
    flat, step, _ = ckpt.restore_flat(str(got_dir))
    assert step == jstep == 2
    for k in jflat:
        g, w = np.asarray(flat[k], np.float64), np.asarray(jflat[k],
                                                           np.float64)
        assert g.shape == w.shape, k
        if k == "it":
            np.testing.assert_array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() + 1e-6, k


def _jax_app_sets(world, app):
    """The JAX app's (train, test) datasets of the whole set."""
    apps = world["apps"]
    if app == "adult":
        full = JaxAdultLoader(apps["adult"]).batch_dict()
        split = max(1, int(len(full["label"]) * 0.8))
        return (JaxArrayDataset({k: v[:split] for k, v in full.items()}),
                JaxArrayDataset({k: v[split:] for k, v in full.items()}))
    mod = {"cifar": jax_cifar_app, "mnist": jax_mnist_app}[app]
    return mod.build_datasets(mod.default_config().with_overrides(
        f"data_dir={apps[app]}"))


@pytest.mark.parametrize("app", ["cifar", "mnist", "adult"])
def test_each_app_trains_on_its_machines_share(world, app):
    train_ds, test_ds = _jax_app_sets(world, app)
    for r, got in enumerate(world["ranks"]):
        for split, ds in (("train", train_ds), ("test", test_ds)):
            want = ds.host_shard(r // LOCAL, WORLD // LOCAL).arrays
            assert sorted(got[app][split]) == sorted(want), (r, split)
            for k in want:
                np.testing.assert_array_equal(got[app][split][k], want[k],
                                              err_msg=f"{app} {r} {split}")
    a, b = (world["ranks"][r][app]["train"]["label"] for r in (0, LOCAL))
    assert len(a) == len(b) == len(train_ds) // 2


class _CifarMachines:
    """Each machine's JAX `host_shard` of the CIFAR train set in NHWC
    under a RoundSampler of two workers, concatenated in machine order on
    the batch axis of a mesh of four."""

    def __init__(self, train_ds):
        self.samplers = []
        for m in range(WORLD // LOCAL):
            mine = train_ds.host_shard(m, WORLD // LOCAL).arrays
            mine = dict(mine, data=np.ascontiguousarray(
                mine["data"].transpose(0, 2, 3, 1)))
            self.samplers.append(JaxRoundSampler(
                JaxArrayDataset(mine), LOCAL, CIFAR_LB, TAU, seed=0))

    def next_round(self, round_index=None):
        parts = [s.next_round(round_index=round_index)
                 for s in self.samplers]
        return {k: np.concatenate([p[k] for p in parts], axis=1)
                for k in parts[0]}


def test_the_cifar_world_is_a_jax_mesh_of_four(world, tmp_path):
    cfg = jax_cifar_app.default_config().with_overrides(
        *CIFAR_OVERRIDES, f"data_dir={world['apps']['cifar']}",
        "n_devices=4", "trainer_impl=shard_map", f"workdir={tmp_path}",
        f"checkpoint_dir={tmp_path / 'ck'}")
    spec = jax_resolve_spec(cfg, data=(CIFAR_LB, 3, 32, 32),
                            label=(CIFAR_LB, 1))
    train_ds, test_ds = jax_cifar_app.build_datasets(cfg)
    jax_train(cfg, spec, _CifarMachines(train_ds), test_ds,
              batch_transform=_AsIs())
    _assert_flat_close(world["out"] / "ck_cifar", tmp_path / "ck")
    want = _metric(tmp_path, "loss")
    want_acc = _metric(tmp_path, "test_accuracy")
    assert len(want) == len(want_acc) == 2
    for r in range(WORLD):
        got = world["out"] / f"cifar_w{r}"
        np.testing.assert_allclose(_metric(got, "loss"), want, rtol=1e-4)
        acc = _metric(got, "test_accuracy")
        np.testing.assert_array_equal(np.rint(np.multiply(acc, N_TEST)),
                                      np.rint(np.multiply(want_acc, N_TEST)))
        np.testing.assert_allclose(acc, want_acc, rtol=0, atol=1e-6)


def test_two_machines_write_per_shard_steps_to_a_bucket(world):
    """Four ranks as two machines, the default layout, the checkpoint
    store on a fake gs:// bucket every rank reaches."""
    overrides = tuple(o for o in CIFAR_OVERRIDES
                      if not o.startswith("checkpoint_sharded"))
    out = world["dir"] / "auto"
    out.mkdir()
    with bucket_store("gs") as (url, _):
        ck = f"{url}/ck_auto"
        ctx = mp.spawn(torch_multimachine_worker.cifar_to,
                       args=(WORLD, LOCAL, str(out / "store"),
                             world["apps"]["cifar_params"],
                             world["apps"]["cifar"], overrides, ck,
                             str(out)),
                       nprocs=WORLD, join=False)
        deadline = SPAWN_TIMEOUT_S
        while not ctx.join(timeout=5):
            deadline -= 5
            if deadline <= 0:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the four ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s")
        meta = json.loads(ckpt._bucket_ops(ck).read(f"{ck}/step-2/meta.json"))
        got, step, extra = ckpt.restore_flat(ck)
        verified = ckpt.verify(f"{ck}/step-2")
    assert meta["format"] == "sharded" and step == 2 and verified
    assert [s["file"] for s in meta["shards"]] == \
        [ckpt.shard_file_name(r, WORLD) for r in range(WORLD)]
    assert extra["n_devices"] == WORLD
    want, _, _ = ckpt.restore_flat(str(world["out"] / "ck_cifar"), step=2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
