"""The port's studies (`sparknet_tpu_torch/scripts/`) against the JAX
package's scripts, and the data-gated recipe runs through the port's apps.

The JAX scripts are imported from `scripts/` as `tests/test_parity.py`
imports them. Weights cross into the port with `params_from_jax`; corpora,
labels, index arrays, crop offsets and mean images are the same numpy data
on both sides. Tolerances:
  - a parity_synth round (W = 4, τ = 3, b = 2) against the JAX round: the
    loss within rel 1e-5, params and every worker's momentum within rtol
    2e-4 / atol 2e-6 (the JAX package's own bands between its two
    programs); the convolutions sum in another order on the two sides;
  - a parity_caffenet round (dropout-free CaffeNet 67/16, b2, size 80,
    W = 2, τ = 2, float32 on both sides) against the JAX round: the loss
    within rel 1e-5, each param tensor within 1e-4 of its largest |JAX|
    value + 1e-7 (the gradient band of `test_torch_train.py`; its pixels
    run to +-156, so absolute errors scale with them);
  - one worker's round against a one-rank `ParallelTrainer.train_round`:
    `torch.equal` (the same ops in the same order);
  - the card-side `prep` against the host's mean subtraction and crop:
    `torch.equal` in float32 and bfloat16;
  - the sharder: byte-equal shards and label files.
The `parity`-marked recipe tests skip unless the datasets are present
under $SPARKNET_TPU_DATA (default `data/`), as the JAX ones do.
"""
import dataclasses
import importlib.util
import json
import os
import sys
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu import CompiledNet as JaxCompiledNet
from sparknet_tpu import zoo as jax_zoo
from sparknet_tpu.solver import SgdSolver as JaxSgdSolver

from sparknet_tpu_torch.data import gcs, s3, synth
from sparknet_tpu_torch.model.net import (CompiledNet, params_from_jax,
                                          params_to_jax)
from sparknet_tpu_torch.parallel.mesh import init_data_group
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.scripts import elastic_momentum_ab, parity_caffenet
from sparknet_tpu_torch.scripts import parity_synth, shard_imagenet
from sparknet_tpu_torch.scripts import soak_stream
from sparknet_tpu_torch.scripts.study import WorkerRounds, cross_iter
from test_torch_train import dropout_free, to_port_spec

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(REPO, "scripts"))

import parity_caffenet as jax_parity_caffenet  # noqa: E402
import parity_synth as jax_parity_synth  # noqa: E402


def _jax_script(name):
    """A JAX script loaded under its own module name (the port has a
    namesake)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_params(jnet, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jnet.init_params(jax.random.PRNGKey(seed)))


def _stacked(params, w):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(jnp.broadcast_to(jnp.asarray(x)[None],
                                               (w,) + x.shape)), params)


def _close_rel(got, want, rtol=2e-4, atol=2e-6, what=""):
    for l in want:
        for p in want[l]:
            np.testing.assert_allclose(got[l][p], np.asarray(want[l][p]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{what}{l}/{p}")


@pytest.fixture
def one_rank(tmp_path):
    group = init_data_group("cpu", store_path=str(tmp_path / "store"),
                            rank=0, world_size=1)
    yield group
    group.close()


def _synth_case(W=4, tau=3, b=2, seed=0):
    r = np.random.default_rng(seed)
    corpus = r.standard_normal((64, 32, 32, 3)).astype(np.float32)
    labels = r.integers(0, 10, (64, 1)).astype(np.int32)
    idx = r.integers(0, 64, (W, tau, b)).astype(np.int32)
    return corpus, labels, idx


# -- parity_synth --------------------------------------------------------------

def test_the_synth_round_is_the_jax_round():
    W, tau, b = 4, 3, 2
    jnet, jsolver = jax_parity_synth.build(batch=b)
    net, cfg = parity_synth.build(batch=b)
    assert cfg == dataclasses.replace(cfg, **{
        f: getattr(jsolver.cfg, f) for f in ("base_lr", "momentum",
                                             "weight_decay", "lr_policy")})
    corpus, labels, idx = _synth_case(W, tau, b)
    jp = _jax_params(jnet)
    stacked = _stacked(jp, W)
    jround = jax_parity_synth.make_round_fn(jnet, jsolver, W, tau, b)
    j_params, j_mom, j_it, j_loss = jround(
        stacked, jax.tree_util.tree_map(jnp.zeros_like, stacked),
        jnp.zeros((), jnp.int32), jnp.asarray(idx), jnp.asarray(corpus),
        jnp.asarray(labels))

    workers = WorkerRounds(net, cfg, W, tau, params_from_jax(net, jp, CPU))
    loss = parity_synth.make_round_fn(workers)(
        torch.from_numpy(idx).long(), torch.from_numpy(corpus),
        torch.from_numpy(labels))
    assert workers.it == int(j_it) == tau
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    _close_rel(params_to_jax(net, workers.params),
               jax.tree_util.tree_map(lambda x: np.asarray(x[0]), j_params))
    for w in range(W):
        _close_rel(params_to_jax(net, workers.momentum[w]),
                   jax.tree_util.tree_map(lambda x: np.asarray(x[w]), j_mom),
                   what=f"momentum[{w}] ")


def test_one_synth_worker_is_the_one_rank_trainers_round(one_rank):
    tau, b = 3, 2
    net, cfg = parity_synth.build(batch=b)
    corpus, labels, idx = _synth_case(1, tau, b, seed=1)
    params = net.init_params(torch.Generator().manual_seed(0), CPU)
    workers = WorkerRounds(net, cfg, 1, tau, params)
    loss = parity_synth.make_round_fn(workers)(
        torch.from_numpy(idx).long(), torch.from_numpy(corpus),
        torch.from_numpy(labels), keys=(0, 0))

    trainer = ParallelTrainer(net, cfg, one_rank, tau=tau)
    state = trainer.state_from_params(params)
    state, t_loss = trainer.train_round(
        state, {"data": corpus[idx[0]], "label": labels[idx[0]]}, (0, 0))
    assert torch.equal(loss, t_loss)
    assert torch.equal(workers.flat, state.flat_params.detach())
    for l, lp in state.momentum.items():
        for p, m in lp.items():
            assert torch.equal(workers.momentum[0][l][p], m), (l, p)
    assert workers.it == state.it == tau


def test_the_synth_run_logs_a_curve_and_every_round_loss():
    r = parity_synth.run(2, 40, seed=0, device="cpu", n_train=2000,
                         n_test=200)
    assert [c["iter"] for c in r["curve"]] == [0, 40]
    assert len(r["round_losses"]) == 4 and r["losses"]["all_finite"]
    assert r["final_loss"] == r["round_losses"][-1]
    assert r["tau"] == parity_synth.TAU and r["workers"] == 2
    assert 0.0 <= r["final_test_accuracy"] <= 1.0


def test_cross_iter_is_the_first_point_at_the_level():
    curve = [{"iter": 0, "a": 0.1}, {"iter": 50, "a": 0.49},
             {"iter": 100, "a": 0.5}, {"iter": 150, "a": 0.9}]
    assert cross_iter(curve, "a") == 100
    assert cross_iter(curve, "a", level=0.95) is None


# -- parity_caffenet -----------------------------------------------------------

def _caffenet_case(W=2, tau=2, b=2, size=80, crop=67, seed=0):
    r = np.random.default_rng(seed)
    corpus = r.integers(0, 256, (32, size, size, 3)).astype(np.uint8)
    labels = r.integers(0, 16, 32).astype(np.int32)
    mean_hwc = r.uniform(100, 156, (size, size, 3)).astype(np.float32)
    idx = r.integers(0, 32, (W, tau, b)).astype(np.int32)
    offs = r.integers(0, size - crop + 1, (W, tau, b, 2)).astype(np.int32)
    return corpus, labels, mean_hwc, idx, offs


def _caffenet_nets(b=2, crop=67):
    spec = dropout_free(jax_zoo.caffenet(batch=b, crop=crop, n_classes=16))
    return (JaxCompiledNet.compile(spec),
            CompiledNet.compile(to_port_spec(spec)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_the_caffenet_round_is_the_jax_round():
    W, tau, crop = 2, 2, 67
    jnet, net = _caffenet_nets(crop=crop)
    corpus, labels, mean_hwc, idx, offs = _caffenet_case(W, tau, crop=crop)
    jp = _jax_params(jnet)
    stacked = _stacked(jp, W)
    jround = jax_parity_caffenet.make_round_fn(
        jnet, JaxSgdSolver(jnet, jax_parity_caffenet.solver_config()), tau,
        crop=crop)
    j_params, _, j_it, j_loss = jround(
        stacked, jax.tree_util.tree_map(jnp.zeros_like, stacked),
        jnp.zeros((), jnp.int32), jnp.asarray(idx), jnp.asarray(offs),
        jax.random.split(jax.random.PRNGKey(3), W), jnp.asarray(corpus),
        jnp.asarray(labels), jnp.asarray(mean_hwc))

    workers = WorkerRounds(net, parity_caffenet.solver_config(), W, tau,
                           params_from_jax(net, jp, CPU))
    loss = parity_caffenet.make_round_fn(workers, crop=crop)(
        _t(idx).long(), _t(offs), (3,), _t(corpus), _t(labels),
        _t(mean_hwc))
    assert workers.it == int(j_it) == tau
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    got = params_to_jax(net, workers.params)
    for l, lp in jp.items():
        for p in lp:
            want = np.asarray(j_params[l][p][0])
            err = np.abs(got[l][p] - want).max()
            assert err <= 1e-4 * np.abs(want).max() + 1e-7, (l, p, err)


def test_one_caffenet_worker_with_dropout_is_the_one_rank_trainers_round(
        one_rank):
    """The full CaffeNet spec (dropout on): the study's per-worker
    generators are the trainer's at rank 0, so the masks and the round
    are equal."""
    tau, b, crop = 2, 2, 67
    net = CompiledNet.compile(to_port_spec(
        jax_zoo.caffenet(batch=b, crop=crop, n_classes=16)))
    cfg = parity_caffenet.solver_config()
    corpus, labels, mean_hwc, idx, offs = _caffenet_case(1, tau, crop=crop,
                                                         seed=2)
    params = net.init_params(torch.Generator().manual_seed(0), CPU)
    workers = WorkerRounds(net, cfg, 1, tau, params)
    keys = (1000, 7)
    loss = parity_caffenet.make_round_fn(workers, crop=crop)(
        _t(idx).long(), _t(offs), keys, _t(corpus), _t(labels), _t(mean_hwc))

    data = torch.stack([parity_caffenet.prep(
        _t(corpus), _t(mean_hwc), _t(idx[0, t]).long(), _t(offs[0, t]),
        crop, torch.float32) for t in range(tau)])
    trainer = ParallelTrainer(net, cfg, one_rank, tau=tau)
    state = trainer.state_from_params(params)
    state, t_loss = trainer.train_round(
        state, {"data": data, "label": _t(labels[idx[0]][..., None])}, keys)
    assert torch.equal(loss, t_loss)
    assert torch.equal(workers.flat, state.flat_params.detach())
    # another key draws other masks
    other = WorkerRounds(net, cfg, 1, tau, params)
    parity_caffenet.make_round_fn(other, crop=crop)(
        _t(idx).long(), _t(offs), (1000, 8), _t(corpus), _t(labels),
        _t(mean_hwc))
    assert not torch.equal(other.flat, workers.flat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_prep_is_the_hosts_mean_subtraction_and_crop(dtype):
    crop = 67
    corpus, _, mean_hwc, idx, offs = _caffenet_case(1, 1, b=6, crop=crop,
                                                    seed=3)
    got = parity_caffenet.prep(_t(corpus), _t(mean_hwc), _t(idx[0, 0]),
                               _t(offs[0, 0]), crop, dtype)
    assert got.shape == (6, crop, crop, 3) and got.dtype == dtype
    for k in range(6):
        img = corpus[idx[0, 0, k]].astype(np.float32) - mean_hwc
        y, x = offs[0, 0, k]
        want = torch.from_numpy(np.ascontiguousarray(
            img[y:y + crop, x:x + crop])).to(dtype)
        assert torch.equal(got[k], want), k


def test_the_caffenet_run_logs_its_curve_on_the_iteration_grid():
    size, crop, b = 80, 67, 2
    r = np.random.default_rng(4)
    n = 2 * 2 * b * 2
    corpus = _t(r.integers(0, 256, (n, size, size, 3)).astype(np.uint8))
    data = (corpus, _t(r.integers(0, 16, n).astype(np.int32)),
            _t(r.uniform(100, 156, (size, size, 3)).astype(np.float32)),
            corpus[:4], _t(r.integers(0, 16, 4).astype(np.int32)), n)
    out = parity_caffenet.run(2, 4, data, seed=0, tau=2, batch=b,
                              crop=crop, size=size, n_classes=16)
    assert out["iters_actual"] == 4 and out["tau"] == 2
    assert [c["iter"] for c in out["curve"]] == [0, 4]
    assert len(out["round_losses"]) == 2 and out["losses"]["all_finite"]


# -- shard_imagenet ------------------------------------------------------------

def _ilsvrc_inputs(tmp_path):
    train_tar = tmp_path / "train_tot.tar"
    synth.write_synthetic_ilsvrc_tar(str(train_tar), 24, seed=0, n_classes=4)
    images, labels = synth.synthetic_imagenet(6, seed=0, start=24,
                                              n_classes=4)
    import io

    from PIL import Image
    val_tar, truth = tmp_path / "val.tar", tmp_path / "truth.txt"
    with tarfile.open(val_tar, "w") as tar, open(truth, "w") as tf:
        for k in range(6):
            buf = io.BytesIO()
            Image.fromarray(images[k]).save(buf, format="JPEG", quality=90)
            info = tarfile.TarInfo(name=f"v_{k}.JPEG")
            info.size = len(buf.getvalue())
            buf.seek(0)
            tar.addfile(info, buf)
            tf.write(f"v_{k}.JPEG {int(labels[k])}\n")
    return str(train_tar), str(val_tar), str(truth)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def test_the_sharder_writes_the_jax_scripts_bytes(tmp_path):
    train_tar, val_tar, truth = _ilsvrc_inputs(tmp_path)
    jax_sharder = _jax_script("shard_imagenet")
    ja, pa = tmp_path / "jax", tmp_path / "port"
    ja.mkdir()
    jax_sharder.shard_train(train_tar, str(ja), shards=3, size=48, seed=1)
    jax_sharder.shard_val(val_tar, truth, str(ja), shards=2, size=48, seed=1)
    shard_imagenet.main(["--out", str(pa), "--train-tar", train_tar,
                         "--shards", "3", "--val-tar", val_tar,
                         "--val-label-file", truth, "--val-shards", "2",
                         "--size", "48", "--seed", "1"])
    want, got = _files(ja), _files(pa)
    assert sorted(got) == sorted(want) == [
        "train.0000.tar", "train.0001.tar", "train.0002.tar", "train.txt",
        "val.0000.tar", "val.0001.tar", "val.txt"]
    for f in want:
        assert got[f] == want[f], f
    assert len(open(pa / "train.txt").read().split("\n")) == 24 + 1


@pytest.mark.parametrize("kind", ["gs", "s3"])
def test_the_sharders_upload_lands_the_jax_scripts_objects(tmp_path, kind,
                                                           monkeypatch):
    from fake_stores import bucket_store
    out = tmp_path / "out"
    out.mkdir()
    for name, data in (("train.0000.tar", b"tar-bytes" * 100),
                       ("train.txt", b"a 1\n"), ("notes.md", b"skip")):
        (out / name).write_bytes(data)
    jax_sharder = _jax_script("shard_imagenet")
    read = gcs.gs_read if kind == "gs" else s3.s3_read
    with bucket_store(kind) as (url, _srv):
        for m in (gcs, s3):
            m._CLIENTS.clear()
        monkeypatch.setattr(gcs, "BACKOFF_S", 0.01)
        assert shard_imagenet.upload_dir(str(out), f"{url}/port/") == 2
        assert jax_sharder.upload_dir(str(out), f"{url}/jax") == 2
        for name in ("train.0000.tar", "train.txt"):
            assert read(f"{url}/port/{name}") == (out / name).read_bytes()
            assert read(f"{url}/port/{name}") == read(f"{url}/jax/{name}")
        for m in (gcs, s3):
            m._CLIENTS.clear()
    with pytest.raises(SystemExit, match="gs:// or s3://"):
        shard_imagenet.upload_dir(str(out), "/local/dir")


# -- soak, elastic A/B, the CLIs -----------------------------------------------

def test_the_soak_smoke_writes_the_jax_scripts_fields(tmp_path):
    out = tmp_path / "soak.json"
    res = soak_stream.main(["--rounds", "3", "--device", "cpu", "--shards",
                            "4", "--per-shard", "32", "--sample-every", "1",
                            "--out", str(out)])
    on_disk = json.load(open(out))
    for key in ("rounds", "images", "wall_s", "readers", "stream_epochs",
                "skipped", "rss_mb", "losses", "rss_samples", "backend",
                "store", "round_batch_mb", "rss_slope_mb_per_round",
                "meta"):
        assert key in on_disk, key
    assert res["rounds"] == 3 and res["images"] == 3 * 32 * 5
    assert res["backend"] == "cpu-control" and res["card"] is None
    assert res["skipped"] == 0 and res["losses"]["n"] == 3
    assert res["losses"]["all_finite"]
    assert set(res["rss_mb"]) == {"first", "median", "last", "max"}
    assert [s["round"] for s in res["rss_samples"]] == [0, 1, 2]
    assert res["rss_slope_mb_per_round"]["all"] is not None
    assert not os.path.exists(str(out) + ".partial.jsonl")


def test_the_rss_slope_is_the_least_squares_slope():
    samples = [{"round": r, "rss_mb": 100.0 + 0.5 * r} for r in (0, 50, 100)]
    assert soak_stream.rss_slope(samples) == pytest.approx(0.5)
    assert soak_stream.rss_slope(samples[:1]) is None


def test_the_elastic_ab_smoke_writes_the_jax_scripts_schema(tmp_path):
    out_path = str(tmp_path / "ab.json")
    out = elastic_momentum_ab.main(["--seeds", "1", "--rounds-pre", "2",
                                    "--rounds-post", "3", "--out",
                                    out_path])
    assert out["winner"] in elastic_momentum_ab.POLICIES
    for pol in elastic_momentum_ab.POLICIES:
        for nd in (4, 2):
            assert len(out["results"][pol][nd]) == 1
            row = out["results"][pol][nd][0]
            assert np.isfinite(row["max_rel_dev"]) and row["seed"] == 0
    on_disk = json.load(open(out_path))
    assert on_disk["summary"].keys() == out["summary"].keys()
    assert set(on_disk) >= {"results", "summary", "winner", "task"}


def test_the_metrics_summary_wrapper_runs_the_console(tmp_path):
    import subprocess
    jsonl = tmp_path / "m.jsonl"
    jsonl.write_text(json.dumps({"step": 0, "loss": 2.3, "ts": 1.0})
                     + "\n")
    r = subprocess.run([sys.executable, "-m",
                        "sparknet_tpu_torch.scripts.metrics_summary",
                        str(jsonl), "--json"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout)
    assert out["loss_final"] == 2.3 and out["rounds"] == 1


# -- the data-gated recipes through the port's apps ----------------------------

DATA = os.environ.get("SPARKNET_TPU_DATA", "data")
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def _missing(*paths):
    return not all(os.path.exists(os.path.join(DATA, p)) for p in paths)


def _final_accuracy(tmp_path, trainer_of, state, test_ds, eval_batch):
    """Evaluate the final state as the loop does, on a world of one."""
    from sparknet_tpu_torch.apps.train_loop import _evaluate
    group = init_data_group(DEVICE, store_path=str(tmp_path / "eval_store"),
                            rank=0, world_size=1)
    try:
        return _evaluate(trainer_of(group), state, test_ds, eval_batch,
                         (0, 1))
    finally:
        group.close()


@pytest.mark.parity
@pytest.mark.skipif(
    _missing("cifar10/data_batch_1.bin", "cifar10/test_batch.bin"),
    reason="data/cifar10 absent (scripts/get_datasets.sh cifar10)")
def test_cifar10_quick_recipe(tmp_path):
    """lr 0.001 fixed / momentum 0.9 / wd 0.004 / batch 100 / tau 10 / 400
    rounds = 4000 iterations: at least 0.70 test accuracy (PARITY.md
    section 1), through the port's CIFAR app on one rank."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.apps.train_loop import (_to_device_layout,
                                                    resolve_spec, train)
    from sparknet_tpu_torch.utils.logger import Logger

    cfg = cifar_app.default_config()
    cfg.data_dir = os.path.join(DATA, "cifar10")
    cfg.n_devices, cfg.max_rounds = 1, 400
    cfg.eval_every = 50
    cfg.workdir = str(tmp_path)
    train_ds, test_ds = cifar_app.build_datasets(cfg)
    spec = resolve_spec(cfg, data=(cfg.local_batch, 3, 32, 32),
                        label=(cfg.local_batch, 1))
    log_path = str(tmp_path / "cifar_parity.txt")
    state = train(cfg, spec, train_ds, test_ds,
                  logger=Logger(log_path, echo=True), device=DEVICE)
    net = CompiledNet.compile(spec)
    acc = _final_accuracy(
        tmp_path, lambda g: ParallelTrainer(net, cfg.solver, g, tau=cfg.tau),
        state, _to_device_layout(test_ds, net), cfg.eval_batch)
    assert acc >= 0.70, (
        f"cifar10_quick @4000 iters: acc={acc:.4f}, expected >=0.70 "
        f"(reference band ~0.71-0.75); see {log_path}")


@pytest.mark.parity
@pytest.mark.skipif(
    _missing("mnist/train-images-idx3-ubyte", "mnist/t10k-images-idx3-ubyte"),
    reason="data/mnist absent (scripts/get_datasets.sh mnist)")
def test_mnist_graph_recipe(tmp_path):
    """The serialized-graph backend (in-graph Momentum + exp-decay lr,
    batch 64, tau 10), 150 rounds = 1500 steps: at least 0.97 (PARITY.md
    section 2), through the port's graph MNIST app on one rank."""
    from sparknet_tpu_torch.apps import graph_mnist_app
    from sparknet_tpu_torch.apps.graph_common import train_graph
    from sparknet_tpu_torch.backend import GraphNet, build_mnist_graph
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.data.mnist import MnistLoader
    from sparknet_tpu_torch.parallel.graph_trainer import GraphTrainer
    from sparknet_tpu_torch.utils.logger import Logger

    cfg = graph_mnist_app.default_config()
    cfg.data_dir = os.path.join(DATA, "mnist")
    cfg.n_devices, cfg.max_rounds = 1, 150
    cfg.eval_every = 25
    cfg.workdir = str(tmp_path)
    loader = MnistLoader(cfg.data_dir)
    train_ds = ArrayDataset(graph_mnist_app._nhwc(loader.train_batch_dict()))
    test_ds = ArrayDataset(graph_mnist_app._nhwc(loader.test_batch_dict()))
    graph = build_mnist_graph(batch=cfg.local_batch,
                              train_size=len(train_ds))
    state = train_graph(cfg, graph, train_ds, test_ds,
                        logger=Logger(str(tmp_path / "mnist_parity.txt"),
                                      echo=True),
                        expect_data_shape=(28, 28, 1), device=DEVICE)
    acc = _final_accuracy(
        tmp_path, lambda g: GraphTrainer(
            GraphNet(graph, seed=cfg.seed, device=DEVICE), g, tau=cfg.tau),
        state, test_ds, cfg.eval_batch)
    assert acc >= 0.97, (
        f"mnist graph recipe @1500 steps: acc={acc:.4f}, expected >=0.97")


@pytest.mark.parity
@pytest.mark.skipif(_missing("adult/adult.data"),
                    reason="data/adult absent "
                    "(scripts/get_datasets.sh adult)")
def test_adult_recipe(tmp_path):
    """Adult MLP: 200 rounds x tau 5 at batch 64; at least 0.80 held-out
    accuracy (PARITY.md section 4), through the port's loop."""
    from sparknet_tpu_torch.apps.adult_app import adult_net
    from sparknet_tpu_torch.apps.train_loop import train
    from sparknet_tpu_torch.data.adult import AdultLoader
    from sparknet_tpu_torch.data.dataset import ArrayDataset
    from sparknet_tpu_torch.solver import SolverConfig
    from sparknet_tpu_torch.utils.config import RunConfig
    from sparknet_tpu_torch.utils.logger import Logger

    loader = AdultLoader(os.path.join(DATA, "adult", "adult.data"))
    full = loader.batch_dict()
    n = len(loader.labels)
    split = int(n * 0.8)
    train_ds = ArrayDataset({k: v[:split] for k, v in full.items()})
    test_ds = ArrayDataset({k: v[split:] for k, v in full.items()})
    cfg = RunConfig(
        model="adult",
        solver=SolverConfig(base_lr=0.01, momentum=0.9, lr_policy="fixed"),
        n_devices=1, tau=5, local_batch=64, eval_every=50, eval_batch=1024,
        max_rounds=200, workdir=str(tmp_path))
    spec = adult_net(cfg.local_batch, loader.features.shape[1])
    state = train(cfg, spec, train_ds, test_ds,
                  logger=Logger(str(tmp_path / "adult_parity.txt"),
                                echo=True), device=DEVICE)
    net = CompiledNet.compile(spec)
    acc = _final_accuracy(
        tmp_path, lambda g: ParallelTrainer(net, cfg.solver, g, tau=cfg.tau),
        state, test_ds, cfg.eval_batch)
    assert acc >= 0.80, f"adult recipe: acc={acc:.4f}, expected >=0.80"


@pytest.mark.parity
@pytest.mark.skipif(_missing("imagenet/train.txt"),
                    reason="data/imagenet absent "
                    "(python -m sparknet_tpu_torch.scripts.shard_imagenet "
                    "ingest)")
def test_imagenet_smoke(tmp_path):
    """A 50-round smoke at the real recipe's lr/crop/mean settings on the
    real shards: the loss must drop clearly below the ln(1000) = 6.908
    random floor."""
    import re

    from sparknet_tpu_torch import zoo
    from sparknet_tpu_torch.apps.train_loop import train
    from sparknet_tpu_torch.data import imagenet
    from sparknet_tpu_torch.data.preprocess import ImagePreprocessor
    from sparknet_tpu_torch.data.streaming import StreamingRoundSource
    from sparknet_tpu_torch.schema import Field, Schema
    from sparknet_tpu_torch.solver import SolverConfig
    from sparknet_tpu_torch.utils.config import RunConfig
    from sparknet_tpu_torch.utils.logger import Logger

    root = os.path.join(DATA, "imagenet")
    shards = [s for s in imagenet.list_shards(root)
              if os.path.basename(s).startswith("train.")][:2]
    loader = imagenet.ShardedTarLoader(
        shards, imagenet.load_label_map(os.path.join(root, "train.txt")))
    crop, local_b, tau = 227, 32, 5
    cfg = RunConfig(
        model="caffenet",
        solver=SolverConfig(base_lr=0.01, momentum=0.9, weight_decay=5e-4,
                            lr_policy="step", gamma=0.1, stepsize=100000),
        n_devices=1, tau=tau, local_batch=local_b, eval_every=0,
        max_rounds=50, crop=crop, workdir=str(tmp_path))
    src = StreamingRoundSource(loader, 1, local_b, tau)
    schema = Schema(Field("data", "float32", (crop, crop, 3)),
                    Field("label", "int32", (1,)))
    pp = ImagePreprocessor(schema, mean_image=None, crop=crop, seed=0)
    log_path = str(tmp_path / "imagenet_smoke.txt")
    train(cfg, zoo.caffenet(batch=local_b, crop=crop), src,
          logger=Logger(log_path, echo=True), batch_transform=pp,
          device=DEVICE)
    losses = [float(m.group(1)) for m in re.finditer(
        r"round loss: ([0-9.]+)", open(log_path).read())]
    assert losses, "no round losses logged"
    tail = np.mean(losses[-5:])
    assert tail < 6.5, (
        f"imagenet smoke: tail loss {tail:.3f} never left the 6.908 "
        f"random floor — preprocessing/label pipeline suspect")
