"""The port's ImageNet path against the JAX package's, on the CPU.

Inputs are made here: JPEG tar shards by `write_synthetic_shards` (both
packages write the same bytes), uint8 batches and mean images from seeded
numpy generators.
- `ImagePreprocessor.convert_batch`, train and eval, float32 and bfloat16,
  through the native plane (where `native/libjpeg_plane.so` loads or
  builds here) and the numpy route: bit-equal to the JAX package's
  (bfloat16 compared as bits).
- `ShardedTarLoader.load_all` on shards with corrupt entries: the same
  pixels, labels and skipped count, through the native plane and PIL.
- `compute_mean_image` equal; the `mean_image.npz` sidecar read across
  packages (each reads the other's file without recomputing), and a
  sidecar of another corpus recomputed.
- `synth`'s corpora equal.
- The app's `main()` against the JAX app's `main()` on a tiny corpus
  with a prototxt net that has a MAX pool and an LRN (both packages read
  the same file), float32, from the JAX package's init: losses within
  rtol 1e-4 (the tolerance of `test_torch_apps.py::
  test_train_matches_the_jax_train`; convolution sums run in another
  order) and test accuracies equal; in a world of one and in two gloo
  ranks against a JAX mesh of two.
- The CLI with `--device cpu`, and a world whose machines hold different
  rank counts, refused (streaming, buckets and several machines are
  held to the JAX package in test_torch_streaming.py,
  test_torch_buckets.py and test_torch_multimachine.py).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from sparknet_tpu.apps import imagenet_app as jax_app
from sparknet_tpu.apps.train_loop import resolve_spec as jax_resolve_spec
from sparknet_tpu.data import imagenet as jax_imagenet
from sparknet_tpu.data import jpeg_plane as jax_plane
from sparknet_tpu.data import preprocess as jax_pre
from sparknet_tpu.data import synth as jax_synth
from sparknet_tpu.model.net import CompiledNet as JaxCompiledNet
from sparknet_tpu.schema import Field as JaxField
from sparknet_tpu.schema import Schema as JaxSchema

import torch_imagenet_worker
from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.apps.train_loop import resolve_spec
from sparknet_tpu_torch.data import imagenet, jpeg_plane, preprocess, synth
from sparknet_tpu_torch.model.net import CompiledNet, params_from_jax
from sparknet_tpu_torch.parallel.trainer import ParallelTrainer
from sparknet_tpu_torch.schema import Field, Schema
from test_torch_train import jax_params

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 240

NET = """name: "tiny_imagenet"
input: "data"
input_shape { dim: 4 dim: 3 dim: 32 dim: 32 }
input: "label"
input_shape { dim: 4 dim: 1 }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 8 kernel_size: 5 stride: 2
    weight_filler { type: "gaussian" std: 0.01 } } }
layer { name: "relu1" type: "ReLU" bottom: "conv1" top: "conv1" }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "norm1" type: "LRN" bottom: "pool1" top: "norm1"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "ip1" type: "InnerProduct" bottom: "norm1" top: "ip1"
  inner_product_param { num_output: 4
    weight_filler { type: "gaussian" std: 0.01 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip1" bottom: "label"
  top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "ip1" bottom: "label"
  top: "accuracy" include { phase: TEST } }
"""
OVERRIDES = ("crop=32", "local_batch=4", "tau=2", "max_rounds=3",
             "eval_every=2", "eval_batch=8", "n_classes=4",
             "precision=float32",
             'solver={"base_lr": 0.001, "momentum": 0.9, '
             '"lr_policy": "fixed"}')


def _native_or_skip():
    if not (jpeg_plane.available() and jax_plane.available()):
        pytest.skip(f"the native plane does not load here: "
                    f"{jpeg_plane.unavailable_reason()}")


def _no_native(monkeypatch):
    monkeypatch.setattr(jpeg_plane, "available", lambda: False)
    monkeypatch.setattr(jax_plane, "available", lambda: False)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    imagenet.write_synthetic_shards(str(d), n_shards=2, per_shard=12,
                                    n_classes=4, size=40, seed=0)
    imagenet.write_synthetic_shards(str(d), n_shards=1, per_shard=8,
                                    n_classes=4, size=40, seed=1,
                                    prefix="val")
    (d / "tiny.prototxt").write_text(NET)
    return d


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
def test_convert_batch_is_the_jax_packages(route, out_dtype, train,
                                           monkeypatch):
    if route == "native":
        _native_or_skip()
    else:
        _no_native(monkeypatch)
    r = np.random.default_rng(4)
    raw = r.integers(0, 256, (6, 3, 16, 16), dtype=np.uint8)
    mean = r.uniform(0, 255, (3, 16, 16)).astype(np.float32)
    batch = {"data": raw, "label": r.integers(0, 4, (6,)).astype(np.int64)}
    mine = preprocess.ImagePreprocessor(
        Schema(Field("data", "float32", (11, 11, 3)),
               Field("label", "int32", (1,))),
        mean_image=mean, crop=11, out_dtype=out_dtype)
    theirs = jax_pre.ImagePreprocessor(
        JaxSchema(JaxField("data", "float32", (11, 11, 3)),
                  JaxField("label", "int32", (1,))),
        mean_image=mean, crop=11, out_dtype=out_dtype)
    assert mine.route(raw) == route
    got = mine.convert_batch(batch, train=train,
                             rng=np.random.default_rng(9))
    want = theirs.convert_batch(batch, train=train,
                                rng=np.random.default_rng(9))
    np.testing.assert_array_equal(got["label"], want["label"])
    assert got["label"].dtype == np.int32 and got["label"].shape == (6, 1)
    assert tuple(got["data"].shape) == want["data"].shape == (6, 11, 11, 3)
    if out_dtype == "bfloat16":
        assert got["data"].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got["data"]),
                                      _bits(want["data"]))
    else:
        np.testing.assert_array_equal(got["data"], want["data"])


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_sharded_tar_loader_is_the_jax_packages(decoder, tmp_path,
                                                monkeypatch):
    if decoder == "native":
        _native_or_skip()
    else:
        _no_native(monkeypatch)
    label = imagenet.write_synthetic_shards(
        str(tmp_path), n_shards=2, per_shard=7, n_classes=5, size=24,
        corrupt_every=4)
    out = []
    for mod in (imagenet, jax_imagenet):
        loader = mod.ShardedTarLoader(mod.list_shards(str(tmp_path),
                                                      "train."),
                                      mod.load_label_map(label), 20, 20)
        images, labels = loader.load_all()
        out.append((images, labels, loader.skipped))
        assert loader.load_all(limit=5)[0].shape == (5, 3, 20, 20)
    (ga, gl, gs), (wa, wl, ws) = out
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(gl, wl)
    assert gs == ws == 3  # entries 4, 8 and 12 are truncated JPEGs


def test_the_synthetic_shards_are_the_jax_packages_bytes(tmp_path):
    a = imagenet.write_synthetic_shards(str(tmp_path / "a"), n_shards=1,
                                        per_shard=3, size=16, seed=2)
    b = jax_imagenet.write_synthetic_shards(str(tmp_path / "b"), n_shards=1,
                                            per_shard=3, size=16, seed=2)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    assert (tmp_path / "a" / "train.0000.tar").read_bytes() == \
        (tmp_path / "b" / "train.0000.tar").read_bytes()


def test_the_synthetic_corpora_are_the_jax_packages():
    for fn, kw in (("synthetic_cifar", {}),
                   ("synthetic_imagenet", dict(n_classes=3))):
        got = getattr(synth, fn)(3, seed=1, start=2, **kw)
        want = getattr(jax_synth, fn)(3, seed=1, start=2, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(synth.mean_image(n=20),
                                  jax_synth.mean_image(n=20))


def _cfg(corpus, checkpoint_dir):
    cfg = imagenet_app.default_config().with_overrides(
        f"data_dir={corpus}", f"checkpoint_dir={checkpoint_dir}")
    jcfg = jax_app.default_config().with_overrides(
        f"data_dir={corpus}", f"checkpoint_dir={checkpoint_dir}")
    return cfg, jcfg


def _loaders(corpus):
    cfg, jcfg = _cfg(corpus, None)
    return (imagenet_app.host_loader(cfg, "train.", "train.txt"),
            jax_app.host_loader(jcfg, "train.", "train.txt"))


def test_the_mean_image_sidecar_reads_across_packages(corpus, tmp_path,
                                                      monkeypatch):
    mine, theirs = _loaders(corpus)
    images, _ = mine.load_all()
    mean = preprocess.compute_mean_image(images)
    np.testing.assert_array_equal(mean, jax_pre.compute_mean_image(images))
    # the port writes, the JAX package reads without a corpus pass
    cfg, jcfg = _cfg(corpus, tmp_path / "a")
    got = imagenet_app._load_or_compute_mean(cfg, mine, images, "port")
    np.testing.assert_array_equal(got, mean)
    monkeypatch.setattr(jax_app, "streaming_sum_count",
                        lambda *a, **k: pytest.fail("recomputed"))
    np.testing.assert_array_equal(
        jax_app._load_or_compute_mean(jcfg, theirs, 0, 1, "jax"), mean)
    monkeypatch.undo()
    # the JAX package writes (its streaming pass), the port reads
    cfg, jcfg = _cfg(corpus, tmp_path / "b")
    want = jax_app._load_or_compute_mean(jcfg, theirs, 0, 1, "jax")
    monkeypatch.setattr(imagenet_app, "compute_mean_image",
                        lambda *a: pytest.fail("recomputed"))
    got = imagenet_app._load_or_compute_mean(cfg, mine, images, "port")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, mean, rtol=1e-6)
    monkeypatch.undo()
    # a sidecar of another corpus is recomputed
    with np.load(tmp_path / "b" / "mean_image.npz") as z:
        np.savez(tmp_path / "b" / "mean_image.npz", mean=z["mean"] + 1,
                 corpus_id=np.array("another corpus"))
    got = imagenet_app._load_or_compute_mean(cfg, mine, images, "port")
    np.testing.assert_array_equal(got, mean)


def _records(workdir):
    (path,) = Path(workdir).glob("training_metrics_*.jsonl")
    return [json.loads(line) for line in path.read_text().splitlines()]


def _start_params(corpus, n_devices):
    net = str(corpus / "tiny.prototxt")
    jcfg = jax_app.default_config().with_overrides(*OVERRIDES,
                                                   f"model={net}")
    tcfg = imagenet_app.default_config().with_overrides(*OVERRIDES,
                                                        f"model={net}")
    shapes = dict(data=(4, 3, 32, 32), label=(4, 1))
    jspec = jax_resolve_spec(jcfg, **shapes)
    return params_from_jax(CompiledNet.compile(resolve_spec(tcfg, **shapes)),
                           jax_params(JaxCompiledNet.compile(jspec)),
                           torch.device("cpu"))


def _jax_main(corpus, workdir, n_devices):
    jax_app.main(["--data-dir", str(corpus), *OVERRIDES,
                  f"model={corpus / 'tiny.prototxt'}", f"workdir={workdir}",
                  f"n_devices={n_devices}", "trainer_impl=shard_map"])
    return _records(workdir)


def _held(got, want):
    gl = [x["loss"] for x in got if "loss" in x]
    wl = [x["loss"] for x in want if "loss" in x]
    assert len(gl) == len(wl) == 3
    assert all(abs(g - w) <= 1e-4 * abs(w) for g, w in zip(gl, wl)), (gl, wl)
    ga = [x["test_accuracy"] for x in got if "test_accuracy" in x]
    assert ga == [x["test_accuracy"] for x in want if "test_accuracy" in x]
    assert len(ga) == 2


def test_the_app_matches_the_jax_app(corpus, tmp_path, monkeypatch):
    want = _jax_main(corpus, tmp_path / "jax", 1)
    start = _start_params(corpus, 1)
    monkeypatch.setattr(ParallelTrainer, "init_state",
                        lambda self, seed=0: self.state_from_params(start))
    imagenet_app.main(["--device", "cpu", "--data-dir", str(corpus),
                       *OVERRIDES, f"model={corpus / 'tiny.prototxt'}",
                       f"workdir={tmp_path / 'port'}"])
    _held(_records(tmp_path / "port"), want)


def _ranks_report(ctx, t0, store, workdir):
    """What each rank got to and when (seconds after the spawn, from the
    phase marks torch_imagenet_worker writes), whether it is alive, and
    the FileStore's state: a failure of the two-rank test says whether the
    ranks were held at the rendezvous, in training, or finished."""
    lines = [f"elapsed {time.time() - t0:.1f} s of SPAWN_TIMEOUT_S "
             f"{SPAWN_TIMEOUT_S}; FileStore {store} "
             + (f"{store.stat().st_size} bytes" if store.exists()
                else "absent")]
    for rank, p in enumerate(ctx.processes):
        marks = Path(f"{workdir}_w{rank}.phases")
        phases = ([json.loads(x) for x in marks.read_text().splitlines()]
                  if marks.exists() else [])
        lines.append(
            f"rank {rank}: pid {p.pid} alive {p.is_alive()} exitcode "
            f"{p.exitcode}; " + (", ".join(
                f"{m['phase']} +{m['t'] - t0:.1f} s" for m in phases)
                or "no phase reached"))
    return "\n".join(lines)


def _records_diff(got, want):
    gl = [x["loss"] for x in got if "loss" in x]
    wl = [x["loss"] for x in want if "loss" in x]
    rel = [abs(g - w) / abs(w) for g, w in zip(gl, wl)]
    return (f"losses {gl} against the JAX mesh's {wl}, largest relative "
            f"difference {max(rel, default=float('nan')):.3e} (rtol 1e-4); "
            f"test accuracies "
            f"{[x['test_accuracy'] for x in got if 'test_accuracy' in x]} "
            f"against "
            f"{[x['test_accuracy'] for x in want if 'test_accuracy' in x]}")


def test_two_gloo_ranks_match_a_jax_mesh_of_two(corpus, tmp_path):
    want = _jax_main(corpus, tmp_path / "jax", 2)
    params = {l: {p: t.numpy() for p, t in lp.items()}
              for l, lp in _start_params(corpus, 2).items()}
    argv = ["--device", "cpu", "--data-dir", str(corpus), *OVERRIDES,
            f"model={corpus / 'tiny.prototxt'}"]
    store, workdir = tmp_path / "store", tmp_path / "port"
    t0 = time.time()
    ctx = mp.spawn(torch_imagenet_worker.run,
                   args=(2, str(store), params, argv, str(workdir)),
                   nprocs=2, join=False)
    try:
        while not ctx.join(timeout=5):
            if time.time() - t0 > SPAWN_TIMEOUT_S:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the two ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s\n"
                            + _ranks_report(ctx, t0, store, workdir))
    except ProcessException as e:
        pytest.fail(f"a rank failed: {e}\n"
                    + _ranks_report(ctx, t0, store, workdir))
    for rank in range(2):
        got = _records(f"{workdir}_w{rank}")
        try:
            _held(got, want)
        except AssertionError as e:
            pytest.fail(f"rank {rank}'s records differ from the JAX "
                        f"mesh's: {e!r}\n{_records_diff(got, want)}\n"
                        + _ranks_report(ctx, t0, store, workdir))


def test_the_cli_trains_on_the_cpu(corpus, tmp_path):
    env = dict(os.environ, SPARKNET_TPU_HOME=str(tmp_path))
    r = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.apps.imagenet_app",
         "--device", "cpu", "--data-dir", str(corpus), *OVERRIDES,
         f"model={corpus / 'tiny.prototxt'}", f"workdir={tmp_path}",
         "precision=bfloat16"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "preprocessing route: " in r.stderr
    assert "round pipeline: prep thread on, h2d_prefetch=True" in r.stderr
    losses = [x for x in _records(tmp_path) if "loss" in x]
    assert [x["step"] for x in losses] == [0, 1, 2]
    assert all(x["nonfinite"] == 0 and "t_data_ms" in x for x in losses)


RAGGED = {
    "3 ranks, 2 a machine": {"WORLD_SIZE": "3", "LOCAL_WORLD_SIZE": "2",
                             "RANK": "2"},
    "LOCAL_RANK out of step with RANK": {
        "WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "2", "RANK": "1",
        "LOCAL_RANK": "0"},
}


@pytest.mark.parametrize("what", sorted(RAGGED))
def test_a_world_of_ragged_machines_raises(what, corpus, monkeypatch):
    """Machines with different rank counts have no JAX-package
    counterpart (its hosts each drive the same devices): the app raises
    before it reads a shard."""
    for k, v in RAGGED[what].items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="different numbers of ranks"):
        imagenet_app.prepare_data(
            imagenet_app.default_config().with_overrides(
                f"data_dir={corpus}", *OVERRIDES),
            _args(corpus))


def _args(corpus, *argv):
    import argparse
    p = argparse.ArgumentParser()
    imagenet_app.add_data_args(p)
    return p.parse_args(["--data-dir", str(corpus), *argv])
